"""Profiling helpers (aux subsystem C16), ported from the JAX package's
utils/profiling.py: a torch.profiler trace in place of jax.profiler's,
and a device timer on CUDA events. The JAX package's timer runs the body
in a lax.scan and subtracts a dispatch round trip, a workaround for TPU
backends reached over RPC; the port times the card with events instead.

The two-view path is instrumented with spans and counters of its own:

  * `span(name)` marks a stage as a range on the profiler's clock, the
    clock of the card's kernels and copies, whenever a torch.profiler
    records (`trace` below, or any other): `sba.two_view` (one call of
    run_two_view or run_two_view_batch) holds `sba.frontend`
    (frontend_pairs) and `sba.refine` (adjust_from_matches), which holds
    `sba.consensus`, one `sba.lm.depth` / `sba.lm.rot` / `sba.lm.tran`
    per LM stage solved and, in corrected mode, `sba.joint_schur`. With
    no profiler recording, a span is one check and nothing else.
  * `COUNTS` counts, always, each LM loop's trips (solver/lm.lm_fixed):
    `lm.<stage>.syncs`, one host read a trip; `lm.<stage>.active`, the
    problems still running at each trip whose result the stage keeps (a
    depth stage drops its padded and invalid match slots);
    `lm.<stage>.slots`, the problems of the batch at each trip. `LAST_CALL` holds what the
    newest call of a two-view entry added to them.
"""

from __future__ import annotations

import collections
import functools
import os
import statistics
import tempfile
import time
from contextlib import contextmanager, nullcontext

import torch
from torch.profiler import ProfilerActivity, profile

from .. import kernel_times

DEFAULT_LOG_DIR = os.path.join(tempfile.gettempdir(), "sba_trace")

COUNTS: collections.Counter = collections.Counter()
LAST_CALL: collections.Counter = collections.Counter()
_OFF = nullcontext()


def span(name: str):
    """A context manager that marks its body as the range `name` in the
    trace of a recording torch.profiler, and does nothing otherwise.

    The range is a function-scope record_function: a host range that the
    card's work links to by correlation id, with no copy of itself on the
    card's timeline (a user-scope torch.profiler.record_function range
    has one), so a trace's device activities stay the card's work."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def spanned(name: str):
    """Decorator: every call of the function as the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextmanager
def entry_call(name: str):
    """One call of a two-view entry (a decorator of the entry): the root
    span `name`, and on a normal exit what the call added to COUNTS in
    LAST_CALL."""
    before = COUNTS.copy()
    with span(name):
        yield
    LAST_CALL.clear()
    LAST_CALL.update(COUNTS - before)


@contextmanager
def trace(log_dir: str = DEFAULT_LOG_DIR):
    """torch.profiler trace of the body: host activity, and the card's
    (kernels, copies) where a card is present. On exit the trace is
    exported as a Chrome trace (open in chrome://tracing or Perfetto) to
    <log_dir>/sba_trace_<pid>_<ns>.json. Yields log_dir."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"sba_trace_{os.getpid()}_{time.time_ns()}.json"))


def device_time(body_fn, reps: int = 32, n: int = 3, device=None):
    """Median seconds per call of `body_fn()` over n samples of `reps`
    back-to-back calls, each after one warm-up call. On the card (device
    "cuda", the default where a card is present) a sample is
    kernel_times.device_ms: CUDA events around calls queued behind a spin
    on the card, so it times the card's work rather than the host's launch
    rate. On the CPU a sample is time.perf_counter around the calls."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type == "cuda":
        return statistics.median(
            kernel_times.device_ms(body_fn, reps, warmup=1)[0] for _ in range(n)) / 1e3
    body_fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        for _ in range(reps):
            body_fn()
        ts.append((time.perf_counter() - t0) / reps)
    return statistics.median(ts)
