"""Profiling helpers (aux subsystem C16), ported from the JAX package's
utils/profiling.py: a torch.profiler trace in place of jax.profiler's,
and a device timer on CUDA events. The JAX package's timer runs the body
in a lax.scan and subtracts a dispatch round trip, a workaround for TPU
backends reached over RPC; the port times the card with events instead.
"""

from __future__ import annotations

import os
import statistics
import tempfile
import time
from contextlib import contextmanager

import torch
from torch.profiler import ProfilerActivity, profile

from .. import kernel_times

DEFAULT_LOG_DIR = os.path.join(tempfile.gettempdir(), "sba_trace")


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
