"""The two-view entry's spans and LM counters (utils/profiling) on
tests/test_torch_twoview.py's scene: the results under torch.profiler
are bit-identical to the results without one, the trace holds the spans
nested as the entry runs its stages, a span enters nothing when no
profiler records, and the LM loops' counters agree with the entry's
SolverTelemetry and leave out the match slots a depth stage drops."""

import json

import numpy as np
import pytest
import torch

import bench
from spherical_bundle_adjuster_tpu_torch.models import twoview as ttv
from spherical_bundle_adjuster_tpu_torch.solver import lm
from spherical_bundle_adjuster_tpu_torch.utils import config as tconfig, profiling, synthetic as tsyn
from spherical_bundle_adjuster_tpu_torch.utils.tree import flatten
from test_torch_twoview import CFG, H, SEED, TCFG, W

torch.set_num_threads(1)

MODES = ("compat", "corrected", "batch")  # a pair in either mode, a compat batch of 2 pairs
CORRECTED = tconfig.from_reference(bench.corrected_mode(CFG))
LM_SPANS = ("sba.lm.depth", "sba.lm.rot", "sba.lm.tran")
IN_REFINE = ("sba.consensus", "sba.joint_schur") + LM_SPANS


@pytest.fixture(scope="module")
def pairs():
    """The scene's pair (its texture and Euler draws) and a second pair
    from the next seed, on the CPU."""
    out = []
    for k in range(2):
        params = tsyn.texture_params_from_numpy(np.random.default_rng(SEED + k))
        euler = np.deg2rad(np.random.default_rng(SEED + 100 + k).uniform(-5, 5, 3))
        left, right, _ = tsyn.rotation_pair(params, euler.astype(np.float32), H, W, "cpu")
        out.append((left, right))
    return out


def _cfg(mode):
    return CORRECTED if mode == "corrected" else TCFG


def _run(mode, pairs):
    gen = torch.Generator().manual_seed(0)
    if mode == "batch":
        lefts, rights = (torch.stack(x) for x in zip(*pairs))
        return ttv.run_two_view_batch(lefts, rights, gen, TCFG)
    return ttv.run_two_view(*pairs[0], gen, _cfg(mode))


@pytest.fixture(scope="module")
def runs(pairs):
    """Per mode, made on first use: (the result without a profiler, the
    result under one, the trace's sba.* ranges as (name, start, end))."""
    cache = {}

    def get(mode):
        if mode not in cache:
            plain = _run(mode, pairs)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                traced = _run(mode, pairs)
            spans = [(e.name(), e.start_ns(), e.end_ns())
                     for e in prof.profiler.kineto_results.events() if e.name().startswith("sba.")]
            cache[mode] = plain, traced, spans
        return cache[mode]

    return get


@pytest.mark.parametrize("mode", MODES)
def test_results_under_the_profiler_are_bit_identical(runs, mode):
    plain, traced, _ = runs(mode)
    a, b = flatten(plain)[0], flatten(traced)[0]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(y, x, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("mode", MODES)
def test_the_trace_holds_the_stage_spans_nested(runs, mode):
    """One sba.two_view holds one sba.frontend and then one sba.refine;
    the refinement holds the consensus, one span per LM stage solved
    (bcd_rounds of each, again after every reprojection gate) and, in
    corrected mode alone, the joint Schur polish."""
    _, _, spans = runs(mode)
    names = [n for n, _, _ in spans]
    ba = _cfg(mode).ba
    solves = ba.bcd_rounds * (1 + (ba.outlier_rounds if ba.outlier_reject else 0))
    expected = {"sba.two_view": 1, "sba.frontend": 1, "sba.refine": 1, "sba.consensus": 1,
                **{s: solves for s in LM_SPANS},
                "sba.joint_schur": 1 if mode == "corrected" else 0}
    assert {n: names.count(n) for n in expected} == expected
    assert len(names) == sum(expected.values())

    def one(name):
        return next((s, e) for n, s, e in spans if n == name)

    root, front, refine = one("sba.two_view"), one("sba.frontend"), one("sba.refine")
    assert root[0] <= front[0] < front[1] <= refine[0] < refine[1] <= root[1]
    for n, s, e in spans:
        if n in IN_REFINE:
            assert refine[0] <= s < e <= refine[1], n
    lm_spans = sorted((s, e) for n, s, e in spans if n in LM_SPANS)
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(lm_spans, lm_spans[1:]))  # never nested


def test_a_span_enters_nothing_without_a_profiler(monkeypatch, pairs):
    """With no profiler recording, a span is the one shared null context
    and the entry opens no record_function; under a profiler every span
    enters the range that profiling.span uses."""
    entered = []

    class Range:
        def __init__(self, name, *args):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Range)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("sba.a") is profiling.span("sba.b")
    _run("compat", pairs)
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("sba.a"):
            pass
    assert entered == ["sba.a"]


@pytest.mark.parametrize("mode", ["compat", "batch"])
def test_lm_counters_agree_with_the_telemetry(pairs, mode):
    """For each rotation and translation stage solved, one host read a
    loop trip: syncs = min(max_iterations, the most iterations of any
    pair + 1); active counts every pair's iterations, slots the batch's
    pairs at every trip. LAST_CALL holds the call's growth of COUNTS."""
    before = profiling.COUNTS.copy()
    out = _run(mode, pairs)
    assert profiling.LAST_CALL == profiling.COUNTS - before
    cap = TCFG.ba.max_iterations
    for stage in ("rot", "tran"):
        its = getattr(out.telemetry, stage).iterations.reshape(-1, TCFG.ba.bcd_rounds)  # (P, rounds)
        syncs = int(torch.clamp(its.amax(0) + 1, max=cap).sum())
        assert profiling.LAST_CALL[f"lm.{stage}.syncs"] == syncs
        assert profiling.LAST_CALL[f"lm.{stage}.active"] == int(its.sum())
        assert profiling.LAST_CALL[f"lm.{stage}.slots"] == its.shape[0] * syncs
    assert lm._COUNTING == ("other", None)  # restored after every stage


@pytest.mark.parametrize("mode", ["compat", "batch"])
def test_the_depth_counters_leave_out_the_dropped_slots(monkeypatch, pairs, mode):
    """A depth stage runs LM on every match slot of its bank and keeps
    the valid ones: its trips are set by every slot, while active counts
    the iterations of the kept slots alone."""
    real, solved = lm.lm_fixed, []

    def spy(*args, **kwargs):
        x, rep = real(*args, **kwargs)
        stage, kept = lm._COUNTING
        if stage == "depth":
            solved.append((rep.iterations, kept))
        return x, rep

    monkeypatch.setattr(lm, "lm_fixed", spy)
    _run(mode, pairs)
    cap = TCFG.ba.max_iterations
    assert len(solved) == TCFG.ba.bcd_rounds
    syncs = sum(min(cap, int(it.amax()) + 1) for it, _ in solved)
    active = sum(int(it[kept].sum()) for it, kept in solved)
    assert profiling.LAST_CALL["lm.depth.syncs"] == syncs
    assert profiling.LAST_CALL["lm.depth.active"] == active
    assert profiling.LAST_CALL["lm.depth.slots"] == sum(it.numel() * min(cap, int(it.amax()) + 1)
                                                        for it, _ in solved)
    assert active < sum(int(it.sum()) for it, _ in solved)  # the dropped slots did iterate


def test_profiling_trace_exports_the_spans(tmp_path, pairs):
    """profiling.trace's Chrome export holds the entry's spans."""
    with profiling.trace(str(tmp_path)) as log_dir:
        _run("compat", pairs)
    (path,) = list(tmp_path.glob("sba_trace_*.json"))
    assert str(path.parent) == log_dir
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"sba.two_view", "sba.frontend", "sba.refine", "sba.consensus"} | set(LM_SPANS) <= names
