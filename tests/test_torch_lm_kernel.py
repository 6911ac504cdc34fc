"""solver/lm's trip kernels (ops/cuda_lm, csrc/lm_trip.cu) against the
loop run op by op (lm._trip, lm._lm_eager, its plain version).

On the CPU: the stages never reach the wrapper and give the op-by-op
loop's results; the wrapper refuses CPU, float64 and strided tensors;
each rotation and translation problem reads its own bearing bank; a
stubbed lm_fixed leaves every stage at its start. On the card (marked
`cuda`, skipped without a GPU; `python -m pytest tests -m cuda`): one
kernel trip against lm._trip on the same state, whole stage solves
against lm._lm_eager, launches, flat memory and one host read a trip, at
the benchmark cells' shapes.

The card tests hold the kernels to the op-by-op loop bit for bit: a trip
takes its products and sums over more than one element with the op-by-op
trip's own aten calls and rounds every elementwise op as aten's kernels
do. Nothing looser would do: in corrected mode a start's trajectory
through a flat valley moves with the last bit, and a start chosen by
another rounding at a near tie can explain the matches several times
worse than the reference's (the benchmark's pose_cost_gap read 7.6 on
one pair of 32 when the kernels summed in their own order).
"""

import collections
import warnings

import pytest
import torch

from spherical_bundle_adjuster_tpu_torch.ops import cuda_lm
from spherical_bundle_adjuster_tpu_torch.problems import (
    LM_CPU_SHAPES, LM_SHAPES, eager_state, solve_stages, stage_problem, stage_systems,
)
from spherical_bundle_adjuster_tpu_torch.solver import lm
from spherical_bundle_adjuster_tpu_torch.utils import profiling
from spherical_bundle_adjuster_tpu_torch.utils.config import BaConfig

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# CPU


@pytest.mark.parametrize("lead,m", LM_CPU_SHAPES)
def test_the_stages_on_the_cpu_never_reach_the_kernel(monkeypatch, lead, m):
    """CPU tensors take lm._trip: no launch, no kernel trip counted, and
    results and reports equal to the op-by-op loop's."""
    prob = stage_problem(lead, m, seed=11)
    cfg = BaConfig()

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU reached the trip kernels' wrapper")

    launches = [k.launches for k in cuda_lm.KERNELS]
    for compat in (True, False):
        with monkeypatch.context() as mp:
            mp.setattr(cuda_lm, "start", refuse)
            mp.setattr(cuda_lm.Trips, "run", refuse)
            got = solve_stages(prob, cfg, compat, lm.lm_fixed)
        ref = solve_stages(prob, cfg, compat, lm._lm_eager)
        for (stage, res, rep, grew), (_, res_e, rep_e, grew_e) in zip(got, ref):
            assert not any("kernel" in k for k in grew) and grew == grew_e, grew
            assert torch.equal(res, res_e), stage
            for a, b in zip(rep, rep_e):
                assert torch.equal(a, b), stage
    assert [k.launches for k in cuda_lm.KERNELS] == launches


@pytest.mark.parametrize("fault", ["cpu", "float64", "strided"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(fault):
    """The wrapper raises, and never falls back, on CPU tensors, float64
    and a strided state, for the initial evaluation and for a trip."""
    b1, b2, valid, d0, r0, t0 = stage_problem((), 16)
    cfg = BaConfig()
    (_, system, problem, x0, kept, lower), *_ = stage_systems(
        (b1, b2, valid, d0, r0, t0), cfg, compat=False)
    _, state = eager_state(system, x0, cfg, lower, 0)
    counts = torch.zeros(2, dtype=torch.int32)
    if fault == "float64":
        x0 = x0.double()
        state = tuple(t.double() if t.is_floating_point() else t for t in state)
        match = "float32"
    elif fault == "strided":
        x0 = torch.stack([x0, x0], dim=-1)[..., 0]
        state = (x0,) + state[1:]
        match = "contiguous"
    else:
        match = "CUDA"
    with pytest.raises(ValueError, match=match):
        cuda_lm.start(problem, x0, cfg, lower, kept, counts)
    with pytest.raises(ValueError, match=match):
        cuda_lm.Trips(problem, state, cfg, lower, kept)


@pytest.mark.parametrize("lead,bank,rows", [
    ((), (), 1), ((4,), (1,), 1), ((3,), (3,), 3), ((3, 4), (3, 1), 3), ((3, 4), (), 1),
    ((3, 4), (3, 4), 12)])
def test_each_global_problem_reads_its_own_bank(lead, bank, rows):
    """A rotation or translation problem n reads bank row n // (N // B):
    that row is the problem's own bank, shared or not, and the banks keep
    one row for each bank that differs (one a pair, not one a start)."""
    m = 8
    b1 = torch.randn(bank + (m, 3), generator=torch.Generator().manual_seed(3))
    valid = torch.ones(lead + (m,), dtype=torch.bool)
    r0 = torch.zeros(lead + (3,))
    _, problem = lm._global_system(True, b1, b1, torch.ones(lead + (2,)), r0, r0, valid, BaConfig())
    own = b1.expand(lead + (m, 3)).reshape(-1, m, 3)
    n = own.shape[0]
    assert problem.b1.shape == (rows, m, 3) and problem.fixed.shape == (n, 3)
    for i in range(n):
        assert torch.equal(problem.b1[i // (n // rows)], own[i])


def test_a_stubbed_lm_fixed_leaves_every_stage_at_its_start(monkeypatch):
    """lm_fixed stubbed as benchmark/tests/test_bench_faults.py stubs it
    (through the module attribute every stage calls): depths, rotation
    and translation come back as they went in."""
    b1, b2, valid, d0, r0, t0 = stage_problem((3, 2), 24)
    cfg = BaConfig()

    def stuck_lm(cost_and_system, x0, cfg, max_iters=None, lower_bound=None):
        cost = cost_and_system(x0)[0]
        zero = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
        return x0, lm.StageReport(zero, cost, cost)

    monkeypatch.setattr(lm, "lm_fixed", stuck_lm)
    d, rep = lm.solve_depths(b1, b2, d0, r0, t0, valid, cfg)
    assert torch.equal(d, d0) and not rep.iterations.any()
    for compat in (True, False):
        pair = d0[..., 0, :] if compat else d0
        r, _ = lm.solve_rotation(b1, b2, pair, r0, t0, valid, cfg)
        t, _ = lm.solve_translation(b1, b2, pair, r0, t0, valid, cfg)
        assert torch.equal(r, r0) and torch.equal(t, t0)


# ---------------------------------------------------------------------------
# Card


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _assert_same(got, ref, what):
    for name, a, b in zip(("x", "H", "g", "cost", "cost_s", "lam", "it", "done"), got, ref):
        assert torch.equal(a, b), (what, name, int((a != b).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("lead,m", LM_SHAPES)
@pytest.mark.parametrize("compat", [True, False], ids=["compat", "corrected"])
def test_one_kernel_trip_matches_the_op_by_op_trip(dev, lead, m, compat):
    """From the same state, after 3 trips op by op (some problems done):
    the kernels' trip and lm._trip give the same state bit for bit, and
    the counts of it."""
    prob = stage_problem(lead, m, seed=7, dev=dev)
    cfg = BaConfig()
    for stage, system, problem, x0, kept, lower in stage_systems(prob, cfg, compat):
        step, state = eager_state(system, x0, cfg, lower, 3)
        ref = step(state)
        got = tuple(t.clone() for t in state)
        counts = torch.zeros(2, dtype=torch.int32, device=dev)
        cuda_lm.Trips(problem, got, cfg, lower, kept).run(counts)
        _assert_same(got, ref, stage)
        every = torch.ones_like(ref[-1])
        want = lm._active(ref[-1], torch.stack([every, every if kept is None else kept]))
        assert counts.tolist() == want.tolist(), stage


@pytest.mark.cuda
@pytest.mark.parametrize("lead,m", LM_SHAPES)
def test_kernel_solves_match_the_eager_loop(dev, monkeypatch, lead, m):
    """Each stage, solved through the kernels and by lm._lm_eager, in
    both modes: results and StageReports bit for bit, the same syncs,
    active and slots counts, one kernel trip a trip (syncs - 1 for a loop
    that stops on its read, syncs at the iteration cap), and no trip run
    op by op."""
    prob = stage_problem(lead, m, seed=7, dev=dev)
    cfg = BaConfig()

    def no_eager_trip(*args):
        raise AssertionError("a trip ran op by op on the card")

    for compat in (True, False):
        with monkeypatch.context() as mp:
            mp.setattr(lm, "_trip", no_eager_trip)
            got = solve_stages(prob, cfg, compat, lm.lm_fixed)
        ref = solve_stages(prob, cfg, compat, lm._lm_eager)
        for (stage, res, rep, grew), (_, res_e, rep_e, grew_e) in zip(got, ref):
            assert torch.equal(res, res_e), (stage, int((res != res_e).sum()))
            for name, a, b in zip(lm.StageReport._fields, rep, rep_e):
                assert torch.equal(a, b), (stage, name)
            trips = grew.pop(f"lm.{stage}.kernel_trips")
            assert grew == grew_e, (grew, grew_e)
            syncs = grew[f"lm.{stage}.syncs"]
            assert trips == syncs - 1 or trips == syncs == cfg.max_iterations, grew


@pytest.mark.cuda
def test_launches_a_trip_and_a_solve(dev):
    """Kernel.launches grows by one each a trip and one each an initial
    evaluation: DEPTH_POINT and DEPTH_SETTLE a depth trip; SOLVE, POINT
    and SETTLE a rotation or translation trip (SOLVE not when
    evaluating)."""
    prob = stage_problem((64, 4), 512, seed=3, dev=dev)
    cfg = BaConfig()
    for compat in (True, False):
        before = [k.launches for k in cuda_lm.KERNELS]
        out = solve_stages(prob, cfg, compat, lm.lm_fixed)
        trips = {stage: grew[f"lm.{stage}.kernel_trips"] for stage, _, _, grew in out}
        grew = [k.launches - b for k, b in zip(cuda_lm.KERNELS, before)]
        depth, others = trips["depth"], trips["rot"] + trips["tran"]
        assert grew == [depth + 1, depth + 1, others, others + 2, others + 2], (grew, trips)


@pytest.mark.cuda
def test_kernel_solves_leave_the_memory_as_they_found_it(dev):
    """After a solve, once its results are dropped, the memory allocated
    on the card is what it was before, and repeated solves reserve no
    more."""
    b1, b2, valid, d0, r0, t0 = stage_problem((64, 4), 512, seed=3, dev=dev)
    cfg = BaConfig()

    def solve():
        d, _ = lm.solve_depths(b1, b2, d0, r0, t0, valid, cfg)
        r, _ = lm.solve_rotation(b1, b2, d, r0, t0, valid, cfg)
        lm.solve_translation(b1, b2, d, r, t0, valid, cfg)

    solve()
    torch.cuda.synchronize()
    allocated, reserved = torch.cuda.memory_allocated(dev), []
    for _ in range(3):
        solve()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(dev) == allocated
        reserved.append(torch.cuda.memory_reserved(dev))
    assert reserved == [reserved[0]] * 3


@pytest.mark.cuda
def test_kernel_trips_read_the_host_once_a_trip(dev, monkeypatch):
    """A kernel solve makes the eager loop's host syncs, at the same
    place: one read a trip (torch's sync debug mode, as the benchmark
    counts them) and no other. Sync debug mode is switched on once
    before both solves: switching it on warns once a process that the
    mode is a prototype, which would fall to whichever solve came first."""
    b1, b2, valid, d0, r0, t0 = stage_problem((), 1024, seed=5, dev=dev)
    cfg = BaConfig()
    lm.solve_depths(b1, b2, d0, r0, t0, valid, cfg)  # builds and loads the kernels
    torch.cuda.synchronize()
    where = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
    try:
        for fn in (lm.lm_fixed, lm._lm_eager):
            before = profiling.COUNTS.copy()
            with warnings.catch_warnings(record=True) as caught, monkeypatch.context() as m:
                warnings.simplefilter("always")
                m.setattr(lm, "lm_fixed", fn)
                d, _ = lm.solve_depths(b1, b2, d0, r0, t0, valid, cfg)
                lm.solve_rotation(b1, b2, d, r0, t0, valid, cfg)
            where[fn.__name__] = collections.Counter(
                f"{w.filename}:{w.lineno}" for w in caught
                if "synchroniz" in str(w.message).lower())
            grew = profiling.COUNTS - before
            reads = sum(n for at, n in where[fn.__name__].items() if at.startswith(lm.__file__))
            assert reads == grew["lm.depth.syncs"] + grew["lm.rot.syncs"] > 4
            assert sum(where[fn.__name__].values()) == reads, where
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert set(where["lm_fixed"]) == set(where["_lm_eager"]), where
