"""solver/lm.lm_fixed's trips as CUDA graphs: on the card, every trip
after the first replays one captured trip, with results, reports and
LM counters equal to the loop run op by op (lm._lm_eager); on the CPU
the loop never captures. The card tests are marked `cuda` and skip
without a GPU; run them with `python -m pytest tests -m cuda`."""

import collections
import warnings

import pytest
import torch

from spherical_bundle_adjuster_tpu_torch.core import rotation
from spherical_bundle_adjuster_tpu_torch.solver import lm
from spherical_bundle_adjuster_tpu_torch.utils import profiling
from spherical_bundle_adjuster_tpu_torch.utils.config import BaConfig

torch.set_num_threads(1)

# (leading axes, matches): one start of a 2K compat pair; 64 pairs x 4
# starts of the corrected 512 batch
CARD_SHAPES = [((), 1024), ((64, 4), 512)]
CPU_SHAPES = [((), 96), ((3, 2), 40)]


def stage_problem(lead, m, seed=0):
    """A noisy two-view scene's bearing banks, shared by the starts,
    with 10% of the match slots invalid, and the stages' starts: unit
    depths and a pose off the true one. On the CPU."""
    g = torch.Generator().manual_seed(seed)
    bank = lead[:-1] + (1,) if lead else ()

    def randn(*shape):
        return torch.randn(shape, generator=g)

    b1 = torch.nn.functional.normalize(randn(*bank, m, 3), dim=-1)
    depth = 2.0 + 3.0 * torch.rand(bank + (m,), generator=g)
    r_true, t_true = 0.1 * randn(*bank, 3), 0.3 * randn(*bank, 3)
    x2 = rotation.rotate_angle_axis(r_true[..., None, :].expand(b1.shape), depth[..., None] * b1)
    b2 = torch.nn.functional.normalize(x2 - t_true[..., None, :] + 0.01 * randn(*bank, m, 3), dim=-1)
    valid = torch.rand(lead + (m,), generator=g) < 0.9
    d0 = torch.ones(lead + (m, 2))
    r0 = (r_true + 0.05 * randn(*lead, 3)).expand(lead + (3,)).contiguous()
    t0 = (t_true + 0.1 * randn(*lead, 3)).expand(lead + (3,)).contiguous()
    return b1, b2, valid, d0, r0, t0


def solve_stages(prob, cfg, compat):
    """The BCD stages in order, each from the last one's result, as
    run_two_view solves them: depths, rotation, translation (compat: on
    the first match's depth pair, which every match shares). Returns
    [(stage, result, StageReport, the stage's growth of COUNTS)]."""
    b1, b2, valid, d0, r0, t0 = prob
    out = []

    def run(stage, fn, *args):
        before = profiling.COUNTS.copy()
        res, rep = fn(*args)
        out.append((stage, res, rep, profiling.COUNTS - before))
        return res

    d = run("depth", lm.solve_depths, b1, b2, d0, r0, t0, valid, cfg)
    pair = d[..., 0, :] if compat else d
    r = run("rot", lm.solve_rotation, b1, b2, pair, r0, t0, valid, cfg)
    run("tran", lm.solve_translation, b1, b2, pair, r, t0, valid, cfg)
    return out


def eager(monkeypatch, prob, cfg, compat):
    """solve_stages with every LM trip run op by op."""
    with monkeypatch.context() as m:
        m.setattr(lm, "lm_fixed", lm._lm_eager)
        return solve_stages(prob, cfg, compat)


def _lm_keys(counts, stage):
    return {k: v for k, v in counts.items() if k.startswith(f"lm.{stage}.")}


def _assert_same(got, ref, stage):
    assert torch.equal(got[0], ref[0]), (stage, (got[0] - ref[0]).abs().max().item())
    for name, a, b in zip(lm.StageReport._fields, got[1], ref[1]):
        assert torch.equal(a, b), (stage, name)


@pytest.mark.parametrize("lead,m", CPU_SHAPES)
def test_the_loop_never_captures_on_the_cpu(monkeypatch, lead, m):
    """CPU tensors take the loop op by op: no capture, no replayed trip,
    and results and LM counters equal to the eager helper's."""
    prob = stage_problem(lead, m, seed=len(lead))
    cfg = BaConfig()
    for compat in (True, False):
        got = solve_stages(prob, cfg, compat)
        ref = eager(monkeypatch, prob, cfg, compat)
        for (stage, res, rep, grew), (_, res_e, rep_e, grew_e) in zip(got, ref):
            assert not any("graph" in k for k in grew), grew
            assert grew == grew_e and grew[f"lm.{stage}.syncs"] > 2
            _assert_same((res, rep), (res_e, rep_e), stage)


def test_the_loop_reads_one_count_pair_a_trip_on_the_cpu(monkeypatch):
    """Each trip's host read is one (every, kept) pair of counts, and the
    loop stops at the first read that finds no problem active."""
    b1, b2, valid, d0, r0, t0 = stage_problem((), 64)
    cfg = BaConfig()
    reads = []
    real = lm._active

    def spy(done, kept, out=None):
        n = real(done, kept, out)
        reads.append(n.tolist())
        return n

    monkeypatch.setattr(lm, "_active", spy)
    before = profiling.COUNTS.copy()
    _, rep = lm.solve_depths(b1, b2, d0, r0, t0, valid, cfg)
    grew = profiling.COUNTS - before
    trips = int(rep.iterations.max())  # every trip iterates the slowest valid match
    assert grew["lm.depth.syncs"] == len(reads) >= trips + 1
    assert reads[-1] == [0, 0] and all(n > 0 for n, _ in reads[:-1])
    assert all(k <= n for n, k in reads) and grew["lm.depth.active"] == sum(k for _, k in reads)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("lead,m", CARD_SHAPES)
def test_graphed_trips_match_the_eager_loop_on_the_card(dev, monkeypatch, lead, m):
    """Each stage on the card, graphed and op by op: x and every
    StageReport field bit-identical, the same syncs, active and slots
    counts, one capture a stage that runs more than one trip, and every
    trip after the first a replay (graph_trips = syncs - 2 for a stage
    that converged before its iteration cap)."""
    prob = [x.to(dev) for x in stage_problem(lead, m, seed=7)]
    cfg = BaConfig()
    for compat in (True, False):
        got = solve_stages(prob, cfg, compat)
        ref = eager(monkeypatch, prob, cfg, compat)
        for (stage, res, rep, grew), (_, res_e, rep_e, grew_e) in zip(got, ref):
            _assert_same((res, rep), (res_e, rep_e), stage)
            counts = _lm_keys(grew, stage)
            trips = counts[f"lm.{stage}.graph_trips"] + 1
            assert trips > 1 and grew["lm.graphs"] == 1, grew
            del counts[f"lm.{stage}.graph_trips"]
            assert counts == _lm_keys(grew_e, stage) and "lm.graphs" not in grew_e
            syncs = counts[f"lm.{stage}.syncs"]
            if trips < cfg.max_iterations:
                assert syncs == trips + 1
                assert grew[f"lm.{stage}.graph_trips"] == syncs - 2


@pytest.mark.cuda
def test_the_graph_and_its_memory_go_with_the_call(dev):
    """After a graphed solve, once its results are dropped, the memory
    allocated on the card is what it was before the call, and repeated
    solves reserve no more: each capture reuses the pool's blocks (the
    first capture on the card also allocates the capture stream's cuBLAS
    workspace, held for the process, so one solve runs first)."""
    b1, b2, valid, d0, r0, t0 = (x.to(dev) for x in stage_problem((64, 4), 512, seed=3))
    cfg = BaConfig()

    def solve():
        d, _ = lm.solve_depths(b1, b2, d0, r0, t0, valid, cfg)
        lm.solve_rotation(b1, b2, d, r0, t0, valid, cfg)

    solve()
    torch.cuda.synchronize()
    allocated, reserved = torch.cuda.memory_allocated(dev), []
    before = profiling.COUNTS.copy()
    for _ in range(3):
        solve()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(dev) == allocated
        reserved.append(torch.cuda.memory_reserved(dev))
    assert (profiling.COUNTS - before)["lm.graphs"] == 6
    assert reserved == [reserved[0]] * 3


@pytest.mark.cuda
def test_graphed_trips_read_the_host_once_a_trip(dev, monkeypatch):
    """A graphed solve makes the eager loop's host syncs, at the same
    places: one read a trip (torch's sync debug mode, as the benchmark
    counts them), and no warning that names a synchronizing operation
    which the eager loop does not raise. Sync debug mode is switched on
    once before both solves: switching it on warns once a process that
    the mode is a prototype ("... does not yet detect all synchronizing
    operations"), which would fall to whichever solve came first."""
    b1, b2, valid, d0, r0, t0 = (x.to(dev) for x in stage_problem((), 1024, seed=5))
    cfg = BaConfig()
    lm.solve_depths(b1, b2, d0, r0, t0, valid, cfg)  # not the process's first capture
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
                lm.solve_depths(b1, b2, d0, r0, t0, valid, cfg)
            where[fn.__name__] = collections.Counter(
                f"{w.filename}:{w.lineno}" for w in caught
                if "synchroniz" in str(w.message).lower())
            reads = sum(n for at, n in where[fn.__name__].items() if at.startswith(lm.__file__))
            assert reads == (profiling.COUNTS - before)["lm.depth.syncs"] > 2
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not where["lm_fixed"] - where["_lm_eager"], where
    assert where["lm_fixed"] == where["_lm_eager"], where
