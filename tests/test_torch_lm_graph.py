"""solver/lm.lm_fixed's host loop on the CPU: each trip op by op, with
results, reports and LM counters equal to the op-by-op helper
(lm._lm_eager), and one host read of (every, kept) counts a trip. The
stage problems and solve_stages here are shared with
tests/test_torch_lm_kernel.py, which holds the card's trip kernels to
the same loop."""

import pytest
import torch

from spherical_bundle_adjuster_tpu_torch.core import rotation
from spherical_bundle_adjuster_tpu_torch.solver import lm
from spherical_bundle_adjuster_tpu_torch.utils import profiling
from spherical_bundle_adjuster_tpu_torch.utils.config import BaConfig

torch.set_num_threads(1)

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


def _assert_same(got, ref, stage):
    assert torch.equal(got[0], ref[0]), (stage, (got[0] - ref[0]).abs().max().item())
    for name, a, b in zip(lm.StageReport._fields, got[1], ref[1]):
        assert torch.equal(a, b), (stage, name)


@pytest.mark.parametrize("lead,m", CPU_SHAPES)
def test_the_loop_never_captures_on_the_cpu(monkeypatch, lead, m):
    """CPU tensors take the loop op by op: no capture, no kernel trip,
    and results and LM counters equal to the eager helper's."""
    prob = stage_problem(lead, m, seed=len(lead))
    cfg = BaConfig()
    for compat in (True, False):
        got = solve_stages(prob, cfg, compat)
        ref = eager(monkeypatch, prob, cfg, compat)
        for (stage, res, rep, grew), (_, res_e, rep_e, grew_e) in zip(got, ref):
            assert not any("graph" in k or "kernel" in k for k in grew), grew
            assert grew == grew_e and grew[f"lm.{stage}.syncs"] > 2
            _assert_same((res, rep), (res_e, rep_e), stage)


def test_the_loop_reads_one_count_pair_a_trip_on_the_cpu(monkeypatch):
    """Each trip's host read is one (every, kept) pair of counts, and the
    loop stops at the first read that finds no problem active."""
    b1, b2, valid, d0, r0, t0 = stage_problem((), 64)
    cfg = BaConfig()
    reads = []
    real = lm._active

    def spy(done, kept):
        n = real(done, kept)
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
