"""solver/lm.lm_fixed's host loop on the CPU: each trip op by op, with
results, reports and LM counters equal to the op-by-op helper
(lm._lm_eager), and one host read of (every, kept) counts a trip, on
the stage problems of spherical_bundle_adjuster_tpu_torch/problems.py
that tests/test_torch_lm_kernel.py holds the card's trip kernels to."""

import pytest
import torch

from spherical_bundle_adjuster_tpu_torch.problems import LM_CPU_SHAPES, solve_stages, stage_problem
from spherical_bundle_adjuster_tpu_torch.solver import lm
from spherical_bundle_adjuster_tpu_torch.utils import profiling
from spherical_bundle_adjuster_tpu_torch.utils.config import BaConfig

torch.set_num_threads(1)


def _assert_same(got, ref, stage):
    assert torch.equal(got[0], ref[0]), (stage, (got[0] - ref[0]).abs().max().item())
    for name, a, b in zip(lm.StageReport._fields, got[1], ref[1]):
        assert torch.equal(a, b), (stage, name)


@pytest.mark.parametrize("lead,m", LM_CPU_SHAPES)
def test_the_loop_runs_op_by_op_on_the_cpu(lead, m):
    """CPU tensors take the loop op by op: no kernel trip, and results
    and LM counters equal to the eager helper's."""
    prob = stage_problem(lead, m, seed=len(lead))
    cfg = BaConfig()
    for compat in (True, False):
        got = solve_stages(prob, cfg, compat, lm.lm_fixed)
        ref = solve_stages(prob, cfg, compat, lm._lm_eager)
        for (stage, res, rep, grew), (_, res_e, rep_e, grew_e) in zip(got, ref):
            assert not any("kernel" in k for k in grew), grew
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
