"""Port parity: utils/checkpoint (npz save / load in the JAX package's
layout, and the checkpointed multi-keyframe solve) against the JAX
package, on tests/test_multiview.synth_problem's seeded problems."""

import os

import numpy as np
import jax
import pytest
import torch

import torch_ranks
from spherical_bundle_adjuster_tpu.models import multiview as jmv
from spherical_bundle_adjuster_tpu.utils import checkpoint as jckpt
from spherical_bundle_adjuster_tpu_torch.models import multiview as tmv
from spherical_bundle_adjuster_tpu_torch.parallel import launch
from spherical_bundle_adjuster_tpu_torch.utils import checkpoint as ckpt
from test_multiview import synth_problem

torch.set_num_threads(1)


def _fields(prob):
    return [np.asarray(f) for f in prob]


def _port(prob):
    return tmv.problem_from_numpy(_fields(prob), "cpu")


@pytest.fixture(scope="module")
def problem():
    prob, _, _ = synth_problem(C=3, L=32, P=3)
    return prob


def _assert_equal_problems(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


@pytest.mark.parametrize("step", [5, None])
def test_save_load_roundtrip(problem, tmp_path, step):
    """tests/test_checkpoint.py::test_save_load_roundtrip through the port:
    every leaf back bit for bit with its dtype, and the step (None kept)."""
    prob = _port(problem)
    path = str(tmp_path / "ck")
    assert ckpt.save_checkpoint(path, prob, step=step) == "npz"
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]  # no temporary file left
    restored, got_step = ckpt.load_checkpoint(path, prob)
    assert got_step == step
    assert type(restored) is tmv.MultiViewProblem
    _assert_equal_problems(restored, prob)


def test_load_takes_dtype_and_container_from_like(tmp_path):
    """Nested tuples, lists, dicts (keys sorted, as jax.tree) and None
    round-trip; each leaf takes the dtype of its leaf in `like`."""
    tree = {"b": (torch.arange(3, dtype=torch.int32), [torch.ones(2, 2)]), "a": None,
            "c": torch.tensor(True)}
    ckpt.save_checkpoint(str(tmp_path / "t"), tree, step=2)
    like = {"b": (torch.zeros(3, dtype=torch.int64), [torch.zeros(2, 2, dtype=torch.float64)]),
            "a": None, "c": torch.tensor(False)}
    got, step = ckpt.load_checkpoint(str(tmp_path / "t"), like)
    assert step == 2 and got["a"] is None and isinstance(got["b"], tuple)
    assert got["b"][0].dtype == torch.int64 and got["b"][0].tolist() == [0, 1, 2]
    assert got["b"][1][0].dtype == torch.float64 and got["b"][1][0].sum().item() == 4.0
    assert got["c"].item() is True
    with np.load(str(tmp_path / "t.npz")) as data:
        assert data["arr_0"].dtype == np.int32  # "b" before "c"; None holds no leaf
        assert data["arr_2"].dtype == np.bool_


def test_reference_reads_a_port_checkpoint(problem, tmp_path):
    """The JAX package's load_checkpoint reads the port's file through its
    npz branch: equal leaves and step, and the port writes the structure
    as jax's str(treedef) of the same problem."""
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, _port(problem), step=3)
    restored, step = jckpt.load_checkpoint(path, problem)
    assert step == 3
    for a, b in zip(jax.tree.leaves(problem), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(path + ".npz") as data:
        assert data["__treedef__"].tobytes().decode() == str(jax.tree.structure(problem))


def test_resumable_solve_continues(problem, tmp_path):
    """tests/test_checkpoint.py::test_resumable_solve_continues through the
    port: 2 rounds of 5, then a call on the finished checkpoint runs no
    round, and the solve converges (cost < 1e-5)."""
    prob = _port(problem)
    path = str(tmp_path / "solve_ck")
    p1, costs1 = ckpt.solve_multiview_resumable(prob, path, total_iters=10, iters_per_round=5)
    assert costs1.shape[0] == 10
    p2, costs2 = ckpt.solve_multiview_resumable(prob, path, total_iters=10, iters_per_round=5)
    assert costs2.shape[0] == 0
    _assert_equal_problems(p2, p1)
    assert float(tmv.total_cost(p1)) < 1e-5


def test_interrupted_then_resumed_equals_uninterrupted(tmp_path):
    """Interrupted after 2 of 4 rounds (total_iters=4), then resumed
    (total_iters=8): poses, landmarks and the cost trace bit for bit those
    of one uninterrupted call into another path."""
    prob = _port(synth_problem(C=4, L=64, P=4, pose_noise=0.05, seed=1)[0])
    _, first = ckpt.solve_multiview_resumable(prob, str(tmp_path / "a"), total_iters=4,
                                              iters_per_round=2)
    resumed, rest = ckpt.solve_multiview_resumable(prob, str(tmp_path / "a"), total_iters=8,
                                                   iters_per_round=2)
    whole, costs = ckpt.solve_multiview_resumable(prob, str(tmp_path / "b"), total_iters=8,
                                                  iters_per_round=2)
    assert first.shape[0] == 4 and rest.shape[0] == 4
    _assert_equal_problems(resumed, whole)
    assert torch.equal(torch.cat([first, rest]), costs)


def test_resumable_solve_matches_the_reference(tmp_path):
    """The port's checkpointed solve against the JAX package's on the same
    problem and rounds (3 rounds of 4 iterations, the damping restarted
    each round in both): poses within 2e-5 and landmarks within 1e-4
    (tests/test_torch_multiview.py's tolerances for solve_multiview),
    costs within rtol 1e-3."""
    prob, _, _ = synth_problem(C=4, L=64, P=4, seed=0)
    solved, costs = ckpt.solve_multiview_resumable(_port(prob), str(tmp_path / "port"),
                                                   total_iters=12, iters_per_round=4)
    j_solved, j_costs = jckpt.solve_multiview_resumable(prob, str(tmp_path / "jax"),
                                                        total_iters=12, iters_per_round=4)
    np.testing.assert_allclose(costs.numpy(), j_costs, rtol=1e-3, atol=1e-10)
    np.testing.assert_allclose(solved.poses.numpy(), np.asarray(j_solved.poses), atol=2e-5)
    np.testing.assert_allclose(solved.landmarks.numpy(), np.asarray(j_solved.landmarks),
                               atol=1e-4)


def test_resumable_solve_over_a_two_rank_mesh(tmp_path):
    """mesh= over 2 gloo ranks (interrupted after 2 of 4 rounds, then
    resumed from the file rank 0 wrote): only rank 0 writes, once a round;
    both ranks end bit-identical; the result equals the mesh=None solve
    up to the order of the sharded sums: poses within 1e-6 (the sharded
    solve's tolerance in tests/test_torch_dist_ba.py), landmarks within
    2e-5 (the ill-conditioned landmark step; measured 5.2e-6 on norms of
    3-7), costs within 1e-5 of the first cost (measured 3e-7 of it)."""
    prob, _, _ = synth_problem(C=4, L=64, P=4, seed=0)
    ranks = launch.run_ranks(torch_ranks.checkpoint_cases, 2,
                             args=(_fields(prob), str(tmp_path / "mesh")), threads=1,
                             timeout_s=torch_ranks.TIMEOUT.total_seconds(), deadline_s=300)
    assert ranks[0]["writes"] == [1, 2, 3, 4] and ranks[1]["writes"] == []
    for k in ("poses", "landmarks", "costs"):
        assert torch.equal(ranks[0][k], ranks[1][k]), k
    single, costs = ckpt.solve_multiview_resumable(_port(prob), str(tmp_path / "single"),
                                                   total_iters=8, iters_per_round=2)
    np.testing.assert_allclose(ranks[0]["poses"].numpy(), single.poses.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["landmarks"].numpy(), single.landmarks.numpy(), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(ranks[0]["costs"].numpy(), costs.numpy(), rtol=0,
                               atol=1e-5 * float(costs[0]))
