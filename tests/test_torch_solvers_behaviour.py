"""The JAX package's single-device tests of the global solvers
(tests/test_multiview.py, tests/test_pose_graph.py), run against the port
with the same data and the same bounds as their JAX originals."""

import numpy as np
import jax.numpy as jnp
import torch

from spherical_bundle_adjuster_tpu_torch.models import multiview as tmv
from spherical_bundle_adjuster_tpu_torch.solver import pose_graph as tpg
import test_multiview as jmv_tests
import test_pose_graph as jpg_tests

torch.set_num_threads(1)


def _problem(**kw):
    prob, poses_gt, X = jmv_tests.synth_problem(**kw)
    return tmv.problem_from_numpy([np.asarray(f) for f in prob], "cpu"), poses_gt, X


def _graph(g):
    return tpg.graph_from_numpy([np.asarray(f) for f in g], "cpu")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# TestMultiView


def test_cost_zero_at_ground_truth():
    prob, poses_gt, X = _problem()
    p = prob._replace(poses=_t(poses_gt), landmarks=_t(X))
    assert float(tmv.total_cost(p)) < 1e-8


def test_converges_from_noisy_init():
    prob, poses_gt, X = _problem()
    c0 = float(tmv.total_cost(prob))
    solved, costs = tmv.solve_multiview(prob, num_iters=15)
    c1 = float(costs[-1])
    assert c1 < 1e-6 * max(c0, 1.0), f"cost {c0} -> {c1}"
    ang, terr = jmv_tests.pose_errors(solved.poses.numpy(), poses_gt)
    assert np.max(ang) < 0.5, f"rot errs {ang}"
    assert np.max(terr) < 0.05, f"tran errs {terr}"


def test_respects_invalid_landmarks():
    prob, poses_gt, X = _problem(L=32)
    lmv = prob.lm_valid.clone()
    lmv[:8] = False
    prob = prob._replace(lm_valid=lmv)
    solved, costs = tmv.solve_multiview(prob, num_iters=10)
    np.testing.assert_array_equal(solved.landmarks[:8].numpy(), prob.landmarks[:8].numpy())


# TestPcgCameraSystem


def test_pcg_matches_dense():
    prob, poses_gt, X = _problem(C=8, L=128, P=4, seed=2)
    solved_d, costs_d = tmv.solve_multiview(prob, num_iters=12, linear_solver="dense")
    solved_p, costs_p = tmv.solve_multiview(prob, num_iters=12, linear_solver="pcg",
                                            cg_iters=200, cg_tol=1e-7)
    assert float(costs_p[-1]) < 1e-6 * max(float(costs_p[0]), 1.0)
    np.testing.assert_allclose(solved_d.poses.numpy(), solved_p.poses.numpy(), atol=1e-3)


# TestPoseGraph


def test_zero_residual_at_consistent_graph():
    odo_r, odo_t, closure, gt = jpg_tests.make_loop(drift=0.0)
    g = tpg.chain_with_loop_closures(_t(odo_r), _t(odo_t))
    assert float(tpg.total_cost(g)) < 1e-8


def test_loop_closure_reduces_drift():
    odo_r, odo_t, closure, gt = jpg_tests.make_loop(n=6, drift=0.03)
    c_raa, c_t = closure
    g = tpg.chain_with_loop_closures(
        _t(odo_r), _t(odo_t),
        closures=[(0, 5, np.asarray(c_raa, np.float32), np.asarray(c_t, np.float32))],
        closure_weight=10.0,
    )
    err_before = np.linalg.norm(g.poses.numpy()[-1][3:] - gt[-1][3:])
    opt, costs = tpg.optimize_pose_graph(g, num_iters=25)
    err_after = np.linalg.norm(opt.poses.numpy()[-1][3:] - gt[-1][3:])
    assert float(costs[-1]) < float(costs[0])
    assert err_after < err_before, (err_before, err_after)
    assert err_after < 0.6 * err_before


def test_first_pose_fixed():
    odo_r, odo_t, closure, gt = jpg_tests.make_loop(n=5, drift=0.05)
    g = tpg.chain_with_loop_closures(_t(odo_r), _t(odo_t))
    opt, _ = tpg.optimize_pose_graph(g, num_iters=10)
    np.testing.assert_allclose(opt.poses.numpy()[0], 0.0, atol=1e-7)


# TestScaledPoseGraph


def _make_graph(n, n_closures, rng):
    g, gt = jpg_tests.TestScaledPoseGraph._make_graph(None, n, n_closures, rng)
    return _graph(g), gt


def test_512_chain_32_closures_pcg():
    g, gt = _make_graph(512, 32, np.random.default_rng(3))
    opt, costs = tpg.optimize_pose_graph(g, num_iters=15, linear_solver="pcg", cg_iters=120)
    assert float(costs[-1]) < 1e-4 * float(costs[0]), (float(costs[0]), float(costs[-1]))
    t_err = np.linalg.norm(opt.poses.numpy()[:, 3:] - gt[:, 3:], axis=-1)
    assert np.median(t_err) < 0.02, f"median t err {np.median(t_err)}"


def test_dense_and_pcg_agree():
    g, gt = _make_graph(24, 4, np.random.default_rng(4))
    opt_d, costs_d = tpg.optimize_pose_graph(g, num_iters=12, linear_solver="dense")
    opt_p, costs_p = tpg.optimize_pose_graph(g, num_iters=12, linear_solver="pcg", cg_iters=200,
                                             cg_tol=1e-7)
    assert float(costs_d[-1]) < 1e-4 * float(costs_d[0])
    assert float(costs_p[-1]) < 1e-4 * float(costs_p[0])
    np.testing.assert_allclose(opt_d.poses.numpy(), opt_p.poses.numpy(), atol=5e-3)
