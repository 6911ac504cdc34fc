"""Port parity: models/multiview (multi-keyframe Schur BA) against the JAX
package, function by function, on tests/test_multiview.synth_problem's
seeded problems (the JAX recipe; its fields go to the port as numpy)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spherical_bundle_adjuster_tpu.models import multiview as jmv
from spherical_bundle_adjuster_tpu_torch.models import multiview as tmv
from spherical_bundle_adjuster_tpu_torch.ops import segment
from test_multiview import synth_problem

torch.set_num_threads(1)

# the reference's functions, jitted (eager JAX dispatch is slow on the CPU)
_j_system = jax.jit(jmv._per_landmark_system)
_j_parts = jax.jit(jmv._schur_parts)
_j_dense = jax.jit(jmv._solve_cameras_dense, static_argnums=(3,))
_j_pcg = jax.jit(jmv._solve_cameras_pcg, static_argnums=(3, 4))


def _port(prob):
    return tmv.problem_from_numpy([np.asarray(f) for f in prob], "cpu")


def _with_invalid(prob):
    """The problem with 4 landmarks invalid (lm_valid false) and 10
    observation slots invalid, 3 of them at p = 0 exactly: a zero
    landmark seen by the gauge-fixed camera 0."""
    lm_valid = np.asarray(prob.lm_valid).copy()
    lm_valid[[1, 5, 9, 13]] = False
    obs_valid = np.asarray(prob.obs_valid).copy()
    obs_valid[[2, 3, 7, 11, 17, 19, 23], [0, 1, 2, 3, 0, 1, 2]] = False
    X = np.asarray(prob.landmarks).copy()
    cam = np.asarray(prob.obs_cam).copy()
    X[[30, 31, 32]] = 0.0
    cam[[30, 31, 32]] = np.arange(4)  # slot 0: camera 0, whose pose is 0
    obs_valid[[30, 31, 32], 0] = False
    return prob._replace(landmarks=jnp.asarray(X), obs_cam=jnp.asarray(cam),
                         obs_valid=jnp.asarray(obs_valid), lm_valid=jnp.asarray(lm_valid))


@pytest.fixture(scope="module")
def problem():
    prob, poses_gt, X = synth_problem(C=4, L=64, P=4, seed=0)
    return _with_invalid(prob), poses_gt, X


def test_invalid_fixture_has_zero_points(problem):
    prob, _, _ = problem
    p = jmv.transform_point(prob.poses[prob.obs_cam], prob.landmarks[:, None, :])
    assert int((np.abs(np.asarray(p)).sum(-1) == 0).sum()) == 3


def test_total_cost_parity(problem):
    """Cost at the noisy init within 1e-6 relative; at the ground truth
    under 1e-8 in both packages."""
    prob, poses_gt, X = problem
    np.testing.assert_allclose(float(tmv.total_cost(_port(prob))), float(jmv.total_cost(prob)),
                               rtol=1e-6)
    gt = prob._replace(poses=jnp.asarray(poses_gt), landmarks=jnp.asarray(X),
                       lm_valid=jnp.ones_like(prob.lm_valid), obs_valid=jnp.ones_like(prob.obs_valid),
                       obs_cam=synth_problem(C=4, L=64, P=4, seed=0)[0].obs_cam)
    assert float(jmv.total_cost(gt)) < 1e-8 and float(tmv.total_cost(_port(gt))) < 1e-8


def test_obs_residual_and_transform_point_parity():
    """Single observations, p = 0 included: residuals within 1e-6."""
    rng = np.random.default_rng(1)
    pose = rng.normal(scale=0.3, size=(8, 6)).astype(np.float32)
    pose[0] = 0.0
    X = rng.normal(scale=3.0, size=(8, 3)).astype(np.float32)
    X[0] = 0.0
    b = rng.normal(size=(8, 3)).astype(np.float32)
    np.testing.assert_allclose(tmv.transform_point(torch.from_numpy(pose), torch.from_numpy(X)).numpy(),
                               np.asarray(jmv.transform_point(jnp.asarray(pose), jnp.asarray(X))),
                               atol=2e-6)
    got = tmv.obs_residual(torch.from_numpy(pose), torch.from_numpy(X), torch.from_numpy(b)).numpy()
    want = np.asarray(jmv.obs_residual(jnp.asarray(pose), jnp.asarray(X), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got[0], b[0])


def test_jacobians_match_jacfwd(problem):
    """The closed-form Jacobians against the reference's jax.jacfwd on
    every observation, the invalid ones and the p = 0 slots included:
    finite everywhere, within 2e-5 (float32 level; the port's right
    Jacobian switches to its Taylor series at th^2 < 1e-2, the
    reference's rotation at th^2 < 1e-12, and camera 0 sits at th = 0)."""
    prob, _, _ = problem
    res, Jc, Jl, w = (x.numpy() for x in tmv._per_landmark_system(_port(prob)))
    rj, Jcj, Jlj, wj = (np.asarray(x) for x in _j_system(prob))
    for got, want in ((res, rj), (Jc, Jcj), (Jl, Jlj), (w, wj)):
        assert np.isfinite(got).all() and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("lam", [1e-3, 10.0])
def test_schur_parts_parity(problem, lam):
    """Every SchurParts field within 1e-4 of its largest entry."""
    prob, _, _ = problem
    tp = _port(prob)
    got = tmv._schur_parts(tp, torch.tensor(lam), tmv.obs_index(tp, "pcg"))
    want = _j_parts(prob, jnp.float32(lam))
    for name in tmv.SchurParts._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(1e-6, np.abs(w).max()),
                                   err_msg=name)
    # invalid landmarks: zeroed inverse blocks
    assert not got.Hll_inv[~tp.lm_valid].any()


@pytest.mark.parametrize("linear_solver", ["dense", "pcg"])
def test_gauss_newton_step_parity(problem, linear_solver):
    """One damped GN step on each linear solver against the reference as
    written (eager): poses within 2e-5, landmarks within 1e-4; invalid
    landmarks unchanged bit for bit. The landmark steps are the
    ill-conditioned part (depth along a landmark's short baselines): the
    reference's own jitted step differs from its eager one by up to 3e-4
    in landmark 3 here, from XLA's fusion alone."""
    prob, _, _ = problem
    tp = _port(prob)
    poses, lms = tmv.gauss_newton_step(tp, torch.tensor(1e-3), True, linear_solver, 100, 1e-6)
    pj, lj = jmv.gauss_newton_step(prob, jnp.float32(1e-3), True, linear_solver, 100, 1e-6)
    np.testing.assert_allclose(poses.numpy(), np.asarray(pj), atol=2e-5)
    np.testing.assert_allclose(lms.numpy(), np.asarray(lj), atol=1e-4)
    assert not poses[0].any()
    assert torch.equal(lms[~tp.lm_valid], tp.landmarks[~tp.lm_valid])


def test_camera_solves_parity(problem):
    """_solve_cameras_dense and _solve_cameras_pcg against the
    reference's on the same SchurParts: camera steps within 1e-5."""
    prob, _, _ = problem
    tp = _port(prob)
    lam = 1e-2
    parts_j = _j_parts(prob, jnp.float32(lam))
    parts = tmv.SchurParts(*(torch.from_numpy(np.array(f)) for f in parts_j))
    index = tmv.obs_index(tp, "dense")
    dense = tmv._solve_cameras_dense(parts, tp, torch.tensor(lam), True, index)
    pcg = tmv._solve_cameras_pcg(parts, tp, torch.tensor(lam), True, 100, 1e-7, index)
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(_j_dense(parts_j, prob, jnp.float32(lam), True)),
        atol=1e-5)
    np.testing.assert_allclose(
        pcg.numpy(), np.asarray(_j_pcg(parts_j, prob, jnp.float32(lam), True, 100, 1e-7)),
        atol=1e-5)


def test_camera_sums_are_the_reference_segment_sums(problem):
    """The port's fixed-order segment sum against jax.ops.segment_sum's
    sums (index_add_) for the observations' camera ids."""
    prob, _, _ = problem
    rng = np.random.default_rng(2)
    data = torch.from_numpy(rng.normal(size=(64 * 4, 6, 6)).astype(np.float32))
    cam = torch.from_numpy(np.array(prob.obs_cam)).reshape(-1)
    got = segment.segment_sum(data, segment.segments(cam, 4))
    want = torch.zeros(4, 6, 6).index_add_(0, cam.long(), data)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_segment_sum_drops_ids_outside_the_segments():
    """Rows with an id below 0 or at num_segments and beyond are dropped,
    and empty segments sum to zero, as in jax.ops.segment_sum (atol 1e-5)."""
    rng = np.random.default_rng(3)
    ids = rng.integers(-2, 9, 200).astype(np.int32)
    data = rng.normal(size=(200, 5)).astype(np.float32)
    got = segment.segment_sum(torch.from_numpy(data), segment.segments(torch.from_numpy(ids), 7))
    want = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), num_segments=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    empty = segment.segment_sum(torch.from_numpy(data), segment.segments(torch.full((200,), 3), 5))
    assert torch.equal(empty[[0, 1, 2, 4]], torch.zeros(4, 5))


# (C, L, linear_solver, seed, cg_iters, cg_tol): auto -> dense at C = 4,
# PCG on test_pcg_matches_dense's problem, auto -> pcg at C = 40
SOLVES = [(4, 64, "auto", 0, 100, 1e-5), (8, 128, "pcg", 2, 200, 1e-7),
          (40, 160, "auto", 1, 100, 1e-5)]


@pytest.mark.parametrize("C,L,linear_solver,seed,cg_iters,cg_tol", SOLVES)
def test_solve_multiview_parity(C, L, linear_solver, seed, cg_iters, cg_tol):
    """The cost trace within 1e-3 relative (or 1e-10, the float32 floor
    the traces end at), the solved poses within 2e-5 and landmarks within
    1e-4."""
    prob, _, _ = synth_problem(C=C, L=L, P=4, seed=seed)
    solved, costs = tmv.solve_multiview(_port(prob), num_iters=10, linear_solver=linear_solver,
                                        cg_iters=cg_iters, cg_tol=cg_tol)
    sj, cj = jmv.solve_multiview(prob, num_iters=10, linear_solver=linear_solver,
                                 cg_iters=cg_iters, cg_tol=cg_tol)
    assert costs.shape == (10,)
    np.testing.assert_allclose(costs.numpy(), np.asarray(cj), rtol=1e-3, atol=1e-10)
    np.testing.assert_allclose(solved.poses.numpy(), np.asarray(sj.poses), atol=2e-5)
    np.testing.assert_allclose(solved.landmarks.numpy(), np.asarray(sj.landmarks), atol=1e-4)
