"""Port parity: solver/pose_graph against the JAX package, function by
function, on tests/test_pose_graph's seeded graphs (the JAX recipes; their
fields go to the port as numpy)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spherical_bundle_adjuster_tpu.solver import pose_graph as jpg
from spherical_bundle_adjuster_tpu_torch.solver import pose_graph as tpg
import test_pose_graph as jtests

torch.set_num_threads(1)

# the reference's functions, jitted (eager JAX dispatch is slow on the CPU)
_j_blocks = jax.jit(jpg._edge_blocks, static_argnums=(2, 3))
_j_dense = jax.jit(jpg._gn_step_dense, static_argnums=(5, 6))
_j_pcg = jax.jit(jpg._gn_step_pcg, static_argnums=(5, 6, 7))


def _port(g):
    return tpg.graph_from_numpy([np.asarray(f) for f in g], "cpu")


def _graph(n, n_closures, seed):
    return jtests.TestScaledPoseGraph._make_graph(None, n, n_closures, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def graphs():
    """Near I: the ground truth (exact measurements, R_err = I up to
    float32). Far: the noisy init (rotation errors up to ~0.2 rad), with
    two edges weighted 0.5 and 3."""
    g, gt = _graph(24, 4, seed=4)
    g = g._replace(edge_weight=g.edge_weight.at[3].set(0.5).at[25].set(3.0))
    return {"near": g._replace(poses=jnp.asarray(gt)), "far": g}


def test_edge_residual_and_relative_pose_parity(graphs):
    g = graphs["far"]
    pi, pj = g.poses[g.edge_i], g.poses[g.edge_j]
    R, t = tpg.relative_pose(torch.from_numpy(np.array(pi)), torch.from_numpy(np.array(pj)))
    Rj, tj = jpg.relative_pose(pi, pj)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=2e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=2e-6)
    for key in ("near", "far"):
        g = graphs[key]
        tg = _port(g)
        got = tpg.edge_residual(tg.poses[tg.edge_i], tg.poses[tg.edge_j], tg.edge_rot, tg.edge_tran)
        want = jpg.edge_residual(g.poses[g.edge_i], g.poses[g.edge_j], g.edge_rot, g.edge_tran)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
        phi2 = (got[:, :3] ** 2).sum(-1)  # near: the log map's small branch on every edge
        assert bool((phi2 < 1e-12).all()) if key == "near" else bool((phi2 > 1e-4).all())
        np.testing.assert_allclose(
            tpg.graph_residuals(tg.poses.reshape(-1), tg).numpy(),
            np.asarray(jpg.graph_residuals(g.poses.reshape(-1), g)), atol=6e-6)
        np.testing.assert_allclose(float(tpg.total_cost(tg)), float(jpg.total_cost(g)),
                                   rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("key", ["near", "far"])
@pytest.mark.parametrize("robust_delta,tran_weight", [(None, 1.0), (0.05, 0.2), (0.2, 0.05)])
def test_edge_blocks_match_jacfwd(graphs, key, robust_delta, tran_weight):
    """The closed-form Jacobians against the reference's jax.jacfwd
    through its log map, with and without the Huber IRLS and the
    translation-row weight (the sequence pipeline's 0.05 / 0.2), near and
    far from R_err = I: finite, within 2e-5 of the largest entry (float32
    level); residuals within 6e-6."""
    g = graphs[key]
    res, Ji, Jj = (x.numpy() for x in tpg._edge_blocks(_port(g).poses, _port(g), robust_delta,
                                                        tran_weight))
    rj, Jij, Jjj = (np.asarray(x) for x in _j_blocks(g.poses, g, robust_delta, tran_weight))
    np.testing.assert_allclose(res, rj, atol=6e-6)
    for got, want in ((Ji, Jij), (Jj, Jjj)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())
    if robust_delta == 0.05 and key == "far":  # the Huber scale is active on some edge
        plain = tpg._edge_blocks(_port(g).poses, _port(g), None, tran_weight)[0].numpy()
        assert (np.abs(res) < np.abs(plain) - 1e-6).any()


@pytest.mark.parametrize("step", ["dense", "pcg"])
def test_gn_steps_parity(graphs, step):
    """_gn_step_dense and _gn_step_pcg on the same edge blocks: pose steps
    within 2e-5 of the reference's (relative to the largest); the fixed
    pose does not move."""
    g = graphs["far"]
    n = g.poses.shape[0]
    res, Ji, Jj = _j_blocks(g.poses, g, 0.05, 0.2)
    tg = _port(g)
    tres, tJi, tJj = (torch.from_numpy(np.array(x)) for x in (res, Ji, Jj))
    index = tpg.graph_index(tg, step)
    lam = 1e-2
    if step == "dense":
        got = tpg._gn_step_dense(index, tres, tJi, tJj, torch.tensor(lam), True, n)
        want = _j_dense(g, res, Ji, Jj, jnp.float32(lam), True, n)
    else:
        got = tpg._gn_step_pcg(tg, index, tres, tJi, tJj, torch.tensor(lam), True, n, 200, 1e-7)
        want = _j_pcg(g, res, Ji, Jj, jnp.float32(lam), True, n, 200, 1e-7)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())
    assert not got[0].any()


@pytest.mark.parametrize("n,n_closures,seed,kwargs", [
    (24, 4, 4, dict()),                                     # auto -> dense
    (80, 6, 5, dict()),                                     # auto -> pcg
    (24, 4, 6, dict(linear_solver="pcg", robust_delta=0.05, tran_weight=0.2)),
])
def test_optimize_pose_graph_parity(n, n_closures, seed, kwargs):
    """The cost trace within 1e-3 relative (or 1e-9) and the poses within
    2e-5."""
    g, _ = _graph(n, n_closures, seed)
    opt, costs = tpg.optimize_pose_graph(_port(g), num_iters=10, **kwargs)
    oj, cj = jpg.optimize_pose_graph(g, num_iters=10, **kwargs)
    assert costs.shape == (10,)
    np.testing.assert_allclose(costs.numpy(), np.asarray(cj), rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(opt.poses.numpy(), np.asarray(oj.poses), atol=2e-5)


def test_chain_with_loop_closures_parity():
    """Chained poses within 1e-5, edges identical, the odometry and
    closure weights as the reference computes them."""
    odo_r, odo_t, closure, _ = jtests.make_loop(n=9, drift=0.03, seed=2)
    c_raa, c_t = closure
    closures = [(0, 8, np.asarray(c_raa, np.float32), np.asarray(c_t, np.float32)),
                (2, 6, np.asarray(c_raa, np.float32) * 0.5, np.asarray(c_t, np.float32))]
    ow = np.linspace(0.5, 2.0, 8)
    kw = dict(closure_weight=4.0, odometry_weights=ow, closure_weights=[1.0, 0.25])
    got = tpg.chain_with_loop_closures(torch.from_numpy(np.array(odo_r)),
                                       torch.from_numpy(np.array(odo_t)), closures, **kw)
    want = jpg.chain_with_loop_closures(odo_r, odo_t, closures, **kw)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=1e-5)
    for f in ("edge_i", "edge_j", "edge_rot", "edge_tran", "edge_weight"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert got.edge_weight.dtype == torch.float32 and got.edge_i.dtype == torch.int32
    with pytest.raises(ValueError):
        tpg.chain_with_loop_closures(torch.from_numpy(np.array(odo_r)),
                                     torch.from_numpy(np.array(odo_t)), odometry_weights=ow[:3])
