"""Port parity: the consensus initial guess and the BCD stages on the
synthetic bearings of tests/test_solver.synth_two_view. torch cannot draw
jax.random.gumbel, so the reference's draws are injected."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spherical_bundle_adjuster_tpu.solver import epipolar as jepi, lm as jlm
from spherical_bundle_adjuster_tpu.models import twoview as jtv
from spherical_bundle_adjuster_tpu.utils.config import BaConfig, PipelineConfig, RansacConfig
from spherical_bundle_adjuster_tpu_torch.core import rotation as trot
from spherical_bundle_adjuster_tpu_torch.solver import epipolar as tepi, lm as tlm
from spherical_bundle_adjuster_tpu_torch.models import twoview as ttv
from spherical_bundle_adjuster_tpu_torch.utils import config as tconfig
from test_solver import synth_two_view

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _gumbel(key, num_trials, m):
    """The reference's per-trial draws (ransac_trials: split, then gumbel)."""
    keys = jax.random.split(key, num_trials)
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (m,)))(keys))


@pytest.fixture(scope="module")
def data():
    b1, b2, valid, R, t, d1, d2 = synth_two_view(n=64, cap=96)
    return b1, b2, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_initial_guess_parity(data, seed):
    """Euler and (sign-resolved) t within 1e-3 from the same draws."""
    b1, b2, valid = data
    cfg = RansacConfig()
    key = jax.random.PRNGKey(seed)
    gj = jepi.initial_guess(b1, b2, valid, key, cfg)
    g = _gumbel(key, cfg.num_trials, b1.shape[0])
    gt = tepi.initial_guess(_t(b1), _t(b2), _t(valid), None, tconfig.from_reference(cfg),
                            gumbel=torch.from_numpy(g))
    assert bool(gj.ok) and bool(gt.ok)
    assert int(gt.num_candidates) == int(gj.num_candidates)
    np.testing.assert_allclose(gt.euler.numpy(), np.asarray(gj.euler), atol=1e-3)
    np.testing.assert_allclose(gt.translation.numpy(), np.asarray(gj.translation), atol=1e-3)


def test_consensus_scores_parity(data):
    rng = np.random.default_rng(4)
    euler = rng.normal(scale=0.1, size=(40, 3)).astype(np.float32)
    valid = rng.random(40) > 0.3
    sj, nj = jepi.consensus_scores(jnp.asarray(euler), jnp.asarray(valid), 0.2, 0.8)
    st, nt = tepi.consensus_scores(_t(euler), _t(valid), 0.2, 0.8)
    assert int(nt) == int(nj)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)


def _depth_valley(b1, b2, r, t, d_test, d_ref, ba):
    """Per match, in float64 at the reference's depths: the component of
    d_test - d_ref along the stiff eigenvector of the depth problem's
    J^T J, and the relative gap between the two depth pairs' costs."""
    b1, b2, r, t = (torch.from_numpy(np.asarray(x, np.float64)) for x in (b1, b2, r, t))
    d_test, d_ref = (torch.from_numpy(np.asarray(x, np.float64)) for x in (d_test, d_ref))

    def cost(d):
        rep = tlm.reprojection_residual(b1, b2, d[:, 0], d[:, 1], r, t)
        bar = ba.barrier_lambda * torch.exp(-ba.barrier_c * d)
        return 0.5 * (torch.sum(rep * rep, -1) + torch.sum(bar * bar, -1))

    j_rep = torch.stack([-trot.rotate_angle_axis(r.expand(b1.shape), b1), b2], dim=-1)
    bar = ba.barrier_lambda * torch.exp(-ba.barrier_c * d_ref)
    H = j_rep.transpose(-1, -2) @ j_rep + torch.diag_embed((ba.barrier_c * bar) ** 2)
    stiff = torch.linalg.eigh(H)[1][..., :, 1]
    across = torch.abs(torch.sum((d_test - d_ref) * stiff, -1))
    c_ref = cost(d_ref)
    return across.numpy(), (torch.abs(cost(d_test) - c_ref) / c_ref).numpy()


def test_bcd_stages_parity(data):
    """d, rot and tran stages from the same init: r, t atol 1e-4; d atol
    1e-3 across each match's cost valley, and along it no farther than
    the reference strays from itself.

    Each match's depth problem has a valley that is flat along the (d1, d2)
    scale direction to float32 resolution. Both solvers follow the same
    path to ~1e-6 per iteration, but the ftol stop (|dcost| <= 1e-6 cost,
    a few ulps of the cost) fires an iteration or more apart, a few 1e-3
    along the valley. The reference does the same to itself: its batched
    solve_depths and the same stage vmapped over one-match problems land
    up to 3.7e-3 apart on this data. So each match is held, in float64,
    to its cost (rtol 1e-6), to its depths across the valley (atol 1e-4),
    and to max(1e-3, 1.2 x the reference's largest self-gap) in all."""
    b1, b2, valid = data
    ba = BaConfig()
    tba = tconfig.from_reference(ba)
    r0 = jnp.asarray([-0.07, 0.11, -0.19], jnp.float32)
    t0 = jnp.asarray([0.3, 0.2, -0.1], jnp.float32)
    d0 = jnp.ones((b1.shape[0], 2), jnp.float32)
    dj, rep_dj = jlm.solve_depths(b1, b2, d0, r0, t0, valid, ba)
    dt, rep_dt = tlm.solve_depths(_t(b1), _t(b2), _t(d0), _t(r0), _t(t0), _t(valid), tba)
    np.testing.assert_allclose(float(rep_dt.final_cost), float(rep_dj.final_cost), rtol=1e-5)
    np.testing.assert_allclose(float(rep_dt.initial_cost), float(rep_dj.initial_cost), rtol=1e-6)
    one = lambda a, b, c, v: jlm.solve_depths(a[None], b[None], c[None], r0, t0, v[None], ba)[0][0]
    dj_single = np.asarray(jax.vmap(one)(b1, b2, d0, valid))
    self_gap = np.abs(dj_single - np.asarray(dj)).max()
    v = np.asarray(valid)
    dd = np.abs(dt.numpy() - np.asarray(dj)).max(-1)
    assert dd.max() <= max(1e-3, 1.2 * self_gap), (dd.max(), self_gap)
    across, dcost = _depth_valley(b1, b2, r0, t0, dt.numpy(), dj, ba)
    assert across[v].max() <= 1e-4
    assert dcost[v].max() <= 1e-6
    np.testing.assert_array_equal(dt.numpy()[~v], np.asarray(dj)[~v])

    pair = jnp.stack([dj[0, 0], dj[1, 0]])
    rj, rep_rj = jlm.solve_rotation(b1, b2, pair, r0, t0, valid, ba)
    rt, rep_rt = tlm.solve_rotation(_t(b1), _t(b2), _t(pair), _t(r0), _t(t0), _t(valid), tba)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(float(rep_rt.final_cost), float(rep_rj.final_cost), rtol=1e-4)

    tj, _ = jlm.solve_translation(b1, b2, pair, rj, t0, valid, ba)
    tt, _ = tlm.solve_translation(_t(b1), _t(b2), _t(pair), _t(rj), _t(t0), _t(valid), tba)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)

    # per-match depths (the non-compat depth layout) take the same path
    rj2, _ = jlm.solve_rotation(b1, b2, dj, r0, t0, valid, ba)
    rt2, _ = tlm.solve_rotation(_t(b1), _t(b2), _t(dj), _t(r0), _t(t0), _t(valid), tba)
    np.testing.assert_allclose(rt2.numpy(), np.asarray(rj2), atol=1e-4)


@pytest.mark.parametrize("angle", [0.0, 0.03, 0.0999, 0.1001, 0.8, 2.5])
def test_rotation_jacobian_matches_autodiff(data, angle):
    """The rot stage's closed-form d res / d r against the reference's
    jax.jacfwd of the same residual, on both sides of the Taylor switch
    at 0.1 rad: atol 2e-5 (float32 rounding of |x1| <= 6)."""
    b1, b2, _ = data
    r = np.array([0.6, -0.48, 0.64], np.float32) * angle
    t = np.array([0.3, 0.2, -0.1], np.float32)
    d1 = np.linspace(1.0, 6.0, b1.shape[0]).astype(np.float32)
    d2 = d1[::-1].copy()
    jj = jax.jacfwd(lambda rr: jlm.reprojection_residual(b1, b2, d1, d2, rr, t))(jnp.asarray(r))
    jt = trot.rotation_jacobian(_t(r), _t(b1) * _t(d1)[:, None])
    np.testing.assert_allclose(jt.numpy(), np.asarray(jj), atol=2e-5)


def test_adjust_from_matches_parity(data):
    """The compat solver half end to end from the same matches and draws:
    r and t atol 1e-4."""
    b1, b2, valid = data
    cfg = PipelineConfig()
    key = jax.random.PRNGKey(2)
    rj, tj, dj, gj, telj = jtv.adjust_from_matches(b1, b2, valid, key, cfg)
    g = torch.from_numpy(_gumbel(key, cfg.ransac.num_trials, b1.shape[0]))
    rt, tt, dt, gt, telt = ttv.adjust_from_matches(_t(b1), _t(b2), _t(valid), None,
                                                 tconfig.from_reference(cfg), gumbel=g)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    # Depths: the ftol stop race of test_bcd_stages_parity, compounded over
    # the BCD rounds (up to 9.6e-3 along the valley on this data); held
    # across each match's valley at the final pose (the last depth stage
    # ran at the pose before it, so the costs there are not its minima).
    across, _ = _depth_valley(b1, b2, rj, tj, dt.numpy(), dj, cfg.ba)
    assert across[np.asarray(valid)].max() <= 1e-4
    assert telt.depth.iterations.shape == (cfg.ba.bcd_rounds,)


def test_generator_draws_are_seeded(data):
    """Without injected draws, the port's own Generator decides the
    subsample: one seed gives one answer, and a good one."""
    b1, b2, valid = data
    out = [
        tepi.initial_guess(_t(b1), _t(b2), _t(valid), torch.Generator().manual_seed(5))
        for _ in range(2)
    ]
    torch.testing.assert_close(out[0].euler, out[1].euler)
    assert bool(out[0].ok)


def test_essential_and_decomposition_parity(data):
    """The unfused 8-point pieces: E up to sign, and the (R1, R2) set of
    its decomposition; t up to sign (SVD sign conventions differ)."""
    b1, b2, valid = data
    w = np.asarray(valid, np.float32)
    Ej = np.asarray(jepi.essential_from_bearings(b1, b2, jnp.asarray(w)))
    Et = tepi.essential_from_bearings(_t(b1), _t(b2), torch.from_numpy(w)).numpy()
    sign = np.sign(np.sum(Ej * Et))
    np.testing.assert_allclose(sign * Et, Ej, atol=1e-4)
    r1j, r2j, tj = (np.asarray(x) for x in jepi.decompose_essential(jnp.asarray(Ej)))
    r1t, r2t, tt = (x.numpy() for x in tepi.decompose_essential(torch.from_numpy(Ej)))
    for R in (r1t, r2t):
        assert min(np.abs(R - r1j).max(), np.abs(R - r2j).max()) < 1e-4
    assert min(np.abs(tt - tj).max(), np.abs(tt + tj).max()) < 1e-4


def test_tf32_is_off():
    import spherical_bundle_adjuster_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
