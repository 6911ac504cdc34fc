"""Port parity for corrected mode: solve_psd, the rest of solver/epipolar
(inlier-count scoring, the outlier gates, the Kabsch start, top-k starts),
the joint Schur solve, the batched starts of solver/lm, corrected
adjust_from_matches and evaluate_matches, against the JAX package on the
CPU. torch cannot draw jax.random.gumbel, so the reference's draws are
injected.

Most banks carry bearing noise (sigma 1e-3 or 3e-3 rad): on noise-free
banks the reprojection cost is 0 along the (d, t) -> (s d, s t) scale
gauge, the barrier then pulls the scale outwards without bound, and both
packages drift along it by amounts that float32 rounding decides
(measured: translations 0.78 and 1.29 after 25 joint steps from one
init, rotations equal to 2e-8)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spherical_bundle_adjuster_tpu.core import rotation as jrot, smallmat as jsm
from spherical_bundle_adjuster_tpu.models import evaluation as jev, frontend as jfront
from spherical_bundle_adjuster_tpu.models import twoview as jtv
from spherical_bundle_adjuster_tpu.solver import epipolar as jepi, lm as jlm
from spherical_bundle_adjuster_tpu.utils.config import BaConfig, PipelineConfig, RansacConfig
from spherical_bundle_adjuster_tpu_torch.core import rotation as trot, smallmat as tsm
from spherical_bundle_adjuster_tpu_torch.models import evaluation as tev, frontend as tfront
from spherical_bundle_adjuster_tpu_torch.models import twoview as ttv
from spherical_bundle_adjuster_tpu_torch.solver import epipolar as tepi, lm as tlm
from spherical_bundle_adjuster_tpu_torch.utils import config as tconfig
from test_solver import corrupt_matches, synth_two_view

torch.set_num_threads(1)

CORRECTED = BaConfig(reference_compat=False, joint_refine=True, outlier_reject=True)


def _t(x):
    return torch.from_numpy(np.array(x))


def _gumbel(key, num_trials, m):
    """The reference's per-trial draws (ransac_trials: split, then gumbel)."""
    keys = jax.random.split(key, num_trials)
    return torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.gumbel(k, (m,)))(keys)))


def noisy(b, sigma, seed=11):
    """Unit bearings b with isotropic N(0, sigma) noise (zero pad rows stay)."""
    b = np.asarray(b, np.float64)
    n = b + np.random.default_rng(seed).normal(scale=sigma, size=b.shape)
    n = np.where(np.linalg.norm(b, axis=-1, keepdims=True) > 0, n, 0.0)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return jnp.asarray(n / np.maximum(norm, 1e-30), jnp.float32)


def bank(kind, sigma=1e-3, n=96, cap=128, n_bad=24):
    """(b1, b2, valid, R): a translation-rich or a pure-rotation (pitch
    60 deg) bank with noise and n_bad gross outliers."""
    if kind == "rotation":
        b1, b2, valid, R, _, _, _ = synth_two_view(
            n=n, cap=cap, euler=(0.02, np.deg2rad(60.0), -0.03), t=(0, 0, 0))
    else:
        b1, b2, valid, R, _, _, _ = synth_two_view(n=n, cap=cap)
    b2, _ = corrupt_matches(b1, noisy(b2, sigma), valid, n_bad=n_bad)
    return b1, b2, valid, R


def geodesic_deg(R1, R2):
    return float(np.degrees(np.arccos(np.clip((np.trace(R1.T @ R2) - 1) / 2, -1, 1))))


@pytest.mark.parametrize("pd", [True, False])
def test_solve_psd_parity(pd):
    """Positive definite: the solution within 1e-5 relative. Not positive
    definite: NaN in both, as XLA's Cholesky gives it."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 6)).astype(np.float32)
    A = a @ a.T + 6 * np.eye(6, dtype=np.float32)
    if not pd:
        A[0, 0] = -1.0
    b = rng.normal(size=6).astype(np.float32)
    xj = np.asarray(jsm.solve_psd(jnp.asarray(A), jnp.asarray(b)))
    xt = tsm.solve_psd(_t(A), _t(b)).numpy()
    if pd:
        np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-6)
    else:
        assert np.isnan(xj).all() and np.isnan(xt).all()


def test_candidate_inlier_counts_parity():
    """Equal counts per candidate, 40 candidates near and far from the pose
    (a count may differ only for a residual within float32 rounding of
    the threshold; none does here)."""
    b1, b2, valid, R = bank("translation")
    rng = np.random.default_rng(1)
    e0 = np.asarray(jrot.matrix_to_euler(jnp.asarray(R.T, jnp.float32)))
    eulers = (e0 + rng.normal(scale=0.02, size=(40, 3))).astype(np.float32)
    ts = rng.normal(size=(40, 3)).astype(np.float32)
    ts /= np.linalg.norm(ts, axis=-1, keepdims=True)
    cj = np.asarray(jepi.candidate_inlier_counts(b1, b2, valid, eulers, ts, np.deg2rad(1.5)))
    ct = tepi.candidate_inlier_counts(_t(b1), _t(b2), _t(valid), _t(eulers), _t(ts),
                                      np.deg2rad(1.5)).numpy()
    np.testing.assert_array_equal(ct, cj)
    assert cj.max() > 20


@pytest.mark.parametrize("thresh_deg,min_keep", [(1.5, 9), (1e-7, 9), (0.2, 200)])
def test_residual_gates_parity(thresh_deg, min_keep):
    """masked_median equal (one sorted element), and the gates equal mask
    for mask: an adaptive cut, a cut at 3 x median, and the min_keep
    fallback that returns the mask unchanged."""
    b1, b2, valid, R = bank("translation")
    rng = np.random.default_rng(2)
    x = np.abs(rng.normal(scale=0.01, size=valid.shape)).astype(np.float32)
    np.testing.assert_array_equal(
        tepi.masked_median(_t(x), _t(valid)).numpy(), np.asarray(jepi.masked_median(x, valid)))
    th = np.deg2rad(thresh_deg)
    gj = np.asarray(jepi.residual_inlier_mask(jnp.asarray(x), valid, th, min_keep=min_keep))
    gt = tepi.residual_inlier_mask(_t(x), _t(valid), th, min_keep=min_keep).numpy()
    np.testing.assert_array_equal(gt, gj)
    e = np.asarray(jrot.matrix_to_euler(jnp.asarray(R.T, jnp.float32)))
    tt = (np.asarray([0.2, 0.1, -0.05]) / np.linalg.norm([0.2, 0.1, -0.05])).astype(np.float32)
    mj = np.asarray(jepi.epipolar_inlier_mask(b1, b2, valid, e, tt, th, min_keep=min_keep))
    mt = tepi.epipolar_inlier_mask(_t(b1), _t(b2), _t(valid), _t(e), _t(tt), th,
                                   min_keep=min_keep).numpy()
    np.testing.assert_array_equal(mt, mj)
    if min_keep > 96:
        np.testing.assert_array_equal(mt, np.asarray(valid))


@pytest.mark.parametrize("kind", ["rotation", "translation"])
def test_kabsch_parity(kind):
    """The Kabsch rotation within 1e-5 (compared as a rotation matrix: SVD
    signs may differ) and the same ok."""
    b1, b2, valid, _ = bank(kind)
    ej, okj = jepi.kabsch_rotation_hypothesis(b1, b2, valid)
    et, okt = tepi.kabsch_rotation_hypothesis(_t(b1), _t(b2), _t(valid))
    assert bool(okt) == bool(okj)
    np.testing.assert_allclose(trot.euler_to_matrix(et).numpy(),
                               np.asarray(jrot.euler_to_matrix(ej)), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_initial_guess_inlier_count_parity(seed):
    """scoring="inlier_count" from the same draws: the same candidate wins
    (Euler within 1e-3, t within 1e-3 after the cheirality vote)."""
    b1, b2, valid, _ = bank("translation")
    cfg = dataclasses.replace(RansacConfig(), scoring="inlier_count")
    key = jax.random.PRNGKey(seed)
    gj = jepi.initial_guess(b1, b2, valid, key, cfg)
    gt = tepi.initial_guess(_t(b1), _t(b2), _t(valid), None, tconfig.from_reference(cfg),
                            gumbel=_gumbel(key, cfg.num_trials, b1.shape[0]))
    assert bool(gj.ok) and bool(gt.ok)
    np.testing.assert_allclose(gt.euler.numpy(), np.asarray(gj.euler), atol=1e-3)
    np.testing.assert_allclose(gt.translation.numpy(), np.asarray(gj.translation), atol=1e-3)


@pytest.mark.parametrize("kind", ["rotation", "translation"])
def test_initial_guess_topk_parity(kind):
    """The k = 4 starts from the same draws, slot for slot: Euler and t
    within 1e-3 (slot 3 is the Kabsch start, t = 0 exactly)."""
    b1, b2, valid, _ = bank(kind)
    cfg = RansacConfig()
    key = jax.random.PRNGKey(3)
    ej, tj, okj = jepi.initial_guess_topk(b1, b2, valid, key, cfg, k=4)
    et, tt, okt = tepi.initial_guess_topk(_t(b1), _t(b2), _t(valid), None,
                                          tconfig.from_reference(cfg), k=4,
                                          gumbel=_gumbel(key, cfg.num_trials, b1.shape[0]))
    assert bool(okt) == bool(okj)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)
    assert float(torch.linalg.vector_norm(tt[3])) == 0.0


def test_k_smallest_breaks_ties_toward_the_lower_index():
    """The start order of initial_guess_topk equals the reference's
    lax.top_k(-score, k) on tied and infinite scores."""
    score = np.array([3.0, 1.0, 1.0, 0.5, 1.0, np.inf, 1.0, np.inf], np.float32)
    for k in (2, 4, 7):
        _, ref = jax.lax.top_k(-jnp.asarray(score), k)
        np.testing.assert_array_equal(tepi.k_smallest(_t(score), k).numpy(), np.asarray(ref))


def _joint_init(sigma):
    b1, b2, valid, R, t, d1, d2 = synth_two_view(n=48, cap=64)
    aa = np.asarray(jrot.matrix_to_angle_axis(jnp.asarray(R, jnp.float32)))
    r0 = jnp.asarray(aa + np.asarray([0.03, -0.02, 0.02]), jnp.float32)
    t0 = jnp.asarray(t + np.asarray([0.03, -0.03, 0.01]), jnp.float32)
    d0 = jnp.stack([d1, d2], axis=-1) + 0.3
    return b1, noisy(b2, sigma), valid, r0, t0, d0


@pytest.mark.parametrize("sigma", [1e-3, 3e-3])
def test_solve_joint_schur_parity(sigma):
    """20 joint steps from the same init: r within 1e-5, t within 1e-4,
    depths within 5e-3 and the per-step costs within 1e-3 relative
    (measured 6.7e-7, 7.1e-5, 3.6e-3 and 4.9e-4: the depths, about 2-6,
    are held only by the barrier along each match's scale gauge, and the
    costs sit at a plateau 25x below the first where each step moves
    them by a few 1e-6)."""
    b1, b2, valid, r0, t0, d0 = _joint_init(sigma)
    ba = BaConfig(reference_compat=False)
    rj, tj, dj, cj = jlm.solve_joint_schur(b1, b2, d0, r0, t0, valid, ba)
    rt, tt, dt, ct = tlm.solve_joint_schur(_t(b1), _t(b2), _t(d0), _t(r0), _t(t0), _t(valid),
                                           tconfig.from_reference(ba))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=5e-3)
    cj = np.asarray(cj)
    assert ct.shape == (20,)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-3)


def test_joint_schur_closed_form_jacobians():
    """The joint solve's closed forms against jax.jacfwd of the reference's
    residual: d res / d r = +rotation_jacobian (atol 2e-5, float32
    rounding of |x1| <= 6), d res / d d1 = -R b1 and d res / d d2 = b2
    (atol 1e-6)."""
    b1, b2, valid, r0, t0, d0 = _joint_init(1e-3)

    def res(r, dd):
        return jlm.reprojection_residual(b1, b2, dd[:, 0], dd[:, 1], r, t0)

    jr = np.asarray(jax.jacfwd(res, 0)(r0, d0))
    jd = np.asarray(jax.jacfwd(res, 1)(r0, d0))  # (M, 3, M, 2)
    m = np.arange(b1.shape[0])
    x1 = _t(b1) * _t(d0)[:, 0:1]
    np.testing.assert_allclose(trot.rotation_jacobian(_t(r0), x1).numpy(), jr, atol=2e-5)
    rb1 = trot.rotate_angle_axis(_t(r0).expand(b1.shape), _t(b1)).numpy()
    np.testing.assert_allclose(jd[m, :, m, 0], -rb1, atol=1e-6)
    np.testing.assert_allclose(jd[m, :, m, 1], np.asarray(b2), atol=1e-6)


def _starts(b1, valid, S=3):
    rng = np.random.default_rng(5)
    r = torch.from_numpy(rng.normal(scale=0.01, size=(S, 3)).astype(np.float32))
    t = torch.from_numpy(rng.normal(scale=0.05, size=(S, 3)).astype(np.float32))
    v = _t(valid).expand(S, -1).clone()
    v[1, 3] = False  # each start carries its own gate mask
    v[2, :10] = False
    return r, t, v


def test_bcd_stages_batched_equal_single_starts():
    """One batched call of each BCD stage over 3 starts equals 3 single
    calls: depths bit for bit (the depth stage is elementwise per (start,
    match) problem), and r, t within 1e-6 (the batched reductions sum in
    another order)."""
    b1, b2, valid, r0, t0, d0 = _joint_init(1e-3)
    ba = tconfig.from_reference(BaConfig(reference_compat=False))
    dr, dt_, v = _starts(b1, valid)
    r = _t(r0) + dr
    t = _t(t0) + dt_
    d = _t(d0).expand(3, -1, -1)
    B1, B2 = _t(b1), _t(b2)
    db, rep_db = tlm.solve_depths(B1, B2, d, r, t, v, ba)
    rb, _ = tlm.solve_rotation(B1, B2, db, r, t, v, ba)
    tb, _ = tlm.solve_translation(B1, B2, db, rb, t, v, ba)
    pair = torch.stack([db[:, 0, 0], db[:, 1, 0]], -1)
    rc, _ = tlm.solve_rotation(B1, B2, pair, r, t, v, ba)
    for i in range(3):
        ds, rep_ds = tlm.solve_depths(B1, B2, d[i], r[i], t[i], v[i], ba)
        assert torch.equal(db[i], ds)
        assert int(rep_db.iterations[i]) == int(rep_ds.iterations)
        rs, _ = tlm.solve_rotation(B1, B2, ds, r[i], t[i], v[i], ba)
        torch.testing.assert_close(rb[i], rs, atol=1e-6, rtol=0)
        ts, _ = tlm.solve_translation(B1, B2, ds, rs, t[i], v[i], ba)
        torch.testing.assert_close(tb[i], ts, atol=1e-6, rtol=0)
        rcs, _ = tlm.solve_rotation(B1, B2, pair[i], r[i], t[i], v[i], ba)
        torch.testing.assert_close(rc[i], rcs, atol=1e-6, rtol=0)


def test_joint_schur_batched_equals_single_starts():
    """One batched joint solve over 3 starts equals 3 single solves: r
    within 1e-6, t within 1e-4, depths within 5e-3 and costs within 1e-3
    relative (measured 3e-8, 2e-5, 6.7e-4 and 2.8e-4: float32
    reassociation of the batched reductions, moved along the weakly held
    scale gauge)."""
    b1, b2, valid, r0, t0, d0 = _joint_init(1e-3)
    ba = tconfig.from_reference(BaConfig(reference_compat=False))
    dr, dt_, v = _starts(b1, valid)
    r, t, d = _t(r0) + dr, _t(t0) + dt_, _t(d0).expand(3, -1, -1)
    rb, tb, db, cb = tlm.solve_joint_schur(_t(b1), _t(b2), d, r, t, v, ba)
    for i in range(3):
        rs, ts, ds, cs = tlm.solve_joint_schur(_t(b1), _t(b2), d[i], r[i], t[i], v[i], ba)
        torch.testing.assert_close(rb[i], rs, atol=1e-6, rtol=0)
        torch.testing.assert_close(tb[i], ts, atol=1e-4, rtol=0)
        torch.testing.assert_close(db[i], ds, atol=5e-3, rtol=0)
        torch.testing.assert_close(cb[i], cs, atol=0, rtol=1e-3)


def _jax_winner(b1, b2, valid, key, cfg, guess):
    """The index of the reference's winning start: its guess is e_k[win]."""
    ek, _, _ = jepi.initial_guess_topk(b1, b2, valid, key, cfg.ransac, k=cfg.ba.multi_start)
    return int(np.argmin(np.abs(np.asarray(ek) - np.asarray(guess.euler)).max(-1)))


@pytest.mark.parametrize("kind,multi_start,sigma,rot_dominant", [
    ("translation", 0, 1e-3, False), ("translation", 0, 3e-3, False),
    ("translation", 4, 1e-3, False), ("translation", 4, 3e-3, True),
    ("rotation", 4, 1e-3, True),
])
def test_corrected_adjust_parity(kind, multi_start, sigma, rot_dominant):
    """Corrected adjust_from_matches (gates, joint polish; multi-start 0 or
    4) from the same draws: the same winning start, r within 1e-5 and t
    within 1e-3 (measured up to 6.5e-7 and 4.3e-4: the scale of t is held
    only by the barrier, so its norm moves with the BCD's ftol stops).
    Both branches of the rotation-dominant selection are covered: it
    fires on the pure-rotation bank, not on the translation-rich bank at
    sigma 1e-3, and at sigma 3e-3 it fires there too (its 25% outliers
    lift the trimmed full-model score past 2/3 of the rotation-only
    median)."""
    b1, b2, valid, R = bank(kind, sigma)
    cfg = PipelineConfig(ba=dataclasses.replace(CORRECTED, multi_start=multi_start))
    key = jax.random.PRNGKey(1)
    rj, tj, dj, gj, _ = jtv.adjust_from_matches(b1, b2, valid, key, cfg)
    rt, tt, dt, gt, tel = ttv.adjust_from_matches(
        _t(b1), _t(b2), _t(valid), None, tconfig.from_reference(cfg),
        gumbel=_gumbel(key, cfg.ransac.num_trials, b1.shape[0]))
    if multi_start:
        assert int(tel.start) == _jax_winner(b1, b2, valid, key, cfg, gj)
        assert bool(tel.rot_dominant) == rot_dominant
    np.testing.assert_allclose(gt.euler.numpy(), np.asarray(gj.euler), atol=1e-3)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)
    assert tel.depth.iterations.shape == (cfg.ba.bcd_rounds,)
    assert geodesic_deg(np.asarray(jrot.angle_axis_to_matrix(rt.numpy())), R) < 0.1


def test_evaluate_matches_parity():
    """Counts equal, outlier % and the trimmed error within 1e-6 (rad) on
    a front-end result with a fifth of its matches moved off."""
    rng = np.random.default_rng(7)
    m, n = 64, 50
    W, H = 256, 128
    R = np.asarray(jrot.euler_to_matrix(jnp.asarray([0.05, -0.08, 0.1])), np.float32)
    lxy = rng.uniform([0, 10], [W, H - 10], size=(m, 2)).astype(np.float32)
    from spherical_bundle_adjuster_tpu.core import sphere as jsph
    rb = np.asarray(jsph.pixel_to_bearing(jnp.asarray(lxy), W, H)) @ R.T
    rxy = np.asarray(jsph.bearing_to_pixel(jnp.asarray(rb), W, H)) + rng.normal(scale=0.3, size=(m, 2))
    rxy[:10] += rng.uniform(5, 20, size=(10, 2))
    rxy = rxy.astype(np.float32)
    valid = np.arange(m) < n
    frj = jfront.FrontendResult(jnp.asarray(lxy), jnp.asarray(rxy), jnp.asarray(valid),
                                jnp.zeros(m), jnp.asarray(n))
    frt = tfront.FrontendResult(_t(lxy), _t(rxy), _t(valid), torch.zeros(m), torch.tensor(n))
    ej = jev.evaluate_matches(frj, jnp.asarray(R), W, H, PipelineConfig())
    et = tev.evaluate_matches(frt, _t(R), W, H, tconfig.from_reference(PipelineConfig()))
    assert int(et.num_matches) == int(ej.num_matches) == n
    assert int(et.num_outliers) == int(ej.num_outliers) > 0
    np.testing.assert_allclose(float(et.outlier_pct), float(ej.outlier_pct), atol=1e-6)
    np.testing.assert_allclose(float(et.trimmed_mean_err_rad), float(ej.trimmed_mean_err_rad),
                               atol=1e-6)
