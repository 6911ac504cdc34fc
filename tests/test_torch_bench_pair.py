"""Whole-pair parity at the bench's size: the 512x1024 rotation pairs of
seeds 0-5 under bench_config() (256 keypoints per band, 3 octaves, 512
match slots, the parity ladder) through both packages, in compat mode and
in the bench's corrected mode, with the reference's backend-dependent
modes pinned and its RANSAC draws injected, assigned to matches by
identity.

End to end, the two packages' match lists differ in a few matches (the
reference's float32 integral image against the port's exactly rounded
one, test_torch_integral.py, and a few band pixels that the two
packages' float32 trigonometry floors to different source pixels), and
the draws of a match that only one package found cannot be shared. The
front-end parity test therefore holds the port against the reference's
band front end run on the port's band crops and on the port's exactly
rounded integral image. Compat mode's
consensus winner and basin, and corrected mode's start selection and
joint polish, follow those matches and draws, so the recovered rotations
are held to the bench's gates end to end, and to the parity bounds (0.5
deg compat, 0.05 deg corrected) from identical matches and draws. Where
the reference itself moves farther than a parity bound when its input
bearings move by one float32 rounding step, the bound is 1.2x that
spread, which the test measures on the reference. `JAX_PLATFORMS=cpu
PYTHONPATH=. python tests/test_torch_bench_pair.py FIRST LAST` (from the
repo root) prints the gaps, the spreads and corrected mode's starts for
the pairs of seeds FIRST..LAST-1.
"""

import contextlib
import dataclasses
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from spherical_bundle_adjuster_tpu.core import rotation as jrot, sphere as jsph
from spherical_bundle_adjuster_tpu.models import frontend as jfront, twoview as jtv
from spherical_bundle_adjuster_tpu.ops import warp as jwarp
from spherical_bundle_adjuster_tpu.utils import synthetic as jsyn
from spherical_bundle_adjuster_tpu_torch.models import twoview as ttv
from spherical_bundle_adjuster_tpu_torch.ops import warp as twarp
from spherical_bundle_adjuster_tpu_torch.utils import config as tconfig, synthetic as tsyn
from test_torch_integral import exact_reference_integral

torch.set_num_threads(1)

H, W = 512, 1024
SEEDS = range(6)
BASE = bench.bench_config()
CFG = dataclasses.replace(BASE, surf=dataclasses.replace(
    BASE.surf, det_mode="xla", gather_mode="mxu", topk_mode="exact"))
MODES = {"compat": CFG, "corrected": bench.corrected_mode(CFG)}


def _jax_render(params, R):
    """The reference's own renderer (render_erp's body) on the numpy params."""
    ys = jnp.arange(H, dtype=jnp.float32) + 0.5
    xs = jnp.arange(W, dtype=jnp.float32) + 0.5
    v = jsph.pixel_to_bearing(jnp.stack(jnp.meshgrid(xs, ys, indexing="xy"), -1), W, H)
    v = jnp.einsum("rc,ijc->ijr", R, v, precision=jax.lax.Precision.HIGHEST)
    return np.asarray(jsyn._texture(v, tuple(jnp.asarray(p) for p in params)).astype(jnp.uint8))


def _images(seed):
    """(left, right, R) of the pair rendered from `seed`."""
    params = tsyn.texture_params_from_numpy(np.random.default_rng(seed))
    euler = np.deg2rad(np.random.default_rng(seed + 100).uniform(-5, 5, 3)).astype(np.float32)
    R = np.asarray(jrot.euler_to_matrix(jnp.asarray(euler)))
    return _jax_render(params, jnp.eye(3)), _jax_render(params, jnp.asarray(R.T)), R


def _scene(seed):
    """(left, right, R, reference's run_two_view, port's front end) of the
    pair rendered from `seed`."""
    left, right, R = _images(seed)
    out_j = jtv.run_two_view(jnp.asarray(left), jnp.asarray(right), jax.random.PRNGKey(0),
                             CFG, frontend="band")
    fr_t = ttv.FRONTENDS["band"](torch.from_numpy(left.copy()), torch.from_numpy(right.copy()),
                                 tconfig.from_reference(CFG))
    return left, right, R, out_j, fr_t


@pytest.fixture(scope="module", params=SEEDS, ids=lambda s: f"seed{s}")
def pair(request):
    return _scene(request.param)


def _port_crop(gray, pitch_rad, mode):
    """The port's crop_rotated_band of a gray image (H, W), with any
    leading axes of 1, at pitches of any shape."""
    p = np.array(pitch_rad, np.float32)
    out = twarp.crop_rotated_band(torch.from_numpy(np.array(gray).reshape(gray.shape[-2:])),
                                  torch.from_numpy(p.reshape(-1)), mode).numpy()
    return out.reshape(p.shape + out.shape[1:])


@contextlib.contextmanager
def port_crops():
    """Within the block, the reference's crop_rotated_band is the port's (a
    host callback), so both packages detect on the same band pixels. The
    jit caches are cleared on entry and on exit."""

    def crop(image, pitch_rad, mode="floor"):
        h, w = image.shape
        return jax.pure_callback(lambda g, p: _port_crop(g, p, mode),
                                 jax.ShapeDtypeStruct(pitch_rad.shape + (h // 4, w), image.dtype),
                                 image, pitch_rad, vmap_method="expand_dims")

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwarp, "crop_rotated_band", crop)
        yield
    jax.clear_caches()


def _same_input_fronts(seeds):
    """{seed: the reference's band front end on the port's band crops and
    exactly rounded integral image}, every seed under one patch (one
    compile)."""
    with port_crops(), exact_reference_integral():
        return {seed: jfront.band_frontend(*(jnp.asarray(im) for im in _images(seed)[:2]), CFG)
                for seed in seeds}


@pytest.fixture(scope="module")
def same_input_fronts():
    return _same_input_fronts(SEEDS)


def _perm(out_j, fr_t, m):
    """Slot permutation taking each of the port's matches to the same
    match (both pixels within 0.05 px) of the reference's list; unpaired
    slots take the reference's unused slots in order."""
    nj, nt = int(np.asarray(out_j.match_valid).sum()), int(fr_t.match_count)
    pj = np.concatenate([np.asarray(out_j.left_xy), np.asarray(out_j.right_xy)], -1)[:nj]
    pt = torch.cat([fr_t.left_xy, fr_t.right_xy], -1).numpy()[:nt]
    perm, used = np.full(m, -1), set()
    for i, p in enumerate(pt):
        d = np.abs(pj - p).max(-1)
        j = int(np.argmin(d))
        if d[j] < 0.05 and j not in used:
            perm[i] = j
            used.add(j)
    free = iter([j for j in range(m) if j not in used])
    return np.asarray([p if p >= 0 else next(free) for p in perm]), len(used)


def test_bench_pair_frontend_parity(same_input_fronts, pair, request):
    """Against the reference's band front end on the port's inputs (its
    band crops and its exactly rounded integral image): match count +-2
    and >= 90% of the reference's matched pairs shared
    (test_run_two_view_parity's bounds).

    On its own inputs the reference differs from the port before SURF
    starts: its integral image is a float32 scan, and its crops put 13-17
    of a pair's 1.05M band pixels on other source pixels than the port's
    (the packages' float32 trigonometry differs in its last bits), and
    at this size the two move the reference by up to 3 matches. Measured over seeds 0-5 (CPU):
    the reference finds 119 / 87 / 112 / 90 / 79 / 59 matches on the
    port's inputs, the port 120 / 88 / 111 / 90 / 79 / 59, sharing 119 /
    86 / 111 / 89 / 78 / 59 of them (on its own inputs the reference
    finds 121 / 90 / 114 / 91 / 78 / 60)."""
    seed = request.node.callspec.params["pair"]
    fr_j, fr_t = same_input_fronts[seed], pair[4]
    nj, nt = int(fr_j.match_count), int(fr_t.match_count)
    assert nj >= 40 and abs(nj - nt) <= 2, (nj, nt)
    _, shared = _perm(fr_j, fr_t, CFG.match.max_matches)
    assert shared >= 0.9 * nj, (shared, nj)


def _rot_gap_deg(r_a, r_b):
    """Angle between two angle-axis rotations, in float64 on the host."""
    return float(bench.rot_err_deg_host(np.asarray(r_a, np.float64)[None],
                                        _matrix64(r_b)[None])[0])


def _matrix64(aa):
    aa = np.asarray(aa, np.float64)
    th = np.linalg.norm(aa)
    k = aa / max(th, 1e-30)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _draws(cfg, key, m):
    keys = jax.random.split(key, cfg.ransac.num_trials)
    return np.array(jax.vmap(lambda k: jax.random.gumbel(k, (m,)))(keys))


def _gaps(left, right, R, out_j, fr_t, mode):
    """(reference's error, port's error, end-to-end gap, gap from the
    reference's matches and draws, the reference's own rounding spread),
    degrees."""
    cfg = MODES[mode]
    m = cfg.match.max_matches
    key = jax.random.PRNGKey(0)
    fr_j = jtv.FrontendResult(out_j.left_xy, out_j.right_xy, out_j.match_valid,
                              out_j.match_distance, out_j.total_keypoints)
    b_l, b_r = jtv.lift_matches(fr_j, W, H)
    rot_j = (np.asarray(out_j.rotation_aa) if mode == "compat" else
             np.asarray(jtv.adjust_from_matches(b_l, b_r, out_j.match_valid, key, cfg)[0]))
    draws = _draws(cfg, key, m)
    perm, _ = _perm(out_j, fr_t, m)
    tcfg = tconfig.from_reference(cfg)
    out_t = ttv.run_two_view(torch.from_numpy(left.copy()), torch.from_numpy(right.copy()), None, tcfg,
                             frontend="band", gumbel=torch.from_numpy(draws[:, perm]))
    assert bool(out_t.ok)
    rot_same = ttv.adjust_from_matches(
        torch.from_numpy(np.array(b_l)), torch.from_numpy(np.array(b_r)),
        torch.from_numpy(np.array(out_j.match_valid)), None, tcfg,
        gumbel=torch.from_numpy(draws))[0].numpy()
    err = lambda r: float(bench.rot_err_deg_host(np.asarray(r)[None], R[None])[0])
    return (err(rot_j), err(out_t.rotation_aa.numpy()),
            _rot_gap_deg(out_t.rotation_aa.numpy(), rot_j), _rot_gap_deg(rot_same, rot_j),
            _rounding_spread(b_l, b_r, out_j.match_valid, key, cfg, rot_j))


def _rounding_spread(b_l, b_r, valid, key, cfg, rot_j, n=6):
    """The largest angle (deg) between the reference's rotation and the
    reference's own rotations from the same matches and draws, each
    bearing component scaled by 1 +- eps32 (a random sign per component,
    n numpy-seeded draws): how far float32 rounding alone moves the
    reference on this pair."""
    eps = np.finfo(np.float32).eps
    out = 0.0
    for k in range(n):
        rng = np.random.default_rng(100 + k)
        b = [jnp.asarray(np.asarray(x) * (1 + eps * rng.choice([-1, 1], x.shape)).astype(np.float32))
             for x in (b_l, b_r)]
        out = max(out, _rot_gap_deg(jtv.adjust_from_matches(*b, valid, key, cfg)[0], rot_j))
    return out


@pytest.mark.parametrize("mode,bound_deg", [("compat", 0.5), ("corrected", 0.05)])
def test_bench_pair_parity(pair, mode, bound_deg):
    """run_two_view in each mode: both packages' rotations within the
    bench's 512x1024 max gate of the ground truth (11.5 deg compat, 0.5 deg
    corrected), end to end; from the reference's own matches and draws the
    port's rotation within 0.5 deg of the reference's in compat mode
    (PARITY.md's same-init bound) and within 0.05 deg in corrected mode,
    or within 1.2x the reference's own rounding spread where that is
    wider (_rounding_spread, measured here).

    Measured over seeds 0-5 (the survey below, on the CPU): end to end,
    compat rotations 0.118-12.23 deg apart and corrected 0.027-0.120 deg
    (2-11 of the reference's 60-121 matches are not the port's, and their
    draws cannot be shared).
    From identical matches and draws, compat 0.0001-1.093 deg and
    corrected 0.0002-0.136 deg; the reference's rounding spread reaches
    0.0584-1.1002 deg compat and 0.0002-0.1367 deg corrected. Two cases
    exceed the parity bounds, each inside the reference's own spread:
    - seed 3 compat, 1.093 deg (spread 1.1002): from one init the BCD
      lands in two basins 1.1 deg apart, and the reference with its
      matches reordered (slots 0 and 1 kept, compat's depth pair) lands
      in either;
    - seed 4 corrected, 0.136 deg (spread 0.1367): the top-4 consensus
      candidates differ. On this pure-rotation pair the 8-point normal
      matrix of a trial has three near-zero eigenvalues (trial 17:
      7.7e-6, 2.6e-5, 5.6e-5 against 0.54), so its candidate follows the
      summation order: the reference with its matches reordered moves
      it as far as the port does, and its consensus score moves it into
      or out of the top 4. From identical starts the refined rotations
      are 0.003-0.019 deg apart, within the reference's reordered spread
      (0.015 deg)."""
    left, right, R, out_j, fr_t = pair
    err_j, err_t, _, same, spread = _gaps(left, right, R, out_j, fr_t, mode)
    gate = bench.GATE_MAX_ROT_ERR_COMPAT if mode == "compat" else bench.GATE_MAX_ROT_ERR_CORRECT
    assert err_j < gate and err_t < gate, (err_j, err_t)
    assert same <= max(bound_deg, 1.2 * spread), (same, spread)


def _starts(out_j, mode="corrected"):
    """From the reference's matches and draws, per start of each package:
    the refined rotation and the rotation-only median (deg) that the
    rotation-dominant selection compares; and each package's winner."""
    from spherical_bundle_adjuster_tpu.solver import epipolar as jepi

    cfg, m = MODES[mode], CFG.match.max_matches
    key = jax.random.PRNGKey(0)
    fr_j = jtv.FrontendResult(out_j.left_xy, out_j.right_xy, out_j.match_valid,
                              out_j.match_distance, out_j.total_keypoints)
    b_l, b_r = jtv.lift_matches(fr_j, W, H)
    valid = out_j.match_valid
    e_k, t_k, ok = jepi.initial_guess_topk(b_l, b_r, valid, key, cfg.ransac, k=cfg.ba.multi_start)
    init_d = jnp.full((m, 2), cfg.ba.init_depth, jnp.float32)
    rs_j = np.asarray(jax.vmap(lambda e, t: jtv._solve_from_init(
        b_l, b_r, valid, e, t, ok, cfg, init_d)[0])(e_k, t_k))
    tcfg = tconfig.from_reference(cfg)
    tb_l, tb_r, tvalid = (torch.from_numpy(np.array(x)) for x in (b_l, b_r, valid))
    te_k, tt_k, tok = ttv.epipolar.initial_guess_topk(
        tb_l, tb_r, tvalid, None, tcfg.ransac, cfg.ba.multi_start,
        torch.from_numpy(_draws(cfg, key, m)))
    rs_t = ttv._solve_from_init(tb_l, tb_r, tvalid, te_k, tt_k, tok, tcfg,
                                torch.from_numpy(np.array(init_d)))[0]
    win_j = int(np.argmin(np.abs(np.asarray(e_k) - np.asarray(jtv.adjust_from_matches(
        b_l, b_r, valid, key, cfg)[3].euler)).max(-1)))
    win_t = int(ttv.adjust_from_matches(tb_l, tb_r, tvalid, None, tcfg,
                                        gumbel=torch.from_numpy(_draws(cfg, key, m)))[4].start)

    def rot_median_deg(r):
        shape = (r.shape[0],) + tuple(tb_l.shape)
        pred = ttv.rotation.rotate_angle_axis(r[:, None, :].expand(shape), tb_l.expand(shape))
        ang = ttv.sphere.angular_distance(pred, tb_r.expand(shape))
        return np.degrees(ttv.epipolar.masked_median(ang, tvalid).numpy().astype(np.float64))

    return dict(winner=(win_j, win_t),
                rot_median_deg=(rot_median_deg(torch.from_numpy(rs_j)).round(4).tolist(),
                                rot_median_deg(rs_t).round(4).tolist()),
                start_gap_deg=[round(_rot_gap_deg(a, b), 4) for a, b in zip(rs_t.numpy(), rs_j)])


def _survey(first, last):
    """Print, per seed, the match counts (the reference's on its own and on
    the port's inputs, the port's) and shared matches, both modes' errors,
    gaps and rounding spreads, and corrected mode's starts."""
    exact = _same_input_fronts(range(first, last))
    m = CFG.match.max_matches
    for seed in range(first, last):
        left, right, R, out_j, fr_t = _scene(seed)
        nj, nt = int(np.asarray(out_j.match_valid).sum()), int(fr_t.match_count)
        row = dict(seed=seed, matches=(nj, int(exact[seed].match_count), nt),
                   shared=(_perm(out_j, fr_t, m)[1], _perm(exact[seed], fr_t, m)[1]))
        for mode in MODES:
            err_j, err_t, e2e, same, spread = _gaps(left, right, R, out_j, fr_t, mode)
            row[mode] = dict(err_deg=(round(err_j, 4), round(err_t, 4)),
                             gap_end_to_end_deg=round(e2e, 4), gap_same_matches_deg=round(same, 4),
                             reference_rounding_spread_deg=round(spread, 4))
        row["corrected_starts"] = _starts(out_j)
        print(row, flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    _survey(int(sys.argv[1]), int(sys.argv[2]))
