"""Port parity for the ERP and cubemap front ends and what they run on:
core/cube, the cubemap and rotation warps, erp_frontend and
cubemap_frontend (and band, on the same fixture), compare_frontends, and
SURF's bilinear-descriptor and gather-Laplacian modes, each against the
JAX package on the CPU.

The front ends run on tests/test_frontends.py's fixture (96x192, seed 7,
euler (2, -3, 5) deg, cube 48) with the reference's backend-dependent
modes pinned and the reference on the port's exactly rounded integral
image (test_torch_integral.py). The reference's CPU backend matches with
its dense MXU-style matcher where the port takes K3's plain version:
indices are identical and distances agree to float32 rounding.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spherical_bundle_adjuster_tpu.core import cube as jcube, rotation as jrot
from spherical_bundle_adjuster_tpu.models import evaluation as jeval, frontend as jfront
from spherical_bundle_adjuster_tpu.ops import surf as jsurf, warp as jwarp
from spherical_bundle_adjuster_tpu.utils import synthetic as jsyn
from spherical_bundle_adjuster_tpu.utils.config import (
    FrontendConfig, MatchConfig, PipelineConfig, SurfConfig,
)
from spherical_bundle_adjuster_tpu_torch.core import cube as tcube
from spherical_bundle_adjuster_tpu_torch.models import evaluation as teval, frontend as tfront
from spherical_bundle_adjuster_tpu_torch.ops import surf as tsurf, warp as twarp
from spherical_bundle_adjuster_tpu_torch.utils import config as tconfig
from test_torch_integral import exact_reference_integral

torch.set_num_threads(1)

H, W = 96, 192
S = 48
CFG = PipelineConfig(
    surf=SurfConfig(max_keypoints=128, n_octaves=2, det_mode="xla", gather_mode="mxu",
                    topk_mode="exact"),
    match=MatchConfig(max_matches=256, ratio_thresh=0.6),
    frontend=FrontendConfig(cube_size=S),
)
TCFG = tconfig.from_reference(CFG)
# tests/test_frontends.py's regression bounds for this fixture:
# name: (min_matches, max_outlier_pct, max_trim_err_deg)
BOUNDS = {"erp": (25, 35.0, 2.5), "band": (12, 50.0, 2.5), "cubemap": (13, 40.0, 2.5)}
NAMES = list(BOUNDS)


@pytest.fixture(scope="module")
def pair():
    """The reference's fixture pair (its render), both packages' front
    ends and compare_frontends."""
    left, right, R = jsyn.rotation_pair(jax.random.PRNGKey(7), np.deg2rad([2.0, -3.0, 5.0]), H, W)
    with exact_reference_integral():
        fr_j = {n: jfront.FRONTENDS[n](left, right, CFG) for n in NAMES}
        ev_j = jeval.compare_frontends(left, right, R, CFG)
        # per key: a tree map would sort the dicts' keys
        fr_j = {n: jax.tree.map(np.asarray, f) for n, f in fr_j.items()}
        ev_j = {n: jax.tree.map(np.asarray, e) for n, e in ev_j.items()}
    lt, rt = (torch.from_numpy(np.array(x)) for x in (left, right))
    Rt = torch.from_numpy(np.array(R))
    fr_t = {n: tfront.FRONTENDS[n](lt, rt, TCFG) for n in NAMES}
    ev_t = teval.compare_frontends(lt, rt, Rt, TCFG)
    return dict(left=np.array(left), right=np.array(right), R=np.array(R),
                fr_j=fr_j, fr_t=fr_t, ev_j=ev_j, ev_t=ev_t)


def _matched(fr):
    v = np.asarray(fr.match_valid)
    xy = np.concatenate([np.asarray(fr.left_xy), np.asarray(fr.right_xy)], -1)
    return xy[: int(v.sum())]


@pytest.mark.parametrize("size", [S, 600])
def test_face_rays_parity(size):
    """Every face's ray field within 1e-6 of the reference's."""
    want = np.asarray(jcube.face_rays(size))
    got = tcube.face_rays(size).numpy()
    assert got.shape == want.shape == (6, size, size, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("size", [S, 600])
def test_cube_pixel_to_erp_parity(size):
    """Cube-strip pixels (every face, off the face borders) to bearings
    within 1e-6 and to ERP pixels within 1e-3 px of the reference's."""
    rng = np.random.default_rng(size)
    xy = np.stack([rng.uniform(0, 6 * size, 4000), rng.uniform(0, size, 4000)], -1)
    xy = xy[np.abs(xy[:, 0] / size - np.round(xy[:, 0] / size)) > 1e-3].astype(np.float32)
    b_j = np.asarray(jcube.cube_pixel_to_bearing(jnp.asarray(xy), size))
    b_t = tcube.cube_pixel_to_bearing(torch.from_numpy(xy), size).numpy()
    np.testing.assert_allclose(b_t, b_j, atol=1e-6)
    e_j = np.asarray(jcube.cube_pixel_to_erp_pixel(jnp.asarray(xy), size, W, H))
    e_t = tcube.cube_pixel_to_erp_pixel(torch.from_numpy(xy), size, W, H).numpy()
    dx = np.abs(e_t[:, 0] - e_j[:, 0])
    dx = np.minimum(dx, W - dx)  # longitude wraps at the seam
    assert dx.max() < 1e-3 and np.abs(e_t[:, 1] - e_j[:, 1]).max() < 1e-3


@pytest.mark.parametrize("mode", ["floor", "nearest", "bilinear"])
def test_equi_to_cubemap_parity(pair, mode):
    """The (S, 6S, 3) strip of the fixture's left image against the
    reference's. floor / nearest: at most 0.5% of the strip's pixels
    differ (coordinates on a rounding boundary follow each package's
    float32 trigonometry); bilinear: within 1 gray level (a truncation
    to uint8) except at those boundary pixels. Measured: no pixel
    differs (bilinear: by at most 1)."""
    im = pair["left"]
    want = np.asarray(jwarp.equi_to_cubemap(jnp.asarray(im), S, mode)).astype(np.int32)
    got = twarp.equi_to_cubemap(torch.from_numpy(im.copy()), S, mode).numpy().astype(np.int32)
    assert got.shape == want.shape == (S, 6 * S, 3)
    tol = 1 if mode == "bilinear" else 0
    assert (np.abs(got - want) > tol).any(-1).mean() <= 0.005


@pytest.mark.parametrize("face", list(tcube.FACE_NAMES))
def test_equi_to_cube_face_parity(pair, face):
    """Each single face equals its slot of the port's strip, and at most
    0.5% of its pixels differ from the reference's face."""
    im = pair["left"]
    got = twarp.equi_to_cube_face(torch.from_numpy(im.copy()), face, S).numpy()
    f = tcube.FACE_NAMES.index(face)
    strip = twarp.equi_to_cubemap(torch.from_numpy(im.copy()), S).numpy()
    np.testing.assert_array_equal(got, strip[:, f * S : (f + 1) * S])
    want = np.asarray(jwarp.equi_to_cube_face(jnp.asarray(im), face, S))
    assert (got != want).any(-1).mean() <= 0.005


def test_rotate_erp_parity(pair):
    """A full-sphere rotation warp of the fixture's left image: at most
    0.5% of its pixels differ from the reference's."""
    im = pair["left"]
    R = np.array(jrot.euler_to_matrix(jnp.asarray(np.deg2rad([10.0, -20.0, 30.0]), jnp.float32)))
    want = np.asarray(jwarp.rotate_erp(jnp.asarray(im), jnp.asarray(R)))
    got = twarp.rotate_erp(torch.from_numpy(im.copy()), torch.from_numpy(R)).numpy()
    assert got.shape == want.shape == im.shape
    assert (got != want).any(-1).mean() <= 0.005


@pytest.mark.parametrize("name", NAMES)
def test_frontend_parity(pair, name):
    """Each front end against the reference's: match count +-2 and >= 90%
    of the reference's matched pairs shared (both pixels within 0.05 px),
    equal keypoint totals. Measured: erp 38, band 19 and cubemap 21
    matches in both packages, every one shared."""
    fj, ft = pair["fr_j"][name], pair["fr_t"][name]
    pj, pt = _matched(fj), _matched(ft)
    nj, nt = len(pj), len(pt)
    assert nj >= 12 and abs(nj - nt) <= 2, (nj, nt)
    shared = sum(np.abs(pj - p).max(-1).min() < 0.05 for p in pt)
    assert shared >= 0.9 * nj, (shared, nj)
    assert int(ft.total_keypoints) == int(fj.total_keypoints)


@pytest.mark.parametrize("name", NAMES)
def test_frontend_quality(pair, name):
    """tests/test_frontends.py's BOUNDS, applied to the port: matches,
    outlier % at 2 deg and trimmed mean error, and matched coordinates
    inside the ERP image."""
    ev = pair["ev_t"][name]
    min_m, max_out, max_err = BOUNDS[name]
    assert int(ev.num_matches) >= min_m, int(ev.num_matches)
    assert float(ev.outlier_pct) < max_out, float(ev.outlier_pct)
    assert float(ev.trimmed_mean_err_rad) < np.deg2rad(max_err)
    fr = pair["fr_t"][name]
    lxy = fr.left_xy[fr.match_valid].numpy()
    assert (lxy[:, 0] >= 0).all() and (lxy[:, 0] <= W).all()
    assert (lxy[:, 1] >= 0).all() and (lxy[:, 1] <= H).all()


def test_compare_frontends_parity(pair):
    """compare_frontends: the same front ends in the same order as the
    reference's, each scored as evaluate_matches scores its own front
    end's result, and within the reference's numbers: matches +-2, outlier
    % within 10 points, trimmed error within 0.25 deg, equal keypoint
    totals."""
    ev_j, ev_t = pair["ev_j"], pair["ev_t"]
    assert list(ev_t) == list(ev_j) == NAMES
    for name in NAMES:
        j, t = ev_j[name], ev_t[name]
        own = teval.evaluate_matches(pair["fr_t"][name], torch.from_numpy(pair["R"]), W, H, TCFG)
        for a, b in zip(t, own):
            assert torch.equal(a, b), name
        assert abs(int(t.num_matches) - int(j.num_matches)) <= 2, name
        assert abs(float(t.outlier_pct) - float(j.outlier_pct)) <= 10.0, name
        assert abs(float(t.trimmed_mean_err_rad) - float(j.trimmed_mean_err_rad)) <= np.deg2rad(0.25)
        assert int(t.total_keypoints) == int(j.total_keypoints), name


def test_run_two_view_takes_every_frontend(pair):
    """run_two_view and run_two_view_batch accept each front end."""
    from spherical_bundle_adjuster_tpu_torch.models import twoview as ttv

    lt, rt = (torch.from_numpy(pair[k].copy()) for k in ("left", "right"))
    for name in NAMES:
        one = ttv.run_two_view(lt, rt, torch.Generator().manual_seed(0), TCFG, frontend=name)
        assert torch.equal(one.match_valid, pair["fr_t"][name].match_valid)
        two = ttv.run_two_view_batch(torch.stack([lt, lt]), torch.stack([rt, rt]),
                                     torch.Generator().manual_seed(0), TCFG, frontend=name)
        assert two.rotation_aa.shape == (2, 3)
        assert torch.equal(two.left_xy[1], pair["fr_t"][name].left_xy)
    with pytest.raises(ValueError):
        ttv.run_two_view(lt, rt, None, TCFG, frontend="sphere")


@pytest.fixture(scope="module")
def gray():
    """tests/test_torch_surf.py's textured 64x128 band."""
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:64, 0:128]
    img = 120 + 80 * np.sin(x / 7.0) * np.cos(y / 5.0) + rng.uniform(0, 40, (64, 128))
    return np.clip(img, 0, 255).astype(np.float32)


@pytest.mark.parametrize("mode", [dict(descriptor_interp="bilinear"),
                                  dict(laplacian_mode="gather"),
                                  dict(descriptor_interp="bilinear", laplacian_mode="gather")],
                         ids=["bilinear", "gather", "bilinear+gather"])
def test_surf_modes_parity(gray, mode):
    """detect_and_describe in SURF's optional modes, held as
    tests/test_torch_surf.py holds the default modes: keypoint count +-1,
    xy atol 0.25, descriptors atol 5e-2, identical Laplacian signs."""
    cfg = dataclasses.replace(SurfConfig(max_keypoints=64, n_octaves=2, det_mode="xla",
                                         gather_mode="mxu", topk_mode="exact"), **mode)
    kp_j, d_j = jsurf.detect_and_describe(jnp.asarray(gray), cfg)
    kp_t, d_t = tsurf.detect_and_describe(torch.from_numpy(gray)[None], tconfig.from_reference(cfg))
    vj, vt = np.asarray(kp_j.valid), kp_t.valid[0].numpy()
    assert vj.sum() > 4
    assert abs(int(vj.sum()) - int(vt.sum())) <= 1
    n = min(int(vj.sum()), int(vt.sum()))
    np.testing.assert_allclose(kp_t.xy[0, :n].numpy(), np.asarray(kp_j.xy)[:n], atol=0.25)
    np.testing.assert_allclose(d_t[0, :n].numpy(), np.asarray(d_j)[:n], atol=5e-2)
    np.testing.assert_array_equal(kp_t.laplacian[0, :n].numpy(), np.asarray(kp_j.laplacian)[:n])


def test_surf_modes_change_what_they_should(gray):
    """Bilinear descriptors differ from nearest ones at the same
    keypoints; the gather Laplacian reads the same signs as the dense
    trace maps at nearly every keypoint (its scale is the keypoint's
    rounded size, not its detection layer's)."""
    g = torch.from_numpy(gray)[None]
    base = dataclasses.replace(TCFG.surf, max_keypoints=64)
    kp_n, d_n = tsurf.detect_and_describe(g, base)
    kp_b, d_b = tsurf.detect_and_describe(g, dataclasses.replace(base, descriptor_interp="bilinear"))
    assert torch.equal(kp_n.xy, kp_b.xy) and not torch.equal(d_n, d_b)
    kp_g, _ = tsurf.detect_and_describe(g, dataclasses.replace(base, laplacian_mode="gather"))
    assert torch.equal(kp_n.xy, kp_g.xy)
    v = kp_n.valid[0]
    assert (kp_n.laplacian[0][v] == kp_g.laplacian[0][v]).float().mean() >= 0.9
    with pytest.raises(ValueError):
        tsurf.detect_and_describe(g, dataclasses.replace(base, laplacian_mode="sparse"))
