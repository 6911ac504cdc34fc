"""Port parity: the SURF module and the plain versions of kernels K1 (det
pyramid) and K2 (Haar / trace-sign maps), against the JAX reference with
its backend-dependent modes pinned (det_mode, gather_mode="mxu",
topk_mode="exact"). Tolerances are those of tests/test_pallas_surf.py."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spherical_bundle_adjuster_tpu.ops import integral as jint, surf as jsurf
from spherical_bundle_adjuster_tpu.utils.config import SurfConfig
from spherical_bundle_adjuster_tpu_torch.ops import cuda_surf, integral as tint, surf as tsurf
from spherical_bundle_adjuster_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

CFG = SurfConfig(max_keypoints=64, n_octaves=2, det_mode="xla", gather_mode="mxu",
                 topk_mode="exact")
TCFG = tconfig.from_reference(CFG)


@pytest.fixture(scope="module")
def gray():
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:64, 0:128]
    img = 120 + 80 * np.sin(x / 7.0) * np.cos(y / 5.0) + rng.uniform(0, 40, (64, 128))
    return np.clip(img, 0, 255).astype(np.float32)


def _ii(gray):
    return tint.integral_image(torch.from_numpy(gray)[None])


@pytest.mark.parametrize("det_mode", ["xla", "pallas"])
def test_det_stack_plain_matches_reference(gray, det_mode):
    """K1's plain version (strided, border-masked) equals the reference's
    det maps: identical finite mask, atol 2.0 / rtol 1e-4 (integral-image
    cancellation noise; the Pallas kernel runs in interpret mode)."""
    cfg = dataclasses.replace(CFG, det_mode=det_mode)
    ref = jsurf._det_maps_per_octave(jnp.asarray(gray), cfg)
    ii = _ii(gray)
    assert len(ref) == CFG.n_octaves
    for o, a in enumerate(ref):
        a = np.asarray(a)
        b = cuda_surf.det_pyramid(ii, tconfig.from_reference(cfg))[o][0].numpy()
        assert a.shape == b.shape
        fin = np.isfinite(a)
        assert (fin == np.isfinite(b)).all()
        np.testing.assert_allclose(b[fin], a[fin], atol=2.0, rtol=1e-4)


def test_haar_trace_plain_matches_reference(gray):
    """K2's plain version against _unpack_haar(_dense_haar_maps) and
    _dense_trace_sign_maps: hx / hy atol 4.0 rtol 2e-2 (a half-ulp
    disagreement flips a bf16 value); under 1% of trace signs flipped."""
    iij = jint.integral_image(jnp.asarray(gray))
    hx_j, hy_j = jsurf._unpack_haar(jsurf._dense_haar_maps(iij, CFG))
    tr_j = np.asarray(jsurf._dense_trace_sign_maps(iij, CFG))
    hx, hy, tr = cuda_surf.haar_trace_maps(_ii(gray), TCFG)
    assert hx.dtype == torch.bfloat16 and tr.dtype == torch.int8
    np.testing.assert_allclose(hx[0].float().numpy(), np.asarray(hx_j), atol=4.0, rtol=2e-2)
    np.testing.assert_allclose(hy[0].float().numpy(), np.asarray(hy_j), atol=4.0, rtol=2e-2)
    assert (tr[0].numpy() != tr_j).mean() < 0.01


def test_detect_and_describe_parity(gray):
    """Keypoint count +-1, xy atol 0.25, descriptors atol 5e-2."""
    kp_j, d_j = jsurf.detect_and_describe(jnp.asarray(gray), CFG)
    kp_t, d_t = tsurf.detect_and_describe(torch.from_numpy(gray)[None], TCFG)
    vj, vt = np.asarray(kp_j.valid), kp_t.valid[0].numpy()
    assert vj.sum() > 4
    assert abs(int(vj.sum()) - int(vt.sum())) <= 1
    n = min(int(vj.sum()), int(vt.sum()))
    np.testing.assert_allclose(kp_t.xy[0, :n].numpy(), np.asarray(kp_j.xy)[:n], atol=0.25)
    np.testing.assert_allclose(d_t[0, :n].numpy(), np.asarray(d_j)[:n], atol=5e-2)
    np.testing.assert_array_equal(kp_t.laplacian[0, :n].numpy(), np.asarray(kp_j.laplacian)[:n])


def test_detect_batch_equals_single_bands(gray):
    """Bands are independent: a batch of two gives each band's own result."""
    pair = np.stack([gray, gray[:, ::-1].copy()])
    kp_b, d_b = tsurf.detect_and_describe(torch.from_numpy(pair), TCFG)
    for i in range(2):
        kp_s, d_s = tsurf.detect_and_describe(torch.from_numpy(pair[i : i + 1]), TCFG)
        torch.testing.assert_close(kp_b.xy[i], kp_s.xy[0])
        torch.testing.assert_close(d_b[i], d_s[0])


def test_cuda_wrappers_reject_cpu_tensors(gray):
    """The kernel wrappers check their inputs before any build or launch."""
    ii = _ii(gray)
    with pytest.raises(ValueError):
        cuda_surf.det_pyramid_cuda(ii, TCFG)
    with pytest.raises(ValueError):
        cuda_surf.haar_trace_maps_cuda(ii, TCFG)
    assert cuda_surf.DET_PYRAMID.launches == 0 and cuda_surf.HAAR_TRACE.launches == 0


# The main path's band shapes: the 2K bench config's 256 x 2048 bands with
# 4 octaves and 512 keypoints, and the 512x1024 config's 128 x 1024 bands
# with 3 octaves and 256 keypoints.
PATH_SHAPES = [(256, 2048, 4, 512), (128, 1024, 3, 256)]


def _textured_band(h, w):
    """A band of a synthetic ERP scene (the texture of utils/synthetic),
    gray, float32."""
    from spherical_bundle_adjuster_tpu_torch.utils import synthetic

    params = synthetic.texture_params_from_numpy(np.random.default_rng(h + w))
    rgb = synthetic.render_erp(params, np.eye(3, dtype=np.float32), h, w, "cpu")
    return tint.rgb_to_gray(rgb).numpy()


@pytest.fixture(scope="module", params=PATH_SHAPES, ids=lambda s: "x".join(map(str, s[:2])))
def path_band(request):
    h, w, n_oct, k = request.param
    cfg = SurfConfig(max_keypoints=k, n_octaves=n_oct, det_mode="xla", gather_mode="mxu",
                     topk_mode="exact")
    return _textured_band(h, w), cfg


def _det_tolerance_use(gray, cfg):
    """The largest |det_port - det_ref| / tolerance over every finite entry
    of every octave layer (the tolerance of
    test_det_maps_parity_at_path_shapes), after asserting both integral
    images' bound."""
    ii64 = torch.cumsum(torch.cumsum(torch.from_numpy(gray).double(), 0), 1)
    e = 2 * np.finfo(np.float32).eps * float(ii64.abs().max())
    ii_t = _ii(gray)
    ii_j = np.asarray(jint.integral_image(jnp.asarray(gray)))
    assert float((ii_t[0, 1:, 1:].double() - ii64).abs().max()) <= e
    assert np.abs(ii_j[1:, 1:] - ii64.numpy()).max() <= e
    ref = jsurf._det_maps_per_octave(jnp.asarray(gray), cfg)
    got = cuda_surf.det_pyramid(ii_t, tconfig.from_reference(cfg))
    ii64_pad = torch.zeros((1,) + tuple(d + 1 for d in gray.shape), dtype=torch.float64)
    ii64_pad[0, 1:, 1:] = ii64
    h, w = gray.shape
    use = 0.0
    for o, (a, b) in enumerate(zip(ref, got)):
        a, b = np.asarray(a), b[0].numpy()
        assert a.shape == b.shape
        fin = np.isfinite(a)
        assert (fin == np.isfinite(b)).all()
        step, oh, ow = cuda_surf._octave_shape(h, w, o)
        pad = cuda_surf.filter_size(o, cfg.n_octave_layers + 1)
        iip = tint.edge_pad(ii64_pad, pad)
        for l in range(cfg.n_octave_layers + 2):
            _, _, groups = cuda_surf.det_layer_boxes(o, l)
            dd = []
            for g in groups:
                boxes = [(y0 + pad, x0 + pad, y1 + pad, x1 + pad, wt) for (y0, x0, y1, x1, wt) in g]
                d = tint.shifted_box_sums(iip, boxes, oh, ow, step)[0].numpy()
                dd.append((np.abs(d), 8 * e * sum(abs(bx[4]) for bx in g)))
            (axx, exx), (ayy, eyy), (axy, exy) = dd
            tol = (exx * ayy + eyy * axx + exx * eyy + 0.81 * (2 * axy * exy + exy * exy)
                   + 1e-5 * (axx * ayy + 0.81 * axy * axy))
            f = fin[l]
            if f.any():
                use = max(use, float((np.abs(b[l][f] - a[l][f]) / tol[f]).max()))
    return use


def test_det_maps_parity_at_path_shapes(path_band):
    """K1's plain version against the reference at the main path's shapes,
    to a tolerance set by the integral images' float32 error.

    Both packages sum the integral image in float32, in different orders;
    each errs against float64 by at most e = 2 eps32 max|ii| (asserted;
    at 256 x 2048 max|ii| ~ 7e7, so e ~ 16). A box sum reads 4 corners, so
    a filter response D = sum_k w_k box_k differs by at most
    dD = 8 e sum_k |w_k| between the packages, and det = Dxx Dyy -
    0.81 Dxy^2 by at most dDxx |Dyy| + dDyy |Dxx| + dDxx dDyy +
    0.81 (2 |Dxy| dDxy + dDxy^2), with the D of a float64 integral image,
    plus 1e-5 of the det's terms for its own float32 rounding. Identical
    finite masks. (`JAX_PLATFORMS=cpu PYTHONPATH=. python
    tests/test_torch_surf.py` prints how much of
    the tolerance the worst entry uses.)"""
    gray, cfg = path_band
    assert _det_tolerance_use(gray, cfg) <= 1.0


def _octave_step(size):
    """The stride 1 << octave of keypoints of refined filter size `size`
    (octave o's middle layers span sizes 15..27 << o)."""
    o = sum((size > 28.5 * (1 << k)).astype(int) for k in range(3))
    return 1 << o


def _keypoint_stats(gray, cfg):
    """Both packages' detect_and_describe on one band: keypoint counts,
    and with the reference's keypoints paired to the port's nearest within
    half their octave's stride, one to one: the paired share and, of the
    pairs, the shares with a descriptor beyond 5e-2, an orientation beyond
    0.05 rad, and an equal Laplacian sign."""
    kp_j, d_j = jsurf.detect_and_describe(jnp.asarray(gray), cfg)
    kp_t, d_t = tsurf.detect_and_describe(torch.from_numpy(gray)[None], tconfig.from_reference(cfg))
    vj, vt = np.asarray(kp_j.valid), kp_t.valid[0].numpy()
    nj, nt = int(vj.sum()), int(vt.sum())
    xj, xt = np.asarray(kp_j.xy)[vj], kp_t.xy[0].numpy()[vt]
    dist = np.abs(xj[:, None, :] - xt[None, :, :]).max(-1)
    nearest = dist.argmin(1)
    close = dist[np.arange(nj), nearest] <= 0.5 * _octave_step(np.asarray(kp_j.size)[vj])
    paired = close & (np.bincount(nearest[close], minlength=nt)[nearest] == 1)
    ij, it = np.nonzero(vj)[0][paired], np.nonzero(vt)[0][nearest[paired]]
    dori = np.asarray(kp_j.orientation)[ij] - kp_t.orientation[0].numpy()[it]
    return dict(
        counts=(nj, nt), paired=float(paired.mean()),
        desc_off=float((np.abs(np.asarray(d_j)[ij] - d_t[0].numpy()[it]).max(-1) > 5e-2).mean()),
        ori_off=float((np.abs(np.angle(np.exp(1j * dori))) > 0.05).mean()),
        laplacian_equal=float((np.asarray(kp_j.laplacian)[ij] == kp_t.laplacian[0].numpy()[it]).mean()),
    )


def test_detect_and_describe_parity_at_path_shapes(path_band):
    """Keypoints paired by position (_keypoint_stats). The integral images'
    reassociation (test_det_maps_parity_at_path_shapes) moves the det maps
    by up to ~200 at 256 x 2048, which flips near-tied NMS, top-K,
    sub-pixel, orientation-bin and descriptor-sample decisions, so the
    bounds are counts (measured at 256 x 2048 / 128 x 1024 by this file's
    main, as test_det_maps_parity_at_path_shapes says): keypoint counts within 2% of K
    (509 vs 512 / equal); at least 95% paired (96.3% / 99.6%); of the
    pairs, at most 10% with a descriptor differing by more than 5e-2
    (7.3% / 3.1%) and at most 3% with an orientation differing by more
    than 0.05 rad (1.6% / 0.8%); Laplacian signs equal on every pair."""
    gray, cfg = path_band
    st = _keypoint_stats(gray, cfg)
    nj, nt = st["counts"]
    assert nj >= 0.9 * cfg.max_keypoints and abs(nj - nt) <= 0.02 * cfg.max_keypoints, (nj, nt)
    assert st["paired"] >= 0.95, st
    assert st["desc_off"] <= 0.10, st
    assert st["ori_off"] <= 0.03, st
    assert st["laplacian_equal"] == 1.0, st


if __name__ == "__main__":
    for h, w, n_oct, k in PATH_SHAPES:
        cfg = SurfConfig(max_keypoints=k, n_octaves=n_oct, det_mode="xla", gather_mode="mxu",
                         topk_mode="exact")
        band = _textured_band(h, w)
        print(dict(shape=(h, w), det_tolerance_use=_det_tolerance_use(band, cfg),
                   **_keypoint_stats(band, cfg)), flush=True)
