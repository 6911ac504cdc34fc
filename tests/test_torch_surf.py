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


def test_unported_surf_modes_raise(gray):
    g = torch.from_numpy(gray)[None]
    for cfg in (dataclasses.replace(TCFG, descriptor_interp="bilinear"),
                dataclasses.replace(TCFG, laplacian_mode="gather")):
        with pytest.raises(NotImplementedError):
            tsurf.detect_and_describe(g, cfg)


def test_cuda_wrappers_reject_cpu_tensors(gray):
    """The kernel wrappers check their inputs before any build or launch."""
    ii = _ii(gray)
    with pytest.raises(ValueError):
        cuda_surf.det_pyramid_cuda(ii, TCFG)
    with pytest.raises(ValueError):
        cuda_surf.haar_trace_maps_cuda(ii, TCFG)
    assert cuda_surf.DET_PYRAMID.launches == 0 and cuda_surf.HAAR_TRACE.launches == 0
