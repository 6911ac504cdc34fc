"""The port's integral image: both prefix sums accumulate in float64 and
the result is rounded once to float32, so every entry lies within half a
float32 ulp of the exact sum.

The reference's integral image is a float32 scan (jnp.cumsum), whose
error grows with the band: at the bench's 512x1024 pairs its rounding
alone moves several matches of the reference's band front end. The
whole-pair parity tests therefore hand the reference the same exactly
rounded integral image (`exact_reference_integral`), so that the two
packages are compared on one integral image, as they are compared on one
set of pinned backend modes and one set of RANSAC draws.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spherical_bundle_adjuster_tpu.ops import integral as jint
from spherical_bundle_adjuster_tpu_torch.ops import integral as tint

torch.set_num_threads(1)


def _exact_ii(gray):
    """(..., H, W) -> (..., H+1, W+1) float32: float64 prefix sums
    (numpy), rounded once."""
    g = np.asarray(gray, np.float64)
    out = np.zeros(g.shape[:-2] + (g.shape[-2] + 1, g.shape[-1] + 1), np.float32)
    out[..., 1:, 1:] = np.cumsum(np.cumsum(g, -2), -1)
    return out


@contextlib.contextmanager
def exact_reference_integral():
    """Within the block, the reference's integral_image is the exactly
    rounded one (a host callback into _exact_ii). The jit caches are
    cleared on entry and on exit, so no trace outlives the block or
    predates it."""

    def exact(gray):
        shape = gray.shape[:-2] + (gray.shape[-2] + 1, gray.shape[-1] + 1)
        return jax.pure_callback(_exact_ii, jax.ShapeDtypeStruct(shape, jnp.float32),
                                 gray.astype(jnp.float32), vmap_method="broadcast_all")

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jint, "integral_image", exact)
        yield
    jax.clear_caches()


def _gray(shape, seed):
    """A gray band with the 0..255 range and the fractional values of
    rgb_to_gray."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, shape + (3,)).astype(np.float32)
    return tint.rgb_to_gray(torch.from_numpy(rgb))


@pytest.mark.parametrize("shape", [(2, 256, 2048), (1, 64, 128), (3, 128, 1024)])
def test_integral_image_within_half_ulp_of_float64(shape):
    """Every entry within half a float32 ulp of its float64 value (plus
    float64's own rounding, 1e-12 relative): at 256x2048 that is at most
    0.5 ulp of max|ii| (4.0 near 1.3e8), where a float32 scan errs by
    several ulps."""
    gray = _gray(shape, sum(shape))
    ii = tint.integral_image(gray)
    assert ii.dtype == torch.float32 and tint.is_row_aligned(ii)
    want = np.cumsum(np.cumsum(gray.numpy().astype(np.float64), -2), -1)
    got = ii[..., 1:, 1:].numpy().astype(np.float64)
    half_ulp = 0.5 * np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert (np.abs(got - want) <= half_ulp + 1e-12 * np.abs(want)).all()
    top = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 0.5 * float(np.spacing(np.float32(top)))
    assert not ii[..., 0, :].any() and not ii[..., :, 0].any()


def test_exact_reference_integral_equals_the_port():
    """The exactly rounded integral image handed to the reference is the
    port's, bit for bit, through jit and vmap."""
    gray = _gray((2, 64, 128), 5)
    with exact_reference_integral():
        ref = jax.jit(jax.vmap(jint.integral_image))(jnp.asarray(gray.numpy()))
    np.testing.assert_array_equal(np.asarray(ref), tint.integral_image(gray).numpy())
