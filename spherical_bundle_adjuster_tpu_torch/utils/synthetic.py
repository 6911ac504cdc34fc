"""Synthetic ERP scenes: the pure-rotation half of
spherical_bundle_adjuster_tpu/utils/synthetic.py.

The scene is a procedural function of the viewing direction (random
Fourier shading plus high-contrast spherical discs), so a rotated view is
rendered exactly. The texture parameters are numpy arrays drawn from a
numpy Generator: the same arrays handed to the reference's `_texture`
render the same scene in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import rotation, sphere

_ROWS = 128  # image rows rendered per chunk (bounds the (pixels, discs) temporaries)


def texture_params_from_numpy(rng: np.random.Generator, n_waves=24, n_discs=96):
    """(freqs, phases, amps, centers, radii, colors) as float32 numpy
    arrays, with the shapes and ranges of the reference's _texture_params."""
    freqs = rng.normal(size=(n_waves, 3)) * 4.0
    phases = rng.uniform(0.0, 2 * np.pi, n_waves)
    amps = rng.uniform(0.0, 1.0, (n_waves, 3))
    centers = rng.normal(size=(n_discs, 3))
    centers = centers / np.linalg.norm(centers, axis=-1, keepdims=True)
    radii = rng.uniform(0.01, 0.08, n_discs)
    colors = rng.uniform(-1.0, 1.0, (n_discs, 3))
    return tuple(
        np.asarray(a, np.float32) for a in (freqs, phases, amps, centers, radii, colors)
    )


def _texture(v, params):
    """v: (..., 3) unit directions -> (..., 3) float colours in [0, 255].
    The disc test dots > cos(radii) sits within ~1e-3 of 1.0, so the
    contractions must stay in true float32 (TF32 is off, core/precision)."""
    freqs, phases, amps, centers, radii, colors = params
    proj = v @ freqs.T + phases
    base = torch.cos(proj) @ amps / freqs.shape[0]
    inside = (v @ centers.T > torch.cos(radii)).to(v.dtype)
    img = 0.5 + 1.5 * base + 0.5 * (inside @ colors)
    return torch.clamp(img, 0.0, 1.0) * 255.0


def render_erp(params, R, height: int = 128, width: int = 256, device="cuda"):
    """Render the scene viewed through rotation R as an ERP image
    (H, W, 3) uint8 on `device`. render(I) and render(R) form an exact
    pure-rotation pair."""
    p = tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in params)
    R = torch.as_tensor(R, dtype=torch.float32, device=device)
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=device)
    for r0 in range(0, height, _ROWS):
        ys = torch.arange(r0, min(r0 + _ROWS, height), dtype=torch.float32,
                          device=device) + 0.5
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        v = sphere.pixel_to_bearing(torch.stack([gx, gy], -1), width, height)
        out[r0 : r0 + ys.shape[0]] = _texture(v @ R.T, p).to(torch.uint8)
    return out


def rotation_pair(params, euler, height=128, width=256, device="cuda"):
    """(left, right, R_gt): a point seen along left bearing b_l appears in
    the right image along b_r = R_gt @ b_l, R_gt = euler_to_matrix(euler)
    (the reference eval's GT convention)."""
    R = rotation.euler_to_matrix(torch.as_tensor(euler, dtype=torch.float32, device=device))
    eye = torch.eye(3, dtype=torch.float32, device=device)
    left = render_erp(params, eye, height, width, device)
    right = render_erp(params, R.T, height, width, device)
    return left, right, R
