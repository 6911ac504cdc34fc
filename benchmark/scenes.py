"""Synthetic pure-rotation ERP pairs: a frozen copy of the renderer in
spherical_bundle_adjuster_tpu_torch/utils/synthetic.py (texture_params_
from_numpy, render_erp, rotation_pair), so that a change to the program
cannot change the benchmark's inputs.

The scene is a procedural function of the viewing direction (random
Fourier shading plus high-contrast spherical discs), so a rotated view is
rendered exactly. Its parameters are numpy arrays drawn from a numpy
Generator; the images are rendered on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import rotation, sphere

_ROWS = 128  # image rows rendered per chunk (bounds the (pixels, discs) temporaries)


def texture_params_from_numpy(rng: np.random.Generator, n_waves=24, n_discs=96):
    """(freqs, phases, amps, centers, radii, colors) as float32 numpy arrays."""
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
    The disc test sits within ~1e-3 of 1.0, so the contractions must run
    in true float32 (the caller keeps TF32 off)."""
    freqs, phases, amps, centers, radii, colors = params
    proj = v @ freqs.T + phases
    base = torch.cos(proj) @ amps / freqs.shape[0]
    inside = (v @ centers.T > torch.cos(radii)).to(v.dtype)
    img = 0.5 + 1.5 * base + 0.5 * (inside @ colors)
    return torch.clamp(img, 0.0, 1.0) * 255.0


def _pixel_bearings(height, width, r0, r1, device):
    """Unit bearings (r1 - r0, W, 3) of the pixel centres of rows [r0, r1)."""
    ys = torch.arange(r0, r1, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return sphere.pixel_to_bearing(torch.stack([gx, gy], -1), width, height)


def render_erp(params, R, height, width, device):
    """The scene viewed through rotation R as an ERP image (H, W, 3) uint8."""
    p = tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in params)
    R = torch.as_tensor(R, dtype=torch.float32, device=device)
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=device)
    for r0 in range(0, height, _ROWS):
        r1 = min(r0 + _ROWS, height)
        v = _pixel_bearings(height, width, r0, r1, device)
        out[r0:r1] = _texture(v @ R.T, p).to(torch.uint8)
    return out


def rotation_pair(params, euler, height, width, device):
    """(left, right, R_gt): a point seen along left bearing b_l appears in
    the right image along b_r = R_gt @ b_l, R_gt = euler_to_matrix(euler)."""
    R = rotation.euler_to_matrix(torch.as_tensor(euler, dtype=torch.float32, device=device))
    eye = torch.eye(3, dtype=torch.float32, device=device)
    left = render_erp(params, eye, height, width, device)
    right = render_erp(params, R.T, height, width, device)
    return left, right, R
