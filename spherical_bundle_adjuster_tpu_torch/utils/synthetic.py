"""Synthetic ERP scenes, from spherical_bundle_adjuster_tpu/utils/
synthetic.py: pure-rotation pairs, pairs with parallax and frames along a
trajectory.

The scene is a procedural function of the viewing direction (random
Fourier shading plus high-contrast spherical discs), so a rotated view is
rendered exactly; `render_erp_at` puts the discs at finite distances, so
a translated camera sees real parallax. The texture parameters and disc
distances are numpy arrays drawn from a numpy Generator: the same arrays
handed to the reference's renderers render the same scene in both
packages.
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


def disc_distances_from_numpy(rng: np.random.Generator, n_discs=96, min_dist=2.0,
                              max_dist=6.0):
    """(n_discs,) float32 world distances of the discs, uniform in
    [min_dist, max_dist) (the reference's render_erp_at draws them)."""
    return np.asarray(rng.uniform(min_dist, max_dist, n_discs), np.float32)


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


def _pixel_bearings(height, width, r0, r1, device):
    """Unit bearings (r1 - r0, W, 3) of the pixel centres of rows [r0, r1)."""
    ys = torch.arange(r0, r1, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return sphere.pixel_to_bearing(torch.stack([gx, gy], -1), width, height)


def render_erp(params, R, height: int = 128, width: int = 256, device="cuda"):
    """Render the scene viewed through rotation R as an ERP image
    (H, W, 3) uint8 on `device`. render(I) and render(R) form an exact
    pure-rotation pair."""
    p = tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in params)
    R = torch.as_tensor(R, dtype=torch.float32, device=device)
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=device)
    for r0 in range(0, height, _ROWS):
        r1 = min(r0 + _ROWS, height)
        v = _pixel_bearings(height, width, r0, r1, device)
        out[r0:r1] = _texture(v @ R.T, p).to(torch.uint8)
    return out


def render_erp_at(params, dists, pose_aa_t, height: int = 128, width: int = 256,
                  device="cuda"):
    """Render the scene from a camera with pose [angle-axis | t] (6,) in
    the BA convention p_cam = R X_world - t (camera centre R^T t), as an
    ERP image (H, W, 3) uint8 on `device`. The discs sit at world points
    centers * dists, so translating the camera gives real parallax; the
    Fourier background stays at infinity."""
    freqs, phases, amps, centers, radii, colors = (
        torch.as_tensor(a, dtype=torch.float32, device=device) for a in params)
    dists = torch.as_tensor(dists, dtype=torch.float32, device=device)
    pose = torch.as_tensor(pose_aa_t, dtype=torch.float32, device=device)
    R = rotation.angle_axis_to_matrix(pose[:3])
    c = R.T @ pose[3:]  # camera centre
    rel = centers * dists[:, None] - c
    dist_c = torch.linalg.vector_norm(rel, dim=-1)
    dir_world = rel / torch.clamp(dist_c[:, None], min=1e-6)
    ang = torch.arcsin(torch.clamp(radii * dists / torch.clamp(dist_c, min=1e-6), 0.0, 1.0))
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=device)
    for r0 in range(0, height, _ROWS):
        r1 = min(r0 + _ROWS, height)
        v = _pixel_bearings(height, width, r0, r1, device) @ R  # R^T b
        base = torch.cos(v @ freqs.T + phases) @ amps / freqs.shape[0]
        discs = (v @ dir_world.T > torch.cos(ang)).to(v.dtype) @ colors
        img = 0.5 + 1.5 * base + 0.5 * discs
        out[r0:r1] = (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
    return out


def render_trajectory(params, dists, poses_aa_t, height=128, width=256, device="cuda"):
    """Stack of ERP frames (N, H, W, 3) uint8 along a camera trajectory
    (N, 6) [angle-axis | t], each render_erp_at's: the multi-keyframe
    fixture with exact ground-truth poses and parallax."""
    return torch.stack([render_erp_at(params, dists, pose, height, width, device)
                        for pose in poses_aa_t])


def translation_pair(params, dists, euler, t, height=128, width=256, device="cuda"):
    """(left, right, R_gt, t_gt): a two-view pair with parallax. The left
    camera is the identity at the origin; the right one has rotation
    R_gt = euler_to_matrix(euler) and translation t_gt in the BA
    convention p_right = R_gt X - t_gt, so a disc point seen along b_l
    appears along b_r = (R_gt X - t_gt) / |...|."""
    R = rotation.euler_to_matrix(torch.as_tensor(euler, dtype=torch.float32, device=device))
    aa = rotation.matrix_to_angle_axis(R)
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    left = render_erp_at(params, dists, torch.zeros(6, device=device), height, width, device)
    right = render_erp_at(params, dists, torch.cat([aa, t]), height, width, device)
    return left, right, R, t


def rotation_pair(params, euler, height=128, width=256, device="cuda"):
    """(left, right, R_gt): a point seen along left bearing b_l appears in
    the right image along b_r = R_gt @ b_l, R_gt = euler_to_matrix(euler)
    (the reference eval's GT convention)."""
    R = rotation.euler_to_matrix(torch.as_tensor(euler, dtype=torch.float32, device=device))
    eye = torch.eye(3, dtype=torch.float32, device=device)
    left = render_erp(params, eye, height, width, device)
    right = render_erp(params, R.T, height, width, device)
    return left, right, R
