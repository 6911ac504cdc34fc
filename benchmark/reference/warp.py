"""Gather-based image resampling, from
spherical_bundle_adjuster_tpu/ops/warp.py: rotated band crops, the band
-> ERP keypoint map and the full-sphere rotation warp. Each warp computes
its source coordinates in float32, then gathers; a trailing channel axis
rides along, so a stack of gray images moved to the channel axis
(H, W, N) is warped in one gather.

Sampling modes:
  * "floor"    — integer truncation (+2e-3 epsilon), bit-matching the
                 reference's nearest-neighbour convention.
  * "nearest"  — round-to-nearest.
  * "bilinear" — 4-tap bilinear.
"""

from __future__ import annotations

import torch

from . import rotation, sphere


def _gather_pixels(image, ix, iy):
    """image: (H, W, C) or (H, W); ix/iy integer tensors of one shape,
    clamped to the image."""
    h, w = image.shape[0], image.shape[1]
    lin = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    if image.ndim == 2:
        return image.reshape(-1)[lin]
    return image.reshape(h * w, -1)[lin]


def resample(image, coords, mode: str = "floor"):
    """Sample `image` at fractional pixel `coords` (..., 2) = (x, y).

    Returns coords.shape[:-1] + image.shape[2:].
    """
    x = coords[..., 0]
    y = coords[..., 1]
    if mode == "bilinear":
        x, y = x.to(torch.float32), y.to(torch.float32)
    if mode == "floor":
        # float32 warp coordinates that are integral in exact arithmetic
        # land a few ulps below the integer; the epsilon keeps floor parity.
        eps = 2e-3
        return _gather_pixels(
            image,
            torch.floor(x + eps).to(torch.int64),
            torch.floor(y + eps).to(torch.int64),
        )
    if mode == "nearest":
        return _gather_pixels(
            image, torch.round(x).to(torch.int64), torch.round(y).to(torch.int64)
        )
    if mode == "bilinear":
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        if image.ndim == 3:
            fx, fy = fx[..., None], fy[..., None]
        x0i = x0.to(torch.int64)
        y0i = y0.to(torch.int64)
        p00 = _gather_pixels(image, x0i, y0i).to(torch.float32)
        p01 = _gather_pixels(image, x0i + 1, y0i).to(torch.float32)
        p10 = _gather_pixels(image, x0i, y0i + 1).to(torch.float32)
        p11 = _gather_pixels(image, x0i + 1, y0i + 1).to(torch.float32)
        top = p00 * (1 - fx) + p01 * fx
        bot = p10 * (1 - fx) + p11 * fx
        out = top * (1 - fy) + bot * fy
        return out if image.dtype.is_floating_point else out.to(image.dtype)
    raise ValueError(f"unknown resample mode: {mode}")


def erp_rotation_coords(R, width, height, row_start, num_rows):
    """Source ERP coordinates (..., num_rows, W, 2) of an inverse rotation
    warp of output rows [row_start, row_start + num_rows); R is (..., 3, 3)
    (a leading batch of rotations gives a leading batch of grids)."""
    dev = R.device
    rows = row_start + torch.arange(num_rows, dtype=torch.float32, device=dev)
    cols = torch.arange(width, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(rows, cols, indexing="ij")
    xy = torch.stack([gx, gy], dim=-1)
    v = sphere.pixel_to_bearing(xy, width, height)  # (num_rows, W, 3)
    v_rot = torch.einsum("...rc,ijc->...ijr", R.to(torch.float32), v)
    return sphere.bearing_to_pixel(v_rot, width, height)


def rotate_erp(image, R, mode: str = "floor"):
    """Full-sphere rotation warp of an ERP image (H, W, ...) by rotation
    matrix R (3, 3)."""
    h, w = image.shape[0], image.shape[1]
    return resample(image, erp_rotation_coords(R, w, h, 0, h), mode)


def _pitch_matrix(pitch_rad):
    zero = torch.zeros_like(pitch_rad)
    return rotation.euler_to_matrix(torch.stack([zero, pitch_rad, zero], dim=-1))


def crop_rotated_band(image, pitch_rad, mode: str = "floor"):
    """The H/4-tall equatorial band (rows [3H/8, 5H/8)) of the
    pitch-rotated sphere — the reference's crop_rotated_image.

    pitch_rad: scalar tensor, or (P,) for P bands at once ->
    (P, H/4, W, ...) crops.
    """
    h, w = image.shape[0], image.shape[1]
    R = _pitch_matrix(pitch_rad)
    coords = erp_rotation_coords(R, w, h, 3 * h // 8, h // 4)
    return resample(image, coords, mode)


def band_pixel_to_erp(xy_band, pitch_rad, width, height):
    """Map keypoint pixels detected in a rotated band back to original ERP
    coordinates: offset rows by 3H/8, then the crop's rotation mapping.

    xy_band: (K, 2) with a scalar pitch, or (B, K, 2) with (B,) pitches."""
    offset = torch.tensor(
        [0.0, 3.0 * height / 8.0], dtype=xy_band.dtype, device=xy_band.device
    )
    R = _pitch_matrix(pitch_rad).to(xy_band.dtype)
    v = sphere.pixel_to_bearing(xy_band + offset, width, height)
    v_rot = torch.matmul(v, R.transpose(-1, -2))
    return sphere.bearing_to_pixel(v_rot, width, height)
