"""Unit-sphere <-> equirectangular (ERP) pixel coordinate transforms.

Counterpart of spherical_bundle_adjuster_tpu/core/sphere.py, same
conventions:

  * theta = colatitude in [0, pi], measured from +z:  theta = pi * y / H
  * phi   = longitude  in [0, 2*pi), from +x toward +y:  phi = 2*pi * x / W
  * cartesian bearing:  (sin(theta)*cos(phi), sin(theta)*sin(phi), cos(theta))

All functions broadcast over leading batch dimensions; the last axis
carries coordinates.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def pixel_to_spherical(xy, width, height):
    """ERP pixel (x, y) -> (theta, phi) radians, stacked on the last axis."""
    theta = math.pi * xy[..., 1] / height
    phi = TWO_PI * xy[..., 0] / width
    return torch.stack([theta, phi], dim=-1)


def spherical_to_pixel(tp, width, height):
    """(theta, phi) radians -> ERP pixel (x, y); phi wrapped to [0, 2*pi)."""
    theta = tp[..., 0]
    phi = torch.remainder(tp[..., 1], TWO_PI)
    x = width * phi / TWO_PI
    y = height * theta / math.pi
    return torch.stack([x, y], dim=-1)


def spherical_to_cartesian(tp):
    """(theta, phi) -> unit bearing vector (..., 3)."""
    theta = tp[..., 0]
    phi = tp[..., 1]
    st = torch.sin(theta)
    return torch.stack(
        [st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)], dim=-1
    )


def cartesian_to_spherical(v):
    """Unit vector (..., 3) -> (theta, phi) with phi in [0, 2*pi)."""
    z = torch.clamp(v[..., 2], -1.0, 1.0)
    theta = torch.arccos(z)
    phi = torch.atan2(v[..., 1], v[..., 0])
    phi = torch.where(phi < 0, phi + TWO_PI, phi)
    return torch.stack([theta, phi], dim=-1)


def pixel_to_bearing(xy, width, height):
    """ERP pixel -> unit bearing vector (the reference's 'lifting')."""
    return spherical_to_cartesian(pixel_to_spherical(xy, width, height))


def bearing_to_pixel(v, width, height):
    """Unit bearing vector -> ERP pixel."""
    return spherical_to_pixel(cartesian_to_spherical(v), width, height)


def angular_distance(v1, v2):
    """Angle between unit vectors (radians): atan2(|v1 x v2|, v1 . v2)."""
    dot = torch.sum(v1 * v2, dim=-1)
    cross = torch.linalg.vector_norm(torch.linalg.cross(v1, v2, dim=-1), dim=-1)
    return torch.atan2(cross, dot)
