"""Cubemap face geometry: per-face ray fields and cube <-> sphere
transforms.

Counterpart of spherical_bundle_adjuster_tpu/core/cube.py. The faces lie
in a horizontal strip left | front | right | back | top | bottom. With
cube pixel (i = row, j = col), S = cube_size, u = (S - 2j) / S and
v = (S - 2i) / S, the face rays are

  left  : ( u,  1,  v)       front : (-1,  u,  v)
  right : (-u, -1,  v)       back  : ( 1, -u,  v)
  top   : ( v,  u,  1)       bottom: (-v,  u, -1)

i.e. ray(face, i, j) = n[face] + a[face] * u(j) + b[face] * v(i).
"""

from __future__ import annotations

import torch

from . import sphere

FACE_NAMES = ("left", "front", "right", "back", "top", "bottom")

_N = [[0, 1, 0], [-1, 0, 0], [0, -1, 0], [1, 0, 0], [0, 0, 1], [0, 0, -1]]
_A = [[1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 1, 0]]
_B = [[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [1, 0, 0], [-1, 0, 0]]


def _face_frames(dtype=torch.float32, device=None):
    """Per-face (origin axis n, column axis a, row axis b), each (6, 3)."""
    return tuple(torch.tensor(m, dtype=dtype, device=device) for m in (_N, _A, _B))


def face_rays(cube_size: int, dtype=torch.float32, device=None):
    """(6, S, S, 3) unnormalized rays of every face, in FACE_NAMES order."""
    s = float(cube_size)
    i = torch.arange(cube_size, dtype=dtype, device=device)
    u = (s - 2.0 * i) / s  # the same formula for rows and columns
    n, a, b = _face_frames(dtype, device)
    return (
        n[:, None, None, :]
        + a[:, None, None, :] * u[None, None, :, None]
        + b[:, None, None, :] * u[None, :, None, None]
    )


def cube_pixel_to_bearing(xy, cube_size: int):
    """Cube-strip pixel (x in [0, 6S), y in [0, S)) -> unit bearing: the
    face is chosen by x's span, then its ray frame is evaluated.
    Broadcasts over leading dimensions."""
    x, y = xy[..., 0], xy[..., 1]
    s = float(cube_size)
    face = torch.clamp(torch.div(x, s, rounding_mode="floor").to(torch.int64), 0, 5)
    xf = x - face.to(x.dtype) * s  # x within the face
    u = (s - 2.0 * xf) / s
    v = (s - 2.0 * y) / s
    n, a, b = _face_frames(x.dtype, x.device)
    ray = n[face] + a[face] * u[..., None] + b[face] * v[..., None]
    return ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)


def cube_pixel_to_erp_pixel(xy, cube_size: int, width: int, height: int):
    """Cube-strip pixel -> ERP pixel."""
    return sphere.bearing_to_pixel(cube_pixel_to_bearing(xy, cube_size), width, height)
