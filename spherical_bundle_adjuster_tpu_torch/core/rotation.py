"""Rotation representations: Euler (XYZ extrinsic, R = Rz @ Ry @ Rx),
rotation matrices, and angle-axis (Rodrigues).

Counterpart of spherical_bundle_adjuster_tpu/core/rotation.py with the
same conventions and the same small-angle branches. All functions
broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch


def _stack3x3(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def euler_to_matrix(euler):
    """(..., 3) Euler (rx, ry, rz) -> (..., 3, 3) rotation, R = Rz@Ry@Rx."""
    rx, ry, rz = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    return _stack3x3(
        [
            [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
            [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
            [-sy, cy * sx, cy * cx],
        ]
    )


def matrix_to_euler(R):
    """(..., 3, 3) -> (..., 3) Euler, with the reference's gimbal branch."""
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    rx = torch.where(
        singular,
        torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
        torch.atan2(R[..., 2, 1], R[..., 2, 2]),
    )
    ry = torch.atan2(-R[..., 2, 0], sy)
    rz = torch.where(
        singular, torch.zeros_like(sy), torch.atan2(R[..., 1, 0], R[..., 0, 0])
    )
    return torch.stack([rx, ry, rz], dim=-1)


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return _stack3x3([[zero, -z, y], [z, zero, -x], [-y, x, zero]])


def angle_axis_to_matrix(aa):
    """Rodrigues: (..., 3) angle-axis -> (..., 3, 3) rotation matrix."""
    theta2 = torch.sum(aa * aa, dim=-1)
    theta = torch.sqrt(theta2 + 1e-32)
    small = theta2 < 1e-12
    s = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    c = torch.where(
        small,
        0.5 - theta2 / 24.0,
        (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-32),
    )
    K = skew(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye + s[..., None, None] * K + c[..., None, None] * (K @ K)


def rotate_angle_axis(aa, v):
    """Rotate vectors v (..., 3) by angle-axis aa (..., 3) (Rodrigues vector
    formula, the ceres::AngleAxisRotatePoint of the BA residual)."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-32)
    small = theta2 < 1e-12
    s = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    c = torch.where(small, theta2 / 2.0, 1.0 - torch.cos(theta))
    w = aa / theta
    wxv = torch.linalg.cross(w.expand(v.shape), v, dim=-1)
    wdv = torch.sum(w * v, dim=-1, keepdim=True)
    cos_t = 1.0 - c
    return v * cos_t + wxv * s * theta + w * wdv * c


def right_jacobian(r):
    """(..., 3) -> (..., 3, 3) right Jacobian of SO(3), J_r(r) =
    I - a [r]x + b [r]x^2 with a = (1 - cos th) / th^2 and
    b = (th - sin th) / th^3: R(r + d) = R(r) exp([J_r(r) d]x) to first
    order. Below th = 0.1 their Taylor series (to th^4) replace them:
    th - sin th cancels catastrophically in float32 there."""
    theta2 = torch.sum(r * r, dim=-1)[..., None, None]
    small = theta2 < 1e-2
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe = torch.sqrt(safe2)
    a = torch.where(small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
                    (1.0 - torch.cos(safe)) / safe2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
                    (safe - torch.sin(safe)) / (safe2 * safe))
    K = skew(r)
    return torch.eye(3, dtype=r.dtype, device=r.device) - a * K + b * (K @ K)


def rotation_jacobian(r, x1):
    """d/dr of x2 - (R(r) x1 - t): (..., M, 3, 3) = R [x1]x J_r(r) for r
    (..., 3) and x1 (..., M, 3), with J_r the right Jacobian of SO(3)
    (`right_jacobian`)."""
    return (angle_axis_to_matrix(r)[..., None, :, :] @ skew(x1)
            @ right_jacobian(r)[..., None, :, :])


def right_jacobian_inverse(phi):
    """(..., 3) -> (..., 3, 3) inverse of the right Jacobian, J_r^-1(phi) =
    I + [phi]x / 2 + c [phi]x^2 with c = 1/th^2 - (1 + cos th) /
    (2 th sin th): log(exp([phi]x) exp([d]x)) = phi + J_r^-1(phi) d to
    first order. Below th = 0.1, c's Taylor series (to th^4) replaces it,
    which cancels catastrophically in float32 there. Stable away from
    th = pi, as matrix_to_angle_axis is."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = theta2 < 1e-2
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe = torch.sqrt(safe2)
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
                    1.0 / safe2 - (1.0 + torch.cos(safe)) / (2.0 * safe * torch.sin(safe)))
    K = skew(phi)
    return torch.eye(3, dtype=phi.dtype, device=phi.device) + 0.5 * K + c * (K @ K)


def matrix_to_angle_axis(R):
    """(..., 3, 3) -> (..., 3) angle-axis (log map), stable away from pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = (trace - 1.0) / 2.0
    ax = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin2 = torch.sum(ax * ax, dim=-1) / 4.0
    small = sin2 < 1e-12
    sin_t = torch.sqrt(torch.where(small, torch.ones_like(sin2), sin2))
    theta = torch.atan2(
        torch.where(small, torch.zeros_like(sin_t), sin_t),
        torch.clamp(cos_t, -1.0, 1.0),
    )
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_t))
    return ax * scale[..., None]


def euler_to_angle_axis(euler):
    """Exact Euler -> angle-axis conversion."""
    return matrix_to_angle_axis(euler_to_matrix(euler))
