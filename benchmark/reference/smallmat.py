"""Small-matrix linear algebra: closed forms for 2x2 and 3x3 blocks, a
Cholesky solve for the small PSD systems of the joint solve and of the
dense camera and pose-graph systems, and the unrolled Cholesky of the
block-Jacobi preconditioner's 6x6 blocks.

Counterpart of the closed forms in spherical_bundle_adjuster_tpu/core/
smallmat.py. Adjugate and Cramer forms are elementwise arithmetic over
the batch, which keeps the tiny per-match systems of the LM stages and
the SURF subpixel refine off generic batched LU on the GPU as well.

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch


def inv2(A):
    """(..., 2, 2) inverse via adjugate."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    row0 = torch.stack([d, -b], dim=-1)
    row1 = torch.stack([-c, a], dim=-1)
    return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]


def solve2(A, b):
    """Solve (..., 2, 2) x = (..., 2) by Cramer's rule."""
    a00, a01 = A[..., 0, 0], A[..., 0, 1]
    a10, a11 = A[..., 1, 0], A[..., 1, 1]
    inv_det = 1.0 / (a00 * a11 - a01 * a10)
    x0 = (b[..., 0] * a11 - b[..., 1] * a01) * inv_det
    x1 = (a00 * b[..., 1] - a10 * b[..., 0]) * inv_det
    return torch.stack([x0, x1], dim=-1)


def _cofactor3(A):
    """Cofactor matrix (transpose of adjugate) of (..., 3, 3)."""
    a = A
    c = [
        [
            a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1],
            a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2],
            a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0],
        ],
        [
            a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2],
            a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0],
            a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1],
        ],
        [
            a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1],
            a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2],
            a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0],
        ],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in c], dim=-2)


def det3(A):
    a = A
    return (
        a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
        - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
        + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
    )


def inv3(A):
    """(..., 3, 3) inverse via adjugate."""
    return _cofactor3(A).transpose(-1, -2) / det3(A)[..., None, None]


def solve3(A, b):
    """Solve (..., 3, 3) x = (..., 3) via adjugate: x_i = sum_j cof[j, i] b_j / det."""
    cof = _cofactor3(A)
    return torch.einsum("...ji,...j->...i", cof, b) / det3(A)[..., None]


def solve_psd(A, b):
    """Solve a small symmetric positive-definite (..., n, n) x = (..., n) by
    Cholesky and two triangular solves. Where A is not positive definite
    the solution is NaN, as XLA's Cholesky gives it (the joint solve
    rejects a NaN step by its cost test); `cholesky_ex` neither raises nor
    syncs the host."""
    L, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]
    return torch.where((info == 0)[..., None], x, torch.nan)


def cholesky_unrolled(A):
    """Cholesky factor of small SPD (..., n, n) blocks, unrolled over the
    static n in the reference's order of operations (core/smallmat.py).

    Each pivot is clamped to 1e-30 before its square root, so a block that
    is not positive definite still gives a finite factor where
    `cholesky_ex` would give NaN; the block-Jacobi preconditioner relies
    on that. Column j is computed for all rows below it at once."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[..., j:, j]
        for k in range(j):
            s = s - L[..., j:, k] * L[..., j, k, None]
        d = torch.sqrt(torch.clamp(s[..., 0], min=1e-30))
        L[..., j, j] = d
        L[..., j + 1:, j] = s[..., 1:] * (1.0 / d)[..., None]
    return L


def cholesky_solve_unrolled(L, b):
    """Solve L L^T x = b for lower-triangular (..., n, n) L and (..., n) b
    by unrolled forward and back substitution, in the reference's order."""
    n = L.shape[-1]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)
