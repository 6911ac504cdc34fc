"""Preconditioned conjugate gradients for the large SPD systems of the
global solvers: spherical_bundle_adjuster_tpu/solver/pcg.py.

The operators are matrix-free: the caller supplies `matvec` (the Schur
complement applied by gather, per-landmark 3x3 product and segment sum,
or the pose-graph Hessian applied per edge) and `precond` (block-Jacobi:
one batched 6x6 product). Nothing quadratic in the parameter count is
materialized.

The reference runs its loop as a `lax.while_loop` that exits on a
data-dependent test. A host-driven loop that read that test every
iteration would sync the host once per CG iteration. Here the test is
evaluated on the device every iteration and an iteration is applied
only where it holds (`torch.where` on the whole state, as `solver/lm`
freezes converged elements), so `x` is frozen at the first iteration
where ||r||^2 <= (tol ||b||)^2 and `iters` counts only the applied
iterations: the while_loop's results. The host reads the test only
every CHECK_EVERY iterations, to end the loop once nothing is applied.
Dot products accumulate in float32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core import smallmat

CHECK_EVERY = 8  # CG iterations between host reads of the stop test


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


class PcgResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor         # iterations applied (int64)
    rel_residual: torch.Tensor  # ||r|| / ||b|| at exit


def pcg(
    matvec: Callable,
    b: torch.Tensor,
    precond: Callable | None = None,
    max_iters: int = 100,
    tol: float = 1e-6,
) -> PcgResult:
    """Solve A x = b for SPD A with preconditioned conjugate gradients.

    matvec(x) -> A x; precond(r) -> M^{-1} r (identity if None). Stops
    where ||r|| <= tol * ||b|| or after max_iters applied iterations."""
    if precond is None:
        precond = lambda r: r

    b_norm = torch.sqrt(_dot(b, b))
    thresh2 = (tol * b_norm) ** 2
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = _dot(r, z)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    active = _dot(r, r) > thresh2
    for i in range(max_iters):
        if i % CHECK_EVERY == 0 and not bool(active):
            break
        ap = matvec(p)
        pap = _dot(p, ap)
        alpha = torch.where(pap > 0, rz / torch.where(pap > 0, pap, 1.0), 0.0)  # breakdown guard
        x_new = x + alpha * p
        r_new = r - alpha * ap
        z_new = precond(r_new)
        rz_new = _dot(r_new, z_new)
        beta = rz_new / torch.where(rz > 0, rz, 1.0)
        p_new = z_new + beta * p
        x, r, z, p, rz = (torch.where(active, new, old) for new, old in
                          ((x_new, x), (r_new, r), (z_new, z), (p_new, p), (rz_new, rz)))
        k = k + active.to(k.dtype)
        active = _dot(r, r) > thresh2
    rel = torch.sqrt(_dot(r, r)) / torch.clamp(b_norm, min=1e-30)
    return PcgResult(x=x, iters=k, rel_residual=rel)


def block_jacobi_precond(diag_blocks):
    """Block-Jacobi preconditioner from (N, B, B) SPD diagonal blocks, for
    r of shape (N*B,) or (N, B).

    The blocks are factored once by `smallmat.cholesky_unrolled` (its
    pivot clamp keeps a block that is not positive definite finite) and
    inverted once by `cholesky_solve_unrolled` on the unit vectors, so
    each application is one batched (B, B) product: one launch per CG
    iteration where the reference runs the unrolled substitutions."""
    n, bdim, _ = diag_blocks.shape
    eye = torch.eye(bdim, dtype=diag_blocks.dtype, device=diag_blocks.device)
    L = smallmat.cholesky_unrolled(diag_blocks + 1e-9 * eye)
    inv = smallmat.cholesky_solve_unrolled(L[:, None], eye.expand(n, bdim, bdim))  # rows: M^-1 e_c

    def apply(r):
        return torch.einsum("nci,nc->ni", inv, r.reshape(n, bdim)).reshape(r.shape)

    return apply
