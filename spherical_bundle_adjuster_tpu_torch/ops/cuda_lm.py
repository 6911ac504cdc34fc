"""solver/lm's LM loop trips on the card (csrc/lm_trip.cu).

`start` sets up a stage's loop state and evaluates its initial system;
each `Trips.run` after it is one trip of the loop on that state, in
place: the damped solve, the trial point's system and the accept /
reject updates that lm._trip computes op by op, its plain version, bit
for bit. Both add the problems still active after them, and those of
them the stage keeps, into a (2,) int32 counts buffer, which the loop
reads on the host once a trip. The tensors are checked and their
pointers taken once a loop.

The depth stage's problem (`DepthProblem`) runs one thread a 2x2 problem;
the rotation and translation stages' (`GlobalProblem`) one block a
3-parameter problem over its matches. The wrappers take contiguous
float32 CUDA tensors and raise on anything else: solver/lm routes CPU
tensors, and other dtypes, to lm._trip before they get here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import kernels

DEPTH_POINT = kernels.Kernel("sba_lm_depth_point")
DEPTH_SETTLE = kernels.Kernel("sba_lm_depth_settle")
SOLVE = kernels.Kernel("sba_lm_global_solve")
POINT = kernels.Kernel("sba_lm_global_point")
SETTLE = kernels.Kernel("sba_lm_global_settle")
KERNELS = (DEPTH_POINT, DEPTH_SETTLE, SOLVE, POINT, SETTLE)


class DepthProblem(NamedTuple):
    """solve_depths' N problems: each one's bearings b1, b2 and pose r, t
    (N, 3), j_rep (N, 3, 2) = d rep / d (d1, d2) and h_rep = j_rep^T j_rep
    (N, 2, 2), and the barrier lambda * exp(-c * d)."""

    b1: torch.Tensor
    b2: torch.Tensor
    r: torch.Tensor
    t: torch.Tensor
    j_rep: torch.Tensor
    h_rep: torch.Tensor
    barrier_lambda: float
    barrier_c: float


class GlobalProblem(NamedTuple):
    """The rotation (rotation=True) or translation stage's N problems:
    bearing banks b1, b2 (B, M, 3), problem n on bank n // (N // B); depths
    d, the pair (N, 2) that every match shares or (N, M, 2); the mask valid
    (N, M); the pose part held fixed (N, 3), t or r; the Huber delta; the
    leading axes `lead` of the stage's start (N = prod(lead)); and the
    translation stage's Jacobian, the identity expanded to lead + (M, 3,
    3) as the stage's cost_and_system holds it (None for rotation)."""

    rotation: bool
    b1: torch.Tensor
    b2: torch.Tensor
    d: torch.Tensor
    valid: torch.Tensor
    fixed: torch.Tensor
    huber_delta: float
    lead: tuple
    eye: torch.Tensor | None


def _check(t, name, dtype, shape, dev):
    """Type and layout before the device, so that each refusal shows on
    CPU tensors too."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    kernels.check(t, name, dtype, dev, shape)


def start(problem, x0, cfg, lower_bound, kept, counts):
    """The loop at x0 (N, n), as `Trips` over a state of its own: the
    initial system, lam at cfg.lm_lambda_init, no iteration, nothing
    done; adds (N, kept count) into counts."""
    _check(x0, "x0", torch.float32, x0.shape, x0.device)
    (m, n), dev = x0.shape, x0.device
    f32 = dict(dtype=torch.float32, device=dev)
    state = (x0.clone(), torch.empty((m, n, n), **f32), torch.empty((m, n), **f32),
             torch.empty(m, **f32), torch.empty(m, **f32), torch.empty(m, **f32),
             torch.empty(m, dtype=torch.int32, device=dev),
             torch.empty(m, dtype=torch.bool, device=dev))
    trips = Trips(problem, state, cfg, lower_bound, kept)
    trips.run(counts, evaluate=True)
    return trips


class Trips:
    """The trip kernels bound to one loop: `state` = (x, H, g, cost,
    cost_s, lam, it, done) of N problems of n parameters, updated in place
    by each `run`, and the problem, damping and kept mask (None: every
    problem is kept) of the stage. Every tensor is checked once, here.

    A trip's products and sums over more than one element run as the same
    aten calls as in the stage's op-by-op trip (lm._trip and the stage's
    cost_and_system), on the same shapes, so they round alike; everything
    else is elementwise and rounds as aten's kernels do (csrc/lm_trip.cu).
    So a trip gives the op-by-op trip's state bit for bit. A depth trip:
    DEPTH_POINT, the bmm j_rep^T rep, DEPTH_SETTLE. A rotation or
    translation trip: SOLVE, the damped solve's einsum, POINT, the einsums
    of H and g and the sum of the cost over the matches, SETTLE (an
    initial evaluation starts at POINT)."""

    def __init__(self, problem, state, cfg, lower_bound, kept):
        (n, k), dev = state[0].shape, state[0].device
        shapes = ((n, k), (n, k, k), (n, k), (n,), (n,), (n,), (n,), (n,))
        dtypes = (torch.float32,) * 6 + (torch.int32, torch.bool)
        for name, t, shape, dtype in zip(("x", "H", "g", "cost", "cost_s", "lam", "it", "done"),
                                         state, shapes, dtypes):
            _check(t, name, dtype, shape, dev)
        if kept is not None:
            _check(kept, "kept", torch.bool, (n,), dev)
        # the tensors behind the pointers below live as long as this object
        self.state, self.device, self.problem, self._kept = state, dev, problem, kept
        self._state = [kernels.ptr(t) for t in state]
        self._kept_ptr = None if kept is None else kernels.ptr(kept)
        self._n = n
        lower = -float("inf") if lower_bound is None else lower_bound
        self._damping = [cfg.lm_lambda_init, cfg.lm_lambda_down, cfg.lm_lambda_up,
                         cfg.function_tolerance]
        f32 = dict(dtype=torch.float32, device=dev)
        if isinstance(problem, DepthProblem):
            if k != 2:
                raise ValueError(f"depth stage: expected 2 parameters a problem, got {k}")
            for name in ("b1", "b2", "r", "t"):
                _check(getattr(problem, name), name, torch.float32, (n, 3), dev)
            _check(problem.j_rep, "j_rep", torch.float32, (n, 3, 2), dev)
            _check(problem.h_rep, "h_rep", torch.float32, (n, 2, 2), dev)
            self._dn, self._rep = torch.empty((n, 2), **f32), torch.empty((n, 3), **f32)
            self.scratch = (self._dn, self._rep)
            self._point = [kernels.ptr(getattr(problem, f)) for f in ("b1", "b2", "r", "t")] + [
                kernels.ptr(self._dn), kernels.ptr(self._rep), n]
            self._lower = lower
            self._settle = [kernels.ptr(problem.h_rep), kernels.ptr(self._dn),
                            kernels.ptr(self._rep)]
            return
        if k != 3:
            raise ValueError(f"rotation / translation stage: expected 3 parameters a problem, got {k}")
        banks, m = problem.b1.shape[0], problem.b1.shape[1]
        if banks < 1 or n % banks:
            raise ValueError(f"{n} problems do not share {banks} banks evenly")
        lead = tuple(problem.lead)
        if math.prod(lead) != n:
            raise ValueError(f"leading axes {lead} do not hold {n} problems")
        _check(problem.b1, "b1", torch.float32, (banks, m, 3), dev)
        _check(problem.b2, "b2", torch.float32, (banks, m, 3), dev)
        per_match = problem.d.ndim == 3
        _check(problem.d, "d", torch.float32, (n, m, 2) if per_match else (n, 2), dev)
        _check(problem.valid, "valid", torch.bool, (n, m), dev)
        _check(problem.fixed, "fixed", torch.float32, (n, 3), dev)
        if not problem.rotation and (problem.eye is None
                                     or tuple(problem.eye.shape) != lead + (m, 3, 3)):
            raise ValueError("translation stage: expected its Jacobian, the identity expanded "
                             f"to {lead + (m, 3, 3)}")
        self._cof, self._det = torch.empty((n, 3, 3), **f32), torch.empty(n, **f32)
        xn = torch.empty((n, 3), **f32)
        res = torch.empty(lead + (m, 3), **f32)
        jac = torch.empty(lead + (m, 3, 3), **f32) if problem.rotation else problem.eye
        jw = torch.empty(lead + (m, 3, 3), **f32)
        rhov = torch.empty(lead + (m,), **f32)
        self.scratch = (self._cof, self._det, xn, res, jw, rhov) + (
            (jac,) if problem.rotation else ())
        self._views = jac, jw, res, rhov
        self._xn = kernels.ptr(xn)
        self._consts = [kernels.ptr(getattr(problem, f))
                        for f in ("b1", "b2", "d", "valid", "fixed")]
        self._outs = [self._xn, kernels.ptr(res),
                      kernels.ptr(jac) if problem.rotation else None, kernels.ptr(jw),
                      kernels.ptr(rhov), n, m, n // banks, int(per_match), int(problem.rotation),
                      int(not lead)]
        delta = problem.huber_delta
        self._point_tail = [lower, delta, delta * delta]

    def run(self, counts, evaluate=False):
        """One trip of the problems not done (evaluate: the initial system
        at x), adding the counts after it into counts, a (2,) int32 buffer."""
        kernels.check(counts, "counts", torch.int32, self.device, (2,))
        dev, p, ev = self.device, self.problem, int(evaluate)
        if isinstance(p, DepthProblem):
            DEPTH_POINT.launch(dev, *self._state, *self._point, ev, self._lower)
            gr = (p.j_rep.transpose(-1, -2) @ self._rep[..., None])[..., 0].contiguous()
            DEPTH_SETTLE.launch(dev, *self._state, kernels.ptr(counts), self._kept_ptr,
                                *self._settle, kernels.ptr(gr), self._n, ev, *self._damping,
                                p.barrier_lambda, p.barrier_c)
            return
        step = None
        if not evaluate:  # smallmat.solve3's einsum on the damped cofactors
            SOLVE.launch(dev, *self._state, kernels.ptr(self._cof), kernels.ptr(self._det), self._n)
            step = torch.einsum("...ji,...j->...i", self._cof, self.state[2]).contiguous()
        POINT.launch(dev, *self._state, *self._consts, None if step is None else kernels.ptr(step),
                     kernels.ptr(self._det), *self._outs, ev, *self._point_tail)
        jac, jw, res, rhov = self._views
        # the stage's cost_and_system's sums over the matches, call for call
        H = torch.einsum("...mri,...mrj->...ij", jw, jac).reshape(-1, 3, 3).contiguous()
        g = torch.einsum("...mri,...mr->...i", jw, res).reshape(-1, 3).contiguous()
        cost = (0.5 * torch.sum(rhov, dim=-1)).reshape(-1).contiguous()
        SETTLE.launch(dev, *self._state, kernels.ptr(counts), self._kept_ptr, self._xn,
                      kernels.ptr(H), kernels.ptr(g), kernels.ptr(cost), self._n, ev,
                      *self._damping)
