"""Levenberg-Marquardt engine for the spherical BA stages:
spherical_bundle_adjuster_tpu/solver/lm.py.

  * residual (all stages): with X1 = d1*b1, X2 = d2*b2,
      res = X2 - (AngleAxis(r) @ X1 - t)    (3-vector per match)
  * d-stage: an independent 2-parameter problem per match with two
    barrier residuals lambda*exp(-c*d_i) and the bound d >= 0, solved as
    one batch of 2x2 LM problems; closed-form Jacobians (the residual is
    linear in each depth).
  * rot / tran stages: 3 global parameters, Huber IRLS, closed-form
    Jacobians (d res / d t = I; d res / d r = R [x1]x J_r(r), the right
    Jacobian of SO(3)).
  * joint mode (`solve_joint_schur`): (r, t, all d) Gauss-Newton with the
    per-match 2x2 depth blocks marginalized into a 6x6 camera system, the
    same closed-form Jacobians and the d-stage's barrier.

Every stage takes optional leading axes, a pair axis and then a start
axis: r, t (P, S, 3), depths (P, S, M, 2) and match masks (P, S, M)
against bearing banks that broadcast to them ((P, 1, M, 3): each pair's
bank, shared by its starts), so the P pairs of a batch and the S starts
of multi-start refinement run as one batch (the reference vmapped them).
The depth stage then solves P*S*M 2x2 problems and the rotation and
translation stages P*S 3-parameter problems, in one `lm_fixed` call
each; without leading axes, a stage is the single-pair, single-start
one.

`lm_fixed` runs a batch of independent problems. Each element stops at
its own convergence or damping cap and keeps its state frozen from then
on (what the reference's vmapped while_loop does); the loop ends when no
element is active, at the cost of one host sync per iteration, and counts
its trips in utils/profiling.COUNTS under the stage that runs it. The loop
is host-driven, so it keeps the system of each accepted trial point
instead of rebuilding it at the top of the next iteration (the reference
re-evaluates it; the values are the same). On the CPU each trip is one
small op after another (`_trip`); on the card each stage's trip, and its
initial system, runs as hand-written CUDA kernels (ops/cuda_lm,
csrc/lm_trip.cu) around the trip's own aten products and sums, bit for
bit the trip op by op.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import NamedTuple

import torch

from ..core import rotation, smallmat
from ..ops import cuda_lm
from ..utils import profiling
from ..utils.config import BaConfig

_COUNTING = ("other", None)  # (stage, kept): what lm_fixed counts its trips under
_PROBLEM = None  # the stage's problem for the trip kernels (ops/cuda_lm), or None


@contextmanager
def _counting(stage, kept=None, problem=None):
    """lm_fixed's loop trips inside count under lm.<stage>; `kept` (N,)
    marks the problems whose result the stage keeps (None: every one);
    `problem` (a cuda_lm DepthProblem or GlobalProblem) describes them to
    the trip kernels, which run the loop on CUDA float32 tensors. A
    context and not arguments of lm_fixed, whose signature
    benchmark/tests/test_bench_faults.py stubs."""
    global _COUNTING, _PROBLEM
    outer, _COUNTING, _PROBLEM = (_COUNTING, _PROBLEM), (stage, kept), problem
    try:
        yield
    finally:
        _COUNTING, _PROBLEM = outer


def reprojection_residual(b1, b2, d1, d2, r, t):
    """(..., 3) residual X2 - (R(r) @ (d1*b1) - t); r is angle-axis."""
    x1 = b1 * d1[..., None]
    x2 = b2 * d2[..., None]
    x1r = rotation.rotate_angle_axis(r.expand(x1.shape), x1)
    return x2 - (x1r - t)


def huber_weight(res_block, delta):
    """IRLS weight per residual block: rho'(s), s = |res|^2, Huber(delta)."""
    s = torch.sum(res_block * res_block, dim=-1)
    return torch.where(
        s <= delta * delta, 1.0, delta / torch.sqrt(torch.clamp(s, min=1e-32))
    )


def huber_cost(res_block, delta, w_valid):
    s = torch.sum(res_block * res_block, dim=-1)
    rho = torch.where(
        s <= delta * delta, s,
        2.0 * delta * torch.sqrt(torch.clamp(s, min=1e-32)) - delta * delta,
    )
    return 0.5 * torch.sum(rho * w_valid, dim=-1)


class StageReport(NamedTuple):
    """Per-stage convergence telemetry (the Ceres BriefReport the
    reference prints): iterations run, initial cost, final cost."""

    iterations: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


def lm_fixed(cost_and_system, x0, cfg: BaConfig, max_iters=None, lower_bound=None):
    """Damped LM on a batch of small independent problems.

    x0: (N, n). cost_and_system(x) -> (cost (N,), H (N, n, n), g (N, n)) of
    the robustified problem. Each element runs accept/reject steps up to
    `max_iters`, stopping on Ceres' function_tolerance criterion
    |cost - cost_new| <= ftol * cost or when the damping saturates.
    Returns (x (N, n), StageReport with (N,) fields).

    Each trip of the loop reads on the host how many elements are still
    active, and how many of those the stage keeps (_counting), in its one
    host sync, and adds to profiling.COUNTS under the stage:
    lm.<stage>.syncs 1, .active the kept ones, .slots N.

    On CUDA float32 tensors of a stage that described its problem
    (_counting), the initial system and every trip run as the stage's
    trip kernels (ops/cuda_lm.Trips: two or three launches around the
    trip's one to three aten products and sums), which update the loop's
    state in place, bit for bit as `_trip` would, and add the next read's
    counts (lm.<stage>.kernel_trips +1 a trip); cost_and_system is then
    not called. Anything else runs each trip op by op (`_trip`).
    """
    return _loop(cost_and_system, x0, cfg, max_iters, lower_bound, eager=False)


def _lm_eager(cost_and_system, x0, cfg: BaConfig, max_iters=None, lower_bound=None):
    """lm_fixed with every trip run op by op, on any device."""
    return _loop(cost_and_system, x0, cfg, max_iters, lower_bound, eager=True)


def _loop(cost_and_system, x0, cfg, max_iters, lower_bound, eager):
    iters = cfg.max_iterations if max_iters is None else max_iters
    stage, kept = _COUNTING
    problem = _PROBLEM
    on_card = not eager and problem is not None and x0.is_cuda and x0.dtype == torch.float32
    if on_card:
        # row k: the counts the host reads before trip k
        table = torch.zeros((iters + 1, 2), dtype=torch.int32, device=x0.device)
        kept = None if kept is None else kept.contiguous()
        trips = cuda_lm.start(problem, x0.contiguous(), cfg, lower_bound, kept, table[0])
        state = trips.state
        init_cost = state[3].clone()
        n_left = table[0]
    else:
        step, state = _eager_start(cost_and_system, x0, cfg, lower_bound)
        init_cost, done = state[3], state[-1]
        every = torch.ones_like(done)
        kept = torch.stack([every, every if kept is None else kept])  # (2, N)
        n_left = _active(done, kept)
    counts, slots = profiling.COUNTS, x0.shape[0]
    key = f"lm.{stage}."
    for trip in range(iters):
        n_active, n_kept = n_left.tolist()
        counts[key + "syncs"] += 1
        counts[key + "active"] += n_kept
        counts[key + "slots"] += slots
        if n_active == 0:
            break
        if on_card:
            n_left = table[trip + 1]
            trips.run(n_left)
            counts[key + "kernel_trips"] += 1
        else:
            state = step(state)
            n_left = _active(state[-1], kept)
    x, _, _, _, cost_s, _, it, _ = state
    return x, StageReport(it, init_cost, cost_s)


def _eager_start(cost_and_system, x0, cfg, lower_bound):
    """The loop run op by op from x0: its trip (`_trip` on the stage's
    problem, out of place) and its state before the first trip, (x0, H,
    g, cost, cost, lam, it, done)."""
    n = x0.shape[-1]
    small_solve = {2: smallmat.solve2, 3: smallmat.solve3}[n]
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    step = functools.partial(_trip, cost_and_system, cfg, small_solve, eye, lower_bound)
    cost, H, g = cost_and_system(x0)
    lam = torch.full_like(cost, cfg.lm_lambda_init)
    it = torch.zeros(cost.shape, dtype=torch.int32, device=x0.device)
    done = torch.zeros(cost.shape, dtype=torch.bool, device=x0.device)
    return step, (x0, H, g, cost, cost, lam, it, done)


def _active(done, kept):
    """(2,) the problems still active: every one, the ones kept."""
    return torch.sum(~done & kept, dim=-1)


def _trip(cost_and_system, cfg, small_solve, eye, lower_bound, state):
    """One trip of the loop after its host read, out of place: the damped
    solve, the clamp, the trial point's system and the accept/reject
    updates of state = (x, H, g, cost, cost_s, lam, it, done). The plain
    version of ops/cuda_lm's Trips.run."""
    x, H, g, cost, cost_s, lam, it, done = state
    active = ~done
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    damped = H + lam[:, None, None] * torch.diag_embed(diag) + 1e-12 * eye
    delta = -small_solve(damped, g)
    x_new = x + delta
    if lower_bound is not None:
        x_new = torch.clamp(x_new, min=lower_bound)
    new_cost, new_H, new_g = cost_and_system(x_new)
    accept = new_cost < cost
    lam_new = torch.where(accept, lam / cfg.lm_lambda_down, lam * cfg.lm_lambda_up)
    lam_new = torch.clamp(lam_new, 1e-12, 1e10)
    converged = accept & (cost - new_cost <= cfg.function_tolerance * torch.clamp(cost, min=1e-30))
    stuck = ~accept & (lam >= 1e6)
    upd = active & accept
    return (torch.where(upd[:, None], x_new, x),
            torch.where(upd[:, None, None], new_H, H),
            torch.where(upd[:, None], new_g, g),
            torch.where(upd, new_cost, cost),
            torch.where(active, torch.minimum(new_cost, cost), cost_s),
            torch.where(active, lam_new, lam),
            it + active.to(torch.int32),
            done | (active & (converged | stuck)))


# ---------------------------------------------------------------------------
# Stage: depths (d-only), one 2x2 problem per match


def _depth_system(b1, b2, r, t, match_valid, cfg: BaConfig):
    """solve_depths' P*S*M problems, one a (start, match) slot: their
    cost_and_system and their description for the trip kernels."""
    lam_b = cfg.barrier_lambda
    c_b = cfg.barrier_c
    lead, m = match_valid.shape[:-1], match_valid.shape[-1]
    # one 2x2 problem per (start, match): per-problem bearings and pose
    bb1 = b1.expand(lead + b1.shape[-2:]).reshape(-1, 3).contiguous()
    bb2 = b2.expand(lead + b2.shape[-2:]).reshape(-1, 3).contiguous()
    rr = r[..., None, :].expand(lead + (m, 3)).reshape(-1, 3).contiguous()
    tt = t[..., None, :].expand(lead + (m, 3)).reshape(-1, 3).contiguous()
    # The residual is linear in each depth: d rep / d (d1, d2) = [-R b1, b2],
    # a constant (N, 3, 2) block, so its share of J^T J is built once; the
    # barrier rows add a diagonal.
    j_rep = torch.stack([-rotation.rotate_angle_axis(rr, bb1), bb2], dim=-1)
    h_rep = j_rep.transpose(-1, -2) @ j_rep  # (N, 2, 2)

    def sys(d):
        rep = reprojection_residual(bb1, bb2, d[:, 0], d[:, 1], rr, tt)  # (N, 3)
        bar = lam_b * torch.exp(-c_b * d)  # (N, 2)
        j_bar = -c_b * bar  # diagonal of d bar / d d
        H = h_rep + torch.diag_embed(j_bar * j_bar)
        g = (j_rep.transpose(-1, -2) @ rep[..., None])[..., 0] + j_bar * bar
        cost = 0.5 * (torch.sum(rep * rep, dim=-1) + torch.sum(bar * bar, dim=-1))
        return cost, H, g

    return sys, cuda_lm.DepthProblem(bb1, bb2, rr, tt, j_rep, h_rep, lam_b, c_b)


@profiling.spanned("sba.lm.depth")
def solve_depths(b1, b2, d_init, r, t, match_valid, cfg: BaConfig):
    """Optimize per-match (d1, d2) with fixed (r, t).

    Residual is 5-dim: 3 reprojection + 2 barrier terms lambda*exp(-c*d_i),
    no robust loss, bound d >= 0. b1, b2: (..., M, 3), broadcasting
    against d_init (..., M, 2); r, t: (..., 3); match_valid: (..., M).
    Returns ((..., M, 2), StageReport) with, per start, iterations = max
    over valid matches and costs summed over valid matches.
    """
    sys, problem = _depth_system(b1, b2, r, t, match_valid, cfg)
    with _counting("depth", match_valid.reshape(-1), problem):  # padded and invalid slots are dropped
        d_opt, reps = lm_fixed(sys, d_init.reshape(-1, 2), cfg, lower_bound=cfg.d_lower_bound)
    d_out = torch.where(match_valid[..., None], d_opt.reshape(d_init.shape), d_init)
    w = match_valid.to(torch.float32)
    report = StageReport(
        iterations=torch.amax(torch.where(match_valid, reps.iterations.reshape(w.shape), 0), dim=-1),
        initial_cost=torch.sum(reps.initial_cost.reshape(w.shape) * w, dim=-1),
        final_cost=torch.sum(reps.final_cost.reshape(w.shape) * w, dim=-1),
    )
    return d_out, report


# ---------------------------------------------------------------------------
# Stages: rotation-only / translation-only (3 global params, Huber IRLS)


def _global_system(rotation_stage, b1, b2, d_pair, fixed, param0, match_valid, cfg: BaConfig):
    """The rotation (rotation_stage) or translation stage's problems, one a
    start: their cost_and_system over a 3-vector p (N, 3), with per-match
    Huber-weighted 3-residual blocks, and their description for the trip
    kernels. `fixed` is the pose part the stage holds, t or r; param0
    (..., 3) sets the problems' leading axes."""
    w_valid = match_valid.to(torch.float32)
    lead, m = param0.shape[:-1], match_valid.shape[-1]
    d1, d2 = _depth_columns(d_pair, match_valid)
    fixed_ = fixed[..., None, :]
    eye = None
    if rotation_stage:
        x1 = b1 * d1[..., None]

        def residual_and_jacobian(r):
            res = reprojection_residual(b1, b2, d1, d2, r[..., None, :], fixed_)
            return res, rotation.rotation_jacobian(r, x1)
    else:
        eye = torch.eye(3, dtype=b1.dtype, device=b1.device).expand(match_valid.shape + (3, 3))

        def residual_and_jacobian(t):
            return reprojection_residual(b1, b2, d1, d2, fixed_, t[..., None, :]), eye

    def sys(p):
        res, J = residual_and_jacobian(p.reshape(param0.shape))
        w_rob = huber_weight(res, cfg.huber_delta) * w_valid
        Jw = J * w_rob[..., None, None]
        H = torch.einsum("...mri,...mrj->...ij", Jw, J)
        g = torch.einsum("...mri,...mr->...i", Jw, res)
        cost = huber_cost(res, cfg.huber_delta, w_valid)
        return cost.reshape(-1), H.reshape(-1, 3, 3), g.reshape(-1, 3)

    pair = d_pair.ndim == match_valid.ndim  # reference-compat: one (d1, d2) for every match
    d = d_pair.expand(lead + ((2,) if pair else (m, 2)))
    problem = cuda_lm.GlobalProblem(
        rotation_stage, _bank(b1, lead), _bank(b2, lead),
        d.reshape((-1,) + d.shape[len(lead):]).contiguous(),
        match_valid.expand(lead + (m,)).reshape(-1, m).contiguous(),
        fixed.expand(lead + (3,)).reshape(-1, 3).contiguous(), cfg.huber_delta, lead, eye)
    return sys, problem


def _bank(b, lead):
    """A bearing bank (..., M, 3) that broadcasts against the problems'
    leading axes `lead`, as the fewest rows (B, M, 3) that problem n reads
    as row n // (N // B): the trailing leading axes it is shared along
    are left out."""
    full = b.expand(lead + b.shape[-2:])
    j = len(lead)
    while j and (full.stride(j - 1) == 0 or full.shape[j - 1] == 1):
        j -= 1
    return full[(slice(None),) * j + (0,) * (len(lead) - j)].reshape(-1, *b.shape[-2:]).contiguous()


def _global_stage(stage, sys, problem, param0, cfg: BaConfig):
    """LM over a 3-vector per start, its trips counted under `stage`."""
    with _counting(stage, problem=problem):
        x, rep = lm_fixed(sys, param0.reshape(-1, 3), cfg)
    return x.reshape(param0.shape), StageReport(*(f.reshape(param0.shape[:-1]) for f in rep))


def _depth_columns(d_pair, match_valid):
    """(d1, d2), each shaped like match_valid (..., M), from per-match
    depths (..., M, 2) or from the reference-compat pair (..., 2) that
    every match shares."""
    if d_pair.ndim == match_valid.ndim:  # reference-compat
        return (d_pair[..., 0, None].expand(match_valid.shape),
                d_pair[..., 1, None].expand(match_valid.shape))
    return d_pair[..., 0], d_pair[..., 1]


@profiling.spanned("sba.lm.rot")
def solve_rotation(b1, b2, d_pair, r0, t, match_valid, cfg: BaConfig):
    """Rotation-only stage. d_pair: the (..., 2) pair (d1, d2) used for
    EVERY residual (reference-compat quirk) or per-match depths
    (..., M, 2)."""
    sys, problem = _global_system(True, b1, b2, d_pair, t, r0, match_valid, cfg)
    return _global_stage("rot", sys, problem, r0, cfg)


@profiling.spanned("sba.lm.tran")
def solve_translation(b1, b2, d_pair, r, t0, match_valid, cfg: BaConfig):
    """Translation-only stage (same depth semantics as solve_rotation);
    the residual is linear in t with Jacobian I."""
    sys, problem = _global_system(False, b1, b2, d_pair, r, t0, match_valid, cfg)
    return _global_stage("tran", sys, problem, t0, cfg)


# ---------------------------------------------------------------------------
# Joint Schur-complement Gauss-Newton (corrected formulation)


@profiling.spanned("sba.joint_schur")
def solve_joint_schur(b1, b2, d0, r0, t0, match_valid, cfg: BaConfig, num_iters=20):
    """Joint (r, t, d) refinement by Schur elimination, `num_iters` fixed
    damped steps.

    Each step builds the per-match Jacobians in closed form (d res / d r =
    rotation_jacobian, d res / d t = I, d res / d d1 = -R b1, d res / d d2
    = b2), marginalizes each damped 2x2 depth block into the 6x6 camera
    system, solves it by Cholesky (a NaN step where it is not positive
    definite, which the cost test rejects) and back-substitutes the
    depths. The d-stage's barrier rows lambda*exp(-c*d_i) enter the depth
    blocks only: without them each low-parallax match's (d1, d2) scale
    gauge lets its depths fall to the bound.

    b1, b2: (..., M, 3), broadcasting against d0 (..., M, 2); r0, t0:
    (..., 3); match_valid: (..., M). Returns (r, t, d, costs
    (..., num_iters)): the cost after each step, of the accepted point.
    """
    w_valid = match_valid.to(torch.float32)
    lam_b = cfg.barrier_lambda
    c_b = cfg.barrier_c
    eye3 = torch.eye(3, dtype=b1.dtype, device=b1.device)
    eye2 = torch.eye(2, dtype=b1.dtype, device=b1.device)
    eye6 = torch.eye(6, dtype=b1.dtype, device=b1.device)

    def residual_all(r, t, d):
        return reprojection_residual(b1, b2, d[..., 0], d[..., 1], r[..., None, :], t[..., None, :])

    def total_cost(r, t, d):
        rep = huber_cost(residual_all(r, t, d), cfg.huber_delta, w_valid)
        bar = lam_b * torch.exp(-c_b * d)
        return rep + 0.5 * torch.sum(torch.sum(bar * bar, dim=-1) * w_valid, dim=-1)

    r, t, d = r0, t0, d0
    lam = torch.full(r0.shape[:-1], cfg.lm_lambda_init, dtype=r0.dtype, device=r0.device)
    costs = []
    for _ in range(num_iters):
        res = residual_all(r, t, d)  # (..., M, 3)
        w = (huber_weight(res, cfg.huber_delta) * w_valid)[..., None, None]
        x1 = b1 * d[..., 0, None]
        j_r = rotation.rotation_jacobian(r, x1)  # (..., M, 3, 3)
        Jc = torch.cat([j_r, eye3.expand(j_r.shape)], dim=-1)  # (..., M, 3, 6)
        rb1 = rotation.rotate_angle_axis(r[..., None, :].expand(x1.shape), b1.expand(x1.shape))
        Jd = torch.stack([-rb1, b2.expand(rb1.shape)], dim=-1)  # (..., M, 3, 2)

        Hcc = torch.einsum("...mri,...mrj->...ij", Jc * w, Jc)  # (..., 6, 6)
        Hcd = torch.einsum("...mri,...mrj->...mij", Jc * w, Jd)  # (..., M, 6, 2)
        Hdd = torch.einsum("...mri,...mrj->...mij", Jd * w, Jd)  # (..., M, 2, 2)
        gc = torch.einsum("...mri,...mr->...i", Jc * w, res)
        gd = torch.einsum("...mri,...mr->...mi", Jd * w, res)

        # barrier rows: diagonal in each depth block, no camera coupling
        rb = lam_b * torch.exp(-c_b * d) * w_valid[..., None]  # (..., M, 2)
        jb = -c_b * rb
        Hdd = Hdd + torch.diag_embed(jb * jb)
        gd = gd + jb * rb

        # damp and invert the depth blocks; Schur complement onto (r, t)
        diag = torch.diagonal(Hdd, dim1=-2, dim2=-1)
        Hdd = Hdd + torch.diag_embed(lam[..., None, None] * torch.clamp(diag, min=1e-8))
        Hdd_inv = smallmat.inv2(Hdd + 1e-9 * eye2)
        HcdHinv = torch.einsum("...mij,...mjk->...mik", Hcd, Hdd_inv)
        S = Hcc - torch.einsum("...mik,...mjk->...ij", HcdHinv, Hcd)
        rhs = gc - torch.einsum("...mik,...mk->...i", HcdHinv, gd)
        S = S + lam[..., None, None] * torch.diag_embed(torch.diagonal(S, dim1=-2, dim2=-1)) + 1e-9 * eye6
        dc = -smallmat.solve_psd(S, rhs)
        dd = -torch.einsum("...mij,...mj->...mi", Hdd_inv,
                           gd + torch.einsum("...mji,...j->...mi", Hcd, dc))

        r_new = r + dc[..., :3]
        t_new = t + dc[..., 3:]
        d_new = torch.clamp(d + dd, min=cfg.d_lower_bound)
        cost_old = total_cost(r, t, d)
        cost_new = total_cost(r_new, t_new, d_new)
        accept = cost_new < cost_old
        r = torch.where(accept[..., None], r_new, r)
        t = torch.where(accept[..., None], t_new, t)
        d = torch.where(accept[..., None, None], d_new, d)
        lam = torch.clamp(torch.where(accept, lam / cfg.lm_lambda_down, lam * cfg.lm_lambda_up),
                          1e-10, 1e8)
        # the cost of the accepted point: a rejected step may carry NaN
        costs.append(torch.where(accept, cost_new, cost_old))
    return r, t, d, torch.stack(costs, dim=-1)
