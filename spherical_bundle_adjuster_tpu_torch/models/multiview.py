"""Multi-keyframe spherical bundle adjustment with an explicit Schur
complement: spherical_bundle_adjuster_tpu/models/multiview.py.

Problem layout (as the reference's):
  * poses: (C, 6) angle-axis r and translation t per keyframe; camera i
    maps a world point X to p_i = R(r_i) X - t_i;
  * landmarks: (L, 3) world points;
  * observations, landmark-major (L, P): obs_cam (L, P) int, obs_bearing
    (L, P, 3) unit bearings, obs_valid (L, P) bool; lm_valid (L,) bool.

Residual per observation: res = b_obs - p (|p|^2 + 1e-18)^(-1/2).

Gauss-Newton with the per-landmark 3x3 blocks marginalized in one batched
pass; the reduced camera system is solved either

  * "dense": the (L, P, P, 6, 6) camera-pair blocks summed into
    (6C, 6C), then Cholesky (`smallmat.solve_psd`), to a few dozen
    cameras; or
  * "pcg": matrix-free block-Jacobi PCG (solver/pcg) whose matvec is
    gather -> per-landmark 3x3 product -> segment sum, O(L P) per
    application, for 100-1000+ cameras.

The Jacobians are closed forms of the reference's `jax.jacfwd`: with
s = (|p|^2 + 1e-18)^(-1/2), d pred / d p = s I - s^3 p p^T; dp/dX = R,
dp/dt = -I, dp/dr = -R [X]x J_r(r) (`core/rotation.rotation_jacobian`).

Every segment sum goes through `ops/segment` with orders built once per
solve (`ObsIndex`), so a solve gives the same bits on every run on one
device. The camera-level aggregates are reduced in one place,
`_camera_sums`.

Sharded (parallel/dist_ba): each rank holds a block of the landmark rows
and all the poses, and passes `group`, its landmark axis
(parallel/mesh.Axis), where the JAX package passes `axis_name`: the
camera-level sums are all-reduced over it (one (C, 84) tensor a GN step,
the dense pair sum, one (C, 6) vector a CG iteration, the cost), so every
rank solves the same camera system. `group=None` reduces nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import rotation, smallmat
from ..ops import segment
from ..solver import pcg as pcg_mod


class MultiViewProblem(NamedTuple):
    poses: torch.Tensor        # (C, 6) [angle-axis | translation]
    landmarks: torch.Tensor    # (L, 3)
    obs_cam: torch.Tensor      # (L, P) int
    obs_bearing: torch.Tensor  # (L, P, 3) unit bearings in the camera frame
    obs_valid: torch.Tensor    # (L, P) bool
    lm_valid: torch.Tensor     # (L,) bool


def problem_from_numpy(fields, device=None) -> MultiViewProblem:
    """A MultiViewProblem from the reference's fields as numpy arrays (in
    field order, e.g. [np.asarray(f) for f in reference_problem]), on
    `device` (default: the card)."""
    dev = torch.device("cuda" if device is None else device)
    return MultiViewProblem(*(torch.as_tensor(np.array(f), device=dev) for f in fields))


class ObsIndex(NamedTuple):
    """Segment-sum orders of one solve: observations by camera, and (dense
    solver only) observation pairs by camera pair."""

    cam: segment.Segments
    pair: segment.Segments | None


def obs_index(prob: MultiViewProblem, linear_solver: str) -> ObsIndex:
    """The segment-sum orders of a solve of `prob` with `linear_solver`
    (the pair order for "dense" only). Observations without weight
    (`_weights`) are dropped from every sum: their rows are exact zeros,
    and in a problem from models/tracks most slots are empty and name
    camera 0, which would make one segment hold them all."""
    C = prob.poses.shape[0]
    w = _weights(prob) > 0
    cam = torch.where(w, prob.obs_cam.long(), -1)
    pair = None
    if linear_solver == "dense":
        ids = torch.where(w[:, :, None] & w[:, None, :],
                          cam[:, :, None] * C + cam[:, None, :], -1)
        pair = segment.segments(ids, C * C)
    return ObsIndex(segment.segments(cam, C), pair)


def transform_point(pose, X):
    """p = R(aa) X - t for pose = [aa | t]."""
    return rotation.rotate_angle_axis(pose[..., :3], X) - pose[..., 3:]


def obs_residual(pose, X, b_obs):
    """Chordal bearing residual of one observation. The normalization is
    p * rsqrt(|p|^2 + eps), not p / max(|p|, eps): invalid slots sit at
    p = 0 exactly, where the latter's derivative is NaN."""
    p = transform_point(pose, X)
    n2 = torch.sum(p * p, dim=-1, keepdim=True)
    return b_obs - p * torch.rsqrt(n2 + 1e-18)


def _weights(prob):
    return (prob.obs_valid & prob.lm_valid[:, None]).to(prob.poses.dtype)


def _all_reduce(x, group):
    return x if group is None else group.all_reduce(x)


def total_cost(prob: MultiViewProblem, group=None):
    poses = prob.poses[prob.obs_cam]
    res = obs_residual(poses, prob.landmarks[:, None, :].expand(prob.obs_bearing.shape),
                       prob.obs_bearing)
    return _all_reduce(0.5 * torch.sum(_weights(prob)[..., None] * res * res), group)


def _per_landmark_system(prob: MultiViewProblem):
    """res (L, P, 3), Jc (L, P, 3, 6), Jl (L, P, 3, 3), w (L, P)."""
    poses = prob.poses[prob.obs_cam]                       # (L, P, 6)
    aa = poses[..., :3]
    X = prob.landmarks[:, None, :].expand(aa.shape)
    p = rotation.rotate_angle_axis(aa, X) - poses[..., 3:]
    s = torch.rsqrt(torch.sum(p * p, dim=-1) + 1e-18)[..., None, None]
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    dpred = s * eye - s ** 3 * (p[..., :, None] * p[..., None, :])  # d pred / d p
    res = prob.obs_bearing - p * s[..., 0]
    # d res/d r = -dpred (dp/dr) with dp/dr = -(R [X]x J_r) = -rotation_jacobian
    J_rot = dpred @ rotation.rotation_jacobian(aa.reshape(-1, 3), X.reshape(-1, 1, 3)).reshape(
        aa.shape + (3,))
    Jc = torch.cat([J_rot, dpred], dim=-1)
    Jl = -dpred @ rotation.angle_axis_to_matrix(prob.poses[:, :3])[prob.obs_cam]
    return res, Jc, Jl, _weights(prob)


class SchurParts(NamedTuple):
    """Per-landmark marginalization products shared by both camera-system
    solvers."""

    Wc: torch.Tensor         # (L, P, 6, 3) camera-landmark coupling blocks
    Hll_inv: torch.Tensor    # (L, 3, 3) damped inverted landmark blocks
    WHinv: torch.Tensor      # (L, P, 6, 3) Wc @ Hll_inv
    gl: torch.Tensor         # (L, 3) landmark gradients
    S_diag: torch.Tensor     # (C, 6, 6) summed per-observation Hcc blocks
    g: torch.Tensor          # (C, 6) reduced gradient g_cam - W Hll_inv gl
    coup_diag: torch.Tensor  # (C, 6, 6) p == q coupling (S's block diagonal part)


def _camera_sums(index: ObsIndex, Hcc_diag, gc_obs, g_pair_obs, coup_obs, group=None):
    """Every camera-level aggregate of `_schur_parts`, in one segment sum
    over the observations and one all-reduce over `group`: S_diag, g_cam,
    g_pairs, coup_diag."""
    n = gc_obs.shape[0] * gc_obs.shape[1]
    stacked = torch.cat([Hcc_diag.reshape(n, 36), gc_obs.reshape(n, 6),
                         g_pair_obs.reshape(n, 6), coup_obs.reshape(n, 36)], dim=1)
    sums = _all_reduce(segment.segment_sum(stacked, index.cam), group)
    C = sums.shape[0]
    return (sums[:, :36].reshape(C, 6, 6), sums[:, 36:42], sums[:, 42:48],
            sums[:, 48:].reshape(C, 6, 6))


def _schur_parts(prob: MultiViewProblem, lam, index: ObsIndex, group=None) -> SchurParts:
    """Marginalize the landmark blocks and reduce the camera aggregates
    (sharded: the landmark fields are this rank's, the camera aggregates
    all-reduced)."""
    res, Jc, Jl, w = _per_landmark_system(prob)
    Jcw = Jc * w[..., None, None]
    Jlw = Jl * w[..., None, None]
    Hll = torch.einsum("lpri,lprj->lij", Jlw, Jl)
    gl = torch.einsum("lpri,lpr->li", Jlw, res)
    Wc = torch.einsum("lpri,lprj->lpij", Jcw, Jl)
    Hcc_diag = torch.einsum("lpri,lprj->lpij", Jcw, Jc)
    gc_obs = torch.einsum("lpri,lpr->lpi", Jcw, res)

    eye = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    damp = torch.clamp(torch.diagonal(Hll, dim1=-2, dim2=-1).amax(-1), min=1e-8)
    Hll_inv = smallmat.inv3(Hll + lam * eye * damp[:, None, None] + 1e-9 * eye)
    Hll_inv = torch.where(prob.lm_valid[:, None, None], Hll_inv, 0.0)

    WHinv = torch.einsum("lpij,ljk->lpik", Wc, Hll_inv)
    S_diag, g_cam, g_pairs, coup_diag = _camera_sums(
        index, Hcc_diag, gc_obs, torch.einsum("lpik,lk->lpi", WHinv, gl),
        torch.einsum("lpik,lpjk->lpij", WHinv, Wc), group)
    return SchurParts(Wc=Wc, Hll_inv=Hll_inv, WHinv=WHinv, gl=gl, S_diag=S_diag,
                      g=g_cam - g_pairs, coup_diag=coup_diag)


def _camera_mask(C, fix_first_pose, like):
    mask = torch.ones((C, 6), dtype=like.dtype, device=like.device)
    if fix_first_pose:
        mask[0] = 0.0
    return mask


def _solve_cameras_dense(parts: SchurParts, prob, lam, fix_first_pose, index: ObsIndex,
                         group=None):
    """Explicit (6C, 6C) assembly + Cholesky. The (L, P, P, 6, 6) pair
    tensor lives only in this path; its (C, C, 6, 6) camera-pair sum is
    all-reduced before the diagonal part is added."""
    C = prob.poses.shape[0]
    pair = torch.einsum("lpik,lqjk->lpqij", parts.WHinv, parts.Wc)
    S = -_all_reduce(segment.segment_sum(pair.reshape(-1, 6, 6), index.pair),
                     group).reshape(C, C, 6, 6)
    ar = torch.arange(C, device=S.device)
    S[ar, ar] = S[ar, ar] + parts.S_diag
    S = S.transpose(1, 2).reshape(C * 6, C * 6)
    g = parts.g.reshape(C * 6)

    S = S + torch.diag(lam * torch.clamp(torch.diagonal(S), min=1e-8))
    mask = _camera_mask(C, fix_first_pose, S).reshape(-1)
    S = S * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    S = S + 1e-9 * torch.eye(C * 6, dtype=S.dtype, device=S.device)
    return -smallmat.solve_psd(S, g * mask).reshape(C, 6)


def _solve_cameras_pcg(parts: SchurParts, prob, lam, fix_first_pose, cg_iters, cg_tol,
                       index: ObsIndex, group=None):
    """Matrix-free block-Jacobi PCG on the reduced camera system: S @ x as
    gather -> 3x3 product -> segment sum (O(L P) work, nothing O(C^2)).
    Sharded, the matvec all-reduces its segment sum, one (C, 6) vector a
    CG iteration; every other CG quantity derives from all-reduced values,
    so every rank reads the same stop test."""
    C = prob.poses.shape[0]
    node_mask = _camera_mask(C, fix_first_pose, parts.g)
    # the exact block diagonal of S (diagonal part minus p == q coupling);
    # the p != q same-camera couplings are left out of the preconditioner
    # and the damping, as in the reference
    D = parts.S_diag - parts.coup_diag
    dvec = lam * torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1), min=1e-8)

    def matvec(x_flat):
        x = x_flat.reshape(C, 6) * node_mask
        y1 = torch.einsum("cij,cj->ci", parts.S_diag, x)
        u = torch.einsum("lpij,lpi->lj", parts.Wc, x[prob.obs_cam])
        v = torch.einsum("lij,lj->li", parts.Hll_inv, u)
        z = torch.einsum("lpij,lj->lpi", parts.Wc, v)
        y2 = _all_reduce(segment.segment_sum(z.reshape(-1, 6), index.cam), group)
        # y1 comes from the replicated S_diag: it stays outside the
        # all-reduce, which would count it once per rank
        y = (y1 - y2 + dvec * x) * node_mask + x_flat.reshape(C, 6) * (1.0 - node_mask)
        return y.reshape(-1)

    eye = torch.eye(6, dtype=D.dtype, device=D.device)
    blocks = torch.where(node_mask[:, :1, None] > 0, D + dvec[..., None] * eye, eye)
    precond = pcg_mod.block_jacobi_precond(blocks)
    b = -(parts.g * node_mask).reshape(-1)
    out = pcg_mod.pcg(matvec, b, precond, max_iters=cg_iters, tol=cg_tol)
    return out.x.reshape(C, 6) * node_mask


def gauss_newton_step(
    prob: MultiViewProblem,
    lam,
    fix_first_pose=True,
    linear_solver: str = "dense",
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
    index: ObsIndex | None = None,
    group=None,
):
    """One damped GN step with Schur elimination of the landmarks; returns
    (new_poses, new_landmarks). `index` is the solve's ObsIndex (built
    here when not given); `group` the landmark axis of a sharded solve."""
    if index is None:
        index = obs_index(prob, linear_solver)
    parts = _schur_parts(prob, lam, index, group)
    if linear_solver == "dense":
        dc = _solve_cameras_dense(parts, prob, lam, fix_first_pose, index, group)
    else:
        dc = _solve_cameras_pcg(parts, prob, lam, fix_first_pose, cg_iters, cg_tol, index,
                                group)
    # back-substitute: dl = -Hll_inv (gl + sum_p Wc_p^T dc_{cam_p})
    rhs = parts.gl + torch.einsum("lpij,lpi->lj", parts.Wc, dc[prob.obs_cam])
    dl = -torch.einsum("lij,lj->li", parts.Hll_inv, rhs)
    new_landmarks = torch.where(prob.lm_valid[:, None], prob.landmarks + dl, prob.landmarks)
    return prob.poses + dc, new_landmarks


def solve_multiview(
    prob: MultiViewProblem,
    num_iters: int = 20,
    lam0: float = 1e-3,
    fix_first_pose: bool = True,
    linear_solver: str = "auto",
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
    group=None,
):
    """LM loop (accept / reject) over Schur GN steps; returns (solved
    problem, (num_iters,) cost trace).

    linear_solver: "dense", "pcg" or "auto" (dense up to 32 cameras).
    The loop has a fixed length and decides on the device (`torch.where`),
    so it makes no host sync of its own; the PCG reads its stop test every
    `pcg.CHECK_EVERY` iterations. A step that does not lower the cost (a
    NaN step included) is rejected.

    group: the landmark axis of a sharded solve (parallel/dist_ba): prob
    holds this rank's landmark rows, the costs and camera sums are
    all-reduced over it, and accept / reject reads only all-reduced costs,
    so every rank takes the same steps."""
    if linear_solver == "auto":
        linear_solver = "dense" if prob.poses.shape[0] <= 32 else "pcg"
    index = obs_index(prob, linear_solver)
    poses, landmarks = prob.poses, prob.landmarks
    lam = torch.tensor(lam0, dtype=poses.dtype, device=poses.device)
    cost0 = total_cost(prob, group)
    costs = []
    for _ in range(num_iters):
        p = prob._replace(poses=poses, landmarks=landmarks)
        new_poses, new_landmarks = gauss_newton_step(
            p, lam, fix_first_pose, linear_solver, cg_iters, cg_tol, index, group)
        cost1 = total_cost(prob._replace(poses=new_poses, landmarks=new_landmarks), group)
        accept = cost1 < cost0
        costs.append(torch.minimum(cost0, cost1))
        poses = torch.where(accept, new_poses, poses)
        landmarks = torch.where(accept, new_landmarks, landmarks)
        cost0 = torch.where(accept, cost1, cost0)  # total_cost of the kept point
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e8)
    return prob._replace(poses=poses, landmarks=landmarks), torch.stack(costs)
