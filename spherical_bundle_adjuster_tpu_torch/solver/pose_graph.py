"""Pose-graph optimization over relative-pose constraints (loop closure):
spherical_bundle_adjuster_tpu/solver/pose_graph.py.

Nodes are keyframe poses (angle-axis r, translation t; a camera maps a
world point X to R(r) X - t, the BA convention); edges are measured
relative poses. Edge (i, j) predicts R_rel = R_j R_i^T and t_rel = t_j -
R_rel t_i, and its residual is [log(R_ij^T R_rel), t_rel - t_ij] in R^6,
scaled per edge by its weight.

Damped Gauss-Newton over per-edge 6x6 Jacobian blocks. The reference
takes them by `jax.jacfwd` through its log map; here they are closed
forms (`_edge_jacobians`, through the right Jacobian of SO(3) and its
inverse), finite at R_err = I where a consistent graph sits. The normal
equations are either assembled densely by segment sums and
Cholesky-solved, or solved matrix-free by block-Jacobi PCG whose H @ x
is two gathers and two segment sums.
Segment sums run through `ops/segment` with orders built once per solve,
so a solve gives the same bits on every run on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import rotation, smallmat
from ..ops import segment
from . import pcg as pcg_mod


class PoseGraph(NamedTuple):
    poses: torch.Tensor        # (N, 6) [angle-axis | translation]
    edge_i: torch.Tensor       # (E,) int source node
    edge_j: torch.Tensor       # (E,) int target node
    edge_rot: torch.Tensor     # (E, 3) measured relative rotation (angle-axis)
    edge_tran: torch.Tensor    # (E, 3) measured relative translation
    edge_weight: torch.Tensor  # (E,) confidence (0 disables an edge slot)


def graph_from_numpy(fields, device=None) -> PoseGraph:
    """A PoseGraph from the reference's fields as numpy arrays (in field
    order, e.g. [np.asarray(f) for f in reference_graph]), on `device`
    (default: the card)."""
    dev = torch.device("cuda" if device is None else device)
    return PoseGraph(*(torch.as_tensor(np.array(f), device=dev) for f in fields))


def relative_pose(pose_i, pose_j):
    """Predicted relative pose of edge (i, j): R_rel = R_j R_i^T,
    t_rel = t_j - R_rel t_i."""
    Ri = rotation.angle_axis_to_matrix(pose_i[..., :3])
    Rj = rotation.angle_axis_to_matrix(pose_j[..., :3])
    R_rel = Rj @ Ri.transpose(-1, -2)
    t_rel = pose_j[..., 3:] - torch.einsum("...ij,...j->...i", R_rel, pose_i[..., 3:])
    return R_rel, t_rel


def edge_residual(pose_i, pose_j, meas_rot_aa, meas_tran):
    """6-residual per edge: SO(3) log of the rotation error and the
    translation gap."""
    R_rel, t_rel = relative_pose(pose_i, pose_j)
    R_err = rotation.angle_axis_to_matrix(meas_rot_aa).transpose(-1, -2) @ R_rel
    return torch.cat([rotation.matrix_to_angle_axis(R_err), t_rel - meas_tran], dim=-1)


def graph_residuals(poses_flat, g: PoseGraph):
    poses = poses_flat.reshape(-1, 6)
    res = edge_residual(poses[g.edge_i], poses[g.edge_j], g.edge_rot, g.edge_tran)
    return res * g.edge_weight[:, None]


def total_cost(g: PoseGraph):
    res = graph_residuals(g.poses.reshape(-1), g)
    return 0.5 * torch.sum(res * res)


def _edge_jacobians(pose_i, pose_j, meas_rot_aa):
    """d res / d pose_i and d res / d pose_j (E, 6, 6) of edge_residual,
    in closed form. With phi = log(R_err), R_err = R_m^T R_j R_i^T and the
    right Jacobians J_i = J_r(r_i), J_j = J_r(r_j):

      d phi / d r_j = J_r^-1(phi) R_i J_j,  d phi / d r_i = -J_r^-1(phi) R_i J_i,
      d t_rel / d r_j = R_j [R_i^T t_i]x J_j,  d t_rel / d r_i = -R_j [R_i^T t_i]x J_i,
      d t_rel / d t_j = I,  d t_rel / d t_i = -R_rel,  d phi / d t = 0."""
    Ri = rotation.angle_axis_to_matrix(pose_i[..., :3])
    Rj = rotation.angle_axis_to_matrix(pose_j[..., :3])
    R_rel = Rj @ Ri.transpose(-1, -2)
    phi = rotation.matrix_to_angle_axis(
        rotation.angle_axis_to_matrix(meas_rot_aa).transpose(-1, -2) @ R_rel)
    A = rotation.right_jacobian_inverse(phi) @ Ri
    B = Rj @ rotation.skew(torch.einsum("...ji,...j->...i", Ri, pose_i[..., 3:]))
    Jr_i = rotation.right_jacobian(pose_i[..., :3])
    Jr_j = rotation.right_jacobian(pose_j[..., :3])
    zero = torch.zeros_like(A)
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    Ji = torch.cat([torch.cat([-A @ Jr_i, zero], -1), torch.cat([-B @ Jr_i, -R_rel], -1)], -2)
    Jj = torch.cat([torch.cat([A @ Jr_j, zero], -1), torch.cat([B @ Jr_j, eye], -1)], -2)
    return Ji, Jj


def _weigh(g: PoseGraph, res, jacs, robust_delta, tran_weight):
    """Row weights (tran_weight on the translation rows), then the Huber
    IRLS scale, then the edge weights, on res (E, 6) and each (E, 6, 6)
    Jacobian of `jacs`.

    Per-block weighting: on near-pure-rotation data the measured edge
    translations are noise whose residuals dwarf the rotation rows;
    tran_weight < 1 restores the rotation rows' authority (1.0 is the
    unweighted formulation). The Huber scale sqrt(rho'(|res|^2)) judges a
    measurement by its own misfit, before the edge weight: on the
    weighted residual it would saturate exactly the high-weight loop
    closures and treat the most informative edges as outliers."""
    w6 = torch.ones(6, dtype=res.dtype, device=res.device)
    w6[3:] = tran_weight
    res = res * w6
    jacs = [J * w6[:, None] for J in jacs]
    if robust_delta is not None:
        s = torch.sum(res * res, dim=-1)
        w_rob = torch.sqrt(torch.where(
            s <= robust_delta * robust_delta, 1.0,
            robust_delta / torch.sqrt(torch.clamp(s, min=1e-32))))
        res = res * w_rob[:, None]
        jacs = [J * w_rob[:, None, None] for J in jacs]
    w = g.edge_weight[:, None]
    return res * w, [J * w[..., None] for J in jacs]


def _edge_blocks(poses, g: PoseGraph, robust_delta=None, tran_weight=1.0):
    """Weighted residuals res (E, 6) and per-edge Jacobian blocks Ji, Jj
    (E, 6, 6) = d res / d pose_i, d res / d pose_j.

    robust_delta: optional Huber scale (IRLS); tran_weight: weight of the
    translation rows (`_weigh`)."""
    pi, pj = poses[g.edge_i], poses[g.edge_j]
    res = edge_residual(pi, pj, g.edge_rot, g.edge_tran)
    res, (Ji, Jj) = _weigh(g, res, _edge_jacobians(pi, pj, g.edge_rot), robust_delta,
                           tran_weight)
    return res, Ji, Jj


def _edge_cost(poses, g: PoseGraph, robust_delta, tran_weight):
    """0.5 |res|^2 of `_edge_blocks`' residuals, without the Jacobians."""
    res = edge_residual(poses[g.edge_i], poses[g.edge_j], g.edge_rot, g.edge_tran)
    res, _ = _weigh(g, res, (), robust_delta, tran_weight)
    return 0.5 * torch.sum(res * res)


class GraphIndex(NamedTuple):
    """Segment-sum orders of one solve: edges by source node and by target
    node, and (dense solver only) by node pair."""

    src: segment.Segments
    dst: segment.Segments
    pair: segment.Segments | None


def graph_index(g: PoseGraph, linear_solver: str) -> GraphIndex:
    """The segment-sum orders of a solve of `g` with `linear_solver` (the
    pair order for "dense" only)."""
    n = g.poses.shape[0]
    pair = None
    if linear_solver == "dense":
        pair = segment.segments(g.edge_i.long() * n + g.edge_j.long(), n * n)
    return GraphIndex(segment.segments(g.edge_i, n), segment.segments(g.edge_j, n), pair)


def _node_sum(index: GraphIndex, at_i, at_j):
    """(N, ...) sums of per-edge values at each edge's source and target."""
    return segment.segment_sum(at_i, index.src) + segment.segment_sum(at_j, index.dst)


def _grad_and_diag(index: GraphIndex, res, Ji, Jj):
    """Gradient (N, 6) and block diagonal of H (N, 6, 6), in one pair of
    segment sums."""
    E = res.shape[0]
    gi = torch.einsum("eri,er->ei", Ji, res)
    gj = torch.einsum("eri,er->ei", Jj, res)
    hii = torch.einsum("eri,erj->eij", Ji, Ji)
    hjj = torch.einsum("eri,erj->eij", Jj, Jj)
    sums = _node_sum(index, torch.cat([gi, hii.reshape(E, 36)], 1),
                     torch.cat([gj, hjj.reshape(E, 36)], 1))
    return sums[:, :6], sums[:, 6:].reshape(-1, 6, 6)


def _node_mask(n, fix_first_pose, like):
    mask = torch.ones((n, 6), dtype=like.dtype, device=like.device)
    if fix_first_pose:
        mask[0] = 0.0
    return mask


def _gn_step_dense(index: GraphIndex, res, Ji, Jj, lam, fix_first_pose, n):
    """Exact dense solve of the damped normal equations, assembled from
    the per-edge blocks by segment sums (O(E + N^2) memory)."""
    grad, Hdiag = _grad_and_diag(index, res, Ji, Jj)
    hij = torch.einsum("eri,erj->eij", Ji, Jj)
    Hoff = segment.segment_sum(hij, index.pair).reshape(n, n, 6, 6)
    H = Hoff + Hoff.transpose(-1, -2).transpose(0, 1)
    ar = torch.arange(n, device=H.device)
    H[ar, ar] = H[ar, ar] + Hdiag
    H = H.transpose(1, 2).reshape(n * 6, n * 6)
    H = H + torch.diag(lam * torch.clamp(torch.diagonal(H), min=1e-8))
    mask = _node_mask(n, fix_first_pose, H).reshape(-1)
    H = H * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    H = H + 1e-9 * torch.eye(n * 6, dtype=H.dtype, device=H.device)
    return -smallmat.solve_psd(H, grad.reshape(-1) * mask).reshape(n, 6)


def _gn_step_pcg(g: PoseGraph, index: GraphIndex, res, Ji, Jj, lam, fix_first_pose, n,
                 cg_iters, cg_tol):
    """Matrix-free damped GN step: H @ x as two gathers and two segment
    sums per CG application; block-Jacobi preconditioner from the (N, 6, 6)
    diagonal. Nothing O(N^2) is materialized."""
    grad, Hdiag = _grad_and_diag(index, res, Ji, Jj)
    dvec = lam * torch.clamp(torch.diagonal(Hdiag, dim1=-2, dim2=-1), min=1e-8)
    node_mask = _node_mask(n, fix_first_pose, grad)

    def matvec(x_flat):
        x = x_flat.reshape(n, 6) * node_mask
        t = (torch.einsum("erk,ek->er", Ji, x[g.edge_i])
             + torch.einsum("erk,ek->er", Jj, x[g.edge_j]))
        y = _node_sum(index, torch.einsum("eri,er->ei", Ji, t), torch.einsum("eri,er->ei", Jj, t))
        y = (y + dvec * x) * node_mask
        # gauge: identity on the fixed pose keeps the system SPD
        return (y + x_flat.reshape(n, 6) * (1.0 - node_mask)).reshape(-1)

    eye = torch.eye(6, dtype=Hdiag.dtype, device=Hdiag.device)
    blocks = torch.where(node_mask[:, :1, None] > 0, Hdiag + dvec[..., None] * eye, eye)
    precond = pcg_mod.block_jacobi_precond(blocks)
    b = -(grad * node_mask).reshape(-1)
    out = pcg_mod.pcg(matvec, b, precond, max_iters=cg_iters, tol=cg_tol)
    return out.x.reshape(n, 6) * node_mask


def optimize_pose_graph(
    g: PoseGraph,
    num_iters: int = 25,
    lam0: float = 1e-3,
    fix_first_pose: bool = True,
    linear_solver: str = "auto",
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
    robust_delta=None,
    tran_weight: float = 1.0,
):
    """Damped GN over all poses; returns (optimized graph, (num_iters,)
    cost trace).

    linear_solver: "dense", "pcg" or "auto" (dense up to 64 nodes). The
    LM loop has a fixed length and decides on the device, so it makes no
    host sync of its own."""
    n = g.poses.shape[0]
    if linear_solver == "auto":
        linear_solver = "dense" if n <= 64 else "pcg"
    index = graph_index(g, linear_solver)
    poses = g.poses
    lam = torch.tensor(lam0, dtype=poses.dtype, device=poses.device)
    costs = []
    for _ in range(num_iters):
        res, Ji, Jj = _edge_blocks(poses, g, robust_delta, tran_weight)
        cost0 = 0.5 * torch.sum(res * res)
        if linear_solver == "dense":
            dp = _gn_step_dense(index, res, Ji, Jj, lam, fix_first_pose, n)
        else:
            dp = _gn_step_pcg(g, index, res, Ji, Jj, lam, fix_first_pose, n, cg_iters, cg_tol)
        new_poses = poses + dp
        cost1 = _edge_cost(new_poses, g, robust_delta, tran_weight)
        accept = cost1 < cost0
        costs.append(torch.minimum(cost0, cost1))
        poses = torch.where(accept, new_poses, poses)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e8)
    return g._replace(poses=poses), torch.stack(costs)


def chain_with_loop_closures(
    odometry_rot, odometry_tran, closures=(), closure_weight=1.0,
    odometry_weights=None, closure_weights=None,
):
    """A PoseGraph of sequential odometry edges (i -> i+1) plus (i, j,
    rot_aa, tran) loop-closure tuples, with poses initialized by chaining
    the odometry, on the odometry's device: a tensor's own, the card for
    anything else (numpy odometry becomes float32, as in the reference).

    odometry_weights: optional (N-1,) per-edge information weights
    (default 1.0 each); closure_weights: optional per-closure weights,
    multiplied by closure_weight (default 1.0 each). Weights and each
    closure's rot_aa and tran may be numpy, numbers or tensors on any
    device (a batch's `num_matches`, `run_two_view`'s outputs on the
    card): they move to the graph's device without a host read."""
    if not isinstance(odometry_rot, torch.Tensor):
        odometry_rot = torch.as_tensor(np.asarray(odometry_rot, np.float32), device="cuda")
    odometry_tran = torch.as_tensor(odometry_tran, dtype=odometry_rot.dtype,
                                    device=odometry_rot.device)
    dt, dev = odometry_rot.dtype, odometry_rot.device
    n = odometry_rot.shape[0] + 1
    # p_{k+1} = R_k p_k - t_k => R_{k+1} = R_k R_prev: chain the rotation
    # matrices (composing angle-axis directly is lossy)
    Rk_all = rotation.angle_axis_to_matrix(odometry_rot)
    R, t = torch.eye(3, dtype=dt, device=dev), torch.zeros(3, dtype=dt, device=dev)
    Rs, ts = [], []
    for Rk, tk in zip(Rk_all, odometry_tran):
        R, t = Rk @ R, tk + Rk @ t
        Rs.append(R)
        ts.append(t)
    aa = rotation.matrix_to_angle_axis(torch.stack(Rs))
    poses = torch.cat([torch.zeros((1, 6), dtype=dt, device=dev),
                       torch.cat([aa, torch.stack(ts)], -1)])

    if odometry_weights is not None:
        ow = torch.as_tensor(odometry_weights, dtype=torch.float32, device=dev)
        if ow.shape != (n - 1,):
            raise ValueError(f"odometry_weights of shape {tuple(ow.shape)}, expected {(n - 1,)}")
    else:
        ow = torch.ones(n - 1, dtype=torch.float32, device=dev)
    ci, cj, cr, ct, cw = [], [], [], [], []
    for idx, (i, j, raa, tr) in enumerate(closures):
        ci.append(i)
        cj.append(j)
        cr.append(torch.as_tensor(raa, dtype=dt, device=dev))
        ct.append(torch.as_tensor(tr, dtype=dt, device=dev))
        # the reference multiplies in float64 and rounds once to float32
        w = 1.0 if closure_weights is None else closure_weights[idx]
        cw.append(closure_weight * torch.as_tensor(w, dtype=torch.float64, device=dev))
    ar = list(range(n - 1))
    return PoseGraph(
        poses=poses,
        edge_i=torch.tensor(ar + ci, dtype=torch.int32, device=dev),
        edge_j=torch.tensor([k + 1 for k in ar] + cj, dtype=torch.int32, device=dev),
        edge_rot=torch.cat([odometry_rot, *(r[None] for r in cr)]),
        edge_tran=torch.cat([odometry_tran, *(x[None] for x in ct)]),
        edge_weight=torch.cat([ow, *(w.reshape(1).float() for w in cw)]),
    )
