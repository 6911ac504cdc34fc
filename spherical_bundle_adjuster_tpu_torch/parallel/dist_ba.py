"""Distributed multi-keyframe Schur BA and batched two-view BA over a
process mesh: spherical_bundle_adjuster_tpu/parallel/dist_ba.py on
torch.distributed.

Sharding (as the JAX package's):
  * landmarks (the L axis of the (L, P) observation table) are sharded
    over the mesh axis: rank i of W holds rows [i L / W, (i + 1) L / W);
  * poses are replicated: the camera system's sums are formed per shard
    and all-reduced (models/multiview's `group`), every rank solves the
    same camera system and back-substitutes its own landmarks.

SPMD over processes: every rank calls the same function on the whole
input and gets the whole output (the landmarks all-gathered). Every
decision read on the host (the PCG's stop test, accept / reject) comes
from all-reduced values, which gloo's and NCCL's all-reduces hand every
rank bit-identical, so the ranks never take different branches.

Batched independent problems or pairs shard the batch axis: no
collectives but the final gathers.
"""

from __future__ import annotations

import torch

from ..models import multiview as mv
from ..models import twoview
from ..solver import epipolar
from . import mesh as mesh_lib


def collective_bytes_per_gn_iter(
    C: int, linear_solver: str = "pcg", cg_iters: int = 100, dtype_bytes: int = 4
) -> int:
    """Analytic per-rank all-reduce payload of ONE GN/LM iteration of the
    sharded multiview solve (bytes entering the all-reduces, per rank;
    the JAX package's accounting, unchanged).

    pcg:   Schur setup sums S_diag (C,6,6) + coup_diag (C,6,6) +
           g_cam (C,6) + g_pairs (C,6), then one (C,6) vector per CG
           iteration — O(C) total.
    dense: setup sums plus the full (C,C,6,6) pair tensor — O(C^2).
    Both: two scalar costs per LM iteration.
    """
    setup = 2 * C * 36 + 2 * C * 6
    costs = 2
    if linear_solver == "dense":
        vol = setup + C * C * 36
    else:
        vol = setup + cg_iters * C * 6
    return (vol + costs) * dtype_bytes


def solve_multiview_sharded(
    prob: mv.MultiViewProblem,
    mesh: mesh_lib.Mesh,
    num_iters: int = 20,
    lam0: float = 1e-3,
    axis_name: str = "data",
    linear_solver: str = "auto",
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
):
    """Distributed LM/Schur solve: landmarks sharded over the mesh axis,
    poses replicated, camera-level aggregates all-reduced each iteration
    (models/multiview.solve_multiview with the axis as its group, first
    pose fixed). Every rank of the axis passes the whole problem; the
    poses are taken from the axis's first rank. Returns (the problem with
    the solved poses and every landmark, (num_iters,) costs), the same on
    every rank.

    linear_solver "dense" all-reduces the (C, C, 6, 6) pair sum once a GN
    step; "pcg" (the scalable path) one (C, 84) aggregate a GN step plus
    one (C, 6) vector a CG iteration; "auto": dense up to 32 cameras.

    The (L, P) observation table must have L divisible by the axis size
    (pad with lm_valid=False rows); else ValueError. A 1-rank axis gives
    solve_multiview's bits."""
    axis = mesh.axis(axis_name)
    L = prob.landmarks.shape[0]
    if L % axis.size:
        raise ValueError(f"{L} landmarks do not divide by the {axis_name!r} axis of "
                         f"{axis.size} ranks: pad with lm_valid=False rows")
    shard = mv.MultiViewProblem(
        mesh_lib.replicated(mesh, prob.poses, axis_name),
        *(mesh_lib.shard_leading(mesh, f, axis_name) for f in prob[1:]))
    solved, costs = mv.solve_multiview(shard, num_iters, lam0, True, linear_solver, cg_iters,
                                       cg_tol, group=axis)
    return prob._replace(poses=solved.poses, landmarks=axis.all_gather(solved.landmarks)), costs


def solve_multiview_batch_sharded(
    probs: mv.MultiViewProblem,
    mesh: mesh_lib.Mesh,
    num_iters: int = 20,
    lam0: float = 1e-3,
    pair_axis: str = "pairs",
    lm_axis: str = "data",
    linear_solver: str = "pcg",
    cg_iters: int = 100,
    cg_tol: float = 1e-5,
):
    """A batch of INDEPENDENT multiview problems on a 2-D (pairs x
    landmarks) mesh (mesh.make_mesh_2d): the leading batch axis is split
    over `pair_axis` (no collectives between the rows), each problem's
    landmark table over `lm_axis`. Each row of the mesh solves its B /
    n_pairs problems one after another (the JAX package vmaps them), each
    with solve_multiview_sharded over the row.

    `probs` is a MultiViewProblem whose every field carries a leading
    batch axis B, on every rank; B must divide by the pair axis and L by
    the landmark axis (else ValueError). Returns (the problems with the
    solved poses and landmarks, (B, num_iters) costs), gathered to every
    rank."""
    pairs = mesh.axis(pair_axis)
    B = probs.poses.shape[0]
    if B % pairs.size:
        raise ValueError(f"{B} problems do not divide by the {pair_axis!r} axis of "
                         f"{pairs.size} ranks")
    mine = mesh_lib.shard_leading(mesh, torch.arange(B), pair_axis).tolist()
    solved = [solve_multiview_sharded(mv.MultiViewProblem(*(f[b] for f in probs)), mesh,
                                      num_iters, lam0, lm_axis, linear_solver, cg_iters, cg_tol)
              for b in mine]
    poses, landmarks, costs = (pairs.all_gather(torch.stack(list(x))) for x in zip(
        *((s.poses, s.landmarks, c) for s, c in solved)))
    return probs._replace(poses=poses, landmarks=landmarks), costs


def _gather_fields(result, axis):
    """Every tensor of a (nested) NamedTuple result all-gathered along its
    leading axis, in field order."""
    return type(result)(*(_gather_fields(f, axis) if isinstance(f, tuple) else axis.all_gather(f)
                          for f in result))


def batched_two_view_sharded(im_left, im_right, generator, mesh: mesh_lib.Mesh, cfg,
                             frontend: str = "band", gumbel=None):
    """Data-parallel batched two-view BA: the batch axis of (P, H, W, 3)
    pairs split over the mesh's "data" axis, each rank running run_two_view_batch
    on its contiguous rows (K1, K2 and K3 launch in every rank), every
    field all-gathered back to (P, ...) on every rank.

    The RANSAC draws of all P pairs are made up front, as
    run_two_view_batch makes them: from `generator` (each rank passes its
    own, seeded alike), or given as gumbel (P, num_trials, max_matches).
    So a row's draws, and its result, do not depend on the number of
    ranks. P must divide by the axis size (else ValueError)."""
    axis = mesh.axis("data")
    p = im_left.shape[0]
    if p % axis.size:
        raise ValueError(f"{p} pairs do not divide by the 'data' axis of {axis.size} ranks")
    if gumbel is None:
        gumbel = epipolar.gumbel_draws(cfg.ransac.num_trials, cfg.match.max_matches,
                                       generator, im_left.device, (p,))

    def rows(x):
        return mesh_lib.shard_leading(mesh, x)

    out = twoview.run_two_view_batch(rows(im_left), rows(im_right), None, cfg, frontend,
                                     gumbel=rows(torch.as_tensor(gumbel, device=im_left.device)))
    return _gather_fields(out, axis)
