"""Rank workers of the port's multi-process CPU tests
(tests/test_torch_mesh.py, tests/test_torch_dist_ba.py,
tests/test_torch_sequence.py, tests/test_torch_checkpoint.py).

parallel/launch.run_ranks spawns every rank afresh, and the rank imports
this module to find its worker, so it imports neither jax nor the JAX
package nor any test module (which would). Each worker takes numpy
inputs, runs on the CPU and returns CPU tensors and plain values.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

from spherical_bundle_adjuster_tpu_torch.models import multiview as mv
from spherical_bundle_adjuster_tpu_torch.models import sequence
from spherical_bundle_adjuster_tpu_torch.parallel import dist_ba, mesh
from spherical_bundle_adjuster_tpu_torch.utils import checkpoint

# every process group's timeout: a rank left waiting fails in a minute
TIMEOUT = timedelta(seconds=60)


def mesh_cases(rank, world):
    """The meshes of tests/test_torch_mesh.py over `world` = 4 ranks: for
    each, its shape, rank grid and this rank's coordinates, and the sum of
    the global ranks over each of this rank's axes; shard_leading and
    replicated on rank-dependent inputs; an oversized 2-D mesh."""
    out = {}
    meshes = {"1d": mesh.make_mesh(timeout=TIMEOUT),
              "1d_first2": mesh.make_mesh(2, timeout=TIMEOUT),
              "2x2": mesh.make_mesh_2d(2, 2, timeout=TIMEOUT),
              "2x_inferred": mesh.make_mesh_2d(2, timeout=TIMEOUT)}
    for name, m in meshes.items():
        rec = dict(shape=m.shape, ranks=m.ranks.tolist(), coords=m.coords)
        if m.coords is not None:
            rec["rank_sums"] = {a: int(m.axis(a).all_reduce(torch.tensor([rank])).item())
                                for a in m.axis_names}
        else:
            try:
                m.axis(m.axis_names[0])
            except ValueError as e:
                rec["outside"] = str(e)
        out[name] = rec
    m = meshes["1d"]
    x = torch.arange(8 * 3).reshape(8, 3) + 100 * rank  # differs on every rank
    out["shard"] = mesh.shard_leading(m, x)
    out["replicated"] = mesh.replicated(m, x)
    try:
        mesh.shard_leading(m, x[:6])
    except ValueError as e:
        out["indivisible"] = str(e)
    try:
        mesh.make_mesh_2d(world, 2, timeout=TIMEOUT)
    except AssertionError as e:
        out["too_big"] = str(e)
    out["backend"] = dist.get_backend()
    return out


def _solve(prob, m, **kw):
    solved, costs = dist_ba.solve_multiview_sharded(prob, m, **kw)
    return dict(poses=solved.poses, landmarks=solved.landmarks, costs=costs)


def _traffic_of_one_gn_step(prob, m, solver, cg_iters):
    """The all-reduce traffic ((collective, bytes a call) -> calls) of a
    one-iteration sharded solve."""
    axis = m.axis("data")
    axis.reset()
    dist_ba.solve_multiview_sharded(prob, m, num_iters=1, linear_solver=solver,
                                    cg_iters=cg_iters)
    return dict(axis.traffic)


def dist_ba_cases(rank, world, small, batch, c256, pairs):
    """tests/test_torch_dist_ba.py's sharded runs over `world` = 4 ranks.

    small: the fields of synth_problem(C=4, L=64, P=4), solved over 4, 2
    and 1 ranks, dense and PCG; over 4 ranks also with every rank but the
    first passing other poses, and with 62 landmarks (not divisible);
    its one-GN-step traffic over 2 and 4 ranks. batch: two problems'
    stacked fields on a 2x2 mesh. c256: test_c256_l8192_sharded_pcg's
    problem over 4 ranks. pairs: (lefts, rights, draws, cfg) of the
    sharded two-view batch over 2 ranks."""
    prob = mv.problem_from_numpy(small, "cpu")
    meshes = {w: mesh.make_mesh(w, timeout=TIMEOUT) for w in (4, 2, 1)}
    m2d = mesh.make_mesh_2d(2, 2, timeout=TIMEOUT)
    out = {}
    for w, m in meshes.items():
        if m.coords is None:
            continue
        for solver in ("dense", "pcg"):
            out["small", w, solver] = _solve(prob, m, num_iters=12, linear_solver=solver)
        if w > 1:
            for solver in ("dense", "pcg"):
                out["traffic", w, solver] = _traffic_of_one_gn_step(prob, m, solver, 100)
    m4 = meshes[4]
    moved = prob._replace(poses=prob.poses + 1e-3 * rank)
    out["small_moved_poses"] = _solve(moved, m4, num_iters=12, linear_solver="dense")
    try:
        dist_ba.solve_multiview_sharded(mv.MultiViewProblem(*(f[:62] if i else f for i, f in
                                                               enumerate(prob))), m4)
    except ValueError as e:
        out["indivisible"] = str(e)

    probs = mv.problem_from_numpy(batch, "cpu")
    solved, costs = dist_ba.solve_multiview_batch_sharded(probs, m2d, num_iters=12,
                                                          linear_solver="pcg", cg_iters=100)
    out["batch"] = dict(poses=solved.poses, landmarks=solved.landmarks, costs=costs,
                        coords=m2d.coords)

    big = mv.problem_from_numpy(c256, "cpu")
    out["c256"] = _solve(big, m4, num_iters=8, linear_solver="pcg", cg_iters=60, cg_tol=1e-5)

    lefts, rights, draws, cfg = pairs
    if meshes[2].coords is not None:
        out["twoview"] = dist_ba.batched_two_view_sharded(
            torch.from_numpy(lefts), torch.from_numpy(rights), None, meshes[2], cfg,
            gumbel=torch.from_numpy(draws))
    return out


def sequence_case(rank, world, frames, cfg, gumbel, closure_gumbel, kw, timeout_s):
    """run_sequence over a `world`-rank mesh (process-group timeout
    timeout_s), every rank on the same frames and draws (numpy); returns
    its SequenceResult and the mesh axis's traffic."""
    m = mesh.make_mesh(world, timeout=timedelta(seconds=timeout_s))
    out = sequence.run_sequence(torch.from_numpy(frames), None, cfg, mesh=m,
                                gumbel=torch.from_numpy(gumbel),
                                closure_gumbel=torch.from_numpy(closure_gumbel), **kw)
    return out, dict(m.axis("data").traffic)


def checkpoint_cases(rank, world, fields, path):
    """tests/test_torch_checkpoint.py's resumable solve over a `world`-rank
    mesh: 2 of 4 rounds into `path` (the interruption), then the rest
    from the checkpoint. Returns the solved poses, landmarks and both
    calls' costs, and the steps this rank wrote."""
    m = mesh.make_mesh(timeout=TIMEOUT)
    writes = []
    save = checkpoint.save_checkpoint

    def counted_save(p, tree, step=None):
        writes.append(step)
        return save(p, tree, step)

    checkpoint.save_checkpoint = counted_save
    try:
        prob = mv.problem_from_numpy(fields, "cpu")
        _, first = checkpoint.solve_multiview_resumable(prob, path, total_iters=4,
                                                        iters_per_round=2, mesh=m)
        solved, rest = checkpoint.solve_multiview_resumable(prob, path, total_iters=8,
                                                            iters_per_round=2, mesh=m)
    finally:
        checkpoint.save_checkpoint = save
    return dict(poses=solved.poses, landmarks=solved.landmarks, costs=torch.cat([first, rest]),
                writes=writes)
