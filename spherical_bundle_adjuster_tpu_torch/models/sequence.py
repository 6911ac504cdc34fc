"""Sequence pipeline: multi-keyframe spherical SfM over an ordered list of
ERP frames, ported from spherical_bundle_adjuster_tpu/models/sequence.py.

Stages:
  1. pairwise odometry: two-view BA between consecutive frames, one
     run_two_view_batch of frames[:-1] vs frames[1:];
  2. optional loop closures: two-view BA between given (i, j) pairs, one
     run_two_view_batch of all of them, every closure with the same RANSAC
     draws (the reference runs each closure with the same key);
  3. pose graph: chain odometry + closures with sqrt-match information
     weights, damped GN (solver.pose_graph);
  4. global refinement: cross-pair merged tracks (models.tracks) into the
     multi-keyframe Schur BA (models.multiview), landmark-sharded over a
     process mesh when one is given (parallel.dist_ba).

Everything runs on the frames' device (the card for frames that are not
a tensor). The stages make the host reads of the entry points they call,
plus one read of the odometry translations for the "auto" BA rule.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..parallel import dist_ba
from ..solver import epipolar
from ..solver import pose_graph as pg
from ..utils.config import PipelineConfig
from . import multiview as mv
from . import tracks
from . import twoview

# "auto" runs the global BA when the median odometry |t| reaches this
MIN_BA_BASELINE = 0.1


class SequenceResult(NamedTuple):
    poses: torch.Tensor          # (N, 6) world->camera [angle-axis | t]
    pairwise_rot: torch.Tensor   # (N-1, 3) odometry rotations (angle-axis)
    pairwise_tran: torch.Tensor  # (N-1, 3)
    pg_costs: torch.Tensor       # pose-graph cost trace
    ba_costs: torch.Tensor       # global BA cost trace (empty if skipped)
    pg_poses: torch.Tensor       # (N, 6) poses after the pose graph, before
    # global BA (so artifacts can attribute quality per stage)


def _on_device(frames):
    """frames as a tensor: a tensor stays where it is, anything else goes
    to the card."""
    if isinstance(frames, torch.Tensor):
        return frames
    return torch.as_tensor(np.asarray(frames), device="cuda")


def pairwise_odometry(frames, generator, cfg: PipelineConfig, frontend: str = "band",
                      gumbel=None):
    """Two-view BA on every consecutive pair, one run_two_view_batch.

    frames: (N, H, W, C). gumbel: optional (N-1, num_trials, max_matches)
    RANSAC draws, pair k's in row k (else drawn from `generator` in pair
    order). Returns (rot_aa (N-1, 3), tran (N-1, 3), ok (N-1,), results)."""
    frames = _on_device(frames)
    res = twoview.run_two_view_batch(frames[:-1], frames[1:], generator, cfg, frontend,
                                     gumbel=gumbel)
    return res.rotation_aa, res.translation, res.ok, res


def build_multiview_problem(poses, pair_results, width, height, max_obs_per_track=6):
    """Landmark-major observation table from pairwise matches with
    cross-pair track merging (models.tracks), on the device of the inputs
    and with no host read. pair_results is a batched TwoViewResult."""
    return tracks.build_multiview_problem(
        poses,
        pair_results.left_xy,
        pair_results.right_xy,
        pair_results.match_valid,
        pair_results.rotation_aa,
        pair_results.translation,
        width,
        height,
        max_obs_per_track=max_obs_per_track,
    )


def information_weights(num_matches, ok, closure_matches):
    """Edge weights sqrt(match count), as the reference computes them in
    float64: odometry pairs without consensus (ok false) count 0.1x, and
    all are divided by the mean odometry weight (at least 1e-6), so a mean
    odometry edge weighs 1 and closure_weight keeps its meaning. Returns
    (odometry weights (N-1,) float32, closure weights (K,) float64), on
    the device of num_matches, with no host read."""
    nm = torch.sqrt(num_matches.double().clamp(min=1.0))
    nm = torch.where(ok, nm, nm * 0.1)
    norm = nm.mean().clamp(min=1e-6)
    cw = torch.sqrt(torch.as_tensor(closure_matches, device=nm.device).double()
                    .clamp(min=1.0)) / norm
    return (nm / norm).float(), cw


def median_baseline(tran):
    """The "auto" rule's statistic: the median odometry |t|, read to the
    host and computed as the reference does (numpy, float32 norms; the
    mean of the two middle values for an even count)."""
    return float(np.median(np.linalg.norm(tran.detach().cpu().numpy(), axis=-1)))


def run_sequence(
    frames,
    generator=None,
    cfg: PipelineConfig = PipelineConfig(),
    frontend: str = "band",
    closures: Sequence[tuple] = (),
    global_ba="auto",
    ba_iters: int = 15,
    mesh=None,
    closure_weight: float = 2.0,
    pg_robust_delta: float = 0.05,
    pg_iters: int = 20,
    pg_tran_weight: float = 0.2,
    gumbel=None,
    closure_gumbel=None,
) -> SequenceResult:
    """Full sequence SfM. frames: (N, H, W, C) stacked ERP frames, on the
    device the pipeline runs on (numpy goes to the card).

    closures: optional (i, j) index pairs to add as loop-closure edges
    (solved together as one extra two-view batch).

    generator: a torch.Generator on the frames' device for the RANSAC
    draws: the odometry pairs' first, in pair order, then one set shared by
    every closure. gumbel: (N-1, num_trials, max_matches) odometry draws
    and closure_gumbel: (num_trials, max_matches), given to every closure,
    in place of the generator's.

    global_ba: True / False / "auto". The global merged-track Schur BA
    refines poses well when observations carry parallax; on
    rotation-dominant sequences (median odometry baseline ~ 0) the
    triangulated landmarks are parallax-free noise and fitting them
    degrades the pose-graph rotations. "auto" runs the BA only when the
    median odometry |t| reaches MIN_BA_BASELINE.

    mesh: a parallel.mesh.Mesh: the global BA runs landmark-sharded over
    its "data" axis (parallel.dist_ba.solve_multiview_sharded). Every rank
    of the mesh calls run_sequence with the same frames and draws and runs
    every stage before the BA itself, as every process of the JAX
    package's would; only the BA is sharded, and every rank returns the
    same result."""
    frames = _on_device(frames)
    n, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    dev = frames.device
    trials, m = cfg.ransac.num_trials, cfg.match.max_matches
    if gumbel is None:
        gumbel = epipolar.gumbel_draws(trials, m, generator, dev, (n - 1,))
    if closures and closure_gumbel is None:
        closure_gumbel = epipolar.gumbel_draws(trials, m, generator, dev)

    rot_aa, tran, ok, pair_res = pairwise_odometry(frames, None, cfg, frontend, gumbel)

    closure_edges, closure_nm = [], torch.zeros(0, dtype=torch.int32, device=dev)
    if closures:
        ci = torch.tensor([i for i, _ in closures], device=dev)
        cj = torch.tensor([j for _, j in closures], device=dev)
        clo = twoview.run_two_view_batch(
            frames[ci], frames[cj], None, cfg, frontend,
            gumbel=torch.as_tensor(closure_gumbel, device=dev).expand(len(closures), -1, -1))
        closure_edges = [(i, j, clo.rotation_aa[k], clo.translation[k])
                         for k, (i, j) in enumerate(closures)]
        closure_nm = clo.num_matches

    odo_w, cw = information_weights(pair_res.num_matches, ok, closure_nm)
    g = pg.chain_with_loop_closures(
        rot_aa, tran, closure_edges, closure_weight=closure_weight,
        odometry_weights=odo_w, closure_weights=cw,
    )
    # tran_weight < 1: the rotation rows carry the information on ERP
    # sequences (edge translations from near-pure-rotation two-view are
    # noise whose residuals would otherwise dominate the cost ~100:1)
    g_opt, pg_costs = pg.optimize_pose_graph(
        g, num_iters=pg_iters, robust_delta=pg_robust_delta, tran_weight=pg_tran_weight,
    )

    ba_costs = torch.zeros((0,), dtype=g_opt.poses.dtype, device=dev)
    poses = g_opt.poses
    if global_ba == "auto":
        global_ba = median_baseline(tran) >= MIN_BA_BASELINE
    if global_ba:
        prob = build_multiview_problem(poses, pair_res, w, h)
        if mesh is not None:
            prob, ba_costs = dist_ba.solve_multiview_sharded(prob, mesh, num_iters=ba_iters)
        else:
            prob, ba_costs = mv.solve_multiview(prob, num_iters=ba_iters)
        poses = prob.poses

    return SequenceResult(
        poses=poses,
        pairwise_rot=rot_aa,
        pairwise_tran=tran,
        pg_costs=pg_costs,
        ba_costs=ba_costs,
        pg_poses=g_opt.poses,
    )
