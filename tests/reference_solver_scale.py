"""The JAX package's global solvers on the solver and synthetic tracks
problems of spherical_bundle_adjuster_tpu_torch/problems.py, and its
run_sequence on the frames of its sequence runs, on the CPU: the
reference's own gate values at those sizes, which the port's GPU smoke
run is gated against.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/reference_solver_scale.py [phase ...]

Builds each phase's problem with problems.py's numpy recipes (the same
seeds, sizes and solver keywords) and prints one JSON line per phase with
the gate values (problems.solver_gates), whether they pass, and the
wall time of the solve on the host's CPU (for the tracks phases, of
models/tracks.build_multiview_problem and the solve). The 1024-keyframe
multiview and tracks phases hold 0.8M observations: run them on a host
with a few GB free.

sequence_10kf renders problems.py's 10 frames at 512x1024 with the port's
render_trajectory on the CPU (the same numpy seed) and runs the JAX
package's run_sequence on them with the same config and closures and the
global BA forced on; it prints the "auto" rule's median odometry |t| and
decision, the BA's mean rotation error and scale-aligned mean translation
error (problems.SEQ_10KF_REFERENCE), the rotation ATE and the wall time.
sequence_100kf_orbit (run only when named: minutes on a CPU) does the
same for problems.py's orbit, mesh=None.

sequence_10kf_split (run only when named) splits the gap between the two
packages on sequence_10kf's frames and draws: the JAX package on its own
front end, the JAX package on the port's band matches (a host callback,
tests/test_torch_sequence.reference_on_port_matches), and the port on the
CPU with the JAX package's draws (problems.reference_sequence_draws);
it prints each run's readings and, per odometry pair, the angle (deg)
between the runs' relative rotations. sequence_10kf_keys (run only when
named) runs the JAX package and the port (CPU, the same draws) on those
frames under the keys SEQ_10KF_KEYS, to show how far the readings move
with the draws.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import bench
from spherical_bundle_adjuster_tpu.models import multiview as mv
from spherical_bundle_adjuster_tpu.models import sequence
from spherical_bundle_adjuster_tpu.models import tracks
from spherical_bundle_adjuster_tpu.solver import pose_graph as pg
from spherical_bundle_adjuster_tpu.utils.config import (
    BaConfig, MatchConfig, PipelineConfig, SurfConfig,
)
from spherical_bundle_adjuster_tpu_torch import problems


def run_multiview(name, C, L, P, noise, seed, kw):
    fields, poses_gt = problems.synth_multiview(C, L, P, noise, seed)
    prob = mv.MultiViewProblem(*(jnp.asarray(f) for f in fields))
    kind = "multiview_dense" if kw.get("linear_solver", "auto") == "auto" and C <= 32 else "multiview_pcg"
    t0 = time.perf_counter()
    solved, costs = mv.solve_multiview(prob, **kw)
    costs = np.asarray(costs)
    seconds = time.perf_counter() - t0
    return problems.solver_gates(kind, float(mv.total_cost(prob)), costs,
                              np.asarray(solved.poses), poses_gt), seconds


def run_pose_graph(name, n, k, seed, kw):
    fields, poses_gt = problems.synth_pose_graph(n, k, seed)
    g = pg.PoseGraph(*(jnp.asarray(f) for f in fields))
    t0 = time.perf_counter()
    opt, costs = pg.optimize_pose_graph(g, **kw)
    costs = np.asarray(costs)
    seconds = time.perf_counter() - t0
    return problems.solver_gates("pose_graph", None, costs, np.asarray(opt.poses), poses_gt), seconds


def run_tracks(name, C, n_lm, slots, stride, kw):
    fields, gt = problems.synth_tracks(C, n_lm, problems.TRACKS_SEED, window=slots, stride=stride,
                                    slots=slots)
    t0 = time.perf_counter()
    prob = tracks.build_multiview_problem(*(jnp.asarray(f) for f in fields), problems.TRACKS_W,
                                          problems.TRACKS_H, max_obs_per_track=problems.TRACKS_P)
    solved, costs = mv.solve_multiview(prob, **kw)
    costs = np.asarray(costs)
    seconds = time.perf_counter() - t0
    longest = int(np.asarray(jnp.sum(prob.obs_valid, axis=-1)).max())
    return problems.tracks_gates(costs, np.asarray(solved.poses), fields[0], gt, longest), seconds


def _sequence_readings(out, R_gt, gt=None):
    """The gate values of a run_sequence result: the auto rule's median
    |t| and decision, cost traces, rotation ATE, and with ground-truth
    poses the BA's and the pose graph's mean rotation and scale-aligned
    translation errors."""
    out = sequence.SequenceResult(*(np.asarray(f) for f in out))
    med_t = float(np.median(np.linalg.norm(out.pairwise_tran, axis=-1)))
    vals = dict(median_t=med_t, auto_runs_ba=med_t >= 0.1, ba_ran=bool(out.ba_costs.size),
                pg_costs=out.pg_costs.tolist(), ba_costs=out.ba_costs.tolist(),
                rot_ate_deg=problems.ate_summary(problems.ate(out.poses, R_gt)[0]),
                rot_ate_pose_graph_deg=problems.ate_summary(problems.ate(out.pg_poses, R_gt)[0]))
    if gt is not None:
        vals["rot_err_deg"], vals["t_err"] = problems.scaled_pose_errors(out.poses, gt)
        vals["pg_rot_err_deg"], vals["pg_t_err"] = problems.scaled_pose_errors(out.pg_poses, gt)
    return vals


def run_sequence_10kf(name, height=problems.SIZE_512[0], width=problems.SIZE_512[1]):
    cfg = bench.corrected_mode(bench.bench_config())
    frames, gt = problems.trajectory_frames(problems.SEQ_10KF_FRAMES, height, width, "cpu")
    t0 = time.perf_counter()
    out = sequence.run_sequence(jnp.asarray(frames.numpy()), jax.random.PRNGKey(problems.SEED), cfg,
                                closures=list(problems.SEQ_10KF_CLOSURES), global_ba=True,
                                ba_iters=problems.SEQ_10KF_BA_ITERS)
    jax.block_until_ready(out.poses)
    seconds = time.perf_counter() - t0
    vals = _sequence_readings(out, problems.angle_axis_matrices(gt[:, :3]), gt)
    return (vals, []), seconds


def _rotation_gaps_deg(rot_a, rot_b):
    """Per pair, the angle (deg) between two sets of relative rotations,
    each (n, 3) angle-axis or (n, 3, 3) matrices."""
    Ra, Rb = (np.asarray(r, np.float64) for r in (rot_a, rot_b))
    Ra, Rb = (problems.angle_axis_matrices(r) if r.ndim == 2 else r for r in (Ra, Rb))
    cos = (np.einsum("nij,nij->n", Ra, Rb) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1, 1))).tolist()


def _port_sequence_cpu(frames, cfg, seed, kw):
    """The port's run_sequence on the CPU with the JAX package's draws for
    jax.random.PRNGKey(seed); its fields as numpy."""
    import torch
    from spherical_bundle_adjuster_tpu_torch.models import sequence as tseq
    from spherical_bundle_adjuster_tpu_torch.utils import config as tconfig

    torch.set_num_threads(os.cpu_count())  # tests/test_torch_sequence sets 1
    odo, closure = problems.reference_sequence_draws(seed, frames.shape[0] - 1,
                                                  cfg.ransac.num_trials, cfg.match.max_matches)
    out = tseq.run_sequence(frames, None, tconfig.from_reference(cfg),
                            gumbel=torch.from_numpy(odo), closure_gumbel=torch.from_numpy(closure),
                            **kw)
    return [f.numpy() for f in out]


def _sequence_10kf_setup(height, width):
    cfg = bench.corrected_mode(bench.bench_config())
    frames, gt = problems.trajectory_frames(problems.SEQ_10KF_FRAMES, height, width, "cpu")
    kw = dict(closures=list(problems.SEQ_10KF_CLOSURES), global_ba=True,
              ba_iters=problems.SEQ_10KF_BA_ITERS)
    return cfg, frames, gt, problems.angle_axis_matrices(gt[:, :3]), kw


def run_sequence_10kf_split(name, height=problems.SIZE_512[0], width=problems.SIZE_512[1]):
    from test_torch_sequence import reference_on_port_matches

    cfg, frames, gt, R_gt, kw = _sequence_10kf_setup(height, width)
    key = jax.random.PRNGKey(problems.SEED)
    t0 = time.perf_counter()
    own = sequence.run_sequence(jnp.asarray(frames.numpy()), key, cfg, **kw)
    with reference_on_port_matches():
        on_port = sequence.run_sequence(jnp.asarray(frames.numpy()), key, cfg, **kw)
    port = _port_sequence_cpu(frames, cfg, problems.SEED, kw)
    seconds = time.perf_counter() - t0
    runs = dict(jax_own_front_end=own, jax_on_port_matches=on_port, port_cpu=port)
    vals = {k: _sequence_readings(v, R_gt, gt) for k, v in runs.items()}
    vals["pair_rotation_gap_deg"] = dict(
        jax_own_vs_jax_on_port_matches=_rotation_gaps_deg(own.pairwise_rot, on_port.pairwise_rot),
        jax_on_port_matches_vs_port=_rotation_gaps_deg(on_port.pairwise_rot, port[1]),
        jax_own_vs_port=_rotation_gaps_deg(own.pairwise_rot, port[1]))
    R_rel = R_gt[1:] @ R_gt[:-1].transpose(0, 2, 1)  # R_{k+1} = R_rel R_k
    vals["pair_rotation_err_deg"] = {k: _rotation_gaps_deg(v[1], R_rel) for k, v in runs.items()}
    return (vals, []), seconds


SEQ_10KF_KEYS = (0, 1, 2, 3, 4)


def run_sequence_10kf_keys(name, height=problems.SIZE_512[0], width=problems.SIZE_512[1]):
    """sequence_10kf's frames under other keys: per key, the JAX package
    (its own front end) and the port on the CPU with that key's draws."""
    cfg, frames, gt, R_gt, kw = _sequence_10kf_setup(height, width)
    t0 = time.perf_counter()
    vals = {}
    for seed in SEQ_10KF_KEYS:
        own = sequence.run_sequence(jnp.asarray(frames.numpy()), jax.random.PRNGKey(seed), cfg,
                                    **kw)
        port = _port_sequence_cpu(frames, cfg, seed, kw)
        vals[f"key_{seed}"] = dict(jax=_sequence_readings(own, R_gt, gt),
                                   port_cpu=_sequence_readings(port, R_gt, gt))
    return (vals, []), time.perf_counter() - t0


def run_sequence_orbit(name, height=problems.SEQ_ORBIT_SIZE[0], width=problems.SEQ_ORBIT_SIZE[1]):
    cfg = PipelineConfig(surf=SurfConfig(max_keypoints=64, n_octaves=2),
                         match=MatchConfig(max_matches=128, ratio_thresh=0.5),
                         ba=BaConfig(reference_compat=False, joint_refine=True,
                                     outlier_reject=True, multi_start=4))
    frames, R_gt = problems.orbit_frames(problems.SEQ_ORBIT_FRAMES, height, width, "cpu")
    t0 = time.perf_counter()
    out = sequence.run_sequence(jnp.asarray(frames.numpy()), jax.random.PRNGKey(problems.SEED), cfg,
                                closures=problems.orbit_closures(problems.SEQ_ORBIT_FRAMES),
                                **problems.SEQ_ORBIT_KW)
    jax.block_until_ready(out.poses)
    seconds = time.perf_counter() - t0
    vals = _sequence_readings(out, R_gt)
    med, mx = problems.GATE_SEQ_ATE_DEG
    fails = [] if vals["rot_ate_deg"]["median"] < med and vals["rot_ate_deg"]["max"] < mx \
        else ["rot_ate_deg"]
    return (vals, fails), seconds


def main(names):
    phases = [(run_multiview, p) for p in problems.MULTIVIEW_PHASES]
    phases += [(run_pose_graph, p) for p in problems.POSE_GRAPH_PHASES]
    phases += [(run_tracks, p) for p in problems.TRACKS_PHASES]
    phases += [(run_sequence_10kf, ("sequence_10kf",)),
               (run_sequence_orbit, ("sequence_100kf_orbit",)),
               (run_sequence_10kf_split, ("sequence_10kf_split",)),
               (run_sequence_10kf_keys, ("sequence_10kf_keys",))]
    named_only = ("sequence_100kf_orbit", "sequence_10kf_split", "sequence_10kf_keys")
    for run, p in phases:
        if (names and p[0] not in names) or (not names and p[0] in named_only):
            continue
        (vals, fails), seconds = run(*p)
        print(json.dumps({"phase": p[0], "package": "jax", "backend": jax.default_backend(),
                          **vals, "passes": not fails, "failed": fails,
                          "seconds_with_compile": seconds}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
