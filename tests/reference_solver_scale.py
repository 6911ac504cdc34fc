"""The JAX package's global solvers on the problems of chip_smoke.py's
solver and synthetic tracks phases, on the CPU: the reference's own gate
values at those sizes, which the port's phases are gated against.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/reference_solver_scale.py [phase ...]

Builds each phase's problem with chip_smoke.py's numpy recipes (the same
seeds, sizes and solver keywords) and prints one JSON line per phase with
the gate values (chip_smoke.solver_gates), whether they pass, and the
wall time of the solve on the host's CPU (for the tracks phases, of
models/tracks.build_multiview_problem and the solve). The 1024-keyframe
multiview and tracks phases hold 0.8M observations: run them on a host
with a few GB free.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke as smoke
from spherical_bundle_adjuster_tpu.models import multiview as mv
from spherical_bundle_adjuster_tpu.models import tracks
from spherical_bundle_adjuster_tpu.solver import pose_graph as pg


def run_multiview(name, C, L, P, noise, seed, kw):
    fields, poses_gt = smoke.synth_multiview(C, L, P, noise, seed)
    prob = mv.MultiViewProblem(*(jnp.asarray(f) for f in fields))
    kind = "multiview_dense" if kw.get("linear_solver", "auto") == "auto" and C <= 32 else "multiview_pcg"
    t0 = time.perf_counter()
    solved, costs = mv.solve_multiview(prob, **kw)
    costs = np.asarray(costs)
    seconds = time.perf_counter() - t0
    return smoke.solver_gates(kind, float(mv.total_cost(prob)), costs,
                              np.asarray(solved.poses), poses_gt), seconds


def run_pose_graph(name, n, k, seed, kw):
    fields, poses_gt = smoke.synth_pose_graph(n, k, seed)
    g = pg.PoseGraph(*(jnp.asarray(f) for f in fields))
    t0 = time.perf_counter()
    opt, costs = pg.optimize_pose_graph(g, **kw)
    costs = np.asarray(costs)
    seconds = time.perf_counter() - t0
    return smoke.solver_gates("pose_graph", None, costs, np.asarray(opt.poses), poses_gt), seconds


def run_tracks(name, C, n_lm, slots, stride, kw):
    fields, gt = smoke.synth_tracks(C, n_lm, smoke.TRACKS_SEED, window=slots, stride=stride,
                                    slots=slots)
    t0 = time.perf_counter()
    prob = tracks.build_multiview_problem(*(jnp.asarray(f) for f in fields), smoke.TRACKS_W,
                                          smoke.TRACKS_H, max_obs_per_track=smoke.TRACKS_P)
    solved, costs = mv.solve_multiview(prob, **kw)
    costs = np.asarray(costs)
    seconds = time.perf_counter() - t0
    longest = int(np.asarray(jnp.sum(prob.obs_valid, axis=-1)).max())
    return smoke.tracks_gates(costs, np.asarray(solved.poses), fields[0], gt, longest), seconds


def main(names):
    phases = [(run_multiview, p) for p in smoke.MULTIVIEW_PHASES]
    phases += [(run_pose_graph, p) for p in smoke.POSE_GRAPH_PHASES]
    phases += [(run_tracks, p) for p in smoke.TRACKS_PHASES]
    for run, p in phases:
        if names and p[0] not in names:
            continue
        (vals, fails), seconds = run(*p)
        print(json.dumps({"phase": p[0], "package": "jax", "backend": jax.default_backend(),
                          **vals, "passes": not fails, "failed": fails,
                          "seconds_with_compile": seconds}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
