"""The port's check problems: the synthetic pairs and problems, the
recorded references, the host measures in float64 and the gates that
the tests, the GPU smoke run, card_rounding.py and kernel_times.py share,
among them the LM stage recipe (stage_problem, solve_stages,
stage_systems, eager_state at LM_SHAPES). Each recipe draws from
generators seeded by its arguments in a fixed order, so it gives the
same arrays on every run and the recorded references hold. No layer of
the port imports this module.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

from .core import rotation, sphere
from .models import tracks, twoview
from .solver import epipolar, lm
from .utils import profiling, synthetic
from .utils.config import DENSE_BAND_PITCHES, MatchConfig, PipelineConfig, SurfConfig


# ---------------------------------------------------------------------------
# Checks (PhaseError) and readings (one JSON line each).


class PhaseError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def phase_device():
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs only on a GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return torch.device("cuda", 0), smi


# ---------------------------------------------------------------------------
# Two-view pairs under bench.py's configs (bench_config_2k / bench_config).

CFG_2K = PipelineConfig(
    surf=SurfConfig(max_keypoints=512, n_octaves=4),
    match=MatchConfig(max_matches=1024, ratio_thresh=0.5),
).parity()
CFG_512 = PipelineConfig(
    surf=SurfConfig(max_keypoints=256, n_octaves=3),
    match=MatchConfig(max_matches=512, ratio_thresh=0.5),
).parity()
N_DISTINCT = 16  # the bench's make_batch: 16 distinct pairs ...
N_BATCH = 64     # ... tiled to its headline batch
CUBE_2K = 600  # the reference's feature test cube size at 2K
SIZE_2K = (1024, 2048)
SIZE_512 = (512, 1024)
SEED = 42


def corrected_mode(cfg):
    """bench.corrected_mode on the port's config: per-match depths, outlier
    gates, the joint Schur polish, 4 starts and 240 RANSAC trials."""
    return dataclasses.replace(
        cfg,
        ba=dataclasses.replace(cfg.ba, reference_compat=False, joint_refine=True,
                               outlier_reject=True, multi_start=4),
        ransac=dataclasses.replace(cfg.ransac, num_trials=240),
    )


def make_pair(i, height, width, dev, euler_deg=None, n_discs=96):
    """Pair i: the scene of seed SEED + i (n_discs discs), seen through
    Euler angles default_rng(SEED).uniform(-5, 5, (16, 3))[i] deg (the
    first 4 rows are those of a (4, 3) draw), or through euler_deg."""
    params = synthetic.texture_params_from_numpy(np.random.default_rng(SEED + i), n_discs=n_discs)
    if euler_deg is None:
        euler_deg = np.random.default_rng(SEED).uniform(-5, 5, (N_DISTINCT, 3))[i]
    euler = np.deg2rad(np.asarray(euler_deg, np.float64))
    left, right, R = synthetic.rotation_pair(params, euler.astype(np.float32), height, width, dev)
    return left, right, R.cpu().numpy().astype(np.float64)


def pair_of(out, i):
    """Pair i of a batch's TwoViewResult, as run_two_view returns it."""
    tel = out.telemetry
    return twoview.TwoViewResult(*(f[i] for f in out[:-1]), telemetry=twoview.SolverTelemetry(
        *(type(r)(*(f[i] for f in r)) for r in tel[:3]), *(f[i] for f in tel[3:])))


def same_matches(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("match_valid", "left_xy", "right_xy"))


def stacked(pairs):
    return (torch.stack([l for l, _, _ in pairs]), torch.stack([r for _, r, _ in pairs]))


def draws(cfg, n, dev, seed=SEED):
    """Every pair's RANSAC draws, (n, trials, max_matches), from one seed."""
    return epipolar.gumbel_draws(cfg.ransac.num_trials, cfg.match.max_matches,
                                 torch.Generator(dev).manual_seed(seed), dev, (n,))


def angle_axis_matrix(aa):
    """Rodrigues' rotation matrix of an angle-axis vector, in float64."""
    aa = np.asarray(aa, np.float64)
    th = np.linalg.norm(aa)
    k = aa / max(th, 1e-30)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def rot_err_deg_host(rot_aa, R_gt):
    """Geodesic angle between Rodrigues(rot_aa) and R_gt, on the host in
    float64 (the bench's rot_err_deg_host)."""
    tr = np.sum(angle_axis_matrix(rot_aa) * np.asarray(R_gt, np.float64))
    return float(np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1))))


def angle_axis_of(euler):
    """The angle-axis vector of the rotation of Euler angles (a tensor)."""
    return rotation.euler_to_angle_axis(euler.double()).cpu().numpy()


def printed(stdout, prefix):
    """The words after `prefix` on the CLI's line that starts with it."""
    lines = [ln for ln in stdout.splitlines() if ln.startswith(prefix)]
    require(len(lines) == 1, f"the CLI printed {len(lines)} lines starting {prefix!r}")
    return lines[0][len(prefix):].split()


# ---------------------------------------------------------------------------
# The LM stages of solver/lm on a noisy synthetic scene.

# (leading axes, matches) of the cells' LM stage solves: a 2K pair alone
# (compat) and with 4 starts (corrected); the 64-pair batch at 512
# matches, alone and with 4 starts
LM_SHAPES = (((), 1024), ((4,), 1024), ((64,), 512), ((64, 4), 512))
# and the small ones the CPU tests solve: one pair; 3 pairs x 2 starts
LM_CPU_SHAPES = (((), 96), ((3, 2), 40))


def stage_problem(lead, m, seed=0, dev="cpu"):
    """A noisy two-view scene's bearing banks, shared by the starts, with
    10% of the match slots invalid, and the stages' starts: unit depths
    and a pose off the true one, drawn on the CPU and moved to dev:
    (b1, b2, valid, d0, r0, t0) with leading axes `lead` and m matches."""
    g = torch.Generator().manual_seed(seed)
    bank = lead[:-1] + (1,) if lead else ()

    def randn(*shape):
        return torch.randn(shape, generator=g)

    b1 = torch.nn.functional.normalize(randn(*bank, m, 3), dim=-1)
    depth = 2.0 + 3.0 * torch.rand(bank + (m,), generator=g)
    r_true, t_true = 0.1 * randn(*bank, 3), 0.3 * randn(*bank, 3)
    x2 = rotation.rotate_angle_axis(r_true[..., None, :].expand(b1.shape), depth[..., None] * b1)
    b2 = torch.nn.functional.normalize(x2 - t_true[..., None, :] + 0.01 * randn(*bank, m, 3), dim=-1)
    valid = torch.rand(lead + (m,), generator=g) < 0.9
    d0 = torch.ones(lead + (m, 2))
    r0 = (r_true + 0.05 * randn(*lead, 3)).expand(lead + (3,)).contiguous()
    t0 = (t_true + 0.1 * randn(*lead, 3)).expand(lead + (3,)).contiguous()
    return tuple(x.to(dev) for x in (b1, b2, valid, d0, r0, t0))


def solve_stages(prob, cfg, compat, lm_fixed):
    """The BCD stages in order, each from the last one's result, as
    run_two_view solves them: depths, rotation, translation (compat: on
    the first match's depth pair, which every match shares), with
    lm.lm_fixed set to `lm_fixed` (the stages call it through the
    module). Returns [(stage, result, StageReport, the stage's growth of
    profiling.COUNTS)]."""
    b1, b2, valid, d0, r0, t0 = prob
    out = []

    def run(stage, fn, *args):
        before = profiling.COUNTS.copy()
        res, rep = fn(*args)
        out.append((stage, res, rep, profiling.COUNTS - before))
        return res

    real = lm.lm_fixed
    lm.lm_fixed = lm_fixed
    try:
        d = run("depth", lm.solve_depths, b1, b2, d0, r0, t0, valid, cfg)
        pair = d[..., 0, :] if compat else d
        r = run("rot", lm.solve_rotation, b1, b2, pair, r0, t0, valid, cfg)
        run("tran", lm.solve_translation, b1, b2, pair, r, t0, valid, cfg)
    finally:
        lm.lm_fixed = real
    return out


def stage_systems(prob, cfg, compat):
    """Each stage's (stage, cost_and_system, trip kernels' problem, x0,
    kept, lower bound) at the problem's start, as solve_stages runs
    them."""
    b1, b2, valid, d0, r0, t0 = prob
    pair = d0[..., 0, :] if compat else d0
    sys_d, p_d = lm._depth_system(b1, b2, r0, t0, valid, cfg)
    sys_r, p_r = lm._global_system(True, b1, b2, pair, t0, r0, valid, cfg)
    sys_t, p_t = lm._global_system(False, b1, b2, pair, r0, t0, valid, cfg)
    return [("depth", sys_d, p_d, d0.reshape(-1, 2), valid.reshape(-1), cfg.d_lower_bound),
            ("rot", sys_r, p_r, r0.reshape(-1, 3), None, None),
            ("tran", sys_t, p_t, t0.reshape(-1, 3), None, None)]


def eager_state(system, x0, cfg, lower_bound, trips):
    """A stage's op-by-op trip (lm._trip on its cost_and_system `system`)
    and the loop's state after `trips` trips of it from x0."""
    step, state = lm._eager_start(system, x0, cfg, lower_bound)
    for _ in range(trips):
        state = step(state)
    return step, state


# ---------------------------------------------------------------------------
# The global solvers: tests/test_multiview.synth_problem and
# tests/test_pose_graph.TestScaledPoseGraph._make_graph in numpy.

# (name, cameras C, landmarks L, observations per landmark P, pose noise,
#  seed, solve_multiview keywords)
MULTIVIEW_PHASES = (
    # config #3: 10 keyframes, 9 consecutive pairs x 1024 match slots
    ("multiview_dense_10kf", 10, 9216, 6, 0.05, 0, dict(num_iters=15)),
    # tests/test_multiview.py::test_c256_l8192_sharded_pcg, on one device
    ("multiview_pcg_256kf", 256, 8192, 4, 0.03, 3,
     dict(num_iters=8, linear_solver="pcg", cg_iters=60, cg_tol=1e-5)),
    # config #5 scale
    ("multiview_pcg_1024kf", 1024, 131072, 6, 0.03, 5,
     dict(num_iters=8, linear_solver="pcg", cg_iters=60, cg_tol=1e-5)),
)
# (name, nodes, loop closures, seed, optimize_pose_graph keywords)
POSE_GRAPH_PHASES = (
    ("pose_graph_100kf", 100, 8, 1, dict(num_iters=15)),  # config #4
    ("pose_graph_1024kf", 1024, 64, 3,
     dict(num_iters=15, linear_solver="pcg", cg_iters=120)),
)
# the JAX tests' gates: test_converges_from_noisy_init (dense),
# test_c256_l8192_sharded_pcg (PCG), test_512_chain_32_closures_pcg
GATE_MV_DENSE = dict(cost_ratio=1e-6, max_rot_err_deg=0.5, max_t_err=0.05)
GATE_MV_PCG = dict(cost_ratio=1e-4, median_rot_err_deg=0.2, median_t_err=0.02)
GATE_PG = dict(cost_ratio=1e-4, median_t_err=0.02)


def angle_axis_matrices(aa):
    """(N, 3) angle-axis -> (N, 3, 3) rotation matrices, float64."""
    aa = np.asarray(aa, np.float64)
    th = np.linalg.norm(aa, axis=-1)[:, None, None]
    k = aa / np.maximum(th[:, :, 0], 1e-30)
    K = np.zeros(aa.shape[:1] + (3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def log_rotations(R):
    """(N, 3, 3) -> (N, 3) angle-axis, float64 (angles below pi)."""
    ax = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]], -1)
    s = np.linalg.norm(ax, axis=-1) / 2
    th = np.arctan2(s, (np.trace(R, axis1=1, axis2=2) - 1) / 2)
    return ax * np.where(s > 1e-12, th / (2 * np.maximum(s, 1e-30)), 0.5)[:, None]


def pose_errors(poses, poses_gt):
    """Per camera: rotation error (deg) and translation error, float64."""
    poses = np.asarray(poses, np.float64)
    rel = angle_axis_matrices(poses[:, :3]) @ angle_axis_matrices(poses_gt[:, :3]).transpose(0, 2, 1)
    cos = (np.trace(rel, axis1=1, axis2=2) - 1) / 2
    ang = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    return ang, np.linalg.norm(poses[:, 3:] - poses_gt[:, 3:], axis=-1)


def synth_multiview(C, L, P, pose_noise, seed):
    """tests/test_multiview.synth_problem (noise-free bearings) in numpy,
    the same draws in the same order: cameras on a small trajectory,
    landmarks on a shell, each seen by P distinct random cameras. Returns
    (the problem's fields with a noisy init, the ground-truth poses)."""
    rng = np.random.default_rng(seed)
    aa = rng.uniform(-0.1, 0.1, (C, 3))
    aa[0] = 0
    t = rng.uniform(-0.3, 0.3, (C, 3))
    t[0] = 0
    poses_gt = np.concatenate([aa, t], axis=-1).astype(np.float32)
    X = rng.normal(size=(L, 3))
    X = (X / np.linalg.norm(X, axis=-1, keepdims=True) * rng.uniform(3, 7, (L, 1))).astype(np.float32)
    obs_cam = np.stack([rng.choice(C, P, replace=False) for _ in range(L)]).astype(np.int32)
    R = angle_axis_matrices(poses_gt[:, :3])
    p = np.einsum("lpij,lj->lpi", R[obs_cam], X.astype(np.float64)) - poses_gt[obs_cam, 3:]
    b = (p / np.linalg.norm(p, axis=-1, keepdims=True)).astype(np.float32)
    poses0 = poses_gt + rng.normal(scale=pose_noise, size=poses_gt.shape).astype(np.float32)
    poses0[0] = poses_gt[0]
    X0 = X + rng.normal(scale=0.1, size=X.shape).astype(np.float32)
    return (poses0, X0, obs_cam, b, np.ones((L, P), bool), np.ones(L, bool)), poses_gt


def synth_pose_graph(n, n_closures, seed, init_noise=(0.05, 0.2)):
    """tests/test_pose_graph.TestScaledPoseGraph._make_graph in numpy, the
    same draws in the same order: a chain of n random poses with exact
    relative-pose edges and n_closures closures 5-9 nodes apart. Returns
    (the graph's fields with a noisy init, the ground-truth poses)."""
    rng = np.random.default_rng(seed)
    gt = np.concatenate([rng.uniform(-0.5, 0.5, (n, 3)), rng.uniform(-2.0, 2.0, (n, 3))],
                        axis=-1).astype(np.float32)
    gt[0] = 0.0
    ei, ej = np.arange(n - 1), np.arange(1, n)
    if n_closures:
        ci = rng.integers(0, n - 10, n_closures)
        cj = ci + rng.integers(5, 10, n_closures)
        ei, ej = np.concatenate([ei, ci]), np.concatenate([ej, cj])
    R = angle_axis_matrices(gt[:, :3])
    R_rel = R[ej] @ R[ei].transpose(0, 2, 1)
    t_rel = gt[ej, 3:] - np.einsum("eij,ej->ei", R_rel, gt[ei, 3:].astype(np.float64))
    init = gt + np.concatenate([rng.normal(scale=init_noise[0], size=(n, 3)),
                                rng.normal(scale=init_noise[1], size=(n, 3))],
                               axis=-1).astype(np.float32)
    init[0] = gt[0]
    fields = (init, ei.astype(np.int32), ej.astype(np.int32), log_rotations(R_rel).astype(np.float32),
              t_rel.astype(np.float32), np.ones(len(ei), np.float32))
    return fields, gt


def solver_gates(kind, c0, costs, poses, poses_gt):
    """The gate values of a solve (costs: its cost trace; c0: the cost at
    its init) and the failed gates' messages."""
    ang, terr = pose_errors(poses, poses_gt)
    c1 = float(costs[-1])
    if kind == "multiview_dense":
        gate = GATE_MV_DENSE
        vals = dict(cost0=c0, cost=c1, cost_limit=gate["cost_ratio"] * max(c0, 1.0),
                    max_rot_err_deg=float(ang.max()), max_t_err=float(terr.max()))
        fails = [k for k, bad in (("cost", c1 > vals["cost_limit"]),
                                  ("max_rot_err_deg", vals["max_rot_err_deg"] >= gate["max_rot_err_deg"]),
                                  ("max_t_err", vals["max_t_err"] >= gate["max_t_err"])) if bad]
    else:
        gate = GATE_MV_PCG if kind == "multiview_pcg" else GATE_PG
        first = float(costs[0])
        vals = dict(first_cost=first, cost=c1, cost_ratio=c1 / first,
                    median_rot_err_deg=float(np.median(ang)), max_rot_err_deg=float(ang.max()),
                    median_t_err=float(np.median(terr)), max_t_err=float(terr.max()))
        checks = [("cost_ratio", not vals["cost_ratio"] < gate["cost_ratio"]),
                  ("median_t_err", not vals["median_t_err"] < gate["median_t_err"])]
        if kind == "multiview_pcg":
            checks.append(("median_rot_err_deg",
                           not vals["median_rot_err_deg"] < gate["median_rot_err_deg"]))
        fails = [k for k, bad in checks if bad]
    return dict(gates=gate, **vals), fails


# ---------------------------------------------------------------------------
# Merged tracks: tests/test_tracks._make_sequence_problem in numpy, and a
# rendered trajectory.

# (name, cameras C, landmarks, match slots per pair = the window, window
#  stride, solve_multiview keywords)
TRACKS_PHASES = (
    # config #3's shape (multiview_dense_10kf): 9 pairs x 1024 slots, L = 9216
    ("tracks_10kf", 10, 2048, 1024, 128, dict(num_iters=25)),
    # config #5's scale (multiview_pcg_1024kf): 1023 pairs x 128 slots,
    # L = 130944; every landmark seen from 9 frames, capped at P = 6
    ("tracks_1024kf", 1024, 1022 * 16 + 128, 128, 16,
     dict(num_iters=8, linear_solver="pcg", cg_iters=60, cg_tol=1e-5)),
)
TRACKS_SEED = 1
TRACKS_POSE_NOISE = (0.02, 0.08)  # rotation (rad), translation
TRACKS_W, TRACKS_H = 1024, 512
TRACKS_P = 6
# tests/test_tracks.py::test_ba_beats_pose_graph_only_10_frames: the last
# cost below the first, the mean rotation and the scale-aligned mean
# translation error below half the noisy start's, a track of >= 4
# observations
GATE_TRACKS = dict(error_ratio=0.5, min_longest_track=4)
# The JAX package misses those error gates on tracks_1024kf (8 PCG GN
# steps from the noisy chain; tests/reference_solver_scale.py on the chip
# host's CPU): mean rotation error 1.2957 deg (start 1.7964), translation
# 0.2284 (start 0.1303). There the port is held to 1.5x the reference's
# own errors.
TRACKS_REFERENCE_ERRORS = {"tracks_1024kf": (1.2956821711419453, 0.22841546218861458)}
TRACKS_REFERENCE_FACTOR = 1.5
# one build against another of the same inputs (the card's against the
# CPU's, the port's against the reference's): ints and bools exact,
# bearings 2e-6, landmarks where the root's midpoint det > 1e-3 within
# max(1e-4, 1e-6 / det) of their norm: det = 1 - (b1 . R^T b2)^2 cancels,
# so one float32 step of the dot (6e-8) moves det by ~1.2e-7 and the
# midpoint by that over det (the reference's float32 against the port's
# float64 triangulation: gap x det <= 8.1e-7 on the 10-keyframe recipe)
TRACKS_BEARING_ATOL = 2e-6
TRACKS_LANDMARK_RTOL = 1e-4
TRACKS_LANDMARK_DET_RTOL = 1e-6
TRACKS_DET_MIN = 1e-3
# tracks_from_odometry: frames along a translating, turning trajectory
ODO_YAW_DEG = 3.0
ODO_STEP = 0.25
ODO_SEED = 11
CELL_SIZE = 0.5  # models/tracks' default grid cell (pixels)


def synth_tracks(n_cams, n_landmarks, seed, pose_noise=TRACKS_POSE_NOISE, window=None,
                 stride=None, slots=None, width=TRACKS_W, height=TRACKS_H):
    """tests/test_tracks._make_sequence_problem in numpy, the same draws in
    the same order: landmarks on a shell projected through a random
    trajectory; pair k holds the landmarks [lo, lo + window) with lo =
    min(k * stride, n_landmarks - window), in its first `window` of
    `slots` match slots (frame k's pixel shared by pairs k-1 and k, as a
    detector's). Window, stride and slots default to the recipe's (half
    the landmarks, spread over the pairs; slots = landmarks). Returns
    ((noisy poses, left_xy, right_xy, valid, pair_rot_aa, pair_tran), the
    ground-truth poses): build_multiview_problem's inputs, with the
    per-pair relative poses taken from the noisy chain."""
    rng = np.random.default_rng(seed)
    n_pairs = n_cams - 1
    gt = np.concatenate([rng.uniform(-0.15, 0.15, (n_cams, 3)),
                         np.cumsum(rng.uniform(-0.4, 0.4, (n_cams, 3)), axis=0)],
                        axis=-1).astype(np.float32)
    gt[0] = 0.0
    X = rng.normal(size=(n_landmarks, 3))
    X = (X / np.linalg.norm(X, axis=-1, keepdims=True)
         * rng.uniform(4.0, 9.0, (n_landmarks, 1))).astype(np.float32)
    R = angle_axis_matrices(gt[:, :3])
    p = np.einsum("cij,lj->cli", R, X.astype(np.float64)) - gt[:, None, 3:]
    b = p / np.linalg.norm(p, axis=-1, keepdims=True)
    phi = np.mod(np.arctan2(b[..., 1], b[..., 0]), 2 * np.pi)
    theta = np.arccos(np.clip(b[..., 2], -1.0, 1.0))
    px = np.stack([width * phi / (2 * np.pi), height * theta / np.pi], -1)
    px = px + rng.normal(scale=0.0, size=px.shape)  # the recipe's px_noise = 0 draw
    win = window or max(n_landmarks // 2, 12)
    stride = stride or max((n_landmarks - win) // max(n_pairs - 1, 1), 1)
    m = slots or n_landmarks
    left_xy = np.zeros((n_pairs, m, 2), np.float32)
    right_xy = np.zeros((n_pairs, m, 2), np.float32)
    valid = np.zeros((n_pairs, m), bool)
    for k in range(n_pairs):
        lo = min(k * stride, n_landmarks - win)
        left_xy[k, :win] = px[k, lo:lo + win]
        right_xy[k, :win] = px[k + 1, lo:lo + win]
        valid[k, :win] = True
    noisy = gt + np.concatenate([rng.normal(scale=pose_noise[0], size=(n_cams, 3)),
                                 rng.normal(scale=pose_noise[1], size=(n_cams, 3))],
                                axis=-1).astype(np.float32)
    noisy[0] = gt[0]
    Rn = angle_axis_matrices(noisy[:, :3])
    R_rel = Rn[1:] @ Rn[:-1].transpose(0, 2, 1)
    t_rel = noisy[1:, 3:] - np.einsum("kij,kj->ki", R_rel, noisy[:-1, 3:].astype(np.float64))
    return (noisy, left_xy, right_xy, valid, log_rotations(R_rel).astype(np.float32),
            t_rel.astype(np.float32)), gt


def scaled_pose_errors(poses, gt):
    """tests/test_tracks._pose_errors: the mean rotation error (deg) and
    the mean translation error after the least-squares global scale
    (bearing-only BA has a scale gauge)."""
    ang, _ = pose_errors(poses, gt)
    te, tg = np.asarray(poses, np.float64)[:, 3:], np.asarray(gt, np.float64)[:, 3:]
    s = float(np.sum(te * tg) / max(np.sum(te * te), 1e-12))
    return float(np.mean(ang)), float(np.mean(np.linalg.norm(s * te - tg, axis=-1)))


def tracks_gates(costs, poses, noisy, gt, longest, limits=None):
    """The gate values of a BA on merged tracks and the failed gates'
    names. limits: absolute (rotation deg, translation) error limits in
    place of GATE_TRACKS' ratio to the noisy start."""
    r0, t0 = scaled_pose_errors(noisy, gt)
    r1, t1 = scaled_pose_errors(poses, gt)
    rot_lim, t_lim = limits or (GATE_TRACKS["error_ratio"] * r0, GATE_TRACKS["error_ratio"] * t0)
    vals = dict(first_cost=float(costs[0]), cost=float(costs[-1]), rot_err_deg_start=r0,
                rot_err_deg=r1, rot_err_limit=rot_lim, t_err_start=t0, t_err=t1,
                t_err_limit=t_lim, longest_track=int(longest))
    fails = [k for k, bad in (("cost", not vals["cost"] < vals["first_cost"]),
                              ("rot_err_deg", not r1 < rot_lim), ("t_err", not t1 < t_lim),
                              ("longest_track", longest < GATE_TRACKS["min_longest_track"]))
             if bad]
    return vals, fails


def landmark_det(inputs, width, height):
    """(L,) the midpoint det (1 - (b1 . R^T b2)^2) of each landmark's root
    match, NaN on rows without a root; from the CPU copies of
    build_multiview_problem's inputs."""
    _, lxy, rxy, valid, rot, _ = (torch.as_tensor(a).cpu() for a in inputs)
    tt = tracks.merge_tracks(lxy, rxy, valid)
    b1 = sphere.pixel_to_bearing(lxy.double(), width, height)
    b2 = sphere.pixel_to_bearing(rxy.double(), width, height)
    d2 = b2 @ rotation.angle_axis_to_matrix(rot.double())
    det = (1.0 - torch.sum(b1 * d2, -1) ** 2).numpy()
    root = (valid & (tt.slot == 0) & (tt.track_id >= 0)).numpy()
    out = np.full(valid.numel(), np.nan)
    out[tt.track_id.numpy()[root]] = det[root]
    return out


def problem_gaps(got, want, det):
    """How far MultiViewProblem `got` is from `want` (both moved to the
    host): the int and bool fields equal, the bearings' largest gap, the
    landmarks' largest gap over their norm where det > TRACKS_DET_MIN (and
    that gap times det), and whether all are within the stated
    tolerances."""
    got = [t.cpu() for t in got]
    want = [t.cpu() for t in want]
    exact = all(torch.equal(a, b) for a, b in zip(got, want) if not a.is_floating_point())
    bear = (got[3] - want[3]).abs().max().item()
    rows = det > TRACKS_DET_MIN
    rel = ((got[1] - want[1]).norm(dim=-1) / want[1].norm(dim=-1).clamp(min=1e-12)).double().numpy()
    rel, d = rel[rows], det[rows]
    lm_ok = bool(np.all(rel <= np.maximum(TRACKS_LANDMARK_RTOL, TRACKS_LANDMARK_DET_RTOL / d)))
    poses = (got[0] - want[0]).abs().max().item()
    return dict(exact_fields_equal=exact, bearing_max_gap=bear,
                landmark_max_rel_gap=float(rel.max(initial=0.0)),
                landmark_max_rel_gap_times_det=float((rel * d).max(initial=0.0)),
                poses_max_gap=poses, within=exact and bear <= TRACKS_BEARING_ATOL and lm_ok
                and poses == 0.0)


def trajectory_poses(n):
    """(n, 6) [angle-axis | t]: frame k turned ODO_YAW_DEG * k about z,
    its centre ODO_STEP * k along x (t = R c in p = R X - t)."""
    yaw = np.deg2rad(ODO_YAW_DEG) * np.arange(n)
    aa = np.stack([np.zeros(n), np.zeros(n), yaw], -1)
    c = np.stack([ODO_STEP * np.arange(n), np.zeros(n), np.zeros(n)], -1)
    return np.concatenate([aa, np.einsum("kij,kj->ki", angle_axis_matrices(aa), c)],
                          -1).astype(np.float32)


def shared_cells(left_xy, right_xy, valid):
    """Frame k in both slots of a consecutive-pair batch: over every right
    keypoint of pair k-1 and left keypoint of pair k in one grid cell, how
    many (pair k, right m', left m) are in one cell and how many of them
    differ in any bit; also pair k-1's right cells that hold two or more
    keypoints (the tie rule's cases) and pair k's left cells that do (two
    matches continuing one track: the duplicate scatter's cases)."""
    lxy, rxy, v = (t.cpu().numpy() for t in (left_xy, right_xy, valid))
    same, differ, ties, dups = [], [], [], []
    for k in range(1, v.shape[0]):
        r, l = rxy[k - 1][v[k - 1]], lxy[k][v[k]]
        cr, cl = np.round(r / CELL_SIZE), np.round(l / CELL_SIZE)
        eq = np.all(cr[:, None] == cl[None], -1)
        same.append(int(eq.sum()))
        differ.append(int((eq & np.any(r[:, None] != l[None], -1)).sum()))
        ties.append(int(len(cr) - len(np.unique(cr, axis=0))))
        dups.append(int(len(cl) - len(np.unique(cl, axis=0))))
    return dict(same_cell=same, same_cell_not_bit_identical=differ,
                right_cells_shared=ties, left_cells_shared=dups)


# ---------------------------------------------------------------------------
# Sequences: scripts/run_sequence_100.run_orbit's 100-keyframe orbit and a
# 10-keyframe turning, translating sequence through the global BA.

SEQ_ORBIT_FRAMES = 100
SEQ_ORBIT_SIZE = (256, 512)
SEQ_ORBIT_SCENE_SEED = 11  # one numpy-seeded scene seen by every frame
# scripts/run_sequence_100.run_orbit's config: 64 keypoints a band, 2
# octaves, 128 match slots, ratio 0.5; corrected BA (per-match depths,
# outlier gates, the joint Schur polish, 4 starts) with 80 RANSAC trials;
# the default auto band ladder
_ORBIT_BASE = PipelineConfig(surf=SurfConfig(max_keypoints=64, n_octaves=2),
                             match=MatchConfig(max_matches=128, ratio_thresh=0.5))
SEQ_ORBIT_CFG = dataclasses.replace(_ORBIT_BASE, ba=dataclasses.replace(
    _ORBIT_BASE.ba, reference_compat=False, joint_refine=True, outlier_reject=True,
    multi_start=4))
SEQ_ORBIT_KW = dict(global_ba="auto", ba_iters=10, closure_weight=8.0, pg_iters=60)
# the slow test's bound (tests/test_sequence.py:97-98): right-side-gauge
# rotation ATE median and max, degrees
GATE_SEQ_ATE_DEG = (1.0, 2.0)
# the JAX package's recorded orbit (SEQUENCE_100_r05.json: its own scene,
# rendered from a JAX key, on an 8-device CPU mesh): ATE median and max
# (deg); its "auto" rule skipped the global BA
SEQ_ORBIT_RECORDED_ATE_DEG = (0.18427328049576297, 0.5131891492613272)
# the JAX package on this orbit's frames (rendered by the port on the CPU),
# mesh=None (tests/reference_solver_scale.py sequence_100kf_orbit on the
# CPU of the H100 machine, 159 s): ATE median and max (deg); "auto" skipped the BA
# (median odometry |t| 0.0189)
SEQ_ORBIT_REFERENCE_ATE_DEG = (0.2973031873044645, 0.7698628777834117)
SEQ_10KF_FRAMES = 10
SEQ_10KF_CFG = corrected_mode(CFG_512)
SEQ_10KF_CLOSURES = ((0, 2), (4, 6))
SEQ_10KF_BA_ITERS = 15
# The JAX package on the same 10 frames (rendered by the port on the CPU)
# under the same config and closures, global BA forced on, with key
# jax.random.PRNGKey(SEED), whose draws the port's run is given
# (reference_sequence_draws) (tests/reference_solver_scale.py
# sequence_10kf on the H100 machine's CPU, 8 cores, jax 0.9.0; 151 s with
# compiles): its "auto" rule's median odometry |t| and decision; the BA's
# mean rotation error (deg) and scale-aligned mean translation error, to
# which the port is held within 1.5x; and the rotation ATE (median, max;
# deg) of its final and of its pose-graph poses. It misses the orbit's
# median bound here (1.65 and 1.19 deg against 1.0: the BA over 0.25-unit
# baselines trades yaw against lateral translation) and meets the max
# bound (1.85 and 1.91 against 2.0), so, as for tracks_1024kf, the port's
# median is held to 1.5x the JAX package's own and its max to 2.0.
SEQ_10KF_REFERENCE = dict(median_t=0.27326685190200806, auto_runs_ba=True,
                          rot_err_deg=1.9219845213375446, t_err=0.18487378677898375,
                          ate_deg=(1.6457961919323285, 1.8529200214929789),
                          pg_ate_deg=(1.186712373566194, 1.9131165538029131))
SEQ_REFERENCE_FACTOR = 1.5
SEQ_RUNS = (("sequence_100kf_orbit", SEQ_ORBIT_CFG, SEQ_ORBIT_SIZE),
            ("sequence_10kf", SEQ_10KF_CFG, SIZE_512))


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) as jax.random's default
    PRNG applies it: key (2,) uint32, counters x0, x1 uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    x0, x1 = np.array(x0, np.uint32), np.array(x1, np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for i in range(5):
            for r in _THREEFRY_ROTATIONS[i % 2]:
                x0 += x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def reference_split(key, n):
    """jax.random.split(key, n) (partitionable Threefry): row i hashes the
    counter (0, i)."""
    return np.stack(threefry2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32)),
                    axis=-1)


def reference_gumbel(key, n):
    """jax.random.gumbel(key, (n,)) in float32: uniform bits (the two
    hash words XORed, 23 mantissa bits) on [tiny, 1), then -log(-log u).
    The bits are the reference's exactly; the logs may differ by an ulp."""
    b0, b1 = threefry2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    f = (((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    tiny = np.finfo(np.float32).tiny
    u = np.maximum(np.float32(tiny), f * np.float32(1 - tiny) + np.float32(tiny))
    return -np.log(-np.log(u))


def reference_draws(key, trials, m):
    """The RANSAC draws (trials, m) of the reference's run_two_view with
    key (2,) uint32: trial t's from split(key, trials)[t]."""
    return np.stack([reference_gumbel(k, m) for k in reference_split(key, trials)])


def reference_sequence_draws(seed, n_pairs, trials, m):
    """The reference's run_sequence draws under jax.random.PRNGKey(seed)
    (the key [0, seed]): odometry pair k's from split(key, n_pairs)[k],
    each closure's from the key itself. Returns (odometry (n_pairs,
    trials, m), closures (trials, m)), float32 numpy."""
    key = np.array([0, seed], np.uint32)
    return (np.stack([reference_draws(k, trials, m) for k in reference_split(key, n_pairs)]),
            reference_draws(key, trials, m))


def orbit_eulers(n, yaw_total_deg=356.4, wobble_deg=2.0, seed=0):
    """scripts/run_sequence_100.orbit_eulers: per-frame absolute
    orientation, a linear yaw sweep with a smooth pitch and roll wobble."""
    rng = np.random.default_rng(seed)
    tt = np.linspace(0.0, 1.0, n)
    yaw = np.deg2rad(yaw_total_deg) * tt
    pitch = np.deg2rad(wobble_deg) * np.sin(2 * np.pi * 2.0 * tt + rng.uniform(0, 6.28))
    roll = np.deg2rad(wobble_deg) * np.sin(2 * np.pi * 3.0 * tt + rng.uniform(0, 6.28))
    return np.stack([roll, pitch, yaw], axis=1).astype(np.float32)


def orbit_closures(n):
    """scripts/run_sequence_100.run_orbit's closures: span-10 and span-25
    skips, the quarter and half orbit, and the true loop (0, n-1)."""
    return sorted({(i, min(i + 10, n - 1)) for i in range(0, n - 1, 10)}
                  | {(i, min(i + 25, n - 1)) for i in range(0, n - 1, 25)}
                  | {(0, n // 2), (n // 4, 3 * n // 4), (n // 2, n - 1)}
                  | {(0, n - 1)})


def orbit_frames(n, height, width, dev):
    """n frames of one scene through orbit_eulers(n)'s rotations R_k
    (bearings b_k = R_k b_0, rendered through R_k^T as the script does);
    returns (frames (n, H, W, 3) uint8, R_k (n, 3, 3) float64)."""
    R = rotation.euler_to_matrix(torch.as_tensor(orbit_eulers(n), device=dev))
    params = synthetic.texture_params_from_numpy(np.random.default_rng(SEQ_ORBIT_SCENE_SEED))
    frames = torch.stack([synthetic.render_erp(params, r.T, height, width, dev) for r in R])
    return frames, R.cpu().numpy().astype(np.float64)


def trajectory_frames(n, height, width, dev):
    """n frames along trajectory_poses(n) through the scene of ODO_SEED
    (tracks_from_odometry's); returns (frames, poses (n, 6))."""
    rng = np.random.default_rng(ODO_SEED)
    params = synthetic.texture_params_from_numpy(rng)
    dists = synthetic.disc_distances_from_numpy(rng)
    gt = trajectory_poses(n)
    return synthetic.render_trajectory(params, dists, gt, height, width, dev), gt


def ate(poses, R_gt):
    """scripts/run_sequence_100.run_orbit's rotation ATE (deg per frame),
    in numpy: with world->camera poses p = R_i X the gauge is a RIGHT
    factor R_i -> R_i G^-1, so R_est is aligned by the best-fit B
    (Procrustes on sum R_est^T R_gt) applied as R_est[i] @ B; also the
    frame-0-anchored variant (B = R_est[0]^T R_gt[0])."""
    R_est = angle_axis_matrices(np.asarray(poses, np.float64)[:, :3])
    R_gt = np.asarray(R_gt, np.float64)
    M = np.einsum("nji,njk->ik", R_est, R_gt)  # sum R_est^T R_gt
    u, _, vt = np.linalg.svd(M)
    B = u @ np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt))]) @ vt
    B0 = R_est[0].T @ R_gt[0]
    e, e0 = [], []
    for i in range(len(R_gt)):
        cv = (np.trace(R_gt[i].T @ (R_est[i] @ B)) - 1) / 2
        e.append(np.degrees(np.arccos(np.clip(cv, -1, 1))))
        cv0 = (np.trace(R_gt[i].T @ (R_est[i] @ B0)) - 1) / 2
        e0.append(np.degrees(np.arccos(np.clip(cv0, -1, 1))))
    return np.asarray(e), np.asarray(e0)


def ate_summary(errs):
    return dict(mean=float(errs.mean()), median=float(np.median(errs)),
                p90=float(np.percentile(errs, 90)), max=float(errs.max()))


def sequence_launch_shapes(cfg, height, width):
    """The K1 / K2 plan keys and K3 banks (pairs, queries, train rows) that
    run_sequence at height x width under cfg can launch: a front-end pass
    of 1 to BATCH_CHUNK pairs on its band ladder (odometry passes and
    their remainder, the closures, the warm-up prefix) and, under the auto
    ladder, a dense re-run of 1 to BATCH_CHUNK pairs."""
    require(twoview.BATCH_CHUNK > 0, "run_two_view_batch's default chunk must be positive")
    fc = cfg.frontend
    ladders = {"parity": [fc.band_pitches_deg], "dense": [DENSE_BAND_PITCHES],
               "auto": [fc.band_pitches_deg, DENSE_BAND_PITCHES]}[fc.band_ladder]
    keys, banks = set(), set()
    for pitches in ladders:
        k = len(pitches) * cfg.surf.max_keypoints
        for p in range(1, twoview.BATCH_CHUNK + 1):
            keys.add((2 * len(pitches) * p, height // 4, width, cfg.surf.n_octaves,
                      cfg.surf.n_octave_layers))
            banks.add((p, k, k))
    return keys, banks
