"""GPU smoke run of the PyTorch + CUDA port (spherical_bundle_adjuster_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (H100, sm_90a) and nvcc; there is no CPU path, and
without a card the script exits non-zero before printing any result.
Phases, each printing its own line:

  0. device: the card's name and power limit (nvidia-smi);
  1. build: nvcc compiles the port's CUDA sources into its build directory;
  2. kernels: K1 (det pyramid) and K2 (Haar / trace maps), bit-identical
     to their plain PyTorch versions, and K3 (top-2 matcher) within its
     tolerance, at the slice's shapes (the 8 bands of one 1024x2048 pair;
     2048 x 2048 x 64 descriptor banks; for K3 also exact ties planted
     across its lanes and blocks, a ragged 1000 x 2100 bank, an
     all-invalid bank, the 64-pair batch and the 2K dense ladder's 4096 x
     4096 banks), with times for each kernel,
     its plain version and, for K3, one library call (cdist + topk), and
     each kernel's bound (bytes or fp32 operations over the H100's
     peaks); K1 and K2 also at every band count that the 512x1024 phases
     launch (BAND_LAUNCHES), the 2K dense ladder's 16 bands, the 2K ERP
     images and the 2K cube strips, and
     K1 / K2 and K3 at every shape that phase 13 can launch
     (sequence_launch_shapes: passes of 1 to 16 pairs on each run's
     ladders, bands of 64 x 512 and 128 x 1024, banks of 256, 512 and 1024
     descriptors a side);
  2b. lm_trips: the LM trip kernels (ops/cuda_lm, csrc/lm_trip.cu) of
     the depth, rotation and translation stages at the cells' shapes
     (leading axes () and (4,) at 1024 matches, (64,) and (64, 4) at
     512), in compat and corrected mode, on a noisy synthetic scene: one
     trip from the same state against lm._trip, and each whole stage
     solve against lm._lm_eager, bit for bit, with the same LM counters,
     no trip run op by op, and each kernel's launches (one a trip, and
     POINT / SETTLE once more a solve for its initial evaluation); with
     the device time of one trip, kernels and op by op;
  3. slice: run_two_view(..., frontend="band") on 4 synthetic 1024x2048
     rotation pairs under the 2K bench config (compat BA), with the
     kernels' launch counts (K1-K3 and the LM trip kernels) and the
     bench's 2K compat gates;
  4. slice_2k_corrected: the same 4 pairs in the bench's corrected mode
     (per-match depths, outlier gates, joint Schur, 4 starts, 240 RANSAC
     trials), with launch counts and the bench's 2K corrected gates;
  5. pair_512x1024: 4 pairs under the 512 bench config, compat and
     corrected, gated on the bench's 512 gates (the bench takes its
     medians over 16 pairs, this phase over 4);
  6. pitch60_corrected: 2 pairs at pitch 60 deg under the default auto
     band ladder in corrected mode, gated on the bench's pitch-cell gates;
  7. batch_512x1024: run_two_view_batch on 64 pairs under the 512 bench
     config (compat; 16 distinct pairs tiled 4x, as the bench's
     make_batch), timed against 64 single-pair calls, with a sweep of
     batch_chunk and one K1 / K2 / K3 launch per chunk; the bench's 512
     compat gates over the 16 distinct pairs; every pair against its
     single-pair run with the same draws (identical match lists, the
     rotation within BATCH_GAP_LIMIT_DEG);
  8. batch_512x1024_auto: 16 pairs (14 easy, 2 sparse scenes at pitch 30
     on the parity ladder's cliff) under the default auto ladder: the
     short pairs, and only they, re-run on the dense ladder in one extra
     launch each;
  9. batch_512x1024_corrected: the 16 distinct pairs in corrected mode as
     one batch, timed against single-pair calls, on the bench's corrected
     512 gates;
 10. frontends_2k: compare_frontends (erp, band, cubemap with cube 600) on
     one 1024x2048 pair, each front end against the port's own CPU run of
     it on the same pair, the band front end on the 2K compat gates;
 11. the global solvers, each on a synthetic problem built in numpy from
     a seed with the JAX tests' recipes and gated on those tests' gates:
     multiview_dense_10kf (solve_multiview, C = 10 keyframes, L = 9216,
     auto -> dense), multiview_pcg_256kf (C = 256, L = 8192, PCG) and
     multiview_pcg_1024kf (C = 1024, L = 131072, PCG); pose_graph_100kf
     (optimize_pose_graph, 100 nodes, 8 closures, auto -> PCG) and
     pose_graph_1024kf (1024 nodes, 64 closures, PCG). Each reports ms
     per solve (median of 3 after a warm-up) and per GN step, CG
     iterations per GN step, torch calls, device kernels, wall ms and
     device-busy ms per CG iteration (CUDA events and torch.profiler over
     16 and 80 iterations), one GN step split into its parts (wall and
     device-busy ms each), the device-busy share of a solve, host syncs
     per solve, peak memory, whether the runs were bit-identical, for the
     256- and 100-keyframe phases the gap to the port's own CPU run, for
     the multiview PCG phases the fixed-order segment sum's time against
     index_add_'s, and for the pose graphs chain_with_loop_closures built
     on the card from numpy odometry (held against its CPU build). These
     phases launch no hand-written kernel: the reference computes them in
     plain XLA;
 12. merged tracks (models/tracks.build_multiview_problem into
     solve_multiview): tracks_10kf (tests/test_tracks' recipe in numpy,
     10 cameras x 1024 match slots a pair) and tracks_1024kf (1024
     cameras x 128 slots), gated on test_ba_beats_pose_graph_only_10_
     frames' gates (at 1024 keyframes, where the JAX package misses
     them, on 1.5x its own errors); tracks_from_odometry: 8 frames
     rendered along a turning, translating trajectory through
     run_two_view_batch (K1, K2, K3), chain_with_loop_closures with a
     closure and weights held on the card, then tracks and the BA, gated
     on links in every pair, frame-k keypoints bit-identical in both
     slots and a falling finite cost. Each build: ms, host syncs (none
     allowed), torch calls, device-busy share, two builds bit-identical
     and the card's build against the port's CPU build of the same
     inputs;
 13. sequence (models/sequence.run_sequence, mesh=None):
     sequence_100kf_orbit, scripts/run_sequence_100.run_orbit rewritten
     for the port: 100 frames at 256x512 of one numpy-seeded scene through
     a 356.4 deg yaw sweep with a 2 deg pitch and roll wobble, corrected
     BA, the default auto ladder, 18 skip and loop closures, gated on the
     slow test's rotation ATE (median < 1 deg, max < 2 deg);
     sequence_10kf, 10 frames along trajectory_poses(10) at 512x1024 in
     the bench's corrected mode with closures (0, 2) and (4, 6) through
     the global BA, gated on the BA having run, the "auto" decision being
     the JAX package's, falling finite cost traces, 1.5x the JAX
     package's BA errors on the same frames, and the same ATE bounds
     where the JAX package meets them, else 1.5x its ATE (it misses the
     median bound here, on the final and the pose-graph poses). Each: a
     warm-up on the first 8 frames, then the timed run (CUDA events, peak
     memory, launch counts), then a run with per-stage CUDA events and
     host syncs; every K1 / K2 / K3 launch's shape must be one phase 2
     checked;
 14. distributed (parallel/mesh, parallel/dist_ba on torch.distributed;
     NCCL refuses two ranks on one card, so NCCL runs one rank and gloo
     DIST_WORLD ranks that share the card, spawned once, every tensor on
     the card, a process-group timeout and a deadline for the whole run):
     dist_nccl_1rank, multiview_pcg_1024kf's problem on a 1-rank NCCL
     mesh in this process, bit-identical to phase 11's solve;
     dist_multiview_256kf and dist_multiview_1024kf, phase 11's problems
     landmark-sharded over 4 gloo ranks, on phase 11's gates and against
     its solves; dist_batch_2d, two 256-keyframe problems on a 2 x 2 mesh,
     each on the gates; dist_twoview_batch, phase 7's 64-pair batch over 4
     ranks (16 pairs each), every row against phase 7's batch (identical
     match lists, rotation within BATCH_GAP_LIMIT_DEG), K1 / K2 / K3 once a
     rank at shapes phase 2 checked; dist_sequence_10kf, phase 13's
     10-keyframe sequence over 2 ranks on the JAX package's draws, on
     phase 13's gates and against its mesh=None result. Each logs ms per
     solve and per GN step, all-reduce calls and bytes per GN step against
     collective_bytes_per_gn_iter, whether the ranks ended bit-identical,
     peak memory per rank and the backend, beside the card's name and
     power limit. Any rank's failure or timeout fails the script.
 15. entry_point: cli_2k, phase 3's pair 0 written as PNGs through
     utils/io and run through cli.main (the reference's main.cpp parity
     CLI: default auto ladder, --max-matches 1024 --ratio-thresh 0.5) in
     this process with the launch counts set to 0 first, gated on K1 / K2
     / K3 launched at shapes phase 2 checked, the 2K compat rotation and
     match gates, the printed pose bit-identical to run_two_view on the
     PNGs read back, the five files (log.txt one 10-field row, log_d.txt a
     row a match, metrics.jsonl's two_view_ba event, two 1024x2048 PNGs),
     then once as a subprocess (`python -m ...cli`, same log.txt row);
     checkpoint_1024kf, phase 11's 1024-keyframe problem through
     utils/checkpoint.solve_multiview_resumable in 4 rounds of 2
     iterations, interrupted after 2 and resumed, bit-identical to an
     uninterrupted call (poses, landmarks, costs), the cost trace finite
     and falling, with the checkpoint's bytes, save / load ms and the
     errors beside phase 11's; profile_trace, one CLI run under
     utils/profiling.trace, whose Chrome trace must hold both
     tile_kernel ops and top2_kernel, and profiling.device_time of K3 at
     the 2K banks within 25% of phase 2's time (the same event timer) and
     of K3's median kernel duration over 16 calls traced after the CLI
     run (CUPTI's clock); native_oracle, the float64
     oracle of utils/native against the port's epipolar / lm on card
     tensors at tests/test_native.py's bounds where the host library
     builds (else the reason is logged).

Each pipeline phase sets the kernels' launch counts to 0 before its
measured runs and fails if a kernel of the path was not launched; the
pair phases and the 512x1024 batches (compat and corrected) also count
and require the LM trip kernels.

Then one JSON line with every kernel's numbers (K1-K3 under "kernels",
the LM trip kernels' launches by phase under "lm_kernels"), and a last line
{"ok": true, "device": {...}}. Any failed phase raises and exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io as io_lib
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.overrides import TorchFunctionMode

from benchmark.metrics.surf_roofline_pct import K1_OPS_PER_VALID, K2_OPS_PER_VALUE
from benchmark.peaks import PEAK_BYTES_PER_S, PEAK_FP32_PER_S, bound_s
from benchmark.system import sync_counter
from spherical_bundle_adjuster_tpu_torch import cli, kernel_times
from spherical_bundle_adjuster_tpu_torch.core import rotation
from spherical_bundle_adjuster_tpu_torch.models import (
    evaluation, frontend, multiview, sequence, tracks, twoview,
)
from spherical_bundle_adjuster_tpu_torch.ops import (
    cuda_lm, cuda_match, cuda_surf, integral, kernels, segment, warp,
)
from spherical_bundle_adjuster_tpu_torch.parallel import dist_ba, launch
from spherical_bundle_adjuster_tpu_torch.parallel import mesh as mesh_lib
from spherical_bundle_adjuster_tpu_torch.problems import (
    CFG_2K, CFG_512, CUBE_2K, GATE_SEQ_ATE_DEG, LM_SHAPES, MULTIVIEW_PHASES, N_BATCH, N_DISTINCT,
    ODO_SEED, ODO_STEP, ODO_YAW_DEG, POSE_GRAPH_PHASES, SEED, SEQ_10KF_BA_ITERS, SEQ_10KF_CFG,
    SEQ_10KF_CLOSURES, SEQ_10KF_FRAMES, SEQ_10KF_REFERENCE, SEQ_ORBIT_CFG, SEQ_ORBIT_FRAMES,
    SEQ_ORBIT_KW, SEQ_ORBIT_RECORDED_ATE_DEG, SEQ_ORBIT_REFERENCE_ATE_DEG, SEQ_ORBIT_SIZE,
    SEQ_REFERENCE_FACTOR, SEQ_RUNS, SIZE_2K, SIZE_512, TRACKS_H, TRACKS_P, TRACKS_PHASES,
    TRACKS_REFERENCE_ERRORS, TRACKS_REFERENCE_FACTOR, TRACKS_SEED, TRACKS_W, PhaseError,
    angle_axis_matrices, angle_axis_matrix, angle_axis_of, ate, ate_summary, corrected_mode, draws,
    eager_state, landmark_det, log, make_pair, orbit_closures, orbit_frames, pair_of, phase_device,
    pose_errors, printed, problem_gaps, reference_sequence_draws, require, rot_err_deg_host,
    same_matches, scaled_pose_errors, sequence_launch_shapes, shared_cells, solve_stages,
    solver_gates, stacked, stage_problem, stage_systems, synth_multiview, synth_pose_graph,
    synth_tracks, tracks_gates, trajectory_frames, trajectory_poses,
)
from spherical_bundle_adjuster_tpu_torch.solver import epipolar, lm, pose_graph
from spherical_bundle_adjuster_tpu_torch.solver import pcg as pcg_mod
from spherical_bundle_adjuster_tpu_torch.utils import checkpoint, native, profiling, synthetic
from spherical_bundle_adjuster_tpu_torch.utils import io as image_io
from spherical_bundle_adjuster_tpu_torch.utils import logging as port_logging
from spherical_bundle_adjuster_tpu_torch.utils.config import (
    DENSE_BAND_PITCHES, BaConfig, FrontendConfig,
)

# the bench's 2K compat gates (bench.py GATE_2K_*)
GATE_MIN_MATCHES = 40
GATE_MAX_OUTLIER_PCT = 12.5
GATE_MED_ROT_ERR_DEG = 2.5
GATE_MAX_ROT_ERR_DEG = 8.0
# bench.py GATE_2K_*_CORRECT
GATE_2K_MED_ROT_ERR_CORRECT = 0.3
GATE_2K_MAX_ROT_ERR_CORRECT = 1.0
# bench.py's 512x1024 gates (GATE_MIN_MATCHES .. GATE_MAX_ROT_ERR_CORRECT)
GATE_512 = dict(min_matches=40, max_outlier_pct=10.0, max_trim_err_deg=1.0,
                compat=(2.5, 11.5), corrected=(0.2, 0.5))
# bench.py's pitch-cell gates at pitch 60 (GATE_CELL_*)
GATE_CELL_MIN_MATCHES = 10
GATE_CELL_MAX_OUTLIER_PCT = 25.0
GATE_CELL_MAX_ROT_ERR_DEG = 1.0
N_PAIRS_2K = 4
N_PAIRS_512 = 4
N_PAIRS_PITCH = 2
CHUNKS = (8, 16, 32, 0)  # the batch_chunk sweep (0: the whole batch a pass)
# The parity ladder's intermediate-pitch cliff: pitch 30 deg. At 512x1024
# the default 96-disc scenes still find more than auto_min_matches parity
# matches there (the auto phase logs them), so the cliff pairs are
# rendered with a quarter of the discs.
CLIFF_EULER_DEG = (0.0, 30.0, 0.0)
CLIFF_DISCS = 24
PITCH_SEED = 77
# A batch row's rotation against its single run with the same matches and
# draws: 1.2x the largest gap over the 64 pairs of the compat batch,
# 0.4865 deg (card_rounding.py on an NVIDIA H100 80GB HBM3 at 700 W;
# PERF.md). The batched einsum of the consensus stage rounds differently
# at another batch size, and compat's BCD carries the start.
BATCH_GAP_LIMIT_DEG = 1.2 * 0.4865
N_AUTO_SHORT = 2  # the auto batch's pairs that fall short on the parity ladder
ODO_FRAMES = 8  # tracks_from_odometry's rendered frames: 7 consecutive pairs
# Bands of 128 x 1024 per K1 / K2 launch in the 512x1024 phases: one pair
# on the parity and on the dense ladder, the auto batch's dense re-run of
# its short pairs, a pass of each swept batch_chunk, and the odometry
# batch's consecutive pairs in one pass.
_PARITY_BANDS = 2 * len(CFG_512.frontend.band_pitches_deg)
_ODO_BANDS = _PARITY_BANDS * min(ODO_FRAMES - 1, twoview.BATCH_CHUNK or ODO_FRAMES - 1)
BAND_LAUNCHES = sorted({_PARITY_BANDS, 2 * len(DENSE_BAND_PITCHES),
                        2 * len(DENSE_BAND_PITCHES) * N_AUTO_SHORT,
                        *(_PARITY_BANDS * (c or N_BATCH) for c in CHUNKS), _ODO_BANDS})


def time_ms(fn, iters=10):
    """Mean device time of fn() in ms: CUDA events around back-to-back
    calls queued behind a GPU spin (profiling.device_ms)."""
    return profiling.device_ms(fn, iters)[0]


def outlier_pct_host(out, R_gt, width, height):
    """Outlier % at 2 deg of the matched pairs (evaluate_matches' KPI):
    angle(R_gt b_left, b_right), on the host in float64."""
    v = out.match_valid.cpu().numpy()
    def bearing(xy):
        xy = np.asarray(xy, np.float64)
        th = np.pi * xy[:, 1] / height
        ph = 2 * np.pi * xy[:, 0] / width
        return np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], -1)
    bl = bearing(out.left_xy.cpu().numpy()[v]) @ np.asarray(R_gt, np.float64).T
    br = bearing(out.right_xy.cpu().numpy()[v])
    ang = np.arctan2(np.linalg.norm(np.cross(bl, br), axis=-1), np.sum(bl * br, -1))
    return 100.0 * float(np.mean(ang > np.deg2rad(2.0))) if v.sum() else 0.0


def phase_build():
    lib = kernels.build(verbose=True)
    kernels.library()
    log("build", seconds=kernels.build_seconds, library=lib.name)


def bound(n_bytes, n_ops):
    """The least time in ms for moving n_bytes and doing n_ops fp32
    operations on the card (benchmark/peaks.py), and which of the two
    sets it."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S >= n_ops / PEAK_FP32_PER_S
    return dict(bound_ms=1e3 * bound_s(n_bytes, n_ops),
                bound_by="bytes" if by_bytes else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs_err(got, want):
    """Largest |got - want| over the values finite in both; inf where the
    two differ in which values are finite."""
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        return float("inf")
    return (got[fin] - want[fin]).abs().max().item() if bool(fin.any()) else 0.0


# Worst-case rounding of one fp32 d2 = |q|^2 + |t|^2 - 2 q.t of unit 64-d
# descriptors: 64 products in each sum, |q|^2 + |t|^2 + 2|q.t| <= 4.
K3_TIE_D2 = 4 * 64 * 2.0**-24


def k3_splits(q, t, v, idx, pidx):
    """Every query whose K3 indices differ from the plain version's
    (banks with or without a leading pair axis), with the squared
    distances at both index pairs: as the plain version rounds them (its
    query chunk recomputed) and exact (float64, +inf at an invalid slot),
    and `gap`, the largest difference of exact d2 between the two picks
    of one rank. K3 sums the 64 products in order with fmaf and the plain
    version through a matmul, so a query whose exact d2 of two train rows
    lie within K3_TIE_D2 may be split either way."""
    if q.ndim == 2:
        q, t, v, idx, pidx = q[None], t[None], v[None], idx[None], pidx[None]
    out = []
    for p, i in (idx != pidx).any(-1).nonzero().tolist():
        picks = {"kernel": idx[p, i].long(), "plain": pidx[p, i].long()}
        tf = t[p].float()
        i0 = i - i % cuda_match._CHUNK
        qc = q[p, i0:i0 + cuda_match._CHUNK].float()
        row = torch.clamp((qc * qc).sum(-1, keepdim=True) + (tf * tf).sum(-1)
                          - 2.0 * (qc @ tf.T), min=0.0)[i - i0]
        exact = ((q[p, i].double() - t[p].double()) ** 2).sum(-1)
        exact = torch.where(v[p], exact, torch.inf)
        rec = dict(pair=p, query=i)
        for who, j in picks.items():
            rec[f"{who}_idx"] = j.tolist()
            rec[f"{who}_plain_d2"] = row[j].tolist()
            rec[f"{who}_exact_d2"] = exact[j].tolist()
        rec["gap"] = (exact[picks["kernel"]] - exact[picks["plain"]]).abs().max().item()
        out.append(rec)
    return out


def k3_agrees(name, q, t, v, dist, idx):
    """K3's (dist, idx) against the plain version on the same banks:
    distances within 2e-3, indices identical but where k3_splits finds a
    split within K3_TIE_D2 (each split logged). Returns (max_abs_err,
    number of splits)."""
    pdist, pidx = cuda_match.top2_distances_plain(q, t, v)
    err = max_abs_err(dist, pdist)
    require(err <= 2e-3, f"K3 {name}: distances differ by {err}")
    splits = k3_splits(q, t, v, idx, pidx)
    for s in splits:
        log("k3_split", bank=name, tie_d2=K3_TIE_D2, **s)
    require(all(s["gap"] <= K3_TIE_D2 for s in splits),
            f"K3 {name}: indices differ beyond a rounding tie: {splits}")
    return err, len(splits)


def phase_kernels(dev):
    """Each kernel against its plain version at the slice's shapes."""
    left, right, _ = make_pair(0, *SIZE_2K, dev)
    bands = frontend.crop_bands(left[None], right[None], CFG_2K,
                                CFG_2K.frontend.band_pitches_deg)[0]
    ii = integral.integral_image(bands)  # (8, 257, 2049)
    ii64 = torch.cumsum(torch.cumsum(bands.double(), dim=-2), dim=-1)
    max_abs = ii64.abs().max().item()
    err = (ii[:, 1:, 1:].double() - ii64).abs().max().item()
    # the bound that test_torch_surf.py's det tolerance assumes of each package
    ii_bound = 2 * float(np.finfo(np.float32).eps) * max_abs
    # float64 prefix sums rounded once: half a float32 ulp of max|ii|
    half_ulp = 0.5 * float(np.spacing(np.float32(max_abs)))
    log("integral_image", shape=list(ii.shape), max_abs=max_abs, max_abs_err_vs_float64=err,
        cpu_test_bound=ii_bound, within_cpu_test_bound=err <= ii_bound,
        half_ulp_bound=half_ulp, within_half_ulp=err <= half_ulp)
    require(err <= ii_bound, f"integral_image errs {err} > the CPU tests' bound {ii_bound}")
    require(err <= half_ulp, f"integral_image errs {err} > half an ulp of max|ii| ({half_ulp})")
    del ii64
    scfg = CFG_2K.surf
    rows = []
    no_library = dict(library_ms=None, library="no single PyTorch call computes it")

    # K1: all octaves of one pair's pyramid, one launch
    got = cuda_surf.det_pyramid_cuda(ii, scfg)
    torch.cuda.synchronize()
    n_bytes, n_ops, err = nbytes(ii), 0, 0.0
    for o, (k, p) in enumerate(zip(got, cuda_surf.det_pyramid_plain(ii, scfg))):
        require(torch.equal(k, p), f"K1 octave {o}: not bit-identical to its plain version")
        err = max(err, max_abs_err(k, p))
        n_bytes += nbytes(k)
        n_ops += K1_OPS_PER_VALID * int(torch.isfinite(p).sum())
    rows.append(dict(
        name="det_pyramid", route="cuda", source="spherical_bundle_adjuster_tpu_torch/csrc/surf_maps.cu",
        replaces="spherical_bundle_adjuster_tpu/ops/pallas_surf.py:95", max_abs_err=err,
        ms=time_ms(lambda: cuda_surf.det_pyramid_cuda(ii, scfg)),
        plain_ms=time_ms(lambda: cuda_surf.det_pyramid_plain(ii, scfg)),
        **bound(n_bytes, n_ops), **no_library,
        tolerance="bit-identical (torch.equal, -inf mask included), every octave",
    ))

    # K2
    hx, hy, tr = cuda_surf.haar_trace_maps_cuda(ii, scfg)
    torch.cuda.synchronize()
    px, py, pt = cuda_surf.haar_trace_maps_plain(ii, scfg)
    for a, b, n in ((hx, px, "hx"), (hy, py, "hy"), (tr, pt, "trace sign")):
        require(torch.equal(a, b), f"K2 {n}: not bit-identical to its plain version")
    rows.append(dict(
        name="haar_trace_maps", route="cuda", source="spherical_bundle_adjuster_tpu_torch/csrc/surf_maps.cu",
        replaces="spherical_bundle_adjuster_tpu/ops/pallas_surf.py:145",
        max_abs_err=max(max_abs_err(a, b) for a, b in ((hx, px), (hy, py), (tr, pt))),
        ms=time_ms(lambda: cuda_surf.haar_trace_maps_cuda(ii, scfg)),
        plain_ms=time_ms(lambda: cuda_surf.haar_trace_maps_plain(ii, scfg)),
        **bound(nbytes(ii, hx, hy, tr), K2_OPS_PER_VALUE * hx.numel()), **no_library,
        tolerance="bit-identical (torch.equal) hx, hy and trace sign",
    ))
    del hx, hy, tr, px, py, pt

    # K1 and K2 at every other launch shape of the path: their plans tile
    # by the launch's size (_max_outputs), so each band count of 128 x
    # 1024 bands that the 512x1024 phases launch is checked (BAND_LAUNCHES:
    # one pair's parity and dense ladders, the auto batch's dense re-run,
    # a pass of each swept batch_chunk, the odometry batch's 7 pairs; the
    # first bands of the 64-pair
    # batch's crops), then the ERP images and cube strips of one 2K pair
    h5, w5 = SIZE_512
    batch_pairs = [make_pair(i, h5, w5, dev) for i in range(N_DISTINCT)]
    lefts, rights = (x.repeat(N_BATCH // N_DISTINCT, 1, 1, 1) for x in stacked(batch_pairs))
    bands5 = frontend.crop_bands(lefts, rights, CFG_512,
                                 CFG_512.frontend.band_pitches_deg).flatten(0, 1)
    del lefts, rights, batch_pairs
    launches = [(f"{n} bands of 128 x 1024", bands5[:n], CFG_512.surf) for n in BAND_LAUNCHES]
    # the 2K pair's dense ladder: phase 15's CLI runs the default auto
    # ladder, which re-runs a pair short of matches on it
    launches += [
        ("2K dense ladder's 16 bands of 256 x 2048",
         frontend.crop_bands(left[None], right[None], CFG_2K, DENSE_BAND_PITCHES)[0], scfg),
        ("2K ERP images", integral.rgb_to_gray(torch.stack([left, right])), scfg),
        ("2K cube strips", torch.stack([warp.equi_to_cubemap(integral.rgb_to_gray(im), CUBE_2K)
                                        for im in (left, right)]), scfg)]
    shapes = []
    checked = dict(surf=set(), top2=set())  # what this phase held against plain
    checked["surf"].add(surf_key(ii, scfg))  # the 8 bands above

    def k1_k2_case(name, images, surf_cfg):
        iib = integral.integral_image(images)
        for o, (k, p) in enumerate(zip(cuda_surf.det_pyramid_cuda(iib, surf_cfg),
                                       cuda_surf.det_pyramid_plain(iib, surf_cfg))):
            require(torch.equal(k, p), f"K1 at the {name}, octave {o}: not its plain version")
        for k, p in zip(cuda_surf.haar_trace_maps_cuda(iib, surf_cfg),
                        cuda_surf.haar_trace_maps_plain(iib, surf_cfg)):
            require(torch.equal(k, p), f"K2 at the {name}: not its plain version")
        checked["surf"].add(surf_key(iib, surf_cfg))

    for name, images, surf_cfg in launches:
        k1_k2_case(name, images, surf_cfg)
        shapes.append(dict(name=name, bands=list(images.shape)))
    del bands5, launches
    log("kernel_shapes", bit_identical_k1_k2=shapes)

    # K1 / K2 at every plan key that phase 13's run_sequence calls can
    # launch (sequence_launch_shapes: passes of 1-16 pairs on the parity
    # and the dense ladder), on dense-ladder bands cropped from pairs at
    # each run's size; K3 at its banks further down
    seq_banks = set()
    for run, cfg, (hh, ww) in SEQ_RUNS:
        keys, banks = sequence_launch_shapes(cfg, hh, ww)
        seq_banks |= banks
        n_pairs = -(-max(k[0] for k in keys) // (2 * len(DENSE_BAND_PITCHES)))
        pairs = [make_pair(i, hh, ww, dev) for i in range(n_pairs)]
        dense_bands = frontend.crop_bands(*stacked(pairs), cfg, DENSE_BAND_PITCHES).flatten(0, 1)
        del pairs
        for key in sorted(keys - checked["surf"]):
            k1_k2_case(f"{run}'s {key[0]} bands of {hh // 4} x {ww}", dense_bands[:key[0]],
                       cfg.surf)
        del dense_bands
    log("kernel_shapes_sequence", bit_identical_k1_k2=sorted(checked["surf"]))

    # K3: 2048 x 2048 x 64 banks, ~10% invalid train slots
    g = torch.Generator(dev).manual_seed(SEED)
    d1 = torch.nn.functional.normalize(torch.randn(2048, 64, device=dev, generator=g), dim=-1)
    d2 = torch.nn.functional.normalize(torch.randn(2048, 64, device=dev, generator=g), dim=-1)
    v2 = torch.rand(2048, device=dev, generator=g) > 0.1

    splits = {}

    def k3_case(name, q, t, v):
        """K3 against its plain version (k3_agrees); returns (dist, idx,
        max_abs_err)."""
        dist, idx = cuda_match.top2_distances_cuda(q, t, v)
        torch.cuda.synchronize()
        err, splits[name] = k3_agrees(name, q, t, v, dist, idx)
        return dist, idx, err

    dist, idx, err = k3_case("2048 x 2048", d1, d2, v2)
    # exact duplicates of query 0 in two lanes of one sub-tile and in other
    # blocks of its query tile, of query 1 across blocks with one invalid
    tied, tv = d2.clone(), v2.clone()
    tied[[1, 16, 1025, 2047]] = d1[0]
    tied[[6, 700, 1500, 2046]] = d1[1]
    tv[[1, 16, 1025, 2047, 6, 1500, 2046]] = True
    tv[700] = False
    _, tidx, terr = k3_case("ties", d1, tied, tv)
    require(tidx[0].tolist() == [1, 16] and tidx[1].tolist() == [6, 1500],
            f"K3 ties: {tidx[:2].tolist()} instead of [[1, 16], [6, 1500]]")
    # a ragged bank: 1000 queries, 2100 train rows
    rq = torch.nn.functional.normalize(torch.randn(1000, 64, device=dev, generator=g), dim=-1)
    rt = torch.nn.functional.normalize(torch.randn(2100, 64, device=dev, generator=g), dim=-1)
    _, _, rerr = k3_case("1000 x 2100", rq, rt, torch.rand(2100, device=dev, generator=g) > 0.1)
    inv, inv_idx = cuda_match.top2_distances_cuda(d1, d2, torch.zeros_like(v2))
    torch.cuda.synchronize()
    require(bool(torch.isinf(inv).all()) and not bool(inv_idx.any()),
            "K3 all-invalid bank did not give (inf, index 0)")

    def library_top2():  # the yardstick only: the port never calls it
        return torch.topk(torch.cdist(d1, d2).masked_fill_(~v2, torch.inf), 2, largest=False)

    # the batch's K3 launch: 64 pairs of 1024 x 1024 banks (4 bands x 256
    # keypoints a side), each pair bit-identical to its own launch
    bq = torch.nn.functional.normalize(torch.randn(N_BATCH, 1024, 64, device=dev, generator=g), dim=-1)
    bt = torch.nn.functional.normalize(torch.randn(N_BATCH, 1024, 64, device=dev, generator=g), dim=-1)
    bv = torch.rand(N_BATCH, 1024, device=dev, generator=g) > 0.1
    bdist, bidx = cuda_match.top2_distances_cuda(bq, bt, bv)
    torch.cuda.synchronize()
    berr, splits["batched"] = k3_agrees("batched", bq, bt, bv, bdist, bidx)
    for p in range(N_BATCH):
        one_d, one_i = cuda_match.top2_distances_cuda(bq[p], bt[p], bv[p])
        require(torch.equal(one_d, bdist[p]) and torch.equal(one_i, bidx[p]),
                f"batched K3: pair {p} differs from its own launch")

    # the 2K dense ladder's banks (8 bands x 512 keypoints a side)
    dq = torch.nn.functional.normalize(torch.randn(4096, 64, device=dev, generator=g), dim=-1)
    dt = torch.nn.functional.normalize(torch.randn(4096, 64, device=dev, generator=g), dim=-1)
    k3_case("4096 x 4096", dq, dt, torch.rand(4096, device=dev, generator=g) > 0.1)
    del dq, dt

    # the banks above, and each pair of the batch launched alone
    checked["top2"] |= {(1, 2048, 2048), (1, 1000, 2100), (N_BATCH, 1024, 1024), (1, 1024, 1024),
                        (1, 4096, 4096)}

    # K3 at every bank that phase 13 can launch: P = 1..16 pairs of k x k
    # banks, each P the first P pairs of one 16-pair draw
    for k in sorted({b[1] for b in seq_banks}):
        sq = torch.nn.functional.normalize(torch.randn(16, k, 64, device=dev, generator=g), dim=-1)
        st = torch.nn.functional.normalize(torch.randn(16, k, 64, device=dev, generator=g), dim=-1)
        sv = torch.rand(16, k, device=dev, generator=g) > 0.1
        for p in sorted(b[0] for b in seq_banks if b[1] == k):
            k3_case(f"({p}, {k}, {k})", sq[:p], st[:p], sv[:p])
            checked["top2"].add((p, k, k))
        del sq, st, sv
    log("kernel_banks_sequence", k3_within_tolerance=sorted(checked["top2"]),
        k3_index_splits={n: c for n, c in splits.items() if c}, k3_tie_d2=K3_TIE_D2)

    def library_batched():
        return torch.topk(torch.cdist(bq, bt).masked_fill_(~bv[:, None, :], torch.inf), 2,
                          largest=False)

    batched = dict(
        shape=[N_BATCH, 1024, 1024, 64], max_abs_err=berr,
        identical_per_pair="every pair bit-identical to a launch of that pair alone",
        ms=time_ms(lambda: cuda_match.top2_distances_cuda(bq, bt, bv)),
        plain_ms=time_ms(lambda: cuda_match.top2_distances_plain(bq, bt, bv), iters=3),
        library_ms=time_ms(library_batched),
        **bound(nbytes(bq, bt, bv, bdist, bidx), 2 * N_BATCH * 1024 * 1024 * 64),
    )
    del bq, bt, bv

    rows.append(dict(
        name="top2_distances", route="cuda", source="spherical_bundle_adjuster_tpu_torch/csrc/match_top2.cu",
        replaces="spherical_bundle_adjuster_tpu/ops/pallas_match.py:89",
        max_abs_err=err, max_abs_err_ties=terr, max_abs_err_ragged=rerr,
        ms=time_ms(lambda: cuda_match.top2_distances_cuda(d1, d2, v2)),
        plain_ms=time_ms(lambda: cuda_match.top2_distances_plain(d1, d2, v2)),
        **bound(nbytes(d1, d2, v2, dist, idx), 2 * d1.shape[0] * d2.shape[0] * d1.shape[1]),
        library_ms=time_ms(library_top2), library="torch.cdist + torch.topk(2, largest=False)",
        tolerance="identical indices but at rounding ties (exact d2 of both picks within "
                  "K3_TIE_D2); distance atol 2e-3 (2048 x 2048, planted ties, 1000 x 2100, the "
                  "64-pair batch, 4096 x 4096, the sequence banks); all-invalid gives (inf, "
                  "index 0)",
        index_splits=sum(splits.values()),
        batched=batched,
    ))
    for r in rows:
        log("kernel", **r)
    return rows, checked


LM_STATE = ("x", "H", "g", "cost", "cost_s", "lam", "it", "done")


def phase_lm(dev):
    """The LM trip kernels against the loop run op by op, at the cells'
    shapes in both modes: one trip from the same state against lm._trip
    and whole stage solves against lm._lm_eager, bit for bit, with equal
    LM counters and each kernel's launches; the device time of one trip.
    Returns one row per (shape, mode, stage)."""
    cfg = BaConfig()
    rows = []

    def no_trip_op_by_op(*args):
        raise PhaseError("an LM trip ran op by op on the card")

    for lead, m in LM_SHAPES:
        prob = stage_problem(lead, m, seed=7, dev=dev)
        for compat in (True, False):
            mode = "compat" if compat else "corrected"
            trip_rows = {}
            for stage, system, problem, x0, kept, lower in stage_systems(prob, cfg, compat):
                step, state = eager_state(system, x0, cfg, lower, 3)
                ref = step(state)
                got = tuple(t.clone() for t in state)
                counts = torch.zeros(2, dtype=torch.int32, device=dev)
                trips = cuda_lm.Trips(problem, got, cfg, lower, kept)
                trips.run(counts)
                for name, a, b in zip(LM_STATE, got, ref):
                    require(torch.equal(a, b), f"LM {stage} trip at {lead}x{m} {mode}: {name} "
                            f"differs from lm._trip in {int((a != b).sum())} values")
                every = torch.ones_like(ref[-1])
                want = lm._active(ref[-1], torch.stack([every, every if kept is None else kept]))
                require(counts.tolist() == want.tolist(),
                        f"LM {stage} trip at {lead}x{m} {mode}: counts {counts.tolist()}, "
                        f"lm._trip's {want.tolist()}")
                trip_rows[stage] = dict(kernel_trip_ms=time_ms(lambda: trips.run(counts)),
                                        op_by_op_trip_ms=time_ms(lambda: step(state)))
            ref = solve_stages(prob, cfg, compat, lm._lm_eager)
            before = [k.launches for k in LM_LAUNCHED]
            real_trip, lm._trip = lm._trip, no_trip_op_by_op
            try:
                got = solve_stages(prob, cfg, compat, lm.lm_fixed)
            finally:
                lm._trip = real_trip
            grew = [k.launches - b for k, b in zip(LM_LAUNCHED, before)]
            ktrips = {}
            for (stage, res, rep, counts), (_, res_e, rep_e, counts_e) in zip(got, ref):
                require(torch.equal(res, res_e), f"LM {stage} solve at {lead}x{m} {mode}: "
                        f"{int((res != res_e).sum())} values differ from lm._lm_eager")
                for name, a, b in zip(lm.StageReport._fields, rep, rep_e):
                    require(torch.equal(a, b), f"LM {stage} solve at {lead}x{m} {mode}: "
                            f"StageReport.{name} differs from lm._lm_eager")
                ktrips[stage] = counts.pop(f"lm.{stage}.kernel_trips", 0)
                require(counts == counts_e, f"LM {stage} solve at {lead}x{m} {mode}: counters "
                        f"{dict(counts)}, lm._lm_eager's {dict(counts_e)}")
                syncs = counts[f"lm.{stage}.syncs"]
                require(ktrips[stage] in (syncs - 1, cfg.max_iterations),
                        f"LM {stage} solve at {lead}x{m} {mode}: {ktrips[stage]} kernel trips "
                        f"for {syncs} host reads")
                rows.append(dict(lead=list(lead), matches=m, mode=mode, stage=stage,
                                 kernel_trips=ktrips[stage], syncs=syncs,
                                 iterations_max=int(rep.iterations.max()), **trip_rows[stage]))
            depth, others = ktrips["depth"], ktrips["rot"] + ktrips["tran"]
            want = [depth + 1, depth + 1, others, others + 2, others + 2]
            require(grew == want, f"LM solves at {lead}x{m} {mode}: launches "
                    f"{dict(zip(lm_launches(), grew))}, expected {want}")
    log("lm_trips", bit_for_bit=True, rows=rows,
        note="kernel trips and solves equal lm._trip / lm._lm_eager bit for bit; "
        "trip ms: device time of one trip of every problem left in the state after 3 "
        "trips op by op")
    return rows


def run_pair(left, right, cfg, dev, seed, gumbel=None):
    """One run_two_view call and its wall time in ms (CUDA events on the
    current stream; the pipeline syncs the host on its own as it goes)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = twoview.run_two_view(left, right, torch.Generator(dev).manual_seed(seed), cfg,
                               frontend="band", gumbel=gumbel)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_output(out, cfg):
    m = cfg.match.max_matches
    require(out.left_xy.shape == (m, 2) and out.depths.shape == (m, 2), "bad output shapes")
    for name in ("rotation_aa", "translation", "depths", "left_xy", "right_xy"):
        require(bool(torch.isfinite(getattr(out, name)).all()), f"non-finite {name}")
    require(bool(out.ok), "no consensus initial guess")


def phase_slice(dev):
    """The 2K slice: counts reset, 4 pairs, gates."""
    h, w = SIZE_2K
    pairs = [make_pair(i, h, w, dev) for i in range(N_PAIRS_2K)]
    run_pair(pairs[0][0], pairs[0][1], CFG_2K, dev, seed=0)  # warm-up
    results, counts = counted(
        lambda: [run_pair(l, r, CFG_2K, dev, seed=i) for i, (l, r, _) in enumerate(pairs)])
    counts.update(lm_launches())
    for out, _ in results:
        check_output(out, CFG_2K)
    matches = [int(o.num_matches) for o, _ in results]
    outl = [outlier_pct_host(o, R, w, h) for (o, _), (_, _, R) in zip(results, pairs)]
    errs = [rot_err_deg_host(o.rotation_aa.cpu().numpy(), R) for (o, _), (_, _, R) in zip(results, pairs)]
    ms = [t for _, t in results]
    log("slice_2k", pairs=N_PAIRS_2K, launches=counts, matches=matches, outlier_pct=outl,
        rot_err_deg=errs, pair_ms=ms, median_pair_ms=float(np.median(ms)))
    require(all(c > 0 for c in counts.values()), f"a kernel of the path never launched: {counts}")
    require(np.mean(matches) >= GATE_MIN_MATCHES, f"mean matches {np.mean(matches)} < {GATE_MIN_MATCHES}")
    require(np.mean(outl) <= GATE_MAX_OUTLIER_PCT, f"mean outlier% {np.mean(outl)} > {GATE_MAX_OUTLIER_PCT}")
    require(np.median(errs) <= GATE_MED_ROT_ERR_DEG, f"median rot err {np.median(errs)} deg")
    require(max(errs) <= GATE_MAX_ROT_ERR_DEG, f"max rot err {max(errs)} deg")
    return counts


LAUNCHED = (cuda_surf.DET_PYRAMID, cuda_surf.HAAR_TRACE, cuda_match.TOP2)
LM_LAUNCHED = cuda_lm.KERNELS


def lm_launches():
    """{LM trip kernel symbol: launches} since `counted` set them to 0."""
    return {k.symbol: k.launches for k in LM_LAUNCHED}


def run_counted(pairs, cfg, dev):
    """One run_two_view per pair with every launch count set to 0 first;
    returns ([(out, ms)], {kernel symbol: launches}), the LM trip kernels
    included."""
    results, counts = counted(
        lambda: [run_pair(l, r, cfg, dev, seed=i) for i, (l, r, _) in enumerate(pairs)])
    counts.update(lm_launches())
    require(all(c > 0 for c in counts.values()), f"a kernel of the path never launched: {counts}")
    return results, counts


def accuracy(results, pairs, cfg, height, width):
    """Per pair: matches, outlier % and 10%-trimmed error (deg) through
    the port's evaluate_matches, and the rotation error (deg, host f64)."""
    rows = []
    for (out, _), (_, _, R) in zip(results, pairs):
        check_output(out, cfg)
        fr = frontend.FrontendResult(out.left_xy, out.right_xy, out.match_valid,
                                     out.match_distance, out.total_keypoints)
        ev = evaluation.evaluate_matches(fr, torch.as_tensor(R, dtype=torch.float32,
                                                             device=out.left_xy.device),
                                         width, height, cfg)
        rows.append(dict(matches=int(ev.num_matches), outlier_pct=float(ev.outlier_pct),
                         trim_err_deg=math.degrees(float(ev.trimmed_mean_err_rad)),
                         rot_err_deg=rot_err_deg_host(out.rotation_aa.cpu().numpy(), R)))
    return {k: [r[k] for r in rows] for k in rows[0]}


def starts(results):
    return dict(start=[int(o.telemetry.start) for o, _ in results],
                rot_dominant=[bool(o.telemetry.rot_dominant) for o, _ in results])


def phase_2k_corrected(dev):
    """The 2K slice's 4 pairs in corrected mode, against the bench's 2K
    corrected gates."""
    h, w = SIZE_2K
    cfg = corrected_mode(CFG_2K)
    pairs = [make_pair(i, h, w, dev) for i in range(N_PAIRS_2K)]
    run_pair(pairs[0][0], pairs[0][1], cfg, dev, seed=0)  # warm-up
    results, counts = run_counted(pairs, cfg, dev)
    acc = accuracy(results, pairs, cfg, h, w)
    ms = [t for _, t in results]
    log("slice_2k_corrected", pairs=N_PAIRS_2K, launches=counts, **acc, **starts(results),
        pair_ms=ms, median_pair_ms=float(np.median(ms)))
    errs = acc["rot_err_deg"]
    require(np.mean(acc["matches"]) >= GATE_MIN_MATCHES, f"mean matches {np.mean(acc['matches'])}")
    require(np.mean(acc["outlier_pct"]) <= GATE_MAX_OUTLIER_PCT,
            f"mean outlier% {np.mean(acc['outlier_pct'])} > {GATE_MAX_OUTLIER_PCT}")
    require(np.median(errs) <= GATE_2K_MED_ROT_ERR_CORRECT, f"median rot err {np.median(errs)} deg")
    require(max(errs) <= GATE_2K_MAX_ROT_ERR_CORRECT, f"max rot err {max(errs)} deg")
    return counts


def phase_512(dev):
    """4 pairs under the 512 bench config, compat and corrected, against
    the bench's 512 gates (its medians are over 16 pairs, these over 4)."""
    h, w = SIZE_512
    pairs = [make_pair(i, h, w, dev) for i in range(N_PAIRS_512)]
    counts = {}
    for mode, cfg in (("compat", CFG_512), ("corrected", corrected_mode(CFG_512))):
        run_pair(pairs[0][0], pairs[0][1], cfg, dev, seed=0)  # warm-up
        results, counts[mode] = run_counted(pairs, cfg, dev)
        acc = accuracy(results, pairs, cfg, h, w)
        ms = [t for _, t in results]
        med_gate, max_gate = GATE_512[mode]
        errs = acc["rot_err_deg"]
        log("pair_512x1024", mode=mode, pairs=N_PAIRS_512, launches=counts[mode], **acc,
            **starts(results), pair_ms=ms, median_pair_ms=float(np.median(ms)),
            note=f"median over {N_PAIRS_512} pairs (the bench takes it over 16)")
        require(np.mean(acc["matches"]) >= GATE_512["min_matches"],
                f"512x1024 {mode}: mean matches {np.mean(acc['matches'])}")
        require(np.mean(acc["outlier_pct"]) <= GATE_512["max_outlier_pct"],
                f"512x1024 {mode}: mean outlier% {np.mean(acc['outlier_pct'])}")
        require(np.mean(acc["trim_err_deg"]) <= GATE_512["max_trim_err_deg"],
                f"512x1024 {mode}: mean trimmed error {np.mean(acc['trim_err_deg'])} deg")
        require(np.median(errs) <= med_gate, f"512x1024 {mode}: median rot err {np.median(errs)} deg")
        require(max(errs) <= max_gate, f"512x1024 {mode}: max rot err {max(errs)} deg")
    return counts


def phase_pitch60(dev):
    """2 pairs at pitch 60 +- 1.5 deg (roll and yaw U(-3, 3) deg, as the
    bench's pitch cells draw them) under the default auto band ladder in
    corrected mode, against the bench's pitch-cell gates."""
    h, w = SIZE_512
    cfg = corrected_mode(dataclasses.replace(CFG_512, frontend=FrontendConfig()))
    rng = np.random.default_rng(PITCH_SEED)
    eulers = np.stack([rng.uniform(-3, 3, N_PAIRS_PITCH),
                       60.0 + rng.uniform(-1.5, 1.5, N_PAIRS_PITCH),
                       rng.uniform(-3, 3, N_PAIRS_PITCH)], axis=1)
    pairs = []
    for i, e in enumerate(np.deg2rad(eulers).astype(np.float32)):
        params = synthetic.texture_params_from_numpy(np.random.default_rng(PITCH_SEED + i))
        left, right, R = synthetic.rotation_pair(params, e, h, w, dev)
        pairs.append((left, right, R.cpu().numpy().astype(np.float64)))
    results, counts = run_counted(pairs, cfg, dev)
    acc = accuracy(results, pairs, cfg, h, w)
    log("pitch60_corrected", pairs=N_PAIRS_PITCH, euler_deg=eulers.tolist(), launches=counts,
        **acc, **starts(results), pair_ms=[t for _, t in results])
    require(np.mean(acc["matches"]) >= GATE_CELL_MIN_MATCHES, f"pitch 60: mean matches {acc['matches']}")
    require(np.mean(acc["outlier_pct"]) <= GATE_CELL_MAX_OUTLIER_PCT,
            f"pitch 60: mean outlier% {np.mean(acc['outlier_pct'])}")
    require(max(acc["rot_err_deg"]) <= GATE_CELL_MAX_ROT_ERR_DEG,
            f"pitch 60: max rot err {max(acc['rot_err_deg'])} deg")
    return counts


def counted(fn):
    """fn() with every launch count set to 0 just before it, the LM trip
    kernels' too (lm_launches reads theirs); returns (fn's result,
    {K1-K3 symbol: launches})."""
    for k in LAUNCHED + LM_LAUNCHED:
        k.launches = 0
    out = fn()
    return out, {k.symbol: k.launches for k in LAUNCHED}


def run_batch(lefts, rights, cfg, gumbel, chunk=None):
    """One run_two_view_batch call and its wall time in ms (CUDA events;
    the pipeline syncs the host on its own as it goes)."""
    kw = {} if chunk is None else dict(batch_chunk=chunk)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = twoview.run_two_view_batch(lefts, rights, None, cfg, gumbel=gumbel, **kw)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def singles_ms(pairs, cfg, dev):
    """Wall time (ms) of one run_two_view call per pair, in all."""
    return float(sum(run_pair(l, r, cfg, dev, seed=i)[1] for i, (l, r, _) in enumerate(pairs)))


def gate_512(acc, mode, label):
    med_gate, max_gate = GATE_512[mode]
    errs = acc["rot_err_deg"]
    require(np.mean(acc["matches"]) >= GATE_512["min_matches"],
            f"{label}: mean matches {np.mean(acc['matches'])}")
    require(np.mean(acc["outlier_pct"]) <= GATE_512["max_outlier_pct"],
            f"{label}: mean outlier% {np.mean(acc['outlier_pct'])}")
    require(np.mean(acc["trim_err_deg"]) <= GATE_512["max_trim_err_deg"],
            f"{label}: mean trimmed error {np.mean(acc['trim_err_deg'])} deg")
    require(np.median(errs) <= med_gate, f"{label}: median rot err {np.median(errs)} deg")
    require(max(errs) <= max_gate, f"{label}: max rot err {max(errs)} deg")


def phase_batch(dev):
    """run_two_view_batch at the bench's headline point: 64 pairs (the 16
    distinct pairs tiled 4x) under the 512 config in compat mode."""
    h, w = SIZE_512
    cfg = CFG_512
    pairs = [make_pair(i, h, w, dev) for i in range(N_DISTINCT)]
    lefts, rights = (x.repeat(N_BATCH // N_DISTINCT, 1, 1, 1) for x in stacked(pairs))
    gumbel = draws(cfg, N_BATCH, dev)
    sweep = {}
    for chunk in CHUNKS:
        run_batch(lefts, rights, cfg, gumbel, chunk)  # warm-up
        torch.cuda.reset_peak_memory_stats(dev)
        (out, ms), counts = counted(lambda: run_batch(lefts, rights, cfg, gumbel, chunk))
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        times = [ms] + [run_batch(lefts, rights, cfg, gumbel, chunk)[1] for _ in range(2)]
        passes = -(-N_BATCH // chunk) if chunk else 1
        require(all(c == passes for c in counts.values()),
                f"batch_chunk {chunk}: launches {counts}, expected {passes} each")
        med = float(np.median(times))
        sweep[chunk] = dict(launches=counts, batch_ms=times, median_batch_ms=med,
                            pairs_per_s=1e3 * N_BATCH / med, peak_memory_gb=peak_gb)
    default = twoview.BATCH_CHUNK
    require(default in sweep, f"the default batch_chunk {default} is not in the sweep")
    (out, _), counts = counted(lambda: run_batch(lefts, rights, cfg, gumbel))
    counts.update(lm_launches())
    require(all(c > 0 for c in counts.values()), f"a kernel of the path never launched: {counts}")
    acc = accuracy([(pair_of(out, i), 0.0) for i in range(N_DISTINCT)], pairs, cfg, h, w)
    # every pair against its single-pair run with the same draw row (also
    # the single-pair timing)
    run_pair(lefts[0], rights[0], cfg, dev, seed=0, gumbel=gumbel[0])  # warm-up
    singles = [run_pair(lefts[i], rights[i], cfg, dev, seed=i, gumbel=gumbel[i])
               for i in range(N_BATCH)]
    single = float(sum(ms for _, ms in singles))
    same = [same_matches(one, pair_of(out, i)) for i, (one, _) in enumerate(singles)]
    gaps = [rot_err_deg_host(one.rotation_aa.cpu().numpy(),
                             angle_axis_matrix(out.rotation_aa[i].cpu().numpy()))
            for i, (one, _) in enumerate(singles)]
    init_gaps = [rot_err_deg_host(  # the consensus initial guesses (Euler angles)
        angle_axis_of(one.initial_euler), angle_axis_matrix(angle_axis_of(out.initial_euler[i])))
        for i, (one, _) in enumerate(singles)]
    med = sweep[default]["median_batch_ms"]
    log("batch_512x1024", mode="compat", pairs=N_BATCH, distinct_pairs=N_DISTINCT,
        default_batch_chunk=default, launches=counts, sweep=sweep, median_batch_ms=med,
        pairs_per_s=1e3 * N_BATCH / med, single_pair_calls_ms=single,
        single_pairs_per_s=1e3 * N_BATCH / single, **acc,
        same_matches_as_single=sum(same), rot_gap_to_single_deg=gaps,
        max_rot_gap_to_single_deg=max(gaps), initial_guess_gap_to_single_deg=init_gaps,
        note=f"gates over the {N_DISTINCT} distinct pairs; the rotation gap to single runs "
        "starts at the consensus stage's einsum (the 9x9 normal matrices), whose batched "
        "product rounds differently at another batch size (card_rounding.py)")
    require(all(same), f"batch pairs {[i for i, x in enumerate(same) if not x]}: match list "
            "differs from the single-pair run")
    require(max(gaps) <= BATCH_GAP_LIMIT_DEG, f"batch pair {int(np.argmax(gaps))}: rotation "
            f"{max(gaps)} deg from its single run (limit {BATCH_GAP_LIMIT_DEG})")
    gate_512(acc, "compat", "batch_512x1024")
    return counts, out


def phase_batch_auto(dev):
    """16 pairs under the default auto band ladder (compat): 14 easy pairs
    and 2 sparse scenes at pitch 30, where the parity ladder finds fewer
    than auto_min_matches."""
    h, w = SIZE_512
    n = N_DISTINCT
    cfg = dataclasses.replace(CFG_512, frontend=FrontendConfig())
    parity = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                   band_ladder="parity"))
    pairs = ([make_pair(i, h, w, dev) for i in range(n - 2)]
             + [make_pair(i, h, w, dev, CLIFF_EULER_DEG, CLIFF_DISCS) for i in (n - 2, n - 1)])
    lefts, rights = stacked(pairs)
    gumbel = draws(cfg, n, dev)
    run_batch(lefts, rights, cfg, gumbel)  # warm-up
    par, parity_ms = run_batch(lefts, rights, parity, gumbel)
    # the same two scenes with the default 96 discs stay above the cliff
    dense_scenes = [int(frontend.band_frontend(*make_pair(i, h, w, dev, CLIFF_EULER_DEG)[:2],
                                               parity).match_count) for i in (n - 2, n - 1)]
    n_par = par.num_matches.tolist()
    short = [i for i, c in enumerate(n_par) if c < cfg.frontend.auto_min_matches]
    (out, ms), counts = counted(lambda: run_batch(lefts, rights, cfg, gumbel))
    times = [ms] + [run_batch(lefts, rights, cfg, gumbel)[1] for _ in range(2)]
    chunk = twoview.BATCH_CHUNK or n
    passes = -(-n // chunk) + -(-len(short) // chunk)
    acc = accuracy([(pair_of(out, i), 0.0) for i in range(n)], pairs, cfg, h, w)
    single = singles_ms(pairs, cfg, dev)
    log("batch_512x1024_auto", pairs=n, parity_matches=n_par, dense_rerun_pairs=short,
        single_pair_calls_ms=single, single_pairs_per_s=1e3 * n / single,
        n_dense_fallback_pairs=len(short), parity_matches_with_96_discs=dense_scenes,
        launches=counts, parity_batch_ms=parity_ms,
        batch_ms=times,
        median_batch_ms=float(np.median(times)), pairs_per_s=1e3 * n / float(np.median(times)),
        **acc)
    require(short, f"no pair fell short of auto_min_matches on the parity ladder: {n_par}")
    rerun_bands = 2 * len(DENSE_BAND_PITCHES) * min(len(short), chunk)
    require(rerun_bands in BAND_LAUNCHES, f"the dense re-run launches K1 / K2 on {rerun_bands} "
            "bands, a shape the kernels phase did not check")
    require(all(c == passes for c in counts.values()),
            f"launches {counts}, expected {passes} each (one extra pass for the re-run)")
    for i in range(n):
        if i in short:
            one = twoview.run_two_view(lefts[i], rights[i], None, cfg, gumbel=gumbel[i])
            require(same_matches(one, pair_of(out, i)),
                    f"auto batch pair {i}: not its single-pair auto run's match list")
        else:
            require(same_matches(pair_of(par, i), pair_of(out, i)),
                    f"auto batch pair {i} has {n_par[i]} parity matches but was re-run")
    return counts


def phase_batch_corrected(dev):
    """The 16 distinct pairs in corrected mode as one batch, against the
    bench's corrected 512 gates, timed against single-pair calls."""
    h, w = SIZE_512
    cfg = corrected_mode(CFG_512)
    pairs = [make_pair(i, h, w, dev) for i in range(N_DISTINCT)]
    lefts, rights = stacked(pairs)
    gumbel = draws(cfg, N_DISTINCT, dev)
    run_batch(lefts, rights, cfg, gumbel)  # warm-up
    (out, ms), counts = counted(lambda: run_batch(lefts, rights, cfg, gumbel))
    counts.update(lm_launches())
    require(all(c > 0 for c in counts.values()), f"a kernel of the path never launched: {counts}")
    times = [ms] + [run_batch(lefts, rights, cfg, gumbel)[1] for _ in range(2)]
    acc = accuracy([(pair_of(out, i), 0.0) for i in range(N_DISTINCT)], pairs, cfg, h, w)
    single = singles_ms(pairs, cfg, dev)
    med = float(np.median(times))
    log("batch_512x1024_corrected", pairs=N_DISTINCT, launches=counts, batch_ms=times,
        median_batch_ms=med, pairs_per_s=1e3 * N_DISTINCT / med, single_pair_calls_ms=single,
        single_pairs_per_s=1e3 * N_DISTINCT / single, **acc, **starts(
            [(pair_of(out, i), 0.0) for i in range(N_DISTINCT)]))
    gate_512(acc, "corrected", "batch_512x1024_corrected")
    return counts


def shared_matches(a, b):
    """Matches of front-end result a whose pixels (both) lie within 0.05 px
    of a match of b."""
    pa = torch.cat([a.left_xy, a.right_xy], -1)[a.match_valid].cpu().double()
    pb = torch.cat([b.left_xy, b.right_xy], -1)[b.match_valid].cpu().double()
    if not len(pa) or not len(pb):
        return 0
    return int(((pa[:, None] - pb[None]).abs().amax(-1).amin(-1) < 0.05).sum())


def phase_frontends(dev):
    """compare_frontends on one 1024x2048 pair (the reference's feature
    test flow, cube 600): each front end's launches, metrics and time on
    the card, and its matches against the port's CPU run of it."""
    h, w = SIZE_2K
    cfg = dataclasses.replace(CFG_2K, frontend=dataclasses.replace(CFG_2K.frontend,
                                                                   cube_size=CUBE_2K))
    left, right, R = make_pair(0, h, w, dev)
    R_t = torch.as_tensor(R, dtype=torch.float32, device=dev)
    evaluation.compare_frontends(left, right, R_t, cfg)  # warm-up
    torch.cuda.synchronize()
    (ev_all, counts_all) = counted(lambda: evaluation.compare_frontends(left, right, R_t, cfg))
    rows, frs = {}, {}
    for name, fn in frontend.FRONTENDS.items():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fr, counts = counted(lambda: fn(left, right, cfg))
        end.record()
        torch.cuda.synchronize()
        ev = evaluation.evaluate_matches(fr, R_t, w, h, cfg)
        frs[name] = fr
        rows[name] = dict(launches=counts, ms=start.elapsed_time(end),
                          matches=int(ev.num_matches), outlier_pct=float(ev.outlier_pct),
                          trim_err_deg=math.degrees(float(ev.trimmed_mean_err_rad)),
                          total_keypoints=int(ev.total_keypoints))
        require(all(c > 0 for c in counts.values()), f"{name}: a kernel never launched: {counts}")
        require(all(torch.equal(a, b) for a, b in zip(ev, ev_all[name])),
                f"{name}: compare_frontends scored another result")
    torch.set_num_threads(os.cpu_count() or 1)
    lc, rc = left.cpu(), right.cpu()
    for name, fn in frontend.FRONTENDS.items():
        fc = fn(lc, rc, cfg)
        n_gpu, n_cpu = int(frs[name].match_count), int(fc.match_count)
        rows[name].update(cpu_matches=n_cpu, shared_with_cpu=shared_matches(frs[name], fc))
    log("frontends_2k", cube_size=CUBE_2K, launches_compare_frontends=counts_all, **rows)
    for name, r in rows.items():
        need = 0.9 * max(r["matches"], r["cpu_matches"])
        require(r["matches"] > 0 and r["shared_with_cpu"] >= need,
                f"{name}: {r['shared_with_cpu']} matches shared with the CPU run, need {need}")
    band = rows["band"]
    require(band["matches"] >= GATE_MIN_MATCHES, f"band: {band['matches']} matches")
    require(band["outlier_pct"] <= GATE_MAX_OUTLIER_PCT, f"band: outlier% {band['outlier_pct']}")
    return {name: r["launches"] for name, r in rows.items()}


# ---------------------------------------------------------------------------
# The global solvers: multi-keyframe Schur BA and the pose graph, on the
# synthetic problems of problems.py (synth_multiview, synth_pose_graph).

CPU_GAP_PHASES = ("multiview_pcg_256kf", "pose_graph_100kf")
# CG iterations of the two runs whose difference is read per CG iteration;
# 64 iterations apart, so the host's noise (a few ms a call) stays small
CG_PROBE = (16, 80)
# chain_with_loop_closures' chained poses on the card against the CPU's:
# 1023 chained float32 3x3 products round apart by a few float32 steps
CHAIN_GAP_LIMIT = 1e-3


class CallCount(TorchFunctionMode):
    """Counts the torch calls made under it (top-level calls only)."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls += 1
        return func(*args, **(kwargs or {}))


def event_ms(fn, reps=3):
    """Median wall ms of fn() over `reps` calls, each between two CUDA
    events with the card idle before it (the host's launch time
    included)."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_trace(fn):
    """fn() under torch.profiler: the device activities it ran (kernels,
    copies, fills) and the sum of their durations in ms (None, None when
    the profiler traced nothing on the card). Everything runs on one
    stream, so the sum is the time the card was busy."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        return None, None
    return len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3


def per_cg_iteration(run):
    """Torch calls, device kernels, wall ms and device-busy ms per CG
    iteration of run(cg_iters) (one GN step with cg_tol 0, so every
    iteration runs): the difference between runs of CG_PROBE[0] and
    CG_PROBE[1] iterations, over the iterations between them. Wall ms:
    medians of 5 calls of each, in turns."""
    calls, kernels_, busy, walls = [], [], [], ([], [])
    for k in CG_PROBE:
        with CallCount() as cc:
            run(k)
        torch.cuda.synchronize()
        calls.append(cc.calls)
        n, ms = device_trace(lambda: run(k))
        kernels_.append(n)
        busy.append(ms)
    for _ in range(5):
        for k, w in zip(CG_PROBE, walls):
            w.append(event_ms(lambda: run(k), reps=1))
    traced = kernels_[1] is not None

    def per(v):
        return (v[1] - v[0]) / (CG_PROBE[1] - CG_PROBE[0])

    return dict(torch_calls_per_cg_iter=per(calls),
                kernels_per_cg_iter=per(kernels_) if traced else None,
                ms_per_cg_iter=per([float(np.median(w)) for w in walls]),
                device_busy_ms_per_cg_iter=per(busy) if traced else None)


def gn_step_split(parts):
    """Wall ms (median of 3) and device-busy ms of each part of one GN
    step, `parts` a list of (name, fn) run in order, after a warm-up."""
    for _, fn in parts:
        fn()
    out = {}
    for name, fn in parts:
        n, busy = device_trace(fn)
        out[name] = dict(ms=event_ms(fn), device_busy_ms=busy, device_activities=n)
    return out


def host_syncs(fn):
    """fn() and the number of host syncs it made (sync_counter)."""
    with sync_counter() as count:
        out = fn()
    return out, count[0]


@contextlib.contextmanager
def recorded_cg_iters():
    """Records the iterations of every solver.pcg.pcg call made inside."""
    calls, orig = [], pcg_mod.pcg

    def recording(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append(out.iters)
        return out

    pcg_mod.pcg = recording
    try:
        yield calls
    finally:
        pcg_mod.pcg = orig


def solver_run(solve, inputs, num_iters):
    """The solver phases' common readings of solve(inputs) -> (result,
    costs): the first call after a warm-up with its host syncs, peak memory
    and CG iterations per GN step, then 3 timed calls, each against the
    first bit for bit."""
    solve(inputs)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recorded_cg_iters() as cg:
        (first, syncs) = host_syncs(lambda: solve(inputs))
        torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    times, gaps = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = solve(inputs)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        gaps.append(max((a - b).abs().max().item()
                        for a, b in zip((*out[0], out[1]), (*first[0], first[1]))
                        if a.is_floating_point()))
    ms = float(np.median(times))
    cg_per_gn = [int(c) for c in cg]
    n_dev, busy_ms = device_trace(lambda: solve(inputs))
    return first, dict(
        device_activities_per_solve=n_dev, device_busy_ms_per_solve=busy_ms,
        device_busy_share=busy_ms / ms if busy_ms is not None else None,
        solve_ms=times, median_solve_ms=ms, ms_per_gn_step=ms / num_iters,
        cg_iters_per_gn_step=cg_per_gn or None,
        mean_cg_iters_per_gn_step=float(np.mean(cg_per_gn)) if cg_per_gn else None,
        host_syncs_per_solve=syncs, peak_memory_gb=peak_gb,
        bit_identical_runs=all(g == 0 for g in gaps), max_gap_between_runs=max(gaps))


def segment_sum_cost(prob, rd):
    """The fixed-order segment sum (ops/segment) against index_add_ (the
    atomics it replaces) at a PCG phase's shapes: the matvec's (L*P, 6)
    and the camera sums' (L*P, 84) by camera. Device and wall ms per call,
    whether two index_add_ runs gave the same bits, and the extra time per
    GN step (one camera sum and one matvec sum per CG iteration) as a
    share of the measured GN step."""
    C, ids = prob.poses.shape[0], prob.obs_cam.reshape(-1)
    seg = segment.segments(ids, C)
    g = torch.Generator(ids.device).manual_seed(SEED)
    out, extra_ms = {}, 0.0
    for name, width, per_gn in (("camera_sums", 84, 1),
                                ("matvec", 6, rd["mean_cg_iters_per_gn_step"])):
        data = torch.randn(ids.numel(), width, device=ids.device, generator=g)

        def fixed():
            return segment.segment_sum(data, seg)

        def atomic():
            return torch.zeros(C, width, device=ids.device).index_add_(0, ids, data)

        runs = [atomic() for _ in range(4)]
        fixed_ms, fixed_wall = profiling.device_ms(fixed)
        atomic_ms, atomic_wall = profiling.device_ms(atomic)
        out[name] = dict(fixed_ms=fixed_ms, fixed_wall_ms=fixed_wall, index_add_ms=atomic_ms,
                         index_add_wall_ms=atomic_wall,
                         index_add_runs_bit_identical=all(torch.equal(r, runs[0]) for r in runs),
                         index_add_max_gap_between_runs=max((r - runs[0]).abs().max().item()
                                                            for r in runs),
                         fixed_vs_index_add_max_gap=(fixed() - runs[0]).abs().max().item())
        extra_ms += per_gn * max(fixed_ms - atomic_ms, fixed_wall - atomic_wall)
    return dict(segment_sum_vs_index_add=out, fixed_order_extra_ms_per_gn_step=extra_ms,
                fixed_order_share_of_gn_step=extra_ms / rd["ms_per_gn_step"])


def multiview_split(prob, solver, kw):
    """One GN step of solve_multiview at the init, in its parts: the
    Schur pass (Jacobians, landmark blocks, camera sums), the camera
    solve, and the whole step with the new cost (the Schur pass, the
    camera solve, back-substitution and total_cost)."""
    index = multiview.obs_index(prob, solver)
    lam = torch.tensor(1e-3, device=prob.poses.device)
    cg = (kw.get("cg_iters", 100), kw.get("cg_tol", 1e-5))
    parts = multiview._schur_parts(prob, lam, index)
    if solver == "dense":
        def cameras():
            return multiview._solve_cameras_dense(parts, prob, lam, True, index)
    else:
        def cameras():
            return multiview._solve_cameras_pcg(parts, prob, lam, True, *cg, index)

    def step():
        poses, landmarks = multiview.gauss_newton_step(prob, lam, True, solver, *cg, index)
        return multiview.total_cost(prob._replace(poses=poses, landmarks=landmarks))

    return gn_step_split([("schur_parts", lambda: multiview._schur_parts(prob, lam, index)),
                          ("camera_solve", cameras), ("whole_step", step)])


def pose_graph_split(g, solver, kw):
    """One GN step of optimize_pose_graph at the init, in its parts: the
    per-edge residuals and Jacobian blocks, the linear solve (gradient,
    block diagonal and the dense or PCG step), and the new cost."""
    index = pose_graph.graph_index(g, solver)
    lam = torch.tensor(1e-3, device=g.poses.device)
    n = g.poses.shape[0]
    robust = (kw.get("robust_delta"), kw.get("tran_weight", 1.0))
    res, Ji, Jj = pose_graph._edge_blocks(g.poses, g, *robust)
    if solver == "dense":
        def linear():
            return pose_graph._gn_step_dense(index, res, Ji, Jj, lam, True, n)
    else:
        def linear():
            return pose_graph._gn_step_pcg(g, index, res, Ji, Jj, lam, True, n,
                                           kw.get("cg_iters", 100), kw.get("cg_tol", 1e-5))
    dp = linear()
    return gn_step_split([("edge_blocks", lambda: pose_graph._edge_blocks(g.poses, g, *robust)),
                          ("linear_solve", linear),
                          ("new_cost", lambda: pose_graph._edge_cost(g.poses + dp, g, *robust))])


def chain_check(fields, n):
    """chain_with_loop_closures on the phase's edges (the first n - 1 the
    odometry, the rest closures), from numpy, so on the card by default:
    every field on the card, its chained poses against the port's CPU
    build of the same graph (CHAIN_GAP_LIMIT), and its wall ms."""
    _, ei, ej, rot, tran, _ = fields
    closures = [(int(i), int(j), r, t) for i, j, r, t in
                zip(ei[n - 1:], ej[n - 1:], rot[n - 1:], tran[n - 1:])]

    def build():
        return pose_graph.chain_with_loop_closures(rot[:n - 1], tran[:n - 1], closures,
                                                   closure_weight=2.0)

    card = build()
    on_card = all(t.device.type == "cuda" for t in card)
    require(on_card, "chain_with_loop_closures left the card for numpy input")
    cpu = pose_graph.chain_with_loop_closures(torch.from_numpy(rot[:n - 1]),
                                              torch.from_numpy(tran[:n - 1]), closures,
                                              closure_weight=2.0)
    gap = max((a.cpu() - b).abs().max().item() for a, b in zip(card, cpu)
              if a.is_floating_point())
    require(gap <= CHAIN_GAP_LIMIT, f"chain_with_loop_closures: card vs CPU gap {gap}")
    return dict(on_card=on_card, card_vs_cpu_max_gap=gap, gap_limit=CHAIN_GAP_LIMIT,
                ms=event_ms(build))


def phase_multiview(dev, name, C, L, P, pose_noise, seed, kw):
    fields, poses_gt = synth_multiview(C, L, P, pose_noise, seed)
    prob = multiview.problem_from_numpy(fields, dev)
    solver = "dense" if kw.get("linear_solver", "auto") == "auto" and C <= 32 else "pcg"
    (solved, costs), rd = solver_run(lambda p: multiview.solve_multiview(p, **kw), prob,
                                     kw["num_iters"])
    c0 = float(multiview.total_cost(prob))
    vals, fails = solver_gates(f"multiview_{solver}", c0, costs.cpu().numpy(),
                               solved.poses.cpu().numpy(), poses_gt)
    extra = {}
    if solver == "pcg":
        pcg_kw = dict(kw, num_iters=1, cg_tol=0.0)
        extra.update(per_cg_iteration(
            lambda k: multiview.solve_multiview(prob, **dict(pcg_kw, cg_iters=k))))
        extra.update(segment_sum_cost(prob, rd))
    extra["gn_step_split"] = multiview_split(prob, solver, kw)
    if name in CPU_GAP_PHASES:
        extra.update(cpu_gap(lambda p: multiview.solve_multiview(p, **kw),
                             multiview.problem_from_numpy(fields, "cpu"), solved, costs))
    log(name, cameras=C, landmarks=L, obs_per_landmark=P, observations=L * P, seed=seed,
        linear_solver=solver, solve_kwargs=kw, **vals, **rd, **extra)
    require(not fails, f"{name}: gates failed: {fails}")
    return dict(fields=fields, poses_gt=poses_gt, solved=solved, costs=costs)


def phase_pose_graph(dev, name, n, n_closures, seed, kw):
    fields, poses_gt = synth_pose_graph(n, n_closures, seed)
    g = pose_graph.graph_from_numpy(fields, dev)
    solver = kw.get("linear_solver", "auto")
    solver = ("dense" if n <= 64 else "pcg") if solver == "auto" else solver
    (opt, costs), rd = solver_run(lambda gg: pose_graph.optimize_pose_graph(gg, **kw), g,
                                  kw["num_iters"])
    vals, fails = solver_gates("pose_graph", None, costs.cpu().numpy(), opt.poses.cpu().numpy(),
                               poses_gt)
    extra = {}
    if solver == "pcg":
        pcg_kw = dict(kw, num_iters=1, linear_solver="pcg", cg_tol=0.0)
        extra.update(per_cg_iteration(
            lambda k: pose_graph.optimize_pose_graph(g, **dict(pcg_kw, cg_iters=k))))
    extra["gn_step_split"] = pose_graph_split(g, solver, kw)
    extra["chain_with_loop_closures"] = chain_check(fields, n)
    if name in CPU_GAP_PHASES:
        extra.update(cpu_gap(lambda gg: pose_graph.optimize_pose_graph(gg, **kw),
                             pose_graph.graph_from_numpy(fields, "cpu"), opt, costs))
    log(name, nodes=n, edges=len(fields[1]), closures=n_closures, seed=seed,
        linear_solver=solver, solve_kwargs=kw, **vals, **rd, **extra)
    require(not fails, f"{name}: gates failed: {fails}")


def cpu_gap(solve, cpu_inputs, card_result, card_costs):
    """The same solve on the host's CPU: its largest pose gap to the
    card's, and both final costs."""
    torch.set_num_threads(os.cpu_count() or 1)
    res, costs = solve(cpu_inputs)
    return dict(cpu_max_pose_gap=(res.poses - card_result.poses.cpu()).abs().max().item(),
                cpu_final_cost=float(costs[-1]), card_final_cost=float(card_costs[-1]))


def phase_solvers(dev):
    """The global solvers at the keyframe counts of configs #3-#5, each
    gated on its JAX test's gates; returns each multiview phase's problem
    and solve (phase_multiview)."""
    _, n = host_syncs(lambda: torch.ones(1, device=dev).sum().item())
    require(n == 1, f"the sync counter saw {n} syncs in one .item()")
    solves = {name: phase_multiview(dev, name, C, L, P, noise, seed, kw)
              for name, C, L, P, noise, seed, kw in MULTIVIEW_PHASES}
    for name, n, k, seed, kw in POSE_GRAPH_PHASES:
        phase_pose_graph(dev, name, n, k, seed, kw)
    return solves


# ---------------------------------------------------------------------------
# Cross-pair track merging (models/tracks) into the global BA: the
# synthetic consecutive-pair match tables of problems.synth_tracks, and
# the match tables of a real consecutive-pair batch on a rendered
# trajectory.

ODO_CLOSURE = (0, 2)


def track_stats(prob, tt):
    """Tracks, valid landmarks, the histogram of observations per valid
    landmark (2 .. P) and the matches linked to their predecessor per
    pair."""
    counts = prob.obs_valid.sum(-1).cpu().numpy()
    lm = prob.lm_valid.cpu().numpy()
    hist = {int(k): int(np.sum(counts[lm] == k)) for k in range(2, prob.obs_valid.shape[1] + 1)}
    links = (tt.slot[1:] > 0).sum(-1).cpu().tolist()
    return dict(num_tracks=int(tt.num_tracks), valid_landmarks=int(lm.sum()),
                obs_per_landmark_hist=hist, links_per_pair=links)


def build_readings(build):
    """build() after a warm-up: its host syncs, torch calls, wall ms (CUDA
    events, median of 3), device-busy ms and share (torch.profiler), and
    whether two builds gave the same bits. Returns (a build, readings)."""
    first = build()
    torch.cuda.synchronize()
    second, syncs = host_syncs(build)
    torch.cuda.synchronize()
    with CallCount() as cc:
        build()
    ms = event_ms(build)
    n_dev, busy = device_trace(build)
    return first, dict(
        build_ms=ms, host_syncs_per_build=syncs, torch_calls_per_build=cc.calls,
        device_activities_per_build=n_dev, device_busy_ms_per_build=busy,
        build_device_busy_share=busy / ms if busy is not None else None,
        builds_bit_identical=all(torch.equal(a, b) for a, b in zip(first, second)))


def build_problem(inputs, width, height):
    return tracks.build_multiview_problem(*inputs, width, height, max_obs_per_track=TRACKS_P)


def tracks_on_card(inputs, width, height):
    """The build on the card, its readings, and the port's CPU build of
    the same inputs against it; requires every gate of the build."""
    prob, rd = build_readings(lambda: build_problem(inputs, width, height))
    require(rd["builds_bit_identical"], "two builds on the card gave different bits")
    require(rd["host_syncs_per_build"] == 0,
            f"the build made {rd['host_syncs_per_build']} host syncs")
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = build_problem([a.cpu() for a in inputs], width, height)
    rd["card_vs_cpu"] = problem_gaps(prob, cpu, landmark_det(inputs, width, height))
    require(rd["card_vs_cpu"]["within"], f"card build vs CPU build: {rd['card_vs_cpu']}")
    tt = tracks.merge_tracks(*inputs[1:4])
    return prob, tt, rd


def phase_tracks(dev, name, C, n_lm, slots, stride, kw):
    """Synthetic tables of C cameras through build_multiview_problem and
    solve_multiview on the card, gated on test_tracks' BA gates (or on
    1.5x the reference's errors where it misses them)."""
    fields, gt = synth_tracks(C, n_lm, TRACKS_SEED, window=slots, stride=stride, slots=slots)
    inputs = [torch.as_tensor(a, device=dev) for a in fields]
    prob, tt, rd = tracks_on_card(inputs, TRACKS_W, TRACKS_H)
    stats = track_stats(prob, tt)
    (solved, costs), srd = solver_run(lambda p: multiview.solve_multiview(p, **kw), prob,
                                      kw["num_iters"])
    ref = TRACKS_REFERENCE_ERRORS.get(name)
    limits = tuple(TRACKS_REFERENCE_FACTOR * e for e in ref) if ref else None
    vals, fails = tracks_gates(costs.cpu().numpy(), solved.poses.cpu().numpy(), fields[0], gt,
                               int(prob.obs_valid.sum(-1).max()), limits)
    stats["links_per_pair"] = dict(min=min(stats["links_per_pair"]),
                                   max=max(stats["links_per_pair"]))
    log(name, cameras=C, pairs=C - 1, match_slots=slots, landmarks_drawn=n_lm, window=slots,
        stride=stride, L=(C - 1) * slots, P=TRACKS_P, solve_kwargs=kw, **stats, **vals,
        reference_errors=ref, **rd,
        **{f"solve_{k}": v for k, v in srd.items()})
    require(not fails, f"{name}: gates failed: {fails}")


def scatter_collisions(prob_inputs, tt):
    """Cells of the (L, P) table named by more than one observation in
    the left scatter and in the right scatter (the reference lets the
    last write win; the port picks the same writer explicitly)."""
    valid = prob_inputs[3].cpu().numpy()
    tid, slot, nxt = (t.cpu().numpy() for t in (tt.track_id, tt.slot, tt.has_next))
    out = {}
    for name, s, ok in (("left", slot, valid), ("right", slot + 1, valid & ~nxt)):
        ok = ok & (tid >= 0) & (s < TRACKS_P)
        _, n = np.unique(tid[ok] * TRACKS_P + s[ok], return_counts=True)
        out[name] = int(np.sum(n - 1))
    return out


def phase_tracks_from_odometry(dev):
    """A consecutive-pair batch on rendered frames (K1, K2, K3 through
    run_two_view_batch), chained with a loop closure held on the card,
    through build_multiview_problem into solve_multiview."""
    h, w = SIZE_512
    rng = np.random.default_rng(ODO_SEED)
    params = synthetic.texture_params_from_numpy(rng)
    dists = synthetic.disc_distances_from_numpy(rng)
    gt = trajectory_poses(ODO_FRAMES)
    frames = synthetic.render_trajectory(params, dists, gt, h, w, dev)
    cfg = CFG_512
    gumbel = draws(cfg, ODO_FRAMES - 1, dev)
    run_batch(frames[:-1], frames[1:], cfg, gumbel)  # warm-up
    (out, batch_ms), counts = counted(lambda: run_batch(frames[:-1], frames[1:], cfg, gumbel))
    require(all(c > 0 for c in counts.values()), f"a kernel of the path never launched: {counts}")
    passes = -(-(ODO_FRAMES - 1) // (twoview.BATCH_CHUNK or ODO_FRAMES - 1))
    require(all(c == passes for c in counts.values()) and _ODO_BANDS in BAND_LAUNCHES,
            f"launches {counts}, expected {passes} each of {_ODO_BANDS} bands, a shape the "
            "kernels phase checked")
    i, j = ODO_CLOSURE
    clo = twoview.run_two_view(frames[i], frames[j], torch.Generator(dev).manual_seed(SEED), cfg)
    # run_sequence's information weights, on the card
    odo_w, cw = sequence.information_weights(out.num_matches, out.ok, clo.num_matches[None])
    g = pose_graph.chain_with_loop_closures(
        out.rotation_aa, out.translation, [(i, j, clo.rotation_aa, clo.translation)],
        closure_weight=2.0, odometry_weights=odo_w, closure_weights=cw)
    require(all(t.device.type == "cuda" for t in g), "chain_with_loop_closures left the card")
    inputs = [g.poses, out.left_xy, out.right_xy, out.match_valid, out.rotation_aa,
              out.translation]
    cells = shared_cells(*inputs[1:4])
    prob, tt, rd = tracks_on_card(inputs, w, h)
    stats = track_stats(prob, tt)
    (solved, costs), srd = solver_run(lambda p: multiview.solve_multiview(p, num_iters=15),
                                      prob, 15)
    c = costs.cpu().numpy()
    log("tracks_from_odometry", frames=ODO_FRAMES, size=[h, w], yaw_step_deg=ODO_YAW_DEG,
        step=ODO_STEP, launches=counts, batch_ms=batch_ms,
        matches=out.num_matches.tolist(), closure=dict(pair=list(ODO_CLOSURE),
                                                       matches=int(clo.num_matches),
                                                       edge_weight=float(g.edge_weight[-1])),
        **cells, scatter_collisions=scatter_collisions(inputs, tt), **stats, **rd,
        ba_costs=c.tolist(), **{f"solve_{k}": v for k, v in srd.items()})
    require(all(n > 0 for n in stats["links_per_pair"]),
            f"a pair links no match to its predecessor: {stats['links_per_pair']}")
    require(not any(cells["same_cell_not_bit_identical"]),
            f"frame keypoints in one cell differ between the two slots: {cells}")
    require(bool(np.all(np.isfinite(c))) and c[-1] <= c[0], f"BA costs {c.tolist()}")
    return counts


def phase_tracks_all(dev):
    """The three tracks phases; returns the odometry batch's launches."""
    for name, C, n_lm, slots, stride, kw in TRACKS_PHASES:
        phase_tracks(dev, name, C, n_lm, slots, stride, kw)
    return phase_tracks_from_odometry(dev)


# ---------------------------------------------------------------------------
# The sequence entry point (models/sequence.run_sequence) end to end: the
# 100-keyframe loop-closure orbit of scripts/run_sequence_100.run_orbit
# (BASELINE.json config #4) and a 10-keyframe turning, translating
# sequence through the global BA (config #3).

SEQ_WARMUP_FRAMES = 8  # the warm-up run's prefix of the frames


def surf_key(ii, cfg):
    """A K1 / K2 launch's plan key: (bands, h, w, octaves, layers)."""
    return (ii.shape[0], ii.shape[1] - 1, ii.shape[2] - 1, cfg.n_octaves, cfg.n_octave_layers)


@contextlib.contextmanager
def recorded_launch_shapes():
    """Records the shape of every K1, K2 and K3 launch made inside: K1 / K2
    as surf_key, K3 as (pairs, queries, train rows)."""
    shapes = dict(surf=set(), top2=set())
    det, haar, top2 = (cuda_surf.det_pyramid_cuda, cuda_surf.haar_trace_maps_cuda,
                       cuda_match.top2_distances_cuda)

    def surf_recorder(fn):
        def recording(ii, cfg):
            shapes["surf"].add(surf_key(ii, cfg))
            return fn(ii, cfg)
        return recording

    def top2_recording(d1, d2, v2):
        if d1.ndim == 3:  # a single bank comes back here with a pair axis
            shapes["top2"].add((d1.shape[0], d1.shape[1], d2.shape[1]))
        return top2(d1, d2, v2)

    cuda_surf.det_pyramid_cuda = surf_recorder(det)
    cuda_surf.haar_trace_maps_cuda = surf_recorder(haar)
    cuda_match.top2_distances_cuda = top2_recording
    try:
        yield shapes
    finally:
        cuda_surf.det_pyramid_cuda, cuda_surf.haar_trace_maps_cuda = det, haar
        cuda_match.top2_distances_cuda = top2


# run_sequence's stages, each a module-level callee that StageClock wraps:
# (stage, module, attribute); a callee entered inside another stage (the
# odometry's own run_two_view_batch) belongs to that stage
SEQ_STAGES = (("odometry", sequence, "pairwise_odometry"),
              ("closures", twoview, "run_two_view_batch"),
              ("chain", sequence, "information_weights"),
              ("chain", pose_graph, "chain_with_loop_closures"),
              ("pose_graph", pose_graph, "optimize_pose_graph"),
              ("tracks", sequence, "build_multiview_problem"),
              ("ba", multiview, "solve_multiview"))


class StageClock:
    """Within the block, each of run_sequence's stages (SEQ_STAGES) is
    timed: wall ms (CUDA events, the card idle at its start) and host
    syncs (sync_counter), summed over the stage's callees."""

    def __init__(self):
        self.ms, self.syncs, self.active = {}, {}, False

    def wrap(self, name, fn):
        def staged(*args, **kwargs):
            if self.active:
                return fn(*args, **kwargs)
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize()
            start.record()
            self.active = True
            try:
                with sync_counter() as count:
                    out = fn(*args, **kwargs)
            finally:
                self.active = False
            end.record()
            torch.cuda.synchronize()
            self.ms[name] = self.ms.get(name, 0.0) + start.elapsed_time(end)
            self.syncs[name] = self.syncs.get(name, 0) + count[0]
            return out
        return staged

    @contextlib.contextmanager
    def __call__(self):
        saved = [(mod, attr, getattr(mod, attr)) for _, mod, attr in SEQ_STAGES]
        for (name, mod, attr), (_, _, fn) in zip(SEQ_STAGES, saved):
            setattr(mod, attr, self.wrap(name, fn))
        try:
            yield self
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)


def run_sequence_timed(frames, cfg, dev, **kw):
    """One run_sequence call (draws from a generator of seed SEED) and its
    wall time in ms (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = sequence.run_sequence(frames, torch.Generator(dev).manual_seed(SEED), cfg, **kw)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def sequence_run(name, frames, cfg, dev, checked, kw):
    """Phase 13's readings of one run_sequence: a warm-up on the first
    SEQ_WARMUP_FRAMES frames (with the closures inside them), the timed
    run (launch counts set to 0 just before it, peak memory), then a run
    with StageClock (ms and host syncs per stage); every K1 / K2 / K3
    launch's shape recorded throughout. Fails unless every kernel launched
    in the timed run and every launch had a shape that phase 2 checked.
    Returns (the timed run's result, readings, launch counts)."""
    warm = dict(kw, closures=[(i, j) for i, j in kw.get("closures", ())
                              if j < SEQ_WARMUP_FRAMES])
    if kw.get("gumbel") is not None:
        warm["gumbel"] = kw["gumbel"][:SEQ_WARMUP_FRAMES - 1]
    with recorded_launch_shapes() as shapes:
        _, warm_ms = run_sequence_timed(frames[:SEQ_WARMUP_FRAMES], cfg, dev, **warm)
        torch.cuda.reset_peak_memory_stats(dev)
        (out, ms), counts = counted(lambda: run_sequence_timed(frames, cfg, dev, **kw))
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        clock = StageClock()
        with clock():
            staged, staged_ms = run_sequence_timed(frames, cfg, dev, **kw)
    unchecked = unchecked_shapes(shapes, checked)
    rd = dict(
        launches=counts, warmup_ms=warm_ms, sequence_ms=ms, staged_sequence_ms=staged_ms,
        stage_ms=clock.ms, stage_host_syncs=clock.syncs,
        host_syncs=sum(clock.syncs.values()), peak_memory_gb=peak_gb,
        staged_run_equals_timed=all(torch.equal(a, b) for a, b in zip(out, staged)),
        k1_k2_launch_shapes=sorted(shapes["surf"]), k3_launch_banks=sorted(shapes["top2"]),
        unchecked_launch_shapes=unchecked,
    )
    require(all(c > 0 for c in counts.values()), f"{name}: a kernel never launched: {counts}")
    require(not unchecked["surf"] and not unchecked["top2"],
            f"{name}: launches at shapes the kernels phase did not check: {unchecked}")
    return out, rd


def unchecked_shapes(shapes, checked):
    """The recorded launch shapes (recorded_launch_shapes) that phase 2
    did not hold against the plain versions."""
    return dict(surf=sorted(shapes["surf"] - checked["surf"]),
                top2=sorted(shapes["top2"] - checked["top2"]))


def cost_trace(costs):
    c = costs.cpu().numpy().astype(np.float64)
    return dict(first=float(c[0]), last=float(c[-1]), finite=bool(np.all(np.isfinite(c))),
                falls=bool(c[-1] < c[0]), trace=c.tolist()) if c.size else None


def phase_sequence_orbit(dev, checked):
    """The 100-keyframe orbit (mesh=None) through run_sequence on the card,
    gated on the slow test's ATE bounds."""
    h, w = SEQ_ORBIT_SIZE
    frames, R_gt = orbit_frames(SEQ_ORBIT_FRAMES, h, w, dev)
    closures = orbit_closures(SEQ_ORBIT_FRAMES)
    out, rd = sequence_run("sequence_100kf_orbit", frames, SEQ_ORBIT_CFG, dev, checked,
                           dict(closures=closures, **SEQ_ORBIT_KW))
    errs, errs0 = ate(out.poses.cpu().numpy(), R_gt)
    errs_pg, _ = ate(out.pg_poses.cpu().numpy(), R_gt)
    med_t = sequence.median_baseline(out.pairwise_tran)
    log("sequence_100kf_orbit", frames=SEQ_ORBIT_FRAMES, size=[h, w], closures=len(closures),
        **{k: v for k, v in SEQ_ORBIT_KW.items()}, median_odometry_t=med_t,
        auto_runs_ba=med_t >= sequence.MIN_BA_BASELINE, ba_ran=out.ba_costs.numel() > 0,
        rot_ate_deg=ate_summary(errs), rot_ate_pose_graph_deg=ate_summary(errs_pg),
        rot_ate_frame0_deg=ate_summary(errs0),
        recorded_jax_ate_deg=dict(median=SEQ_ORBIT_RECORDED_ATE_DEG[0],
                                  max=SEQ_ORBIT_RECORDED_ATE_DEG[1], ba_ran=False),
        jax_ate_deg_same_frames=dict(median=SEQ_ORBIT_REFERENCE_ATE_DEG[0],
                                     max=SEQ_ORBIT_REFERENCE_ATE_DEG[1], ba_ran=False),
        pg_costs=cost_trace(out.pg_costs), ba_costs=cost_trace(out.ba_costs),
        per_frame_err_deg=[round(float(e), 4) for e in errs], **rd)
    med_gate, max_gate = GATE_SEQ_ATE_DEG
    require(np.all(np.isfinite(errs)), "orbit: non-finite poses")
    require(np.median(errs) < med_gate, f"orbit: median rotation ATE {np.median(errs)} deg")
    require(errs.max() < max_gate, f"orbit: max rotation ATE {errs.max()} deg")
    return rd["launches"]


def seq_ate_limits(ref_ate):
    """The (median, max) rotation ATE limits (deg) of a set of poses: each
    of the slow test's bounds where the JAX package's own ATE on the same
    frames and draws, ref_ate, meets it, else 1.5x the JAX package's."""
    return tuple(bound if ref < bound else SEQ_REFERENCE_FACTOR * ref
                 for ref, bound in zip(ref_ate, GATE_SEQ_ATE_DEG))


def seq_10kf_errors(out, gt):
    """Rotation ATE (deg per frame) of out.poses and out.pg_poses, and the
    mean rotation (deg) and scale-aligned translation errors of each."""
    R_gt = angle_axis_matrices(gt[:, :3])
    poses, pg_poses = out.poses.cpu().numpy(), out.pg_poses.cpu().numpy()
    return dict(ate=ate(poses, R_gt)[0], pg_ate=ate(pg_poses, R_gt)[0],
                ba=scaled_pose_errors(poses, gt), pg=scaled_pose_errors(pg_poses, gt))


def phase_sequence_10kf(dev, checked):
    """10 frames along trajectory_poses(10) at 512x1024 in the bench's
    corrected mode, two closures, through the global BA, on the JAX
    package's RANSAC draws for key SEED (reference_sequence_draws), so both
    packages solve from the same draws; gated on the "auto" decision,
    falling finite cost traces, 1.5x the JAX package's BA errors on the
    same frames and draws, and the orbit's ATE bounds (1.5x the JAX
    package's ATE on a bound it misses: seq_ate_limits). A run on the
    port's own draws (from a generator of seed SEED) is logged beside it."""
    h, w = SIZE_512
    frames, gt = trajectory_frames(SEQ_10KF_FRAMES, h, w, dev)
    ref, cfg = SEQ_10KF_REFERENCE, SEQ_10KF_CFG
    odo_draws, closure_draws = reference_sequence_draws(
        SEED, SEQ_10KF_FRAMES - 1, cfg.ransac.num_trials, cfg.match.max_matches)
    kw = dict(closures=list(SEQ_10KF_CLOSURES), ba_iters=SEQ_10KF_BA_ITERS,
              global_ba="auto" if ref["auto_runs_ba"] else True)
    out, rd = sequence_run("sequence_10kf", frames, cfg, dev, checked,
                           dict(kw, gumbel=torch.from_numpy(odo_draws).to(dev),
                                closure_gumbel=torch.from_numpy(closure_draws).to(dev)))
    with recorded_launch_shapes() as own_shapes:
        own, own_ms = run_sequence_timed(frames, cfg, dev, **kw)
    e, e_own = seq_10kf_errors(out, gt), seq_10kf_errors(own, gt)
    med_t = sequence.median_baseline(out.pairwise_tran)
    auto = med_t >= sequence.MIN_BA_BASELINE
    pg, ba = cost_trace(out.pg_costs), cost_trace(out.ba_costs)
    limits = (SEQ_REFERENCE_FACTOR * ref["rot_err_deg"], SEQ_REFERENCE_FACTOR * ref["t_err"])
    ate_limits = {"poses": seq_ate_limits(ref["ate_deg"]),
                  "pg_poses": seq_ate_limits(ref["pg_ate_deg"])}
    unchecked_own = unchecked_shapes(own_shapes, checked)
    log("sequence_10kf", frames=SEQ_10KF_FRAMES, size=[h, w], yaw_step_deg=ODO_YAW_DEG,
        step=ODO_STEP, closures=list(SEQ_10KF_CLOSURES), global_ba=kw["global_ba"],
        ba_iters=SEQ_10KF_BA_ITERS, draws="reference (jax.random.PRNGKey(SEED))",
        median_odometry_t=med_t, auto_runs_ba=auto,
        reference=ref, ba_rot_err_deg=e["ba"][0], ba_t_err=e["ba"][1], limits=limits,
        ate_limits_deg=ate_limits,
        pose_graph_rot_err_deg=e["pg"][0], pose_graph_t_err=e["pg"][1],
        rot_ate_deg=ate_summary(e["ate"]), rot_ate_pose_graph_deg=ate_summary(e["pg_ate"]),
        pg_costs=pg, ba_costs=ba,
        own_draws=dict(sequence_ms=own_ms, median_odometry_t=sequence.median_baseline(
            own.pairwise_tran), ba_ran=own.ba_costs.numel() > 0,
            ba_rot_err_deg=e_own["ba"][0], ba_t_err=e_own["ba"][1],
            pose_graph_rot_err_deg=e_own["pg"][0], pose_graph_t_err=e_own["pg"][1],
            rot_ate_deg=ate_summary(e_own["ate"]),
            rot_ate_pose_graph_deg=ate_summary(e_own["pg_ate"]),
            unchecked_launch_shapes=unchecked_own),
        **rd)
    require(not unchecked_own["surf"] and not unchecked_own["top2"],
            f"10 kf, own draws: launches at shapes the kernels phase did not check: "
            f"{unchecked_own}")
    require(auto == ref["auto_runs_ba"], f"10 kf: the auto rule decides {auto} (median |t| "
            f"{med_t}), the JAX package {ref['auto_runs_ba']} ({ref['median_t']})")
    require(ba is not None and len(ba["trace"]) == SEQ_10KF_BA_ITERS, "10 kf: the BA did not run")
    for label, c in (("pose graph", pg), ("BA", ba)):
        require(c["finite"] and c["falls"], f"10 kf: {label} cost trace {c['trace']}")
    for label, errs, lim in (("poses", e["ate"], ate_limits["poses"]),
                             ("pose-graph poses", e["pg_ate"], ate_limits["pg_poses"])):
        require(np.median(errs) < lim[0] and errs.max() < lim[1],
                f"10 kf: {label} rotation ATE median {np.median(errs)}, max {errs.max()} deg "
                f"(limits {lim})")
    rot, tran = e["ba"]
    require(rot < limits[0] and tran < limits[1],
            f"10 kf: BA errors {rot} deg, {tran} against 1.5x the JAX package's {limits}")
    return rd["launches"], out


def phase_sequence(dev, checked):
    """Phase 13: run_sequence on the orbit and on the 10-keyframe sequence;
    returns each run's launch counts and the 10-keyframe run's result."""
    orbit = phase_sequence_orbit(dev, checked)
    counts, out = phase_sequence_10kf(dev, checked)
    return {"sequence_100kf_orbit": orbit, "sequence_10kf": counts}, out


# ---------------------------------------------------------------------------
# Phase 14: the distributed layer (parallel/mesh, parallel/dist_ba) on one
# card. NCCL refuses two ranks on one device, so NCCL runs one rank (in
# this process) and gloo runs DIST_WORLD spawned ranks that share the card,
# with every tensor on it (gloo stages its collectives through the host).

DIST_WORLD = 4
DIST_TIMEOUT_S = 120   # the process groups' timeout: a stuck collective fails
DIST_DEADLINE_S = 300  # the gloo ranks' whole run
DIST_BATCH_SEEDS = (3, 4)  # dist_batch_2d: multiview_pcg_256kf's problem and a second seed
DIST_SEQ_RANKS = 2
# dist_sequence_10kf against phase 13's mesh=None run (tests/
# test_torch_sequence.py::test_sequence_over_a_two_rank_mesh's bounds):
# pose-graph poses (rad, units), BA cost trace (share of its first cost),
# final poses (rad, units)
# test_translating_sequence_with_global_ba_parity's bound for the cost
# trace (1% of the first cost), not the 1e-3 that the CPU test holds
# between the 2-rank and the mesh=None run: on the CPU the two give the
# same bits (rank 1's rows hold no valid track), on the card the
# reductions round by shape (the half table's first cost is 1.4e-5 apart
# already) and the BA's ill-conditioned landmark step carries that to
# 1.4e-3 of the first cost (first card run)
DIST_SEQ_PG_GAP = (1e-4, 5e-4)
DIST_SEQ_COST_GAP = 1e-2
DIST_SEQ_POSE_GAP = (1e-3, 2e-3)
DIST_PROBE_CALLS = 50  # all-reduces a probe times


def _multiview_phase(name):
    """phase 11's entry of MULTIVIEW_PHASES named `name`."""
    return next(x for x in MULTIVIEW_PHASES if x[0] == name)


def _pose_gap(p, q):
    """(largest rotation angle in rad, largest translation gap) between two
    (N, 6) stacks of poses."""
    p, q = p.cpu().numpy(), q.cpu().numpy()
    rot = max(rot_err_deg_host(a, angle_axis_matrix(b)) for a, b in zip(p[:, :3], q[:, :3]))
    return float(np.radians(rot)), float(np.abs(p[:, 3:] - q[:, 3:]).max())


def dist_solve_readings(solve, axis, kw, C):
    """solve() -> (problem, costs) after a warm-up: ms per solve (3 runs,
    CUDA events), all-reduce calls and bytes per GN step (the axis's
    counts over one solve) against collective_bytes_per_gn_iter, the Schur
    setup's bytes, and peak memory. Returns (the first run's result,
    readings)."""
    solve()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    axis.reset()
    out = solve()
    torch.cuda.synchronize()
    reduces = {b: n for (op, b), n in axis.traffic.items() if op == "all_reduce"}
    setup = (2 * C * 36 + 2 * C * 6) * 4
    times = [event_ms(solve, reps=1) for _ in range(3)]
    ms, num_iters = float(np.median(times)), kw["num_iters"]
    return out, dict(
        solve_ms=times, median_solve_ms=ms, ms_per_gn_step=ms / num_iters,
        all_reduce_calls_per_gn_step=sum(reduces.values()) / num_iters,
        all_reduce_bytes_per_gn_step=sum(b * n for b, n in reduces.items()) / num_iters,
        setup_bytes_per_gn_step=setup * reduces.get(setup, 0) / num_iters,
        formula_bytes_per_gn_step=dist_ba.collective_bytes_per_gn_iter(
            C, kw["linear_solver"], kw["cg_iters"]),
        formula_setup_bytes=setup, traffic={f"{op} {b} B": n for (op, b), n in axis.traffic.items()},
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def all_reduce_probe(axis, dev, places=("cuda", "cpu"), n=DIST_PROBE_CALLS):
    """Wall ms per all_reduce of one CG iteration's (C, 6) float32 vector
    at C = 1024 over the axis, from card memory and from host memory: n
    calls in a row after one, the card idle before and after (host
    clock). Every rank of the axis must call it."""
    out = {}
    for place in places:
        x = torch.zeros(1024, 6, device=dev if place == "cuda" else "cpu")
        axis.all_reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            axis.all_reduce(x)
        torch.cuda.synchronize()
        out[f"{place}_ms_per_call"] = 1e3 * (time.perf_counter() - t0) / n
    axis.reset()
    return out


def _rank_solve(m, fields, kw, dev):
    prob = multiview.problem_from_numpy(fields, dev)
    (solved, costs), rd = dist_solve_readings(
        lambda: dist_ba.solve_multiview_sharded(prob, m, **kw), m.axis("data"), kw,
        prob.poses.shape[0])
    return dict(poses=solved.poses.cpu(), landmarks=solved.landmarks.cpu(), costs=costs.cpu(),
                digest=kernel_times.digest((solved.poses, solved.landmarks, costs)), **rd)


def _rank_batch_2d(m, fields, kw, dev):
    probs = multiview.MultiViewProblem(*(torch.as_tensor(np.stack(f), device=dev)
                                         for f in zip(*fields)))
    (solved, costs), rd = dist_solve_readings(
        lambda: dist_ba.solve_multiview_batch_sharded(probs, m, **kw), m.axis("data"), kw,
        probs.poses.shape[1])
    return dict(poses=solved.poses.cpu(), costs=costs.cpu(), coords=m.coords,
                digest=kernel_times.digest((solved.poses, solved.landmarks, costs)), **rd)


def _rank_twoview(m, dev, checked):
    """phase 7's 64-pair compat batch through batched_two_view_sharded: a
    warm-up, then one run with the launch counts set to 0 just before it
    and every launch's shape recorded."""
    h, w = SIZE_512
    pairs = [make_pair(i, h, w, dev) for i in range(N_DISTINCT)]
    lefts, rights = (x.repeat(N_BATCH // N_DISTINCT, 1, 1, 1) for x in stacked(pairs))

    def run():
        return dist_ba.batched_two_view_sharded(lefts, rights, torch.Generator(dev).manual_seed(SEED),
                                                m, CFG_512)

    run()
    torch.cuda.reset_peak_memory_stats()
    with recorded_launch_shapes() as shapes:
        out, counts = counted(run)
    ms = [event_ms(run, reps=1) for _ in range(2)]
    return dict(out=type(out)(*(f.cpu() for f in out[:-1]), telemetry=None),
                digest=kernel_times.digest(out[:-1]), launches=counts, batch_ms=ms,
                median_batch_ms=float(np.median(ms)),
                images_digest=kernel_times.digest((lefts, rights)),
                unchecked_launch_shapes=unchecked_shapes(shapes, checked),
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def _rank_sequence(m, frames, odo, closure, dev, checked):
    """phase 13's 10-keyframe sequence over the mesh, on the JAX package's
    draws: a warm-up on the first SEQ_WARMUP_FRAMES frames, then one run
    with the launch counts set to 0 just before it, every launch's shape
    recorded and StageClock timing each stage (the BA: solve_multiview
    inside solve_multiview_sharded); also the valid landmarks in each
    rank's rows."""
    frames = torch.from_numpy(frames).to(dev)
    ref = SEQ_10KF_REFERENCE
    kw = dict(closures=list(SEQ_10KF_CLOSURES), ba_iters=SEQ_10KF_BA_ITERS,
              global_ba="auto" if ref["auto_runs_ba"] else True, mesh=m,
              gumbel=torch.from_numpy(odo).to(dev), closure_gumbel=torch.from_numpy(closure).to(dev))
    warm = dict(kw, gumbel=kw["gumbel"][:SEQ_WARMUP_FRAMES - 1],
                closures=[(i, j) for i, j in kw["closures"] if j < SEQ_WARMUP_FRAMES])
    run_sequence_timed(frames[:SEQ_WARMUP_FRAMES], SEQ_10KF_CFG, dev, **warm)
    valid, build = [], sequence.build_multiview_problem

    def recording(*args, **kwargs):
        prob = build(*args, **kwargs)
        valid.append(mesh_lib.shard_leading(m, prob.lm_valid).sum())
        return prob

    sequence.build_multiview_problem = recording
    axis = m.axis("data")
    axis.reset()
    torch.cuda.reset_peak_memory_stats()
    try:
        with recorded_launch_shapes() as shapes:
            clock = StageClock()
            with clock():
                (out, ms), counts = counted(
                    lambda: run_sequence_timed(frames, SEQ_10KF_CFG, dev, **kw))
    finally:
        sequence.build_multiview_problem = build
    return dict(out=type(out)(*(f.cpu() for f in out)), digest=kernel_times.digest(out),
                sequence_ms=ms,
                stage_ms=clock.ms, launches=counts,
                valid_landmarks_in_rank=int(valid[0]) if valid else None,
                ba_all_reduce_calls=axis.calls(), ba_all_reduce_bytes=axis.bytes(),
                unchecked_launch_shapes=unchecked_shapes(shapes, checked),
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def dist_rank_main(rank, world, path, checked):
    """One gloo rank of phase 14 (spawned by parallel/launch.run_ranks):
    every rank builds every mesh (new_group is collective over the job),
    then runs each sub-phase it is in. Returns its readings; the poses,
    landmarks and outputs themselves only from rank 0."""
    dev = torch.device("cuda", torch.cuda.current_device())
    inp = torch.load(path, weights_only=False)
    timeout = datetime.timedelta(seconds=DIST_TIMEOUT_S)
    m_all = mesh_lib.make_mesh(world, timeout=timeout)
    m_seq = mesh_lib.make_mesh(DIST_SEQ_RANKS, timeout=timeout)
    m_2d = mesh_lib.make_mesh_2d(2, world // 2, timeout=timeout)
    out = {"all_reduce_probe": all_reduce_probe(m_all.axis("data"), dev)}
    kw256, kw1024 = (_multiview_phase(n)[-1] for n in ("multiview_pcg_256kf",
                                                        "multiview_pcg_1024kf"))
    out["dist_multiview_256kf"] = _rank_solve(m_all, inp["256kf"], kw256, dev)
    out["dist_multiview_1024kf"] = _rank_solve(m_all, inp["1024kf"], kw1024, dev)
    out["dist_batch_2d"] = _rank_batch_2d(m_2d, inp["batch_2d"], kw256, dev)
    out["dist_twoview_batch"] = _rank_twoview(m_all, dev, checked)
    if m_seq.coords is not None:
        out["dist_sequence_10kf"] = _rank_sequence(m_seq, inp["seq_frames"], inp["seq_odo"],
                                                   inp["seq_closure"], dev, checked)
    if rank:
        for r in out.values():
            for k in ("poses", "landmarks", "costs", "out"):
                r.pop(k, None)
    return out


def dist_nccl_1rank(dev, ref, smi):
    """multiview_pcg_1024kf's problem on a 1-rank NCCL mesh in this process,
    against phase 11's solve bit for bit."""
    name = "multiview_pcg_1024kf"
    kw = _multiview_phase(name)[-1]
    mesh_lib.init_distributed(f"localhost:{launch.free_port()}", 1, 0, backend="nccl",
                              timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        m = mesh_lib.make_mesh(1, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        backend = torch.distributed.get_backend()
        probe = all_reduce_probe(m.axis("data"), dev, places=("cuda",))
        got = _rank_solve(m, ref["fields"], kw, dev)
    finally:
        torch.distributed.destroy_process_group()
    same = got["digest"] == kernel_times.digest((ref["solved"].poses, ref["solved"].landmarks,
                                                 ref["costs"]))
    log("dist_nccl_1rank", card=smi, backend=backend, ranks=1, problem=name, solve_kwargs=kw,
        bit_identical_to_phase_11=same, all_reduce_probe=probe,
        **{k: v for k, v in got.items() if k not in ("poses", "landmarks", "costs")})
    require(backend == "nccl", f"dist_nccl_1rank ran on {backend}")
    require(same, "dist_nccl_1rank: the 1-rank NCCL solve differs from phase 11's")


def _gate_dist_solve(name, r0, ranks, ref_solved, ref_costs, fields, poses_gt, kind, smi,
                     extra=None):
    c0 = float(multiview.total_cost(multiview.problem_from_numpy(fields, "cpu")))
    vals, fails = solver_gates(kind, c0, r0["costs"].numpy(), r0["poses"].numpy(), poses_gt)
    same = len({r["digest"] for r in ranks}) == 1
    pose_gap = (r0["poses"] - ref_solved.poses.cpu()).abs().max().item()
    log(name, card=smi, backend="gloo", ranks=len(ranks), **vals,
        single_process_final_cost=float(ref_costs[-1]), max_pose_gap_to_single=pose_gap,
        ranks_bit_identical=same, peak_memory_gb_per_rank=[r["peak_memory_gb"] for r in ranks],
        **{k: v for k, v in r0.items() if k not in ("poses", "landmarks", "costs", "digest",
                                                    "peak_memory_gb", "coords")}, **(extra or {}))
    require(not fails, f"{name}: gates failed: {fails}")
    require(same, f"{name}: ranks ended with different bits")
    require(r0["setup_bytes_per_gn_step"] == r0["formula_setup_bytes"],
            f"{name}: Schur setup all-reduces {r0['setup_bytes_per_gn_step']} B a GN step")
    require(r0["all_reduce_bytes_per_gn_step"] <= r0["formula_bytes_per_gn_step"],
            f"{name}: {r0['all_reduce_bytes_per_gn_step']} B a GN step over the formula")
    return pose_gap


def phase_distributed(dev, smi, checked, solves, batch_out, seq_out):
    """Phase 14: the 1-rank NCCL solve here, then DIST_WORLD gloo ranks on
    the card; fails on any rank's failure, a timeout or a missed gate."""
    dist_nccl_1rank(dev, solves["multiview_pcg_1024kf"], smi)
    _, C, L, P, noise, _, kw256 = _multiview_phase("multiview_pcg_256kf")
    fields_b, gt_b = synth_multiview(C, L, P, noise, DIST_BATCH_SEEDS[1])
    single_b = multiview.solve_multiview(multiview.problem_from_numpy(fields_b, dev), **kw256)
    h, w = SIZE_512
    frames, gt = trajectory_frames(SEQ_10KF_FRAMES, h, w, dev)
    odo, closure = reference_sequence_draws(SEED, SEQ_10KF_FRAMES - 1,
                                            SEQ_10KF_CFG.ransac.num_trials,
                                            SEQ_10KF_CFG.match.max_matches)
    inputs = {"256kf": solves["multiview_pcg_256kf"]["fields"],
              "1024kf": solves["multiview_pcg_1024kf"]["fields"],
              "batch_2d": [solves["multiview_pcg_256kf"]["fields"], fields_b],
              "seq_frames": frames.cpu().numpy(), "seq_odo": odo, "seq_closure": closure}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save(inputs, path)
        t0 = time.perf_counter()
        ranks = launch.run_ranks(dist_rank_main, DIST_WORLD, args=(path, checked),
                                 init_method=f"tcp://localhost:{launch.free_port()}",
                                 timeout_s=DIST_TIMEOUT_S, deadline_s=DIST_DEADLINE_S)
        ranks_s = time.perf_counter() - t0
    r0 = ranks[0]
    log("dist_ranks", card=smi, backend="gloo", ranks=DIST_WORLD, seconds=ranks_s,
        all_reduce_probe=[r["all_reduce_probe"] for r in ranks],
        note="spawn, imports, every sub-phase below")

    for name, key in (("dist_multiview_256kf", "multiview_pcg_256kf"),
                      ("dist_multiview_1024kf", "multiview_pcg_1024kf")):
        ref = solves[key]
        _gate_dist_solve(name, r0[name], [r[name] for r in ranks], ref["solved"], ref["costs"],
                         ref["fields"], ref["poses_gt"], "multiview_pcg", smi)

    b = r0["dist_batch_2d"]
    for i, (fields, poses_gt, (solved, costs)) in enumerate(zip(
            inputs["batch_2d"], (solves["multiview_pcg_256kf"]["poses_gt"], gt_b),
            ((solves["multiview_pcg_256kf"]["solved"], solves["multiview_pcg_256kf"]["costs"]),
             single_b))):
        one = dict(b, poses=b["poses"][i], costs=b["costs"][i])
        _gate_dist_solve(f"dist_batch_2d_problem_{i}", one, [r["dist_batch_2d"] for r in ranks],
                         solved, costs, fields, poses_gt, "multiview_pcg", smi,
                         dict(seed=DIST_BATCH_SEEDS[i], mesh={"pairs": 2, "data": DIST_WORLD // 2},
                              coords=[r["dist_batch_2d"]["coords"] for r in ranks]))

    tv = [r["dist_twoview_batch"] for r in ranks]
    got = tv[0]["out"]
    same = [all(torch.equal(getattr(got, f)[i], getattr(batch_out, f)[i].cpu())
                for f in ("match_valid", "left_xy", "right_xy")) for i in range(N_BATCH)]
    gaps = [rot_err_deg_host(batch_out.rotation_aa[i].cpu().numpy(),
                             angle_axis_matrix(got.rotation_aa[i].numpy())) for i in range(N_BATCH)]
    log("dist_twoview_batch", card=smi, backend="gloo", ranks=DIST_WORLD, pairs=N_BATCH,
        pairs_per_rank=N_BATCH // DIST_WORLD, launches_per_rank=[r["launches"] for r in tv],
        batch_ms=tv[0]["batch_ms"], median_batch_ms=tv[0]["median_batch_ms"],
        pairs_per_s=1e3 * N_BATCH / tv[0]["median_batch_ms"],
        peak_memory_gb_per_rank=[r["peak_memory_gb"] for r in tv],
        ranks_bit_identical=len({r["digest"] for r in tv}) == 1,
        same_images_on_every_rank=len({r["images_digest"] for r in tv}) == 1,
        same_matches_as_unsharded=sum(same), max_rot_gap_to_unsharded_deg=max(gaps),
        gap_limit_deg=BATCH_GAP_LIMIT_DEG,
        unchecked_launch_shapes=[r["unchecked_launch_shapes"] for r in tv])
    for r, x in enumerate(tv):
        require(all(c == 1 for c in x["launches"].values()),
                f"dist_twoview_batch rank {r}: launches {x['launches']}, expected 1 each")
        require(not any(x["unchecked_launch_shapes"].values()),
                f"dist_twoview_batch rank {r}: unchecked launch shapes {x['unchecked_launch_shapes']}")
    require(len({r["digest"] for r in tv}) == 1, "dist_twoview_batch: ranks differ")
    require(all(same), f"dist_twoview_batch: pairs {[i for i, x in enumerate(same) if not x]} "
            "match differently from the unsharded batch")
    require(max(gaps) <= BATCH_GAP_LIMIT_DEG,
            f"dist_twoview_batch: rotation {max(gaps)} deg from the unsharded batch")

    sq = [r["dist_sequence_10kf"] for r in ranks if "dist_sequence_10kf" in r]
    out = sq[0]["out"]
    ref = SEQ_10KF_REFERENCE
    e = seq_10kf_errors(out, gt)
    pg_gap, pose_gap = _pose_gap(out.pg_poses, seq_out.pg_poses), _pose_gap(out.poses, seq_out.poses)
    a, c = out.ba_costs.numpy(), seq_out.ba_costs.cpu().numpy()
    fin = (np.isfinite(a) & np.isfinite(c)) if a.shape == c.shape else np.zeros(0, bool)
    cost_gap = float(np.abs(a - c)[fin].max() / c[0]) if fin.any() else float("inf")
    first_gap = float(abs(a[0] - c[0]) / c[0]) if a.size and c.size else float("inf")
    ate_limits = {"poses": seq_ate_limits(ref["ate_deg"]),
                  "pg_poses": seq_ate_limits(ref["pg_ate_deg"])}
    limits = (SEQ_REFERENCE_FACTOR * ref["rot_err_deg"], SEQ_REFERENCE_FACTOR * ref["t_err"])
    ba = cost_trace(out.ba_costs)
    log("dist_sequence_10kf", card=smi, backend="gloo", ranks=DIST_SEQ_RANKS,
        draws="reference (jax.random.PRNGKey(SEED))", sequence_ms=[x["sequence_ms"] for x in sq],
        stage_ms=sq[0]["stage_ms"], launches_per_rank=[x["launches"] for x in sq],
        valid_landmarks_per_rank=[x["valid_landmarks_in_rank"] for x in sq],
        ba_all_reduce_calls=sq[0]["ba_all_reduce_calls"],
        ba_all_reduce_bytes=sq[0]["ba_all_reduce_bytes"],
        peak_memory_gb_per_rank=[x["peak_memory_gb"] for x in sq],
        ranks_bit_identical=len({x["digest"] for x in sq}) == 1,
        pg_gap_to_mesh_none=pg_gap, pose_gap_to_mesh_none=pose_gap,
        ba_cost_gap_to_mesh_none=cost_gap, ba_first_cost_gap_to_mesh_none=first_gap,
        cost_gap_limit=DIST_SEQ_COST_GAP, ba_costs=ba,
        ba_rot_err_deg=e["ba"][0], ba_t_err=e["ba"][1], limits=limits,
        rot_ate_deg=ate_summary(e["ate"]), rot_ate_pose_graph_deg=ate_summary(e["pg_ate"]),
        ate_limits_deg=ate_limits,
        unchecked_launch_shapes=[x["unchecked_launch_shapes"] for x in sq])
    for r, x in enumerate(sq):
        require(all(c > 0 for c in x["launches"].values()),
                f"dist_sequence_10kf rank {r}: a kernel never launched: {x['launches']}")
        require(not any(x["unchecked_launch_shapes"].values()),
                f"dist_sequence_10kf rank {r}: unchecked shapes {x['unchecked_launch_shapes']}")
    require(len({x["digest"] for x in sq}) == 1, "dist_sequence_10kf: ranks differ")
    require(ba is not None and len(ba["trace"]) == SEQ_10KF_BA_ITERS and ba["finite"]
            and ba["falls"], f"dist_sequence_10kf: BA cost trace {ba}")
    require(pg_gap[0] < DIST_SEQ_PG_GAP[0] and pg_gap[1] < DIST_SEQ_PG_GAP[1],
            f"dist_sequence_10kf: pose graph {pg_gap} from the mesh=None run")
    require(cost_gap < DIST_SEQ_COST_GAP, f"dist_sequence_10kf: BA costs {cost_gap} apart")
    require(pose_gap[0] < DIST_SEQ_POSE_GAP[0] and pose_gap[1] < DIST_SEQ_POSE_GAP[1],
            f"dist_sequence_10kf: poses {pose_gap} from the mesh=None run")
    for label, errs, lim in (("poses", e["ate"], ate_limits["poses"]),
                             ("pose-graph poses", e["pg_ate"], ate_limits["pg_poses"])):
        require(np.median(errs) < lim[0] and errs.max() < lim[1],
                f"dist_sequence_10kf: {label} ATE median {np.median(errs)}, max {errs.max()}")
    require(e["ba"][0] < limits[0] and e["ba"][1] < limits[1],
            f"dist_sequence_10kf: BA errors {e['ba']} against {limits}")
    return ({"dist_twoview_batch": [x["launches"] for x in tv],
             "dist_sequence_10kf": [x["launches"] for x in sq]})


# ---------------------------------------------------------------------------
# Phase 15: the reference's own entry point (cli.main, the main.cpp parity
# CLI) on a 2K pair, the checkpointed multiview solve, a profiler trace
# and the native oracle.

# cli_2k's flags after the nine positionals: the 2K bench config's match
# capacity and ratio test; everything else is the CLI's default (the auto
# band ladder, 512 keypoints a band, compat BA)
CLI_FLAGS = ("--max-matches", "1024", "--ratio-thresh", "0.5")
CKPT_PHASE = "multiview_pcg_1024kf"
CKPT_ITERS_PER_ROUND = 2
CKPT_INTERRUPT_ITERS = 4  # the interrupted call: 2 of the 4 rounds
CKPT_TOTAL_ITERS = 8
PROFILE_K3_TOLERANCE = 0.25  # device_time of K3 against phase 2's time and the trace's
# K3 calls traced after the CLI run, timed on CUPTI's clock: a trace of
# these calls alone lost its first kernels on the H100 (kept 14 and 1 of 16)
PROFILE_K3_CALLS = 16
# tests/test_native.py's inputs and bounds
ORACLE_EULER = (0.08, -0.12, 0.2)
ORACLE_T = (0.2, 0.1, -0.05)
ORACLE_ATOL = dict(euler=5e-3, t_axis=1e-3, rot=2e-2, tran=3e-2)
REPO = os.path.dirname(os.path.abspath(__file__))


def cli_argv(left, right, euler_deg, out_dir):
    return [left, right, *(repr(float(v)) for v in euler_deg), "0", "0", "0", "1", *CLI_FLAGS,
            "--out-dir", out_dir]


class LogLines(logging.Handler):
    """Collects the messages of a logger while installed."""

    def __init__(self, logger):
        super().__init__()
        self.messages, self.logger = [], logger

    def __enter__(self):
        self.logger.addHandler(self)
        return self.messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self)

    def emit(self, record):
        self.messages.append(record.getMessage())


def run_cli(argv):
    """cli.main(argv) in this process: (rc, stdout, log messages)."""
    buf = io_lib.StringIO()
    with LogLines(port_logging.logger) as messages, contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue(), messages


def phase_cli_2k(dev, smi, checked, tmp):
    """cli_2k: phase 3's pair 0 as PNGs through the port's CLI, in this
    process with the launch counts set to 0 first, then once as a
    subprocess; returns (launch counts, the CLI's argv)."""
    left, right, R = make_pair(0, *SIZE_2K, dev)
    euler = np.random.default_rng(SEED).uniform(-5, 5, (N_DISTINCT, 3))[0]
    paths = [os.path.join(tmp, "left.png"), os.path.join(tmp, "right.png")]
    image_io.save_image(left, paths[0])
    image_io.save_image(right, paths[1])
    out_dir = os.path.join(tmp, "match_result")
    argv = cli_argv(*paths, euler, out_dir)
    with recorded_launch_shapes() as shapes:
        (rc, stdout, messages), counts = counted(lambda: run_cli(argv))
    require(rc == 0, f"cli.main returned {rc}")
    rot_deg, tran = printed(stdout, "rotation vector in degree "), printed(stdout, "translation vector ")
    matches = int(printed(stdout, "matches: ")[0])
    err = rot_err_deg_host(np.deg2rad(np.array(rot_deg, np.float64)), R)
    ba_s = [float(m.split(":")[1].split()[0]) for m in messages
            if m.startswith("bundle_adjustment execution time")]

    # the same pair, config and seed through run_two_view in this process
    args = cli.build_parser().parse_args(argv)
    images = [torch.tensor(image_io.load_image(p), device=dev) for p in paths]
    require(all(torch.equal(a, b) for a, b in zip(images, (left, right))),
            "the PNGs do not read back as the rendered pair")
    ref = twoview.run_two_view(*images, torch.Generator(dev).manual_seed(args.seed),
                               cli.build_config(args), args.frontend)
    want = ([str(v) for v in ref.rotation_deg.cpu().numpy().tolist()],
            [str(v) for v in ref.translation.cpu().numpy().tolist()])

    files = sorted(os.listdir(out_dir))
    rows = open(os.path.join(out_dir, "log.txt")).read().splitlines()
    depth_rows = open(os.path.join(out_dir, "log_d.txt")).read().splitlines()
    events = [json.loads(ln)["event"] for ln in open(os.path.join(out_dir, "metrics.jsonl"))]
    pngs = [f for f in files if f.endswith(".png")]
    png_shapes = {f: list(image_io.load_image(os.path.join(out_dir, f)).shape) for f in pngs}

    sub_dir = os.path.join(tmp, "match_result_subprocess")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "spherical_bundle_adjuster_tpu_torch.cli",
         *cli_argv(*paths, euler, sub_dir)], capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=600)
    sub_s = time.perf_counter() - t0
    sub_rows = (open(os.path.join(sub_dir, "log.txt")).read().splitlines()
                if proc.returncode == 0 else None)
    unchecked = unchecked_shapes(shapes, checked)
    log("cli_2k", card=smi, argv_flags=list(CLI_FLAGS), euler_deg=euler.tolist(), launches=counts,
        launch_shapes={k: sorted(v) for k, v in shapes.items()}, unchecked_launch_shapes=unchecked,
        dense_rerun=any(k[0] == 2 * len(DENSE_BAND_PITCHES) for k in shapes["surf"]),
        rotation_deg=rot_deg, translation=tran, matches=matches, rot_err_deg=err,
        gates=dict(med_rot_err_deg=GATE_MED_ROT_ERR_DEG, min_matches=GATE_MIN_MATCHES),
        pose_equals_run_two_view=(rot_deg, tran) == want, bundle_adjustment_s=ba_s,
        codec="native" if native.available() else "PIL",
        native_unavailable=native.unavailable_reason(), files=files, png_shapes=png_shapes,
        log_rows=len(rows), log_fields=len(rows[0].split(",")) if rows else 0,
        log_d_rows=len(depth_rows), metric_events=events, subprocess_rc=proc.returncode,
        subprocess_s=sub_s, subprocess_row_equal=sub_rows == rows)
    require(all(c > 0 for c in counts.values()), f"cli_2k: a kernel never launched: {counts}")
    require(not any(unchecked.values()), f"cli_2k: launch shapes phase 2 did not check: {unchecked}")
    require(err <= GATE_MED_ROT_ERR_DEG, f"cli_2k: rotation {err} deg off")
    require(matches >= GATE_MIN_MATCHES, f"cli_2k: {matches} matches")
    require((rot_deg, tran) == want, f"cli_2k: printed pose {rot_deg, tran} is not run_two_view's "
            f"{want}")
    require(len(rows) == 1 and len(rows[0].split(",")) == 10, f"cli_2k: log.txt {rows}")
    require(len(depth_rows) == matches, f"cli_2k: {len(depth_rows)} depth rows, {matches} matches")
    require(events == ["two_view_ba"], f"cli_2k: metrics events {events}")
    require(len(pngs) == 2 and "d_found.png" in pngs
            and all(v == [*SIZE_2K, 3] for v in png_shapes.values()), f"cli_2k: PNGs {png_shapes}")
    require(proc.returncode == 0, f"cli_2k: the CLI as a subprocess exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    require(sub_rows == rows, f"cli_2k: the subprocess wrote {sub_rows}, in-process {rows}")
    return counts, argv


def phase_checkpoint(dev, smi, solves):
    """checkpoint_1024kf: phase 11's 1024-keyframe problem in checkpointed
    rounds, interrupted after 2 rounds and resumed, against one
    uninterrupted call into another path."""
    name, C, L, P, noise, seed, kw = _multiview_phase(CKPT_PHASE)
    ref = solves[name]
    prob = multiview.problem_from_numpy(ref["fields"], dev)
    timings = dict(save_ms=[], load_ms=[])
    save, load = checkpoint.save_checkpoint, checkpoint.load_checkpoint

    def timed_call(fn, key):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            timings[key].append(1e3 * (time.perf_counter() - t0))
            return out
        return call

    checkpoint.save_checkpoint = timed_call(save, "save_ms")
    checkpoint.load_checkpoint = timed_call(load, "load_ms")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            a, b = os.path.join(tmp, "interrupted"), os.path.join(tmp, "whole")
            t0 = time.perf_counter()
            _, first = checkpoint.solve_multiview_resumable(
                prob, a, total_iters=CKPT_INTERRUPT_ITERS, iters_per_round=CKPT_ITERS_PER_ROUND)
            resumed, rest = checkpoint.solve_multiview_resumable(
                prob, a, total_iters=CKPT_TOTAL_ITERS, iters_per_round=CKPT_ITERS_PER_ROUND)
            torch.cuda.synchronize()
            interrupted_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            whole, costs = checkpoint.solve_multiview_resumable(
                prob, b, total_iters=CKPT_TOTAL_ITERS, iters_per_round=CKPT_ITERS_PER_ROUND)
            torch.cuda.synchronize()
            whole_s = time.perf_counter() - t0
            n_bytes = os.path.getsize(b + ".npz")
    finally:
        checkpoint.save_checkpoint, checkpoint.load_checkpoint = save, load
    same = dict(poses=torch.equal(resumed.poses, whole.poses),
                landmarks=torch.equal(resumed.landmarks, whole.landmarks),
                costs=torch.equal(torch.cat([first, rest]), costs))
    trace = cost_trace(costs)
    c0 = float(multiview.total_cost(prob))
    vals, fails = solver_gates("multiview_pcg", c0, costs.cpu().numpy(),
                               whole.poses.cpu().numpy(), ref["poses_gt"])
    ang11, t11 = pose_errors(ref["solved"].poses.cpu().numpy(), ref["poses_gt"])
    log("checkpoint_1024kf", card=smi, cameras=C, landmarks=L, obs_per_landmark=P,
        rounds=CKPT_TOTAL_ITERS // CKPT_ITERS_PER_ROUND, iters_per_round=CKPT_ITERS_PER_ROUND,
        interrupted_after_rounds=CKPT_INTERRUPT_ITERS // CKPT_ITERS_PER_ROUND,
        bit_identical=same, checkpoint_bytes=n_bytes, save_ms=timings["save_ms"],
        load_ms=timings["load_ms"], interrupted_and_resumed_s=interrupted_s,
        uninterrupted_s=whole_s, costs=trace, final=vals, phase11_gates_failed=fails,
        phase11=dict(solve_kwargs=kw, median_rot_err_deg=float(np.median(ang11)),
                     max_rot_err_deg=float(ang11.max()), median_t_err=float(np.median(t11)),
                     max_t_err=float(t11.max())))
    require(all(same.values()), f"checkpoint_1024kf: resumed differs from uninterrupted: {same}")
    require(trace is not None and trace["finite"] and trace["falls"],
            f"checkpoint_1024kf: cost trace {trace}")
    require(len(timings["save_ms"]) == 2 * CKPT_TOTAL_ITERS // CKPT_ITERS_PER_ROUND
            and len(timings["load_ms"]) == 1, f"checkpoint_1024kf: {timings}")


def phase_profile(dev, smi, argv, k3_ms, tmp):
    """profile_trace: one CLI run (cli_2k's argv) under profiling.trace,
    whose Chrome trace must hold K1's, K2's and K3's kernels; K3 timed by
    profiling.device_time at the 2K banks against phase 2's time (the same
    CUDA-event timer, profiling.device_ms, so this holds it to its own
    repeatability) and against the median duration of K3's kernel over
    PROFILE_K3_CALLS calls at those banks traced after the CLI run (CUPTI's
    clock, independent of the events)."""
    g = torch.Generator(dev).manual_seed(SEED)
    d1 = torch.nn.functional.normalize(torch.randn(2048, 64, device=dev, generator=g), dim=-1)
    d2 = torch.nn.functional.normalize(torch.randn(2048, 64, device=dev, generator=g), dim=-1)
    v2 = torch.rand(2048, device=dev, generator=g) > 0.1
    k3 = lambda: cuda_match.top2_distances_cuda(d1, d2, v2)
    k3_s = profiling.device_time(k3)
    gap = abs(1e3 * k3_s - k3_ms) / k3_ms
    log_dir = os.path.join(tmp, "trace")
    out_dir = os.path.join(tmp, "match_result_traced")
    with profiling.trace(log_dir):
        rc, _, _ = run_cli(argv[:-1] + [out_dir])
        for _ in range(PROFILE_K3_CALLS):
            k3()
    require(rc == 0, f"profile_trace: cli.main returned {rc}")
    files = sorted(os.listdir(log_dir))
    require(len(files) == 1, f"profile_trace: {files} in the trace directory")
    path = os.path.join(log_dir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = [e["name"] for e in kernels]
    top2 = sorted((e for e in kernels if "top2_kernel" in e["name"]), key=lambda e: e["ts"])
    found = {"tile_kernel<DetOp>": sum("tile_kernel" in k and "DetOp" in k for k in names),
             "tile_kernel<HaarOp>": sum("tile_kernel" in k and "HaarOp" in k for k in names),
             "top2_kernel": len(top2)}
    durs = [e["dur"] for e in top2[-PROFILE_K3_CALLS:]]
    cupti_ms = statistics.median(durs) / 1e3 if durs else None
    cupti_gap = abs(1e3 * k3_s - cupti_ms) / cupti_ms if durs else None
    log("profile_trace", card=smi, trace_bytes=os.path.getsize(path), events=len(events),
        device_kernels=len(kernels), kernels_found=found, cupti=bool(kernels),
        k3_calls_after_the_cli=PROFILE_K3_CALLS, k3_device_time_ms=1e3 * k3_s,
        k3_phase2_ms=k3_ms, k3_gap=gap, k3_cupti_ms=cupti_ms, k3_cupti_gap=cupti_gap,
        k3_tolerance=PROFILE_K3_TOLERANCE)
    if kernels:
        require(all(found.values()), f"profile_trace: kernels missing from the trace: {found}")
        require(len(top2) > PROFILE_K3_CALLS,
                f"profile_trace: {len(top2)} K3 kernels in the trace, fewer than the CLI's and "
                f"the {PROFILE_K3_CALLS} calls after it")
        require(cupti_gap <= PROFILE_K3_TOLERANCE, f"profile_trace: device_time {1e3 * k3_s} "
                f"ms against the trace's {cupti_ms} ms")
    require(gap <= PROFILE_K3_TOLERANCE, f"profile_trace: device_time {1e3 * k3_s} ms against "
            f"phase 2's {k3_ms} ms")


def phase_native_oracle(dev, smi):
    """native_oracle: the float64 oracle (utils/native) against the port's
    epipolar and lm stages on card tensors, at tests/test_native.py's
    inputs and bounds, where the host library builds."""
    if not native.available():
        log("native_oracle", card=smi, available=False, reason=native.unavailable_reason(),
            note="the host lacks what csrc/sba_native.cpp needs; image IO reads through PIL")
        return
    rng = np.random.default_rng(0)
    n = 64
    b1 = rng.normal(size=(n, 3))
    b1 /= np.linalg.norm(b1, axis=-1, keepdims=True)
    d1 = rng.uniform(2, 6, n)
    R = rotation.euler_to_matrix(torch.tensor(ORACLE_EULER, dtype=torch.float32)).numpy()
    x2 = (R.astype(np.float64) @ (b1 * d1[:, None]).T).T - np.asarray(ORACLE_T)
    d2 = np.linalg.norm(x2, axis=-1)
    b2 = x2 / d2[:, None]
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    E = epipolar.essential_from_bearings(f32(b1), f32(b2), torch.ones(n, device=dev))
    r1, r2, tt = epipolar.decompose_essential(E)
    e_port = torch.stack([rotation.matrix_to_euler(r1), rotation.matrix_to_euler(r2)]).cpu().numpy()
    e1, e2, t_o, v1, v2 = native.oracle_eight_point(b1, b2)
    euler_err = [float(np.linalg.norm(e_port - e, axis=-1).min()) for e, v in ((e1, v1), (e2, v2))
                 if v]
    t_axis_err = abs(abs(float(np.dot(tt.cpu().numpy(), t_o))) - 1.0)
    aa = rotation.matrix_to_angle_axis(torch.tensor(R)).numpy().astype(np.float64)
    rot0, tran0, d0 = aa + 0.02, np.asarray(ORACLE_T) + 0.02, np.stack([d1, d2], -1) + 0.2
    rot_o, tran_o, _ = native.oracle_bcd(b1, b2, rot0, tran0, d0, iters=50, compat=False)
    cfg = BaConfig(reference_compat=False)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    d_p, _ = lm.solve_depths(f32(b1), f32(b2), f32(d0), f32(rot0), f32(tran0), valid, cfg)
    rot_p, _ = lm.solve_rotation(f32(b1), f32(b2), d_p, f32(rot0), f32(tran0), valid, cfg)
    tran_p, _ = lm.solve_translation(f32(b1), f32(b2), d_p, rot_p, f32(tran0), valid, cfg)
    rot_err = float(np.abs(rot_p.cpu().numpy() - rot_o).max())
    tran_err = float(np.abs(tran_p.cpu().numpy() - tran_o).max())
    log("native_oracle", card=smi, available=True, euler_err=euler_err, t_axis_err=t_axis_err,
        bcd_rot_err=rot_err, bcd_tran_err=tran_err, atol=ORACLE_ATOL)
    require(euler_err and max(euler_err) < ORACLE_ATOL["euler"], f"native_oracle: Euler {euler_err}")
    require(t_axis_err < ORACLE_ATOL["t_axis"], f"native_oracle: t axis {t_axis_err}")
    require(rot_err < ORACLE_ATOL["rot"] and tran_err < ORACLE_ATOL["tran"],
            f"native_oracle: BCD {rot_err}, {tran_err}")


def phase_entry_point(dev, smi, checked, solves, k3_ms):
    """Phase 15; returns cli_2k's launch counts."""
    with tempfile.TemporaryDirectory() as tmp:
        counts, argv = phase_cli_2k(dev, smi, checked, tmp)
        phase_checkpoint(dev, smi, solves)
        phase_profile(dev, smi, argv, k3_ms, tmp)
    phase_native_oracle(dev, smi)
    return counts


def main():
    dev, smi = phase_device()
    phase_build()
    rows, checked = phase_kernels(dev)
    lm_rows = phase_lm(dev)
    counts = phase_slice(dev)
    by_phase = {"slice_2k_corrected": (phase_2k_corrected(dev), N_PAIRS_2K)}
    for mode, c in phase_512(dev).items():
        by_phase[f"pair_512x1024_{mode}"] = (c, N_PAIRS_512)
    by_phase["pitch60_corrected"] = (phase_pitch60(dev), N_PAIRS_PITCH)
    batch_counts, batch_out = phase_batch(dev)
    per_batch = {"batch_512x1024": batch_counts,
                 "batch_512x1024_auto": phase_batch_auto(dev),
                 "batch_512x1024_corrected": phase_batch_corrected(dev)}
    per_frontend = phase_frontends(dev)
    solves = phase_solvers(dev)
    per_batch["tracks_from_odometry"] = phase_tracks_all(dev)
    seq_counts, seq_out = phase_sequence(dev, checked)
    per_batch.update(seq_counts)
    per_rank = phase_distributed(dev, smi, checked, solves, batch_out, seq_out)
    cli_counts = phase_entry_point(dev, smi, checked, solves, rows[2]["ms"])
    for r, sym in zip(rows, ("sba_det_pyramid", "sba_haar_trace", "sba_top2")):
        r["launches"] = counts[sym]
        r["launches_per_pair"] = counts[sym] / N_PAIRS_2K
        r["launches_per_pair_by_phase"] = {k: c[sym] / n for k, (c, n) in by_phase.items()}
        r["launches_per_batch_by_phase"] = {k: c[sym] for k, c in per_batch.items()}
        r["launches_per_frontend_2k"] = {k: c[sym] for k, c in per_frontend.items()}
        r["launches_per_rank_by_phase"] = {k: [c[sym] for c in cs] for k, cs in per_rank.items()}
        r["launches_per_cli_run"] = cli_counts[sym]
    lm_batches = ("batch_512x1024", "batch_512x1024_corrected")
    lm_kernels = [dict(
        name=k.symbol, source="spherical_bundle_adjuster_tpu_torch/csrc/lm_trip.cu",
        launches=counts[k.symbol], launches_per_pair=counts[k.symbol] / N_PAIRS_2K,
        launches_per_pair_by_phase={p: c[k.symbol] / n for p, (c, n) in by_phase.items()},
        launches_per_batch_by_phase={p: per_batch[p][k.symbol] for p in lm_batches})
        for k in LM_LAUNCHED]
    print(json.dumps({"kernels": rows, "lm_kernels": lm_kernels, "lm_trips": lm_rows}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
