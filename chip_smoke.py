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
     all-invalid bank and the 64-pair batch), with times for each kernel,
     its plain version and, for K3, one library call (cdist + topk), and
     each kernel's bound (bytes or fp32 operations over the H100's
     peaks); K1 and K2 also at every band count that the 512x1024 phases
     launch (BAND_LAUNCHES), the 2K ERP images and the 2K cube strips;
  3. slice: run_two_view(..., frontend="band") on 4 synthetic 1024x2048
     rotation pairs under the 2K bench config (compat BA), with the
     kernels' launch counts and the bench's 2K compat gates;
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
     it on the same pair, the band front end on the 2K compat gates.

Each pipeline phase sets the kernels' launch counts to 0 before its
measured runs and fails if a kernel of the path was not launched.

Then one JSON line with every kernel's numbers, and a last line
{"ok": true, "device": {...}}. Any failed phase raises and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

from spherical_bundle_adjuster_tpu_torch import kernel_times
from spherical_bundle_adjuster_tpu_torch.models import evaluation, frontend, twoview
from spherical_bundle_adjuster_tpu_torch.ops import cuda_match, cuda_surf, integral, kernels, warp
from spherical_bundle_adjuster_tpu_torch.solver import epipolar
from spherical_bundle_adjuster_tpu_torch.utils import synthetic
from spherical_bundle_adjuster_tpu_torch.utils.config import (
    DENSE_BAND_PITCHES, FrontendConfig, MatchConfig, PipelineConfig, SurfConfig,
)

# The bench's configs (bench.py bench_config_2k / bench_config) and its 2K
# compat gates (bench.py GATE_2K_*).
CFG_2K = PipelineConfig(
    surf=SurfConfig(max_keypoints=512, n_octaves=4),
    match=MatchConfig(max_matches=1024, ratio_thresh=0.5),
).parity()
CFG_512 = PipelineConfig(
    surf=SurfConfig(max_keypoints=256, n_octaves=3),
    match=MatchConfig(max_matches=512, ratio_thresh=0.5),
).parity()
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
N_DISTINCT = 16  # the bench's make_batch: 16 distinct pairs ...
N_BATCH = 64     # ... tiled to its headline batch
CHUNKS = (8, 16, 32, 0)  # the batch_chunk sweep (0: the whole batch a pass)
CUBE_2K = 600  # the reference's feature test cube size at 2K
# The parity ladder's intermediate-pitch cliff: pitch 30 deg. At 512x1024
# the default 96-disc scenes still find more than auto_min_matches parity
# matches there (the auto phase logs them), so the cliff pairs are
# rendered with a quarter of the discs.
CLIFF_EULER_DEG = (0.0, 30.0, 0.0)
CLIFF_DISCS = 24
SIZE_2K = (1024, 2048)
SIZE_512 = (512, 1024)
SEED = 42
PITCH_SEED = 77
# A batch row's rotation against its single run with the same matches and
# draws: 1.2x the largest gap over the 64 pairs of the compat batch,
# 0.4865 deg (card_rounding.py on an NVIDIA H100 80GB HBM3 at 700 W;
# PERF.md). The batched einsum of the consensus stage rounds differently
# at another batch size, and compat's BCD carries the start.
BATCH_GAP_LIMIT_DEG = 1.2 * 0.4865
N_AUTO_SHORT = 2  # the auto batch's pairs that fall short on the parity ladder
# Bands of 128 x 1024 per K1 / K2 launch in the 512x1024 phases: one pair
# on the parity and on the dense ladder, the auto batch's dense re-run of
# its short pairs, and a pass of each swept batch_chunk.
_PARITY_BANDS = 2 * len(CFG_512.frontend.band_pitches_deg)
BAND_LAUNCHES = sorted({_PARITY_BANDS, 2 * len(DENSE_BAND_PITCHES),
                        2 * len(DENSE_BAND_PITCHES) * N_AUTO_SHORT,
                        *(_PARITY_BANDS * (c or N_BATCH) for c in CHUNKS)})


def corrected_mode(cfg):
    """bench.corrected_mode on the port's config: per-match depths, outlier
    gates, the joint Schur polish, 4 starts and 240 RANSAC trials."""
    return dataclasses.replace(
        cfg,
        ba=dataclasses.replace(cfg.ba, reference_compat=False, joint_refine=True,
                               outlier_reject=True, multi_start=4),
        ransac=dataclasses.replace(cfg.ransac, num_trials=240),
    )


class PhaseError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def time_ms(fn, iters=10):
    """Mean device time of fn() in ms: CUDA events around back-to-back
    calls queued behind a GPU spin (kernel_times.device_ms)."""
    return kernel_times.device_ms(fn, iters)[0]


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


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return torch.device("cuda", 0), smi


def phase_build():
    lib = kernels.build(verbose=True)
    kernels.library()
    log("build", seconds=kernels.build_seconds, library=lib.name)


# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): HBM bytes/s and
# fp32 FLOP/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# fp32 operations per value: K1 10 boxes x 3 + 10 weights + 7 sums + 4 for
# the det; K2 14 boxes x 3 + hx, hy 2 + the trace's 2 weights and 5 sums.
K1_OPS_PER_VALID = 51
K2_OPS_PER_VALUE = 51


def bound(n_bytes, n_ops):
    """The least time in ms for moving n_bytes and doing n_ops fp32
    operations on the card, and which of the two sets it."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


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
    # a pass of each swept batch_chunk; the first bands of the 64-pair
    # batch's crops), then the ERP images and cube strips of one 2K pair
    h5, w5 = SIZE_512
    batch_pairs = [make_pair(i, h5, w5, dev) for i in range(N_DISTINCT)]
    lefts, rights = (x.repeat(N_BATCH // N_DISTINCT, 1, 1, 1) for x in stacked(batch_pairs))
    bands5 = frontend.crop_bands(lefts, rights, CFG_512,
                                 CFG_512.frontend.band_pitches_deg).flatten(0, 1)
    del lefts, rights, batch_pairs
    launches = [(f"{n} bands of 128 x 1024", bands5[:n], CFG_512.surf) for n in BAND_LAUNCHES]
    launches += [
        ("2K ERP images", integral.rgb_to_gray(torch.stack([left, right])), scfg),
        ("2K cube strips", torch.stack([warp.equi_to_cubemap(integral.rgb_to_gray(im), CUBE_2K)
                                        for im in (left, right)]), scfg)]
    shapes = []
    for name, images, surf_cfg in launches:
        iib = integral.integral_image(images)
        for o, (k, p) in enumerate(zip(cuda_surf.det_pyramid_cuda(iib, surf_cfg),
                                       cuda_surf.det_pyramid_plain(iib, surf_cfg))):
            require(torch.equal(k, p), f"K1 at the {name}, octave {o}: not its plain version")
        for k, p in zip(cuda_surf.haar_trace_maps_cuda(iib, surf_cfg),
                        cuda_surf.haar_trace_maps_plain(iib, surf_cfg)):
            require(torch.equal(k, p), f"K2 at the {name}: not its plain version")
        shapes.append(dict(name=name, bands=list(images.shape)))
        del iib, k, p
    del bands5, launches
    log("kernel_shapes", bit_identical_k1_k2=shapes)

    # K3: 2048 x 2048 x 64 banks, ~10% invalid train slots
    g = torch.Generator(dev).manual_seed(SEED)
    d1 = torch.nn.functional.normalize(torch.randn(2048, 64, device=dev, generator=g), dim=-1)
    d2 = torch.nn.functional.normalize(torch.randn(2048, 64, device=dev, generator=g), dim=-1)
    v2 = torch.rand(2048, device=dev, generator=g) > 0.1

    def k3_case(name, q, t, v):
        """K3 against its plain version: identical indices, distances
        within 2e-3; returns (dist, idx, max_abs_err)."""
        dist, idx = cuda_match.top2_distances_cuda(q, t, v)
        torch.cuda.synchronize()
        pdist, pidx = cuda_match.top2_distances_plain(q, t, v)
        require(torch.equal(idx, pidx), f"K3 {name}: indices differ")
        err = max_abs_err(dist, pdist)
        require(err <= 2e-3, f"K3 {name}: distances differ by {err}")
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
    pdist, pidx = cuda_match.top2_distances_plain(bq, bt, bv)
    require(torch.equal(bidx, pidx), "batched K3: indices differ from the plain version")
    berr = max_abs_err(bdist, pdist)
    require(berr <= 2e-3, f"batched K3: distances differ by {berr}")
    for p in range(N_BATCH):
        one_d, one_i = cuda_match.top2_distances_cuda(bq[p], bt[p], bv[p])
        require(torch.equal(one_d, bdist[p]) and torch.equal(one_i, bidx[p]),
                f"batched K3: pair {p} differs from its own launch")

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
    del bq, bt, bv, pdist, pidx

    rows.append(dict(
        name="top2_distances", route="cuda", source="spherical_bundle_adjuster_tpu_torch/csrc/match_top2.cu",
        replaces="spherical_bundle_adjuster_tpu/ops/pallas_match.py:89",
        max_abs_err=err, max_abs_err_ties=terr, max_abs_err_ragged=rerr,
        ms=time_ms(lambda: cuda_match.top2_distances_cuda(d1, d2, v2)),
        plain_ms=time_ms(lambda: cuda_match.top2_distances_plain(d1, d2, v2)),
        **bound(nbytes(d1, d2, v2, dist, idx), 2 * d1.shape[0] * d2.shape[0] * d1.shape[1]),
        library_ms=time_ms(library_top2), library="torch.cdist + torch.topk(2, largest=False)",
        tolerance="identical indices; distance atol 2e-3 (2048 x 2048, planted ties, "
                  "1000 x 2100, the 64-pair batch); all-invalid gives (inf, index 0)",
        batched=batched,
    ))
    for r in rows:
        log("kernel", **r)
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
    launched = (cuda_surf.DET_PYRAMID, cuda_surf.HAAR_TRACE, cuda_match.TOP2)
    for k in launched:
        k.launches = 0
    results = [run_pair(l, r, CFG_2K, dev, seed=i) for i, (l, r, _) in enumerate(pairs)]
    counts = {k.symbol: k.launches for k in launched}
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


def run_counted(pairs, cfg, dev):
    """One run_two_view per pair with every launch count set to 0 first;
    returns ([(out, ms)], {kernel symbol: launches})."""
    results, counts = counted(
        lambda: [run_pair(l, r, cfg, dev, seed=i) for i, (l, r, _) in enumerate(pairs)])
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
    """fn() with every launch count set to 0 just before it; returns
    (fn's result, {kernel symbol: launches})."""
    for k in LAUNCHED:
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
    return counts


def angle_axis_of(euler):
    """The angle-axis vector of the rotation of Euler angles (a tensor)."""
    from spherical_bundle_adjuster_tpu_torch.core import rotation

    return rotation.euler_to_angle_axis(euler.double()).cpu().numpy()


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


def main():
    dev, smi = phase_device()
    phase_build()
    rows = phase_kernels(dev)
    counts = phase_slice(dev)
    by_phase = {"slice_2k_corrected": (phase_2k_corrected(dev), N_PAIRS_2K)}
    for mode, c in phase_512(dev).items():
        by_phase[f"pair_512x1024_{mode}"] = (c, N_PAIRS_512)
    by_phase["pitch60_corrected"] = (phase_pitch60(dev), N_PAIRS_PITCH)
    per_batch = {"batch_512x1024": phase_batch(dev),
                 "batch_512x1024_auto": phase_batch_auto(dev),
                 "batch_512x1024_corrected": phase_batch_corrected(dev)}
    per_frontend = phase_frontends(dev)
    for r, sym in zip(rows, ("sba_det_pyramid", "sba_haar_trace", "sba_top2")):
        r["launches"] = counts[sym]
        r["launches_per_pair"] = counts[sym] / N_PAIRS_2K
        r["launches_per_pair_by_phase"] = {k: c[sym] / n for k, (c, n) in by_phase.items()}
        r["launches_per_batch_by_phase"] = {k: c[sym] for k, c in per_batch.items()}
        r["launches_per_frontend_2k"] = {k: c[sym] for k, c in per_frontend.items()}
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
