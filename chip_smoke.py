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
     across its lanes and blocks, a ragged 1000 x 2100 bank and an
     all-invalid bank), with times for each kernel, its
     plain version and, for K3, one library call (cdist + topk), and each
     kernel's bound (bytes or fp32 operations over the H100's peaks);
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
     band ladder in corrected mode, gated on the bench's pitch-cell gates.

Each pipeline phase sets the kernels' launch counts to 0 before its
measured runs and fails if a kernel of the path was not launched.

Then one JSON line with every kernel's numbers, and a last line
{"ok": true, "device": {...}}. Any failed phase raises and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys

import numpy as np
import torch

from spherical_bundle_adjuster_tpu_torch import kernel_times
from spherical_bundle_adjuster_tpu_torch.models import evaluation, frontend, twoview
from spherical_bundle_adjuster_tpu_torch.ops import cuda_match, cuda_surf, integral, kernels
from spherical_bundle_adjuster_tpu_torch.utils import synthetic
from spherical_bundle_adjuster_tpu_torch.utils.config import (
    FrontendConfig, MatchConfig, PipelineConfig, SurfConfig,
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
SIZE_2K = (1024, 2048)
SIZE_512 = (512, 1024)
SEED = 42
PITCH_SEED = 77


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


def rot_err_deg_host(rot_aa, R_gt):
    """Geodesic angle between Rodrigues(rot_aa) and R_gt, on the host in
    float64 (the bench's rot_err_deg_host)."""
    aa = np.asarray(rot_aa, np.float64)
    th = np.linalg.norm(aa)
    k = aa / max(th, 1e-30)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    tr = np.sum(R * np.asarray(R_gt, np.float64))
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


def make_pair(i, height, width, dev):
    params = synthetic.texture_params_from_numpy(np.random.default_rng(SEED + i))
    euler = np.deg2rad(np.random.default_rng(SEED).uniform(-5, 5, (N_PAIRS_2K, 3))[i])
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
    bands = frontend.crop_bands(left, right, CFG_2K, CFG_2K.frontend.band_pitches_deg)
    ii = integral.integral_image(bands)  # (8, 257, 2049)
    ii64 = torch.cumsum(torch.cumsum(bands.double(), dim=-2), dim=-1)
    max_abs = ii64.abs().max().item()
    err = (ii[:, 1:, 1:].double() - ii64).abs().max().item()
    # the bound that test_torch_surf.py's det tolerance assumes of each package
    ii_bound = 2 * float(np.finfo(np.float32).eps) * max_abs
    log("integral_image", shape=list(ii.shape), max_abs=max_abs, max_abs_err_vs_float64=err,
        cpu_test_bound=ii_bound, within_cpu_test_bound=err <= ii_bound)
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

    rows.append(dict(
        name="top2_distances", route="cuda", source="spherical_bundle_adjuster_tpu_torch/csrc/match_top2.cu",
        replaces="spherical_bundle_adjuster_tpu/ops/pallas_match.py:89",
        max_abs_err=err, max_abs_err_ties=terr, max_abs_err_ragged=rerr,
        ms=time_ms(lambda: cuda_match.top2_distances_cuda(d1, d2, v2)),
        plain_ms=time_ms(lambda: cuda_match.top2_distances_plain(d1, d2, v2)),
        **bound(nbytes(d1, d2, v2, dist, idx), 2 * d1.shape[0] * d2.shape[0] * d1.shape[1]),
        library_ms=time_ms(library_top2), library="torch.cdist + torch.topk(2, largest=False)",
        tolerance="identical indices; distance atol 2e-3 (2048 x 2048, planted ties, "
                  "1000 x 2100); all-invalid gives (inf, index 0)",
    ))
    for r in rows:
        log("kernel", **r)
    return rows


def run_pair(left, right, cfg, dev, seed):
    """One run_two_view call and its wall time in ms (CUDA events on the
    current stream; the pipeline syncs the host on its own as it goes)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = twoview.run_two_view(left, right, torch.Generator(dev).manual_seed(seed), cfg,
                               frontend="band")
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
    for k in LAUNCHED:
        k.launches = 0
    results = [run_pair(l, r, cfg, dev, seed=i) for i, (l, r, _) in enumerate(pairs)]
    counts = {k.symbol: k.launches for k in LAUNCHED}
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


def main():
    dev, smi = phase_device()
    phase_build()
    rows = phase_kernels(dev)
    counts = phase_slice(dev)
    by_phase = {"slice_2k_corrected": (phase_2k_corrected(dev), N_PAIRS_2K)}
    for mode, c in phase_512(dev).items():
        by_phase[f"pair_512x1024_{mode}"] = (c, N_PAIRS_512)
    by_phase["pitch60_corrected"] = (phase_pitch60(dev), N_PAIRS_PITCH)
    for r, sym in zip(rows, ("sba_det_pyramid", "sba_haar_trace", "sba_top2")):
        r["launches"] = counts[sym]
        r["launches_per_pair"] = counts[sym] / N_PAIRS_2K
        r["launches_per_pair_by_phase"] = {k: c[sym] / n for k, (c, n) in by_phase.items()}
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
