"""Two-view spherical bundle adjustment — the reference tool's product
path (main.cpp -> do_bundle_adjustment: one ERP pair in, one relative
pose out), ported from spherical_bundle_adjuster_tpu/models/twoview.py.

Stages:
  1. band front-end                         -> matched ERP pixel pairs
  2. pixel -> unit-bearing lifting          -> (M, 3) bearing banks
  3. consensus 8-point initial guess (the top k and a Kabsch rotation-only
     start with BaConfig.multi_start = k in corrected mode)
  4. depth init + the reference's init quirks (reference_compat)
  5. block-coordinate descent d -> rot -> tran; in corrected mode with
     epipolar and reprojection outlier gates, a joint Schur polish, and
     the winning start chosen by its trimmed residual (or by its
     rotation-only residual when a pure rotation explains the matches)

The k starts run as one batch through every stage (a leading start axis
in solver/lm), as the reference vmapped them. `run_two_view_batch` runs
P pairs the same way: the front end in passes of `batch_chunk` pairs
(one K1, K2 and K3 launch each), then one solve with a leading pair axis
for the whole batch, so each host sync and launch of the solver is paid
once per batch, not once per pair.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import rotation, sphere
from . import epipolar, lm
from .config import PipelineConfig
from .frontend import FRONTENDS, FrontendResult


class SolverTelemetry(NamedTuple):
    """Per-BCD-stage convergence telemetry of the final solve of the
    winning start; each of depth / rot / tran is an lm.StageReport whose
    fields are shaped (..., bcd_rounds). `start` is the winning start's
    index (0 with one start) and `rot_dominant` whether the
    rotation-dominant selection chose it. A batch adds a leading pair
    axis to every field."""

    depth: lm.StageReport
    rot: lm.StageReport
    tran: lm.StageReport
    start: torch.Tensor
    rot_dominant: torch.Tensor


class TwoViewResult(NamedTuple):
    """One pair's result; run_two_view_batch adds a leading pair axis to
    every field."""

    rotation_aa: torch.Tensor      # (3,) refined rotation (angle-axis)
    rotation_deg: torch.Tensor     # (3,) angle-axis components * 180/pi
    translation: torch.Tensor      # (3,)
    depths: torch.Tensor           # (M, 2) per-match (d1, d2)
    initial_euler: torch.Tensor    # (3,) consensus initial guess
    initial_translation: torch.Tensor
    match_valid: torch.Tensor      # (M,)
    match_distance: torch.Tensor   # (M,)
    left_xy: torch.Tensor          # (M, 2)
    right_xy: torch.Tensor         # (M, 2)
    num_matches: torch.Tensor      # scalar int
    total_keypoints: torch.Tensor  # scalar int
    ok: torch.Tensor               # scalar bool (initial guess found)
    telemetry: SolverTelemetry


def lift_matches(fr: FrontendResult, width, height):
    """Matched ERP pixels -> unit bearing banks."""
    return (
        sphere.pixel_to_bearing(fr.left_xy, width, height),
        sphere.pixel_to_bearing(fr.right_xy, width, height),
    )


def _pred_angular_residual(b_left, b_right, r, t, d):
    """Per-match angle between b_right and the reprojected left ray, for
    r, t (..., 3) and d (..., M, 2): (..., M)."""
    x1 = b_left * d[..., 0:1]
    pred = rotation.rotate_angle_axis(r[..., None, :].expand(x1.shape), x1) - t[..., None, :]
    pred = pred / torch.clamp(torch.linalg.vector_norm(pred, dim=-1, keepdim=True), min=1e-12)
    return sphere.angular_distance(pred, b_right.expand(pred.shape))


def _trimmed_mean_masked(x, valid, keep_frac=0.8):
    """Mean of the smallest keep_frac of x (..., M) over valid slots."""
    n = torch.sum(valid.to(torch.int32), dim=-1)
    xs = torch.sort(torch.where(valid, x, torch.inf), dim=-1).values
    hi = torch.clamp(torch.floor(keep_frac * n.to(torch.float32)).to(torch.int64), min=1)
    keep = torch.arange(x.shape[-1], device=x.device) < hi[..., None]
    kept = torch.where(keep & torch.isfinite(xs), xs, 0.0)
    return torch.sum(kept, dim=-1) / hi.to(torch.float32)


def _solve_from_init(b_left, b_right, base_valid, euler0, t0, ok, cfg, init_d):
    """The refinement from consensus candidates euler0, t0 (..., 3), ...
    an optional pair axis, then an optional start axis, with banks
    (..., M, 3), masks (..., M) and depths (..., M, 2) that broadcast
    against it: the stage-1 epipolar gate, BCD rounds of d -> rot -> tran,
    the iterated stage-2 reprojection gates each followed by a BCD
    re-solve from the init, and the joint Schur polish, as cfg.ba asks.
    ok broadcasts against ... . Returns (r, t, d, score, (depth, rot,
    tran) reports): score is the 20%-trimmed mean angular residual over
    the pre-gate matches, the multi-start criterion."""
    ba = cfg.ba
    lead = euler0.shape[:-1]
    base_valid = base_valid.expand(lead + base_valid.shape[-1:])
    init_d = init_d.expand(lead + init_d.shape[-2:])
    ok = ok[..., None]  # against (..., M) and (..., 3)
    match_valid = base_valid
    thresh = math.radians(ba.outlier_thresh_deg)
    if ba.outlier_reject:
        # Stage-1 gate: each candidate's epipolar residuals, trusted only
        # when a consensus pose exists.
        gated = epipolar.epipolar_inlier_mask(b_left, b_right, match_valid, euler0, t0,
                                              thresh, min_keep=ba.outlier_min_keep)
        match_valid = torch.where(ok, gated, match_valid)

    if ba.reference_compat:
        # Quirk (reference :330): the negated Euler consensus vector is used
        # directly as the angle-axis init.
        r0 = -euler0
    else:
        # The 8-point decomposition recovers R^T, so the exact init inverts
        # the consensus rotation.
        r0 = -rotation.euler_to_angle_axis(euler0)

    def run_bcd(valid_mask):
        r, t, d = r0, t0, init_d
        reps = []
        for _ in range(ba.bcd_rounds):
            d, rep_d = lm.solve_depths(b_left, b_right, d, r, t, valid_mask, ba)
            if ba.reference_compat:
                # Quirk (:941-942, :998-999): every rot / tran residual uses
                # the first two matches' LEFT depths as (d1, d2).
                d_pair = torch.stack([d[..., 0, 0], d[..., 1, 0]], dim=-1)
            else:
                d_pair = d
            r, rep_r = lm.solve_rotation(b_left, b_right, d_pair, r, t, valid_mask, ba)
            t, rep_t = lm.solve_translation(b_left, b_right, d_pair, r, t, valid_mask, ba)
            reps.append((rep_d, rep_r, rep_t))
        return r, t, d, reps

    r, t, d, reps = run_bcd(match_valid)
    if ba.outlier_reject:
        # Stage-2 gates: residuals against the refined pose, then a re-solve
        # on the cleaner set; each round's sharper pose exposes more.
        for _ in range(ba.outlier_rounds):
            ang = _pred_angular_residual(b_left, b_right, r, t, d)
            gated = epipolar.residual_inlier_mask(ang, match_valid, thresh,
                                                  min_keep=ba.outlier_min_keep)
            match_valid = torch.where(ok, gated, match_valid)
            r, t, d, reps = run_bcd(match_valid)

    if ba.joint_refine:
        r, t, d, _ = lm.solve_joint_schur(b_left, b_right, d, r, t, match_valid, ba)

    # over the pre-gate matches: a start must not win by gating away the
    # matches it cannot explain
    ang = _pred_angular_residual(b_left, b_right, r, t, d)
    score = _trimmed_mean_masked(ang, base_valid, keep_frac=0.8)

    # Without a consensus initial guess the solve is discarded: report the
    # init pose and mask the telemetry (0 iterations, NaN costs).
    r = torch.where(ok, r, r0)
    t = torch.where(ok, t, t0)
    d = torch.where(ok[..., None], d, init_d)

    def stage(i):  # one stage's reports over the BCD rounds: (..., bcd_rounds)
        fields = zip(*(rs[i] for rs in reps))
        return lm.StageReport(*(torch.where(ok, f, _masked(f))
                                for f in (torch.stack(x, dim=-1) for x in fields)))

    return r, t, d, score, (stage(0), stage(1), stage(2))


def _masked(x):
    return torch.full_like(x, math.nan) if x.is_floating_point() else torch.zeros_like(x)


def _select_start(b_left, b_right, match_valid, rs, scores, ba):
    """The winning start of a multi-start solve, per pair: the lowest
    score, unless some start explains the matches as a pure rotation to a
    median residual below max(rot_dominant_select_deg, 1.5 x the best
    score), capped at 3 deg; then the start of lowest rotation-only
    median. rs (..., S, 3), scores (..., S). Returns (index, whether the
    rotation-only criterion chose it), each (...)."""
    win = torch.argmin(scores, dim=-1)
    if ba.rot_dominant_select_deg <= 0:
        return win, torch.zeros(win.shape, dtype=torch.bool, device=win.device)
    shape = rs.shape[:-1] + b_left.shape[-2:]
    pred = rotation.rotate_angle_axis(rs[..., None, :].expand(shape), b_left.expand(shape))
    mr = epipolar.masked_median(sphere.angular_distance(pred, b_right.expand(shape)), match_valid)
    thresh = torch.clamp(torch.clamp(1.5 * torch.amin(scores, dim=-1),
                                     min=math.radians(ba.rot_dominant_select_deg)),
                         max=math.radians(3.0))
    rot_dom = torch.amin(mr, dim=-1) < thresh
    return torch.where(rot_dom, torch.argmin(mr, dim=-1), win), rot_dom


def adjust_from_matches(b_left, b_right, match_valid, generator,
                        cfg: PipelineConfig = PipelineConfig(), init_depth=None,
                        gumbel=None):
    """Initial guess + BCD refinement given lifted matched bearings
    (..., M, 3) with an optional leading pair axis, each pair solved as it
    would be alone.

    With cfg.ba.multi_start = k > 0 in corrected mode, the top-k
    consensus candidates (the last one the Kabsch rotation-only start)
    are refined as one batch and the best start wins (_select_start).
    gumbel: optional (..., num_trials, M) RANSAC draws (else drawn from
    `generator`). Returns (r, t, d, InitialGuess, SolverTelemetry).
    """
    ba = cfg.ba
    d0 = ba.init_depth if init_depth is None else init_depth
    dev = b_left.device
    lead = match_valid.shape[:-1]
    init_d = torch.full(b_left.shape[:-1] + (2,), d0, dtype=torch.float32, device=dev)

    if ba.multi_start and not ba.reference_compat:
        e_k, t_k, ok = epipolar.initial_guess_topk(b_left, b_right, match_valid, generator,
                                                   cfg.ransac, ba.multi_start, gumbel)
        if lead:  # each pair's bank, shared by its starts
            b_left, b_right = b_left[..., None, :, :], b_right[..., None, :, :]
            match_valid, init_d = match_valid[..., None, :], init_d[..., None, :, :]
        rs, ts, ds, scores, reps = _solve_from_init(b_left, b_right, match_valid, e_k, t_k,
                                                    ok[..., None], cfg, init_d)
        win, rot_dom = _select_start(b_left, b_right, match_valid, rs, scores, ba)
        guess = epipolar.InitialGuess(
            euler=epipolar.pick(e_k, win), translation=epipolar.pick(t_k, win),
            num_candidates=torch.full(lead, ba.multi_start, device=dev), ok=ok,
        )
        tel = SolverTelemetry(*(lm.StageReport(*(epipolar.pick(f, win) for f in rep))
                                for rep in reps),
                              start=win, rot_dominant=rot_dom)
        return (epipolar.pick(rs, win), epipolar.pick(ts, win), epipolar.pick(ds, win),
                guess, tel)

    guess = epipolar.initial_guess(b_left, b_right, match_valid, generator, cfg.ransac, gumbel)
    r, t, d, _, reps = _solve_from_init(
        b_left, b_right, match_valid, guess.euler, guess.translation, guess.ok, cfg, init_d
    )
    tel = SolverTelemetry(*reps, start=torch.zeros(lead, dtype=torch.int64, device=dev),
                          rot_dominant=torch.zeros(lead, dtype=torch.bool, device=dev))
    return r, t, d, guess, tel


def _result(fr: FrontendResult, r, t, d, guess, tel) -> TwoViewResult:
    return TwoViewResult(
        rotation_aa=r,
        rotation_deg=r / math.pi * 180.0,
        translation=t,
        depths=d,
        initial_euler=guess.euler,
        initial_translation=guess.translation,
        match_valid=fr.match_valid,
        match_distance=fr.match_distance,
        left_xy=fr.left_xy,
        right_xy=fr.right_xy,
        num_matches=fr.match_count,
        total_keypoints=fr.total_keypoints,
        ok=guess.ok,
        telemetry=tel,
    )


def run_two_view(im_left, im_right, generator, cfg: PipelineConfig = PipelineConfig(),
                 frontend: str = "band", gumbel=None) -> TwoViewResult:
    """End-to-end two-view spherical BA on an ERP image pair (H, W, 3).
    Runs on the images' device; `generator` (a torch.Generator on that
    device) drives the RANSAC subsampling unless `gumbel`
    (num_trials, max_matches) is given."""
    if frontend not in FRONTENDS:
        raise ValueError(f"unknown front end {frontend!r}; one of {sorted(FRONTENDS)}")
    h, w = im_left.shape[0], im_left.shape[1]
    fr = FRONTENDS[frontend](im_left, im_right, cfg)
    b_left, b_right = lift_matches(fr, w, h)
    r, t, d, guess, tel = adjust_from_matches(
        b_left, b_right, fr.match_valid, generator, cfg, gumbel=gumbel
    )
    return _result(fr, r, t, d, guess, tel)
