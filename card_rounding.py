"""Where rounding on the card moves the port's results, on one NVIDIA GPU.

    python3 card_rounding.py [--pairs N]

Prints one JSON line per reading:

  batch_vs_single: the 64-pair batch of the bench's headline point
    (compat, 512x1024, problems.py's 16 distinct pairs tiled to 64, the
    same draws; its first N pairs with --pairs) through run_two_view_batch,
    each pair against run_two_view on that pair with its draw row and
    against run_two_view_batch on that pair alone (P = 1): whether the
    match lists are identical, and the gaps (deg) between the consensus
    initial guesses and between the final rotations.
  first_differing_op: the consensus initial guess (epipolar.initial_guess)
    of every pair of the batch, traced torch call by torch call in the
    batch and for each pair alone, on identical matches and draws: per
    pair, the first call whose output differs between the pair's row of
    the batch and its run alone, with the largest difference, and how
    many pairs each call moves first. The refinement (the BCD from the
    batch's initial guesses, in the batch and alone) is traced the same
    way, with the rotation gap it adds on its own.
  warps: what the warps sample differently on the card and on its host's
    CPU for one 1024x2048 pair: the band crops' pixels (float32
    coordinates, as the reference's), and the 600-pixel cube strip's
    samples whose floor pixel differs with the faces' coordinates in
    float32 and, as the port computes them, in float64.

Run from the repository root (it reuses the pairs and configs of
spherical_bundle_adjuster_tpu_torch/problems.py). Needs one card; it
builds the kernels with ops/kernels.build.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from spherical_bundle_adjuster_tpu_torch import problems
from spherical_bundle_adjuster_tpu_torch.core import cube, sphere
from spherical_bundle_adjuster_tpu_torch.models import frontend, twoview
from spherical_bundle_adjuster_tpu_torch.ops import integral, kernels, warp
from spherical_bundle_adjuster_tpu_torch.solver import epipolar


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out.detach()]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


class OpTrace(TorchFunctionMode):
    """The name and tensor outputs of every torch call that returns a
    tensor, in call order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ts = _tensors(out)
        if ts:
            self.ops.append((getattr(func, "__name__", repr(func)), ts))
        return out


def traced(fn):
    with OpTrace() as tr:
        out = fn()
    return out, tr.ops


def _max_diff(a, b):
    if a.dtype == torch.bool:
        return float((a != b).sum())
    a, b = a.double(), b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b)[fin].abs().max()) if bool(fin.any()) else float("inf")


def first_divergence(batch_ops, single_ops, i, n_pairs):
    """The first call whose output differs between row i of the batch's
    trace and the single run's trace: its index, name and largest
    difference; the first call that differs in name where the two traces
    part first; None where they agree throughout their common length."""
    for k, ((nb, tb), (ns, ts)) in enumerate(zip(batch_ops, single_ops)):
        if nb != ns:
            return dict(op=k, name=f"paths part: {nb} / {ns}", diff=None)
        for b, s in zip(tb, ts):
            if b.shape != (n_pairs,) + s.shape:  # constants, and reductions over the pairs
                continue
            b = b[i]
            same = (b == s) | (torch.isnan(b) & torch.isnan(s)) if b.is_floating_point() else b == s
            if not bool(same.all()):
                return dict(op=k, name=nb, diff=_max_diff(b, s), shape=list(s.shape))
    return None


def rot_gap_deg(aa_a, aa_b):
    return problems.rot_err_deg_host(aa_a.cpu().numpy(),
                                     problems.angle_axis_matrix(aa_b.cpu().numpy()))


def euler_gap_deg(e_a, e_b):
    return rot_gap_deg(torch.as_tensor(problems.angle_axis_of(e_a)),
                       torch.as_tensor(problems.angle_axis_of(e_b)))


def batch_vs_single(dev, n_pairs):
    h, w = problems.SIZE_512
    cfg = problems.CFG_512
    pairs = [problems.make_pair(i, h, w, dev) for i in range(problems.N_DISTINCT)]
    reps = -(-problems.N_BATCH // problems.N_DISTINCT)
    lefts, rights = (x.repeat(reps, 1, 1, 1)[:n_pairs] for x in problems.stacked(pairs))
    gumbel = problems.draws(cfg, problems.N_BATCH, dev)[:n_pairs]
    out = twoview.run_two_view_batch(lefts, rights, None, cfg, gumbel=gumbel)
    rows = []
    for i in range(n_pairs):
        one = twoview.run_two_view(lefts[i], rights[i], None, cfg, gumbel=gumbel[i])
        p1 = twoview.run_two_view_batch(lefts[i:i + 1], rights[i:i + 1], None, cfg,
                                        gumbel=gumbel[i:i + 1])
        row = problems.pair_of(out, i)
        rows.append(dict(
            same_matches=problems.same_matches(one, row),
            init_gap_deg=euler_gap_deg(one.initial_euler, row.initial_euler),
            rot_gap_deg=rot_gap_deg(one.rotation_aa, row.rotation_aa),
            p1_init_gap_deg=euler_gap_deg(p1.initial_euler[0], row.initial_euler),
            p1_rot_gap_deg=rot_gap_deg(p1.rotation_aa[0], row.rotation_aa)))
    cols = {k: [r[k] for r in rows] for k in rows[0]}
    gaps = np.asarray(cols["rot_gap_deg"])
    print(json.dumps(dict(
        reading="batch_vs_single", pairs=n_pairs, all_same_matches=all(cols["same_matches"]),
        max_rot_gap_deg=float(gaps.max()), median_rot_gap_deg=float(np.median(gaps)),
        pairs_moved=int((gaps > 0).sum()), max_init_gap_deg=max(cols["init_gap_deg"]),
        max_p1_rot_gap_deg=max(cols["p1_rot_gap_deg"]),
        max_p1_init_gap_deg=max(cols["p1_init_gap_deg"]), **cols)), flush=True)
    return out, gumbel


def op_trace(out, gumbel, dev):
    """The first differing call of the consensus stage and of the BCD."""
    h, w = problems.SIZE_512
    cfg = problems.CFG_512
    n = out.match_valid.shape[0]
    fr = frontend.FrontendResult(out.left_xy, out.right_xy, out.match_valid,
                                 out.match_distance, out.total_keypoints)
    bl, br = twoview.lift_matches(fr, w, h)
    mv = out.match_valid
    guess, b_ops = traced(lambda: epipolar.initial_guess(bl, br, mv, None, cfg.ransac, gumbel))
    init_d = torch.full(bl.shape[:-1] + (2,), cfg.ba.init_depth, device=dev)
    solve = lambda b_l, b_r, v, g, d: twoview._solve_from_init(
        b_l, b_r, v, g.euler, g.translation, g.ok, cfg, d)
    (r_b, *_), s_ops = traced(lambda: solve(bl, br, mv, guess, init_d))
    consensus, bcd, bcd_gaps = [], [], []
    for i in range(n):
        bl_i, br_i, mv_i, gumbel_i, d_i = bl[i], br[i], mv[i], gumbel[i], init_d[i]
        _, ops = traced(lambda: epipolar.initial_guess(bl_i, br_i, mv_i, None, cfg.ransac,
                                                       gumbel_i))
        consensus.append(first_divergence(b_ops, ops, i, n))
        del ops
        g_i = epipolar.InitialGuess(*(f[i] for f in guess))
        (r_i, *_), ops = traced(lambda: solve(bl_i, br_i, mv_i, g_i, d_i))
        bcd.append(first_divergence(s_ops, ops, i, n))
        bcd_gaps.append(rot_gap_deg(r_i, r_b[i]))
        del ops

    def tally(firsts):
        c = collections.Counter(f"{f['op']}:{f['name']}" if f else "none" for f in firsts)
        return dict(c.most_common())

    print(json.dumps(dict(
        reading="first_differing_op", pairs=n,
        consensus_first_differing=tally(consensus), consensus=consensus,
        bcd_first_differing=tally(bcd), bcd=bcd, bcd_max_rot_gap_deg=max(bcd_gaps),
        bcd_rot_gap_deg=bcd_gaps)), flush=True)


def warps(dev):
    h, w = problems.SIZE_2K
    cfg = problems.CFG_2K
    left, right, _ = problems.make_pair(0, h, w, dev)

    def coords32(device):
        rays = cube.face_rays(problems.CUBE_2K, device=device)
        v = rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)
        return sphere.spherical_to_pixel(sphere.cartesian_to_spherical(v), w, h)

    def pixel(c):
        return torch.floor(c.double().cpu() + 2e-3)

    pitches = cfg.frontend.band_pitches_deg
    bands = [frontend.crop_bands(l[None], r[None], cfg, pitches).cpu()
             for l, r in ((left, right), (left.cpu(), right.cpu()))]
    out = dict(reading="warps", band_pixels=bands[0].numel(),
               band_pixels_changed=int((bands[0] != bands[1]).sum()))
    gray = integral.rgb_to_gray(left)
    for name, fn in (("float32", coords32),
                     ("float64", lambda d: warp._face_coords(problems.CUBE_2K, w, h, d))):
        a, b = fn(gray.device), fn(torch.device("cpu"))
        out[f"cube_samples_flipped_{name}"] = int((pixel(a) != pixel(b)).any(-1).sum())
    strips = [warp.resample(g, coords32(g.device)).cpu() for g in (gray, gray.cpu())]
    out["cube_samples"] = 6 * problems.CUBE_2K ** 2
    out["cube_strip_pixels_changed_float32"] = int((strips[0] != strips[1]).sum())
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=problems.N_BATCH)
    args = ap.parse_args()
    dev, smi = problems.phase_device()
    kernels.build()
    torch.set_num_threads(os.cpu_count() or 1)
    out, gumbel = batch_vs_single(dev, args.pairs)
    op_trace(out, gumbel, dev)
    warps(dev)
    print(smi, flush=True)


if __name__ == "__main__":
    sys.exit(main())
