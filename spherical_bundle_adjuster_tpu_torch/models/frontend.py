"""Spherical feature front-ends, from
spherical_bundle_adjuster_tpu/models/frontend.py: the reference's three
interchangeable strategies, each returning matched ERP pixel pairs.

  * erp     — SURF directly on the full ERP images
  * band    — 4 pitch-rotated equatorial bands per image (the reference's
              active strategy)
  * cubemap — SURF on the ERP -> cube strip (S, 6S), keypoints mapped
              back to ERP pixels, each image sized on its own

Every front end runs P pairs at once (`frontend_pairs`, images
(P, H, W, 3)): all images or bands of the P pairs are detected and
described as one batch (one K1 and one K2 launch) and matched pair by
pair in one K3 launch. `chunk` bounds the pairs of one pass. The
single-pair functions in FRONTENDS are the batch of one.

Band ladder selection (FrontendConfig.band_ladder): "parity" runs the
reference's 4-pitch ladder, "dense" the 22.5-degree ladder, and "auto"
runs parity for every pair, reads the match counts back once, and re-runs
only the pairs with fewer than auto_min_matches matches on the dense
ladder (the reference traced both branches of a lax.cond; here the dense
ladder costs nothing unless a pair needs it).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..core import cube
from ..ops import integral, match, surf, warp
from ..utils import profiling
from ..utils.config import DENSE_BAND_PITCHES, PipelineConfig


class FrontendResult(NamedTuple):
    """Matched keypoints in ERP pixel coordinates (static capacity M),
    with an optional leading pair axis."""

    left_xy: torch.Tensor         # (..., M, 2)
    right_xy: torch.Tensor        # (..., M, 2)
    match_valid: torch.Tensor     # (..., M) bool
    match_distance: torch.Tensor  # (..., M)
    total_keypoints: torch.Tensor  # (...): valid left keypoints

    @property
    def match_count(self):
        return torch.sum(self.match_valid.to(torch.int32), dim=-1)


def _match_banks(xy_l, desc_l, valid_l, xy_r, desc_r, valid_r, cfg: PipelineConfig):
    """Match each pair's banks (P, N, ...) and look up the matched pixels."""
    mt = match.match_descriptors(desc_l, valid_l, desc_r, valid_r, cfg=cfg.match)
    mv = mt.valid[..., None]
    return FrontendResult(
        left_xy=torch.where(mv, torch.take_along_dim(xy_l, mt.query_idx.long()[..., None], -2), 0.0),
        right_xy=torch.where(mv, torch.take_along_dim(xy_r, mt.train_idx.long()[..., None], -2), 0.0),
        match_valid=mt.valid,
        match_distance=mt.distance,
        total_keypoints=torch.sum(valid_l.to(torch.int32), dim=-1),
    )


def _banks(kp, desc, xy_erp, p):
    """Per-image keypoint banks (2P * n, K, ...), each pair's left images
    first, -> (xy, desc, valid) of the left and the right image of each
    pair, (P, n * K, ...) each."""
    out = []
    for x in (xy_erp, desc, kp.valid):
        x = x.reshape((p, 2, -1) + x.shape[2:])
        out.append((x[:, 0], x[:, 1]))
    (xl, xr), (dl, dr), (vl, vr) = out
    return xl, dl, vl, xr, dr, vr


def _gray_pairs(lefts, rights):
    """(P, H, W, 3) pairs -> gray (2P, H, W), each pair's left image first."""
    return integral.rgb_to_gray(torch.stack([lefts, rights], dim=1).flatten(0, 1))


def crop_bands(im_left, im_right, cfg: PipelineConfig, pitch_list):
    """Gray bands of P pairs (P, H, W, 3) at the pitch ladder (degrees):
    (P, 2B, H/4, W), each pair's left image's B bands first."""
    p, h, w = im_left.shape[:3]
    dev = im_left.device
    # Grayscale before warping: pointwise conversion commutes exactly
    # with floor / nearest gathers. The 2P gray images ride the channel
    # axis, so each pitch is one gather for all of them.
    gray = _gray_pairs(im_left, im_right).permute(1, 2, 0)  # (H, W, 2P)

    # The 0-degree band is a plain row slice (crop_rotated_band at pitch 0
    # floors identity coordinates, so the slice is bit-identical).
    nonzero = [q for q in pitch_list if q != 0.0]
    nz_rad = torch.deg2rad(torch.tensor(nonzero, dtype=torch.float32, device=dev))
    warped = (warp.crop_rotated_band(gray, nz_rad, cfg.frontend.resample_mode)
              if nonzero else None)
    r0 = 3 * h // 8
    outs, wi = [], 0
    for q in pitch_list:
        if q == 0.0:
            outs.append(gray[r0 : r0 + h // 4])
        else:
            outs.append(warped[wi])
            wi += 1
    bands = torch.stack(outs)  # (B, H/4, W, 2P)
    return bands.permute(3, 0, 1, 2).reshape(p, 2 * len(pitch_list), h // 4, w)


def _band_pairs(lefts, rights, cfg: PipelineConfig, pitch_list):
    """Band front-end of P pairs at a fixed pitch ladder (degrees)."""
    p, h, w = lefts.shape[:3]
    bands = crop_bands(lefts, rights, cfg, pitch_list)  # (P, 2B, H/4, W)
    kp, desc = surf.detect_and_describe(bands.flatten(0, 1), cfg.surf)
    pitches = torch.deg2rad(torch.tensor(list(pitch_list) * (2 * p), dtype=torch.float32,
                                         device=lefts.device))
    xy_erp = warp.band_pixel_to_erp(kp.xy, pitches, w, h)  # (2PB, K, 2)
    return _match_banks(*_banks(kp, desc, xy_erp, p), cfg)


def _erp_pairs(lefts, rights, cfg: PipelineConfig):
    """Full-ERP SURF and matching of P pairs."""
    p = lefts.shape[0]
    kp, desc = surf.detect_and_describe(_gray_pairs(lefts, rights), cfg.surf)
    return _match_banks(*_banks(kp, desc, kp.xy, p), cfg)


def _cubemap_pairs(lefts, rights, cfg: PipelineConfig):
    """Cube-strip SURF of P pairs, keypoints mapped back to ERP pixels."""
    p, h, w = lefts.shape[:3]
    s = cfg.frontend.cube_size
    gray = _gray_pairs(lefts, rights).permute(1, 2, 0)  # (H, W, 2P)
    strips = warp.equi_to_cubemap(gray, s, cfg.frontend.resample_mode)  # (S, 6S, 2P)
    kp, desc = surf.detect_and_describe(strips.permute(2, 0, 1).contiguous(), cfg.surf)
    xy_erp = cube.cube_pixel_to_erp_pixel(kp.xy, s, w, h)
    return _match_banks(*_banks(kp, desc, xy_erp, p), cfg)


def _chunked(fn, lefts, rights, cfg, chunk: int):
    """fn over the pairs, `chunk` pairs a pass (0: all in one)."""
    p = lefts.shape[0]
    if not chunk or chunk >= p:
        return fn(lefts, rights, cfg)
    parts = [fn(lefts[i : i + chunk], rights[i : i + chunk], cfg) for i in range(0, p, chunk)]
    return FrontendResult(*(torch.cat(f) for f in zip(*parts)))


_PAIR_FRONTENDS = {"erp": _erp_pairs, "cubemap": _cubemap_pairs}


@profiling.spanned("sba.frontend")
def frontend_pairs(name: str, lefts, rights, cfg: PipelineConfig = PipelineConfig(),
                   chunk: int = 0) -> FrontendResult:
    """P pairs (P, H, W, 3) through front end `name`, `chunk` pairs per
    device pass (0: all at once): a FrontendResult with (P, ...) fields."""
    if name != "band":
        if name not in _PAIR_FRONTENDS:
            raise ValueError(f"unknown front end {name!r}; one of {sorted(FRONTENDS)}")
        return _chunked(_PAIR_FRONTENDS[name], lefts, rights, cfg, chunk)
    fcfg = cfg.frontend
    parity = partial(_band_pairs, pitch_list=fcfg.band_pitches_deg)
    dense = partial(_band_pairs, pitch_list=DENSE_BAND_PITCHES)
    if fcfg.band_ladder == "parity":
        return _chunked(parity, lefts, rights, cfg, chunk)
    if fcfg.band_ladder == "dense":
        return _chunked(dense, lefts, rights, cfg, chunk)
    if fcfg.band_ladder != "auto":
        raise ValueError(f"unknown band_ladder {fcfg.band_ladder!r}")
    fr = _chunked(parity, lefts, rights, cfg, chunk)
    short = torch.nonzero(fr.match_count < fcfg.auto_min_matches).flatten()  # one readback
    if short.numel():
        sub = _chunked(dense, lefts[short], rights[short], cfg, chunk)
        fr = FrontendResult(*(a.index_copy(0, short, b) for a, b in zip(fr, sub)))
    return fr


def _one_pair(name, im_left, im_right, cfg):
    fr = frontend_pairs(name, im_left[None], im_right[None], cfg)
    return FrontendResult(*(f[0] for f in fr))


def erp_frontend(im_left, im_right, cfg: PipelineConfig = PipelineConfig()):
    """Naive full-ERP SURF + match of one pair (H, W, 3)."""
    return _one_pair("erp", im_left, im_right, cfg)


def band_frontend(im_left, im_right, cfg: PipelineConfig = PipelineConfig()):
    """Band-rotation front-end of one pair — the reference's active strategy."""
    return _one_pair("band", im_left, im_right, cfg)


def cubemap_frontend(im_left, im_right, cfg: PipelineConfig = PipelineConfig()):
    """Cubemap front-end of one pair: cube strips of side
    cfg.frontend.cube_size, keypoints mapped back to ERP pixels."""
    return _one_pair("cubemap", im_left, im_right, cfg)


FRONTENDS = {"erp": erp_frontend, "band": band_frontend, "cubemap": cubemap_frontend}
