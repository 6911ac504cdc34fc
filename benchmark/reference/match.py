"""Descriptor matching: exact brute-force top-2 + Lowe ratio test.

Counterpart of spherical_bundle_adjuster_tpu/ops/match.py. The top-2
comes from top2.top2_distances_plain (plain PyTorch) on every device.
The output is a fixed-capacity match list packed by ascending distance
(stable sort, as jnp.argsort). `mutual_check` back-matches each train
column over the full K1 x K2 squared-distance matrix in plain PyTorch, as
the reference's dense branch does outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import MatchConfig
from . import top2


class Matches(NamedTuple):
    """Fixed-capacity match set (M = cfg.max_matches): query_idx /
    train_idx (..., M) int32, distance (..., M), valid (..., M) bool; valid
    entries packed first, by ascending distance."""

    query_idx: torch.Tensor
    train_idx: torch.Tensor
    distance: torch.Tensor
    valid: torch.Tensor

    @property
    def count(self):
        return torch.sum(self.valid.to(torch.int32), dim=-1)


def match_descriptors(desc1, valid1, desc2, valid2, cfg: MatchConfig = MatchConfig()):
    """One-way kNN(k=2) + ratio test. desc1: (..., K1, D) queries, desc2:
    (..., K2, D) train bank, valid1 / valid2: bool masks of the padded
    slots. A leading pair axis matches P independent pairs of banks at
    once (one K3 launch)."""
    d1 = desc1.to(torch.float32).contiguous()
    d2 = desc2.to(torch.float32).contiguous()
    dists, idx2 = top2.top2_distances_plain(d1, d2, valid2.contiguous())
    best, second = dists[..., 0], dists[..., 1]
    best_idx = idx2[..., 0]
    good = (
        valid1
        & torch.isfinite(best)
        & torch.isfinite(second)
        & (best < cfg.ratio_thresh * second)
    )
    k1 = best.shape[-1]
    if cfg.mutual_check:
        # the best query of the best train column must point back
        # (argmin: the first minimum, as jnp.argmin)
        sq1 = torch.sum(d1 * d1, dim=-1, keepdim=True)
        sq2 = torch.sum(d2 * d2, dim=-1)[..., None, :]
        dist2 = torch.clamp(sq1 + sq2 - 2.0 * (d1 @ d2.transpose(-1, -2)), min=0.0)
        keep = valid1[..., :, None] & valid2[..., None, :]
        back = torch.argmin(torch.where(keep, dist2, torch.inf), dim=-2)
        good = good & (torch.gather(back, -1, best_idx.long())
                       == torch.arange(k1, device=d1.device))

    m = cfg.max_matches
    score = torch.where(good, best, torch.inf)
    order = torch.argsort(score, dim=-1, stable=True)
    if k1 >= m:
        take = order[..., :m]
    else:
        take = torch.cat([order, order.new_zeros(order.shape[:-1] + (m - k1,))], dim=-1)
    n_good = torch.sum(good.to(torch.int32), dim=-1, keepdim=True)
    v = torch.gather(good, -1, take) & (torch.arange(m, device=take.device) < n_good)
    return Matches(
        query_idx=torch.where(v, take.to(torch.int32), 0),
        train_idx=torch.where(v, torch.gather(best_idx, -1, take), 0),
        distance=torch.where(v, torch.gather(best, -1, take), 0.0),
        valid=v,
    )
