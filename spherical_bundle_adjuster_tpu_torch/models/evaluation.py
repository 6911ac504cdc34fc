"""Front-end evaluation: matched keypoints scored against a known
ground-truth rotation (the reference's test/feature_test.cpp metrics),
from spherical_bundle_adjuster_tpu/models/evaluation.py.

A match is an inlier iff angle(R_gt @ b_left, b_right) is at most the
threshold. `compare_frontends` scores all three front-ends on one pair
(the reference's feature_test main flow).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import sphere
from ..utils.config import PipelineConfig
from .frontend import FRONTENDS, FrontendResult


class EvalMetrics(NamedTuple):
    num_matches: torch.Tensor
    num_outliers: torch.Tensor
    outlier_pct: torch.Tensor
    trimmed_mean_err_rad: torch.Tensor
    total_keypoints: torch.Tensor


def evaluate_matches(fr: FrontendResult, R_gt, width: int, height: int,
                     cfg: PipelineConfig = PipelineConfig()) -> EvalMetrics:
    """Match count, outliers (count and %) at cfg.eval_inlier_thresh_rad,
    and the 10%-trimmed mean angular error (floor(0.1 n) dropped from each
    end of the n valid errors) of one pair's matches."""
    b_l = sphere.pixel_to_bearing(fr.left_xy, width, height)
    b_r = sphere.pixel_to_bearing(fr.right_xy, width, height)
    diff = sphere.angular_distance(b_l @ R_gt.T.to(b_l.dtype), b_r)  # (M,)

    valid = fr.match_valid
    n = torch.sum(valid.to(torch.int32))
    diff_m = torch.where(valid, diff, torch.inf)
    outliers = torch.sum((diff_m > cfg.eval_inlier_thresh_rad) & valid)
    pct = torch.where(n > 0, outliers.to(torch.float32) * 100.0 / n, 0.0)

    sorted_d = torch.sort(diff_m).values
    rank = torch.arange(diff.shape[0], device=diff.device)
    ten = torch.floor(0.1 * n.to(torch.float32)).to(torch.int64)
    keep = (rank >= ten) & (rank < n - ten)
    kept = torch.where(keep & torch.isfinite(sorted_d), sorted_d, 0.0)
    tmean = torch.sum(kept) / torch.clamp(torch.sum(keep), min=1).to(torch.float32)
    return EvalMetrics(n, outliers, pct, tmean, fr.total_keypoints)


def compare_frontends(im_left, im_right, R_gt, cfg: PipelineConfig = PipelineConfig()):
    """A/B/C comparison of the three front-ends on one ground-truth pair
    (H, W, 3): {name: EvalMetrics} in FRONTENDS order."""
    h, w = im_left.shape[0], im_left.shape[1]
    return {name: evaluate_matches(fn(im_left, im_right, cfg), R_gt, w, h, cfg)
            for name, fn in FRONTENDS.items()}
