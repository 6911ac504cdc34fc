"""The pipeline's configuration dataclasses (the port's
utils/config.py, frozen with the reference): SURF, matching, the band
front end, the consensus and the solver."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SurfConfig:
    """SURF detector/descriptor (OpenCV's defaults)."""

    hessian_threshold: float = 100.0
    n_octaves: int = 4
    n_octave_layers: int = 3
    max_keypoints: int = 512      # static per-image keypoint capacity
    upright: bool = False         # True skips orientation assignment (U-SURF)
    descriptor_dim: int = 64
    subpixel_refine: bool = True
    descriptor_interp: str = "nearest"  # "nearest" (OpenCV-style) | "bilinear"
    # "dense": per-layer dense trace-sign maps, one gather per keypoint;
    # "gather": corner reads per keypoint at the refined size.
    laplacian_mode: str = "dense"


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Descriptor matching: exact top-2 + Lowe ratio."""

    ratio_thresh: float = 0.3
    max_matches: int = 512        # static match capacity
    mutual_check: bool = False    # the reference tool matches one way only


# The 22.5-deg band ladder, which keeps every latitude within 11.25 deg of
# a band center (no intermediate-pitch match cliff); 2x front-end cost.
DENSE_BAND_PITCHES: Tuple[float, ...] = (
    67.5, 45.0, 22.5, 0.0, -22.5, -45.0, -67.5, -90.0
)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Band-rotation front-end."""

    band_pitches_deg: Tuple[float, ...] = (45.0, 0.0, -45.0, -90.0)
    # Band rows [3H/8, 5H/8) of the pitch-rotated sphere, as fractions of H.
    band_row_start_frac: float = 3.0 / 8.0
    band_height_frac: float = 1.0 / 4.0
    cube_size: int = 600          # cubemap front-end
    resample_mode: str = "floor"  # reference parity; "bilinear" for quality
    # "parity" (band_pitches_deg), "dense" (DENSE_BAND_PITCHES) or "auto"
    # (parity, then dense when it finds fewer than auto_min_matches).
    band_ladder: str = "auto"
    auto_min_matches: int = 16


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Consensus initial guess."""

    num_trials: int = 80
    sample_fraction: float = 0.25
    max_euler_valid: float = 1.57  # validity bound, rad
    trim_lo: float = 0.2           # trimmed-mean consensus window
    trim_hi: float = 0.8
    seed: int = 0
    scoring: str = "trimmed_mode"  # | "inlier_count"
    inlier_thresh_deg: float = 1.5
    cheirality: bool = True        # resolve t's sign by a positive-depth vote
    rotation_hypothesis: bool = True  # multi-start only: a Procrustes start


@dataclasses.dataclass(frozen=True)
class BaConfig:
    """Bundle adjustment solver."""

    max_iterations: int = 50      # per BCD stage
    function_tolerance: float = 1e-6
    huber_delta: float = 1.0
    barrier_lambda: float = 1.0   # d-stage depth barrier lambda*exp(-c*d)
    barrier_c: float = 1.0
    d_lower_bound: float = 0.0
    init_depth: float = 1.0
    lm_lambda_init: float = 1e-4
    lm_lambda_up: float = 4.0
    lm_lambda_down: float = 2.0
    reference_compat: bool = True  # the reference tool's quirks, for pose parity
    bcd_rounds: int = 1
    joint_refine: bool = False
    outlier_reject: bool = False
    outlier_thresh_deg: float = 1.5
    outlier_min_keep: int = 9
    outlier_rounds: int = 2
    multi_start: int = 0
    rot_dominant_select_deg: float = 0.75


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    surf: SurfConfig = SurfConfig()
    match: MatchConfig = MatchConfig()
    frontend: FrontendConfig = FrontendConfig()
    ransac: RansacConfig = RansacConfig()
    ba: BaConfig = BaConfig()
    # Evaluation: inlier threshold 2 deg and 10% trim for the mean error.
    eval_inlier_thresh_rad: float = 2.0 / 180.0 * math.pi
    eval_trim_frac: float = 0.1
    dtype: str = "float32"

    def quality(self) -> "PipelineConfig":
        """Quality preset: the dense band ladder and inlier-count RANSAC
        scoring, for scenes whose relative pitch is unconstrained."""
        return dataclasses.replace(
            self,
            frontend=dataclasses.replace(self.frontend, band_ladder="dense"),
            ransac=dataclasses.replace(self.ransac, scoring="inlier_count"),
        )

    def parity(self) -> "PipelineConfig":
        """Reference-parity preset: the reference's 4-pitch ladder with no
        dense fallback."""
        return dataclasses.replace(
            self,
            frontend=dataclasses.replace(self.frontend, band_ladder="parity"),
        )
