"""Command-line interface, ported from the JAX package's cli.py — parity
with the reference's main.cpp (C14):

  python -m spherical_bundle_adjuster_tpu_torch.cli <left> <right> \
      <roll> <pitch> <yaw> <tx> <ty> <tz> <d> [--options]

The nine positional arguments mirror main/main.cpp:8-27 (expected pose in
degrees + expected depth used as the depth initialization). Every constant
the reference hard-codes is exposed as a flag (SURVEY.md §5), with the JAX
package's names and defaults. `--device` (default cuda) picks the device,
as JAX_PLATFORMS does for the JAX package; without a card the default
raises rather than falling back to the CPU.

Writes into --out-dir (default match_result): log.txt (the pose CSV row),
log_d.txt (per-match depths), metrics.jsonl, the match overlay
<solved rotation %g>,<matches>.png and d_found.png. torch's generator
does not reproduce jax.random's draws, so at one --seed the RANSAC
samples, and so the poses, differ from the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="sba-tpu-torch",
        description="Spherical bundle adjustment on an ERP image pair (PyTorch + CUDA)",
    )
    p.add_argument("left_image")
    p.add_argument("right_image")
    p.add_argument("roll", type=float, help="expected roll (deg)")
    p.add_argument("pitch", type=float, help="expected pitch (deg)")
    p.add_argument("yaw", type=float, help="expected yaw (deg)")
    p.add_argument("tx", type=float)
    p.add_argument("ty", type=float)
    p.add_argument("tz", type=float)
    p.add_argument("d", type=float, help="expected depth (initializes all d)")
    p.add_argument("--frontend", choices=["band", "erp", "cubemap"], default="band")
    p.add_argument("--max-keypoints", type=int, default=512)
    p.add_argument("--max-matches", type=int, default=512)
    p.add_argument("--ratio-thresh", type=float, default=0.3)
    p.add_argument("--hessian-threshold", type=float, default=100.0)
    p.add_argument("--ransac-trials", type=int, default=80)
    p.add_argument("--max-iterations", type=int, default=50)
    p.add_argument("--no-reference-compat", action="store_true",
                   help="use exact angle-axis init and per-match depths")
    p.add_argument("--joint-refine", action="store_true",
                   help="extra joint Schur-complement polish")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default="match_result")
    p.add_argument("--cube-size", type=int, default=600)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    return p


def build_config(args):
    """The PipelineConfig that the flags describe."""
    from .utils.config import (
        BaConfig,
        FrontendConfig,
        MatchConfig,
        PipelineConfig,
        RansacConfig,
        SurfConfig,
    )

    return PipelineConfig(
        surf=SurfConfig(
            hessian_threshold=args.hessian_threshold,
            max_keypoints=args.max_keypoints,
        ),
        match=MatchConfig(ratio_thresh=args.ratio_thresh, max_matches=args.max_matches),
        frontend=FrontendConfig(cube_size=args.cube_size),
        ransac=RansacConfig(num_trials=args.ransac_trials, seed=args.seed),
        ba=BaConfig(
            max_iterations=args.max_iterations,
            init_depth=args.d,
            reference_compat=not args.no_reference_compat,
            joint_refine=args.joint_refine,
        ),
    )


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from .models import twoview
    from .utils import io, viz
    from .utils.logging import RunLogger, logger, timed
    from .utils.tree import to_host

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here (pass --device cpu "
                           "to run on the CPU)")
    cfg = build_config(args)

    logger.info("Do feature finding and matching")
    left = io.load_image(args.left_image)
    right = io.load_image(args.right_image)
    im_left = torch.tensor(left, device=dev)
    im_right = torch.tensor(right, device=dev)

    with timed("bundle_adjustment"):
        out = twoview.run_two_view(
            im_left, im_right, torch.Generator(dev).manual_seed(args.seed), cfg, args.frontend
        )
        out = to_host(out)  # one copy off the card, which waits for its work

    # Per-stage solver telemetry, the Ceres BriefReport parity prints
    # (spherical_bundle_adjuster.cpp:198-211): one line per BCD stage per
    # round with iterations and initial -> final cost.
    tel = out.telemetry
    stage_rows = []
    for name, rep in (("d", tel.depth), ("rot", tel.rot), ("tran", tel.tran)):
        for rnd in range(len(np.atleast_1d(rep.iterations))):
            row = {
                "stage": name,
                "round": rnd,
                "iterations": int(np.atleast_1d(rep.iterations)[rnd]),
                "initial_cost": float(np.atleast_1d(rep.initial_cost)[rnd]),
                "final_cost": float(np.atleast_1d(rep.final_cost)[rnd]),
            }
            stage_rows.append(row)
            print(
                f"stage {name} (round {rnd}): iterations {row['iterations']},"
                f" initial cost {row['initial_cost']:.6e},"
                f" final cost {row['final_cost']:.6e}"
            )

    # Pose report, reference print convention
    # (spherical_bundle_adjuster.cpp:214-216)
    print("expected rotation vector", args.roll, args.pitch, args.yaw)
    print("rotation vector in degree", *out.rotation_deg.tolist())
    print("translation vector", *out.translation.tolist())
    print("matches:", int(out.num_matches), "total keypoints:", int(out.total_keypoints))

    rl = RunLogger(args.out_dir)
    rl.pose_csv(
        (args.roll, args.pitch, args.yaw),
        out.rotation_deg,
        out.translation,
        int(out.num_matches),
    )
    rl.depth_csv(out.depths, out.match_valid)
    rl.metric(
        event="two_view_ba",
        frontend=args.frontend,
        matches=int(out.num_matches),
        rotation_deg=out.rotation_deg.tolist(),
        translation=out.translation.tolist(),
        solver_stages=stage_rows,
    )
    overlay = viz.draw_match(left, right, out.left_xy, out.right_xy, out.match_valid)
    # Filename parity (spherical_bundle_adjuster.cpp:824-830): the overlay
    # is saved as <solved rotation in degrees>,<match count>.png, with C++
    # default ostream float formatting (%g, 6 significant digits).
    rdeg = out.rotation_deg.tolist()
    euler_name = ",".join(f"{v:g}" for v in rdeg)
    viz.save_image(overlay, f"{args.out_dir}/{euler_name},{int(out.num_matches)}.png")
    circles = viz.draw_depth_circles(left, out.depths, out.left_xy, out.match_valid)
    # write_d_circle is called with name="d_found" (:356) -> match_result/d_found.png
    viz.save_image(circles, f"{args.out_dir}/d_found.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
