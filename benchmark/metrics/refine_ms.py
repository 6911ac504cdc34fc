"""refine_ms.<pair|batch>: wall ms of the refinement the entry runs on
the front end's matches (models.twoview.lift_matches and
adjust_from_matches: solver.epipolar's consensus, solver.lm's BCD and,
in corrected mode, the gates, joint Schur and the starts), between CUDA
events with the card idle before; the median of the probe's calls."""

import statistics


def read(ctx):
    t = ctx["spans"].get("refine_ms")
    return statistics.median(t) if t else None
