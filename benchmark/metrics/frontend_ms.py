"""frontend_ms.<pair|batch>: wall ms of the front end the entry runs
(models.frontend.frontend_pairs, band: crops, K1, K2, SURF glue, K3, the
ratio test) on a call's pairs, between CUDA events with the card idle
before; the median of the probe's calls."""

import statistics


def read(ctx):
    t = ctx["spans"].get("frontend_ms")
    return statistics.median(t) if t else None
