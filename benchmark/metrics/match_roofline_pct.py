"""match_roofline_pct.<pair|batch>: K3 (ops.cuda_match top-2 descriptor
distances), the least time its work needs on the card over its device
time in the traced window, in %.

The work: for each pair, every left-image descriptor (the ladder's bands
x max_keypoints) against every right-image one, 2·Q·T·D fp32 operations
(a multiply and an add per element of each distance), the two banks and
the train mask read once, the (Q, 2) distances and indices written once.
The bound is the larger of bytes over the peak bandwidth and operations
over the fp32 peak (benchmark/peaks.py).
"""

from benchmark import peaks
from benchmark.trace import kernel_us


KERNELS = ("top2_kernel",)


def k3_counts(q, t, d):
    """(bytes, fp32 operations) of K3 on one pair's banks, Q x D against T x D."""
    return 4 * (q + t) * d + t + q * 2 * (4 + 4), 2 * q * t * d


def bound_s(pipeline, pairs):
    fe = pipeline["frontend"]
    if fe["band_ladder"] != "parity":
        return None
    k = len(fe["band_pitches_deg"]) * pipeline["surf"]["max_keypoints"]
    n_bytes, n_ops = k3_counts(k, k, pipeline["surf"]["descriptor_dim"])
    return pairs * peaks.bound_s(n_bytes, n_ops)


def read(ctx):
    t_us = kernel_us(ctx["trace"], KERNELS)
    bound = bound_s(ctx["pipeline"], ctx["traced_pairs"])
    if not t_us or bound is None:
        return None
    return 100.0 * bound / (t_us * 1e-6)
