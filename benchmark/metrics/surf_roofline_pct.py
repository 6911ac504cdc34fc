"""surf_roofline_pct.<pair|batch>: K1 (det-of-Hessian pyramid) and K2
(Haar / trace-sign maps) of ops.cuda_surf, the least time their work
needs on the card over their device time in the traced window, in %.

The work is what the algorithm needs at the cell's shapes: for every
band image (2 images x the ladder's bands a pair, H/4 x W each), the
integral image read once by each kernel ((H/4 + 1) x (W + 1) float32),
each output written once (K1: every octave's 5 layers, float32; K2: hx
and hy bf16 and the trace sign int8 at each of the n_octaves x 3 middle
scales), and 51 fp32 operations per K1 value inside its octave's border
and per K2 value (10 boxes x 3 + 10 weights + 7 sums + 4 for the det; 14
boxes x 3 + 2 + 2 weights + 5 sums). Each kernel's bound is the larger
of its bytes over the peak bandwidth and its operations over the fp32
peak (benchmark/peaks.py); the two bounds are added.
"""

from benchmark import peaks
from benchmark.trace import kernel_us

KERNELS = {"K1": "DetOp", "K2": "HaarOp"}  # tile_kernel<DetOp>, tile_kernel<HaarOp>
K1_OPS_PER_VALID = 51
K2_OPS_PER_VALUE = 51
K1_LAYERS_EXTRA = 2  # a K1 octave holds n_octave_layers + 2 layers


def ladder_bands(pipeline):
    """Bands per image, or None where the ladder depends on the data."""
    fe = pipeline["frontend"]
    if fe["band_ladder"] == "parity":
        return len(fe["band_pitches_deg"])
    if fe["band_ladder"] == "dense":
        return 8
    return None


def _filter_size(octave, layer):
    return (9 + 6 * layer) << octave


def _inside(n, step, size, extent):
    """Samples y * step, 0 <= y < n, with half <= y * step <= extent - (size - half)."""
    half = size // 2
    lo, hi = half, extent - (size - half)
    return sum(1 for y in range(n) if lo <= y * step <= hi)


def k1_counts(b, h, w, n_octaves, n_octave_layers):
    """(bytes, fp32 operations) of K1 on b bands of h x w."""
    n_in = b * (h + 1) * (w + 1)
    n_out = n_valid = 0
    for o in range(n_octaves):
        step = 1 << o
        oh, ow = -(-h // step), -(-w // step)
        for l in range(n_octave_layers + K1_LAYERS_EXTRA):
            size = _filter_size(o, l)
            n_out += b * oh * ow
            n_valid += b * _inside(oh, step, size, h) * _inside(ow, step, size, w)
    return 4 * (n_in + n_out), K1_OPS_PER_VALID * n_valid


def k2_counts(b, h, w, n_octaves, n_octave_layers):
    """(bytes, fp32 operations) of K2 on b bands of h x w."""
    n_in = b * (h + 1) * (w + 1)
    n_val = b * n_octaves * n_octave_layers * h * w
    return 4 * n_in + (2 + 2 + 1) * n_val, K2_OPS_PER_VALUE * n_val


def bound_s(pipeline, height, width, pairs):
    """The least time (s) for K1 and K2 on `pairs` pairs, or None."""
    n = ladder_bands(pipeline)
    if n is None:
        return None
    s = pipeline["surf"]
    b, h, w = pairs * 2 * n, height // 4, width
    return sum(peaks.bound_s(*f(b, h, w, s["n_octaves"], s["n_octave_layers"]))
               for f in (k1_counts, k2_counts))


def read(ctx):
    t_us = kernel_us(ctx["trace"], KERNELS.values())
    bound = bound_s(ctx["pipeline"], ctx["height"], ctx["width"], ctx["traced_pairs"])
    if not t_us or bound is None:
        return None
    return 100.0 * bound / (t_us * 1e-6)
