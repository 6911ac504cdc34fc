"""SURF's dense maps in plain PyTorch: the det-of-Hessian pyramid (what
the program's K1 computes) and the Haar / trace-sign maps (K2), as
shifted-slice box sums of an edge-padded integral image. Box geometry is
computed on the host with Python's round(). A frozen copy of the plain
versions in spherical_bundle_adjuster_tpu_torch/ops/cuda_surf.py.
"""

from __future__ import annotations

import torch

from . import integral
from .config import SurfConfig

# Base (size-9) box patterns, (y0, x0, y1, x1, weight), relative to the
# filter's top-left corner (OpenCV's geometry).
_DXX9 = [(2, 0, 7, 3, 1.0), (2, 3, 7, 6, -2.0), (2, 6, 7, 9, 1.0)]
_DYY9 = [(0, 2, 3, 7, 1.0), (3, 2, 6, 7, -2.0), (6, 2, 9, 7, 1.0)]
_DXY9 = [(1, 1, 4, 4, 1.0), (1, 5, 4, 8, -1.0), (5, 1, 8, 4, -1.0), (5, 5, 8, 8, 1.0)]


def _scaled_pattern(base, size: int):
    """Scale a size-9 base pattern to `size`, area-normalizing weights
    (Python's round: half to even, as the reference)."""
    ratio = size / 9.0
    out = []
    for (y0, x0, y1, x1, w) in base:
        sy0, sx0 = round(ratio * y0), round(ratio * x0)
        sy1, sx1 = round(ratio * y1), round(ratio * x1)
        area = max((sy1 - sy0) * (sx1 - sx0), 1)
        out.append((sy0, sx0, sy1, sx1, w / area))
    return out


def filter_size(octave: int, layer: int) -> int:
    return (9 + 6 * layer) << octave


def mid_layer_sizes(cfg: SurfConfig):
    """Filter sizes of the NMS-eligible middle layers, all octaves."""
    return [
        filter_size(o, l)
        for o in range(cfg.n_octaves)
        for l in range(1, cfg.n_octave_layers + 1)
    ]


def det_layer_boxes(octave: int, layer: int):
    """(size, half, [dxx, dyy, dxy] box lists relative to the sample)."""
    size = filter_size(octave, layer)
    half = size // 2
    groups = [
        [(y0 - half, x0 - half, y1 - half, x1 - half, w)
         for (y0, x0, y1, x1, w) in _scaled_pattern(base, size)]
        for base in (_DXX9, _DYY9, _DXY9)
    ]
    return size, half, groups


def haar_radius(size: int) -> int:
    return max(int(round(2 * 1.2 * size / 9.0)), 1)


def trace_boxes(size: int):
    """Thirds-geometry trace boxes relative to the sample: Dyy's three row
    bands, then Dxx's three column bands, weights (1, -2, 1)."""
    half = size // 2
    t = int(size / 3.0)
    b = int(2.0 * size / 9.0)
    base = -half
    return [
        (base + i * t, base + b, base + (i + 1) * t, base + size - b, wt)
        for i, wt in ((0, 1.0), (1, -2.0), (2, 1.0))
    ] + [
        (base + b, base + i * t, base + size - b, base + (i + 1) * t, wt)
        for i, wt in ((0, 1.0), (1, -2.0), (2, 1.0))
    ]


def _octave_shape(h, w, octave):
    step = 1 << octave
    return step, (h + step - 1) // step, (w + step - 1) // step


def _inside_mask(h, w, step, oh, ow, size, half, device):
    ys = torch.arange(oh, device=device)[:, None] * step
    xs = torch.arange(ow, device=device)[None, :] * step
    return (
        (ys >= half) & (ys <= h - (size - half))
        & (xs >= half) & (xs <= w - (size - half))
    )



def det_octave_plain(ii, octave: int, cfg: SurfConfig):
    """Plain version of K1: (B, n_layers, oh, ow) f32, -inf outside the
    octave's valid border. ii: (B, h+1, w+1)."""
    h, w = ii.shape[-2] - 1, ii.shape[-1] - 1
    n_l = cfg.n_octave_layers + 2
    step, oh, ow = _octave_shape(h, w, octave)
    pad = filter_size(octave, n_l - 1)
    ii_pad = integral.edge_pad(ii, pad)
    layers = []
    for l in range(n_l):
        size, half, groups = det_layer_boxes(octave, l)
        dxx, dyy, dxy = (
            integral.shifted_box_sums(
                ii_pad,
                [(y0 + pad, x0 + pad, y1 + pad, x1 + pad, wt)
                 for (y0, x0, y1, x1, wt) in g],
                oh, ow, step,
            )
            for g in groups
        )
        det = dxx * dyy - 0.81 * dxy * dxy
        inside = _inside_mask(h, w, step, oh, ow, size, half, ii.device)
        layers.append(torch.where(inside, det, -torch.inf))
    return torch.stack(layers, dim=1)


def det_pyramid_plain(ii, cfg: SurfConfig):
    """Plain version of K1: det_octave_plain for every octave."""
    return [det_octave_plain(ii, o, cfg) for o in range(cfg.n_octaves)]


def haar_trace_maps_plain(ii, cfg: SurfConfig):
    """Plain version of K2: (hx, hy) bf16 (B, Q, h, w) and trace sign
    int8 (B, Q, h, w). ii: (B, h+1, w+1)."""
    h, w = ii.shape[-2] - 1, ii.shape[-1] - 1
    sizes = mid_layer_sizes(cfg)
    pad = max(max(haar_radius(s) for s in sizes) + 1, max(sizes) // 2 + 2)
    ii_pad = integral.edge_pad(ii, pad)

    def sums(boxes):
        return integral.shifted_box_sums(
            ii_pad,
            [(y0 + pad, x0 + pad, y1 + pad, x1 + pad, wt)
             for (y0, x0, y1, x1, wt) in boxes],
            h, w,
        )

    hx, hy, tr = [], [], []
    for size in sizes:
        r = haar_radius(size)
        hx.append(sums([(-r, 0, r, r, 1.0), (-r, -r, r, 0, -1.0)]))
        hy.append(sums([(0, -r, r, r, 1.0), (-r, -r, 0, r, -1.0)]))
        tr.append(torch.sign(sums(trace_boxes(size))))
    return (
        torch.stack(hx, dim=1).to(torch.bfloat16),
        torch.stack(hy, dim=1).to(torch.bfloat16),
        torch.stack(tr, dim=1).to(torch.int8),
    )
