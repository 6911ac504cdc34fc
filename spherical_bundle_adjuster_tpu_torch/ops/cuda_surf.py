"""SURF dense-map kernels: the det-of-Hessian pyramid (K1) and the Haar /
trace-sign maps (K2), each with its plain PyTorch version.

K1 `det_pyramid` replaces the Pallas TPU kernel
spherical_bundle_adjuster_tpu/ops/pallas_surf.det_octave_dense, plus the
`[::step]` subsample and the -inf border mask that
ops/surf._det_maps_per_octave applied after it: one launch evaluates
every octave's strided grid for every band at once.

K2 `haar_trace_maps` replaces pallas_surf.haar_trace_maps: Haar x / y
responses at each middle-layer scale, rounded to bf16 (two planes instead
of the TPU's packed u32), and the int8 sign of the thirds-geometry trace.

For CUDA tensors each wrapper launches its kernel (csrc/surf_maps.cu) or
raises; for CPU tensors it runs the plain version, the shifted-slice
box sums of the JAX reference's XLA path on an edge-padded integral
image. Box geometry is computed on the host with Python's round(), as
the reference does, and shared by both versions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.config import SurfConfig
from . import integral, kernels

# Base (size-9) box patterns, (y0, x0, y1, x1, weight), relative to the
# filter's top-left corner (OpenCV's geometry).
_DXX9 = [(2, 0, 7, 3, 1.0), (2, 3, 7, 6, -2.0), (2, 6, 7, 9, 1.0)]
_DYY9 = [(0, 2, 3, 7, 1.0), (3, 2, 6, 7, -2.0), (6, 2, 9, 7, 1.0)]
_DXY9 = [(1, 1, 4, 4, 1.0), (1, 5, 4, 8, -1.0), (5, 1, 8, 4, -1.0), (5, 5, 8, 8, 1.0)]

DET_PYRAMID = kernels.Kernel("sba_det_pyramid")
HAAR_TRACE = kernels.Kernel("sba_haar_trace")


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


# ---------------------------------------------------------------------------
# Shared-memory staging plan shared by both kernels
#
# Every corner a K1 layer or K2 scale reads lies on a lattice: image row
# y * step + off[k] and column x * step + off[k'] for output (y, x), with
# the same few offsets off[] for rows and columns. A block stages, for a
# tile of ty x tx outputs, exactly the lattice rows and columns the tile
# touches, then computes every output of the tile from shared memory.
#
# Along one axis, the tile's outputs y0 .. y0 + t - 1 touch positions
# y * step + o for each offset o. Offsets of one residue mod step whose
# gaps are at most step * t touch one contiguous progression of stride
# step: a run. A run starting at offset o0 with extent e = (o_last - o0)
# / step holds t + e slots; offset o of the run sits at slot
# first + (o - o0) / step for the tile's output 0, and output y at that
# plus y. Rows and columns are staged this way independently, so a
# staged row holds the column slots of every column run, `pitch` floats.
# At step 1 a column run is copied in 16-byte chunks, so it starts at an
# offset and a slot that are multiples of 4 floats; the integral image's
# rows are padded to match (integral.integral_image).

# Bytes a block may stage: at 112 KB two blocks share an H100 SM's 228 KB.
# The fastest of the budgets timed at the 2K shapes (kernel_times.py
# --stage-bytes; PERF.md section 6).
STAGE_BYTES = 112 * 1024
_STAGE_TY = (1, 2, 4, 8, 16, 32, 64, 128)  # output rows per tile
_STAGE_TX = (32, 64, 128, 256, 512, 1024, 2048)  # output columns per tile
_MIN_TILE = 1024  # outputs per tile: 2 per thread of a 512-thread block
_WANT_TILES = 4 * 132  # tiles per launch to keep every H100 SM's blocks busy
MAX_OFFS = 10  # lattice offsets per part: K1 10, K2 9
MAX_PARTS = 32  # layers or scales one launch takes (csrc: kMaxParts)
_COPY_FLOATS = integral.ROW_ALIGN  # floats per copy at step 1 (16 bytes)
PART_INTS = 13 + 8 * MAX_OFFS + 2 + 10  # one row of the part table (csrc: struct Part)


class Runs(NamedTuple):
    """One axis of a tile's lattice: runs (first slot, first offset,
    extent), the slot of each offset for the tile's output 0, and the
    slots in all."""

    runs: tuple
    base: tuple
    slots: int


def lattice_runs(offs, step: int, t: int, align: int = 1) -> Runs:
    """Group `offs` into runs for a tile of t outputs at stride `step`.
    With align > 1 (step 1 only), each run starts at an offset and a slot
    that are multiples of `align`, and holds a multiple of `align` slots,
    so that it can be staged in aligned chunks of `align` floats."""
    runs, base, slot = [], {}, 0
    for rho in sorted({o % step for o in offs}):
        cls = sorted({o for o in offs if o % step == rho})
        group = [cls[0]]
        for o in cls[1:] + [None]:
            if o is not None and o - group[-1] <= step * t:
                group.append(o)
                continue
            first = group[0] - group[0] % align
            ext = (group[-1] - first) // step
            for g in group:
                base[g] = slot + (g - first) // step
            runs.append((slot, first, ext))
            slot += -(-(t + ext) // align) * align
            if o is not None:
                group = [o]
    return Runs(tuple(runs), tuple(base[o] for o in offs), slot)


class StageTile(NamedTuple):
    """How the blocks of one K1 layer or K2 scale tile its output grid
    (ty x tx outputs a tile, nty x ntx tiles a band) and stage a tile's
    lattice: `rows` and `cols` are its runs; a staged row is `cols.slots`
    floats."""

    ty: int
    tx: int
    nty: int
    ntx: int
    rows: Runs
    cols: Runs

    @property
    def smem(self) -> int:
        return 4 * self.rows.slots * self.cols.slots


def stage_tile(offs, step: int, oh: int, ow: int, max_outputs: int) -> StageTile:
    """The tiling that stages the fewest floats per band within
    STAGE_BYTES, among tiles of at most max_outputs outputs (ties: the
    larger tile)."""
    best, best_cost = None, None
    for ty in sorted({min(t, oh) for t in _STAGE_TY}):
        rows = lattice_runs(offs, step, ty)
        for tx in sorted({min(t, ow) for t in _STAGE_TX}):
            if ty * tx > max_outputs:
                continue
            cols = lattice_runs(offs, step, tx, _COPY_FLOATS if step == 1 else 1)
            if 4 * rows.slots * cols.slots > STAGE_BYTES:
                continue
            nty, ntx = -(-oh // ty), -(-ow // tx)
            cost = (nty * ntx * rows.slots * cols.slots, -ty * tx)
            if best is None or cost < best_cost:
                best, best_cost = StageTile(ty, tx, nty, ntx, rows, cols), cost
    if best is None:
        raise ValueError(f"offsets {list(offs)} at step {step} do not fit "
                         f"{STAGE_BYTES} bytes of shared memory")
    return best


def _part_row(first: int, t: StageTile, shift: int, oh: int, ow: int, out_off: int,
              band_stride: int, size=0, half=0, weights=()):
    """One row of the part table, in csrc/surf_maps.cu's struct Part order:
    the part's tiling, output grid (oh x ow at stride 1 << shift), where
    its (band 0) output plane starts in the launch's output and how far
    apart its bands' planes are, its lattice runs and, for K1, the
    filter's size, half and box weights."""
    def pad(v):
        return list(v) + [0] * (MAX_OFFS - len(v))

    rr, cr = t.rows.runs, t.cols.runs
    ints = [first, t.ty, t.tx, t.nty, t.ntx, t.cols.slots, len(rr), len(cr),
            shift, oh, ow, out_off, band_stride]
    for runs in (rr, cr):
        for i in range(3):
            ints += pad([r[i] for r in runs])
    ints += pad(t.rows.base) + pad(t.cols.base) + [size, half]
    wt = np.zeros(10, np.float32)
    wt[: len(weights)] = weights
    return np.concatenate([np.asarray(ints, np.int32), wt.view(np.int32)])


def _max_outputs(total: int) -> int:
    return max(_MIN_TILE, total // _WANT_TILES)


def _check_ii(ii):
    """Raise unless ii is what the kernels take: (B, h+1, w+1) float32 on
    the card in integral_image's row-aligned layout."""
    if ii.device.type != "cuda":
        raise ValueError(f"ii: expected a CUDA tensor, got {ii.device}")
    if ii.dtype != torch.float32 or ii.ndim != 3:
        raise ValueError(f"ii: expected (B, h+1, w+1) float32, got {ii.dtype} {tuple(ii.shape)}")
    if not integral.is_row_aligned(ii):
        raise ValueError("ii: expected integral_image's layout (rows 16-byte aligned, "
                         f"row stride a multiple of {integral.ROW_ALIGN}), got strides {ii.stride()}")


# ---------------------------------------------------------------------------
# K1: det-of-Hessian, all octaves, all bands


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


def _det_offsets(size: int):
    """The 10 offsets round(size/9 * k) - half, k = 0..9, on which every
    corner of a layer's boxes lies (rows and columns alike)."""
    half = size // 2
    return [round(size / 9.0 * k) - half for k in range(10)]


# Each det box of _DXX9 + _DYY9 + _DXY9 as indices k of (y0, x0, y1, x1)
# into _det_offsets: the fixed corner lattice K1 reads.
_DET_BOX_K = [(y0, x0, y1, x1) for (y0, x0, y1, x1, _) in _DXX9 + _DYY9 + _DXY9]


@functools.lru_cache(maxsize=64)
def _det_plan(n_octaves: int, n_l: int, b: int, h: int, w: int):
    """K1's launch plan for b bands of h x w: the (n_octaves * n_l,
    PART_INTS) int32 part table (one row per octave and layer, the highest
    octave first: its few, costly tiles start early and octave 0's many
    small ones fill the end), the octaves' output shapes (one flat buffer,
    octave after octave), the number of tiles and the bytes of shared
    memory a block needs (its staging buffer)."""
    shapes, out_off = [], []
    for o in range(n_octaves):
        step, oh, ow = _octave_shape(h, w, o)
        shapes.append((b, n_l, oh, ow))
        out_off.append(sum(int(np.prod(s)) for s in shapes[:-1]))
    if sum(int(np.prod(s)) for s in shapes) >= 2**31:
        raise ValueError("det_pyramid: the pyramid is too large for 32-bit offsets")
    total = sum(int(np.prod(s)) for s in shapes)
    rows, first, smem = [], 0, 0
    for o in reversed(range(n_octaves)):
        step, oh, ow = _octave_shape(h, w, o)
        for l in range(n_l):
            size, half, groups = det_layer_boxes(o, l)
            boxes = [bx for g in groups for bx in g]
            off = _det_offsets(size)
            if [bx[:4] for bx in boxes] != [tuple(off[k] for k in bk) for bk in _DET_BOX_K]:
                raise AssertionError(f"det boxes of size {size} leave the offset lattice")
            t = stage_tile(off, step, oh, ow, _max_outputs(total))
            rows.append(_part_row(first, t, o, oh, ow, out_off[o] + l * oh * ow, n_l * oh * ow,
                                  size, half, [bx[4] for bx in boxes]))
            first += b * t.nty * t.ntx
            smem = max(smem, t.smem)
    table = np.stack(rows)
    table.setflags(write=False)
    return table, tuple(shapes), first, smem


def det_pyramid_plain(ii, cfg: SurfConfig):
    """Plain version of K1: det_octave_plain for every octave."""
    return [det_octave_plain(ii, o, cfg) for o in range(cfg.n_octaves)]


def det_pyramid_cuda(ii, cfg: SurfConfig):
    """K1 on the card, one launch for every octave: same contract as
    det_pyramid_plain (each octave's maps a view into one buffer)."""
    _check_ii(ii)
    b, h, w = ii.shape[0], ii.shape[1] - 1, ii.shape[2] - 1
    n_l = cfg.n_octave_layers + 2
    if cfg.n_octaves * n_l > MAX_PARTS:
        raise ValueError(f"det_pyramid: at most {MAX_PARTS} octave layers in all")
    table, shapes, n_tiles, smem = _det_plan(cfg.n_octaves, n_l, b, h, w)
    flat = torch.empty(sum(int(np.prod(s)) for s in shapes), dtype=torch.float32,
                       device=ii.device)
    DET_PYRAMID.launch(
        ii.device, kernels.ptr(ii), kernels.ptr(flat), kernels.host_ptr(table),
        len(table), n_tiles, h, w, ii.stride(1), smem,
    )
    sizes = [int(np.prod(s)) for s in shapes]
    return [v.view(s) for v, s in zip(torch.split(flat, sizes), shapes)]


def det_pyramid(ii, cfg: SurfConfig):
    """K1 for CUDA tensors, its plain version for CPU tensors: the det
    maps of every octave, (B, n_layers, oh, ow) each."""
    if ii.is_cuda:
        return det_pyramid_cuda(ii, cfg)
    if ii.device.type == "cpu":
        return det_pyramid_plain(ii, cfg)
    raise ValueError(f"det_pyramid: unsupported device {ii.device}")


# ---------------------------------------------------------------------------
# K2: Haar (bf16) + trace-sign maps, all middle-layer scales, all bands


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


def _haar_offsets(size: int):
    """K2's 9 offsets [-r, 0, r, T0, T1, T2, T3, B+b, B+size-b]: the Haar
    radius and the thirds-geometry trace's band edges (B = -half), on which
    every corner of the scale's boxes lies (rows and columns alike)."""
    r = haar_radius(size)
    tb = trace_boxes(size)
    off = [-r, 0, r] + [tb[i][0] for i in range(3)] + [tb[2][2], tb[0][1], tb[0][3]]
    t0, t1, t2, t3, lo, hi = off[3:]
    want = ([(a, lo, c, hi) for a, c in ((t0, t1), (t1, t2), (t2, t3))]
            + [(lo, a, hi, c) for a, c in ((t0, t1), (t1, t2), (t2, t3))])
    if [b[:4] for b in tb] != want:
        raise AssertionError(f"trace boxes of size {size} leave the offset lattice")
    return off


@functools.lru_cache(maxsize=64)
def _haar_plan(n_octaves: int, n_octave_layers: int, b: int, h: int, w: int):
    """K2's launch plan for b bands of h x w: the (Q, PART_INTS) int32 part
    table (one row per middle-layer scale: its tiling and lattice runs,
    offsets in _haar_offsets order), the number of tiles and the bytes of
    shared memory a block needs (its staging buffer)."""
    cfg = SurfConfig(n_octaves=n_octaves, n_octave_layers=n_octave_layers)
    sizes = mid_layer_sizes(cfg)
    table = np.zeros((len(sizes), PART_INTS), np.int32)
    first = smem = 0
    for i, size in enumerate(sizes):
        t = stage_tile(_haar_offsets(size), 1, h, w, _max_outputs(b * len(sizes) * h * w))
        table[i] = _part_row(first, t, 0, h, w, i * h * w, len(sizes) * h * w)
        first += b * t.nty * t.ntx
        smem = max(smem, t.smem)
    table.setflags(write=False)
    return table, first, smem


def haar_trace_maps_cuda(ii, cfg: SurfConfig):
    """K2 on the card: same contract as haar_trace_maps_plain."""
    _check_ii(ii)
    b, h, w = ii.shape[0], ii.shape[1] - 1, ii.shape[2] - 1
    q = cfg.n_octaves * cfg.n_octave_layers
    if q > MAX_PARTS:
        raise ValueError(f"haar_trace_maps: at most {MAX_PARTS} middle-layer scales, got {q}")
    table, n_tiles, smem = _haar_plan(cfg.n_octaves, cfg.n_octave_layers, b, h, w)
    hx = torch.empty((b, q, h, w), dtype=torch.bfloat16, device=ii.device)
    hy = torch.empty_like(hx)
    tr = torch.empty((b, q, h, w), dtype=torch.int8, device=ii.device)
    HAAR_TRACE.launch(
        ii.device, kernels.ptr(ii), kernels.ptr(hx), kernels.ptr(hy),
        kernels.ptr(tr), kernels.host_ptr(table), q, n_tiles, h, w, ii.stride(1), smem,
    )
    return hx, hy, tr


def haar_trace_maps(ii, cfg: SurfConfig):
    """K2 for CUDA tensors, its plain version for CPU tensors."""
    if ii.is_cuda:
        return haar_trace_maps_cuda(ii, cfg)
    if ii.device.type == "cpu":
        return haar_trace_maps_plain(ii, cfg)
    raise ValueError(f"haar_trace_maps: unsupported device {ii.device}")
