"""Exact brute-force top-2 nearest descriptors (K3), with its plain
PyTorch version.

K3 `top2_distances` replaces the Pallas TPU kernel
spherical_bundle_adjuster_tpu/ops/pallas_match.top2_distances: for each
query, the two nearest valid train descriptors by
d2 = max(|q|^2 + |t|^2 - 2 q.t, 0), invalid train slots +inf, ties to the
lower index (lax.top_k's order); returns sqrt distances and int32
indices without storing the K1 x K2 matrix (csrc/match_top2.cu: one
launch of a register-tiled fp32 product; the blocks of one query tile
each take a span of the train bank, and the last of them to finish
merges their top-2). `top2_plan` chooses its tiling.

The banks may carry a leading pair axis, (P, K1, 64) against (P, K2, 64)
with a (P, K2) mask: P independent problems in one launch (a grid
dimension over pairs), each pair's output bit-identical to a launch of
that pair alone.

For CUDA tensors the wrapper launches the kernel or raises; for CPU
tensors it runs the plain version: query chunks against the whole bank,
then a first-minimum top-2 (argmin returns the first minimum, so ties go
to the lower index as in the kernel).

When a query has fewer than two valid train rows, its second distance is
inf and its second index is unspecified (0 here, from both versions; the
references give other values). match_descriptors rejects such a query.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import kernels

TOP2 = kernels.Kernel("sba_top2")
_CHUNK = 4096  # query rows per plain distance block
# The kernel's tiling (csrc/match_top2.cu kQTile and kSub; the kernel
# refuses a plan of other tiles).
Q_TILE = 128  # queries per block
SUB_ROWS = 128  # train rows per staged sub-tile, the unit of a block's span
MAX_SPLITS = 8  # blocks per query tile


class Top2Plan(NamedTuple):
    """K3's grid: `q_tiles` query tiles of Q_TILE rows, each taken by
    `splits` blocks; block r of a query tile takes the train rows
    [r * span, min((r + 1) * span, k2)) (none when r * span >= k2)."""

    q_tiles: int
    splits: int
    span: int


def top2_plan(k1: int, k2: int) -> Top2Plan:
    """The train bank is cut into SUB_ROWS units and spread over up to
    MAX_SPLITS blocks per query tile, each taking an equal whole number
    of units: at 2048 x 2048, 16 query tiles x 8 blocks of 256 rows (128
    blocks, one wave on 132 SMs at one block per SM); larger banks give
    each block more rows, not more blocks."""
    if k1 < 1 or k2 < 1:
        raise ValueError(f"top2_plan: empty bank ({k1} queries, {k2} train rows)")
    units = -(-k2 // SUB_ROWS)
    splits = min(MAX_SPLITS, units)
    return Top2Plan(q_tiles=-(-k1 // Q_TILE), splits=splits,
                    span=-(-units // splits) * SUB_ROWS)


# One arrival counter per (pair, query tile), for each (device, stream):
# zero before each launch, and the kernel leaves it zero (the last block of
# a tile resets it), so it is zeroed once, when it is allocated. Launches
# on one stream run in order, and launches on two streams that may overlap
# count on two buffers.
_COUNTERS: dict = {}


def _counters(dev, n):
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[key] = buf
    return buf


def top2_distances_plain(desc1, desc2, valid2):
    """(dist (K1, 2) f32, idx (K1, 2) int32) of each query's two nearest
    valid train rows; with a leading pair axis, each pair on its own."""
    if desc1.ndim == 3:
        outs = [top2_distances_plain(*bank) for bank in zip(desc1, desc2, valid2)]
        return tuple(torch.stack(x) for x in zip(*outs))
    d1 = desc1.to(torch.float32)
    d2 = desc2.to(torch.float32)
    tt = torch.sum(d2 * d2, dim=-1)
    dists, idxs = [], []
    for i in range(0, d1.shape[0], _CHUNK):
        q = d1[i : i + _CHUNK]
        qq = torch.sum(q * q, dim=-1, keepdim=True)
        dist2 = torch.clamp(qq + tt - 2.0 * (q @ d2.T), min=0.0)
        dist2 = torch.where(valid2[None, :], dist2, torch.inf)
        i1 = torch.argmin(dist2, dim=-1, keepdim=True)
        b1 = torch.gather(dist2, 1, i1)
        rest = dist2.scatter(1, i1, torch.inf)
        i2 = torch.argmin(rest, dim=-1, keepdim=True)
        b2 = torch.gather(rest, 1, i2)
        dists.append(torch.sqrt(torch.cat([b1, b2], dim=1)))
        idxs.append(torch.cat([i1, i2], dim=1).to(torch.int32))
    return torch.cat(dists), torch.cat(idxs)


def top2_distances_cuda(desc1, desc2, valid2):
    """K3 on the card: same contract as top2_distances_plain. Takes
    contiguous, 16-byte aligned f32 (K1, 64) and (K2, 64) banks and a
    bool (K2,) mask, or (P, K1, 64), (P, K2, 64) and (P, K2) for P pairs
    in one launch."""
    if desc1.ndim == 2:
        dist, idx = top2_distances_cuda(desc1[None], desc2[None], valid2[None])
        return dist[0], idx[0]
    dev = desc1.device
    p, k1, dim = desc1.shape
    k2 = desc2.shape[1]
    kernels.check(desc1, "desc1", torch.float32, dev)
    kernels.check(desc2, "desc2", torch.float32, dev, (p, k2, dim))
    kernels.check(valid2, "valid2", torch.bool, dev, (p, k2))
    if dim != 64:
        raise ValueError(f"top2_distances: descriptor width must be 64, got {dim}")
    if k1 < 1 or k2 < 1:
        raise ValueError(f"top2_distances: empty bank ({k1} queries, {k2} train rows)")
    if desc1.data_ptr() % 16 or desc2.data_ptr() % 16:
        raise ValueError("top2_distances: the banks must be 16-byte aligned")
    plan = top2_plan(k1, k2)
    dist = torch.empty((p, k1, 2), dtype=torch.float32, device=dev)
    idx = torch.empty((p, k1, 2), dtype=torch.int32, device=dev)
    part = torch.empty((p, plan.splits, k1, 4), dtype=torch.float32, device=dev)
    TOP2.launch(
        dev, kernels.ptr(desc1), kernels.ptr(desc2), kernels.ptr(valid2),
        kernels.ptr(dist), kernels.ptr(idx), kernels.ptr(part),
        kernels.ptr(_counters(dev, p * plan.q_tiles)), p, k1, k2, dim, Q_TILE,
        plan.q_tiles, plan.span, plan.splits,
    )
    return dist, idx


def top2_distances(desc1, desc2, valid2):
    """K3 for CUDA tensors, its plain version for CPU tensors; the banks
    may carry a leading pair axis."""
    if desc1.is_cuda:
        return top2_distances_cuda(desc1, desc2, valid2)
    if desc1.device.type == "cpu":
        return top2_distances_plain(desc1, desc2, valid2)
    raise ValueError(f"top2_distances: unsupported device {desc1.device}")
