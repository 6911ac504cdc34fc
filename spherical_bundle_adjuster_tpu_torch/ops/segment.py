"""Segment sums in a fixed order: the port's `jax.ops.segment_sum`.

The solvers scatter per-observation and per-edge blocks into per-camera
and per-node sums many times with the same segment ids (the observation
layout and the graph's edges are fixed for a whole solve). `index_add_`
on a CUDA tensor adds with atomics, so the order of the float additions,
and with it the result, can change from run to run. Here the ids are
sorted once (`segments`, a stable device sort and an integer count),
and each sum gathers the rows in that order and reduces each segment's
run of rows with `torch.segment_reduce`, which adds a segment's rows one
after another in one thread. So `segment_sum` gives the same bits on
every run on one device, and neither step makes a host sync. As in
`jax.ops.segment_sum`, rows whose id lies outside [0, num_segments) are
dropped: they go in turn to trailing segments, one for every DROP_ROWS
rows of ids, which are summed and thrown away, so that no one thread
adds them all (a multiview problem built from tracks drops most of its
rows) and a sum that drops nothing gets few extra segments.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


# rows of ids per trailing segment that takes dropped rows: n ids get
# _num_drop(n) of them, row i goes to the (i mod _num_drop(n))-th
DROP_ROWS = 512


def _num_drop(n: int) -> int:
    return max(1, -(-n // DROP_ROWS))


class Segments(NamedTuple):
    order: torch.Tensor    # (n,) int64 rows by segment id, stable; dropped rows last
    lengths: torch.Tensor  # (num_segments + _num_drop(n),) int64 rows per segment; the
    #                        last _num_drop(n) hold the dropped rows


def segments(ids, num_segments: int) -> Segments:
    """The summation order of (n,) segment ids, on the ids' device."""
    ids = ids.reshape(-1).long()
    n_drop = _num_drop(ids.numel())
    drop = num_segments + torch.arange(ids.numel(), device=ids.device) % n_drop
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, drop)
    lengths = torch.zeros(num_segments + n_drop, dtype=torch.long, device=ids.device)
    lengths.index_add_(0, ids, torch.ones_like(ids))
    return Segments(torch.argsort(ids, stable=True), lengths)


def segment_sum(data, seg: Segments):
    """(num_segments, ...) sums of the rows of (n, ...) data, each over
    the rows its segment id names (zero for an empty segment)."""
    sums = torch.segment_reduce(data[seg.order], "sum", lengths=seg.lengths, axis=0,
                                unsafe=True)
    return sums[:-_num_drop(seg.order.numel())]
