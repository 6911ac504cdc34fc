"""K3's tiling plan (ops/cuda_match.top2_plan), on the CPU. A CUDA kernel
cannot run here, so these tests replay in numpy how csrc/match_top2.cu
cuts the (query, train) pairs among query tiles, blocks, sub-tiles and
threads, and how it merges the top-2 of each: per thread in ascending
row order, then over the 16 lanes of a query by butterfly, then over the
blocks of a query tile in split order (the last block to finish folds
them), always by (d2, index). The replay is held against the plain
version's indices, with duplicate train rows planted across lane,
sub-tile and block boundaries."""

import numpy as np
import pytest
import torch

from spherical_bundle_adjuster_tpu_torch.ops import cuda_match

torch.set_num_threads(1)

Q, SUB = cuda_match.Q_TILE, cuda_match.SUB_ROWS
GRID, PER = 16, 8  # the kernel's 16 x 16 thread grid, 8 x 8 outputs each
# the 2K bank, the 512x1024 bank (4 bands x 256 keypoints; also the
# 10-keyframe sequence's), the orbit sequence's parity and dense banks
# (4 and 8 bands x 64 keypoints: problems.sequence_launch_shapes), ragged
# and tiny banks, and an 8K-scale bank
SHAPES = [(2048, 2048), (1024, 1024), (256, 256), (512, 512), (1, 64), (100, 333),
          (300, 2100), (8192, 8192)]
H100_SMS = 132


def _blocks(plan, k1, k2):
    """(query rows, train rows of each sub-tile, rank) of every block."""
    for qt in range(plan.q_tiles):
        qrows = np.arange(qt * Q, min((qt + 1) * Q, k1))
        for r in range(plan.splits):
            lo, hi = r * plan.span, min((r + 1) * plan.span, k2)
            yield qrows, [np.arange(s, min(s + SUB, hi)) for s in range(lo, hi, SUB)], r


def _thread_tile():
    """(query, train) offsets in a Q x SUB tile of thread (a, b):
    queries a + 16 i, train rows b + 16 j."""
    off = GRID * np.arange(PER)
    return {(a, b): (a + off, b + off) for a in range(GRID) for b in range(GRID)}


@pytest.mark.parametrize("k1,k2", SHAPES)
def test_plan_covers_every_pair_once(k1, k2):
    plan = cuda_match.top2_plan(k1, k2)
    assert 1 <= plan.splits <= cuda_match.MAX_SPLITS
    assert plan.span % SUB == 0 and plan.splits * plan.span >= k2
    assert (plan.span - SUB) * plan.splits < k2  # no shorter span covers the bank
    count = np.zeros((k1, k2), np.uint8)
    for qrows, subs, _ in _blocks(plan, k1, k2):
        for rows in subs:
            count[qrows[0]: qrows[-1] + 1, rows[0]: rows[-1] + 1] += 1
    assert (count == 1).all()
    tile = np.zeros((Q, SUB), np.int32)
    for qo, to in _thread_tile().values():
        tile[np.ix_(qo, to)] += 1
    assert (tile == 1).all()


def test_plan_fills_one_wave_at_the_2k_shape():
    plan = cuda_match.top2_plan(2048, 2048)
    assert plan == cuda_match.Top2Plan(q_tiles=16, splits=8, span=256)
    assert plan.q_tiles * plan.splits == 128 <= H100_SMS
    # a larger bank gives each block more rows, not more blocks
    assert cuda_match.top2_plan(8192, 8192) == cuda_match.Top2Plan(64, 8, 1024)


def _before(d, i, e, j):
    return (d < e) | ((d == e) & (i < j))


def _merge(x, y):
    """Top-2 of the union of two top-2 (d1, i1, d2, i2), elementwise, as
    the kernel's merge()."""
    d1, i1, d2, i2 = x
    e1, j1, e2, j2 = y
    b_wins = _before(e1, j1, d1, i1)
    b_sec = _before(e2, j2, d1, i1)
    a_sec = _before(e1, j1, d2, i2)
    n1 = np.where(b_wins, e1, d1), np.where(b_wins, j1, i1)
    n2d = np.where(b_wins, np.where(b_sec, e2, d1), np.where(a_sec, e1, d2))
    n2i = np.where(b_wins, np.where(b_sec, j2, i1), np.where(a_sec, j1, i2))
    return n1[0], n1[1], n2d, n2i


def _thread_top2(dist2, rows):
    """Each query's top-2 over `rows` (ascending) as a thread inserts
    them: strict '<', so ties keep the lower index; (inf, 0) where fewer
    than two rows are finite."""
    nq = dist2.shape[0]
    d1 = np.full(nq, np.inf, np.float32)
    d2 = d1.copy()
    i1 = np.zeros(nq, np.int64)
    i2 = i1.copy()
    if len(rows):
        sub = dist2[:, rows]
        order = np.argsort(sub, axis=1, kind="stable")[:, :2]
        for k, (dd, ii) in enumerate(((d1, i1), (d2, i2))):
            if order.shape[1] > k:
                v = np.take_along_axis(sub, order[:, k: k + 1], 1)[:, 0]
                fin = np.isfinite(v)
                dd[fin] = v[fin]
                ii[fin] = rows[order[fin, k]]
    return d1, i1, d2, i2


def _replay(dist2, plan, k1, k2):
    """The kernel's top-2 indices, replayed from the plan."""
    out = np.zeros((k1, 2), np.int64)
    merged = {}
    for qrows, subs, r in _blocks(plan, k1, k2):
        sub_d = dist2[qrows]
        lanes = []
        for b in range(GRID):
            rows = np.concatenate([s[b::GRID] for s in subs]) if subs else np.zeros(0, int)
            lanes.append(_thread_top2(sub_d, rows.astype(np.int64)))
        for m in (1, 2, 4, 8):  # butterfly over the 16 lanes of a query
            lanes = [_merge(lanes[b], lanes[b ^ m]) for b in range(GRID)]
        qt = qrows[0] // Q
        if r == 0:
            inf, zero = np.full(len(qrows), np.inf, np.float32), np.zeros(len(qrows), np.int64)
            merged[qt] = (inf, zero, inf, zero)
        merged[qt] = _merge(merged[qt], lanes[0])
        if r == plan.splits - 1:
            d1, i1, d2, i2 = merged[qt]
            out[qrows] = np.stack([i1, i2], 1)
    return out


def _tied_banks(k1, k2, seed):
    """Random banks with ~10% invalid train rows, and exact duplicates of
    query 0 at rows 1 and 16 (lanes 1 and 0 of one sub-tile: the lane
    merge must order them by index, not by lane), k2 // 2 + 1 and k2 - 1
    (other blocks), and of query 1 at rows 6 and 22 (one thread), 700
    (invalid) and 1500 (another block). Returns the rows that hold each
    query's valid duplicates, in ascending order."""
    rng = np.random.default_rng(seed)
    d1 = rng.normal(size=(k1, 64)).astype(np.float32)
    d2 = rng.normal(size=(k2, 64)).astype(np.float32)
    valid = rng.random(k2) > 0.1
    twins = []
    for qi, spots in enumerate(([1, 16, k2 // 2 + 1, k2 - 1], [6, 22, 700, 1500])[:k1]):
        spots = sorted({s for s in spots if s < k2})
        d2[spots] = d1[qi]
        valid[spots] = [s != 700 for s in spots]
        twins.append([s for s in spots if valid[s]])
    return d1, d2, valid, twins


@pytest.mark.parametrize("k1,k2", [s for s in SHAPES if s != (8192, 8192)])
def test_replayed_merge_gives_plain_indices(k1, k2):
    """The full 8192 x 8192 distance matrix is too large for a CPU test;
    its coverage is checked above."""
    d1, d2, valid, twins = _tied_banks(k1, k2, k1 + k2)
    t1, t2, tv = torch.from_numpy(d1), torch.from_numpy(d2), torch.from_numpy(valid)
    _, want = cuda_match.top2_distances_plain(t1, t2, tv)
    # the same squared distances as the plain version
    tt = torch.sum(t2 * t2, dim=-1)
    qq = torch.sum(t1 * t1, dim=-1, keepdim=True)
    dist2 = torch.clamp(qq + tt - 2.0 * (t1 @ t2.T), min=0.0)
    dist2 = torch.where(tv[None, :], dist2, torch.inf).numpy()
    for qi, rows in enumerate(twins):  # exact ties: the lower indices win
        assert len(rows) >= 2 and len(set(dist2[qi, rows].tolist())) == 1
        np.testing.assert_array_equal(want[qi].numpy(), rows[:2])
    got = _replay(dist2, cuda_match.top2_plan(k1, k2), k1, k2)
    np.testing.assert_array_equal(got, want.numpy())


def _replay_batch(dist2s, plan, k1, k2):
    """The batched launch, replayed on flat buffers as csrc/match_top2.cu
    addresses them: block (split r, query tile qt, pair p) writes its
    top-2 to part[(p * splits + r) * k1 + qi] and counts on
    count[p * q_tiles + qt]; the block that brings a counter to `splits`
    folds that pair's splits in order. Returns (indices (P, k1, 2), how
    often each scratch slot was written, the final counters)."""
    p_n = len(dist2s)
    part = [None] * (p_n * plan.splits * k1)
    writes = np.zeros(p_n * plan.splits * k1, np.int64)
    count = np.zeros(p_n * plan.q_tiles, np.int64)
    out = np.zeros((p_n, k1, 2), np.int64)
    for p in range(p_n):
        for qrows, subs, r in _blocks(plan, k1, k2):
            sub_d = dist2s[p][qrows]
            lanes = []
            for b in range(GRID):
                rows = np.concatenate([s[b::GRID] for s in subs]) if subs else np.zeros(0, int)
                lanes.append(_thread_top2(sub_d, rows.astype(np.int64)))
            for m in (1, 2, 4, 8):
                lanes = [_merge(lanes[b], lanes[b ^ m]) for b in range(GRID)]
            for n, qi in enumerate(qrows):
                slot = (p * plan.splits + r) * k1 + qi
                part[slot] = tuple(x[n] for x in lanes[0])
                writes[slot] += 1
            qt = qrows[0] // Q
            c = p * plan.q_tiles + qt
            count[c] += 1
            if count[c] == plan.splits:  # the last block of this (pair, tile)
                for n, qi in enumerate(qrows):
                    acc = (np.float32(np.inf), 0, np.float32(np.inf), 0)
                    for k in range(plan.splits):
                        acc = _merge(acc, part[(p * plan.splits + k) * k1 + qi])
                    out[p, qi] = (acc[1], acc[3])
                count[c] = 0
    return out, writes, count


@pytest.mark.parametrize("k1,k2", [(100, 333), (300, 2100), (1, 64), (256, 256), (512, 512)])
def test_replayed_batched_merge_gives_each_pairs_plain_indices(k1, k2):
    """Three pairs in one launch: every pair's indices are the plain
    version's of that pair alone (ties planted per pair), every scratch
    slot of every (pair, split, query) is written once, and every (pair,
    query tile) counter is left at zero for the next launch."""
    banks = [_tied_banks(k1, k2, k1 + k2 + p) for p in range(3)]
    d1, d2, valid = (torch.from_numpy(np.stack([b[i] for b in banks])) for i in range(3))
    _, want = cuda_match.top2_distances_plain(d1, d2, valid)
    assert want.shape == (3, k1, 2)
    dist2s = []
    for p in range(3):
        _, one = cuda_match.top2_distances_plain(d1[p], d2[p], valid[p])
        assert torch.equal(want[p], one)
        tt = torch.sum(d2[p] * d2[p], dim=-1)
        qq = torch.sum(d1[p] * d1[p], dim=-1, keepdim=True)
        dist2 = torch.clamp(qq + tt - 2.0 * (d1[p] @ d2[p].T), min=0.0)
        dist2s.append(torch.where(valid[p][None, :], dist2, torch.inf).numpy())
    plan = cuda_match.top2_plan(k1, k2)
    got, writes, count = _replay_batch(dist2s, plan, k1, k2)
    np.testing.assert_array_equal(got, want.numpy())
    assert (writes == 1).all() and not count.any()
