"""Cross-pair feature-track merging: consecutive-pair matches into
multi-observation landmarks, from spherical_bundle_adjuster_tpu/models/
tracks.py, on the matches' device with no host read.

  * JOIN (`link_consecutive`): match m of pair k (frames k -> k+1)
    continues match m' of pair k-1 iff its LEFT keypoint falls in the
    grid cell of pair k-1's RIGHT keypoint m'. Both are detections in
    frame k by the same detector, so they agree bit for bit. Where the
    reference compares cells in an (M, M) equality table per pair and
    takes the argmax (the lowest m' among equal cells), each pair's right
    cells are sorted once (stable, valid slots first) and each left cell
    is looked up with `searchsorted`: the first of equal keys in a stable
    sort is the lowest m', so the answer is the same, in O(Np M log M)
    time and O(Np M) memory.
  * TRACK IDS (`merge_tracks`): the reference carries (id, slot) along
    the chain with one `lax.scan` over pairs. A match's id is its root's
    rank among all roots and its slot is its distance from that root, so
    pointer doubling over the (Np, M) predecessor table gives both in
    ceil(log2(Np - 1)) rounds of gathers.
  * ASSEMBLY (`build_multiview_problem`): observations go into the
    landmark-major (L, P) table of models/multiview: each match's left
    observation at (track, slot), the right observation of a chain's
    tail at (track, slot + 1). Several matches can name one cell (two
    pair-k matches in one left cell both continue the same pair-(k-1)
    match). The reference's scatters let the last write in flattened
    (pair, match) order win, the right-observation scatter after the
    left one; here each cell's winner is that same source, found with an
    order-free `scatter_reduce("amax")` of source positions, and the
    table is gathered from the winners, so the card and the CPU give
    the same bits. Landmarks start at the midpoint triangulation of each
    root match, lifted to the world through the chained pose of its left
    camera; bearings and landmarks are computed in float64 and rounded
    once, where the reference stays in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import rotation, sphere
from . import multiview as mv

_INT32 = (-2 ** 31, 2 ** 31 - 1)


class TrackTable(NamedTuple):
    """Per-match track assignment over (Np, M) consecutive-pair matches."""

    track_id: torch.Tensor    # (Np, M) int32 compact landmark index, -1 invalid
    slot: torch.Tensor        # (Np, M) int32 position of the match in its track
    has_next: torch.Tensor    # (Np, M) bool: a pair-(k+1) match continues this one
    num_tracks: torch.Tensor  # scalar int32: number of distinct tracks (roots)


def _cell_keys(xy, valid, cell_size):
    """(..., M) int64 keys of the grid cells round(xy / cell_size), each
    coordinate cast to int32 as XLA casts (saturating, NaN to 0); invalid
    slots, which may hold anything, are zeroed before the cast."""
    c = torch.round(torch.where(valid[..., None], xy / cell_size, 0.0))
    c = torch.nan_to_num(c, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31).long().clamp(*_INT32)
    return c[..., 0] * 2 ** 32 + (c[..., 1] - _INT32[0])


def link_consecutive(left_xy, right_xy, valid, cell_size: float = 0.5):
    """links[k, m] = index m' of the pair-k match continued by pair-(k+1)
    match m (right keypoint of (k, m') == left keypoint of (k+1, m) up to
    cell quantization; the lowest such m'), or -1. Returns (Np-1, M)
    int32."""
    m = valid.shape[-1]
    prev = _cell_keys(right_xy[:-1], valid[:-1], cell_size)
    query = _cell_keys(left_xy[1:], valid[1:], cell_size)
    # valid slots first, by key, each run of equal keys by slot
    order = torch.argsort(prev, dim=-1, stable=True)
    invalid = (~valid[:-1]).to(torch.uint8).gather(-1, order)
    order = order.gather(-1, torch.argsort(invalid, dim=-1, stable=True))
    keys = prev.gather(-1, order)
    n_valid = valid[:-1].sum(-1, keepdim=True)
    # invalid slots sort last with the largest key (searchsorted needs a
    # sorted row; a valid key equal to it still comes first)
    keys = torch.where(torch.arange(m, device=keys.device) < n_valid, keys,
                       torch.iinfo(torch.int64).max)
    pos = torch.searchsorted(keys, query)
    hit = pos.clamp(max=m - 1)
    found = (pos < n_valid) & (keys.gather(-1, hit) == query) & valid[1:]
    return torch.where(found, order.gather(-1, hit), -1).int()


def merge_tracks(left_xy, right_xy, valid, cell_size: float = 0.5) -> TrackTable:
    """Assign compact track ids/slots to all matches of a consecutive-pair
    chain. left_xy/right_xy: (Np, M, 2); valid: (Np, M)."""
    n_pairs, m = valid.shape
    dev = valid.device
    links = link_consecutive(left_xy, right_xy, valid, cell_size)  # (Np-1, M)

    # roots: valid matches not linked to a predecessor
    linked = torch.cat([torch.zeros((1, m), dtype=torch.bool, device=dev), links >= 0])
    is_root = valid & ~linked
    root_rank = torch.cumsum(is_root.reshape(-1), 0) - 1
    num_tracks = is_root.sum().int()

    # pointer doubling: parent = the linked predecessor (a root or an
    # unlinked slot points at itself), depth = links to the parent; after
    # r rounds each pointer has jumped 2^r links or reached its root
    flat = torch.arange(n_pairs * m, device=dev)
    prev = torch.cat([torch.zeros((1, m), dtype=torch.long, device=dev),
                      (links.long() + (torch.arange(n_pairs - 1, device=dev) * m)[:, None])])
    parent = torch.where(linked, prev, flat.reshape(n_pairs, m)).reshape(-1)
    depth = linked.reshape(-1).long()
    for _ in range(math.ceil(math.log2(max(n_pairs - 1, 1)))):
        depth = depth + depth[parent]
        parent = parent[parent]
    track_id = torch.where(valid.reshape(-1), root_rank[parent], -1).int().reshape(n_pairs, m)
    slot = depth.int().reshape(n_pairs, m)

    # has_next[k, m'] = some pair-(k+1) match links back to m' (the same
    # value at every duplicate target, m the dump column)
    tgt = torch.where(links >= 0, links.long(), m)
    nexts = torch.zeros((n_pairs - 1, m + 1), dtype=torch.bool, device=dev)
    nexts.scatter_(1, tgt, True)
    has_next = torch.cat([nexts[:, :m], torch.zeros((1, m), dtype=torch.bool, device=dev)])
    return TrackTable(track_id=track_id, slot=slot, has_next=has_next, num_tracks=num_tracks)


def _triangulate_midpoint(b1, b2, r_aa, t):
    """Midpoint triangulation of matched bearings (batched over leading
    dims). Rays: camera i at origin along b1; camera j at center
    c = R^T t with direction R^T b2 (from p_j = R p_i - t).
    Returns (X (..., 3) in camera-i frame, ok (...,))."""
    R = rotation.angle_axis_to_matrix(r_aa)
    d2 = torch.einsum("...i,...ij->...j", b2, R)  # R^T b2
    c2 = torch.einsum("...ij,...i->...j", R, t)   # R^T t
    b1d2 = torch.sum(b1 * d2, dim=-1)
    rhs1 = torch.sum(b1 * c2, dim=-1)
    rhs2 = torch.sum(d2 * c2, dim=-1)
    det = 1.0 - b1d2 * b1d2
    s = (rhs1 - b1d2 * rhs2) / torch.clamp(det, min=1e-9)
    u = (b1d2 * rhs1 - rhs2) / torch.clamp(det, min=1e-9)
    p1 = b1 * s[..., None]
    p2 = c2 + d2 * u[..., None]
    X = 0.5 * (p1 + p2)
    ok = (det > 1e-6) & (s > 0.1) & torch.all(torch.isfinite(X), dim=-1)
    return torch.where(ok[..., None], X, 0.0), ok


def _last_writer(cells, ok, n_cells):
    """(n_cells,) int64: for each cell, the flat position of the last
    source (in flattened order) with ok that names it, or -1. The maximum
    does not depend on the order of the reduction, so this is exact on
    every device."""
    cells = torch.where(ok, cells, n_cells).reshape(-1)
    src = torch.arange(cells.numel(), device=cells.device)
    win = torch.full((n_cells + 1,), -1, dtype=torch.long, device=cells.device)
    return win.scatter_reduce_(0, cells, src, "amax")[:n_cells]


def _gather(win, values, fill):
    """values[win] where win >= 0, else fill (values flat on dim 0)."""
    got = values[win.clamp(min=0)]
    hit = (win >= 0).reshape(win.shape + (1,) * (values.dim() - 1))
    return torch.where(hit, got, fill)


def build_multiview_problem(
    poses,
    left_xy,
    right_xy,
    match_valid,
    pair_rot_aa,
    pair_tran,
    width: int,
    height: int,
    max_obs_per_track: int = 6,
) -> mv.MultiViewProblem:
    """Landmark-major (L, P) problem from consecutive-pair matches with
    cross-pair track merging, on the inputs' device, with no host read.

    poses: (C=Np+1, 6) world->camera chained poses; left_xy/right_xy:
    (Np, M, 2) matched ERP pixels of pair k (frames k, k+1); match_valid:
    (Np, M); pair_rot_aa/pair_tran: (Np, 3) per-pair two-view relative
    poses (used only for landmark triangulation init).

    L = Np * M rows (every match could be a root; rows beyond the actual
    track count stay invalid); P = max_obs_per_track, observations past
    the cap are dropped.
    """
    n_pairs, m = match_valid.shape
    L = n_pairs * m
    P = max_obs_per_track
    dev = match_valid.device

    tt = merge_tracks(left_xy, right_xy, match_valid)

    # bearings and landmarks in float64, rounded once to float32 (the
    # reference: float32 throughout): the midpoint divides by det = 1 -
    # (b1 . R^T b2)^2, which cancels, so one float32 step of a bearing
    # moves a landmark by ~1e-7 / det of its norm, and the card's and the
    # CPU's float32 sin / cos differ by such steps
    b_left64 = sphere.pixel_to_bearing(left_xy.double(), width, height)
    b_right64 = sphere.pixel_to_bearing(right_xy.double(), width, height)
    b_left, b_right = (b.float().reshape(-1, 3) for b in (b_left64, b_right64))
    cam_left = torch.arange(n_pairs, dtype=torch.int32, device=dev)[:, None].expand(n_pairs, m)
    tid, slot = tt.track_id.long(), tt.slot.long()

    # left obs at (tid, slot); right obs at (tid, slot + 1) only for chain
    # tails (a successor's left obs fills that cell otherwise: same frame,
    # same keypoint). The right scatter comes second, so its writes win.
    def cells(s, ok):
        ok = ok & (tid >= 0) & (s >= 0) & (s < P)
        return tid * P + s.clamp(0, P - 1), ok

    w_left = _last_writer(*cells(slot, match_valid), L * P)
    w_right = _last_writer(*cells(slot + 1, match_valid & ~tt.has_next), L * P)
    cam_l = cam_left.reshape(-1)
    obs_cam = _gather(w_right, cam_l + 1, _gather(w_left, cam_l, 0)).reshape(L, P)
    obs_bearing = _gather(w_right, b_right, _gather(w_left, b_left, 0.0)).reshape(L, P, 3)
    obs_valid = ((w_left >= 0) | (w_right >= 0)).reshape(L, P)

    # landmark init: triangulate each ROOT match with its pair's relative
    # pose, lift to world through the chained pose of its left camera
    # (X_w = R_i^T (X_ci + t_i) from p_i = R_i X_w - t_i)
    X_local, tri_ok = _triangulate_midpoint(
        b_left64, b_right64,
        pair_rot_aa.double()[:, None, :].expand(n_pairs, m, 3),
        pair_tran.double()[:, None, :].expand(n_pairs, m, 3),
    )
    pose_l = poses.double()[:n_pairs, None, :]
    R_l = rotation.angle_axis_to_matrix(pose_l[..., :3])
    Xw = torch.einsum("...ij,...i->...j", R_l, X_local + pose_l[..., 3:]).to(poses.dtype)

    root_ok = match_valid & (slot == 0) & (tid >= 0)
    w_root = _last_writer(tid, root_ok, L)  # one root per track
    landmarks = _gather(w_root, Xw.reshape(-1, 3), 0.0)
    lm_tri_ok = _gather(w_root, tri_ok.reshape(-1), False)

    lm_valid = lm_tri_ok & (obs_valid.sum(-1) >= 2)
    return mv.MultiViewProblem(
        poses=poses,
        landmarks=landmarks,
        obs_cam=obs_cam,
        obs_bearing=obs_bearing,
        obs_valid=obs_valid & lm_valid[:, None],
        lm_valid=lm_valid,
    )
