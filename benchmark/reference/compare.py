"""The comparison that decides `correct`: each judged answer of the
program against the plain reference, on the same images and RANSAC
draws.

The front end is judged against the reference's own front end on the
pair's images. The refinement is judged against the reference's
refinement run on the answer's own match list (lifted, with the pair's
draws, batched over the call's pairs as the program batched them): the
consensus picks slots of that list, so a list that differs in the last
bits of one distance would otherwise send both sides down different
draws. Numbers, each the largest over the judged answers:

  match_dist_gap     |distance| gap of a match both sides found (K3's
                     arithmetic: its fp32 products);
  match_unexplained  matches found by one side only that no rounding tie
                     explains (band crops, K1 / K2 keypoints, orientations
                     and descriptors, K3's picks, the ratio test): a
                     match explains itself when the reference's top-2 of
                     its query put it within TIE_DIST of the ratio test's
                     boundary, or its two candidates within TIE_DIST of
                     each other, or the list was full;
  init_gap_deg       angle between the two consensus initial guesses;
  rot_gap_deg        angle between the two refined rotations;
  tran_gap           |t_program - t_reference| of the refined translations;
  refine_excess      compat: the share of the BA cost that the reference's
                     BCD stages still take off when they run on from the
                     program's refined state (optimality.remaining_cost);
  pose_cost_gap      corrected: how much worse the program's refined pose
                     explains the matches than the reference's pose of the
                     same matches, depths left free (optimality.pose_cost),
                     as a share: the refinement judged by its cost, which
                     a pure rotation leaves well conditioned where the pose
                     is not;
  unsolved_matches   matches the configuration's solve has to solve (every
                     valid match in compat; in corrected mode at least
                     outlier_min_keep, which the gates keep) whose depths
                     the program left at the initial depth, in a pair with
                     a consensus guess: 0 in any sound run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

from . import config as rcfg
from . import frontend, optimality, sphere, twoview

NUMBERS = ("match_dist_gap", "match_unexplained", "init_gap_deg", "rot_gap_deg", "tran_gap",
           "refine_excess", "pose_cost_gap", "unsolved_matches")
# Two descriptor distances closer than this are a rounding tie: fp32
# arithmetic that sums in another order moves a distance by ~1e-4 at most
# (|q|^2 + |t|^2 - 2 q.t against an fma chain: 5e-5 seen on the card).
TIE_DIST = 1e-3


def config_from_files(classes, config: dict, traffic: dict):
    """A PipelineConfig of the module `classes` (the reference's config,
    or the program's, which has the same classes): every field the
    configuration's file gives, then the traffic's per-call `request`."""
    groups = {"surf": classes.SurfConfig, "match": classes.MatchConfig,
              "frontend": classes.FrontendConfig, "ransac": classes.RansacConfig,
              "ba": classes.BaConfig}
    kw = {k: (groups[k](**{f: tuple(x) if isinstance(x, list) else x for f, x in v.items()})
              if k in groups else v) for k, v in config["pipeline"].items()}
    cfg = classes.PipelineConfig(**kw)
    for group, over in traffic.get("request", {}).items():
        cfg = dataclasses.replace(cfg, **{group: dataclasses.replace(getattr(cfg, group), **over)})
    return cfg


def reference_config(config: dict, traffic: dict):
    """The reference's PipelineConfig from the same files as the program's."""
    return config_from_files(rcfg, config, traffic)


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 with TF32 off (the configuration's), or on (the control)."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def to_numpy(tree):
    """Tensor leaves of nested tuples as numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, (tuple, list)):
        items = [to_numpy(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree


def reference_front(config, traffic, inputs, rows, chunk=0, tf32=False):
    """The reference's band front end over one call's pairs (in passes of
    `chunk` pairs, as the program's call makes them): (FrontendResult
    with a leading pair axis, [top-2 table of each pair]), as numpy."""
    cfg = reference_config(config, traffic)
    idx = torch.as_tensor(rows, device=inputs.lefts.device)
    with precision(tf32):
        return to_numpy(frontend.band_pairs_with_top2(inputs.lefts[idx], inputs.rights[idx], cfg,
                                                      chunk))


def reference_refine(config, traffic, inputs, rows, answer, tf32=False):
    """The reference's refinement of the answer's own matches (one pair, or
    the call's pairs with a leading axis): SimpleNamespace of numpy
    rotation_aa, translation, depths, initial_euler, initial_translation,
    ok."""
    cfg = reference_config(config, traffic)
    dev = inputs.lefts.device
    h, w = inputs.lefts.shape[1:3]
    left = torch.as_tensor(np.asarray(answer.left_xy), device=dev)
    right = torch.as_tensor(np.asarray(answer.right_xy), device=dev)
    valid = torch.as_tensor(np.asarray(answer.match_valid), device=dev)
    idx = torch.as_tensor(rows, device=dev)
    gumbel = inputs.gumbel[idx] if left.ndim == 3 else inputs.gumbel[rows[0]]
    with precision(tf32):
        r, t, d, guess, _ = twoview.adjust_from_matches(
            sphere.pixel_to_bearing(left, w, h), sphere.pixel_to_bearing(right, w, h), valid,
            None, cfg, gumbel=gumbel)
    return SimpleNamespace(**{k: v.cpu().numpy() for k, v in dict(
        rotation_aa=r, translation=t, depths=d, initial_euler=guess.euler,
        initial_translation=guess.translation, ok=guess.ok).items()})


def control_answer(config, traffic, inputs, rows, chunk=0):
    """The control in the program's place: the reference computed with TF32
    on (the nearest precision below the configuration's), its front end
    and its refinement over the call's pairs."""
    fr, _ = reference_front(config, traffic, inputs, rows, chunk, tf32=True)
    fields = ("left_xy", "right_xy", "match_valid", "match_distance")
    ans = SimpleNamespace(**{f: getattr(fr, f) if len(rows) > 1 else getattr(fr, f)[0]
                             for f in fields})
    ref = reference_refine(config, traffic, inputs, rows, ans, tf32=True)
    return SimpleNamespace(**vars(ans), **vars(ref))


def row(answer, j):
    """Row j of a batched answer (every leaf's leading axis), as one pair's."""
    if isinstance(answer, np.ndarray):
        return answer[j]
    if isinstance(answer, SimpleNamespace):
        return SimpleNamespace(**{k: row(v, j) for k, v in vars(answer).items()})
    if isinstance(answer, tuple):
        items = [row(x, j) for x in answer]
        return type(answer)(*items) if hasattr(answer, "_fields") else tuple(items)
    return answer


def rodrigues(aa):
    """The rotation matrix of an angle-axis vector, in float64."""
    aa = np.asarray(aa, np.float64)
    th = np.linalg.norm(aa)
    k = aa / max(th, 1e-300)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(th) * K + (1 - math.cos(th)) * K @ K


def euler_matrix(e):
    """R = Rz @ Ry @ Rx of Euler angles (rx, ry, rz), in float64."""
    rx, ry, rz = np.asarray(e, np.float64)
    cx, sx, cy, sy, cz, sz = (math.cos(rx), math.sin(rx), math.cos(ry), math.sin(ry),
                              math.cos(rz), math.sin(rz))
    return np.array([[cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
                     [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
                     [-sy, cy * sx, cy * cx]])


def angle_deg(Ra, Rb) -> float:
    """Geodesic angle between two rotation matrices, in degrees (from the
    chord |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2), exact at small angles)."""
    chord = float(np.linalg.norm(np.asarray(Ra) - np.asarray(Rb)))
    return math.degrees(2.0 * math.asin(min(1.0, chord / math.sqrt(8.0))))


def _key(xy):
    return tuple(np.asarray(xy, np.float32).view(np.uint32).tolist())


def _matches(a):
    v = np.asarray(a.match_valid, bool)
    return {_key(l) + _key(r): float(d) for l, r, d in
            zip(a.left_xy[v], a.right_xy[v], a.match_distance[v])}


def _explained(key, queries, full_at):
    """Whether a match found by one side only is a rounding tie by the
    reference's top-2 of its query (see the module's docstring).
    `queries`: left key -> [(d1, d2, right key 1, right key 2)]."""
    lk, rk = key[:2], key[2:]
    for d1, d2, r1, r2, ratio in queries.get(lk, ()):
        near_ratio = abs(d1 - ratio * d2) <= TIE_DIST
        near_order = abs(d2 - d1) <= TIE_DIST
        if rk == r1 and (near_ratio or near_order or d1 >= full_at):
            return True
        if rk == r2 and near_order:
            return True
    return False


def _queries(table, ratio):
    qxy, qvalid, dist, rxy = table
    out = {}
    for q in np.flatnonzero(qvalid):
        d1, d2 = (float(x) for x in dist[q])
        if math.isfinite(d1) and math.isfinite(d2):
            out.setdefault(_key(qxy[q]), []).append(
                (d1, d2, _key(rxy[q, 0]), _key(rxy[q, 1]), ratio))
    return out


def unsolved(answer, ba) -> int:
    """Matches the solve had to solve and left at the initial depth (0 for
    a pair without a consensus guess, whose solve is discarded)."""
    if not bool(np.asarray(answer.ok)):
        return 0
    n_valid = int(np.asarray(answer.match_valid, bool).sum())
    need = n_valid if ba.reference_compat or not ba.outlier_reject else min(
        n_valid, ba.outlier_min_keep)
    return max(0, need - int(optimality.solved(answer.depths, answer.match_valid,
                                               ba.init_depth).sum()))


def refinement_by_cost(cfg, ones, refined, device, width, height):
    """The refinement number of the mode, one a judged answer: compat's
    refine_excess, or corrected mode's pose_cost_gap against the
    reference's refinements `refined` of the same answers."""
    with precision(False):
        if cfg.ba.reference_compat:
            return "refine_excess", optimality.remaining_cost(cfg, ones, width, height, device)
        theirs = [SimpleNamespace(**{f: getattr(a, f) for f in ("left_xy", "right_xy",
                                                              "match_valid")},
                                  rotation_aa=r.rotation_aa, translation=r.translation)
                  for a, r in zip(ones, refined)]
        mine = optimality.pose_cost(cfg, ones, width, height, device)
        ref = optimality.pose_cost(cfg, theirs, width, height, device)
        return "pose_cost_gap", mine / np.maximum(ref, 1e-30) - 1.0


def readings(answer, front, refined, ratio: float, ba) -> dict:
    """The numbers of one judged answer (one pair) but its refinement's
    cost (refinement_by_cost):
    `front` the reference's front end of its pair, `refined` the
    reference's refinement of its own matches."""
    fr, table = front
    mp, mr = _matches(answer), _matches(fr)
    both = mp.keys() & mr.keys()
    # a full list drops its farthest matches: a tie there is the capacity's
    full_at = min((max(m.values()) - TIE_DIST for m, a in ((mp, answer), (mr, fr))
                   if m and len(m) == np.asarray(a.match_valid).shape[-1]), default=math.inf)
    differ = mp.keys() ^ mr.keys()
    queries = _queries(table, ratio) if differ else {}
    unexplained = sum(not _explained(k, queries, full_at) for k in differ)
    return dict(
        match_dist_gap=max((abs(mp[k] - mr[k]) for k in both), default=0.0),
        match_unexplained=float(unexplained),
        init_gap_deg=angle_deg(euler_matrix(answer.initial_euler), euler_matrix(refined.initial_euler)),
        rot_gap_deg=angle_deg(rodrigues(answer.rotation_aa), rodrigues(refined.rotation_aa)),
        tran_gap=float(np.linalg.norm(np.asarray(answer.translation, np.float64)
                                      - np.asarray(refined.translation, np.float64))),
        unsolved_matches=float(unsolved(answer, ba)),
        lists_differ=bool(differ),
    )


def judge_calls(config, traffic, inputs, judged, chunk=0):
    """Readings of every judged answer: `judged` is a list of (rows of a
    call, its answer, positions in the call to judge); `chunk` the pairs
    of one front-end pass of the program's call."""
    cfg = reference_config(config, traffic)
    out, ones, refs = [], [], []
    for rows, answer, pos in judged:
        fr, tables = reference_front(config, traffic, inputs, rows, chunk)
        refined = reference_refine(config, traffic, inputs, rows, answer)
        for j in pos:
            one = answer if len(rows) == 1 else row(answer, j)
            ref = refined if len(rows) == 1 else row(refined, j)
            out.append(readings(one, (row(fr, j), tables[j]), ref, cfg.match.ratio_thresh, cfg.ba))
            ones.append(one)
            refs.append(ref)
    if ones:
        h, w = inputs.lefts.shape[1:3]
        name, values = refinement_by_cost(cfg, ones, refs, inputs.lefts.device, w, h)
        for r, x in zip(out, values):
            r[name] = float(x)
    return out


def judge(per_answer: list, limits: dict):
    """(correct, {number: [largest reading, limit]}): correct when there is
    a judged answer and every compared number is at or under its limit.
    A number without a limit is reported and not compared; a limit on a
    number the mode does not read fails."""
    read = [k for k in NUMBERS if any(k in r for r in per_answer) or k in limits]
    worst = {k: max((r[k] for r in per_answer if k in r), default=None) for k in read}
    table = {k: [worst[k], limits.get(k)] for k in read}
    correct = bool(per_answer) and all(v is not None and v <= lim for v, lim in table.values()
                                       if lim is not None)
    return correct, table
