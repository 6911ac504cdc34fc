"""The refinement judged by its cost. A pure rotation leaves the pose's
rotation and translation trading off along a flat valley of the BA
cost (and compat mode's translation free), so float32 rounding alone
moves the refined pose further than skipping the refinement does. The
cost is flat along that valley, so the cost is what is judged.

  compat     `remaining_cost`: the reference's BCD round run on from the
             program's own state, stage by stage (the depth stage at the
             program's consensus start, r0 = -euler as the reference's
             quirk has it, and its translation; the rotation stage on the
             first two matches' left depths; the translation stage at the
             program's rotation), on the same matches. The share of each
             stage's cost that the reference still takes off, the largest
             of the three, is ~1e-5 for a sound solve (the LM stops at a
             relative decrease of 1e-6) and some units for a skipped one.
  corrected  `pose_cost`: how well a pose explains the matches with every
             depth left free. The joint Schur polish has no minimum to
             run on to here: on a pure rotation the barrier drives the
             depths up without end, and 20 more steps take 0.1-13x of the
             cost off a sound solve's. The profile over depths has no
             such gauge: the program's pose is held to the reference's
             pose of the same matches.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lm, sphere


def _banks(answers, width, height, device):
    """(stack, match masks, left bearings, right bearings) of the answers:
    stack(field) is that field of every answer, stacked on `device`."""

    def stack(field, dtype=torch.float32):
        return torch.as_tensor(np.stack([np.asarray(getattr(a, field)) for a in answers]),
                               device=device).to(dtype)

    return (stack, stack("match_valid", torch.bool),
            sphere.pixel_to_bearing(stack("left_xy"), width, height),
            sphere.pixel_to_bearing(stack("right_xy"), width, height))


def _share(start, end):
    """The cost taken off from `start` as a share of where it ends."""
    return (start - end) / torch.clamp(end, min=1e-30)


def solved(depths, valid, init_depth):
    """Valid matches whose depths left the initial depth: (..., M)."""
    d = torch.as_tensor(np.asarray(depths))
    v = torch.as_tensor(np.asarray(valid, bool))
    return v & (d != init_depth).any(dim=-1)


def pose_cost(cfg, answers, width, height, device, keep_frac=0.8):
    """How well each answer's pose (r, t) explains its matches, depths left
    free: every valid match's depths solved by the reference's depth stage
    at that pose (from the initial depth), and the smallest keep_frac of
    the per-match costs (reprojection plus barrier) summed, so that the
    outliers the gates drop do not count. A numpy array, one a pair."""
    ba = cfg.ba
    stack, valid, b1, b2 = _banks(answers, width, height, device)
    r, t = stack("rotation_aa"), stack("translation")
    with torch.no_grad():
        d0 = torch.full(valid.shape + (2,), ba.init_depth, dtype=torch.float32, device=device)
        d, _ = lm.solve_depths(b1, b2, d0, r, t, valid, ba)
        rep = lm.reprojection_residual(b1, b2, d[..., 0], d[..., 1], r[..., None, :],
                                       t[..., None, :])
        bar = ba.barrier_lambda * torch.exp(-ba.barrier_c * d)
        per = 0.5 * (torch.sum(rep * rep, dim=-1) + torch.sum(bar * bar, dim=-1))
        per = torch.sort(torch.where(valid, per, torch.inf), dim=-1).values
        n = torch.sum(valid.to(torch.int64), dim=-1)
        keep = torch.arange(per.shape[-1], device=device) < torch.clamp(
            torch.floor(keep_frac * n.to(torch.float32)).to(torch.int64), min=1)[..., None]
        cost = torch.sum(torch.where(keep & torch.isfinite(per), per, 0.0), dim=-1)
    return cost.cpu().numpy().astype(np.float64)


def remaining_cost(cfg, answers, width, height, device):
    """Compat mode: the share of the cost that the reference's BCD stages
    still take off from each answer's refined state, the largest of the
    three: a numpy array, one value a pair. `answers`: pair answers
    (numpy leaves) of one cell, stacked here."""
    ba = cfg.ba
    stack, valid, b1, b2 = _banks(answers, width, height, device)
    r, t, d = stack("rotation_aa"), stack("translation"), stack("depths")
    r0, t0 = -stack("initial_euler"), stack("initial_translation")
    d_pair = torch.stack([d[..., 0, 0], d[..., 1, 0]], dim=-1)
    with torch.no_grad():
        _, rep_d = lm.solve_depths(b1, b2, d, r0, t0, valid, ba)
        _, rep_r = lm.solve_rotation(b1, b2, d_pair, r, t0, valid, ba)
        _, rep_t = lm.solve_translation(b1, b2, d_pair, r, t, valid, ba)
        share = torch.stack([_share(rep.initial_cost, rep.final_cost)
                             for rep in (rep_d, rep_r, rep_t)], dim=-1).amax(dim=-1)
    return share.cpu().numpy().astype(np.float64)
