"""Checkpoint / resume for long multi-keyframe solves, ported from the
JAX package's utils/checkpoint.py.

The reference has no checkpointing (SURVEY.md §5: run once and exit).
Solver state (the problem's poses and landmarks, and the round) is saved
in the JAX package's npz layout: <path>.npz holding the leaves as
arr_0, arr_1, ... in jax.tree's leaf order, `__treedef__` (the structure
as text) and `__step__` (-1 for none). The JAX package's load_checkpoint
reads such a file through its own npz branch. The JAX package tries
orbax first, which needs jax; the port writes only the npz layout.
`solve_multiview_resumable` restarts from the last round saved.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from . import tree as tree_util


def save_checkpoint(path: str, tree: Any, step: int | None = None):
    """Save a tree of tensors (NamedTuples, tuples, lists, dicts) to
    <path>.npz, written to a temporary file and renamed into place.
    Returns "npz", the kind written."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    host = tree_util.to_host(tree)
    flat, treedef = tree_util.flatten(host)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            *flat,
            __treedef__=np.frombuffer(tree_util.describe(treedef).encode(), np.uint8),
            __step__=np.asarray(-1 if step is None else step),
        )
    os.replace(tmp, path + ".npz")
    return "npz"


def load_checkpoint(path: str, like: Any):
    """Restore a tree saved by save_checkpoint (or by the JAX package's
    npz branch); `like` gives the structure, and each leaf comes back as
    a tensor on the device and with the dtype of its leaf in `like`.
    Returns (tree, step or None)."""
    path = os.path.abspath(path)
    leaves_like, treedef = tree_util.flatten(like)
    with np.load(path + ".npz") as data:
        arrays = [data[f"arr_{i}"] for i in range(len(leaves_like))]
        step = int(data["__step__"])
    leaves = [
        torch.from_numpy(a).to(device=l.device, dtype=l.dtype)
        if isinstance(l, torch.Tensor) else torch.from_numpy(a)
        for a, l in zip(arrays, leaves_like)
    ]
    return tree_util.unflatten(treedef, leaves), (None if step < 0 else step)


def solve_multiview_resumable(
    prob,
    ckpt_path: str,
    total_iters: int = 40,
    iters_per_round: int = 10,
    mesh=None,
):
    """Multi-keyframe solve in checkpointed rounds: each round runs
    `iters_per_round` LM iterations (solve_multiview afresh, so its
    damping restarts each round, as in the JAX package), persists
    (problem, round) and can be resumed after an interruption by calling
    again with the same path. Returns (problem, costs of the rounds run
    in this call).

    With `mesh` (parallel/mesh), every rank of its "data" axis calls this
    with the whole problem and runs dist_ba.solve_multiview_sharded; only
    the axis's first rank writes the checkpoint, and a collective on the
    axis follows each write, so no rank reads a half-written file."""
    from ..models import multiview as mv

    start_round = 0
    if os.path.exists(ckpt_path) or os.path.exists(ckpt_path + ".npz"):
        prob, step = load_checkpoint(ckpt_path, prob)
        start_round = 0 if step is None else step

    axis = None
    if mesh is not None:
        from ..parallel import dist_ba

        axis = mesh.axis("data")
    rounds = max(total_iters // iters_per_round, 1)
    costs_all = []
    for r in range(start_round, rounds):
        if mesh is not None:
            prob, costs = dist_ba.solve_multiview_sharded(
                prob, mesh, num_iters=iters_per_round
            )
        else:
            prob, costs = mv.solve_multiview(prob, num_iters=iters_per_round)
        costs_all.append(costs)
        if axis is None or axis.index == 0:
            save_checkpoint(ckpt_path, prob, step=r + 1)
        if axis is not None:
            axis.all_reduce(torch.zeros(1, device=prob.poses.device))  # the write is done
    if costs_all:
        return prob, torch.cat(costs_all)
    return prob, torch.zeros(0, dtype=prob.poses.dtype, device=prob.poses.device)
