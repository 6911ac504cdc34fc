"""Nested containers of tensors in the JAX package's leaf order.

`flatten` lists the leaves of NamedTuples, tuples, lists and dicts as
`jax.tree.flatten` does (fields in order, dict keys sorted, None holds no
leaf), so a checkpoint written here reads back leaf for leaf in the JAX
package, and `to_host` pulls every tensor of a result off the card in one
copy.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree):
    """(leaves, treedef): the leaves in jax.tree's order and what
    `unflatten` needs to rebuild the containers around new leaves."""
    leaves = []

    def walk(x):
        if x is None:
            return ("none",)
        if _is_namedtuple(x):
            return ("namedtuple", type(x), [walk(c) for c in x])
        if isinstance(x, (tuple, list)):
            return (type(x).__name__, [walk(c) for c in x])
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", keys, [walk(x[k]) for k in keys])
        leaves.append(x)
        return ("leaf",)

    return leaves, walk(tree)


def unflatten(treedef, leaves):
    """The containers of `treedef` around `leaves` (in flatten's order)."""
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "namedtuple":
            return node[1](*(build(c) for c in node[2]))
        if kind == "dict":
            return {k: build(c) for k, c in zip(node[1], node[2])}
        children = [build(c) for c in node[1]]
        return tuple(children) if kind == "tuple" else children

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def describe(treedef) -> str:
    """The structure as jax's str(treedef) writes it, e.g.
    PyTreeDef(CustomNode(namedtuple[MultiViewProblem], [*, *]))."""

    def text(node):
        kind = node[0]
        if kind == "leaf":
            return "*"
        if kind == "none":
            return "None"
        if kind == "namedtuple":
            inner = ", ".join(text(c) for c in node[2])
            return f"CustomNode(namedtuple[{node[1].__name__}], [{inner}])"
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {text(c)}" for k, c in zip(node[1], node[2])) + "}"
        inner = ", ".join(text(c) for c in node[1])
        if kind == "tuple":
            return f"({inner},)" if len(node[1]) == 1 else f"({inner})"
        return f"[{inner}]"

    return f"PyTreeDef({text(treedef)})"


def to_host(tree):
    """The tree with every tensor leaf as a numpy array: the tensors of
    each device are packed into one byte buffer there and copied to the
    host in one transfer (the JAX package's np.asarray tree-map). Other
    leaves pass through np.asarray."""
    leaves, treedef = flatten(tree)
    out = [None if isinstance(x, torch.Tensor) else np.asarray(x) for x in leaves]
    by_device = {}
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor):
            by_device.setdefault(x.device, []).append(i)
    for idx in by_device.values():
        parts = [leaves[i].detach().contiguous().reshape(-1).view(torch.uint8) for i in idx]
        buf = torch.cat(parts).cpu().numpy()
        off = 0
        for i, p in zip(idx, parts):
            t = leaves[i]
            dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
            out[i] = buf[off:off + p.numel()].copy().view(dtype).reshape(tuple(t.shape))
            off += p.numel()
    return unflatten(treedef, out)
