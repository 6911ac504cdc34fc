"""Exact brute-force top-2 nearest descriptors in plain PyTorch (what
the program's K3 computes): for each query, the two nearest valid train
rows by d2 = max(|q|^2 + |t|^2 - 2 q.t, 0), invalid rows +inf, ties to
the lower index; sqrt distances and int32 indices. A frozen copy of
spherical_bundle_adjuster_tpu_torch/ops/cuda_match.top2_distances_plain.
The q.t products are a float32 matmul, so they run in TF32 where
torch.backends.cuda.matmul.allow_tf32 is set (the harness's control).
"""

from __future__ import annotations

import torch

_CHUNK = 4096  # query rows per plain distance block


def product(q, t):
    """The (Q, T) products q.t of two banks: one float32 matmul."""
    return q @ t.T


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
        dist2 = torch.clamp(qq + tt - 2.0 * product(q, d2), min=0.0)
        dist2 = torch.where(valid2[None, :], dist2, torch.inf)
        i1 = torch.argmin(dist2, dim=-1, keepdim=True)
        b1 = torch.gather(dist2, 1, i1)
        rest = dist2.scatter(1, i1, torch.inf)
        i2 = torch.argmin(rest, dim=-1, keepdim=True)
        b2 = torch.gather(rest, 1, i2)
        dists.append(torch.sqrt(torch.cat([b1, b2], dim=1)))
        idxs.append(torch.cat([i1, i2], dim=1).to(torch.int32))
    return torch.cat(dists), torch.cat(idxs)
