"""The one traffic generator: a pool of synthetic ERP pairs and their
RANSAC draws, made from --seed, and the order in which a closed loop
with one caller sends them.

A traffic mix (traffic/<name>.json) gives
  pool_pairs      distinct pairs held on the device
  euler_deg_max   each pair's Euler angles are U(-e, e) deg on each axis
  discs, waves    the scene's discs and Fourier waves
  request         PipelineConfig fields the caller sets on every call
                  ({"ba": {...}, "ransac": {...}}), e.g. the solve mode
and the configuration gives the image size (`image`) and `pairs_per_call`: a call
takes that many consecutive pool pairs, the next call the next ones,
wrapping round the pool. Every seed gives the same sizes; the seed
moves the scenes, the angles and the draws. Scenes are pure rotations
of the frozen renderer's discs and waves: a mix with another pose draw
(a pitch, parallax) needs a generator that reads new keys, which only a
`benchmark` change can add (spec.MIX_KEYS refuses the rest).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import scenes


class Inputs(NamedTuple):
    lefts: torch.Tensor    # (N, H, W, 3) uint8 on the device
    rights: torch.Tensor   # (N, H, W, 3) uint8
    gumbel: torch.Tensor   # (N, num_trials, max_matches) float32 RANSAC draws


def gumbel_draws(num_trials: int, m: int, generator, device, lead=()):
    """lead + (num_trials, m) standard Gumbel noise (the program's
    solver/epipolar.gumbel_draws)."""
    u = torch.rand(tuple(lead) + (num_trials, m), generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def make_inputs(config: dict, traffic: dict, num_trials: int, max_matches: int, seed: int,
                device) -> Inputs:
    """The pool of traffic["pool_pairs"] pairs at the configuration's size."""
    n, h, w = traffic["pool_pairs"], config["image"]["height"], config["image"]["width"]
    ss = np.random.SeedSequence(abs(int(seed)))
    pose_rng, *scene_ss = ss.spawn(n + 1)
    e = traffic["euler_deg_max"]
    eulers = np.deg2rad(np.random.default_rng(pose_rng).uniform(-e, e, (n, 3)))
    lefts = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    rights = torch.empty_like(lefts)
    for i in range(n):
        params = scenes.texture_params_from_numpy(np.random.default_rng(scene_ss[i]),
                                                  n_waves=traffic["waves"],
                                                  n_discs=traffic["discs"])
        lefts[i], rights[i], _ = scenes.rotation_pair(params, eulers[i].astype(np.float32),
                                                      h, w, device)
    gen = torch.Generator(device).manual_seed(int(ss.generate_state(1, np.uint64)[0]) >> 1)
    gumbel = gumbel_draws(num_trials, max_matches, gen, device, (n,))
    return Inputs(lefts, rights, gumbel)


def call_rows(k: int, pairs_per_call: int, pool: int) -> list:
    """The pool rows of call k (0, 1, 2, ...) of the closed loop."""
    start = (k * pairs_per_call) % pool
    return [(start + j) % pool for j in range(pairs_per_call)]
