"""The frozen renderer equals the program's utils/synthetic bit for bit
at a small size, and the generator makes the same inputs from a seed."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import generator, scenes


def test_frozen_renderer_equals_the_programs():
    from spherical_bundle_adjuster_tpu_torch.utils import synthetic

    for seed in (0, 7):
        rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
        pa = scenes.texture_params_from_numpy(rng_a)
        pb = synthetic.texture_params_from_numpy(rng_b)
        assert all(np.array_equal(a, b) for a, b in zip(pa, pb))
        euler = np.deg2rad(np.array([2.0, -4.0, 3.5], np.float32))
        la, ra, Ra = scenes.rotation_pair(pa, euler, 64, 128, "cpu")
        lb, rb, Rb = synthetic.rotation_pair(pb, euler, 64, 128, "cpu")
        assert torch.equal(la, lb) and torch.equal(ra, rb) and torch.equal(Ra, Rb)


def test_generator_repeats_from_a_large_seed():
    cfg, mix = {"image": {"height": 32, "width": 64}}, {"pool_pairs": 3, "euler_deg_max": 5.0, "discs": 96,
                                            "waves": 24}
    a = generator.make_inputs(cfg, mix, 80, 128, 2**31 + 3, "cpu")
    b = generator.make_inputs(cfg, mix, 80, 128, 2**31 + 3, "cpu")
    c = generator.make_inputs(cfg, mix, 80, 128, 2**31 + 4, "cpu")
    assert torch.equal(a.lefts, b.lefts) and torch.equal(a.rights, b.rights)
    assert torch.equal(a.gumbel, b.gumbel)
    assert not torch.equal(a.lefts, c.lefts) and a.lefts.shape == c.lefts.shape
    assert a.gumbel.shape == (3, 80, 128)
