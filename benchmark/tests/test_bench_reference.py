"""The plain reference is the program's plain path, frozen: on the CPU,
where the program runs its kernels' plain versions, the two give the
same answers bit for bit, in compat and in corrected mode, one pair at
a time and as a batch."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import generator
from benchmark.reference import compare, twoview
from benchmark.system import System, pipeline_config

from .conftest import BENCH


def _cell(mode, per_call):
    cfg = json.loads((BENCH / "configs" / "erp_pair_2k.json").read_text())
    cfg["pipeline"]["surf"].update(max_keypoints=128, n_octaves=2)
    cfg["pipeline"]["match"].update(max_matches=256)
    cfg.update(image={"height": 128, "width": 256}, pairs_per_call=per_call)
    mix = json.loads((BENCH / "traffic" / f"pool32.{mode}.json").read_text())
    mix["pool_pairs"] = 2
    return cfg, mix


@pytest.mark.parametrize("mode", ["compat", "corrected"])
def test_reference_equals_the_programs_plain_path(mode):
    cfg, mix = _cell(mode, 1)
    pc = pipeline_config(cfg, mix)
    inputs = generator.make_inputs(cfg, mix, pc.ransac.num_trials, pc.match.max_matches, 5, "cpu")
    system = System(cfg, mix, inputs, torch.device("cpu"))
    rc = compare.reference_config(cfg, mix)
    for i in (0, 1):
        got = system.call([i])
        with compare.precision(False):
            want = compare.to_numpy(twoview.run_two_view(inputs.lefts[i], inputs.rights[i], None,
                                                         rc, gumbel=inputs.gumbel[i]))
        for a, b in zip(got[:-1], want[:-1]):
            assert np.array_equal(a, b)
    judged = [([i], system.call([i]), [0]) for i in (0, 1)]
    for r in compare.judge_calls(cfg, mix, inputs, judged):
        assert not r["lists_differ"]
        assert all(r[k] == 0.0 for k in compare.NUMBERS if k in r and k != "refine_excess"), r
        # the compat stages run on from the program's state take ~nothing off
        assert 0.0 <= r.get("refine_excess", 0.0) < 1e-3, r


def test_batch_rows_are_judged_against_the_same_batched_refinement():
    cfg, mix = _cell("compat", 2)
    pc = pipeline_config(cfg, mix)
    inputs = generator.make_inputs(cfg, mix, pc.ransac.num_trials, pc.match.max_matches, 6, "cpu")
    out = System(cfg, mix, inputs, torch.device("cpu")).call([0, 1])
    for r in compare.judge_calls(cfg, mix, inputs, [([0, 1], out, [0, 1])]):
        assert not r["lists_differ"]
        assert all(r[k] == 0.0 for k in compare.NUMBERS if k in r and k != "refine_excess"), r
        assert 0.0 <= r["refine_excess"] < 1e-3, r
