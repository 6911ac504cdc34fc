"""`correct` comes out false when the timed path is broken: the harness's
run of a tiny cell on the CPU (the look for a card skipped), held to a
real cell's limits, with the program's answers replaced by the control
(the reference with its descriptor products in TF32), or with the
program broken underneath in each way a two-view cell can break (on one
chip there is no exchange between chips to leave out)."""

from __future__ import annotations

import contextlib
import json

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.reference import compare, top2

from .conftest import run_args, tiny_root


def _result(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _run(tmp_path, capsys, per_call, mix, checks_of, corrupt=None, pool=4, seconds=1.0):
    bench = tiny_root(tmp_path, per_call, mix, checks_of, pool)
    rc = run.run_cell(bench, bench.workload("tiny.cell"), run_args(seconds), torch.device("cpu"),
                      corrupt=corrupt)
    assert rc == 0
    return _result(capsys)


CELLS = [(1, "pool32.compat", "pair_2k.compat"), (1, "pool32.corrected", "pair_2k.corrected"),
         (2, "pool256.compat", "batch64_512.compat"),
         (2, "pool256.corrected", "batch64_512.corrected")]


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest), as the tensor
    cores read a float32 operand."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def tf32_products(monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(top2, "product", lambda q, t: tf32(q) @ tf32(t).T)
        yield


class Control:
    """The control in the program's place: the reference, its descriptor
    products in emulated TF32 (the CPU has no TF32 of its own)."""

    def __init__(self, system, monkeypatch):
        self.system, self.mp = system, monkeypatch

    def call(self, rows):
        s = self.system
        with tf32_products(self.mp):
            return compare.control_answer(s.config, s.traffic, s.inputs, rows,
                                          0 if len(rows) == 1 else s.batch_chunk)


@pytest.mark.parametrize("per_call,mix,checks_of", CELLS)
def test_a_sound_run_is_correct(tmp_path, capsys, per_call, mix, checks_of):
    res = _run(tmp_path, capsys, per_call, mix, checks_of)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= per_call
    assert res["checks"]["match_dist_gap"]["limit"] is not None


@pytest.mark.parametrize("per_call,mix,checks_of", CELLS)
def test_the_control_is_not_correct(tmp_path, capsys, monkeypatch, per_call, mix, checks_of):
    # 8 pool pairs, all judged: the descriptor gaps have a long tail
    res = _run(tmp_path, capsys, per_call, mix, checks_of,
               corrupt=lambda s: Control(s, monkeypatch), pool=8, seconds=4.0)
    assert not res["correct"], res["checks"]
    assert res["checks"]["match_dist_gap"]["value"] > res["checks"]["match_dist_gap"]["limit"]


@pytest.mark.parametrize("per_call,mix,checks_of", CELLS)
def test_a_band_warp_that_returns_its_input_unchanged_is_not_correct(
        tmp_path, capsys, monkeypatch, per_call, mix, checks_of):
    from spherical_bundle_adjuster_tpu_torch.ops import warp

    def unrotated(image, pitch_rad, mode="floor"):  # every band the 0-pitch crop
        h = image.shape[0]
        band = image[3 * h // 8: 3 * h // 8 + h // 4]
        return band.expand((pitch_rad.shape[0],) + band.shape).contiguous()

    monkeypatch.setattr(warp, "crop_rotated_band", unrotated)
    res = _run(tmp_path, capsys, per_call, mix, checks_of)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("per_call,mix,checks_of", CELLS)
def test_a_refinement_that_returns_its_state_unchanged_is_not_correct(
        tmp_path, capsys, monkeypatch, per_call, mix, checks_of):
    """Every LM solve and the joint Schur polish return their start: the
    pose may move less than rounding alone moves it (PERF.md), but the
    depths stay at the initial depth and the cost is not taken off."""
    from spherical_bundle_adjuster_tpu_torch.solver import lm

    def stuck_lm(cost_and_system, x0, cfg, max_iters=None, lower_bound=None):
        cost = cost_and_system(x0)[0]
        zero = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
        return x0, lm.StageReport(zero, cost, cost)

    def stuck_schur(b1, b2, d0, r0, t0, match_valid, cfg, num_iters=20):
        return r0, t0, d0, torch.zeros(r0.shape[:-1] + (num_iters,), device=r0.device)

    monkeypatch.setattr(lm, "lm_fixed", stuck_lm)
    monkeypatch.setattr(lm, "solve_joint_schur", stuck_schur)
    res = _run(tmp_path, capsys, per_call, mix, checks_of)
    assert not res["correct"], res["checks"]
    assert res["checks"]["unsolved_matches"]["value"] > res["checks"]["unsolved_matches"]["limit"]


@pytest.mark.parametrize("per_call,mix,checks_of", CELLS[2:])
def test_half_of_the_batch_left_out_is_not_correct(tmp_path, capsys, per_call, mix, checks_of):
    class Half:
        def __init__(self, system):
            self.system = system

        def call(self, rows):
            half = self.system.call(rows[: len(rows) // 2])
            return compare_rows_twice(half)

    res = _run(tmp_path, capsys, per_call, mix, checks_of, corrupt=Half)
    assert not res["correct"], res["checks"]


def compare_rows_twice(tree):
    """A batched answer of n pairs as 2n: the first n answer for the rest."""
    if isinstance(tree, np.ndarray):
        return np.concatenate([tree, tree])
    if isinstance(tree, tuple):
        items = [compare_rows_twice(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


@pytest.mark.parametrize("what", ["match", "rotation"])
@pytest.mark.parametrize("per_call,mix,checks_of", CELLS)
def test_an_answer_altered_where_produced_is_not_correct(tmp_path, capsys, per_call, mix,
                                                         checks_of, what):
    class Altered:
        def __init__(self, system):
            self.system = system

        def call(self, rows):
            out = self.system.call(rows)
            if what == "match":  # every right pixel one column over
                xy = out.right_xy.copy()
                xy[..., 0] += 1.0
                return out._replace(right_xy=xy)
            return out._replace(rotation_aa=-out.rotation_aa)  # the inverse rotation

    # the cell judges 16 answers: compat's cost sees an inverted rotation on
    # some pairs only (PERF.md), so the rotation is judged on 8 pool pairs
    more = dict(pool=8, seconds=4.0) if what == "rotation" else {}
    res = _run(tmp_path, capsys, per_call, mix, checks_of, corrupt=Altered, **more)
    assert not res["correct"], res["checks"]



class CardControl:
    """The control on the card: the reference with TF32 really on."""

    def __init__(self, system):
        self.system = system

    def call(self, rows):
        s = self.system
        return compare.control_answer(s.config, s.traffic, s.inputs, rows,
                                      0 if len(rows) == 1 else s.batch_chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("per_call,mix,checks_of", [CELLS[0], CELLS[3]])
def test_on_the_card_a_sound_run_is_correct_and_the_tf32_control_is_not(
        tmp_path, capsys, per_call, mix, checks_of):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: pytest benchmark/tests -m cuda)")
    dev = torch.device("cuda", 0)
    bench = tiny_root(tmp_path, per_call, mix, checks_of)
    cell = bench.workload("tiny.cell")
    assert run.run_cell(bench, cell, run_args(seconds=2.0), dev) == 0
    assert _result(capsys)["correct"]
    assert run.run_cell(bench, cell, run_args(seconds=2.0), dev, corrupt=CardControl) == 0
    res = _result(capsys)
    assert not res["correct"], res["checks"]
    assert res["checks"]["match_dist_gap"]["value"] > res["checks"]["match_dist_gap"]["limit"]
