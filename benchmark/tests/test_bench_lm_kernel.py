"""lm_kernel_pct's reader: the share of a call's LM loop trips that ran
through the trip kernels, worked out by hand, and nothing for a
program that runs no trip as the kernel or keeps no counters."""

from __future__ import annotations

from collections import Counter

import pytest

from benchmark import spec

from .conftest import REPO


def _set_last_call(monkeypatch, counts):
    from spherical_bundle_adjuster_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "LAST_CALL", Counter(counts), raising=False)


def test_lm_kernel_pct_gives_the_share_worked_out_by_hand(monkeypatch):
    """A depth loop of 9 trips that stops on its read (10 reads, 9 kernel
    trips) and a rotation loop at a cap of 4 (4 reads, 4 trips): 13 of 14."""
    bench = spec.Spec(REPO)
    _set_last_call(monkeypatch, {"lm.depth.syncs": 10, "lm.depth.kernel_trips": 9,
                                 "lm.rot.syncs": 4, "lm.rot.kernel_trips": 4,
                                 "lm.rot.active": 5, "lm.rot.slots": 8})
    for suffix in ("pair", "batch"):
        assert bench.reader(f"lm_kernel_pct.{suffix}")({}) == pytest.approx(100.0 * 13 / 14)


def test_lm_kernel_pct_gives_nothing_without_kernel_trips(monkeypatch):
    from spherical_bundle_adjuster_tpu_torch.utils import profiling

    bench = spec.Spec(REPO)
    _set_last_call(monkeypatch, {"lm.depth.syncs": 10, "lm.depth.graph_trips": 8,
                                 "lm.graphs": 1})  # a program that replays graphs
    assert bench.reader("lm_kernel_pct.pair")({}) is None
    _set_last_call(monkeypatch, {})
    assert bench.reader("lm_kernel_pct.pair")({}) is None
    monkeypatch.delattr(profiling, "LAST_CALL")
    assert bench.reader("lm_kernel_pct.batch")({}) is None
