"""lm_graph_pct's reader: the share of a call's LM loop trips that ran
as a CUDA graph's replay, worked out by hand, and nothing for a program
that replays no trip or keeps no counters."""

from __future__ import annotations

from collections import Counter

import pytest

from benchmark import spec

from .conftest import REPO


def _set_last_call(monkeypatch, counts):
    from spherical_bundle_adjuster_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "LAST_CALL", Counter(counts), raising=False)


def test_lm_graph_pct_gives_the_share_worked_out_by_hand(monkeypatch):
    """A depth loop of 9 trips (10 reads, the first trip op by op, 8
    replays) and a rotation loop of 3 (4 reads, 2 replays): 10 of 14."""
    bench = spec.Spec(REPO)
    _set_last_call(monkeypatch, {"lm.depth.syncs": 10, "lm.depth.graph_trips": 8,
                                 "lm.rot.syncs": 4, "lm.rot.graph_trips": 2, "lm.graphs": 2,
                                 "lm.rot.active": 5})
    for suffix in ("pair", "batch"):
        assert bench.reader(f"lm_graph_pct.{suffix}")({}) == pytest.approx(100.0 * 10 / 14)


def test_lm_graph_pct_gives_nothing_without_replays(monkeypatch):
    from spherical_bundle_adjuster_tpu_torch.utils import profiling

    bench = spec.Spec(REPO)
    _set_last_call(monkeypatch, {"lm.depth.syncs": 10, "lm.depth.active": 30})  # the parent
    assert bench.reader("lm_graph_pct.pair")({}) is None
    monkeypatch.delattr(profiling, "LAST_CALL")
    assert bench.reader("lm_graph_pct.batch")({}) is None
