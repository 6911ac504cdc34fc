"""The end-to-end metrics are taken over the whole window: every pair
and all of its time, not over chunks."""

from __future__ import annotations

import statistics

import pytest

from benchmark import generator, window


def _window(call_s, per_call, seconds=None):
    return window.Window(seconds if seconds is not None else sum(call_s), list(call_s), per_call,
                         [None] * len(call_s))


def test_pair_ms_is_the_window_over_its_pairs():
    w = _window([0.1, 0.2, 0.3, 0.4], 1, seconds=1.05)  # host work between calls counts
    assert window.pair_ms(w) == pytest.approx(1e3 * 1.05 / 4)


def test_pairs_per_s_counts_every_pair_of_every_batch():
    w = _window([0.25] * 8, 64)
    assert window.pairs_per_s(w) == pytest.approx(8 * 64 / 2.0)


def test_p95_is_over_all_pairs_not_over_chunks():
    # 200 fast pairs and 12 slow ones, the slow ones together: a p95 over
    # chunks of 20 (or a median of chunk p95s) would miss them
    call_s = [0.1] * 100 + [1.0] * 12 + [0.1] * 100
    w = _window(call_s, 1)
    want = statistics.quantiles(call_s, n=100)[94]
    assert window.pair_ms_p95(w) == pytest.approx(1e3 * want)
    assert window.pair_ms_p95(w) > 500
    chunked = statistics.median(statistics.quantiles(call_s[i:i + 20], n=100)[94]
                                for i in range(0, 200, 20))
    assert 1e3 * chunked < 200


def test_p95_is_refused_for_batches():
    with pytest.raises(ValueError):
        window.pair_ms_p95(_window([0.2] * 30, 64))


def test_run_window_waits_for_the_last_call_and_counts_it():
    class Slow:
        def call(self, rows):
            import time
            time.sleep(0.03)
            return rows

    w = window.run_window(Slow(), 0.1, 2, 5, generator.call_rows)
    assert w.pairs == 2 * len(w.call_s) and len(w.call_s) >= 3
    assert w.seconds >= 0.1 and w.seconds >= sum(w.call_s)
    assert [rows for rows, _ in w.answers][:3] == [[0, 1], [2, 3], [4, 0]]
