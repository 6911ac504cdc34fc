"""The measured window and the end-to-end metrics taken over it.

A closed loop with one caller: call k is sent when call k - 1 has
returned its result to the host. Every time is the host's clock
(time.perf_counter) around a call that ends in a copy off the card, so
each call's time includes all of its device work.
"""

from __future__ import annotations

import statistics
import time
from typing import NamedTuple


class Window(NamedTuple):
    seconds: float       # from the window's start to the last call's return
    call_s: list         # wall time of each call, in order
    pairs_per_call: int
    answers: list        # (pool rows, host result) of each call, in order

    @property
    def pairs(self) -> int:
        return len(self.call_s) * self.pairs_per_call


def run_window(system, seconds: float, pairs_per_call: int, pool: int, call_rows, first_call=0):
    """Calls back to back until `seconds` have passed; every call that
    started inside the window is waited for and counted."""
    call_s, answers = [], []
    k = first_call
    t_start = time.perf_counter()
    t_end = t_start + seconds
    now = t_start
    while now < t_end:
        rows = call_rows(k, pairs_per_call, pool)
        t0 = time.perf_counter()
        out = system.call(rows)
        now = time.perf_counter()
        call_s.append(now - t0)
        answers.append((rows, out))
        k += 1
    return Window(now - t_start, call_s, pairs_per_call, answers)


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of all values, by
    statistics.quantiles' exclusive method at a 1% step."""
    return statistics.quantiles(values, n=100)[round(q) - 1]


def pair_ms(w: Window) -> float:
    """The whole window over the pairs completed in it, in ms."""
    return 1e3 * w.seconds / w.pairs


def pair_ms_p95(w: Window) -> float:
    """The 95th percentile of every pair's wall time in the window, in ms
    (a pair is a call of one pair)."""
    if w.pairs_per_call != 1:
        raise ValueError("pair_ms_p95 is a metric of one pair a call")
    return 1e3 * percentile(w.call_s, 95)


def pairs_per_s(w: Window) -> float:
    """All pairs of the calls completed in the window, over the window."""
    return w.pairs / w.seconds


END_TO_END = {"pair_ms": pair_ms, "pair_ms_p95": pair_ms_p95, "pairs_per_s": pairs_per_s}
