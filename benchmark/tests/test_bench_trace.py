"""The traced window's reduction: busy time is the union of device
activities inside the traced calls, the calls' own range on the device
is no work, and each idle gap is named by the innermost host operation
running at its middle."""

from __future__ import annotations

import pytest

from benchmark import spec, trace

from .conftest import REPO

EVENTS = [  # (name, on the device, start us, end us)
    (trace.CALL, False, 0.0, 100.0),
    (trace.CALL, True, 0.0, 100.0),         # the range's copy on the device timeline
    ("aten::mul", False, 5.0, 30.0),
    ("cudaLaunchKernel", False, 20.0, 25.0),
    ("aten::item", False, 60.0, 90.0),
    ("kernel_a", True, 10.0, 40.0),
    ("kernel_b", True, 30.0, 50.0),          # overlaps kernel_a: counted once
    ("kernel_a", True, 80.0, 120.0),         # clipped at the window's end
    ("outside", True, 150.0, 160.0),
]


def test_busy_is_the_union_of_device_work_in_the_window():
    red = trace.reduce_events(EVENTS)
    assert red["window_us"] == (0.0, 100.0)
    assert red["busy_us"] == pytest.approx(40.0 + 20.0)
    assert [tuple(g[1:]) for g in red["gaps"]] == [(0.0, 10.0), (50.0, 80.0)]
    assert [g[0] for g in red["gaps"]] == ["aten::mul", "aten::item"]
    brk = trace.breakdown(red)
    assert brk["device_ops"][0] == ["kernel_a", pytest.approx(50e-6)]
    assert dict(brk["idle_gaps"]) == {"aten::item": pytest.approx(30e-6),
                                      "aten::mul": pytest.approx(10e-6)}


def test_idle_share_reads_the_reduction():
    red = trace.reduce_events(EVENTS)
    read = spec.Spec(REPO).reader("device_idle_pct.pair")
    assert read({"trace": red}) == pytest.approx(40.0)


def test_a_trace_without_a_call_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce_events([e for e in EVENTS if e[0] != trace.CALL])
