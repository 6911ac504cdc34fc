"""The traced sub-window: a few calls under torch.profiler, reduced to
what the per-layer readers and the `device` and `breakdown` keys need.

Everything of the program runs on one stream, so the union of the device
activities' intervals (kernels, copies, fills) is the time the card was
busy. The window is the span of the traced calls on the host's clock
(each a `bench.call` range), which the profiler shares with the device;
the range's own copy on the device's timeline is no device work.
An idle gap is labelled by the innermost host operation running at its
middle (an aten op, or the CUDA runtime call it made); "python" where
the host ran none.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.autograd import DeviceType

CALL = "bench.call"


def profile_calls(system, rows_list):
    """The calls on `rows_list` under the profiler: every activity as
    (name, on the device, start us, end us), read straight from the
    profiler's results (building its event tree takes minutes)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for rows in rows_list:
            with torch.profiler.record_function(CALL):
                system.call(rows)
        torch.cuda.synchronize()
    return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events) -> dict:
    """{"window_us": (start, end), "device_ops": [(name, start, end)],
    "busy_us", "gaps": [(label, start, end)]}, times in microseconds."""
    calls = [(t0, t1) for name, dev, t0, t1 in events if name == CALL and not dev]
    if not calls:
        raise RuntimeError("the trace holds no traced call")
    w0 = min(t0 for t0, _ in calls)
    w1 = max(t1 for _, t1 in calls)
    dev = [(name, max(t0, w0), min(t1, w1)) for name, d, t0, t1 in events
           if d and name != CALL]
    dev = [d for d in dev if d[2] > d[1]]
    busy = _merge([(s, e) for _, s, e in dev])
    host = sorted((t0, t1, name) for name, d, t0, t1 in events if not d and name != CALL)
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append([None, prev, s])
        prev = max(prev, e)
    # one sweep over the host ranges in start order with a stack of the
    # ranges still open: at a gap's middle the stack's top is the innermost
    stack, j = [], 0
    for g in gaps:
        mid = 0.5 * (g[1] + g[2])
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        g[0] = stack[-1][2] if stack else "python"
    return dict(window_us=(w0, w1), device_ops=dev,
                busy_us=sum(e - s for s, e in busy), gaps=gaps)


def breakdown(red: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, in seconds, at most `top` entries each."""
    ops, idle = defaultdict(float), defaultdict(float)
    for name, s, e in red["device_ops"]:
        ops[name] += (e - s) * 1e-6
    for label, s, e in red["gaps"]:
        idle[label] += (e - s) * 1e-6
    def head(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": head(ops), "idle_gaps": head(idle)}


def kernel_us(red: dict, patterns) -> float:
    """Device time (us) of the activities whose name holds any of `patterns`."""
    return sum(e - s for name, s, e in red["device_ops"] if any(p in name for p in patterns))
