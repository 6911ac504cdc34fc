"""The program's spans and LM counters in the traced window: its sba.*
ranges, which are host ranges only, leave the device's busy time, the
idle share and the kernels' rooflines as they were, and name the idle
gaps in which the host ran no operation; the LM counters' readers give
the values worked out by hand, and nothing for a program that keeps no
counters; every per-layer entry of BENCHMARK.json has a reader."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import run, spec, trace

from .conftest import REPO, run_args, tiny_root
from .test_bench_trace import EVENTS

SPANS = [  # the program's ranges on the host's timeline, inside the call
    ("sba.two_view", False, 2.0, 98.0),
    ("sba.frontend", False, 3.0, 32.0),
    ("sba.refine", False, 33.0, 97.0),
    ("sba.lm.rot", False, 55.0, 95.0),
]
PIPELINE = json.loads((REPO / "benchmark/configs/erp_pair_2k.json").read_text())["pipeline"]
KERNELS = [("tile_kernel<DetOp>", True, 12.0, 20.0), ("tile_kernel<HaarOp>", True, 21.0, 26.0),
           ("top2_kernel", True, 27.0, 29.0)]


def _ctx(events):
    return {"trace": trace.reduce_events(events), "pipeline": PIPELINE, "height": 1024,
            "width": 2048, "traced_pairs": 1}


def test_spans_leave_busy_time_idle_share_and_rooflines_as_they_were():
    bench = spec.Spec(REPO)
    before, after = _ctx(EVENTS + KERNELS), _ctx(EVENTS + KERNELS + SPANS)
    for key in ("window_us", "busy_us", "device_ops"):
        assert after["trace"][key] == before["trace"][key]
    for name in ("device_idle_pct.pair", "surf_roofline_pct.pair", "match_roofline_pct.pair"):
        value = bench.reader(name)(after)
        assert value is not None and value == bench.reader(name)(before)


def test_a_gap_where_the_host_ran_no_operation_takes_the_innermost_span():
    """EVENTS' gap at 50-80 us has aten::item at its middle; a gap with
    no operation at its middle was "python" and is now the LM stage."""
    events = [e for e in EVENTS if e[0] != "aten::item"]
    assert [g[0] for g in trace.reduce_events(events)["gaps"]] == ["aten::mul", "python"]
    red = trace.reduce_events(events + SPANS)
    assert [g[0] for g in red["gaps"]] == ["aten::mul", "sba.lm.rot"]
    assert dict(trace.breakdown(red)["idle_gaps"]) == {"aten::mul": pytest.approx(10e-6),
                                                       "sba.lm.rot": pytest.approx(30e-6)}


def _set_last_call(monkeypatch, counts):
    from collections import Counter

    from spherical_bundle_adjuster_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "LAST_CALL", Counter(counts), raising=False)


def test_lm_readers_give_the_counts_worked_out_by_hand(monkeypatch):
    """A call of two depth trips over 6 problems (6, then 0 active) and
    three rotation trips over 2 (2, 1, 0 active): 5 reads, 9 of 18
    element-iterations active."""
    bench = spec.Spec(REPO)
    _set_last_call(monkeypatch, {"lm.depth.syncs": 2, "lm.depth.active": 6, "lm.depth.slots": 12,
                                 "lm.rot.syncs": 3, "lm.rot.active": 3, "lm.rot.slots": 6,
                                 "other.count": 40})
    for suffix in ("pair", "batch"):
        assert bench.reader(f"lm_syncs.{suffix}")({}) == 5
        assert bench.reader(f"lm_active_pct.{suffix}")({}) == pytest.approx(50.0)


def test_lm_readers_give_nothing_for_a_program_without_counters(monkeypatch):
    from spherical_bundle_adjuster_tpu_torch.utils import profiling

    bench = spec.Spec(REPO)
    monkeypatch.delattr(profiling, "LAST_CALL")
    assert bench.reader("lm_syncs.pair")({}) is None
    assert bench.reader("lm_active_pct.batch")({}) is None
    _set_last_call(monkeypatch, {})
    assert bench.reader("lm_syncs.pair")({}) == 0
    assert bench.reader("lm_active_pct.pair")({}) is None


def test_every_per_layer_entry_has_a_reader():
    bench = spec.Spec(REPO)
    for m in bench.doc["per_layer"]:
        assert callable(bench.reader(m["name"])), m["name"]


@pytest.mark.cuda
def test_on_the_card_the_spans_have_no_device_copy_and_the_lm_readers_read(tmp_path, capsys):
    """A traced run of a tiny cell on the card: no device activity bears
    a span's name (a user-scope record_function's range does get a copy
    there, which the reducer would count as work), the LM counters'
    readers read the sync-counted call, and its LM reads are among its
    host syncs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: pytest benchmark/tests -m cuda)")
    from spherical_bundle_adjuster_tpu_torch.utils import profiling

    x = torch.ones(1 << 20, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span("sba.probe"):
            x.mul_(2)
        with torch.profiler.record_function("user.probe"):
            x.mul_(2)
        torch.cuda.synchronize()
    on = {(e.name(), e.device_type() == torch.autograd.DeviceType.CUDA)
          for e in prof.profiler.kineto_results.events()}
    assert ("sba.probe", False) in on and ("sba.probe", True) not in on
    assert ("user.probe", True) in on

    bench = tiny_root(tmp_path, 1, "pool32.compat", "pair_2k.compat")
    doc = json.loads((bench.root / "BENCHMARK.json").read_text())
    for m in doc["per_layer"]:
        if m["name"] in ("host_syncs.pair", "lm_syncs.pair", "lm_active_pct.pair"):
            m["workloads"].append("tiny.cell")
    (bench.root / "BENCHMARK.json").write_text(json.dumps(doc))
    bench = spec.Spec(bench.root)
    args = run_args(seconds=2.0)
    args.trace = 1
    assert run.run_cell(bench, bench.workload("tiny.cell"), args, torch.device("cuda", 0)) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not any(name.startswith("sba.") for name, _ in res["breakdown"]["device_ops"])
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert 0 < m["lm_syncs.pair"] <= m["host_syncs.pair"]
    assert 0 < m["lm_active_pct.pair"] <= 100
