"""BENCHMARK.json keeps the shape its checker takes, and a configuration, a
traffic mix, a cell and a per-layer metric added as new files and new
entries alone are found by name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import spec

from .conftest import REPO, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_keeps_its_shape():
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert doc["paths"] == ["benchmark"] and 1 <= doc["run_seconds"] <= 51
    configs = {c["name"] for c in doc["configs"]}
    cells = {w["name"] for w in doc["workloads"]}
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).exists()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    assert configs == {w["config"] for w in doc["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in doc["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert (REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
        assert (REPO / "benchmark" / "checks" / f"{w['name']}.json").exists()
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in doc["end_to_end"]:
        assert m["source"] in {"host_clock", "device_trace"} and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in cells:  # setup_s and one more end-to-end metric, and a per-layer one
        reported = [m["name"] for m in doc["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in doc["per_layer"])
    for m in doc["per_layer"]:
        assert m["source"] in SOURCES and UNIT.match(m["unit"]) and NAME.match(m["name"])
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    names = [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    assert len(names) == len(set(names))
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_new_files_alone_are_found_by_name(tmp_path):
    bench = tiny_root(tmp_path, 1, "pool32.compat", "pair_2k.compat")
    root = bench.root
    (root / "benchmark/metrics/matches_per_pair.py").write_text(
        "def read(ctx):\n    return ctx['counters'].get('matches')\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["per_layer"].append({"name": "matches_per_pair.pair", "unit": "count",
                             "better": "higher", "source": "program_counter",
                             "layer": "models.frontend", "moves": "pair_ms",
                             "workloads": ["tiny.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    bench = spec.Spec(root)
    cell = bench.workload("tiny.cell")
    assert bench.config(cell["config"])["image"]["height"] == 128
    assert bench.traffic(cell["traffic"])["pool_pairs"] == 4
    assert "limits" in bench.checks("tiny.cell")
    assert [m["name"] for m in bench.end_to_end("tiny.cell")] == ["setup_s", "pair_ms"]
    assert [m["name"] for m in bench.per_layer("tiny.cell")] == ["matches_per_pair.pair"]
    assert bench.reader("matches_per_pair.pair")({"counters": {"matches": 7}}) == 7
    # a split metric falls back to the reader of its base name
    assert bench.reader("host_syncs.batch")({"counters": {"host_syncs": 3}}) == 3


def test_a_mix_key_the_generator_does_not_read_is_refused(tmp_path):
    bench = tiny_root(tmp_path, 1, "pool32.compat", "pair_2k.compat")
    path = bench.dir / "traffic" / "tiny.json"
    mix = json.loads(path.read_text())
    path.write_text(json.dumps(dict(mix, callers=4)))
    with pytest.raises(ValueError, match="callers"):
        bench.traffic("tiny")


def test_configurations_state_their_departures_and_precision():
    for name in ("erp_pair_2k", "erp_batch64_512"):
        cfg = spec.Spec().config(name)
        assert cfg["tf32"] is False and cfg["pipeline"]["dtype"] == "float32"
        assert cfg["reduced"] and cfg["departures_from_source"]
        for dep in cfg["departures_from_source"]:
            assert dep.split(" ")[0].split(".")[0] in cfg["reduced"]
