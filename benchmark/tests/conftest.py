"""Shared fixtures of the benchmark's CPU tests: a checkout root in a
temporary directory holding BENCHMARK.json and the benchmark's data
files, plus a tiny cell added as new files alone."""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import spec

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"


def tiny_root(tmp: Path, per_call: int, mix: str, checks_of: str, pool: int = 4) -> spec.Spec:
    """A root whose BENCHMARK.json adds the cell `tiny.cell`: 128x256 pairs
    (256 keypoints a band image, `per_call` pairs a call) under the mix `mix` with 4 pool pairs, held to
    the limits of the cell `checks_of`. Only new files and new entries."""
    root = tmp / "root"
    (root / "benchmark").mkdir(parents=True)
    for d in ("traffic", "metrics", "checks", "configs"):
        shutil.copytree(BENCH / d, root / "benchmark" / d)
    big = json.loads((BENCH / "configs" / "erp_pair_2k.json").read_text())
    pipe = big["pipeline"]
    pipe["surf"].update(max_keypoints=256, n_octaves=2)
    pipe["match"].update(max_matches=256)
    cfg = dict(big, image={"height": 128, "width": 256}, pairs_per_call=per_call, pipeline=pipe)
    (root / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    mixd = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    mixd["pool_pairs"] = pool
    (root / "benchmark/traffic/tiny.json").write_text(json.dumps(mixd))
    shutil.copy(BENCH / "checks" / f"{checks_of}.json", root / "benchmark/checks/tiny.cell.json")
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "tiny.cell", "config": "tiny", "traffic": "tiny",
                             "chips": 1, "why": "test"})
    e2e = "pair_ms" if per_call == 1 else "pairs_per_s"
    for m in doc["end_to_end"]:
        if m["name"] == e2e:
            m["workloads"].append("tiny.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return spec.Spec(root)


def run_args(seconds=1.0, seed=2**31 + 11):
    return argparse.Namespace(workload="tiny.cell", seed=seed, seconds=seconds, trace=0)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)
    yield
