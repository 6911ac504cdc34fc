"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic
mix. The configuration's file is the one its `configs` entry gives; the
traffic mix is traffic/<name>.json; the limits that decide `correct` are
checks/<cell>.json; a per-layer metric's reader is metrics/<name>.py, or
metrics/<base>.py for a metric <base>.<suffix> split by the end-to-end
metric it moves. Adding a configuration, a mix, a cell or a metric is a
new file and a new entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent  # the checkout's root
# what generator.make_inputs reads of a mix: a closed loop with one caller
MIX_KEYS = {"pool_pairs", "euler_deg_max", "discs", "waves", "request"}
HERE = Path(__file__).resolve().parent


class Spec:
    """BENCHMARK.json under `root`, with the benchmark's folder `bench_dir`."""

    def __init__(self, root: Path = ROOT, bench_dir: Path | None = None):
        self.root = Path(root)
        self.dir = Path(bench_dir) if bench_dir is not None else self.root / HERE.name
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        mix = json.loads((self.dir / "traffic" / f"{name}.json").read_text())
        unknown = set(mix) - MIX_KEYS
        if unknown:
            raise ValueError(f"traffic mix {name!r}: the generator reads no {sorted(unknown)}")
        return mix

    def checks(self, cell: str) -> dict:
        return json.loads((self.dir / "checks" / f"{cell}.json").read_text())

    def _for_cell(self, metrics, cell):
        return [m for m in metrics if cell in m.get("workloads", [cell])]

    def end_to_end(self, cell: str) -> list:
        return self._for_cell(self.doc["end_to_end"], cell)

    def per_layer(self, cell: str) -> list:
        return self._for_cell(self.doc["per_layer"], cell)

    def reader(self, metric: str):
        """The `read(ctx)` function of a per-layer metric's reader."""
        for stem in (metric, metric.split(".")[0]):
            path = self.dir / "metrics" / f"{stem}.py"
            if path.exists():
                name = "_bench_metric_" + stem.replace(".", "_")
                spec = importlib.util.spec_from_file_location(name, path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                return mod.read
        raise KeyError(f"no reader for per-layer metric {metric!r} under {self.dir / 'metrics'}")
