"""The roofline readers' byte and operation counts at the 2K pair's
shapes give PERF.md's numbers (section 6): K1 16.9 MB in and 111.4 MB
out, K2 251.7 MB out, K3 0.54 GFLOP a pair and 8.6 GFLOP at the 64-pair
batch of 1024 x 1024 banks."""

from __future__ import annotations

import json

import pytest

from benchmark import peaks, spec

from .conftest import REPO

BANDS_2K = 8  # one 2K pair: 2 images x 4 parity bands, each 256 x 2048


def _module(name):
    return spec.Spec(REPO).reader(name).__globals__


def test_k1_k2_counts_at_the_2k_pair():
    surf = _module("surf_roofline_pct.pair")
    in_bytes = 4 * BANDS_2K * 257 * 2049
    k1_bytes, k1_ops = surf["k1_counts"](BANDS_2K, 256, 2048, 4, 3)
    k2_bytes, k2_ops = surf["k2_counts"](BANDS_2K, 256, 2048, 4, 3)
    assert round(in_bytes / 1e6, 1) == 16.9
    assert round((k1_bytes - in_bytes) / 1e6, 1) == 111.4
    assert round((k2_bytes - in_bytes) / 1e6, 1) == 251.7
    assert k2_ops == 51 * BANDS_2K * 12 * 256 * 2048
    assert 0 < k1_ops < 51 * (k1_bytes - in_bytes) / 4  # border outputs need no work
    # PERF.md's bounds: K1 0.0383 ms, K2 0.0802 ms (bytes)
    assert peaks.bound_s(k1_bytes, k1_ops) * 1e3 == pytest.approx(0.0383, abs=5e-5)
    assert peaks.bound_s(k2_bytes, k2_ops) * 1e3 == pytest.approx(0.0802, abs=5e-5)


def test_k3_counts_at_the_pair_and_the_batch():
    match = _module("match_roofline_pct.pair")
    assert round(match["k3_counts"](2048, 2048, 64)[1] / 1e9, 2) == 0.54
    assert round(64 * match["k3_counts"](1024, 1024, 64)[1] / 1e9, 1) == 8.6
    cfg = json.loads((REPO / "benchmark/configs/erp_pair_2k.json").read_text())["pipeline"]
    assert match["bound_s"](cfg, 1) * 1e3 == pytest.approx(0.0080, abs=5e-5)  # operations


def test_surf_bound_follows_the_pairs_traced():
    surf = _module("surf_roofline_pct.pair")
    cfg = json.loads((REPO / "benchmark/configs/erp_pair_2k.json").read_text())["pipeline"]
    one = surf["bound_s"](cfg, 1024, 2048, 1)
    assert one * 1e3 == pytest.approx(0.0383 + 0.0802, abs=1e-4)
    assert surf["bound_s"](cfg, 1024, 2048, 4) == pytest.approx(4 * one)
    auto = dict(cfg, frontend=dict(cfg["frontend"], band_ladder="auto"))
    assert surf["bound_s"](auto, 1024, 2048, 1) is None  # the data picks the ladder


def test_roofline_readers_read_nothing_without_their_kernels():
    ctx = {"trace": {"device_ops": [("other_kernel", 0.0, 5.0)], "window_us": (0, 10),
                     "busy_us": 5.0},
           "pipeline": json.loads((REPO / "benchmark/configs/erp_pair_2k.json").read_text())[
               "pipeline"], "height": 1024, "width": 2048, "traced_pairs": 1}
    bench = spec.Spec(REPO)
    assert bench.reader("surf_roofline_pct.pair")(ctx) is None
    assert bench.reader("match_roofline_pct.pair")(ctx) is None
    ctx["trace"]["device_ops"] = [("void top2_kernel(float const*)", 0.0, 16.0)]
    assert bench.reader("match_roofline_pct.pair")(ctx) == pytest.approx(
        100 * 8.0129e-6 / 16e-6, rel=1e-3)
