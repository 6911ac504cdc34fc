"""Port parity: utils/viz, utils/io, utils/logging and utils/profiling
against the JAX package, on numpy inputs made from a seed: the port is
handed tensors, the JAX package arrays."""

import json
import logging as pylogging
import os

import numpy as np
import pytest
import torch
from PIL import Image

from spherical_bundle_adjuster_tpu.utils import io as jio, logging as jlog, viz as jviz
from spherical_bundle_adjuster_tpu_torch.utils import io as tio, logging as tlog, profiling
from spherical_bundle_adjuster_tpu_torch.utils import viz as tviz

torch.set_num_threads(1)

H, W, M = 64, 128, 40


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    xy = lambda: np.stack([rng.uniform(-4, W + 4, M), rng.uniform(-4, H + 4, M)], -1)
    depths = rng.normal(2.0, 2.0, (M, 2)).astype(np.float32)  # some negative
    return dict(
        left=rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
        right=rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
        gray=rng.integers(0, 256, (H, W), dtype=np.uint8),
        left_xy=xy().astype(np.float32), right_xy=xy().astype(np.float32),
        valid=rng.random(M) < 0.7, depths=depths,
        diffs=rng.uniform(0, 4, M).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


DRAWS = {
    "draw_match": lambda m, x, v: m.draw_match(x["left"], x["right"], x["left_xy"],
                                               x["right_xy"], v),
    "draw_depth_circles": lambda m, x, v: m.draw_depth_circles(x["left"], x["depths"],
                                                               x["left_xy"], v),
    "draw_depth_circles_gray": lambda m, x, v: m.draw_depth_circles(
        x["gray"], x["depths"][:, 0], x["left_xy"], v, radius=6),
    "draw_eval_overlay": lambda m, x, v: m.draw_eval_overlay(x["right"], x["left_xy"],
                                                             x["right_xy"], x["diffs"], 2.0, v),
}


@pytest.mark.parametrize("valid", ["mask", "none", "all_invalid"])
@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draw_functions_match_the_reference(name, valid):
    """Each draw_* function gives the JAX package's image bit for bit."""
    x = _inputs(seed=len(name))
    v = {"mask": x["valid"], "none": None, "all_invalid": np.zeros(M, bool)}[valid]
    want = DRAWS[name](jviz, x, v)
    got = DRAWS[name](tviz, {k: _t(a) for k, a in x.items()}, None if v is None else _t(v))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if valid != "all_invalid":  # something was drawn
        assert not np.array_equal(got, DRAWS[name](tviz, x, np.zeros(M, bool)))


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_load_and_save_image_match_the_reference(tmp_path, ext):
    """save_image of a tensor writes the JAX package's bytes for the same
    array; load_image reads what the JAX package reads (RGB, gray, JPEG)."""
    x = _inputs(seed=3)
    tio.save_image(_t(x["left"]), str(tmp_path / "port" / f"a.{ext}"))
    jio.save_image(x["left"], str(tmp_path / "jax" / f"a.{ext}"))
    assert ((tmp_path / "port" / f"a.{ext}").read_bytes()
            == (tmp_path / "jax" / f"a.{ext}").read_bytes())
    Image.fromarray(x["gray"]).save(tmp_path / f"gray.{ext}")
    for name in (f"port/a.{ext}", f"gray.{ext}"):
        got, want = tio.load_image(str(tmp_path / name)), jio.load_image(str(tmp_path / name))
        assert got.dtype == np.uint8 and got.shape == (H, W, 3)
        np.testing.assert_array_equal(got, want)
    if ext == "png":
        np.testing.assert_array_equal(tio.load_image(str(tmp_path / "port/a.png")), x["left"])


def test_run_logger_files_match_the_reference(tmp_path):
    """pose_csv, depth_csv and metric write the JAX package's bytes (less
    the metric's ts), the port from float32 tensors, the JAX package from
    float32 arrays, both twice (appending)."""
    x = _inputs(seed=5)
    rng = np.random.default_rng(5)
    rot = rng.normal(0, 3, 3).astype(np.float32)
    tran = rng.normal(0, 1, 3).astype(np.float32)
    for mod, conv, out in ((jlog, np.asarray, "jax"), (tlog, _t, "port")):
        rl = mod.RunLogger(str(tmp_path / out))
        for k in range(2):
            rl.pose_csv((2.0, -3.0, 5.5), conv(rot + k), conv(tran), int(x["valid"].sum()))
            rl.depth_csv(conv(x["depths"]), conv(x["valid"]))
            rl.depth_csv(conv(x["depths"][:3]))
            rl.metric(event="two_view_ba", matches=int(x["valid"].sum()),
                      rotation_deg=rot.tolist(), stages=[{"stage": "d", "round": k}])
    for name in ("log.txt", "log_d.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    rows = [[json.loads(line) for line in (tmp_path / out / "metrics.jsonl").read_text().splitlines()]
            for out in ("port", "jax")]
    for a, b in zip(*rows):
        assert isinstance(a.pop("ts"), float) and isinstance(b.pop("ts"), float)
        assert a == b
    first = (tmp_path / "port" / "log.txt").read_text().splitlines()[0].split(",")
    assert len(first) == 10 and first[3] == str(float(rot[0]))  # float32's digits


def test_timed_and_logger(caplog):
    """timed() yields a dict that receives the seconds, hands them to the
    sink and logs them as the JAX package does; the logger is the port's
    own (sba_tpu_torch)."""
    seen = []
    assert tlog.logger.name == "sba_tpu_torch" and tlog.logger.name != jlog.logger.name
    tlog.logger.propagate, keep = True, tlog.logger.propagate
    try:
        with caplog.at_level(pylogging.INFO, logger="sba_tpu_torch"):
            with tlog.timed("stage_x", sink=lambda label, s: seen.append((label, s))) as rec:
                sum(range(1000))
    finally:
        tlog.logger.propagate = keep
    assert rec["seconds"] > 0 and seen == [("stage_x", rec["seconds"])]
    assert any(r.getMessage().startswith("stage_x execution time : ") for r in caplog.records)


def test_logger_level_reads_the_environment():
    """SBA_TPU_LOGLEVEL sets the level, as in the JAX package."""
    import subprocess
    import sys

    code = ("from spherical_bundle_adjuster_tpu_torch.utils.logging import logger; "
            "print(logger.level)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                         env=dict(os.environ, SBA_TPU_LOGLEVEL="WARNING", PYTHONPATH=root),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == pylogging.WARNING


def test_trace_writes_a_chrome_trace(tmp_path):
    """profiling.trace on the CPU exports one Chrome trace into log_dir,
    holding the body's operators."""
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as d:
        torch.mm(a, a)
    assert d == str(tmp_path / "tr")
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((tmp_path / "tr" / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_device_time_on_the_cpu():
    """device_time times CPU work with perf_counter: positive, and a body
    that does ~8x the work takes longer."""
    a = torch.randn(128, 128)
    b = torch.randn(256, 256)
    small = profiling.device_time(lambda: torch.mm(a, a), reps=8, n=3)
    large = profiling.device_time(lambda: torch.mm(b, b), reps=8, n=3)
    assert 0 < small < large


@pytest.mark.parametrize("module", ["cli", "utils/checkpoint", "utils/io", "utils/logging",
                                    "utils/native", "utils/profiling", "utils/viz"])
def test_every_public_name_has_a_counterpart(module):
    """Every top-level function, class and constant of the JAX package's
    module has a counterpart of the same name in the port's module."""
    import ast
    import importlib
    from pathlib import Path

    src = Path(__file__).resolve().parent.parent / "spherical_bundle_adjuster_tpu" / f"{module}.py"
    names = set()
    for node in ast.parse(src.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    public = {n for n in names if not n.startswith("_")}
    assert public
    port = importlib.import_module("spherical_bundle_adjuster_tpu_torch." + module.replace("/", "."))
    assert sorted(n for n in public if not hasattr(port, n)) == []
