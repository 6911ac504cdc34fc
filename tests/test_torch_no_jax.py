"""The port imports torch and never jax nor the JAX package, directly or
indirectly; no layer of the port imports its tools; its entry points
default to the card; and the GPU smoke script refuses to run without a
card or without the repo."""

import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "spherical_bundle_adjuster_tpu_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


REFERENCE = "spherical_bundle_adjuster_tpu"


# the port's scripts at the repo root
SCRIPTS = ("chip_smoke.py", "card_rounding.py")


def _script_imports():
    """The import statements of the scripts, as source lines."""
    lines = []
    for name in SCRIPTS:
        tree = ast.parse((ROOT / name).read_text())
        lines += [ast.unparse(n) for n in tree.body
                  if isinstance(n, ast.Import)
                  or (isinstance(n, ast.ImportFrom) and n.module != "__future__")]
    return lines


def test_port_imports_no_jax():
    """Importing every module of the port and what its scripts import
    loads neither jax nor any module of the JAX package."""
    mods = sorted(
        "spherical_bundle_adjuster_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        + "".join(line + "\n" for line in _script_imports())
        + "bad = [m for m in sys.modules if m in ('jax', %r)\n"
        "       or m.startswith(('jax.', %r))]\n" % (REFERENCE, REFERENCE + ".")
        + "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# the port's layers, and the modules beside them that drive or check it
LAYERS = ("core", "ops", "solver", "models", "parallel", "utils")
TOOLS = ("kernel_times", "problems", "cli")


def test_no_layer_of_the_port_imports_a_tool():
    """Importing every module of the port's layers loads none of its tools:
    kernel_times (the kernel timer), problems (the check problems) and
    cli (the command line)."""
    mods = sorted(
        "spherical_bundle_adjuster_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for layer in LAYERS for p in (PKG / layer).rglob("*.py")
        if p.name != "__init__.py"
    )
    tools = [f"spherical_bundle_adjuster_tpu_torch.{t}" for t in TOOLS]
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"print(sorted(m for m in {tools!r} if m in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) > 30 and out.stdout.strip() == "[]", out.stdout


def test_no_file_of_the_port_mentions_a_jax_import():
    """No import statement of the port or its scripts names jax or the
    JAX package (relative imports stay inside the port)."""
    files = list(PKG.rglob("*.py")) + [ROOT / name for name in SCRIPTS]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", REFERENCE), (f, node.lineno, n)


@pytest.mark.parametrize("fn", ["render_erp", "rotation_pair", "render_trajectory"])
def test_synthetic_entry_points_default_to_the_card(fn):
    from spherical_bundle_adjuster_tpu_torch.utils import synthetic

    assert inspect.signature(getattr(synthetic, fn)).parameters["device"].default == "cuda"


def test_run_sequence_puts_frames_that_are_not_a_tensor_on_the_card(monkeypatch):
    """models/sequence.run_sequence runs on the frames' device, and frames
    that are not a tensor go to the card."""
    import numpy as np
    import torch
    from spherical_bundle_adjuster_tpu_torch.models import sequence

    devices = []

    def as_tensor(data, *args, device=None, **kw):
        devices.append(str(device))
        raise StopIteration

    monkeypatch.setattr(torch, "as_tensor", as_tensor)
    with pytest.raises(StopIteration):
        sequence.run_sequence(np.zeros((3, 16, 32, 3), np.uint8))
    assert devices == ["cuda"]


def test_chip_smoke_fails_without_a_card():
    """No CPU fallback: without CUDA the script exits non-zero and prints
    no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run in full")
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script cannot find the port: it exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_distributed_layer_and_rank_workers_import_no_jax():
    """parallel/ (mesh, dist_ba, launch) is part of the port, and it and
    tests/torch_ranks.py, which every rank of the multi-process tests
    imports when it is spawned, load neither jax nor the JAX package."""
    assert {p.stem for p in (PKG / "parallel").glob("*.py")} >= {"mesh", "dist_ba", "launch"}
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import torch_ranks\n"
        "from spherical_bundle_adjuster_tpu_torch.parallel import dist_ba, launch, mesh\n"
        "bad = [m for m in sys.modules if m in ('jax', %r)\n"
        "       or m.startswith(('jax.', %r))]\n" % (REFERENCE, REFERENCE + ".")
        + "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    for node in ast.walk(ast.parse((ROOT / "tests" / "torch_ranks.py").read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module]
            assert not any(n.split(".")[0] in ("jax", REFERENCE) for n in names), node.lineno


def test_cli_defaults_to_the_card():
    """The port's entry point runs on the card unless --device says
    otherwise (the JAX package's CLI has no such flag)."""
    from spherical_bundle_adjuster_tpu_torch import cli

    args = cli.build_parser().parse_args(["l", "r", "0", "0", "0", "0", "0", "0", "1"])
    assert args.device == "cuda"


def test_cli_checkpoint_and_native_load_no_orbax_and_build_nothing():
    """Importing cli, utils.checkpoint and utils.native (and what they
    import) loads no orbax, and importing utils.native starts no compiler
    and loads no library: it builds at first use."""
    code = (
        "import subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a process was started at import: ' + repr(a))\n"
        "subprocess.run = subprocess.Popen = refuse\n"
        "from spherical_bundle_adjuster_tpu_torch import cli\n"
        "from spherical_bundle_adjuster_tpu_torch.utils import checkpoint, native\n"
        "bad = [m for m in sys.modules if m == 'orbax' or m.startswith('orbax.')\n"
        "       or m in ('jax', %r) or m.startswith(('jax.', %r))]\n" % (REFERENCE, REFERENCE + ".")
        + "assert not bad, bad\n"
        "assert native._LIB is None and not native._TRIED\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
