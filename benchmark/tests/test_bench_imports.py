"""Nothing under benchmark/ imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's),
and the reference imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys

from benchmark import run

from .conftest import BENCH, REPO

JAX_NAMES = {"jax", "jaxlib", "flax", "spherical_bundle_adjuster_tpu"}
PORT = "spherical_bundle_adjuster_tpu_torch"


def _imports(path):
    """(top-level name, relative level) of every import in a file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(((node.module or "").split(".")[0], node.level))
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for name, level in _imports(f):
            assert level or name not in JAX_NAMES, f"{f}: imports {name}"


def test_the_reference_imports_nothing_of_the_port():
    for f in sorted((BENCH / "reference").glob("*.py")):
        for name, level in _imports(f):
            assert level <= 1, f"{f}: a relative import out of reference/"
            assert level or name in sys.stdlib_module_names | {"torch", "numpy"}, \
                f"{f}: imports {name}"


def test_loading_the_harness_and_the_program_loads_no_jax():
    code = ("import sys; import benchmark.run, benchmark.system, benchmark.control, "
            "benchmark.reference.compare; import spherical_bundle_adjuster_tpu_torch.models.twoview; "
            "from benchmark.run import loaded_forbidden; print(loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    code = ("import sys; import benchmark.reference.compare; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] == {PORT!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr


def test_the_runtime_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + "._probe", object())
    assert "spherical_bundle_adjuster_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "spherical_bundle_adjuster_tpu.utils", object())
    assert "spherical_bundle_adjuster_tpu" in run.loaded_forbidden()
