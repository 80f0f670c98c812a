"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole), and the reference nothing of the program."""

import ast
import subprocess
import sys

import pytest

from perfbench import harness

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "infera_tpu"}
SOURCES = sorted(p for p in (ROOT / "perfbench").rglob("*.py") if "tests" not in p.parts)
# the yardstick: everything but what drives the program (the harness, its CLI, the control)
YARDSTICK = [p for p in SOURCES if p.name not in ("harness.py", "run.py", "control.py")]


def _imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: str(p.relative_to(ROOT)))
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "infera_tpu_torch" not in _imports(path)


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
    return set(out.stdout.split())


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import perfbench.reference, perfbench.work, perfbench.profiler_trace\n"
                     "import perfbench.models.mlp, perfbench.models.tree_ensemble")
    assert "infera_tpu_torch" not in loaded and not loaded & FORBIDDEN


def test_the_harness_with_the_program_loads_no_jax():
    loaded = _loaded("import perfbench.harness, infera_tpu_torch.sql, infera_tpu_torch.onnx")
    assert "infera_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_the_run_refuses_a_forbidden_module(monkeypatch):
    assert harness.forbidden_modules() == sorted({m.split(".")[0] for m in sys.modules}
                                                 & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "infera_tpu_torchx", object())
    assert "infera_tpu_torchx" not in harness.forbidden_modules()
