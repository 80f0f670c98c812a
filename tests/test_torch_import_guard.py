"""The port imports torch and numpy, never JAX and never ``infera_tpu``."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "infera_tpu_torch"
IMPORT_LINE = re.compile(r"^\s*(import|from)\s+(jax|infera_tpu)(\.|\s|$)")

_PROBE = """
import sys
import {module}
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'infera_tpu'))
print(bad)
sys.exit(1 if bad else 0)
"""


@pytest.mark.parametrize("module", [
    "infera_tpu_torch",
    "infera_tpu_torch.bench",
    "infera_tpu_torch.ops.fused_query",
    "infera_tpu_torch.ops.fused_sql",
    "infera_tpu_torch.onnx.ml_ops",
    "infera_tpu_torch.sql",
    "infera_tpu_torch.sql.device_plan",
    "infera_tpu_torch.sql.device_join_plan",
    "infera_tpu_torch.sql.shell",
    "infera_tpu_torch.sql.csv_io",
    "infera_tpu_torch.columnar.diskfile",
    "infera_tpu_torch.columnar.pandas_io",
    "infera_tpu_torch.ops.window",
    "infera_tpu_torch.ops.join",
    "infera_tpu_torch.ops.device_join",
    "infera_tpu_torch.ops.device_groupby",
    "infera_tpu_torch.onnx.fusion",
    "infera_tpu_torch.observability",
    "infera_tpu_torch.testing.sqllogic",
    "infera_tpu_torch.testing.profile_query",
    "infera_tpu_torch.testing.benchmarks",
    "infera_tpu_torch.testing.ab_kernels",
    "chip_smoke",
])
def test_fresh_import_pulls_in_no_jax(module):
    env = dict(os.environ)
    env.pop("INFERA_PLATFORM", None)  # importing must work with no device chosen
    res = subprocess.run([sys.executable, "-c", _PROBE.format(module=module)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_WALK = """
import pkgutil, sys
import infera_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(infera_tpu_torch.__path__, 'infera_tpu_torch.')
               if not m.name.endswith('__main__'))
for name in names:
    __import__(name)
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'infera_tpu'))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 30 else 0)
"""


def test_every_module_of_the_port_imports_without_jax():
    """All modules of the package in one process, found by walking it."""
    env = dict(os.environ)
    env.pop("INFERA_PLATFORM", None)
    res = subprocess.run([sys.executable, "-c", _WALK], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_import_line_names_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = []
    for path in files:
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            if IMPORT_LINE.match(line):
                offenders.append(f"{path.relative_to(ROOT)}:{lineno}: {line.strip()}")
    assert offenders == []


def test_chip_smoke_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run in full")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
