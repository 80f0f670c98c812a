"""The benchmark's own tests: run from the checkout's root with
``python -m pytest perfbench/tests -q`` (the card tests, marked ``cuda``,
skip without a card)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture()
def cpu_program(monkeypatch, tmp_path):
    """The program on the CPU through its kernel tier's plain versions, the
    path the cells take on the card, its cache in ``tmp_path``."""
    monkeypatch.setenv("INFERA_PLATFORM", "cpu")
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    monkeypatch.setenv("INFERA_CACHE_DIR", str(tmp_path / "infera_cache"))
    return tmp_path
