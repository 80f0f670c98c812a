"""The parity sqllogictest suite (tests/sqllogic/*.test) through the port.

Every file replays through the port's own runner and Connection, on one
device (the mesh is not in the port yet), with the port's registry and cache
isolated per file. The tables of these files are small, so the statements
run on the port's host executor."""

import glob
import os

import pytest

import infera_tpu_torch as itt
from infera_tpu_torch import config as port_config
from infera_tpu_torch.onnx.builder import write_reference_test_models
from infera_tpu_torch.registry import MODELS
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.testing.sqllogic import SqlLogicRunner

SUITE_DIR = os.path.join(os.path.dirname(__file__), "sqllogic")
FILES = sorted(glob.glob(os.path.join(SUITE_DIR, "*.test")))


@pytest.fixture(scope="module")
def port_model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_sqllogic_models")
    write_reference_test_models(str(d))
    return str(d)


@pytest.fixture()
def port_env(monkeypatch, tmp_path):
    """The port on the CPU, an empty registry and a fresh cache directory."""
    monkeypatch.setenv("INFERA_CACHE_DIR", str(tmp_path / "cache"))
    port_config.reset_config_for_tests()
    itt.set_device("cpu")
    MODELS.clear()
    yield tmp_path
    MODELS.clear()
    itt.set_device(None)
    port_config.reset_config_for_tests()


def test_the_suite_has_every_file():
    assert len(FILES) == 14


@pytest.mark.parametrize("path", FILES, ids=[os.path.basename(f) for f in FILES])
def test_sqllogic_file(path, port_model_dir, port_env):
    conn = Connection()
    runner = SqlLogicRunner(conn, substitutions={"MODELS": port_model_dir,
                                                 "TMP": str(port_env)})
    result = runner.run_file(path)
    if not result.passed:
        msgs = [f"line {rec.line + 1}: {rec.sql}\n  {rec.message}" for rec in result.failures()]
        pytest.fail(f"{os.path.basename(path)}: {len(result.failures())} of "
                    f"{len(result.records)} records failed\n" + "\n".join(msgs))
    assert result.n_passed == len(result.records)
