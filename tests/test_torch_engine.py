"""The port's slice end to end on the CPU: both packages load the same
builder-written .onnx files, and the port's 13-function API answers as
``infera_tpu``'s does: predictions to 1e-5 (the JAX side runs XLA on the CPU),
the same JSON envelopes and byte-equal error strings."""

import json

import numpy as np
import pytest
import torch

import infera_tpu as it
import infera_tpu_torch as itt
from infera_tpu_torch import engine as port_engine
from infera_tpu_torch.onnx import builder, proto
from infera_tpu_torch.ops import fused_mlp as fm
from infera_tpu_torch.registry import MODELS as PORT_MODELS


@pytest.fixture(autouse=True)
def port_on_cpu():
    itt.set_device("cpu")
    yield
    itt.set_device(None)


@pytest.fixture()
def registries(clean_registry):
    PORT_MODELS.clear()
    yield
    PORT_MODELS.clear()


MODELS = {
    "mlp": dict(in_dim=32, hidden=(64, 64), out_dim=16, softmax=True),
    "mlp_raw": dict(in_dim=16, hidden=(32,), out_dim=8, softmax=False),
    "mlp_fixed": dict(in_dim=8, hidden=(16,), out_dim=4, softmax=True, dynamic_batch=False),
}


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_models")
    builder.write_reference_test_models(str(d))
    for name, kw in MODELS.items():
        proto.save_model_file(builder.mlp_model(seed=3, **kw), d / f"{name}.onnx")
    return d


def _load_both(model_files, name, precision="f32"):
    path = str(model_files / f"{name}.onnx")
    it.load_model(name, path, precision)
    itt.load_model(name, path, precision)


def _both(fn, *args):
    """Run fn on both APIs; return (jax result or exception, port result or exception)."""
    out = []
    for api in (it, itt):
        try:
            out.append(getattr(api, fn)(*args))
        except Exception as e:  # the parity check compares the errors themselves
            out.append(e)
    return out


def test_builder_copy_writes_the_same_bytes(tmp_path):
    from infera_tpu.onnx import builder as ref_builder
    from infera_tpu.onnx import proto as ref_proto

    for kw in MODELS.values():
        ref_proto.save_model_file(ref_builder.mlp_model(**kw), tmp_path / "ref.onnx")
        proto.save_model_file(builder.mlp_model(**kw), tmp_path / "port.onnx")
        assert (tmp_path / "ref.onnx").read_bytes() == (tmp_path / "port.onnx").read_bytes()


@pytest.mark.parametrize("name,rows", [("linear", 1), ("linear", 300), ("mlp", 1000),
                                       ("mlp_raw", 517), ("mlp_fixed", 64),
                                       ("multi_output", 1)])
def test_predict_matches(model_files, registries, name, rows):
    _load_both(model_files, name)
    cols = {"linear": 3, "multi_output": 4}.get(name) or MODELS[name]["in_dim"]
    x = np.random.default_rng(rows).standard_normal((rows, cols)).astype(np.float32)
    want, got = _both("predict", name, x)
    assert (got.rows, got.cols) == (want.rows, want.cols)
    assert got.data.dtype == np.float32
    # f32 matmuls on both sides, sums in another order: the parity bound
    np.testing.assert_allclose(got.data, want.data, rtol=1e-5, atol=1e-5)


def test_linear_anchor(model_files, registries):
    _load_both(model_files, "linear")
    got = itt.predict("linear", [[1.0, 2.0, 3.0]])
    assert (got.rows, got.cols) == (1, 1)
    assert abs(float(got.data[0]) - 1.75) < 1e-6


def test_matched_models_run_through_the_fused_wrapper(model_files, registries, monkeypatch):
    from infera_tpu_torch.onnx import fusion

    calls = []
    real = fusion.fused_mlp

    def spy(weights, x, final_softmax=False):
        calls.append((weights.dims, final_softmax))
        return real(weights, x, final_softmax)

    monkeypatch.setattr(fusion, "fused_mlp", spy)
    for name in ("linear", "mlp", "multi_output"):
        itt.load_model(name, str(model_files / f"{name}.onnx"))
    itt.predict("linear", [[1.0, 2.0, 3.0]])
    itt.predict("mlp", np.ones((5, 32), np.float32))
    itt.predict("multi_output", [[1.0, 2.0, 3.0, 4.0]])  # Identity: no MLP plan
    assert calls == [((3, 1), False), ((32, 64, 64, 16), True)]


def test_graph_path_equals_fused_path(model_files, registries, monkeypatch):
    itt.load_model("mlp", str(model_files / "mlp.onnx"))
    x = np.random.default_rng(0).standard_normal((200, 32)).astype(np.float32)
    fused = itt.predict("mlp", x).data
    monkeypatch.setenv("INFERA_PALLAS_MLP", "0")
    graph = itt.predict("mlp", x).data
    np.testing.assert_allclose(fused, graph, rtol=1e-6, atol=1e-7)


def test_model_above_the_budget_takes_the_graph_path(tmp_path, registries):
    path = tmp_path / "wide.onnx"
    proto.save_model_file(builder.mlp_model(in_dim=8, hidden=(1024,), out_dim=4), path)
    itt.load_model("wide", str(path))
    model = PORT_MODELS.get("wide")
    assert model.mlp_plan is not None and model.mlp_weights is None
    assert not fm.smem_fits((8, 1024, 4))
    it.load_model("wide", str(path))
    x = np.random.default_rng(1).standard_normal((50, 8)).astype(np.float32)
    want, got = _both("predict", "wide", x)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-5, atol=1e-5)


def test_bf16_precision_matches(model_files, registries):
    _load_both(model_files, "mlp", precision="bf16")
    x = np.random.default_rng(2).standard_normal((300, 32)).astype(np.float32)
    want, got = _both("predict", "mlp", x)
    # bf16 operands with f32 accumulation on both sides, softmax outputs
    np.testing.assert_allclose(got.data, want.data, rtol=1e-3, atol=1e-4)
    assert itt.get_model_info("mlp") == it.get_model_info("mlp")


def test_large_batch_runs_in_chunks(model_files, registries, monkeypatch):
    itt.load_model("mlp", str(model_files / "mlp.onnx"))
    x = np.random.default_rng(0).standard_normal((1000, 32)).astype(np.float32)
    whole = itt.predict("mlp", x).data
    monkeypatch.setattr(port_engine, "SPLIT_CHUNK_ROWS", 256)  # 4 chunks, ragged tail
    np.testing.assert_array_equal(itt.predict("mlp", x).data, whole)


@pytest.mark.parametrize("name,blob", [
    ("linear", np.array([1.0, 2.0, 3.0], np.float32).tobytes()),
    ("linear", np.arange(6, dtype=np.float32).tobytes()),      # fixed batch, 2 rows
    ("mlp", np.ones(64, np.float32).tobytes()),                 # dynamic batch, 2 rows
])
def test_predict_from_blob_matches(model_files, registries, name, blob):
    _load_both(model_files, name)
    want, got = _both("predict_from_blob", name, blob)
    assert (got.rows, got.cols) == (want.rows, want.cols)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("call", [
    ("predict", "nope", [[1.0]]),
    ("predict", "linear", [[1.0, 2.0]]),
    ("predict", "mlp", np.ones((2, 31), np.float32)),
    ("predict_from_blob", "nope", b"\x00" * 4),
    ("predict_from_blob", "linear", b"\x00" * 5),
    ("predict_from_blob", "linear", b"\x00" * 16),
    ("load_model", "ghost", "/nonexistent/dir/ghost.onnx"),
    ("load_model", "linear", "LINEAR_PATH", "f16"),
])
def test_error_strings_are_byte_equal(model_files, registries, call):
    _load_both(model_files, "linear")
    _load_both(model_files, "mlp")
    fn, *args = call
    args = [str(model_files / "linear.onnx") if isinstance(a, str) and a == "LINEAR_PATH"
            else a for a in args]
    want, got = _both(fn, *args)
    assert isinstance(want, it.InferaError), want
    assert isinstance(got, itt.InferaError), got
    assert type(got).__name__ == type(want).__name__
    assert str(got) == str(want)


def test_metadata_and_registry_match(model_files, registries):
    for name in ("linear", "multi_output", "mlp", "mlp_fixed"):
        _load_both(model_files, name)
    for name in ("linear", "multi_output", "mlp", "mlp_fixed", "ghost"):
        assert itt.get_model_info(name) == it.get_model_info(name)
        assert itt.is_model_loaded(name) == it.is_model_loaded(name)
    assert itt.get_loaded_models() == it.get_loaded_models()
    assert itt.unload_model("mlp") is it.unload_model("mlp") is True
    assert itt.unload_model("mlp") is it.unload_model("mlp") is False
    assert itt.get_loaded_models() == it.get_loaded_models()
    itt.unload_all_models()
    assert itt.get_loaded_models() == "[]"


def test_autoload_dir_matches(model_files, registries, tmp_path):
    assert itt.set_autoload_dir(str(model_files)) == it.set_autoload_dir(str(model_files))
    assert itt.get_loaded_models() == it.get_loaded_models()
    missing = str(tmp_path / "missing")
    assert itt.set_autoload_dir(missing) == it.set_autoload_dir(missing)


def test_version_names_the_torch_backend():
    want, got = json.loads(it.get_version()), json.loads(itt.get_version())
    assert got.keys() == want.keys()
    assert got["version"] == want["version"]
    assert got["onnx_backend"] == "torch-cuda"


def test_int8_precision_loads_and_predicts(model_files, registries):
    """int8 loads; predict calibrates on its first call, runs the fused int8
    chain, and answers as infera_tpu does (512 rows: no bucket padding)."""
    _load_both(model_files, "mlp", "int8")
    assert itt.get_model_info("mlp") == it.get_model_info("mlp")
    assert itt.get_model_info("mlp").endswith('"precision":"int8"}')
    x = np.random.default_rng(9).standard_normal((512, 32)).astype(np.float32)
    got, want = itt.predict("mlp", x), it.predict("mlp", x)
    assert (got.rows, got.cols) == (want.rows, want.cols) == (512, 16)
    assert PORT_MODELS.get("mlp")._int8_fused_cache
    np.testing.assert_allclose(got.data, np.asarray(want.data), rtol=1e-5, atol=1e-5)


def test_weights_move_to_the_device_at_load(model_files, registries):
    itt.load_model("mlp", str(model_files / "mlp.onnx"))
    model = PORT_MODELS.get("mlp")
    assert model.device == torch.device("cpu")
    assert all(t.device == model.device for t in model._initializers.values())
    assert model.mlp_weights.blob.device == model.device


def test_device_choice(monkeypatch):
    itt.set_device(None)
    monkeypatch.setenv("INFERA_PLATFORM", "cpu")
    assert itt.get_device() == torch.device("cpu")
    monkeypatch.delenv("INFERA_PLATFORM")
    if torch.cuda.is_available():
        assert itt.get_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="INFERA_PLATFORM=cpu"):
            itt.get_device()
    itt.set_device("cpu")
    assert itt.get_device() == torch.device("cpu")
