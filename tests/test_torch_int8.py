"""The port's int8 precision policy (``onnx/ops.py`` ``_policy_dot``,
``onnx/executor.py`` ``calibrate_int8``, ``onnx/fusion.py``
``maybe_run_int8_fused``) against ``infera_tpu``'s, on the CPU: the cases of
tests/test_quantization.py, and the port's int8 ``predict`` against
``infera_tpu``'s on the same model and rows."""

import numpy as np
import pytest
import torch

import infera_tpu as it
import infera_tpu_torch as itt
from infera_tpu.onnx.executor import compile_model_bytes as ref_compile
from infera_tpu.registry import MODELS as REF_MODELS
from infera_tpu.sql import Connection as RefConnection
from infera_tpu_torch.errors import OnnxError, SqlError
from infera_tpu_torch.onnx import builder, proto
from infera_tpu_torch.onnx.executor import compile_model_bytes
from infera_tpu_torch.onnx.fusion import maybe_run_int8_fused
from infera_tpu_torch.registry import MODELS as PORT_MODELS
from infera_tpu_torch.sql import Connection


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


def _save(model, tmp_path, fname):
    p = tmp_path / fname
    proto.save_model_file(model, p)
    return str(p)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("precision,rtol", [("bf16", 0.05), ("int8", 0.08)])
def test_quantized_mlp_close_to_f32(tmp_path, registries, precision, rtol):
    model = builder.mlp_model(in_dim=16, hidden=(64, 64), out_dim=8, softmax=False, seed=2)
    p = _save(model, tmp_path, "mlp.onnx")
    itt.load_model("mlp_f32", p)
    itt.load_model("mlp_q", p, precision=precision)
    x = np.random.default_rng(0).standard_normal((256, 16)).astype(np.float32)
    ref = itt.predict("mlp_f32", x).data
    got = itt.predict("mlp_q", x).data
    # relative to the output magnitude, not elementwise (outputs near 0)
    assert np.abs(got - ref).mean() < rtol * np.abs(ref).mean()
    assert itt.get_model_info("mlp_q").endswith(f'"precision":"{precision}"}}')


def _gemm_transb_model(w):
    from infera_tpu_torch.onnx.proto import (
        Attribute, DataType, Graph, Model, Node, Tensor, ValueInfo,
    )

    g = Graph(
        name="g",
        nodes=[Node(op_type="Gemm", inputs=["X", "W"], outputs=["Y"],
                    attributes={"transB": Attribute.make("transB", 1)})],
        initializers={"W": Tensor.from_array("W", w)},
        inputs=[ValueInfo(name="X", elem_type=DataType.FLOAT, shape=[-1, w.shape[1]])],
        outputs=[ValueInfo(name="Y", elem_type=DataType.FLOAT, shape=[-1, w.shape[0]])],
    )
    return Model(graph=g)


def test_int8_gemm_transb():
    """Per-channel scales follow the effective (post-transpose) weight
    orientation, and the result equals infera_tpu's."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 8)).astype(np.float32)  # [out, in] (transB)
    data = _gemm_transb_model(w).serialize()
    x = rng.standard_normal((32, 8)).astype(np.float32)
    ref = _np(compile_model_bytes(data, "t_f32").run(x)[0])
    for fused in (True, False):  # the one-layer chain, then the per-layer path
        port = compile_model_bytes(data, "t_q", precision="int8")
        jax_model = ref_compile(data, "t_q", precision="int8")
        if not fused:
            port.mlp_plan = jax_model.mlp_plan = None
        got = _np(port.run(x)[0])
        assert bool(port._int8_fused_cache) == fused
        assert np.abs(got - ref).mean() < 0.05 * np.abs(ref).mean()
        np.testing.assert_allclose(got, np.asarray(jax_model.run(x)[0]), rtol=1e-5, atol=1e-5)


def test_int8_dynamic_path_matches_infera_tpu():
    """Before calibration the per-row dynamic path runs; the calibrating
    pass of the first run is skipped by marking the model calibrated."""
    rng = np.random.default_rng(4)
    data = _gemm_transb_model(rng.standard_normal((8, 16)).astype(np.float32)).serialize()
    x = rng.standard_normal((40, 16)).astype(np.float32)
    port = compile_model_bytes(data, "d_q", precision="int8")
    ref = ref_compile(data, "d_q", precision="int8")
    port._int8_calibrated = ref._int8_calibrated = True
    got, want = _np(port.run(x)[0]), np.asarray(ref.run(x)[0])
    assert not any(getattr(n, "_infera_act_scale", None) for n in port.nodes)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_invalid_precision_rejected(tmp_path, registries):
    p = _save(builder.linear_model(), tmp_path, "linear.onnx")
    with pytest.raises(OnnxError, match="unsupported precision 'fp4'"):
        itt.load_model("bad", p, precision="fp4")


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_sql_three_arg_load(tmp_path, registries, precision):
    p = _save(builder.mlp_model(in_dim=4, hidden=(8,), out_dim=2, softmax=False, seed=1),
              tmp_path, "m.onnx")
    port, ref = Connection(), RefConnection()
    for conn in (port, ref):
        rows = conn.execute(f"select infera_load_model('mq', '{p}', '{precision}')").rows
        assert rows == [(True,)]
    out = port.execute("select infera_get_model_info('mq')").rows[0][0]
    assert f'"precision":"{precision}"' in out
    # an int8 model runs on the host executor through CompiledOnnxModel.run;
    # 4,096 rows, so infera_tpu's power-of-two bucket adds no padding rows
    # to the calibration sample
    q = ("select sum(infera_predict_multi_list('mq', a, b, c, d)[1]) from "
         "(select x * 0.01 as a, (x % 7) * 0.1 as b, (x % 13) * -0.05 as c, "
         "(x % 5) * 0.2 as d from range(4096) r(x))")
    got, want = port.execute(q).rows, ref.execute(q).rows
    assert port._exec_path == "host"
    assert got[0][0] == pytest.approx(want[0][0], rel=1e-5)
    # the 2-arg parity form still enforces its exact arity message
    with pytest.raises(SqlError, match="expects exactly 2 arguments"):
        port.execute("select infera_load_model('x')")


def test_sql_invalid_precision_message(tmp_path, registries):
    p = _save(builder.linear_model(), tmp_path, "linear.onnx")
    with pytest.raises(SqlError, match="Failed to load model 'lq'.*unsupported precision"):
        Connection().execute(f"select infera_load_model('lq', '{p}', 'q4')")


def test_int8_static_calibration():
    """The first run calibrates static per-tensor activation scales; the
    second uses them and stays close to f32."""
    m = builder.mlp_model(in_dim=16, hidden=(64, 64), out_dim=8)
    c8 = compile_model_bytes(m.serialize(), "m8", precision="int8")
    cf = compile_model_bytes(m.serialize(), "mf", precision="f32")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 16)).astype(np.float32)

    out1 = _np(c8.run(x)[0])   # calibrates, then runs static
    assert c8._int8_calibrated
    assert all(getattr(nd, "_infera_act_scale", None) for nd in c8.mlp_plan[2])
    out2 = _np(c8.run(x)[0])   # static path, cached scales
    ref = _np(cf.run(x)[0])
    np.testing.assert_allclose(out1, ref, rtol=0.15, atol=0.15)
    np.testing.assert_allclose(out2, ref, rtol=0.15, atol=0.15)
    x2 = rng.standard_normal((256, 16)).astype(np.float32)
    np.testing.assert_allclose(_np(c8.run(x2)[0]), _np(cf.run(x2)[0]), rtol=0.2, atol=0.2)


def test_int8_explicit_calibrate_api():
    m = builder.mlp_model(in_dim=8, hidden=(32,), out_dim=4)
    c8 = compile_model_bytes(m.serialize(), "m8b", precision="int8")
    sample = np.random.default_rng(1).standard_normal((128, 8)).astype(np.float32)
    c8.calibrate_int8([sample])
    assert c8._int8_calibrated
    out = _np(c8.run(sample)[0])
    assert np.isfinite(out).all()


def test_calibration_reads_at_most_4096_rows():
    m = builder.mlp_model(in_dim=8, hidden=(16,), out_dim=4, softmax=False)
    x = np.random.default_rng(2).standard_normal((6000, 8)).astype(np.float32)
    x[4096:] *= 100.0  # rows past the sample would raise every scale
    a = compile_model_bytes(m.serialize(), "ca", precision="int8")
    b = compile_model_bytes(m.serialize(), "cb", precision="int8")
    a.calibrate_int8([x])
    b.calibrate_int8([x[:4096]])
    assert [n._infera_act_scale for n in a.mlp_plan[2]] == \
        [n._infera_act_scale for n in b.mlp_plan[2]]


def test_calibrating_scales_are_infera_tpus():
    """The scales are Python floats computed as infera_tpu computes them:
    max(prev, amax / 127) with amax the f32 max."""
    data = builder.mlp_model(in_dim=32, hidden=(64, 64), out_dim=16).serialize()
    x = np.random.default_rng(5).standard_normal((1000, 32)).astype(np.float32)
    port = compile_model_bytes(data, "s_p", precision="int8")
    ref = ref_compile(data, "s_r", precision="int8")
    port.calibrate_int8([x])
    ref.calibrate_int8([x])
    got = [n._infera_act_scale for n in port.mlp_plan[2]]
    want = [n._infera_act_scale for n in ref.mlp_plan[2]]
    assert got == want and all(isinstance(s, float) for s in got)


def test_int8_fused_chain_static_scales():
    """The fused int8 chain (hidden activations stay int8) engages after
    calibration and stays close to the per-layer static path, which
    requantizes the same activations with the same scales by other
    roundings (in infera_tpu the two are equal on this data)."""
    data = builder.mlp_model(in_dim=64, hidden=(64, 64), out_dim=8).serialize()
    x = np.random.default_rng(0).standard_normal((512, 64)).astype(np.float32)
    f32 = _np(compile_model_bytes(data, "q_f").run(x)[0])
    m8 = compile_model_bytes(data, "q_8", precision="int8")
    m8.calibrate_int8([x[:256]])
    assert all(getattr(nd, "_infera_act_scale", None) for nd in m8.mlp_plan[2])
    out8 = _np(m8.run(x)[0])
    assert m8._int8_fused_cache  # the fused path ran
    assert np.abs(out8 - f32).max() / np.abs(f32).max() < 0.05
    m8b = compile_model_bytes(data, "q_8b", precision="int8")
    m8b.calibrate_int8([x[:256]])
    m8b.mlp_plan = None  # force the per-layer static path
    ref8 = _np(m8b.run(x)[0])
    assert not m8b._int8_fused_cache
    np.testing.assert_allclose(out8, ref8, rtol=1e-5, atol=1e-5)


def test_int8_fused_cache_keys_on_scales():
    """The chain's constants fold the calibrated scales in, so the cache key
    holds them: changed scales miss the cache."""
    data = builder.mlp_model(in_dim=32, hidden=(32,), out_dim=4).serialize()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 32)).astype(np.float32))
    m8 = compile_model_bytes(data, "q_key", precision="int8")
    m8.calibrate_int8([x])
    out_a = maybe_run_int8_fused(m8, x)
    assert len(m8._int8_fused_cache) == 1
    assert torch.equal(maybe_run_int8_fused(m8, x), out_a)
    assert len(m8._int8_fused_cache) == 1
    for nd in m8.mlp_plan[2]:
        nd._infera_act_scale = nd._infera_act_scale * 2.0
    out_b = maybe_run_int8_fused(m8, x)
    assert len(m8._int8_fused_cache) == 2  # new scales -> new cache entry
    assert not torch.equal(out_a, out_b)


def test_fused_chain_returns_none_only_where_declared():
    data = builder.mlp_model(in_dim=8, hidden=(16,), out_dim=4).serialize()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((32, 8)).astype(np.float32))
    m8 = compile_model_bytes(data, "q_none", precision="int8")
    assert maybe_run_int8_fused(m8, x) is None          # uncalibrated
    m8.calibrate_int8([x])
    assert maybe_run_int8_fused(m8, x[:, :4]) is None   # wrong input width
    assert maybe_run_int8_fused(m8, x[0]) is None       # not 2-D
    assert maybe_run_int8_fused(m8, x) is not None
    m8.mlp_plan = None
    assert maybe_run_int8_fused(m8, x) is None          # no plan


# rows of test_int8_predict_matches_infera_tpu whose requantized hidden
# values move between the two packages (one of cfg2's 4,096; the others none)
MOVED_ROWS = {"cfg2": 1, "raw": 0, "small": 0}


def _hidden_q(nodes, params, scales, x, once):
    """The chain's requantized hidden activations in numpy, with the
    epilogue y * comb + bq rounded twice (the port) or once (an FMA)."""
    from infera_tpu_torch.onnx.ops import _quantize_weight_int8

    q = np.clip(np.rint(x * np.float32(1.0 / scales[0])), -127, 127).astype(np.float64)
    out = []
    for i, (nd, (w, b)) in enumerate(zip(nodes[:-1], params[:-1])):
        wq, ws, _ = _quantize_weight_int8(nd, w)
        comb = ws * np.float32(scales[i] / scales[i + 1])
        bq = b / np.float32(scales[i + 1])
        y = q @ wq.astype(np.float64)
        if once:
            t = (y * comb.astype(np.float64) + bq.astype(np.float64)).astype(np.float32)
        else:
            t = y.astype(np.float32) * comb + bq
        q = np.clip(np.rint(np.maximum(t, 0)), 0, 127).astype(np.float64)
        out.append(q)
    return out


def _rows_moved(model, ref_model, x):
    """Rows of ``x`` whose requantized hidden activations differ between the
    port's chain and infera_tpu's. Two things can move one: XLA on the CPU
    contracts the epilogue into an FMA where the port rounds twice, and the
    hidden activation scales come from f32 matmuls summed in another order
    (XLA's against torch's), so they may differ in their last bit. Either
    moves a value only where t lies within an ulp or so of a half-integer."""
    params, _, nodes = model.mlp_plan
    mine = _hidden_q(nodes, params, [n._infera_act_scale for n in nodes], x, once=False)
    theirs = _hidden_q(nodes, params, [n._infera_act_scale for n in ref_model.mlp_plan[2]], x,
                       once=True)
    moved = np.zeros(x.shape[0], bool)
    for a, b in zip(mine, theirs):
        moved |= (a != b).any(axis=1)
    return moved


@pytest.mark.parametrize("name,kw,rows", [
    ("cfg2", dict(in_dim=32, hidden=(128, 128), out_dim=16, softmax=True), 4096),
    ("raw", dict(in_dim=16, hidden=(64, 64), out_dim=8, softmax=False), 512),
    ("small", dict(in_dim=8, hidden=(16,), out_dim=4, softmax=True), 8192),
])
def test_int8_predict_matches_infera_tpu(tmp_path, registries, name, kw, rows):
    """Engine predict of an int8 model in both packages, on the same model
    file and rows (a power of two, so infera_tpu's bucket pads nothing and
    both calibrate on the same first 4,096 rows). The input scale is equal
    and the hidden ones agree to an ulp; the outputs agree to 1e-5 in every
    row where no requantized value moved (see ``_rows_moved``), and the
    rows that moved are counted and bounded."""
    p = _save(builder.mlp_model(seed=7, **kw), tmp_path, f"{name}.onnx")
    it.load_model(name, p, "int8")
    itt.load_model(name, p, "int8")
    x = np.random.default_rng(8).standard_normal((rows, kw["in_dim"])).astype(np.float32)
    want = np.asarray(it.predict(name, x).data).reshape(rows, -1)
    got = itt.predict(name, x).data.reshape(rows, -1)
    model = PORT_MODELS.get(name)
    assert model._int8_fused_cache
    ref_model = REF_MODELS.get(name)
    scales = [n._infera_act_scale for n in model.mlp_plan[2]]
    ref_scales = [n._infera_act_scale for n in ref_model.mlp_plan[2]]
    assert scales[0] == ref_scales[0]
    np.testing.assert_allclose(scales, ref_scales, rtol=1e-6)
    moved = _rows_moved(model, ref_model, x)
    close = np.isclose(got, want, rtol=1e-5, atol=1e-5).all(axis=1)
    assert not (~close & ~moved).any()
    assert moved.sum() == MOVED_ROWS[name]
    # a second call reuses the scales and the chain
    np.testing.assert_array_equal(itt.predict(name, x).data.reshape(rows, -1), got)
    assert len(model._int8_fused_cache) == 1
