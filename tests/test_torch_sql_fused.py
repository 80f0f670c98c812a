"""The SQL form of the main path through the port's kernel tier, on the CPU.

With ``INFERA_PALLAS_SQL=1`` on the CPU, ``device_plan`` runs K2's plain
version (``ops/fused_sql.fused_sql_plain``): the planner, the program
emitter, the MLP slots (K2′), the key guards and the result assembly are
the ones the card runs. The same queries over the same data must give the
port's host rows and ``infera_tpu``'s ``device_plan_pallas`` rows (its Pallas
kernel in interpret mode, as its own tests run it), at the tolerances of
``tests/test_pallas_sql.py``. The program evaluator is held to
``infera_tpu``'s ``_Lowerer`` closures value by value."""

import numpy as np
import pytest
import torch

import infera_tpu as it
import infera_tpu_torch as itt
from infera_tpu.columnar import Column as RefColumn
from infera_tpu.columnar import Table as RefTable
from infera_tpu.columnar import types as RT
from infera_tpu.sql import Connection as RefConnection
from infera_tpu.sql.device_plan import _Lowerer as RefLowerer
from infera_tpu.sql.parser import parse_one as ref_parse_one
from infera_tpu_torch.columnar import Column, Table
from infera_tpu_torch.columnar import types as T
from infera_tpu_torch.onnx import builder, proto
from infera_tpu_torch.ops import fused_mlp as fm
from infera_tpu_torch.ops import fused_sql as fs
from infera_tpu_torch.registry import MODELS as PORT_MODELS
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_plan as dp
from infera_tpu_torch.sql.parser import parse_one

N = dp.MIN_DEVICE_ROWS * 2
BIG = (f"create table big as select x % 64 as g, x % 5 as h, "
       f"(x % 100)::float / 10.0 as f1, ((x + 3) % 50)::float / 5.0 as f2, "
       f"((x * 7) % 30)::float / 3.0 as f3, ((x * 11) % 90)::float / 9.0 "
       f"as f4 from range({N}) r(x)")


@pytest.fixture()
def both(clean_registry, monkeypatch, tmp_path):
    """The big table of tests/test_pallas_sql.py in both packages, the kernel
    tier forced on (the port on the CPU runs K2's plain version) and the
    models loaded into both registries from the same bytes."""
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    itt.set_device("cpu")
    PORT_MODELS.clear()
    port, ref = Connection(), RefConnection()
    for conn in (port, ref):
        conn.execute(BIG)
    models = {"m": (dict(in_dim=4, hidden=(32,), out_dim=1), "f32"),
              "mc": (dict(in_dim=4, hidden=(16,), out_dim=3), "f32"),
              "mb": (dict(in_dim=4, hidden=(32,), out_dim=1), "bf16")}
    for name, (kw, precision) in models.items():
        path = tmp_path / f"{name}.onnx"
        proto.save_model_file(builder.mlp_model(**kw), path)
        it.load_model(name, str(path), precision)
        itt.load_model(name, str(path), precision)
    yield port, ref, tmp_path
    PORT_MODELS.clear()
    itt.set_device(None)


def _host_rows(port, q, monkeypatch):
    """The port's host executor's rows: a second Connection over the same
    catalog with the device plan turned away (infera_tpu's own route,
    tests/test_agg_tail_device.py:20-27)."""
    host = Connection(port.catalog)
    with monkeypatch.context() as m:
        m.setattr(dp, "try_execute_on_device", lambda *a, **k: None)
        rows = host.execute(q).rows
    assert host._exec_path == "host"
    return rows


def _assert_rows_close(rows, want, rel):
    assert len(rows) == len(want)
    for a, b in zip(rows, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=rel, abs=1e-9)
            else:
                assert x == y


# (query, tolerance of tests/test_pallas_sql.py)
KERNEL_QUERIES = {
    "flagship": ("select g, count(*) c, avg(infera_predict('m', f1, f2, f3, f4)) p, "
                 "sum(f1) s from big where f2 > 1.0 group by g order by g", 1e-6),
    "minmax_multikey_having": ("select g, h, min(f1) mn, max(f2) mx, count(*) c from big "
                               "group by g, h having count(*) > 10 order by g, h", 1e-6),
    "global": ("select count(*), sum(f1 * 2.0 + f3), min(f2 - f4), max(f2) "
               "from big where f1 > 3.0 and f3 < 8.0", 1e-6),
    "multi_list": ("select g, avg(infera_predict_multi_list('mc', f1, f2, f3, f4)[2]) "
                   "from big group by g order by g", 1e-5),
    "bf16": ("select g, avg(infera_predict('mb', f1, f2, f3, f4)) p from big "
             "group by g order by g", 1e-5),
}


@pytest.mark.parametrize("name", list(KERNEL_QUERIES))
def test_kernel_tier_rows_match_host_and_reference(both, monkeypatch, name):
    port, ref, _ = both
    q, rel = KERNEL_QUERIES[name]
    launches = dict(fs.fused_sql.launches)
    rows = port.execute(q).rows
    assert port._exec_path == "device_plan_cuda"
    # on the CPU the wrapper runs the plain version, and counts no launch
    assert fs.fused_sql.launches == launches
    ref_rows = ref.execute(q).rows
    assert ref._exec_path == "device_plan_pallas"
    _assert_rows_close(rows, _host_rows(port, q, monkeypatch), rel)
    _assert_rows_close(rows, ref_rows, rel)


def test_predict_calls_share_one_mlp_slot(both):
    """Two aggregates over the same prediction run its MLP once."""
    port, _, _ = both
    q = ("select g, avg(infera_predict('m', f1, f2, f3, f4)), "
         "max(infera_predict('m', f1, f2, f3, f4)) from big group by g")
    sel = parse_one(q)
    low = dp._ProgramLowerer(port.catalog.get("big"))
    progs = [low.lower(item.expr.args[0]) for item in sel.items[1:]]
    assert progs[0] == progs[1] == [(fs.PRED, 0)]
    assert len(low.preds) == 1


@pytest.mark.parametrize("q,path", [
    # infera_tpu's XLA program: the port's torch program
    ("select g, median(f1) from big group by g order by g", "device_plan"),
    ("select g, quantile_cont(f2, 0.75) from big group by g order by g", "device_plan"),
    # f3 = k / 3.0 holds doubles f32 cannot: the device HLL would merge them
    ("select g, approx_count_distinct(f3) from big group by g order by g", "host"),
    ("select f1, count(*) from big group by f1 order by f1", "host"),   # fractional key
])
def test_outside_the_core_slots_the_host_answers(both, monkeypatch, q, path):
    """What the kernel tier declines (the tail's families run in it:
    tests/test_torch_sql_tail.py) the torch program answers, or where a
    guard trips or an argument is not f32-exact the host executor. The
    port's host rows equal infera_tpu's host rows (1e-12), and the port's
    rows equal its host's (the program's medians are the f32 table block's
    values: tests/test_device_plan.py's 1e-6)."""
    port, ref, _ = both
    rows = port.execute(q).rows
    assert port._exec_path == path
    host = _host_rows(port, q, monkeypatch)
    _assert_rows_close(rows, host, 1e-6 if path == "device_plan" else 1e-12)
    import infera_tpu.sql.device_plan as ref_dp

    monkeypatch.setattr(ref_dp, "try_execute_on_device", lambda *a, **k: None)
    _assert_rows_close(host, ref.execute(q).rows, 1e-12)


def test_key_beyond_f32_integers_goes_to_host(both):
    """|key| >= 2**24 trips the magnitude flag: the host answers."""
    port, _, _ = both
    port.execute(f"create table wide as select (x % 3) * 20000000.0 as k, "
                 f"x * 0.5 as v from range({N}) r(x)")
    rows = port.execute("select k, count(*), sum(v) from wide group by k order by k").rows
    assert port._exec_path == "host"
    assert [r[0] for r in rows] == [0.0, 20000000.0, 40000000.0]


def test_min_max_near_5e9_are_held_to_host(both, monkeypatch):
    """Reference fault R1: the TPU kernel starts MIN/MAX at +-2**30 and so
    clamps values beyond it. The port starts at +-inf: values near 5e9 come
    back as the host's, to f32 rounding of the block."""
    port, _, _ = both
    port.execute(f"create table r1 as select x % 4 as g, 5000000000.0 + x * 1000.0 as v, "
                 f"-5000000000.0 - x * 1000.0 as w from range({N}) r(x)")
    q = "select g, min(v), max(v), min(w), max(w) from r1 group by g order by g"
    rows = port.execute(q).rows
    assert port._exec_path == "device_plan_cuda"
    host = _host_rows(port, q, monkeypatch)
    _assert_rows_close(rows, host, 1e-7)
    assert rows[0][1] > 4.9e9 and rows[0][3] < -4.9e9


# --------------------------------------------------------------------------- programs


def _tables(n=4001, seed=5):
    """The same columns as a port Table and as an infera_tpu Table."""
    rng = np.random.default_rng(seed)
    cols = {
        "f": rng.uniform(-9, 9, n),
        "z": np.where(rng.random(n) < 0.1, 0.0, rng.standard_normal(n)),
        "h": rng.integers(-6, 6, n) + 0.5,
        "p": rng.uniform(0.01, 4, n),
        "i": rng.integers(-50, 50, n),
    }
    cols["f"][::13] = -cols["f"][::13]
    port = Table({k: Column(v, T.BIGINT if k == "i" else T.DOUBLE) for k, v in cols.items()})
    ref = RefTable({k: RefColumn(v, RT.BIGINT if k == "i" else RT.DOUBLE)
                    for k, v in cols.items()})
    return port, ref, n


EXPRS = [
    "f % 3.0", "f % -2.5", "(0.0 - f) % 3.0", "i % 7", "i % -4",
    "round(h)", "round(f)", "f / z", "i / 3", "f * 2.0 + z", "-f - z * z",
    "f between -0.5 and 0.5", "f not between -2 and 2",
    "cast(f as integer)", "cast(h as bigint)", "cast(i as double)",
    "abs(f)", "floor(f)", "ceil(h)",
    "not (f > 0)", "f > 0 and z < 0", "f > 0 or z < 0", "f = z", "f <> z", "f >= h",
    "f <= i", "(f > 0) + 1.0", "i * 0.25 - f / 4.0",
]
LIBRARY = ["exp(f)", "log(p)", "sqrt(p)", "exp(z) * log(p + 1.0)"]


def _both_values(expr):
    port_t, ref_t, n = _tables()
    sql = f"select {expr} from t"
    low = dp._ProgramLowerer(port_t)
    code = low.lower(parse_one(sql).items[0].expr)
    xc, row_map = dp.get_table_block(port_t, torch.device("cpu"))
    plan = low.fused_plan(None, [code], [], [], [], [1], 1, row_map)
    got = fs.eval_program(plan.keys[0], plan.consts, xc, n, []).numpy()
    import jax.numpy as jnp

    ref_low = RefLowerer(ref_t)
    fn = ref_low.lower(ref_parse_one(sql).items[0].expr)
    cols = {k: jnp.asarray(np.asarray(c.data, np.float32))
            for k, c in ref_low.used_columns.items()}
    want = np.broadcast_to(np.asarray(fn(cols)).astype(np.float32), (n,))
    return got, want


@pytest.mark.parametrize("expr", EXPRS)
def test_program_evaluator_equals_the_reference_closures(expr):
    """f32 op for op, as the kernel's interpreter: bit-equal values."""
    got, want = _both_values(expr)
    np.testing.assert_array_equal(got, want)


def _closure_values(expr):
    """The torch program's closure (``device_plan._Lowerer``) and
    infera_tpu's, over the same f32 columns."""
    import jax.numpy as jnp

    port_t, ref_t, n = _tables()
    sql = f"select {expr} from t"
    low = dp._Lowerer(port_t, torch.device("cpu"))
    fn = low.lower(parse_one(sql).items[0].expr)
    block = dp.get_table_block(port_t, torch.device("cpu"))
    cols = {k: dp.device_column_array(k, block, n) for k in low.used_columns}
    got = fn(dict(cols, __n__=n, __pred__={})).expand(n).numpy()
    ref_low = RefLowerer(ref_t)
    ref_fn = ref_low.lower(ref_parse_one(sql).items[0].expr)
    ref_cols = {k: jnp.asarray(np.asarray(c.data, np.float32))
                for k, c in ref_low.used_columns.items()}
    want = np.broadcast_to(np.asarray(ref_fn(ref_cols)).astype(np.float32), (n,))
    return got, want


@pytest.mark.parametrize("expr", EXPRS)
def test_program_closures_equal_the_reference_closures(expr):
    """The torch program's closures, f32 op for op: bit-equal values."""
    got, want = _closure_values(expr)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("expr", LIBRARY)
def test_program_closures_library_functions_within_a_few_ulp(expr):
    got, want = _closure_values(expr)
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)


@pytest.mark.parametrize("expr", LIBRARY)
def test_library_functions_within_a_few_ulp(expr):
    # torch's and XLA's exp, log and sqrt come from different libraries:
    # up to 2 ulp each (XLA's sqrt on the CPU is not correctly rounded),
    # 4 in a product of two
    got, want = _both_values(expr)
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)


def test_min_max_propagate_nan_like_the_reference():
    """jnp.minimum/maximum propagate NaN: a group holding a NaN row has NaN
    for its min and max; other groups are untouched."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n, G = 5000, 16
    v = rng.standard_normal(n).astype(np.float32)
    v[[7, 100, 2000]] = np.nan
    key = (np.arange(n) % G).astype(np.float32)
    xc = torch.as_tensor(np.stack([key, v]))
    plan = fs.FusedPlan(where=None, keys=[[(fs.COL, 0)]], sums=[], mins=[[(fs.COL, 1)]],
                        maxs=[[(fs.COL, 1)]], strides=[1], n_groups=G)
    res = fs.fused_sql_plain(fs.pack_plan(plan, "cpu"), xc, n)
    onehot = jnp.asarray(key)[None, :] == jnp.arange(G)[:, None]
    want_min = jnp.min(jnp.where(onehot, jnp.asarray(v), jnp.inf), axis=1)
    want_max = jnp.max(jnp.where(onehot, jnp.asarray(v), -jnp.inf), axis=1)
    np.testing.assert_array_equal(res["mm"][0].numpy(), np.asarray(want_min))
    np.testing.assert_array_equal(res["mm"][1].numpy(), np.asarray(want_max))
    assert np.isnan(res["mm"][0].numpy()).sum() == 3


def test_k2_mlp_plain_takes_the_reference_params():
    """K2′'s plain version on infera_tpu's own mlp_plan params (numpy),
    carried by fused_query.params_from_numpy, equals the reference model's
    graph to the 1e-5 parity bound, in f32 and bf16."""
    from infera_tpu.onnx.builder import mlp_model as ref_mlp_model
    from infera_tpu.onnx.executor import compile_model_bytes
    from infera_tpu_torch.ops.fused_query import params_from_numpy

    data = ref_mlp_model(in_dim=8, hidden=(32, 16), out_dim=5, softmax=True).serialize()
    x = np.random.default_rng(1).standard_normal((300, 8)).astype(np.float32)
    for precision, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ref = compile_model_bytes(data, "r", precision)
        params, softmax = ref.mlp_plan[0], ref.mlp_plan[1]
        w = params_from_numpy(params, "cpu", dtype)
        got = fs.mlp_plain(w, torch.as_tensor(x.T.copy()), softmax, 3).numpy()
        want = np.asarray(ref._run_graph(x)[0])[:, 3]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- budget


def _mlp_slot(dims, bf16=False):
    params = [(np.zeros((dims[i], dims[i + 1]), np.float32), np.zeros(dims[i + 1], np.float32))
              for i in range(len(dims) - 1)]
    return fs.MlpSlot(params=params, final_softmax=True, out_col=1, bf16=bf16,
                      features=[[(fs.COL, k)] for k in range(dims[0])])


def test_smem_budget_of_the_bench_plan():
    """Query B's plan: the bench MLP (90,112 B of f32 weights, 1,088 B of
    biases) at G = 64 with one key, one sum and one max slot."""
    plan = fs.FusedPlan(where=[(fs.COL, 0), (fs.CONST, 0), (fs.GT, 0)], keys=[[(fs.COL, 32)]],
                        sums=[[(fs.PRED, 0)]], mins=[], maxs=[[(fs.PRED, 0)]], strides=[1],
                        n_groups=64, consts=[0.0], preds=[_mlp_slot((32, 128, 128, 16))])
    n_words = fs._HEADER + 2 * 36 + 2 * 38 + 1 + 1 + 16
    layout = fs.smem_layout(plan, n_words, (90112 + 1088) // 4)
    assert fs.smem_bytes(plan) == layout["total"]
    expect = (-(-4 * n_words // 16) * 16 + 91200 + 2 * 4 * 128 * fm.ACT_STRIDE + 1024
              + 2 * 1024 + 1024 + 1024 + 8 * 64 + 8 * 64 + 4 * 3 * 64 + 16)
    assert layout["total"] == expect
    assert fs.smem_fits(plan)
    # two predicts of one model share one copy of the weights
    plan.preds.append(_mlp_slot((32, 128, 128, 16)))
    plan.preds[1].params = plan.preds[0].params
    assert fs.smem_fits(plan)
    # another model of the same widths does not fit beside it
    plan.preds[1] = _mlp_slot((32, 128, 128, 16))
    assert not fs.smem_fits(plan)


def test_a_plan_over_the_budget_runs_on_the_host(both, monkeypatch):
    port, _, tmp_path = both
    path = tmp_path / "wide.onnx"
    proto.save_model_file(builder.mlp_model(in_dim=4, hidden=(256, 256), out_dim=1), path)
    itt.load_model("wide", str(path))
    q = "select g, avg(infera_predict('wide', f1, f2, f3, f4)) from big group by g order by g"
    rows = port.execute(q).rows
    # K2 declines the plan: the torch program runs the model's graph
    assert port._exec_path == "device_plan"
    _assert_rows_close(rows, _host_rows(port, q, monkeypatch), 1e-5)
