"""Tree-ensemble queries through the port's kernel tier, on the CPU.

With ``INFERA_PALLAS_SQL=1`` on the CPU, ``device_plan`` runs K2's plain
version with the forest slots of K4 (``ops/fused_sql.forest_plain``): the
planner, the forest tables, the regressor and classifier tails and the
result assembly are the ones the card runs. The queries of
``tests/test_pallas_sql.py``'s tree cases, and more, must give the port's
host rows and ``infera_tpu``'s ``device_plan_pallas`` rows (its Pallas kernel
in interpret mode, as its own tests run it): rel 1e-5, labels 1e-6. Forests
that ``infera_tpu``'s kernel declines leave the port's kernel tier too."""

import threading

import numpy as np
import pytest

import infera_tpu as it
import infera_tpu_torch as itt
from infera_tpu.columnar import Column as RefColumn
from infera_tpu.columnar import Table as RefTable
from infera_tpu.columnar import types as RT
from infera_tpu.sql import Connection as RefConnection
from infera_tpu_torch.columnar import Column, Table
from infera_tpu_torch.columnar import types as T
from infera_tpu_torch.onnx import builder, proto
from infera_tpu_torch.onnx.proto import Attribute
from infera_tpu_torch.ops import fused_sql as fs
from infera_tpu_torch.registry import MODELS as PORT_MODELS
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_plan as dp

N = dp.MIN_DEVICE_ROWS * 2
BIG = (f"create table big as select x % 64 as g, x % 5 as h, "
       f"(x % 100)::float / 10.0 as f1, ((x + 3) % 50)::float / 5.0 as f2, "
       f"((x * 7) % 30)::float / 3.0 as f3, ((x * 11) % 90)::float / 9.0 "
       f"as f4 from range({N}) r(x)")


def _with(model, **attrs):
    node = model.graph.nodes[0]
    for k, v in attrs.items():
        node.attributes[k] = Attribute.make(k, v)
    return model


def _multi_target():
    """The builder's forest with its leaves spread over 3 targets."""
    m = builder.gbt_regressor_model(n_features=4, n_trees=9, depth=4, seed=5)
    n = len(m.graph.nodes[0].attr("target_ids"))
    m = _with(m, target_ids=[k % 3 for k in range(n)], n_targets=3,
              base_values=[0.5, -0.25, 0.125])
    m.graph.outputs[0].shape = [-1, 3]
    return m


def _gt_forest():
    m = builder.gbt_regressor_model(n_features=4, n_trees=6, depth=3, seed=13)
    modes = m.graph.nodes[0].attr("nodes_modes")
    return _with(m, nodes_modes=["BRANCH_GT" if x != "LEAF" else x for x in modes])


MODELS = {
    "gbt": lambda: builder.gbt_regressor_model(n_features=4, n_trees=12, depth=4, seed=7),
    "gbtw": lambda: builder.gbt_regressor_model(n_features=4, n_trees=6, depth=3, seed=11),
    "gbc": lambda: builder.gbt_classifier_model(n_features=4, n_trees=8, depth=3, n_classes=3,
                                                labels=[7, 19, 42], seed=3),
    "gbavg": lambda: _with(builder.gbt_regressor_model(n_features=4, n_trees=10, depth=4,
                                                       seed=17), aggregate_function="AVERAGE"),
    "gblog": lambda: _with(builder.gbt_regressor_model(n_features=4, n_trees=10, depth=4,
                                                       seed=19), post_transform="LOGISTIC"),
    "gbm": _multi_target,
    # declined by both kernel tiers
    "gbgt": _gt_forest,
    "gbdeep": lambda: builder.gbt_regressor_model(n_features=4, n_trees=2, depth=8, seed=23),
    "gbcz": lambda: _with(builder.gbt_classifier_model(n_features=4, n_trees=6, depth=3,
                                                       n_classes=3, labels=[1, 2, 3], seed=29),
                          post_transform="SOFTMAX_ZERO"),
}


@pytest.fixture()
def both(clean_registry, monkeypatch, tmp_path):
    """The big table of tests/test_pallas_sql.py in both packages, the kernel
    tier forced on and the models loaded into both registries from the same
    bytes."""
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    itt.set_device("cpu")
    PORT_MODELS.clear()
    port, ref = Connection(), RefConnection()
    for conn in (port, ref):
        conn.execute(BIG)
    for name, make in MODELS.items():
        path = tmp_path / f"{name}.onnx"
        proto.save_model_file(make(), path)
        it.load_model(name, str(path))
        itt.load_model(name, str(path))
    yield port, ref
    PORT_MODELS.clear()
    itt.set_device(None)


def _host_rows(port, q, monkeypatch):
    monkeypatch.setenv("INFERA_PALLAS_SQL", "0")
    rows = port.execute(q).rows
    assert port._exec_path == "host"
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
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


def _p(model):
    return f"infera_predict('{model}', f1, f2, f3, f4)"


KERNEL_QUERIES = {
    # tests/test_pallas_sql.py:98-156
    "forest": (f"select g, count(*) c, avg({_p('gbt')}) p, max({_p('gbt')}) mx from big "
               "where f1 > 1.0 group by g order by g", 1e-5),
    "where_on_prediction": (f"select count(*), sum(f1) from big where {_p('gbtw')} > 0.0", 1e-5),
    "classifier": (f"select g, count(*) c, avg({_p('gbc')}) al, min({_p('gbc')}) ml from big "
                   "group by g order by g", 1e-6),
    # beyond them: AVERAGE with a base value, LOGISTIC, a multi-target column
    "average": (f"select h, avg({_p('gbavg')}), min({_p('gbavg')}) from big group by h "
                "order by h", 1e-5),
    "logistic": (f"select g, avg({_p('gblog')}), max({_p('gblog')}) from big where f2 < 7.0 "
                 "group by g order by g", 1e-5),
    "multi_list": ("select g, avg(infera_predict_multi_list('gbm', f1, f2, f3, f4)[2]), "
                   "sum(infera_predict_multi_list('gbm', f1, f2, f3, f4)[3]) from big "
                   "group by g order by g", 1e-5),
    "regressor_and_classifier": (f"select g, count(*), avg({_p('gbt')} + {_p('gbc')}) from big "
                                f"where {_p('gbc')} > 10 group by g order by g", 1e-5),
}


@pytest.mark.parametrize("name", list(KERNEL_QUERIES))
def test_tree_queries_match_host_and_reference(both, monkeypatch, name):
    port, ref = both
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
    if name == "classifier":
        assert all(r[3] in (7.0, 19.0, 42.0) for r in rows)


@pytest.mark.parametrize("model", ["gbgt", "gbdeep", "gbcz"])
def test_declined_forests_leave_the_kernel_tier(both, monkeypatch, model):
    """A BRANCH_GT forest, a depth-8 tree (over 128 leaves) and a
    SOFTMAX_ZERO classifier: infera_tpu's kernel declines them (its XLA
    tier answers) and so does the port's (its host executor answers, until
    the port has that tier), with the same rows."""
    port, ref = both
    q = f"select g, count(*), avg({_p(model)}), max({_p(model)}) from big group by g order by g"
    rows = port.execute(q).rows
    assert port._exec_path == "host"
    ref_rows = ref.execute(q).rows
    assert ref._exec_path == "device_plan"
    _assert_rows_close(rows, ref_rows, 1e-5)


def test_plan_carries_one_forest_slot_per_distinct_call(both):
    """Two aggregates over the same prediction walk its forest once; a
    multi-list element keeps its column."""
    port, _ = both
    from infera_tpu_torch.sql.parser import parse_one

    q = (f"select avg({_p('gbt')}), max({_p('gbt')}), "
         "avg(infera_predict_multi_list('gbm', f1, f2, f3, f4)[3]) from big")
    low = dp._ProgramLowerer(port.catalog.get("big"))
    progs = [low.lower(item.expr.args[0]) for item in parse_one(q).items]
    assert progs == [[(fs.PRED, 0)], [(fs.PRED, 0)], [(fs.PRED, 1)]]
    assert [type(s) for s in low.preds] == [fs.ForestSlot, fs.ForestSlot]
    assert low.preds[1].out_col == 2 and low.preds[1].bias == np.float32(0.125)
    # no MLP tiles; K4's feature tile of the 4 features, then each forest's
    # records (a regressor's leaf weights lie in them) in shared memory
    plan = low.fused_plan(None, [], [], [], [], [], 1, dp.get_table_block(
        port.catalog.get("big"), "cpu")[1])
    lay = fs.smem_layout(plan, 0, 0)
    assert lay["act0"] == lay["pred"]
    gbt, gbm = plan.forests
    assert gbt.smem_bytes() == (12 * 31 * 8, 0) and gbm.smem_bytes() == (9 * 31 * 8, 0)
    rec0 = lay["ftile"] + 4 * 4 * fs.SLOT_ROWS
    rec1 = rec0 + fs._align16(12 * 31 * 8)
    assert lay["forests"] == [(rec0, -1), (rec1, -1)]
    assert lay["total"] == rec1 + fs._align16(9 * 31 * 8)


def _nonfinite_tables(n, seed=31):
    """f1..f4 with NaN, +inf and -inf scattered over the rows, as port and
    infera_tpu tables."""
    rng = np.random.default_rng(seed)
    cols = {f"f{k}": rng.uniform(-1, 10, n) for k in range(1, 5)}
    cols["f1"][::101] = np.nan
    cols["f2"][5::211] = np.inf
    cols["f3"][9::307] = -np.inf
    cols["f4"][::401] = np.nan
    g = np.arange(n, dtype=np.int64) % 16
    port = Table({**{k: Column(v, T.DOUBLE) for k, v in cols.items()}, "g": Column(g, T.BIGINT)})
    ref = RefTable({**{k: RefColumn(v, RT.DOUBLE) for k, v in cols.items()},
                    "g": RefColumn(g, RT.BIGINT)})
    return port, ref


@pytest.mark.parametrize("model", ["gbt", "gbc"])
def test_rows_with_non_finite_features(both, monkeypatch, model):
    """NaN and +-inf features: the port's K4 gives the host's rows (the GEMM
    forest's one-hot product spreads NaN to the nodes of the row's other
    features), and so does infera_tpu's kernel."""
    port, ref = both
    port_t, ref_t = _nonfinite_tables(N)
    port.register_table("nf", port_t)
    ref.register_table("nf", ref_t)
    q = f"select g, count(*), avg({_p(model)}), min({_p(model)}) from nf group by g order by g"
    rows = port.execute(q).rows
    assert port._exec_path == "device_plan_cuda"
    _assert_rows_close(rows, _host_rows(port, q, monkeypatch), 1e-5)
    ref_rows = ref.execute(q).rows
    assert ref._exec_path == "device_plan_pallas"
    _assert_rows_close(rows, ref_rows, 1e-5)


@pytest.mark.parametrize("rows,kernel", [(2000, False), (N, True)])
def test_concurrent_sql_queries_across_models(model_dir, clean_registry, monkeypatch, tmp_path,
                                              rows, kernel):
    """tests/test_concurrency.py's config-4 registry envelope on the port:
    eight threads query a linear model and a GBT through their own
    connections, with no errors and one answer per model; at the larger
    size the GBT answers come from the kernel tier."""
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1" if kernel else "0")
    itt.set_device("cpu")
    PORT_MODELS.clear()
    try:
        proto.save_model_file(builder.gbt_regressor_model(n_features=3, n_trees=4, depth=3,
                                                          seed=1), tmp_path / "gbt.onnx")
        itt.load_model("linear", f"{model_dir}/linear.onnx")
        itt.load_model("gbt", str(tmp_path / "gbt.onnx"))
        errors: list = []
        results: dict = {"linear": set(), "gbt": set()}
        paths: set = set()
        lock = threading.Lock()

        def worker(model, idx):
            try:
                conn = Connection()
                conn.execute(f"create table t as select (x % 10)::float as a, "
                             f"((x + 1) % 10)::float as b, "
                             f"((x + 2) % 10)::float as c from range({rows}) r(x)")
                # round() over an aggregate stays on the host executor
                agg = f"sum(infera_predict('{model}', a, b, c))"
                q = f"select {agg} from t" if kernel else f"select round({agg}, 3) from t"
                for _ in range(5):
                    out = conn.execute(q).rows
                    with lock:
                        results[model].add(out[0][0])
                        paths.add((model, conn._exec_path))
            except Exception as e:  # pragma: no cover
                errors.append((model, idx, repr(e)))

        threads = [threading.Thread(target=worker, args=("linear" if i % 2 == 0 else "gbt", i))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert len(results["linear"]) == 1
        assert len(results["gbt"]) == 1
        assert ("gbt", "device_plan_cuda" if kernel else "host") in paths
    finally:
        PORT_MODELS.clear()
        itt.set_device(None)
