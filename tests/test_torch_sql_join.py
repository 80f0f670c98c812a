"""Fact→dimension joins through the port's join tier (K5), on the CPU.

With ``INFERA_PALLAS_SQL=1`` on the CPU, ``device_join_plan`` runs K5's plain
version (``ops/fused_sql.fused_sql_plain`` with the join prologue): the
orientation, the declines, the dense lookup, the outer-join validity
lattice, the matched-count slot, the result assembly and the FULL join's
phantom side are the ones the card runs. Every query here gives, on the
port, the rows of its host executor (a second Connection with both device
tiers turned away, whose joins of 2**14 rows and more take the sort-join of
``ops/device_join``) and of ``infera_tpu`` (its Pallas kernel in interpret
mode, as its own tests run it): keys and counts exact, sums and averages
rel 1e-5. The port's path is ``infera_tpu``'s, mapped:
``device_join_plan_pallas`` → ``device_join_plan_cuda``,
``device_join_plan`` (its XLA join program) → ``device_join_plan`` (the
torch join program), but where ``infera_tpu`` lowers a ``coalesce`` of a
join to its XLA program the port lowers it to ``SEL`` in the kernel; the
host elsewhere."""

import numpy as np
import pytest

import infera_tpu as it
import infera_tpu_torch as itt
from infera_tpu.columnar import Column as RefColumn
from infera_tpu.columnar import Table as RefTable
from infera_tpu.columnar import types as RT
from infera_tpu.registry import MODELS as REF_MODELS
from infera_tpu.sql import Connection as RefConnection
from infera_tpu_torch.columnar import Column, Table
from infera_tpu_torch.columnar import types as T
from infera_tpu_torch.onnx import builder, proto
from infera_tpu_torch.ops import fused_sql as fs
from infera_tpu_torch.registry import MODELS as PORT_MODELS
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_join_plan as djp
from infera_tpu_torch.sql import device_plan as dp

N = dp.MIN_DEVICE_ROWS * 2
CUDA_PATH = "device_join_plan_cuda"

TABLES = [
    # tests/test_pallas_sql.py:376-470
    f"create table jfact as select x % 100 as k, x % 7 as jg, (x % 40)::float / 4.0 as v "
    f"from range({N}) r(x)",
    "create table jdim as select x as k, (x * 2)::float as w, x % 3 as cat from range(100) r(x)",
    f"create table ofact as select x % 150 as k, x % 6 as og, (x % 40)::float as v "
    f"from range({N}) r(x)",
    "create table odim as select x as k, (x * 2)::float as w from range(100) r(x)",
    f"create table ffact as select x % 80 as k, (x % 30)::float as v from range({N}) r(x)",
    "create table fdim as select x as k, (x * 3)::float as w from range(120) r(x)",
    # tests/test_device_plan.py:219-340, 514-720
    "create table dim as select x as k, (x * 2)::float as w, x % 3 as cat from range(100) r(x)",
    f"create table fact as select x % 100 as k, x % 7 as g, (x % 40)::float / 4.0 as f1, "
    f"((x + 5) % 30)::float / 3.0 as f2, ((x * 3) % 20)::float / 2.0 as f3 "
    f"from range({N}) r(x)",
    "create table dim2 as select x * 2 as k, (x)::float as w from range(50) r(x)",
    f"create table fact2 as select x % 100 as k, (x % 10)::float as f from range({N}) r(x)",
    "create table dup as select x % 10 as k, x as v from range(20) r(x)",
    f"create table factd as select x % 10 as k from range({N}) r(x)",
    "create table dimk as select x as k, (x)::float as w from range(10) r(x)",
    f"create table factk as select case when x % 2 = 0 then {(1 << 32) + 5} else 5 end as k "
    f"from range({N}) r(x)",
    "create table ldim as select x as k, (x * 2)::float as w from range(100) r(x)",
    f"create table lfact as select x % 150 as k, x % 7 as g, (x % 40)::float / 4.0 as v "
    f"from range({N}) r(x)",
    "create table rdim as select x as k, (x * 3)::float as w from range(80) r(x)",
    f"create table rfact as select x % 120 as k, (x % 10)::float as v from range({N}) r(x)",
    "create table gdim as select x as k, (x * 2)::float as w from range(200) r(x)",
    f"create table gfact as select x % 120 as k, x % 3 as g, (x % 10)::float as v "
    f"from range({N}) r(x)",
    # tests/test_sql_fuzz.py:471-535
    f"create table jf as select x % 120 as k, x % 6 as g, (x % 41)::float / 4.0 as v "
    f"from range({N}) r(x)",
    "create table jd as select x as k, (x * 3)::float as w, x % 4 as cat from range(100) r(x)",
]


def _register_f(conn, table_cls, col_cls, types):
    """Query F's tables (config 3) at N rows: src(id permuted, x0..x7) and
    meta(id, w, cat = id % 16), made from seeds with numpy."""
    ids = np.random.default_rng(0).permutation(N).astype(np.int64)
    x = np.random.default_rng(0).standard_normal((N, 8), dtype=np.float32)
    src = {"id": col_cls(ids, types.BIGINT)}
    for i in range(8):
        src[f"x{i}"] = col_cls(np.ascontiguousarray(x[:, i]), types.FLOAT)
    mid = np.arange(N, dtype=np.int64)
    w = np.random.default_rng(1).standard_normal(N, dtype=np.float32)
    conn.register_table("src", table_cls(src))
    conn.register_table("meta", table_cls({"id": col_cls(mid, types.BIGINT),
                                           "w": col_cls(w, types.FLOAT),
                                           "cat": col_cls(mid % 16, types.BIGINT)}))
    return ids, x, w


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Every table above in both packages and the models loaded into both
    registries from the same bytes."""
    itt.set_device("cpu")
    PORT_MODELS.clear()
    REF_MODELS.clear()
    port, ref = Connection(), RefConnection()
    for conn in (port, ref):
        for stmt in TABLES:
            conn.execute(stmt)
    _register_f(port, Table, Column, T)
    _register_f(ref, RefTable, RefColumn, RT)
    d = tmp_path_factory.mktemp("join_models")
    models = {"m": builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1),
              "linear": builder.linear_model(),
              "m3": builder.mlp_model(in_dim=8, hidden=(), out_dim=4, softmax=False, seed=0)}
    for name, model in models.items():
        path = d / f"{name}.onnx"
        proto.save_model_file(model, path)
        it.load_model(name, str(path))
        itt.load_model(name, str(path))
    yield port, ref
    PORT_MODELS.clear()
    REF_MODELS.clear()
    itt.set_device(None)


def _host_run(port, q, monkeypatch):
    """(rows, path) of the port's host executor over the same catalog: both
    device tiers turned away, as ``tests/test_path_equivalence.py`` and
    ``chip_smoke.host_rows`` reach the host."""
    host = Connection(port.catalog)
    with monkeypatch.context() as m:
        m.setattr(dp, "try_execute_on_device", lambda *a, **k: None)
        m.setattr(djp, "try_execute_join_on_device", lambda *a, **k: None)
        rows = host.execute(q).rows
    assert host._exec_path in ("host", "device_join")
    return rows, host._exec_path


def _run(both, q, monkeypatch):
    """(kernel-tier rows, path) and (host rows, path) of the port, and
    infera_tpu's (rows, path), the kernel tiers forced on."""
    port, ref = both
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    got = (port.execute(q).rows, port._exec_path)
    want = (ref.execute(q).rows, ref._exec_path)
    return got, _host_run(port, q, monkeypatch), want


def _port_path(rpath, q):
    """The port's path for ``infera_tpu``'s path ``rpath`` on query ``q``."""
    if rpath == "device_join_plan_pallas" or (rpath == "device_join_plan" and "coalesce" in q):
        return CUDA_PATH
    return rpath


def _assert_rows_close(rows, want, rel=1e-5):
    assert len(rows) == len(want)
    for a, b in zip(rows, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=rel, abs=1e-9)
            else:
                assert x == y


def _check(both, q, monkeypatch, on_kernel=True):
    """The port's rows equal its host rows and infera_tpu's; its path is
    infera_tpu's mapped (``_port_path``), and is asserted to be the kernel
    tier (``on_kernel``) or the host's."""
    (rows, path), (hrows, hpath), (rrows, rpath) = _run(both, q, monkeypatch)
    assert path == _port_path(rpath, q), (path, rpath)
    assert (path == CUDA_PATH) == on_kernel, (path, rpath)
    if not on_kernel:
        assert path == hpath
    _assert_rows_close(rows, hrows)
    _assert_rows_close(rows, rrows)
    return rows


CASES = {
    # tests/test_pallas_sql.py:376-470
    "inner_grouped": "select cat, count(*) c, sum(w) sw, max(v) mx from jfact "
                     "join jdim on jfact.k = jdim.k group by cat order by cat",
    "inner_where": "select count(*), sum(v * w), min(w) from jfact "
                   "join jdim on jfact.k = jdim.k where v > 2.0",
    "inner_predict": "select jg, avg(infera_predict('m', v, w, v, w)) from jfact "
                     "join jdim on jfact.k = jdim.k group by jg order by jg",
    "left_counts": "select count(*), count(w) from ofact left join odim on ofact.k = odim.k",
    "left_sums": "select og, count(*) c, sum(w) sw, avg(w) aw, sum(v) sv from "
                 "ofact left join odim on ofact.k = odim.k group by og order by og",
    "left_minmax": "select og, min(w), max(w), max(v) from ofact left join odim "
                   "on ofact.k = odim.k group by og order by og",
    "right": "select og, count(*), sum(w) from odim right join ofact "
             "on odim.k = ofact.k group by og order by og",
    "left_where": "select og, count(*), sum(w), min(w) from ofact left join odim "
                  "on ofact.k = odim.k where v > 3.0 group by og order by og",
    "full_global": "select count(*) c, sum(v) sv, count(w) cw from ffact full join "
                   "fdim on ffact.k = fdim.k",
    "full_grouped": "select ffact.k fk, count(*) c, sum(w) sw from ffact full join "
                    "fdim on ffact.k = fdim.k group by ffact.k order by fk",
    # tests/test_device_plan.py:219-340, 514-720
    "partial_match_where": "select count(*), sum(w), max(f) from fact2 join dim2 "
                           "on fact2.k = dim2.k where f < 5.0",
    "left_all_aggs": "select g, count(*) c, count(w) cw, sum(v) sv, sum(w) sw, avg(w) aw, "
                     "min(w) mnw, max(w) mxw, sum(coalesce(w, -1.0)) sc from lfact left join "
                     "ldim on lfact.k = ldim.k group by g order by g",
    "right_fact_on_right": "select count(*) c, count(w) cw from rdim right join rfact "
                           "on rdim.k = rfact.k",
    "full_all_aggs": "select count(*) c, count(w) cw, count(v) cv, sum(v) sv, sum(w) sw, "
                     "min(w) mnw, max(w) mxw from gfact full join gdim on gfact.k = gdim.k",
    "full_group_by": "select g, count(*) c, count(w) cw, sum(w) sw, min(w) mnw "
                     "from gfact full join gdim on gfact.k = gdim.k group by g order by g",
    "full_where_fact": "select count(*) c, count(w) cw from gfact full join gdim "
                       "on gfact.k = gdim.k where v < 5",
    "full_where_coalesce": "select count(*) c from gfact full join gdim "
                           "on gfact.k = gdim.k where coalesce(v, 99.0) >= 5",
}

HOST_CASES = {
    # a WHERE over a dim column under an outer join: three-valued logic
    "outer_where_dim": "select count(*) from rfact left join rdim on rfact.k = rdim.k "
                       "where w > 10",
    # duplicate dim keys need row expansion
    "duplicate_dim_keys": "select count(*) from factd join dup on factd.k = dup.k",
    # int64 fact keys beyond int32 would alias in the kernel's lookup
    "fact_keys_beyond_int32": "select count(*) from factk join dimk on factk.k = dimk.k",
    # a dim-side group key is NULL on unmatched rows
    "full_group_by_dim_key": "select fdim.k dk, count(*) c, sum(w) sw from ffact full join "
                             "fdim on ffact.k = fdim.k group by fdim.k order by dk",
    # FULL with avg: finalized averages do not combine with phantom rows
    "full_avg": "select avg(w) from ffact full join fdim on ffact.k = fdim.k",
}


@pytest.mark.parametrize("name", list(CASES))
def test_join_tier_rows_match_host_and_reference(both, monkeypatch, name):
    launches = dict(fs.fused_sql.launches)
    _check(both, CASES[name], monkeypatch)
    # on the CPU the wrapper runs the plain version, and counts no launch
    assert fs.fused_sql.launches == launches


@pytest.mark.parametrize("name", list(HOST_CASES))
def test_declined_joins_answer_on_the_host_in_both(both, monkeypatch, name):
    _check(both, HOST_CASES[name], monkeypatch, on_kernel=False)


def test_inner_join_with_predict_against_numpy(both, monkeypatch):
    """tests/test_device_plan.py:219-250: config 3's shape, by hand."""
    q = ("select cat, count(*) c, sum(w) sw, avg(infera_predict('linear', f1, f2, f3)) p "
         "from fact join dim on fact.k = dim.k group by cat order by cat")
    rows = _check(both, q, monkeypatch)
    x = np.arange(N)
    k = x % 100
    f1 = (x % 40).astype(np.float32) / np.float32(4.0)
    f2 = ((x + 5) % 30).astype(np.float32) / np.float32(3.0)
    f3 = ((x * 3) % 20).astype(np.float32) / np.float32(2.0)
    pred = (2 * f1 - f2 + 0.5 * f3 + np.float32(0.25)).astype(np.float64)
    w = (k * 2).astype(np.float64)
    cat = k % 3
    assert len(rows) == 3
    for kc, c, sw, p in rows:
        m = cat == kc
        assert c == int(m.sum())
        assert sw == pytest.approx(float(w[m].sum()), rel=1e-6)
        assert p == pytest.approx(float(pred[m].mean()), rel=1e-5)


def test_outer_counts_against_numpy(both, monkeypatch):
    rows = _check(both, CASES["left_counts"], monkeypatch)
    x = np.arange(N)
    assert rows[0] == (N, int((x % 150 < 100).sum()))
    rows = _check(both, CASES["full_all_aggs"], monkeypatch)
    assert rows[0][:3] == (N + 80, N + 80, N)
    assert rows[0][5:] == (0.0, 398.0)


def test_full_join_phantom_group_is_appended(both, monkeypatch):
    """The NULL-key group of the FULL join holds the 80 phantom dim rows."""
    rows = _check(both, CASES["full_group_by"], monkeypatch)
    assert len(rows) == 4
    null_row = [r for r in rows if r[0] is None][0]
    assert null_row[1:3] == (80, 80)
    assert null_row[3] == pytest.approx(sum(i * 2.0 for i in range(120, 200)))
    assert null_row[4] == 240.0


def test_differential_join_fuzz(both, monkeypatch):
    """tests/test_sql_fuzz.py:471-535 with its seed and 20 trials: random
    fact→dim INNER and LEFT join aggregates."""
    rng = np.random.default_rng(7)
    agg_pool = ["count(*)", "sum(v)", "sum(w)", "sum(v * w)", "avg(w)", "min(v)", "max(w)"]
    left_aggs = ["count(*)", "count(w)", "sum(v)", "sum(w)", "avg(w)", "min(w)", "max(w)"]
    wheres = ["", " where v > 2.0", " where v + 1.0 < 9.0"]
    for trial in range(20):
        outer = trial >= 12
        pool = left_aggs if outer else agg_pool
        k = int(rng.integers(1, 4))
        aggs = list(rng.choice(pool, size=k, replace=False))
        grouped = bool(rng.integers(0, 2))
        gkey = "g" if outer else "cat"
        sel = ", ".join(([gkey] if grouped else []) + aggs)
        kind = "left join" if outer else "join"
        q = (f"select {sel} from jf {kind} jd on jf.k = jd.k{rng.choice(wheres)}"
             + (f" group by {gkey} order by {gkey}" if grouped else ""))
        _check(both, q, monkeypatch)


def _nan_dim_tables(conn, table_cls, col_cls, types):
    """A dim whose row 0 holds NaN (key 0, which no fact row has) and fact
    keys 1..149: the unmatched rows (100..149) read dim row 0 in the kernel."""
    w = np.arange(100, dtype=np.float64) * 2.0
    w[0] = np.nan
    conn.register_table("ndim", table_cls({"k": col_cls(np.arange(100, dtype=np.int64),
                                                        types.BIGINT),
                                           "w": col_cls(w, types.DOUBLE)}))
    x = np.arange(N, dtype=np.int64)
    conn.register_table("nfact", table_cls({"k": col_cls(x % 149 + 1, types.BIGINT),
                                            "g": col_cls(x % 5, types.BIGINT),
                                            "v": col_cls((x % 40) / 4.0, types.DOUBLE)}))


def test_nan_in_dim_row_zero_never_reaches_an_unmatched_row(both, monkeypatch):
    """SEL is a true select: an unmatched row's dim row 0 holds NaN, and its
    group's sums, extremes and coalesce still equal the host's."""
    port, ref = both
    _nan_dim_tables(port, Table, Column, T)
    _nan_dim_tables(ref, RefTable, RefColumn, RT)
    q = ("select g, count(*), count(w), sum(w), avg(w), min(w), max(w), "
         "sum(coalesce(w, -1.0)), sum(v) from nfact left join ndim on nfact.k = ndim.k "
         "group by g order by g")
    rows = _check(both, q, monkeypatch)
    assert all(np.isfinite(r[3]) for r in rows)


def test_matched_min_max_near_5e9_are_held_to_host(both, monkeypatch):
    """Reference fault R1 under an outer join: the TPU kernel masks
    unmatched rows to +-2**30 and clamps values beyond it. The port masks to
    +-inf: dim values near +-5e9 come back as the host's, to f32 rounding."""
    port, _ = both
    port.execute("create table edim as select x as k, 5000000000.0 + x * 1000.0 as hi, "
                 "-5000000000.0 - x * 1000.0 as lo from range(100) r(x)")
    port.execute(f"create table efact as select x % 150 as k, x % 4 as g from range({N}) r(x)")
    q = ("select g, min(hi), max(hi), min(lo), max(lo) from efact left join edim "
         "on efact.k = edim.k group by g order by g")
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    rows = port.execute(q).rows
    assert port._exec_path == CUDA_PATH
    _assert_rows_close(rows, _host_run(port, q, monkeypatch)[0], rel=1e-7)
    assert rows[0][1] > 4.9e9 and rows[0][3] < -4.9e9


def test_query_f_through_predict_multi_list(both, monkeypatch):
    """Config 3's query F at N rows: four outputs of the 8→4 map over the
    fact row, a random 1:1 key into the dimension, 16 groups. Counts held
    to numpy (lookup, f32 map, np.add.at)."""
    P = "infera_predict_multi_list('m3', x0, x1, x2, x3, x4, x5, x6, x7)[{}]"
    q = (f"select cat, count(*), avg({P.format(1)}), sum({P.format(2)} * w), "
         f"max({P.format(4)}) from src join meta on src.id = meta.id "
         f"where {P.format(3)} > 0 group by cat order by cat")
    rows = _check(both, q, monkeypatch)
    ids = np.random.default_rng(0).permutation(N)
    x = np.random.default_rng(0).standard_normal((N, 8), dtype=np.float32)
    (wt, b), = PORT_MODELS.get("m3").mlp_plan[0]
    y = x @ np.asarray(wt, np.float32) + np.asarray(b, np.float32)
    cnt = np.zeros(16, np.int64)
    np.add.at(cnt, (ids % 16)[y[:, 2] > 0], 1)
    assert [r[1] for r in rows] == cnt.tolist()


def test_explain_and_phases_of_the_join_tier(both, monkeypatch):
    port, _ = both
    q = CASES["full_global"]
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    assert "kernel K5" in "\n".join(r[0] for r in port.execute("explain " + q).rows)
    port.execute(q)
    assert set(port._last_phases) == {"plan_ms", "upload_ms", "exec_ms", "assemble_ms",
                                      "phantom_ms"}
    monkeypatch.setenv("INFERA_PALLAS_SQL", "0")
    assert "torch join program" in "\n".join(r[0] for r in port.execute("explain " + q).rows)
    port.execute(q)
    assert port._exec_path == "device_join_plan"
    assert set(port._last_phases) == {"plan_ms", "upload_ms", "exec_ms", "assemble_ms",
                                      "phantom_ms"}


def test_join_plan_carries_the_join_opcodes(both, monkeypatch):
    """The packed plan of an outer join: no WHERE (the user gave none), a
    matched-validity sum and min that select with SEL, and one shared
    matched-count slot that count(w) reads too."""
    port, _ = both
    port._device_plan_cache = {}
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    port.execute("select count(w), sum(w), min(w) from ofact left join odim on ofact.k = odim.k")
    (_, packed, dim_xc, _), = port._device_plan_cache.values()
    plan = packed.plan
    assert plan.where is None and plan.join is not None
    assert plan.sums[0] == [(fs.MATCHED, 0)] and len(plan.sums) == 2
    assert plan.sums[1][0] == (fs.MATCHED, 0) and plan.sums[1][-1] == (fs.SEL, 0)
    assert plan.sums[1][1][0] == fs.DIM
    assert plan.mins[0][-1] == (fs.SEL, 0)
    assert plan.consts[plan.mins[0][-2][1]] == float("inf")
    assert tuple(dim_xc.shape) == (plan.join.n_cols, 100) and len(packed.lookup) == 100
