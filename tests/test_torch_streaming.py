"""The streaming tier (``sql/streaming_plan.py``, ``ops/streaming.py``) on the
CPU against ``infera_tpu``.

Every streaming test of ``tests/test_columnar_io.py`` and the
``stream_query`` test of ``tests/test_device_ops.py`` run here through both
packages with the same monkeypatched thresholds (``STREAM_MIN_ROWS``,
``CHUNK_ROWS``, a chunk that does not divide the rows): both take the same
path, and the port's rows equal ``infera_tpu``'s and the port's host rows
(a second Connection with the streaming and device tiers turned away).
Keys, counts and integers are exact; float sums, averages and extremes
agree to 1e-6 relative, the bound of ``infera_tpu``'s tests. Then the edge
cases: a group key past 2**24, predictions across ragged chunks, NaN and
±inf arguments, an empty global group (ROADMAP R17: the port renders the
host's NULLs), each decline, and no table-sized block cached on the device.
"""

import numpy as np
import pytest
import torch

import infera_tpu as it
import infera_tpu_torch as itt
from infera_tpu.sql import Connection as RefConnection
from infera_tpu.sql import streaming_plan as ref_sp
from infera_tpu_torch.columnar import Column, Table
from infera_tpu_torch.columnar import types as T
from infera_tpu_torch.errors import SqlError
from infera_tpu_torch.ops.streaming import chunked, stream_query
from infera_tpu_torch.registry import MODELS as PORT_MODELS
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_plan as dp
from infera_tpu_torch.sql import streaming_plan as sp

STREAM = "streaming_plan"


@pytest.fixture()
def both(clean_registry, model_dir, monkeypatch):
    """Both packages on the CPU with tests/test_columnar_io.py's thresholds
    (2**14 rows, chunks of 10,000) and the linear model in both registries."""
    itt.set_device("cpu")
    PORT_MODELS.clear()
    for mod in (sp, ref_sp):
        monkeypatch.setattr(mod, "STREAM_MIN_ROWS", 1 << 14)
        monkeypatch.setattr(mod, "CHUNK_ROWS", 10000)
    it.load_model("linear", f"{model_dir}/linear.onnx")
    itt.load_model("linear", f"{model_dir}/linear.onnx")
    yield Connection(), RefConnection()
    PORT_MODELS.clear()
    itt.set_device(None)


def _chunks(monkeypatch, rows):
    for mod in (sp, ref_sp):
        monkeypatch.setattr(mod, "CHUNK_ROWS", rows)


def _create(both, *sqls):
    for conn in both:
        for q in sqls:
            conn.execute(q)


def _host_rows(port, q, monkeypatch):
    """The port's host executor's rows over the same catalog."""
    host = Connection(port.catalog)
    with monkeypatch.context() as m:
        m.setattr(sp, "try_execute_streaming", lambda *a, **k: None)
        m.setattr(dp, "try_execute_on_device", lambda *a, **k: None)
        rows = host.execute(q).rows
    assert host._exec_path == "host"
    return rows


def _same(rows, want, rel=1e-6):
    """Integers and NULLs exact, floats to ``rel`` (NaN equal to NaN)."""
    assert len(rows) == len(want), (rows, want)
    for a, b in zip(rows, want):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            if x is None or y is None or isinstance(x, (int, np.integer)) and isinstance(
                    y, (int, np.integer)):
                assert x == y, (a, b)
            elif np.isnan(x) or np.isnan(y):
                assert np.isnan(x) and np.isnan(y), (a, b)
            else:
                assert x == pytest.approx(y, rel=rel), (a, b)


def _check(both, q, monkeypatch, path=STREAM, rel=1e-6, ref_rel=None):
    """Both packages take ``path``; the port equals the host and
    ``infera_tpu`` (``ref_rel`` None: not compared, a logged R-case)."""
    port, ref = both
    got = port.execute(q).rows
    assert port._exec_path == path, port._exec_path
    want = ref.execute(q).rows
    assert ref._exec_path == path, ref._exec_path
    _same(got, _host_rows(port, q, monkeypatch), rel)
    if ref_rel is not None:
        _same(got, want, ref_rel)
    return got, want


# ---------------------------------------------------------------- tests/test_columnar_io.py


def test_streaming_fused_aggregate(both, monkeypatch):
    """tests/test_columnar_io.py:71: grouped and global aggregates with a
    model, a chunk that does not divide the rows, held to numpy too."""
    n = 45000
    _create(both, f"create table big as select x % 6 as g, x % 5 as h, "
                  f"(x % 100)::float / 10.0 as f1, ((x + 3) % 50)::float / 5.0 as f2, "
                  f"((x * 7) % 30)::float / 3.0 as f3 from range({n}) r(x)")
    calls = {"hits": 0}
    orig = sp.try_execute_streaming

    def probed(conn_, sel, table, analyze_only=False):
        res = orig(conn_, sel, table, analyze_only)
        if res is not None and not analyze_only:
            calls["hits"] += 1
        return res

    monkeypatch.setattr(sp, "try_execute_streaming", probed)
    x = np.arange(n)
    g, h = x % 6, x % 5
    f1 = (x % 100).astype(np.float32) / np.float32(10.0)
    f2 = ((x + 3) % 50).astype(np.float32) / np.float32(5.0)
    f3 = ((x * 7) % 30).astype(np.float32) / np.float32(3.0)
    pred = (2 * f1 - f2 + 0.5 * f3 + np.float32(0.25)).astype(np.float64)

    q = ("select count(*), sum(f1), min(f2), max(f3), "
         "avg(infera_predict('linear', f1, f2, f3)) from big where f1 > 2.0")
    # infera_tpu sums predictions in f32 a chunk (ROADMAP R19): its test's bound, 1e-5
    rows, _ = _check(both, q, monkeypatch, ref_rel=1e-5)
    sel = f1 > 2.0
    assert rows[0][0] == int(sel.sum())
    assert rows[0][1] == pytest.approx(float(f1[sel].astype(np.float64).sum()), rel=1e-6)
    assert rows[0][2] == pytest.approx(float(f2[sel].min()))
    assert rows[0][3] == pytest.approx(float(f3[sel].max()))
    assert rows[0][4] == pytest.approx(float(pred[sel].mean()), rel=1e-5)

    q = ("select g, h, count(*) c, avg(infera_predict('linear', f1, f2, f3)) p "
         "from big group by g, h order by g, h")
    rows, _ = _check(both, q, monkeypatch, ref_rel=1e-5)
    assert len(rows) == 30
    for kg, kh, c, p in rows:
        m = (g == kg) & (h == kh)
        assert c == int(m.sum())
        assert p == pytest.approx(float(pred[m].mean()), rel=1e-5)
    assert calls["hits"] == 2


def test_streaming_over_columnar_file(both, monkeypatch, tmp_path):
    """tests/test_columnar_io.py:133: COPY → read_columnar (memmap) → the
    streaming aggregate, in chunks of 8,192; the port reads the file the
    reference wrote and the reference the port's."""
    _chunks(monkeypatch, 8192)
    n = 50000
    _create(both, f"create table t as select x % 5 as g, (x % 11)::float as f from range({n}) r(x)")
    port, ref = both
    port.execute(f"copy t to '{tmp_path / 'p'}' (format columnar)")
    ref.execute(f"copy t to '{tmp_path / 'r'}' (format columnar)")
    x = np.arange(n)
    for src in ("p", "r"):
        q = f"select g, count(*), sum(f) from read_columnar('{tmp_path / src}') group by g order by g"
        rows, _ = _check(both, q, monkeypatch, ref_rel=1e-9)
        assert len(rows) == 5
        for kg, c, s in rows:
            m = x % 5 == kg
            assert c == int(m.sum())
            assert s == pytest.approx(float((x[m] % 11).sum()), rel=1e-9)


def test_streaming_integer_sum_exact(both, monkeypatch):
    """tests/test_columnar_io.py:157: int64 sums exact past f32 and f64."""
    _chunks(monkeypatch, 8192)
    big = (1 << 47) + 1
    n = 40000
    _create(both, f"create table ti as select x % 4 as g, {big}::bigint as v from range({n}) r(x)")
    rows, want = _check(both, "select g, sum(v) from ti group by g order by g", monkeypatch,
                        ref_rel=0)
    assert rows == want == [(g, (n // 4) * big) for g in range(4)]


def test_streaming_integer_min_max_avg_negative(both, monkeypatch):
    """tests/test_columnar_io.py:176: int64 min/max/avg/sum, negative values
    and magnitudes past 2**53."""
    _chunks(monkeypatch, 8192)
    n = 30000
    base = (1 << 48) + 7
    _create(both, f"create table tm as select x % 3 as g, "
                  f"(x - {n // 2}) * 700000007 + {base} as v from range({n}) r(x)")
    rows, want = _check(both, "select g, min(v), max(v), avg(v), sum(v) from tm group by g "
                              "order by g", monkeypatch, rel=1e-12, ref_rel=1e-12)
    xs = np.arange(n, dtype=object)
    vs = (xs - n // 2) * 700000007 + base
    for (g, mn, mx, av, sm), w in zip(rows, want):
        grp = vs[np.arange(n) % 3 == g]
        assert (mn, mx, sm) == (int(grp.min()), int(grp.max()), int(grp.sum())) == (w[1], w[2], w[4])
        assert av == pytest.approx(int(grp.sum()) / len(grp), rel=1e-12)


def test_streaming_integer_sum_overflow_raises(both, monkeypatch):
    """tests/test_columnar_io.py:206: SUM(BIGINT) past 2**62 raises the
    host's message in both packages."""
    _chunks(monkeypatch, 8192)
    _create(both, "create table ov as select 9000000000000000000::bigint as v "
                  "from range(20000) r(x)")
    port, ref = both
    with pytest.raises(SqlError, match="overflow in SUM"):
        port.execute("select sum(v) from ov")
    from infera_tpu.errors import SqlError as RefSqlError

    with pytest.raises(RefSqlError, match="overflow in SUM") as e:
        ref.execute("select sum(v) from ov")
    with pytest.raises(SqlError) as p:
        port.execute("select sum(v) from ov")
    assert str(p.value) == str(e.value)


def test_streaming_integer_sum_default_scale(clean_registry, monkeypatch):
    """tests/test_columnar_io.py:241: int64 SUM at the real thresholds
    (2**22 + 4,321 rows, chunks of 2**20), exact near 2**60."""
    itt.set_device("cpu")
    try:
        n = (1 << 22) + 4321
        q = "select g, sum(v), count(*) from tbig group by g order by g"
        out = []
        for conn in (Connection(), RefConnection()):
            conn.execute(f"create table tbig as select x % 5 as g, "
                         f"(x * 262147 + 1099511627777) as v from range({n}) r(x)")
            out.append(conn.execute(q).rows)
            assert conn._exec_path == STREAM
        assert out[0] == out[1]
        xs = np.arange(n, dtype=object)
        vs = xs * 262147 + 1099511627777
        for g, s, c in out[0]:
            m = np.arange(n) % 5 == g
            assert c == int(m.sum())
            assert s == int(vs[m].sum())
    finally:
        itt.set_device(None)


# ---------------------------------------------------------------- tests/test_device_ops.py


def test_streaming_query_matches_batch():
    """tests/test_device_ops.py:144: stream_query over chunked host arrays
    equals the batch result; the same chunks through infera_tpu's."""
    import jax
    import jax.numpy as jnp

    from infera_tpu.ops.streaming import chunked as ref_chunked
    from infera_tpu.ops.streaming import stream_query as ref_stream_query

    rng = np.random.default_rng(0)
    n, chunk = 10_000, 1024
    x = rng.standard_normal((n, 8)).astype(np.float32)
    mask = np.ones(n, np.float32)
    w_np = rng.standard_normal((8, 1)).astype(np.float32)
    w = torch.from_numpy(w_np)

    def step(xc, mc):
        y = (xc @ w)[:, 0] * mc
        return y.sum(dtype=torch.float64), mc.sum()

    def combine(acc, p):
        return (acc[0] + p[0], acc[1] + p[1])

    stats = {}
    total, count = stream_query(chunked((x, mask), chunk), step, combine,
                                (torch.zeros((), dtype=torch.float64), torch.zeros(())),
                                device="cpu", stats=stats)
    expected = (x @ w_np)[:, 0].sum()
    assert float(count) == n
    np.testing.assert_allclose(float(total), expected, rtol=1e-4)
    assert stats["chunks"] == -(-n // chunk)

    wj = jnp.asarray(w_np)
    rt, rc = ref_stream_query(ref_chunked((x, mask), chunk),
                              jax.jit(lambda xc, mc: (jnp.sum(jnp.dot(xc, wj)[:, 0] * mc),
                                                      jnp.sum(mc))),
                              combine, (jnp.float32(0), jnp.float32(0)))
    assert float(rc) == float(count)
    np.testing.assert_allclose(float(total), float(rt), rtol=1e-4)


def test_chunked_tail_against_infera_tpus_padding():
    """chunked leaves the tail short where infera_tpu's pads it with zeros:
    the rows are the same."""
    from infera_tpu.ops.streaming import chunked as ref_chunked

    a, b = np.arange(10), np.arange(10.0) * 2
    got = list(chunked((a, b), 4))
    want = list(ref_chunked((a, b), 4))
    assert [len(c[0]) for c in got] == [4, 4, 2] and len(want) == 3
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y[:len(x)])
            assert not y[len(x):].any()


# ---------------------------------------------------------------- edge cases


def test_group_key_past_2_24(both, monkeypatch):
    """Keys past 2**24 are read as int64, never through f32: neighbouring
    keys stay apart and come back exact."""
    k0 = (1 << 25) + 1
    _create(both, f"create table kb as select {k0} + x % 7 as k, (x % 13)::float as f, "
                  f"x as i from range(30000) r(x)")
    rows, _ = _check(both, "select k, count(*), sum(f), max(i) from kb group by k order by k",
                     monkeypatch, ref_rel=1e-6)
    assert [r[0] for r in rows] == [k0 + j for j in range(7)]


def test_key_guard_sends_colliding_keys_to_the_host(both, monkeypatch):
    """Keys past MAX_GROUPS wrap into one bucket: the guard trips in both
    packages and the host answers."""
    _create(both, "create table kc as select case when x % 2 = 0 then 3 else 3 + 65536 end as k, "
                  "(x % 10)::float as f from range(30000) r(x)")
    _check(both, "select k, count(*), sum(f) from kc group by k order by k", monkeypatch,
           path="host", ref_rel=1e-6)


def test_predictions_across_ragged_chunks(both, monkeypatch):
    """A model in the aggregate and in the WHERE, with a chunk of 7,001
    rows: each chunk computes its own predictions (its own ``__pred__``
    and ``__n__``), the tail chunk included."""
    _chunks(monkeypatch, 7001)
    _create(both, "create table pm as select x % 4 as g, (x % 100)::float / 10.0 as f1, "
                  "((x + 3) % 50)::float / 5.0 as f2, ((x * 7) % 30)::float / 3.0 as f3 "
                  "from range(45000) r(x)")
    p = "infera_predict('linear', f1, f2, f3)"
    for q in (f"select g, count(*), avg({p}), min({p}), max({p}) from pm group by g order by g",
              f"select count(*), sum({p}) from pm where {p} > 5.0"):
        # infera_tpu sums predictions in f32 a chunk (ROADMAP R19: 1.1e-5 off
        # the host's f64 sum here); the port is held to the host at 1e-6
        _check(both, q, monkeypatch, ref_rel=1e-4)


def test_nan_and_inf_arguments_against_the_host(both, monkeypatch):
    """NaN, +inf and -inf in a float column: sums, extremes and averages
    equal the host's in every group (NaN wins; inf + -inf is NaN)."""
    n = 45000
    f = ((np.arange(n) % 100) / 10.0).astype(np.float32)
    f[100], f[20000], f[30001], f[30007], f[40003] = np.nan, np.inf, -np.inf, np.inf, -np.inf
    g = (np.arange(n) % 6).astype(np.int64)
    for conn, (tcls, ccls, types) in zip(both, ((Table, Column, T), _ref_types())):
        conn.register_table("nf", tcls({"g": ccls(g, types.BIGINT), "f": ccls(f, types.FLOAT)}))
    for q in ("select g, count(*), sum(f), min(f), max(f), avg(f) from nf group by g order by g",
              "select count(*), sum(f), min(f), max(f) from nf where f > 5.0",
              "select g, sum(f), min(f) from nf where f < 1.0 group by g order by g"):
        _check(both, q, monkeypatch, ref_rel=1e-6)


def _ref_types():
    from infera_tpu.columnar import Column as RefColumn
    from infera_tpu.columnar import Table as RefTable
    from infera_tpu.columnar import types as RT

    return RefTable, RefColumn, RT


def test_r17_empty_global_group_renders_null(both, monkeypatch):
    """ROADMAP R17: a WHERE that keeps no row. The host answers count 0 and
    NULLs; infera_tpu's streaming plan answers 0.0 and ±inf; the port
    renders the host's NULLs on the same path."""
    _create(both, "create table e as select (x % 10)::float as f, x as i from range(30000) r(x)")
    q = "select count(*), sum(f), min(f), max(f), avg(f), sum(i), min(i), avg(i) from e where f > 100.0"
    rows, want = _check(both, q, monkeypatch)
    assert rows == [(0, None, None, None, None, None, None, None)]
    assert want[0][:4] == (0, 0.0, float("inf"), float("-inf"))


@pytest.mark.parametrize("q", [
    "select count(distinct g) from d",
    "select g, var_pop(f) from d group by g order by g",
    "select g, count(*) from d group by g having count(*) > 1 order by g",
    "select g + 1 as gp, count(*) from d group by g + 1 order by gp",
    "select s, count(*) from d group by s order by s",
    "select g, sum(f) from d where g > 2 group by g order by g",
])
def test_declines_leave_both_packages_on_one_path(both, monkeypatch, q):
    """DISTINCT, the variance family, HAVING, an expression key and a
    negative key are declined by both (the device plan or the host
    answers, the same in both); a WHERE over a key column streams. The
    variance runs in f32 on infera_tpu's device plan (R12): its tests'
    bound, 1e-3."""
    _create(both, "create table d as select x % 6 as g, x % 6 - 3 as s, "
                  "(x % 10)::float as f from range(30000) r(x)")
    port, ref = both
    got, want = port.execute(q).rows, ref.execute(q).rows
    assert port._exec_path == ref._exec_path
    if "where" in q:
        assert port._exec_path == STREAM
    else:
        assert port._exec_path != STREAM
    _same(got, want, 1e-3 if "var_pop" in q else 1e-6)
    _same(got, _host_rows(port, q, monkeypatch), 1e-3 if "var_pop" in q else 1e-6)


def test_streaming_caches_no_table_sized_block(both, monkeypatch):
    """Streaming never uploads the table as one block: the device plan's
    caches gain no entry, and no tensor in them has the table's rows."""
    _create(both, "create table nb as select x % 8 as g, (x % 10)::float as f, "
                  "x * 1000003 as v from range(40000) r(x)")
    port, _ = both
    dp._TABLE_BLOCK_CACHE.clear()
    dp._INT_BLOCK_CACHE.clear()
    port.execute("select g, count(*), sum(f), sum(v), max(v) from nb group by g")
    assert port._exec_path == STREAM
    assert not dp._TABLE_BLOCK_CACHE and not dp._INT_BLOCK_CACHE
    phases = port._last_phases
    assert phases["chunks"] == 4
    assert {"plan_ms", "probe_ms", "stream_ms", "fold_ms", "assemble_ms"} <= set(phases)


def test_small_tables_and_the_analyze_only_probe(both, monkeypatch):
    """A table below STREAM_MIN_ROWS takes the device plan in both; the
    analyze-only probe accepts what the tier runs."""
    monkeypatch.setattr(sp, "STREAM_MIN_ROWS", 1 << 15)
    monkeypatch.setattr(ref_sp, "STREAM_MIN_ROWS", 1 << 15)
    _create(both, "create table s as select x % 3 as g, (x % 10)::float as f from range(20000) r(x)")
    port, ref = both
    for conn in both:
        conn.execute("select g, sum(f) from s group by g")
    assert port._exec_path == ref._exec_path == "device_plan"
    from infera_tpu_torch.sql.parser import parse_sql

    table = port.catalog.get("s")
    monkeypatch.setattr(sp, "STREAM_MIN_ROWS", 1 << 10)
    assert sp.try_execute_streaming(port, parse_sql("select g, sum(f) from s group by g")[0],
                                    table, analyze_only=True) is True


def test_r18_a_nan_in_one_group_against_the_host(both, monkeypatch):
    """ROADMAP R18: with chunks of 2**17 rows (infera_tpu's one-hot group-by
    from 2**17 rows and up to 512 groups) a NaN in one group's rows reaches
    every group's sum in infera_tpu (NaN times the one-hot zero). The port
    keeps it in its group, as the host does."""
    _chunks(monkeypatch, 1 << 17)
    n = (1 << 17) + 9000
    f = ((np.arange(n) % 100) / 10.0).astype(np.float32)
    f[100] = np.nan   # group 4
    g = (np.arange(n) % 6).astype(np.int64)
    for conn, (tcls, ccls, types) in zip(both, ((Table, Column, T), _ref_types())):
        conn.register_table("nh", tcls({"g": ccls(g, types.BIGINT), "f": ccls(f, types.FLOAT)}))
    q = "select g, count(*), sum(f), avg(f) from nh group by g order by g"
    rows, want = _check(both, q, monkeypatch)
    assert [bool(np.isnan(r[2])) for r in rows] == [False] * 4 + [True, False]
    assert all(np.isnan(r[2]) for r in want)
