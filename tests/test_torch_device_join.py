"""The port's device sort-join (``ops/device_join.py``) against ``infera_tpu``'s.

The same key columns give the same ``(li, ri)`` pairs, in the same order,
for INNER, LEFT, RIGHT and FULL: duplicates on both sides, empty results,
VARCHAR keys, int64 keys beyond int32, float and multi-column keys. SQL
joins over 2**14 rows record the path ``device_join`` in both packages and
give the same rows in the same order (tests/test_parallel.py:99-130,
tests/test_path_equivalence.py:35-160, tests/test_device_ops.py:43-110)."""

import numpy as np
import pytest

import infera_tpu_torch as itt
from infera_tpu.columnar import Column as RefColumn
from infera_tpu.columnar import types as RT
from infera_tpu.ops import device_join as ref_dj
from infera_tpu.sql import Connection as RefConnection
from infera_tpu_torch.columnar import Column, Table
from infera_tpu_torch.columnar import types as T
from infera_tpu_torch.ops import device_join as dj
from infera_tpu_torch.sql import Connection

KINDS = ["INNER", "LEFT", "RIGHT", "FULL"]


@pytest.fixture(autouse=True)
def _on_cpu():
    itt.set_device("cpu")
    yield
    itt.set_device(None)


def _keys(name):
    """(left key arrays, right key arrays, sql type name) of one scenario."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "duplicates":
        return [rng.integers(0, 50, 300)], [rng.integers(0, 50, 200)], "BIGINT"
    if name == "disjoint":
        return [np.array([1, 2, 3])], [np.array([7, 8])], "BIGINT"
    if name == "one_key":
        return [np.zeros(64, np.int64)], [np.zeros(64, np.int64)], "BIGINT"
    if name == "varchar":
        words = np.array(["alpha", "beta", "gamma", "delta", "eps"], object)
        return [words[rng.integers(0, 5, 120)]], [words[rng.integers(1, 5, 40)]], "VARCHAR"
    if name == "beyond_int32":
        base = np.int64(5) << 33
        return ([np.array([base + 7, 7, base + 7, 123, -(base + 1)], np.int64)],
                [np.array([7, base + 7, -(base + 1), 9], np.int64)], "BIGINT")
    if name == "float":
        vals = np.array([1.45, 1.95, 0.2, -0.0, 0.0, 7.5])
        return [vals[rng.integers(0, 6, 90)]], [vals[rng.integers(0, 5, 30)]], "DOUBLE"
    if name == "two_columns":
        return ([rng.integers(0, 4, 150), rng.integers(0, 3, 150)],
                [rng.integers(0, 4, 40), rng.integers(0, 3, 40)], "BIGINT")
    if name == "empty_left":
        return [np.zeros(0, np.int64)], [np.arange(5)], "BIGINT"
    if name == "empty_right":
        return [np.arange(5)], [np.zeros(0, np.int64)], "BIGINT"
    if name == "empty_both":
        return [np.zeros(0, np.int64)], [np.zeros(0, np.int64)], "BIGINT"
    raise KeyError(name)


SCENARIOS = ["duplicates", "disjoint", "one_key", "varchar", "beyond_int32", "float",
             "two_columns", "empty_left", "empty_right", "empty_both"]


def _columns(arrays, tname, col_cls, types):
    t = getattr(types, tname)
    return [col_cls(a if tname == "VARCHAR" else np.asarray(a, t.np_dtype), t) for a in arrays]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", SCENARIOS)
def test_indices_equal_the_reference(name, kind):
    """Where the port declines (an outer join whose build side is empty
    while the preserved side is not), infera_tpu's device join raises and
    falls back to its host join: the port leaves it to the host join."""
    lk, rk, tname = _keys(name)
    if not dj.device_join_eligible(_columns(lk, tname, Column, T),
                                   _columns(rk, tname, Column, T), len(lk[0]), len(rk[0]), kind):
        assert name in ("empty_left", "empty_right")
        with pytest.raises(Exception):
            ref_dj.device_join_indices(_columns(lk, tname, RefColumn, RT),
                                       _columns(rk, tname, RefColumn, RT), kind)
        return
    li, ri = dj.device_join_indices(_columns(lk, tname, Column, T),
                                    _columns(rk, tname, Column, T), kind)
    want_li, want_ri = ref_dj.device_join_indices(_columns(lk, tname, RefColumn, RT),
                                                  _columns(rk, tname, RefColumn, RT), kind)
    assert li.dtype == ri.dtype == np.int64
    np.testing.assert_array_equal(li, np.asarray(want_li))
    np.testing.assert_array_equal(ri, np.asarray(want_ri))


@pytest.mark.parametrize("name", ["duplicates", "varchar", "beyond_int32", "two_columns"])
def test_inner_pairs_equal_a_nested_loop(name):
    lk, rk, tname = _keys(name)
    li, ri = dj.device_join_indices(_columns(lk, tname, Column, T),
                                    _columns(rk, tname, Column, T), "INNER")
    lrows = list(zip(*[a.tolist() for a in lk]))
    rrows = list(zip(*[a.tolist() for a in rk]))
    want = sorted((i, j) for i in range(len(lrows)) for j in range(len(rrows))
                  if lrows[i] == rrows[j])
    assert sorted(zip(li.tolist(), ri.tolist())) == want


# --------------------------------------------------------------------------- SQL


N = 1 << 14


def _sql_pair(*stmts):
    port, ref = Connection(), RefConnection()
    for conn in (port, ref):
        for s in stmts:
            conn.execute(s)
    return port, ref


def _same(port, ref, q, path="device_join"):
    got, want = port.execute(q), ref.execute(q)
    assert port._exec_path == ref._exec_path == path
    assert got.names == want.names
    assert got.rows == want.rows
    return got.rows


@pytest.mark.parametrize("kind", KINDS)
def test_sql_join_rows_and_order_equal_the_reference(kind):
    """Duplicate keys on both sides keep every join off the fused plan: the
    sort-join answers in both packages, and a plain projection shows its
    pairs in their order."""
    port, ref = _sql_pair(
        f"create table l as select x % 5000 as k, x as a from range({N}) r(x)",
        f"create table r2 as select (x * 7) % 6000 as k, x * 3 as b from range({N}) r(x)")
    rows = _same(port, ref, f"select l.k, a, b from l {kind.lower()} join r2 on l.k = r2.k")
    assert len(rows) > N
    _same(port, ref, f"select count(*) n, count(b) nb, count(a) na, sum(a + b) s "
                     f"from l {kind.lower()} join r2 on l.k = r2.k")


def test_sql_join_large_numeric_device_path():
    """tests/test_device_ops.py:43-53 at 2**15 rows a side."""
    n = 1 << 15
    port, ref = _sql_pair(f"create table l as select x as k, x * 2 as a from range({n}) r(x)",
                          f"create table r2 as select x as k, x * 3 as b from range({n}) r(x)")
    rows = _same(port, ref, "select count(*) n, sum(l.a + r2.b) s from l join r2 on l.k = r2.k")
    assert rows == [(n, int((np.arange(n) * 5).sum()))]


def test_sql_varchar_join_device_path():
    """tests/test_path_equivalence.py:145-163: VARCHAR keys dictionary-encode."""
    port, ref = _sql_pair(
        f"create table jl as select case when x % 2 = 0 then 'even' else 'odd' end as s, "
        f"x as v from range({N}) r(x)",
        "create table jr as select 'even' as s, 100 as w union all select 'odd', 200 "
        "union all select 'none', 300")
    rows = _same(port, ref, "select jl.s, v, w from jl join jr on jl.s = jr.s")
    assert len(rows) == N
    port.execute("create table big2 as select 'k' || (x % 977) as s, x as u "
                 f"from range({N}) r(x)")
    ref.execute("create table big2 as select 'k' || (x % 977) as s, x as u "
                f"from range({N}) r(x)")
    _same(port, ref, "select count(*), sum(v), sum(u) from jl left join big2 on jl.s = big2.s")


def test_sql_outer_join_with_an_empty_side_answers_on_the_host():
    port, ref = _sql_pair(f"create table l as select x as k, x as a from range({N}) r(x)",
                          "create table e as select x as k, x as b from range(3) r(x) "
                          "where x > 5")
    got = port.execute("select count(*), count(b) from l left join e on l.k = e.k")
    assert port._exec_path == "host"
    assert got.rows == ref.execute(
        "select count(*), count(b) from l left join e on l.k = e.k").rows == [(N, 0)]


@pytest.mark.parametrize("case", ["int_vs_float", "nan_keys"])
def test_keys_the_sort_join_encodes_apart_go_to_the_host_join(case):
    """Fault R4 of infera_tpu: its sort-join encodes an integer key and a
    float key apart (1 never meets 1.0) and gives NaN keys one bit pattern
    (NaN meets NaN), where its host join, and SQL, do the opposite. The
    port sends such keys to the host join and answers as it does."""
    x = np.arange(N)
    if case == "int_vs_float":
        lk, rk = x % 100, (x % 50).astype(np.float64)
        ltype, rtype = T.BIGINT, T.DOUBLE
        want = int(sum(np.count_nonzero(rk == v) for v in lk[:100]) * (N // 100)
                   + sum(np.count_nonzero(rk == v) for v in lk[:N % 100]))
    else:
        lk = np.where(x % 10 == 0, np.nan, x % 300).astype(np.float64)
        rk = np.where(x % 7 == 0, np.nan, x % 200).astype(np.float64)
        ltype = rtype = T.DOUBLE
        counts = np.bincount(rk[~np.isnan(rk)].astype(np.int64), minlength=300)
        want = int(counts[lk[~np.isnan(lk)].astype(np.int64)].sum())
    assert not dj.device_join_eligible([Column(lk, ltype)], [Column(rk, rtype)], N, N, "INNER")
    port = Connection()
    port.register_table("l", Table({"k": Column(lk, ltype), "a": Column(x, T.BIGINT)}))
    port.register_table("r2", Table({"k": Column(rk, rtype), "b": Column(x, T.BIGINT)}))
    got = port.execute("select count(*) from l join r2 on l.k = r2.k").rows
    assert port._exec_path == "host"
    assert got == [(want,)]
