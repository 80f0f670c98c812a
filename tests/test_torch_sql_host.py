"""The port's SQL front end and host executor against ``infera_tpu``'s.

The port keeps its own copies of the lexer, parser and host operators: the
same SQL parses to the same AST (compared by ``repr``), and the same
statements over the same data give the same rows. The tables here are small
(under ``MIN_DEVICE_ROWS``), so both packages answer on their host
executors."""

import numpy as np
import pytest

from infera_tpu.sql import Connection as RefConnection
from infera_tpu.sql.parser import parse_sql as ref_parse_sql
from infera_tpu_torch.errors import SqlError
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql.parser import parse_sql

# the statements of tests/test_pallas_sql.py:52-186 and the SQL flagship of
# infera_tpu/testing/e2e_eval.py
PARSED = [
    "select g, count(*) c, avg(infera_predict('m', f1, f2, f3, f4)) p, "
    "sum(f1) s from big where f2 > 1.0 group by g order by g",
    "select g, h, min(f1) mn, max(f2) mx, count(*) c from big "
    "group by g, h having count(*) > 10 order by g, h",
    "select count(*), sum(f1 * 2.0 + f3), min(f2 - f4), max(f2) "
    "from big where f1 > 3.0 and f3 < 8.0",
    "select g, avg(infera_predict_multi_list('mc', f1, f2, f3, f4)[2]) "
    "from big group by g order by g",
    "select g, count(*) c, avg(infera_predict('gbt', f1, f2, f3, f4)) p,"
    " max(infera_predict('gbt', f1, f2, f3, f4)) mx from big "
    "where f1 > 1.0 group by g order by g",
    "select count(*), sum(f1) from big "
    "where infera_predict('gbtw', f1, f2, f3, f4) > 0.0",
    "select g, count(*) c, avg(infera_predict('gbc', f1, f2, f3, f4))"
    " al, min(infera_predict('gbc', f1, f2, f3, f4)) ml from big "
    "group by g order by g",
    "select g, avg(infera_predict('mb', f1, f2, f3, f4)) p from big "
    "group by g order by g",
    "select g, sum(h) from big group by g order by g",
    "select g, stddev(f1) sd, var_pop(f2) vp, count_if(f1 > 4.0) ci, "
    "bool_and(f1 >= 0.0) ba, bool_or(f2 > 9.0) bo, "
    "product(1.0 + f3 / 1000.0) pr, avg(h) ah from big group by g order by g",
    "select g, count(distinct h) cd, sum(distinct h) sd, "
    "avg(distinct h) ad from big group by g order by g",
    "create table big as select x % 64 as g, x % 5 as h, "
    "(x % 100)::float / 10.0 as f1, ((x + 3) % 50)::float / 5.0 as f2, "
    "((x * 7) % 30)::float / 3.0 as f3, ((x * 11) % 90)::float / 9.0 "
    "as f4 from range(32768) r(x)",
    "select g, count(*) from big where f1 between 1 and 2 and not (f2 < 0.5 "
    "or cast(f3 as integer) % 2 = 1) group by g having max(f4) >= abs(-3.5)",
]

TABLE = ("create table t as select x % 7 as g, x % 3 as h, (x % 100)::float / 10.0 as f, "
         "((x * 7) % 31)::float - 15.0 as v, 'k' || (x % 4) as s from range(2000) r(x)")
DIM = "create table d as select x as g, 'name' || x as nm, x * 1.5 as w from range(5) r(x)"

# group-by, HAVING, ORDER BY / LIMIT, a join, windows, and the host
# aggregate families the kernel tier leaves to the host
HOST_QUERIES = [
    "select g, count(*), sum(f), avg(v), min(v), max(f) from t group by g order by g",
    "select g, h, count(*) c from t group by g, h having count(*) > 90 order by g, h",
    "select s, sum(v) sv from t group by s having sum(v) > -100 order by sv desc",
    "select g, f, v from t order by v desc, f limit 7",
    "select g, v from t where f between 2 and 3 order by g, v limit 5 offset 3",
    "select nm, count(*), sum(v * w) from t join d on t.g = d.g group by nm order by nm",
    "select g, f, row_number() over (partition by g order by f, v) rn, "
    "sum(v) over (partition by g order by f rows between 2 preceding and current row) rs "
    "from t where f < 1.0 order by g, f, v",
    "select g, rank() over (order by g) r from t where h = 0 and f < 3 order by g, r",
    "select g, var_pop(v), stddev(f), count(distinct h), median(v) from t "
    "group by g order by g",
    "select count(*), sum(g), min(f), max(v) from t where v > 0",
    "select g % 2 as p, avg(f * 2.0 + v) from t group by g % 2 order by p",
    "select distinct h, g % 2 from t order by h, 2",
    "with q as (select g, sum(v) sv from t group by g) select * from q where sv > 0 order by g",
]


@pytest.mark.parametrize("sql", PARSED)
def test_parse_gives_the_same_ast(sql):
    assert repr(parse_sql(sql)) == repr(ref_parse_sql(sql))


@pytest.mark.parametrize("sql", ["select 1 +", "selec 1", "select (1", "select * from t where",
                                 "select 'abc", "select 1 from t group"])
def test_parse_errors_are_byte_equal(sql):
    outcomes = []
    for parse in (parse_sql, ref_parse_sql):
        try:
            outcomes.append(repr(parse(sql)))
        except Exception as e:  # the parity check compares the errors themselves
            outcomes.append(f"{type(e).__name__}: {e}")
    assert outcomes[0] == outcomes[1]
    assert outcomes[0].startswith("SqlError")


@pytest.fixture(scope="module")
def conns():
    port, ref = Connection(), RefConnection()
    for conn in (port, ref):
        conn.execute(TABLE)
        conn.execute(DIM)
    return port, ref


def _close(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            if isinstance(y, float) and not isinstance(x, str):
                assert x == pytest.approx(y, rel=1e-12, abs=1e-12, nan_ok=True)
            else:
                assert x == y


@pytest.mark.parametrize("sql", HOST_QUERIES)
def test_host_rows_match(conns, sql):
    port, ref = conns
    got = port.execute(sql)
    want = ref.execute(sql)
    assert port._exec_path == ref._exec_path == "host"
    assert got.names == want.names
    _close(got.rows, want.rows)


def test_mesh_is_refused_with_a_clear_error():
    """set_mesh takes a shard count, a Mesh or None; anything else is
    refused with an error that names the mesh."""
    conn = Connection()
    conn.set_mesh(None)
    with pytest.raises(SqlError, match="mesh"):
        conn.set_mesh("8")


def test_explain_names_the_kernel_tier(monkeypatch):
    """EXPLAIN names the tier the plan takes: kernel K2 where it is on, the
    torch program where it is off (``INFERA_PALLAS_SQL=0`` turns off K2
    only), the host where neither takes the plan."""
    import infera_tpu_torch as itt

    itt.set_device("cpu")
    try:
        conn = Connection()
        conn.execute("create table e as select x % 8 as g, x * 0.5 as f from range(20000) r(x)")
        q = "explain select g, sum(f) from e group by g"
        monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
        assert "kernel K2" in "\n".join(r[0] for r in conn.execute(q).rows)
        monkeypatch.setenv("INFERA_PALLAS_SQL", "0")
        assert "torch program" in "\n".join(r[0] for r in conn.execute(q).rows)
        q = "explain select g, sum(f) from e group by g having g > 1"
        assert "host/hybrid" in "\n".join(r[0] for r in conn.execute(q).rows)
    finally:
        itt.set_device(None)


def test_metrics_record_the_path_and_phases(monkeypatch):
    import infera_tpu_torch as itt
    from infera_tpu_torch.observability import METRICS

    itt.set_device("cpu")
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    try:
        conn = Connection()
        conn.execute("create table e as select x % 8 as g, x * 0.5 as f from range(20000) r(x)")
        rows = conn.execute("select g, sum(f) from e group by g order by g").rows
        m = METRICS.entries[0]
        assert m.path == "device_plan_cuda"
        assert set(m.phases) == {"plan_ms", "upload_ms", "probe_ms", "exec_ms", "assemble_ms"}
        x = np.arange(20000)
        assert [r[1] for r in rows] == [float((x[x % 8 == g] * 0.5).sum()) for g in range(8)]
    finally:
        itt.set_device(None)
