"""The aggregate tail (slot families b–e of K2) through the port's kernel
tier, on the CPU.

With ``INFERA_PALLAS_SQL=1`` on the CPU, ``device_plan`` runs K2's plain
version (``ops/fused_sql.fused_sql_plain``) for the variance family,
count_if, bool_and/or, product, exact int64 sum/avg/min/max,
COUNT/SUM/AVG(DISTINCT), MODE and arg_min/arg_max. Each query that
``infera_tpu`` runs on ``device_plan_pallas`` (its Pallas kernel in
interpret mode) must run on ``device_plan_cuda`` and give the port's host
rows and ``infera_tpu``'s rows at the tolerance of the reference test it
ports (``tests/test_pallas_sql.py:188-275,472-500``,
``tests/test_device_plan.py:371-520``); where ``infera_tpu`` sends a query
to its XLA program (``device_plan``) the port's host executor answers with
the same rows. The plain version's new families are held to numpy per-group
references."""

import numpy as np
import pytest
import torch

import infera_tpu as it
import infera_tpu.sql.device_plan as ref_dp
import infera_tpu_torch as itt
from infera_tpu.columnar import Column as RefColumn
from infera_tpu.columnar import Table as RefTable
from infera_tpu.columnar import types as RT
from infera_tpu.errors import SqlError as RefSqlError
from infera_tpu.sql import Connection as RefConnection
from infera_tpu_torch.columnar import Column, Table
from infera_tpu_torch.columnar import types as T
from infera_tpu_torch.errors import SqlError
from infera_tpu_torch.onnx import builder, proto
from infera_tpu_torch.ops import fused_sql as fs
from infera_tpu_torch.registry import MODELS as PORT_MODELS
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_plan as dp
from infera_tpu_torch.sql import int_agg

N = dp.MIN_DEVICE_ROWS * 2
BIG = (f"create table big as select x % 64 as g, x % 5 as h, "
       f"(x % 100)::float / 10.0 as f1, ((x + 3) % 50)::float / 5.0 as f2, "
       f"((x * 7) % 30)::float / 3.0 as f3, ((x * 11) % 90)::float / 9.0 "
       f"as f4 from range({N}) r(x)")
# tests/test_device_plan.py's conn_big table
BIG7 = (f"create table big as select x % 7 as g, (x % 100)::float / 10.0 as f1, "
        f"((x + 3) % 50)::float / 5.0 as f2, ((x * 7) % 30)::float / 3.0 as f3 "
        f"from range({N}) r(x)")


def _connections(monkeypatch, create):
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    itt.set_device("cpu")
    PORT_MODELS.clear()
    port, ref = Connection(), RefConnection()
    for conn in (port, ref):
        conn.execute(create)
    return port, ref


@pytest.fixture()
def both(clean_registry, monkeypatch, tmp_path):
    """tests/test_pallas_sql.py's big table and its 4-32-1 MLP in both
    packages, the kernel tier forced on."""
    port, ref = _connections(monkeypatch, BIG)
    path = tmp_path / "m.onnx"
    proto.save_model_file(builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1, softmax=False),
                          path)
    it.load_model("m", str(path))
    itt.load_model("m", str(path))
    yield port, ref
    PORT_MODELS.clear()
    itt.set_device(None)


@pytest.fixture()
def both7(clean_registry, monkeypatch):
    """tests/test_device_plan.py's conn_big table in both packages."""
    yield _connections(monkeypatch, BIG7)
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
            if isinstance(y, float) and not (isinstance(x, float) and np.isnan(x) and np.isnan(y)):
                assert x == pytest.approx(y, rel=rel, abs=1e-9)
            else:
                assert x == y


# where infera_tpu's rows come from -> where the port's must
PATHS = {"device_plan_pallas": "device_plan_cuda", "device_plan": "host", "host": "host"}


def _run_both(port, ref, q, monkeypatch, rel):
    """The query through both packages: the port takes its kernel tier
    exactly where infera_tpu takes its Pallas kernel, and both give the
    port's host rows. Returns (port rows, infera_tpu's path)."""
    rows = port.execute(q).rows
    path = port._exec_path
    ref_rows = ref.execute(q).rows
    assert path == PATHS[ref._exec_path], (q, ref._exec_path)
    _assert_rows_close(rows, _host_rows(port, q, monkeypatch), rel)
    _assert_rows_close(rows, ref_rows, rel)
    return rows, ref._exec_path


# --------------------------------------------------------------------------- test_pallas_sql


# (query, tolerance of tests/test_pallas_sql.py:188-213)
WIDENED = {
    "int_sum": ("select g, sum(h) from big group by g order by g", 1e-12),
    "families": ("select g, stddev(f1) sd, var_pop(f2) vp, count_if(f1 > 4.0) ci, "
                 "bool_and(f1 >= 0.0) ba, bool_or(f2 > 9.0) bo, "
                 "product(1.0 + f3 / 1000.0) pr, avg(h) ah "
                 "from big group by g order by g", 1e-3),
    "distinct": ("select g, count(distinct h) cd, sum(distinct h) sd, "
                 "avg(distinct h) ad from big group by g order by g", 1e-6),
    "var_pop": ("select g, var_pop(f1) from big group by g order by g", 1e-3),
    "predictions": ("select g, var_samp(infera_predict('m', f1, f2, f3, f4)), "
                    "count_if(infera_predict('m', f1, f2, f3, f4) > 0.0), "
                    "product(infera_predict('m', f1, f2, f3, f4)) from big "
                    "group by g order by g", 1e-3),
    "having": ("select g, count(distinct h), mode(h) from big group by g "
               "having stddev(f1) > 2.0 and count(distinct h) = 5 order by g", 1e-12),
}


@pytest.mark.parametrize("name", list(WIDENED))
def test_widened_tail_runs_in_the_kernel(both, monkeypatch, name):
    port, ref = both
    q, rel = WIDENED[name]
    rows, ref_path = _run_both(port, ref, q, monkeypatch, rel)
    if name != "having":   # a MODE that ties goes to infera_tpu's XLA program
        assert ref_path == "device_plan_pallas"
    if name == "int_sum":
        x = np.arange(N)
        assert rows == [(k, int((x % 5)[x % 64 == k].sum())) for k in range(64)]


def test_int_sum_overflow_and_big_values(clean_registry, monkeypatch):
    """Exact int64 sums of values far beyond 2**24, and the host's
    SUM(BIGINT) overflow error raised from the kernel tier."""
    big = (1 << 44) + 7   # per-group totals ~2**57: exact past f64's 2**53
    port, ref = _connections(monkeypatch, f"create table bi as select x % 4 as g, "
                                          f"{big} + x as v from range({N}) r(x)")
    q = "select g, sum(v) from bi group by g order by g"
    rows, ref_path = _run_both(port, ref, q, monkeypatch, 0)
    assert ref_path == "device_plan_pallas"
    assert rows == [(k, sum(big + i for i in range(k, N, 4))) for k in range(4)]
    calls = []
    finalize = dp._finalize_agg

    def spy(pname, *a):
        calls.append(pname)
        return finalize(pname, *a)

    monkeypatch.setattr(dp, "_finalize_agg", spy)
    for conn in (port, ref):
        conn.execute(f"create table ov as select 1 as g, {(1 << 53) + 1} as v from range({N}) r(x)")
    with pytest.raises(SqlError, match="Out of Range Error: overflow in SUM\\(BIGINT\\)"):
        port.execute("select g, sum(v) from ov group by g")
    assert calls == ["isum"]    # raised by the kernel tier's finalize
    with pytest.raises(RefSqlError, match="overflow in SUM"):
        ref.execute("select g, sum(v) from ov group by g")
    monkeypatch.setenv("INFERA_PALLAS_SQL", "0")
    with pytest.raises(SqlError, match="Out of Range Error: overflow in SUM\\(BIGINT\\)"):
        port.execute("select g, sum(v) from ov group by g")


SARG = (f"create table sarg as select x % 16 as g, ((x * 13) % 97)::float as v, "
        f"'n' || (x % 11) as nm, x % 23 as iv from range({N}) r(x)")
ARG_QUERIES = [
    "select g, arg_min(iv, v) am, arg_max(iv, v) ax from sarg group by g order by g",
    "select g, arg_max(nm, v) from sarg group by g order by g",
    "select arg_min(iv, v), arg_max(nm, v) from sarg where v > 5.0",
    "select g, min_by(iv, v), max_by(g, iv) from sarg group by g order by g",
]


@pytest.mark.parametrize("q", ARG_QUERIES)
def test_arg_min_max_in_the_kernel(both, monkeypatch, q):
    """The winning row id in the kernel, the smallest on a tie; the host
    gathers the arg column, of any type."""
    port, ref = both
    for conn in (port, ref):
        conn.execute(SARG)
    _, ref_path = _run_both(port, ref, q, monkeypatch, 0)
    assert ref_path == "device_plan_pallas"


def test_int64_min_max_in_the_kernel(both, monkeypatch):
    port, ref = both
    big = (1 << 44) + 5
    for conn in (port, ref):
        conn.execute(f"create table lx as select x % 16 as g, "
                     f"(case when x % 3 = 0 then -1 else 1 end) * "
                     f"({big} + x * 7) as v, x % 9 as sm from range({N}) r(x)")
    q = ("select g, min(v) mn, max(v) mx, min(sm) sn, max(sm) sx, sum(v), avg(v) "
         "from lx group by g order by g")
    _, ref_path = _run_both(port, ref, q, monkeypatch, 1e-12)
    assert ref_path == "device_plan_pallas"


def test_mode_unique_max_in_the_kernel(both, monkeypatch):
    port, ref = both
    for conn in (port, ref):
        conn.execute(f"create table mu as select x % 4 as mg, "
                     f"((x % 12) * (x % 5)) % 9 as v from range({N}) r(x)")
    q = "select mg, mode(v) m, count(*) c from mu group by mg order by mg"
    _, ref_path = _run_both(port, ref, q, monkeypatch, 0)
    assert ref_path == "device_plan_pallas"


def test_mode_tie_goes_to_the_host(both, monkeypatch):
    """A tied MODE needs the host's first-occurrence tie-break: infera_tpu
    runs its XLA program, the port its host executor."""
    port, ref = both
    for conn in (port, ref):
        conn.execute(f"create table mtie as select x % 4 as mg, x % 5 as v from range({N}) r(x)")
    _, ref_path = _run_both(port, ref, "select mg, mode(v) from mtie group by mg order by mg",
                            monkeypatch, 0)
    assert ref_path == "device_plan"


# --------------------------------------------------------------------------- test_device_plan


def _frame():
    x = np.arange(N, dtype=np.int64)
    f1 = (x % 100).astype(np.float32) / np.float32(10.0)
    f2 = ((x + 3) % 50).astype(np.float32) / np.float32(5.0)
    f3 = ((x * 7) % 30).astype(np.float32) / np.float32(3.0)
    return x % 7, f1, f2, f3


def test_int_sum_overflow_raises_on_a_global_sum(both7):
    port, ref = both7
    big = (1 << 62) // (N // 2)
    for conn in (port, ref):
        conn.execute(f"create table ovfsd as select {big} as v from range({N}) r(x)")
    with pytest.raises(SqlError, match="Out of Range Error: overflow in SUM\\(BIGINT\\)"):
        port.execute("select sum(v) from ovfsd")
    with pytest.raises(RefSqlError, match="Out of Range Error: overflow in SUM\\(BIGINT\\)"):
        ref.execute("select sum(v) from ovfsd")


def test_stddev_and_variance(both7, monkeypatch):
    port, ref = both7
    q = "select g, stddev(f1), var_pop(f2), stddev_pop(f3) from big group by g order by g"
    rows, ref_path = _run_both(port, ref, q, monkeypatch, 1e-3)
    assert ref_path == "device_plan_pallas"
    g, f1, f2, f3 = _frame()
    for key, sd, vp, sp in rows:
        m = g == key
        assert sd == pytest.approx(float(np.std(f1[m], ddof=1)), rel=1e-3)
        assert vp == pytest.approx(float(np.var(f2[m], ddof=0)), rel=1e-3)
        assert sp == pytest.approx(float(np.std(f3[m], ddof=0)), rel=1e-3)


def test_stddev_of_one_row_groups_goes_to_the_host(both7):
    """stddev over 1-row groups is NULL: 32,768 groups are over the kernel's
    512, and the host renders the NULLs."""
    port, _ = both7
    port.execute(f"create table onerow as select x as g, x::float as f from range({N}) r(x)")
    rows = port.execute("select g, stddev(f) from onerow group by g order by g limit 3").rows
    assert port._exec_path == "host"
    assert rows[0][1] is None


def test_distinct_aggregates(both7, monkeypatch):
    port, ref = both7
    for conn in (port, ref):
        conn.execute(f"create table ddsd as select x % 5 as g, (x * 13) % 41 as v "
                     f"from range({N}) r(x)")
    q = ("select g, count(distinct v), sum(distinct v), avg(distinct v) "
         "from ddsd group by g order by g")
    rows, ref_path = _run_both(port, ref, q, monkeypatch, 1e-9)
    assert ref_path == "device_plan_pallas"
    x = np.arange(N, dtype=np.int64)
    for key, c, s, a in rows:
        vals = np.unique(((x * 13) % 41)[x % 5 == key])
        assert (c, s) == (len(vals), int(vals.sum()))
        assert a == pytest.approx(float(vals.mean()), rel=1e-9)


def test_distinct_matches_the_host_on_a_small_table(both7, monkeypatch):
    port, ref = both7
    for conn in (port, ref):
        conn.execute(f"create table dd_dev as select x % 4 as g, x % 23 as v from range({N}) r(x)")
        conn.execute("create table dd_host as select * from dd_dev limit 1000")
    q = "select g, count(distinct v), sum(distinct v) from {} group by g order by g"
    dev, ref_path = _run_both(port, ref, q.format("dd_dev"), monkeypatch, 0)
    assert ref_path == "device_plan_pallas" and len(dev) == 4
    host = port.execute(q.format("dd_host")).rows
    assert port._exec_path == "host"
    x = np.arange(1000, dtype=np.int64)
    for key, c, s in host:
        vals = np.unique((x % 23)[x % 4 == key])
        assert c == len(vals) and s == int(vals.sum())


def test_min_max_are_distinct_insensitive(both7, monkeypatch):
    port, ref = both7
    rows, ref_path = _run_both(port, ref, "select min(distinct f1), max(distinct f2) from big",
                               monkeypatch, 1e-7)
    assert ref_path == "device_plan_pallas"
    _, f1, f2, _ = _frame()
    assert rows[0] == (pytest.approx(float(f1.min())), pytest.approx(float(f2.max())))


@pytest.mark.parametrize("q", [
    "select g, median(f1), median(g) from big where f2 > 1.0 group by g order by g",
    "select g, quantile_cont(f1, 0.25), quantile_disc(f2, 0.5) from big group by g order by g",
    "select g, approx_count_distinct(f1) from big group by g order by g",
])
def test_infera_tpus_xla_aggregates_go_to_the_host(both7, monkeypatch, q):
    """Median, quantiles and HLL run in infera_tpu's XLA program (P4): the
    port's host executor answers with the same rows, to the XLA program's f32
    (pytest.approx's default, as tests/test_device_plan.py:457-489)."""
    port, ref = both7
    _, ref_path = _run_both(port, ref, q, monkeypatch, 1e-6)
    assert ref_path != "device_plan_pallas"


def test_mode_with_the_hosts_tie_break(both7, monkeypatch):
    port, ref = both7
    for conn in (port, ref):
        conn.execute(f"create table mo as select x % 4 as g, "
                     f"case when x % 10 < 4 then 7 when x % 10 < 8 then 3 "
                     f"else x % 23 end as v from range({N}) r(x)")
    rows, _ = _run_both(port, ref, "select g, mode(v) from mo group by g order by g",
                        monkeypatch, 0)
    x = np.arange(N)
    v = np.where(x % 10 < 4, 7, np.where(x % 10 < 8, 3, x % 23))
    from collections import Counter
    for key, mv in rows:
        vals = v[x % 4 == key]
        best = max(Counter(vals.tolist()).items(),
                   key=lambda kv: (kv[1], -int(np.flatnonzero(vals == kv[0])[0])))[0]
        assert mv == best


# --------------------------------------------------------------------------- edge cases


def _register(port, ref, name, cols):
    """The same numpy columns as a table of both packages."""
    port.register_table(name, Table({k: Column(v, t) for k, (v, t) in cols.items()}))
    ref.register_table(name, RefTable({k: RefColumn(v, getattr(RT, t.name))
                                       for k, (v, t) in cols.items()}))


def _edge_table(port, ref):
    x = np.arange(N)
    v = np.sin(x * 0.37).astype(np.float32)
    nan_late = v.copy()
    nan_late[100::997] = np.nan            # never a group's first row
    nan_first = v.copy()
    nan_first[0:4] = np.nan                # every group's first row
    _register(port, ref, "e", {
        "g": (x % 4, T.BIGINT), "id": (x.astype(np.int64), T.BIGINT),
        "z": (np.where(x % 2 == 0, -0.0, 0.0).astype(np.float32), T.FLOAT),
        "z2": (np.where(x % 3 == 0, 0.0, -0.0).astype(np.float32), T.FLOAT),
        "big": ((2.0e9 + ((x * 7919) % 100000) * 256.0).astype(np.float32), T.FLOAT),
        "nl": (nan_late, T.FLOAT), "nf": (nan_first, T.FLOAT),
        "d": (1.0 + ((x * 7919) % N) * 1e-12, T.DOUBLE),
        "dx": (((x * 7919) % N) * 0.5, T.DOUBLE)})


@pytest.mark.parametrize("q", [
    "select g, arg_min(id, z), arg_max(id, z), arg_min(id, z2), arg_max(id, z2) from e "
    "group by g order by g",
    "select g, arg_min(id, big), arg_max(id, big), arg_min(id, -big) from e group by g order by g",
    "select g, arg_min(id, dx), arg_max(id, -dx) from e group by g order by g",
])
def test_arg_edge_cases_in_the_kernel(both, monkeypatch, q):
    """-0.0 ties +0.0 (the first row wins, as the host's np.less has it);
    values past 2**30, where infera_tpu's arg slots fill with 2**30 and
    answer rows of other groups (R1), are held to the host; an f64 column
    whose values are f32-exact runs in the kernel, and so does its
    negation."""
    port, ref = both
    _edge_table(port, ref)
    rows = port.execute(q).rows
    assert port._exec_path == "device_plan_cuda"
    assert rows == _host_rows(port, q, monkeypatch)


@pytest.mark.parametrize("col", ["nl", "nf", "d", "d * 2.0"])
def test_arg_edge_cases_held_to_the_host(both, monkeypatch, col):
    """A NaN order value (the host lets a NaN win only as its group's first
    row; infera_tpu's kernel maps it to 2**30, R5) and an f64 order column
    that is not f32-exact (the f32 block ties rows the host tells apart,
    R6) send the query to the host. infera_tpu's rows differ: the port
    answers as the host."""
    port, ref = both
    _edge_table(port, ref)
    q = f"select g, arg_min(id, {col}), arg_max(id, {col}) from e group by g order by g"
    rows = port.execute(q).rows
    assert port._exec_path == "host"
    ref_rows = ref.execute(q).rows
    assert ref._exec_path == "device_plan_pallas"
    assert ref_rows != rows
    monkeypatch.setattr(ref_dp, "try_execute_on_device", lambda *a, **k: None)
    assert ref.execute(q).rows == rows


def test_arg_over_a_computed_order_is_held_to_the_host(both, monkeypatch):
    """R8: K2 would evaluate ``1.0 + h * 1e-9`` in f32, where every row
    rounds to 1.0 and ties (rows 0-3 win); the host evaluates it in f64. So
    the arg slot declines the expression and the host's rows come back, as
    in infera_tpu without its device tiers."""
    port, ref = both
    n = 32_768
    for conn in (port, ref):
        conn.execute(f"create table r8 as select x % 4 as g, ((x * 7) % 5)::double as h, "
                     f"x as id from range({n}) r(x)")
    q = ("select g, arg_min(id, 1.0 + h * 1e-9), arg_max(id, 1.0 + h * 1e-9) from r8 "
         "group by g order by g")
    rows = port.execute(q).rows
    assert port._exec_path == "host"
    assert rows == [(0, 0, 12), (1, 5, 17), (2, 10, 2), (3, 15, 7)]
    assert rows == _host_rows(port, q, monkeypatch)
    monkeypatch.setattr(ref_dp, "try_execute_on_device", lambda *a, **k: None)
    assert ref.execute(q).rows == rows


@pytest.mark.parametrize("q", [
    "select sum(v) from ge where f < 0.0",
    "select min(v), max(v) from ge where f < 0.0",
    "select sum(distinct h) from ge where f < 0.0",
    "select arg_min(v, f) from ge where f < 0.0",
])
def test_an_empty_global_group_renders_null(both, monkeypatch, q):
    """An aggregate over no selected rows is NULL. infera_tpu's kernel tier
    answers 0, the int64 extreme or row 0 here (R7); the port's finalize
    marks the empty group and the host renders the NULL."""
    port, ref = both
    for conn in (port, ref):
        conn.execute(f"create table ge as select x * 3 - 7 as v, x % 5 as h, "
                     f"(x % 100)::float as f from range({N}) r(x)")
    rows = port.execute(q).rows
    assert port._exec_path == "host"
    assert all(v is None for v in rows[0])
    assert ref.execute(q).rows != rows
    assert ref._exec_path == "device_plan_pallas"


def test_a_plan_over_the_smem_budget_runs_on_the_host(both):
    """24 exact int64 sums at 512 groups need 24 x 10 KB of accumulators,
    over one block's 227 KB."""
    port, _ = both
    port.execute(f"create table s5 as select x % 500 as k, x % 5 as h from range({N}) r(x)")
    for slots, path in ((24, "host"), (20, "device_plan_cuda")):
        port.execute("select k, " + ", ".join(["sum(h)"] * slots) + " from s5 group by k")
        assert port._exec_path == path


@pytest.mark.parametrize("case", ["domain", "limb_rows", "int_product"])
def test_infera_tpus_declines_are_kept(both, monkeypatch, case):
    """A DISTINCT domain over 512 values, an integer sum over more rows than
    MAX_LIMB_ROWS (patched small on both sides) and a product over an integer
    column run outside the kernel in both packages, with the same rows."""
    port, ref = both
    if case == "limb_rows":
        monkeypatch.setattr(int_agg, "MAX_LIMB_ROWS", 1000)
        monkeypatch.setattr("infera_tpu.sql.int_agg.MAX_LIMB_ROWS", 1000)
    for conn in (port, ref):
        conn.execute(f"create table dk as select x % 8 as g, x % 1000 as k from range({N}) r(x)")
    q = {"domain": "select g, count(distinct k) from dk group by g order by g",
         "limb_rows": "select g, sum(k), avg(k) from dk group by g order by g",
         "int_product": "select g, product(k % 2 + 1) from dk group by g order by g"}[case]
    rows, ref_path = _run_both(port, ref, q, monkeypatch, 1e-12)
    assert port._exec_path == "host"
    assert ref_path != "device_plan_pallas"


# --------------------------------------------------------------------------- plain version


def _plain_inputs(n, G, seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, G, n)
    vals = rng.integers(-3, 40, n).astype(np.float32)     # some negatives: invalid values
    order = rng.integers(-50, 50, n).astype(np.float32)   # ties
    order[rng.random(n) < 0.01] = -0.0
    xi = np.stack([rng.integers(-(1 << 62), 1 << 62, n),
                   rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
                                endpoint=True)])
    xc = np.stack([key.astype(np.float32), np.abs(vals), order, vals])
    return key, xc, xi


@pytest.mark.parametrize("n,G,seed", [(1, 8, 0), (4099, 64, 1), (50_000, 512, 2)])
def test_plain_tail_against_numpy(n, G, seed):
    """fused_sql_plain's int slots, DISTINCT counts and arg words against
    numpy per-group references: integers exact, the |v| sums to 1e-12."""
    key, xc_np, xi_np = _plain_inputs(n, G, seed)
    plan = fs.FusedPlan(where=None, keys=[[(fs.COL, 0)]], sums=[], mins=[], maxs=[],
                        strides=[1], n_groups=G,
                        ints=[(0, "sum"), (1, "min"), (1, "max"), (1, "sum")],
                        dists=[([(fs.COL, 1)], 64, "dist"), ([(fs.COL, 3)], 64, "mode")],
                        args=[([(fs.COL, 2)], True), ([(fs.COL, 2)], False)])
    res = fs.fused_sql_plain(fs.pack_plan(plan, "cpu"), torch.as_tensor(xc_np), n,
                             int_xc=torch.as_tensor(xi_np))
    i64 = np.iinfo(np.int64)
    wrap = np.zeros(G, np.uint64)
    np.add.at(wrap, key, xi_np[1].view(np.uint64))
    want_sum0 = np.zeros(G, np.int64)
    np.add.at(want_sum0, key, xi_np[0])
    mn = np.full(G, i64.max)
    np.minimum.at(mn, key, xi_np[1])
    mx = np.full(G, i64.min)
    np.maximum.at(mx, key, xi_np[1])
    np.testing.assert_array_equal(res["ints"].numpy(),
                                  np.stack([want_sum0, mn, mx, wrap.view(np.int64)]))
    est = np.zeros((2, G))
    np.add.at(est[0], key, np.abs(xi_np[0].astype(np.float64)))
    np.add.at(est[1], key, np.abs(xi_np[1].astype(np.float64)))
    np.testing.assert_allclose(res["iest"].numpy(), est, rtol=1e-12)
    # DISTINCT counts: slot 0 reads |vals| (always valid), slot 1 vals
    # (negatives are invalid: the flag, bit K + 1 + 1)
    cnt = np.zeros((G, 64), np.int32)
    np.add.at(cnt, (key, np.abs(xc_np[3]).astype(np.int64)), 1)
    ok = xc_np[3] >= 0
    cnt_m = np.zeros((G, 64), np.int32)
    np.add.at(cnt_m, (key[ok], xc_np[3][ok].astype(np.int64)), 1)
    np.testing.assert_array_equal(res["dist"].numpy(), np.concatenate([cnt.ravel(),
                                                                       cnt_m.ravel()]))
    assert int(res["flags"][0]) == (1 << 3 if (~ok).any() else 0)
    # arg words: the smallest row id at each group's extreme (-0.0 == 0.0)
    rids = fs.arg_rows(plan, res["args"]).numpy()
    order = xc_np[2].astype(np.float64)
    for g in range(G):
        idx = np.flatnonzero(key == g)
        if not len(idx):
            assert (rids[:, g] == -1).all()
            continue
        assert rids[0, g] == idx[np.argmin(order[idx])]
        assert rids[1, g] == idx[np.argmax(order[idx])]


def test_plain_folds_of_the_counts():
    """fold_dists: distinct count and sum per group; the mode's value, its
    count and how many values share it."""
    plan = fs.FusedPlan(where=None, keys=[], sums=[], mins=[], maxs=[], strides=[], n_groups=2,
                        dists=[([], 4, "dist"), ([], 4, "mode")])
    dist = torch.tensor([0, 3, 0, 1, 0, 0, 0, 0,   # dist: groups 0 and 1
                         5, 2, 5, 0, 0, 0, 9, 1], dtype=torch.int32)
    (dc, ds), (mv, mc, ties) = fs.fold_dists(plan, dist)
    assert dc.tolist() == [2, 0] and ds.tolist() == [4, 0]
    assert mv.tolist() == [0, 2] and mc.tolist() == [5, 9] and ties.tolist() == [2, 1]


@pytest.mark.parametrize("with_mlp", [False, True])
def test_packing_the_tail_keeps_the_mlp_blob_length(with_mlp):
    """K2 copies ``blob_floats`` floats of MLP weights into shared memory:
    the tail's descriptors must leave that length as the MLP weights give
    it (a plan whose DISTINCT counts start at element 66,048 once packed it
    as the blob's length, and the copy ran past shared memory)."""
    preds = []
    if with_mlp:
        params = [(np.ones((2, 8), np.float32), np.zeros(8, np.float32)),
                  (np.ones((8, 1), np.float32), np.zeros(1, np.float32))]
        preds = [fs.MlpSlot(params=params, final_softmax=False, out_col=0, bf16=False,
                            features=[[(fs.COL, 1)], [(fs.COL, 2)]])]
    plan = fs.FusedPlan(where=None, keys=[[(fs.COL, 0)]], sums=[], mins=[], maxs=[],
                        strides=[1], n_groups=64, preds=preds, ints=[(0, "sum"), (0, "max")],
                        dists=[([(fs.COL, 1)], 8, "dist"), ([(fs.COL, 2)], 512, "dist"),
                               ([(fs.COL, 2)], 512, "mode"), ([(fs.COL, 3)], 16, "dist")],
                        args=[([(fs.COL, 1)], True)])
    packed = fs.pack_plan(plan, "cpu")
    assert packed.blob_floats == packed.blob.numel() if with_mlp else packed.blob_floats == 0
    assert packed.blob_floats == fs._sizes(plan)[1]
    assert plan.dist_offsets == [0, 512, 33280, 66048, 67072]
    tail = packed.words[packed.words[fs.H_TAIL]:].tolist()
    assert tail == [0, 0, 0, 0, 0, 2, -1, 0, 8, 0, 0, 0, 512, 512, 0, 0, 512, 33280, 0, 0,
                    16, 66048, 0, 0, 1, 0, 0, 0]
