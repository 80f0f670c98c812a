"""Windows on the device, on the CPU: aggregates over a windowed subquery
fused into the torch program (``sql/window_fusion.py``,
``device_plan._Lowerer._lower_window``), and the opt-in device route of
``ops/window.py`` (``INFERA_WINDOW_DEVICE=1``).

Every case of ``tests/test_window_frames.py:200-360`` runs here through
both packages over the same catalog: the five fused queries take path
``device_plan`` on both, with ``infera_tpu``'s rows and the port's host
rows (a second Connection with the device tiers turned away) at
``rel=1e-6, abs=1e-6``; the ineligible shapes stay on the host; the device
route equals the host route at ``rel=1e-5`` and counts rows; an integer
running sum that could pass 2**24 leaves the route; a bad qualifier still
raises the Binder Error. Then: NaN in a partition key, an order key and a
window argument, held to the host (where ``infera_tpu``'s fused windows
disagree with its host: ROADMAP R15); K2 declines every windowed plan; the
segmented scan's bound; random windowed subqueries against the host."""

import math

import numpy as np
import pytest

import infera_tpu_torch as itt
from infera_tpu.columnar import Column as RefColumn
from infera_tpu.columnar import Table as RefTable
from infera_tpu.columnar import types as RT
from infera_tpu.sql import Connection as RefConnection
from infera_tpu_torch.columnar import Column, Table
from infera_tpu_torch.columnar import types as T
from infera_tpu_torch.errors import SqlError
from infera_tpu_torch.ops import fused_sql as fs
from infera_tpu_torch.ops import window as W
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_plan as dp
from infera_tpu_torch.sql import parser
from infera_tpu_torch.sql.window_fusion import flatten_windowed_scan
from infera_tpu_torch.testing import plan_fuzz

N = dp.MIN_DEVICE_ROWS * 2
# tests/test_window_frames.py:222-248
WT = (f"create table wt as select x % 8 as p, x % 5 as g, (x * 2654435761) % 9973 as k, "
      f"((x * 13) % 97)::float - 48.0 as v from range({N}) r(x)")
FUSED = [
    ("select g, avg(w) a, max(w) m from (select g, sum(v) over "
     "(partition by p order by k) as w from wt) sub group by g order by g"),
    ("select g, avg(r) s from (select g, rank() over (partition by p "
     "order by k) as r from wt) sub group by g order by g"),
    ("select count(*), avg(w) from (select min(v) over (partition by "
     "p order by k) as w, v from wt) sub where w < -20.0"),
    ("select g, avg(w) from (select g, avg(v) over (partition by p "
     "order by k rows between unbounded preceding and current row) "
     "as w from wt) sub group by g order by g"),
    ("select g, sum(w) from (select g, max(v) over (partition by p) "
     "as w from wt) sub group by g order by g"),
]


@pytest.fixture()
def both(monkeypatch):
    """Both packages on the CPU over the same ``wt``; K2 off."""
    monkeypatch.delenv("INFERA_PALLAS_SQL", raising=False)
    monkeypatch.delenv("INFERA_WINDOW_DEVICE", raising=False)
    itt.set_device("cpu")
    port, ref = Connection(), RefConnection()
    for conn in (port, ref):
        conn.execute(WT)
    yield port, ref
    itt.set_device(None)


def _host_rows(conn, q, monkeypatch):
    host = Connection(conn.catalog)
    with monkeypatch.context() as m:
        m.setattr(dp, "try_execute_on_device", lambda *a, **k: None)
        rows = host.execute(q).rows
    assert host._exec_path == "host"
    return rows


def _close(rows, want, rel=1e-6, abs_=1e-6):
    assert len(rows) == len(want), (rows, want)
    for a, b in zip(rows, want):
        for x, y in zip(a, b, strict=True):
            if isinstance(y, float) and x is not None:
                assert x == pytest.approx(y, rel=rel, abs=abs_, nan_ok=True), (a, b)
            else:
                assert x == y, (a, b)


@pytest.mark.parametrize("i", range(len(FUSED)))
def test_windowed_subquery_fuses_into_the_program(both, monkeypatch, i):
    port, ref = both
    q = FUSED[i]
    rows = port.execute(q).rows
    assert port._exec_path == "device_plan"
    assert "window computed in-program" in "\n".join(
        r[0] for r in port.execute("explain " + q).rows)
    ref_rows = ref.execute(q).rows
    assert ref._exec_path == "device_plan"
    _close(rows, ref_rows)
    _close(rows, _host_rows(port, q, monkeypatch))


def test_one_sort_per_distinct_window_and_no_materialized_subquery(both, monkeypatch):
    """The fused plan reads ``w`` in two aggregates and computes it once;
    the subquery is never materialized on the host."""
    port, _ = both
    calls = {"window": 0}
    run = W.window_device

    def counted(*a, **k):
        calls["window"] += 1
        return run(*a, **k)

    monkeypatch.setattr(dp, "window_device", counted)
    monkeypatch.setattr(Connection, "_project", lambda *a, **k: pytest.fail("materialized"))
    port.execute(FUSED[0])
    assert calls["window"] == 1 and port._exec_path == "device_plan"


def test_ineligible_windowed_subqueries_stay_on_the_host(both, monkeypatch):
    """tests/test_window_frames.py:251-290: a sliding frame (the window on
    the host, the outer aggregate over the materialized subquery), a bare
    window output, and SUM over a ranking window (BIGINT: the exact int64
    slots over the materialized subquery)."""
    port, ref = both
    for conn in (port, ref):
        conn.execute(f"create table wh as select x % 4 as p, x as k, (x % 50)::float as v "
                     f"from range({N}) r(x)")
    q = ("select avg(w) from (select sum(v) over (partition by p order by k rows between "
         "2 preceding and current row) as w from wh) sub")
    rows = port.execute(q).rows
    assert rows[0][0] == pytest.approx(_host_rows(port, q, monkeypatch)[0][0], rel=1e-9)
    assert rows[0][0] == pytest.approx(ref.execute(q).rows[0][0], rel=1e-9)
    for conn in (port, ref):
        conn.execute("select w from (select sum(v) over (order by k) as w from wh) sub limit 5")
        assert conn._exec_path == "host"
    q = "select sum(r) from (select rank() over (order by k) as r from wh) sub"
    assert port.execute(q).rows == ref.execute(q).rows == [(N * (N + 1) // 2,)]
    assert isinstance(port.execute(q).rows[0][0], int)
    assert flatten_windowed_scan(parser.parse_sql(q)[0]) is not None
    assert "window computed in-program" not in "\n".join(
        r[0] for r in port.execute("explain " + q).rows)


def test_flattening_preserves_binder_errors(both):
    """tests/test_window_frames.py:348-360: a qualifier that is not valid
    through the subquery boundary raises on the port too."""
    port, _ = both
    port.execute(f"create table wq as select x % 4 as p, x as k, (x % 9)::float as v "
                 f"from range({N}) r(x)")
    with pytest.raises(SqlError, match="Referenced column"):
        port.execute("select avg(wq.v) from (select sum(v) over "
                     "(partition by p order by k) as w from wq) sub")


# --------------------------------------------------------------------------- the device route

ROUTE_QUERIES = [
    "select sum(v) over (partition by p order by k) s from dt",
    "select rank() over (partition by p order by k) r from dt",
    "select row_number() over (order by k) r from dt",
]


@pytest.fixture()
def route(monkeypatch):
    """tests/test_window_frames.py:293-345's table on the port, the route's
    threshold lowered to 2**10 rows, window_device counted."""
    monkeypatch.setattr(W, "DEVICE_WINDOW_MIN_ROWS", 1 << 10)
    itt.set_device("cpu")
    calls = {"n": 0}
    run = W.window_device

    def counted(*a, **k):
        calls["n"] += 1
        return run(*a, **k)

    monkeypatch.setattr(W, "window_device", counted)
    c = Connection()
    n = 1 << 12
    c.execute(f"create table dt as select x % 16 as p, (x * 2654435761) % 9973 as k, "
              f"(x % 97)::float as v from range({n}) r(x)")
    yield c, calls
    itt.set_device(None)


@pytest.mark.parametrize("q", ROUTE_QUERIES)
def test_device_route_matches_host(route, monkeypatch, q):
    c, calls = route
    monkeypatch.setenv("INFERA_WINDOW_DEVICE", "1")
    dev = c.execute(q).rows
    assert calls["n"] == 1
    monkeypatch.setenv("INFERA_WINDOW_DEVICE", "0")
    host = c.execute(q).rows
    assert calls["n"] == 1 and W.window_device_enabled() is False
    for a, b in zip(dev, host, strict=True):
        assert a[0] == pytest.approx(b[0], rel=1e-5) and type(a[0]) is type(b[0])


def test_device_route_count_is_row_count(route, monkeypatch):
    c, calls = route
    c.execute(f"create table dc as select x % 8 as p, x as k, (x % 97)::float as v "
              f"from range({1 << 12}) r(x)")
    q = "select count(v) over (partition by p order by k) c from dc"
    monkeypatch.setenv("INFERA_WINDOW_DEVICE", "1")
    dev = c.execute(q).rows
    assert calls["n"] == 1
    monkeypatch.setenv("INFERA_WINDOW_DEVICE", "0")
    assert [r[0] for r in dev] == [r[0] for r in c.execute(q).rows]


def test_device_route_int_sum_overflow_falls_back(route, monkeypatch):
    """tests/test_window_frames.py:200-217: an integer running SUM whose
    magnitude can pass 2^24 leaves the route for the host's exact BIGINT."""
    c, calls = route
    monkeypatch.setenv("INFERA_WINDOW_DEVICE", "1")
    n, big = 1 << 12, 1 << 20
    c.execute(f"create table ov as select x as k, {big} + x as v from range({n}) r(x)")
    rows = c.execute("select sum(v) over (order by k) s from ov order by k").rows
    assert calls["n"] == 0
    run = 0
    for i, (s,) in enumerate(rows):
        run += big + i
        assert s == run


def test_device_route_leaves_non_finite_arguments_to_the_host(route, monkeypatch):
    """A NaN in a float argument: the host's prefix sums carry it into every
    later partition (R15); the route declines and the rows are the host's."""
    c, calls = route
    x = np.arange(1 << 12)
    v = (x % 97).astype(np.float64)
    v[5] = np.nan
    c.register_table("dn", Table({"p": Column(x % 16, T.BIGINT), "k": Column(x, T.BIGINT),
                                  "v": Column(v, T.DOUBLE)}))
    q = "select sum(v) over (partition by p order by k) s from dn"
    monkeypatch.setenv("INFERA_WINDOW_DEVICE", "1")
    dev = c.execute(q).rows
    assert calls["n"] == 0
    monkeypatch.setenv("INFERA_WINDOW_DEVICE", "0")
    _close(dev, c.execute(q).rows, rel=0, abs_=0)


# --------------------------------------------------------------------------- NaN, held to the host

def _nan_tables(conn, table_cls, col_cls, types):
    x = np.arange(N)
    pk = (x % 8).astype(np.float64)
    pk[x % 97 == 5] = np.nan
    ok = ((x * 2654435761) % 9973).astype(np.float64)
    ok[x % 89 == 3] = np.nan
    v = ((x * 13) % 97).astype(np.float64) - 48
    vn = v.copy()
    vn[x % 1000 == 7] = np.nan
    v1 = v.copy()
    v1[8] = np.nan   # one NaN, in partition 0
    cols = {"p": pk, "k": ok, "v": v, "vn": vn, "v1": v1}
    tab = {name: col_cls(a, types.DOUBLE) for name, a in cols.items()}
    for name, a in (("g", x % 5), ("pi", x % 8), ("ki", (x * 2654435761) % 9973)):
        tab[name] = col_cls(a.astype(np.int64), types.BIGINT)
    conn.register_table("nt", table_cls(tab))


NAN_CASES = {
    "partition_key": "select g, avg(w), max(w), count(*) from (select g, sum(v) over "
                     "(partition by p order by ki) as w from nt) sub group by g order by g",
    "partition_key_rank": "select g, avg(w) from (select g, rank() over (partition by p "
                          "order by ki) as w from nt) sub group by g order by g",
    "order_key": "select g, avg(w), max(w) from (select g, sum(v) over (partition by pi "
                 "order by k) as w from nt) sub group by g order by g",
    "order_key_desc_rank": "select g, avg(w) from (select g, rank() over (partition by pi "
                           "order by k desc) as w from nt) sub group by g order by g",
    "argument_sum": "select g, avg(w) from (select g, sum(vn) over (partition by pi "
                    "order by ki) as w from nt) sub group by g order by g",
    "argument_max": "select g, avg(w), count(w) from (select g, max(vn) over (partition by "
                    "pi order by ki) as w from nt) sub group by g order by g",
    "argument_sum_one_partition": "select pi, avg(w), min(w) from (select pi, sum(v1) over "
                                  "(partition by pi order by ki) as w from nt) sub "
                                  "group by pi order by pi",
}


@pytest.mark.parametrize("name", list(NAN_CASES))
def test_nan_keys_and_arguments_are_held_to_the_host(both, monkeypatch, name):
    """NaN keys: each NaN row is its own partition or peer on the host and
    in the program (``!=``), and the rows agree. A NaN argument: the host
    renders a NaN minimum or maximum NULL and carries a NaN prefix sum into
    later partitions; the program trips on a window value that is not
    finite, and the outer aggregate runs over the host's materialized
    subquery, so the rows are the host's."""
    port, ref = both
    _nan_tables(port, Table, Column, T)
    _nan_tables(ref, RefTable, RefColumn, RT)
    q = NAN_CASES[name]
    tripped = {"n": 0}
    run = dp._run_window

    def watched(cols, *a):
        out = run(cols, *a)
        tripped["n"] += int(any(bool(t) for t in cols.get("__trip__", ())))
        return out

    monkeypatch.setattr(dp, "_run_window", watched)
    rows = port.execute(q).rows
    _close(rows, _host_rows(port, q, monkeypatch), rel=1e-6)
    assert bool(tripped["n"]) == name.startswith("argument")
    if name == "argument_sum_one_partition":
        # R15: infera_tpu's fused window keeps the NaN in partition 0; its
        # host makes every later partition NaN, as the port answers
        ref_rows = ref.execute(q).rows
        assert ref._exec_path == "device_plan" and math.isfinite(ref_rows[1][1])
        assert all(math.isnan(r[1]) for r in rows)


# --------------------------------------------------------------------------- K2 and the scan

def test_k2_declines_every_windowed_plan(both, monkeypatch):
    """``_kernel_lowers`` and K2's lowering decline a window; with K2 on
    the program runs every windowed plan and K2 runs none (its probes of a
    plain group key excepted)."""
    port, _ = both
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    plans = {"n": 0}
    execute = fs.execute_fused_plan

    def counted(*a, **k):
        plans["n"] += 1
        return execute(*a, **k)

    monkeypatch.setattr(fs, "execute_fused_plan", counted)
    for q in FUSED:
        port.execute(q)
        assert port._exec_path == "device_plan"
    assert plans["n"] == 0
    table = port.catalog.get("wt")
    flat = flatten_windowed_scan(parser.parse_sql(FUSED[0])[0])
    lowerer = dp._Lowerer(table, "cpu")
    plans_ = [("key", 0), ("avg", lowerer.lower(flat.items[1].expr.args[0])),
              ("max", lowerer.lower(flat.items[2].expr.args[0]))]
    nodes = [None, flat.items[1].expr, flat.items[2].expr]
    assert dp._kernel_lowers(table, flat, plans_, nodes) is False
    assert dp.try_execute_on_device(port, flat, table, analyze_only=True) == "torch program"
    # the same query over a plain column: K2 takes it
    port.execute("select g, avg(v) from wt group by g")
    assert port._exec_path == "device_plan_cuda" and plans["n"] == 1


@pytest.mark.parametrize("m", [1, 7, 1000, 4097])
def test_segmented_f64_scan_is_within_its_bound(m):
    """``_seg_scan`` over segments of ``m`` rows: every running sum within
    ceil(log2 m) * 2**-53 * (sum of |v| so far) of the exact sum
    (``math.fsum``), with no term from earlier segments."""
    import torch

    rng = np.random.default_rng(m)
    n = 3 * m + 5
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 8, n)
    heads = np.zeros(n, bool)
    heads[[0, m, 2 * m + 3]] = True
    got = W._seg_scan(torch.from_numpy(v), torch.from_numpy(heads), torch.add).numpy()
    start = 0
    for i in range(n):
        if heads[i]:
            start = i
        seg = v[start:i + 1]
        bound = math.ceil(math.log2(max(len(seg), 2))) * 2.0 ** -53 * np.abs(seg).sum()
        assert abs(got[i] - math.fsum(seg)) <= bound


@pytest.mark.parametrize("seed,kernel", [(0, "0"), (1, "1")])
def test_random_windowed_subqueries_equal_the_host(monkeypatch, seed, kernel):
    """testing/plan_fuzz's random windowed subqueries (every window the
    program computes, its three frames, 0–2 partition keys)."""
    monkeypatch.setenv("INFERA_PALLAS_SQL", kernel)
    itt.set_device("cpu")
    try:
        res = plan_fuzz.run_seed(seed, 20000, 30, "window")
    finally:
        itt.set_device(None)
    assert not res["mismatches"], res["mismatches"]
    assert res["paths"].get("device_plan", 0) > 0


@pytest.mark.parametrize("seed,kernel", [(0, "0"), (1, "1")])
def test_random_joins_equal_the_host(monkeypatch, seed, kernel):
    """testing/plan_fuzz's random fact→dim joins (inner, left, full; 1–3
    aggregates; 8 to 4,096 groups) through K5's plain version and the
    program, or the program alone."""
    monkeypatch.setenv("INFERA_PALLAS_SQL", kernel)
    itt.set_device("cpu")
    try:
        res = plan_fuzz.run_seed(seed, 20000, 30, "join")
    finally:
        itt.set_device(None)
    assert not res["mismatches"], res["mismatches"]
    assert res["paths"].get("device_join_plan", 0) > 0
    assert (res["paths"].get("device_join_plan_cuda", 0) > 0) == (kernel == "1")
