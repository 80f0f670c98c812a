"""The torch join program (``device_join_plan``) on the CPU: ``infera_tpu``'s
XLA join program as eager torch ops, between kernel K5 and the host.

With ``INFERA_PALLAS_SQL`` unset on the CPU, K5 is off and every fact→dim
join the tier takes runs the program, as ``infera_tpu`` on the CPU runs its
XLA join program. The same catalog and seeded data go through both
packages: every join case of ``tests/test_device_plan.py`` and the random
joins of ``tests/test_path_equivalence.py`` take ``infera_tpu``'s path
(``device_join_plan``, or the host where the tier declines) with its rows
and the port's host rows (a second Connection with both device tiers
turned away), at those tests' tolerances: counts, keys, minima and maxima
exact, sums and averages rel 1e-5. With K5 on (``INFERA_PALLAS_SQL=1``,
its plain version here) the plans K5 declines — more than 512 groups, an
integer past 2**24, more than 64 block rows — run the program, as they run
``infera_tpu``'s XLA program."""

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
from infera_tpu_torch.registry import MODELS as PORT_MODELS
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_join_plan as djp
from infera_tpu_torch.sql import device_plan as dp

N = dp.MIN_DEVICE_ROWS * 2
PROGRAM = "device_join_plan"
HOST = "device_join"   # the host executor's join over 2**14 rows: the device sort-join

# tests/test_device_plan.py's join tables (:219-340, 514-720)
TABLES = [
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
    "create table fdim as select x as k, (x * 2)::float as w from range(200) r(x)",
    f"create table ffact as select x % 120 as k, (x % 10)::float as v from range({N}) r(x)",
    "create table gdim as select x as k, (x * 2)::float as w from range(200) r(x)",
    f"create table gfact as select x % 120 as k, x % 3 as g, (x % 10)::float as v "
    f"from range({N}) r(x)",
    "create table wdim as select x as k, (x * 2)::float as w from range(200) r(x)",
    f"create table wfact as select x % 120 as k, (x % 10)::float as v from range({N}) r(x)",
    # plans K5 declines and infera_tpu's XLA program runs: 4,096 groups, a
    # fact key past 2**24 on a third of the rows (none of which match)
    f"create table bfact as select x % 150 as k, x % 4096 as g, (x % 40)::float / 4.0 as v "
    f"from range({N}) r(x)",
    f"create table kfact as select case when x % 3 = 0 then 20000000 + x else x % 150 end as k, "
    f"x % 5 as g, (x % 10)::float as v from range({N}) r(x)",
]
# more than 64 block rows: 70 fact columns in one sum (tests/test_pallas_sql.py's
# PALLAS_MAX_COLS)
WIDE = 70


def _wide_tables(conn, table_cls, col_cls, types):
    x = np.arange(N)
    cols = {"k": col_cls((x % 150).astype(np.int64), types.BIGINT),
            "g": col_cls((x % 4).astype(np.int64), types.BIGINT)}
    for i in range(WIDE):
        cols[f"c{i}"] = col_cls(((x * (i + 1)) % 17).astype(np.float32) / 4, types.FLOAT)
    conn.register_table("wide", table_cls(cols))


@pytest.fixture(scope="module")
def both(model_dir):
    """Both packages on the CPU over the same tables, the linear model
    loaded into both registries from one file."""
    from infera_tpu.registry import MODELS as REF_MODELS

    itt.set_device("cpu")
    PORT_MODELS.clear()
    REF_MODELS.clear()
    port, ref = Connection(), RefConnection()
    for conn in (port, ref):
        for stmt in TABLES:
            conn.execute(stmt)
    _wide_tables(port, Table, Column, T)
    _wide_tables(ref, RefTable, RefColumn, RT)
    it.load_model("linear", f"{model_dir}/linear.onnx")
    itt.load_model("linear", f"{model_dir}/linear.onnx")
    yield port, ref
    PORT_MODELS.clear()
    REF_MODELS.clear()
    itt.set_device(None)


def _host_rows(port, q, monkeypatch):
    """The port's host executor's rows over the same catalog."""
    host = Connection(port.catalog)
    with monkeypatch.context() as m:
        m.setattr(dp, "try_execute_on_device", lambda *a, **k: None)
        m.setattr(djp, "try_execute_join_on_device", lambda *a, **k: None)
        rows = host.execute(q).rows
    assert host._exec_path in ("host", "device_join")
    return rows


def _close(rows, want, rel=1e-5):
    assert len(rows) == len(want), (rows, want)
    for a, b in zip(rows, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=rel, abs=1e-9), (a, b)
            else:
                assert x == y, (a, b)


def _check(both, q, monkeypatch, path=PROGRAM, kernel=None):
    """q through both packages (``INFERA_PALLAS_SQL`` = ``kernel``, unset by
    default: K5 off here): the port's path is ``path`` and infera_tpu's the
    same; rows equal infera_tpu's and the port's host rows."""
    port, ref = both
    if kernel is None:
        monkeypatch.delenv("INFERA_PALLAS_SQL", raising=False)
    else:
        monkeypatch.setenv("INFERA_PALLAS_SQL", kernel)
    rows = port.execute(q).rows
    assert port._exec_path == path, (q, port._exec_path)
    ref_rows = ref.execute(q).rows
    assert ref._exec_path == path, (q, ref._exec_path)
    _close(rows, ref_rows)
    _close(rows, _host_rows(port, q, monkeypatch))
    return rows


CASES = {
    "inner_grouped_predict": ("select cat, count(*) c, sum(w) sw, "
                              "avg(infera_predict('linear', f1, f2, f3)) p from fact join dim "
                              "on fact.k = dim.k group by cat order by cat", PROGRAM),
    "partial_match_where": ("select count(*), sum(w), max(f) from fact2 join dim2 "
                            "on fact2.k = dim2.k where f < 5.0", PROGRAM),
    "duplicate_dim_keys": ("select count(*) from factd join dup on factd.k = dup.k", HOST),
    "fact_keys_beyond_int32": ("select count(*) from factk join dimk on factk.k = dimk.k",
                               HOST),
    "left_all_aggs": ("select g, count(*) c, count(w) cw, sum(v) sv, sum(w) sw, avg(w) aw, "
                      "min(w) mnw, max(w) mxw, sum(coalesce(w, -1.0)) sc from lfact left join "
                      "ldim on lfact.k = ldim.k group by g order by g", PROGRAM),
    "right_fact_on_right": ("select count(*) c, count(w) cw from rdim right join rfact "
                            "on rdim.k = rfact.k", PROGRAM),
    "outer_where_dim": ("select count(*) from rfact left join rdim on rfact.k = rdim.k "
                        "where w > 10", HOST),
    "full_global": ("select count(*) c, count(w) cw, count(v) cv, sum(v) sv, sum(w) sw, "
                    "min(w) mnw, max(w) mxw from ffact full join fdim on ffact.k = fdim.k",
                    PROGRAM),
    "full_group_by": ("select g, count(*) c, count(w) cw, sum(w) sw, min(w) mnw from gfact "
                      "full join gdim on gfact.k = gdim.k group by g order by g", PROGRAM),
    "full_where_fact": ("select count(*) c, count(w) cw from wfact full join wdim "
                        "on wfact.k = wdim.k where v < 5", PROGRAM),
    "full_where_coalesce": ("select count(*) c from wfact full join wdim on wfact.k = wdim.k "
                            "where coalesce(v, 99.0) >= 5", PROGRAM),
}


@pytest.mark.parametrize("name", list(CASES))
def test_reference_join_cases_with_k5_off(both, monkeypatch, name):
    q, path = CASES[name]
    _check(both, q, monkeypatch, path)


def test_inner_join_with_predict_against_numpy(both, monkeypatch):
    """tests/test_device_plan.py:219-250 on the program, by hand."""
    rows = _check(both, CASES["inner_grouped_predict"][0], monkeypatch)
    x = np.arange(N)
    k = x % 100
    f1 = (x % 40).astype(np.float32) / np.float32(4.0)
    f2 = ((x + 5) % 30).astype(np.float32) / np.float32(3.0)
    f3 = ((x * 3) % 20).astype(np.float32) / np.float32(2.0)
    pred = (2 * f1 - f2 + 0.5 * f3 + np.float32(0.25)).astype(np.float64)
    w = (k * 2).astype(np.float64)
    for kc, c, sw, p in rows:
        m = k % 3 == kc
        assert c == int(m.sum())
        assert sw == pytest.approx(float(w[m].sum()), rel=1e-6)
        assert p == pytest.approx(float(pred[m].mean()), rel=1e-5)


def test_full_join_phantom_group_is_appended(both, monkeypatch):
    rows = _check(both, CASES["full_group_by"][0], monkeypatch)
    null_row = [r for r in rows if r[0] is None][0]
    assert null_row[1:3] == (80, 80)
    assert null_row[3] == pytest.approx(sum(i * 2.0 for i in range(120, 200)))
    assert null_row[4] == 240.0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["inner", "left"])
def test_random_joins_of_path_equivalence(both, monkeypatch, seed, kind):
    """tests/test_path_equivalence.py's random joins (its seeds, sizes and
    query) through both packages."""
    rng = np.random.default_rng(seed + 10)
    n = 1 << 15
    dim_n = int(rng.integers(20, 400))
    span = int(dim_n * float(rng.uniform(1.0, 2.0)))
    port, ref = both
    for conn in (port, ref):
        conn.execute(f"create or replace table pjf as select x % {span} as k, "
                     f"(x % 30)::float as v, x % 5 as g from range({n}) r(x)")
        conn.execute(f"create or replace table pjd as select x as k, (x * 3)::float as w "
                     f"from range({dim_n}) r(x)")
    _check(both, f"select g, count(*) c, count(w) cw, sum(v) sv, sum(w) sw, min(w) mn, "
                 f"max(w) mx, sum(coalesce(w, -2.0)) sc from pjf {kind} join pjd "
                 f"on pjf.k = pjd.k group by g order by g", monkeypatch)


K5_DECLINES = {
    # more than 512 groups (ops/fused_sql.MAX_GROUPS)
    "groups_past_512": "select g, count(*), sum(w), max(v) from bfact join ldim "
                       "on bfact.k = ldim.k group by g order by g",
    "groups_past_512_left": "select g, count(w), avg(w), min(w) from bfact left join ldim "
                            "on bfact.k = ldim.k group by g order by g",
    # an integer column past 2**24: the fact key, read exactly from the int64 block
    "int_past_2_24": "select g, count(*), sum(w), min(v) from kfact join ldim "
                     "on kfact.k = ldim.k group by g order by g",
    "int_past_2_24_left": "select g, count(*), count(w), sum(coalesce(w, 0.5)) from kfact "
                          "left join ldim on kfact.k = ldim.k group by g order by g",
    # more than 64 block rows
    "block_rows_past_64": "select g, count(*), sum(" + " + ".join(f"c{i}" for i in range(WIDE))
                          + " + w) from wide join ldim on wide.k = ldim.k group by g order by g",
}


@pytest.mark.parametrize("name", list(K5_DECLINES))
def test_plans_k5_declines_run_the_program(both, monkeypatch, name):
    q = K5_DECLINES[name]
    port, _ = both
    port._device_plan_cache = {}
    rows = _check(both, q, monkeypatch, kernel="1")
    assert not port._device_plan_cache  # K5 packed no plan
    assert len(rows) > 1
    if name == "int_past_2_24":
        # a third of the rows hold keys past 2**24, which no dim row holds
        x = np.arange(N)
        assert sum(r[1] for r in rows) == int((x % 3 != 0).sum() - ((x % 3 != 0)
                                                                     & (x % 150 >= 100)).sum())


def test_k5_first_then_the_program_then_the_host(both, monkeypatch):
    """infera_tpu's tier order: K5 runs the plans it takes (its path), the
    program those it declines; a key guard that trips after K5 ran sends the
    query to the host, not to the program (same bucketing)."""
    port, _ = both
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    port.execute(CASES["left_all_aggs"][0])
    assert port._exec_path == "device_join_plan_cuda"
    port.execute(K5_DECLINES["groups_past_512"])
    assert port._exec_path == PROGRAM
    runs = {"program": 0}
    build = djp._build_program

    def counted(*a, **k):
        prog = build(*a, **k)

        def run(cols):
            runs["program"] += 1
            return prog(cols)
        return run

    monkeypatch.setattr(djp, "_build_program", counted)
    port._device_program_cache = {}
    port.execute("create or replace table fracf as select x % 100 as k, "
                 f"(x % 4)::float / 2.0 as h from range({N}) r(x)")
    q = "select h, count(*), sum(w) from fracf join ldim on fracf.k = ldim.k group by h order by h"
    rows = port.execute(q).rows
    assert port._exec_path == HOST and runs["program"] == 0
    _close(rows, _host_rows(port, q, monkeypatch))
    monkeypatch.delenv("INFERA_PALLAS_SQL")
    assert port.execute(q).rows == rows and port._exec_path == HOST
    assert runs["program"] == 1  # the program ran, and its fractional-key flag tripped


def test_explain_names_the_tier_that_runs(both, monkeypatch):
    port, _ = both

    def explain(q):
        return "\n".join(r[0] for r in port.execute("explain " + q).rows)

    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    assert "(kernel K5)" in explain(CASES["full_global"][0])
    for q in K5_DECLINES.values():
        assert "(torch join program)" in explain(q)
    monkeypatch.delenv("INFERA_PALLAS_SQL")
    assert "(torch join program)" in explain(CASES["full_global"][0])
    assert "host/hybrid" in explain(CASES["duplicate_dim_keys"][0])


def test_program_cache_phases_and_gathers(both, monkeypatch):
    """The program is cached by plan key with the blocks and lookup it
    reads; the phases are the tier's; an outer join's matched-validity sum
    drops the unmatched rows that read dim row 0."""
    port, _ = both
    monkeypatch.delenv("INFERA_PALLAS_SQL", raising=False)
    port._device_program_cache = {}
    q = CASES["full_global"][0]
    port.execute(q)
    port.execute(q)
    assert len(port._device_program_cache) == 1
    (xc, dim_xc, lookup, _prog), = port._device_program_cache.values()
    assert tuple(dim_xc.shape) == (2, 200) and len(lookup) == 200
    assert set(port._last_phases) == {"plan_ms", "upload_ms", "exec_ms", "assemble_ms",
                                      "phantom_ms"}
    assert port._exec_path == PROGRAM


def _nan_dim_tables(conn, table_cls, col_cls, types):
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
    """An unmatched row gathers dim row 0 (NaN here); the matched-validity
    slots drop it, and coalesce selects past it."""
    port, ref = both
    _nan_dim_tables(port, Table, Column, T)
    _nan_dim_tables(ref, RefTable, RefColumn, RT)
    q = ("select g, count(*), count(w), sum(w), avg(w), min(w), max(w), "
         "sum(coalesce(w, -1.0)), sum(v) from nfact left join ndim on nfact.k = ndim.k "
         "group by g order by g")
    rows = _check(both, q, monkeypatch)
    assert all(np.isfinite(r[3]) and np.isfinite(r[7]) for r in rows)
