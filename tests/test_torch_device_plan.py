"""The torch program (``device_plan``) on the CPU: ``infera_tpu``'s fused XLA
program as eager torch ops, between kernel K2 and the host executor.

Every single-table test of ``tests/test_device_plan.py`` and the
single-device cases of ``tests/test_agg_tail_device.py`` run here on the
port, with ``INFERA_PALLAS_SQL`` unset (on the CPU: K2 off, the program
on). The same catalog and seeded data go through both packages; each query
takes the path ``infera_tpu`` takes (``device_plan``, or the host where a
guard trips) and its rows equal ``infera_tpu``'s and the port's host rows
(a second Connection with the device plan turned away, as
``tests/test_agg_tail_device.py:20-27``) at the reference test's tolerance.
Then: the routing between the tiers; the reference's faults (R10, R12,
R13) held to the host; F6 and the device ORDER BY; R2 in a fresh
interpreter; the device hashes and the int_agg helpers against
``infera_tpu``'s."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import infera_tpu as it
import infera_tpu_torch as itt
from infera_tpu.sql import Connection as RefConnection
from infera_tpu_torch.columnar import Column, Table
from infera_tpu_torch.columnar import types as T
from infera_tpu_torch.onnx import builder, proto
from infera_tpu_torch.ops import hashing as H
from infera_tpu_torch.ops import sort as port_sort
from infera_tpu_torch.registry import MODELS as PORT_MODELS
from infera_tpu_torch.testing import plan_fuzz
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_plan as dp
from infera_tpu_torch.sql import int_agg

N = dp.MIN_DEVICE_ROWS * 2
# tests/test_device_plan.py's conn_big table
BIG = (f"create table big as select x % 7 as g, (x % 100)::float / 10.0 as f1, "
       f"((x + 3) % 50)::float / 5.0 as f2, ((x * 7) % 30)::float / 3.0 as f3 "
       f"from range({N}) r(x)")
# tests/test_agg_tail_device.py's table
TAIL = (f"create table t as select x % 5 as g, (x % 40)::float / 4.0 - 3.0 as v, "
        f"(x % 7) as iv, ((x * 13) % 101)::float as hv from range({N}) r(x)")


@pytest.fixture()
def both(clean_registry, model_dir, monkeypatch):
    """Both packages on the CPU over the same tables, the reference models
    loaded into both registries from the same files, K2 off."""
    monkeypatch.delenv("INFERA_PALLAS_SQL", raising=False)
    itt.set_device("cpu")
    PORT_MODELS.clear()
    port, ref = Connection(), RefConnection()
    for conn in (port, ref):
        conn.execute(BIG)
        conn.execute(TAIL)
    for name, file in (("linear", "linear.onnx"), ("multi", "multi_output.onnx")):
        it.load_model(name, f"{model_dir}/{file}")
        itt.load_model(name, f"{model_dir}/{file}")
    yield port, ref
    PORT_MODELS.clear()
    itt.set_device(None)


def _host_rows(port, q, monkeypatch):
    """The port's host executor's rows over the same catalog."""
    host = Connection(port.catalog)
    with monkeypatch.context() as m:
        m.setattr(dp, "try_execute_on_device", lambda *a, **k: None)
        rows = host.execute(q).rows
    assert host._exec_path == "host"
    return rows


def _close(rows, want, rel, abs_=1e-9):
    assert len(rows) == len(want), (rows, want)
    for a, b in zip(rows, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(y, float) and not isinstance(x, (bool, str)) and x is not None:
                assert x == pytest.approx(y, rel=rel, abs=abs_, nan_ok=True), (a, b)
            else:
                assert x == y, (a, b)


def _check(port, ref, q, path, monkeypatch, rel=1e-6, abs_=1e-9):
    """The query through both packages: the port's path is ``path`` and
    infera_tpu's is the same; rows equal infera_tpu's and the port's host
    rows."""
    rows = port.execute(q).rows
    assert port._exec_path == path, q
    ref_rows = ref.execute(q).rows
    assert ref._exec_path == path, (q, ref._exec_path)
    _close(rows, ref_rows, rel, abs_)
    _close(rows, _host_rows(port, q, monkeypatch), rel, abs_)
    return rows


DP, HOST = "device_plan", "host"
# reference test -> (tables to create, [(query, path, rel, abs)])
CASES = {
    "test_fused_global_aggregate_with_predict": ([], [
        ("select count(*), avg(infera_predict('linear', f1, f2, f3)), sum(f1) from big",
         DP, 1e-4, 1e-9)]),
    "test_fused_filtered_groupby_predict": ([], [
        ("select g, count(*) c, avg(infera_predict('linear', f1, f2, f3)) p "
         "from big where f1 > 5.0 group by g order by g", DP, 1e-4, 1e-9)]),
    "test_fused_min_max": ([], [
        ("select min(f2), max(f3) from big where g = 3", DP, 1e-6, 1e-9)]),
    "test_integer_sum_exact": ([], [("select sum(g) from big", DP, 0, 0)]),
    "test_small_tables_stay_on_host": (
        ["create table small as select 1.0::float f1 from range(10) r(x)"],
        [("select count(*), sum(f1) from small", HOST, 0, 0)]),
    "test_fused_multikey_groupby": (
        [f"create table mk as select x % 5 as g, x % 3 as h, (x % 100)::float / 10.0 as f1 "
         f"from range({N}) r(x)"],
        [("select g, h, count(*) c, avg(f1) a from mk group by g, h order by g, h",
          DP, 1e-4, 1e-9)]),
    "test_fused_multikey_three_keys_with_predict": (
        [f"create table mk3 as select x % 4 as a, x % 2 as b, (x % 32 - x % 8) / 8 as c, "
         f"(x % 100)::float / 10.0 as f1, ((x + 3) % 50)::float / 5.0 as f2, "
         f"((x * 7) % 30)::float / 3.0 as f3 from range({N}) r(x)"],
        [("select g, count(*), avg(infera_predict('linear', f1, f2, f3)) "
          "from big where f2 < 8.0 group by g order by g", DP, 1e-4, 1e-9),
         ("select a, b, c, count(*), avg(infera_predict('linear', f1, f2, f3)) "
          "from mk3 group by a, b, c order by a, b, c", DP, 1e-4, 1e-9)]),
    "test_fused_predict_multi_list_element": ([], [
        ("select avg(infera_predict_multi_list('multi', f1, f2, f3, f1)[2]), count(*) from big",
         DP, 1e-4, 1e-9)]),
    "test_fractional_key_falls_back_to_host": (
        [f"create table fk as select (x % 2)::float + 0.2 + (x % 4) / 2 * 0.5 as g, "
         f"(x % 10)::float as f1 from range({N}) r(x)"],
        [("select g, count(*) from fk group by g order by g", HOST, 0, 1e-6)]),
    "test_fused_having": ([], [
        ("select g, count(*) c from big group by g having avg(f1) > 4.9 and count(*) > 10 "
         "order by g", DP, 0, 0),
        ("select count(*) from big having count(*) < 0", DP, 0, 0),
        ("select g, count(*) from big group by g having g >= 5 order by g", HOST, 0, 0)]),
    "test_groupby_int64_keys_beyond_int32_host_path": (
        [f"create table bigg as select case when x % 2 = 0 then {1 << 32} else 0 end as g2 "
         f"from range({N}) r(x)"],
        [("select g2, count(*) from bigg group by g2 order by g2", HOST, 0, 0)]),
    "test_fused_int_sum_exact_single_device": (
        [f"create table widesd as select x % 3 as g, {(1 << 41) + 1} + x as v, "
         f"-{(1 << 41) + 1} - 3 * x as nv from range({N}) r(x)"],
        [("select g, sum(v), avg(v), min(v), max(v), sum(nv), max(nv) from widesd "
          "group by g order by g", DP, 1e-12, 0)]),
    "test_fused_stddev_variance_single_device": ([], [
        ("select g, stddev(f1), var_pop(f2), stddev_pop(f3) from big group by g order by g",
         DP, 1e-3, 1e-9)]),
    "test_fused_stddev_single_row_group_falls_back": (
        [f"create table onerow as select x as g, x::float as f from range({N}) r(x)"],
        [("select g, stddev(f) from onerow group by g order by g limit 3", HOST, 0, 0)]),
    "test_fused_distinct_aggregates_single_device": (
        [f"create table ddsd as select x % 5 as g, (x * 13) % 41 as v from range({N}) r(x)"],
        [("select g, count(distinct v), sum(distinct v), avg(distinct v) from ddsd "
          "group by g order by g", DP, 1e-9, 0)]),
    "test_fused_distinct_matches_host_path": (
        [f"create table dd_dev as select x % 4 as g, x % 23 as v from range({N}) r(x)",
         "create table dd_host as select * from dd_dev limit 1000"],
        [("select g, count(distinct v), sum(distinct v) from dd_dev group by g order by g",
          DP, 0, 0),
         ("select g, count(distinct v), sum(distinct v) from dd_host group by g order by g",
          HOST, 0, 0)]),
    "test_fused_min_max_distinct_insensitive": ([], [
        ("select min(distinct f1), max(distinct f2) from big", DP, 1e-6, 1e-9)]),
    "test_fused_median_single_device": ([], [
        ("select g, median(f1), median(g) from big where f2 > 1.0 group by g order by g",
         DP, 1e-6, 1e-9)]),
    "test_fused_median_matches_host": (
        [f"create table mt as select x % 3 as g, ((x * 31) % 1000)::float / 8.0 as v "
         f"from range({N}) r(x)",
         "create table mt_small as select * from mt limit 999"],
        [("select g, median(v) from mt group by g order by g", DP, 1e-6, 1e-9),
         ("select g, median(v) from mt_small group by g order by g", HOST, 0, 0)]),
    "test_fused_mode_single_device": (
        [f"create table mo as select x % 4 as g, case when x % 10 < 4 then 7 "
         f"when x % 10 < 8 then 3 else x % 23 end as v from range({N}) r(x)"],
        [("select g, mode(v) from mo group by g order by g", DP, 0, 0)]),
    "test_fused_quantile": ([], [
        # the discrete quantile answers the f32 block's element (:637-640)
        ("select g, quantile_cont(f1, 0.25) qc, quantile_disc(f1, 0.9) qd, median(f1) md "
         "from big group by g order by g", DP, 0, 1e-6),
        ("select quantile_cont(f1, 0.5 + 0.0) from big", HOST, 0, 1e-6)]),
    # tests/test_agg_tail_device.py, the single-device parameter
    "test_count_if": ([], [
        ("select g, count_if(v > 0.0) c from t group by g order by g", DP, 1e-6, 1e-9)]),
    "test_bool_and_or": ([], [
        ("select g, bool_and(v > -4.0) ba, bool_or(v > 9.0) bo, bool_and(v > 0.0) bf "
         "from t group by g order by g", DP, 1e-6, 1e-9)]),
    "test_arg_min_max": ([], [
        ("select g, arg_min(iv, v) am, arg_max(iv, v) ax from t group by g order by g",
         DP, 1e-6, 1e-9)]),
    "test_approx_count_distinct_host_exact": ([], [
        ("select g, approx_count_distinct(hv) a, approx_count_distinct(iv) b from t "
         "group by g order by g", DP, 0, 0),
        ("select approx_count_distinct(hv) from t", DP, 0, 0)]),
    "test_approx_count_distinct_f64_not_f32_exact_falls_back": (
        [f"create table fd as select 1 as g, 1.0 + x * 1e-9 as dv from range({N}) r(x)",
         f"create table fe as select 1 as g, (x % 1000) * 1.0 as ev from range({N}) r(x)"],
        [("select approx_count_distinct(dv) from fd", HOST, 0, 0),
         ("select approx_count_distinct(ev) from fe", DP, 0, 0)]),
    "test_product": (
        [f"create table pz as select x % 3 as g, case when x % 8 = 0 then 0.0 else "
         f"(x % 5)::float - 2.0 end as v from range({N}) r(x)"],
        [("select g, product(1.0 + v / 1000.0) p from t group by g order by g", DP, 1e-3, 1e-9),
         ("select g, product(v) from pz group by g order by g", DP, 0, 0)]),
    "test_argmax_string_payload": (
        [f"create table s as select x % 4 as g, (x % 90)::float as v, "
         f"'name_' || (x % 11)::varchar as nm from range({N}) r(x)"],
        [("select g, arg_max(nm, v) from s group by g order by g", DP, 0, 0)]),
    "test_empty_selection_renders_null": ([], [
        ("select bool_and(v > 0), bool_or(v > 0), product(v), approx_count_distinct(iv), "
         "sum(v), min(v) from t where v > 1000.0", HOST, 0, 0)]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_reference_single_table_cases(both, monkeypatch, name):
    port, ref = both
    tables, queries = CASES[name]
    for conn in (port, ref):
        for sql in tables:
            conn.execute(sql)
    for q, path, rel, abs_ in queries:
        _check(port, ref, q, path, monkeypatch, rel, abs_)


def test_reference_values_of_the_program(both):
    """Spot values of the reference tests, computed by numpy."""
    port, _ = both
    x = np.arange(N)
    g, v = x % 5, (x % 40).astype(np.float32) / np.float32(4.0) - np.float32(3.0)
    rows = port.execute("select g, count_if(v > 0.0), median(v), mode(iv), "
                        "count(distinct iv) from t group by g order by g").rows
    assert port._exec_path == "device_plan"
    for key, c, md, mo, dc in rows:
        m = g == key
        assert c == int((v[m] > 0).sum())
        assert md == float(np.median(v[m].astype(np.float64)))
        assert dc == len(np.unique((x % 7)[m]))
    rows = port.execute("select bool_and(v > 0), product(v), sum(v) from t "
                        "where v > 1000.0").rows
    assert rows == [(None, None, None)]


def test_fused_matches_volatile_semantics(both):
    """After unload, the plan fails like the host path (the model is
    resolved per execution, never cached in a stale plan)."""
    port, _ = both
    port.execute("select avg(infera_predict('linear', f1, f2, f3)) from big")
    assert port._exec_path == "device_plan"
    itt.unload_model("linear")
    with pytest.raises(Exception, match="Model not found: linear"):
        port.execute("select avg(infera_predict('linear', f1, f2, f3)) from big")


def test_explain_reports_the_program(both):
    port, _ = both
    text = "\n".join(r[0] for r in port.execute(
        "explain select g, count(*), avg(infera_predict('linear', f1, f2, f3)) "
        "from big where f1 > 5.0 group by g").rows)
    assert "fused device plan (torch program)" in text and "SCAN big" in text
    assert "fused device plan" in "\n".join(
        r[0] for r in port.execute("explain select sum(g) from big").rows)
    # integer EXPRESSIONS still need the host's exact arithmetic
    assert "host/hybrid operators" in "\n".join(
        r[0] for r in port.execute("explain select sum(g * 2) from big").rows)


def test_fused_int_sum_overflow_raises_single_device(both):
    port, ref = both
    big = (1 << 62) // (N // 2)
    for conn in (port, ref):
        conn.execute(f"create table ovfsd as select {big} as v from range({N}) r(x)")
    with pytest.raises(Exception, match="Out of Range Error: overflow in SUM\\(BIGINT\\)"):
        port.execute("select sum(v) from ovfsd")
    with pytest.raises(Exception, match="overflow in SUM"):
        ref.execute("select sum(v) from ovfsd")


def test_phases_and_metrics_name_the_program(both):
    from infera_tpu_torch.observability import METRICS

    port, _ = both
    port.execute("select g, median(f1) from big group by g order by g")
    assert set(port._last_phases) == {"plan_ms", "upload_ms", "probe_ms", "exec_ms",
                                      "assemble_ms"}
    assert METRICS.entries[0].path == "device_plan"   # most recent first


# --------------------------------------------------------------------------- routing


@pytest.mark.parametrize("case", ["tied_mode", "over_budget", "groups_past_512", "int8_model"])
def test_plans_k2_declines_run_in_the_program(both, monkeypatch, tmp_path, case):
    """With K2 on (INFERA_PALLAS_SQL=1, its plain version on the CPU), a
    plan it declines runs in the torch program, with the host's rows."""
    port, ref = both
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    port.execute(f"create table r as select x % 4 as mg, x % 5 as v, x % 500 as k, "
                 f"x % 4096 as k4, (x % 40)::float / 4.0 as f from range({N}) r(x)")
    if case == "int8_model":
        path = tmp_path / "m.onnx"
        proto.save_model_file(builder.mlp_model(in_dim=3, hidden=(16,), out_dim=1), path)
        itt.load_model("m8", str(path), "int8")
    q = {"tied_mode": "select mg, mode(v) from r group by mg order by mg",
         "over_budget": "select k, " + ", ".join(["sum(v)"] * 24) + " from r group by k",
         "groups_past_512": "select k4, count(*), sum(f), min(f) from r group by k4 order by k4",
         "int8_model": "select mg, count(*), avg(infera_predict('m8', f, f, f)) from r "
                       "group by mg order by mg"}[case]
    rows = port.execute(q).rows
    assert port._exec_path == "device_plan"
    if case != "int8_model":   # the host's int8 chain is calibrated, the graph's policy not
        _close(rows, _host_rows(port, q, monkeypatch), 1e-6)


@pytest.mark.parametrize("kernel", ["0", "1"])
@pytest.mark.parametrize("case", ["fractional", "past_f32", "collision"])
def test_key_guards_go_to_the_host(both, monkeypatch, kernel, case):
    """A fractional key, a key past f32's exact integers and two keys in one
    bucket trip a guard in either tier: the host answers."""
    port, _ = both
    monkeypatch.setenv("INFERA_PALLAS_SQL", kernel)
    k = {"fractional": "(x % 4)::float / 2.0",
         "past_f32": "(x % 3) * 20000000.0",
         "collision": f"(x % 2) * {1 << 16}"}[case]
    port.execute(f"create table kg as select {k} as k, x * 0.5 as v from range({N}) r(x)")
    q = "select k, count(*), sum(v) from kg group by k order by k"
    rows = port.execute(q).rows
    assert port._exec_path == "host"
    assert rows == _host_rows(port, q, monkeypatch)


def test_pallas_sql_0_turns_off_only_the_kernel(both, monkeypatch):
    port, _ = both
    q = "select g, count(*), sum(f1) from big group by g order by g"
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    on = port.execute(q).rows
    assert port._exec_path == "device_plan_cuda"
    monkeypatch.setenv("INFERA_PALLAS_SQL", "0")
    off = port.execute(q).rows
    assert port._exec_path == "device_plan"
    _close(on, off, 1e-12)


# --------------------------------------------------------------------------- reference faults


def test_r10_wide_integers_are_held_to_the_host(both, monkeypatch):
    """infera_tpu's program uploads integers as int32 and compares in f32
    (740; 2,147,054,441; 8,586): the port declines a wide integer inside an
    expression and reads it exactly in the int slots."""
    port, _ = both
    port.execute("create table r10 as select (x * 1000003) % 4000000000 as big, "
                 "(x * 977) % 50000000 as mid from range(20000) r(x)")
    for q, want, path in (("select count(*) from r10 where big > 2000000000", 10000, "host"),
                          ("select max(big) from r10", 3999059997, "device_plan"),
                          ("select count(*) from r10 where mid % 2 = 1", 10000, "host")):
        rows = port.execute(q).rows
        assert port._exec_path == path
        assert rows == [(want,)] == _host_rows(port, q, monkeypatch)


def test_r12_the_variance_of_a_constant_group_is_zero(both, monkeypatch):
    """infera_tpu's program sums in f32 (1.065e-4 for the all-zero group);
    the program's two f64 passes give 0.0, as the host."""
    port, _ = both
    port.execute(f"create table r12 as select x % 5 as h, (x % 40)::float / 4.0 - 3.0 as v "
                 f"from range({N}) r(x)")
    q = "select h, stddev_pop(h), var_samp(v) from r12 where v < 0 group by h order by h"
    rows = port.execute(q).rows
    assert port._exec_path == "device_plan"
    assert rows[0][:2] == (0, 0.0)
    _close(rows, _host_rows(port, q, monkeypatch), 1e-9)


@pytest.mark.parametrize("kernel", ["0", "1"])
def test_r14_a_nan_in_the_head_leaves_other_groups_variance(both, monkeypatch, kernel):
    """K2 centres the variance on the mean of a column's first 4,096 rows;
    infera_tpu's mean of a head holding a NaN made every group NaN (R14).
    The shift now comes from the head's finite values: only the group that
    holds the NaN is NaN, as on the host, in K2 and in the program."""
    port, _ = both
    monkeypatch.setenv("INFERA_PALLAS_SQL", kernel)
    c = np.random.default_rng(13).standard_normal(N).astype(np.float32)
    c[5] = np.nan
    port.register_table("r14", Table({"k": Column(np.arange(N) % 4, T.BIGINT),
                                      "c": Column(c, T.FLOAT)}))
    q = "select k, var_pop(c), stddev(c) from r14 group by k order by k"
    rows = port.execute(q).rows
    assert port._exec_path == ("device_plan_cuda" if kernel == "1" else "device_plan")
    assert [np.isnan(r[1]) for r in rows] == [False, True, False, False]
    _close(rows, _host_rows(port, q, monkeypatch), 1e-6)


def test_r13_f64_keys_past_f32_sort_as_duckdb(both):
    """From 2**15 rows ORDER BY sorts on the device: f64 keys past f32's
    range keep their order (infera_tpu ties them in row order)."""
    port, _ = both
    port.execute("create table r13 as select x, case when x % 3 = 0 then 1e300 * (x % 7 + 1) "
                 "else x::double end as v from range(40000) r(x)")
    rows = port.execute("select x, v from r13 order by v desc limit 8").rows
    x = np.arange(40000)
    v = np.where(x % 3 == 0, 1e300 * (x % 7 + 1), x.astype(np.float64))
    order = np.argsort(-v, kind="stable")[:8]
    assert rows == [(int(i), float(v[i])) for i in order]
    assert all(r[1] == 7e300 for r in rows)


@pytest.mark.parametrize("seed,kernel", [(0, "0"), (1, "0"), (2, "1"), (3, "1")])
def test_random_plans_equal_the_host(monkeypatch, seed, kernel):
    """testing/plan_fuzz's random aggregate queries (every family, NaN
    values, wide integers, WHERE, keys) through the program (K2 off) or K2's
    plain version and the program (K2 on): the host's rows."""
    monkeypatch.setenv("INFERA_PALLAS_SQL", kernel)
    itt.set_device("cpu")
    try:
        res = plan_fuzz.run_seed(seed, 20000, 40)
    finally:
        itt.set_device(None)
    assert not res["mismatches"], res["mismatches"]
    assert res["paths"].get("device_plan", 0) > 0
    assert (res["paths"].get("device_plan_cuda", 0) > 0) == (kernel == "1")


# --------------------------------------------------------------------------- F6 and the sort


def test_f6_wide_int_order_by_equals_infera_tpu(both):
    port, ref = both
    for conn in (port, ref):
        conn.execute("create table f6 as select (x * 1000003) % 7 + 1152921504606846976 as k, x "
                     "from range(40000) r(x)")
    q = "select k, x from f6 order by k desc limit 3"
    rows = port.execute(q).rows
    assert rows == ref.execute(q).rows
    assert rows == [(2**60 + 6, 5), (2**60 + 6, 12), (2**60 + 6, 19)]


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_paths_agree(both, seed):
    rng = np.random.default_rng(seed)
    n = 500
    k1 = rng.integers(0, 50, n).astype(np.int64)
    k2 = rng.standard_normal(n).astype(np.float32)
    dev = port_sort.argsort_device([k1, k2], [True, False], [False, False], [None, None])
    host = np.lexsort((-k2, k1))
    np.testing.assert_array_equal(np.stack([k1[dev], k2[dev]]), np.stack([k1[host], k2[host]]))


def test_device_order_by_wide_ints_exact(both):
    rng = np.random.default_rng(0)
    keys = rng.integers(-2**52, 2**52, size=40000).astype(np.int64)
    keys[:100] = np.arange(100) + (1 << 40)  # adjacent wide values
    order = port_sort.argsort_device([keys], [True], [False], [None])
    np.testing.assert_array_equal(keys[order], np.sort(keys, kind="stable"))


def test_device_order_by_f64_close_values(both):
    keys = np.array([1.0 + 1e-9, 1.0, 1.0 + 2e-9, 0.5] * 10000, np.float64)
    order = port_sort.argsort_device([keys], [True], [False], [None])
    np.testing.assert_array_equal(keys[order], np.sort(keys, kind="stable"))


def test_device_order_by_nulls_nan_and_direction_match_the_host_lexsort(both):
    """NULL sentinels, NaN last and the direction as the host lexsort has
    them, for float, int and bool keys; ``head`` keeps the first rows."""
    rng = np.random.default_rng(7)
    n = 3000
    f = rng.standard_normal(n)
    f[::17] = np.nan
    f[::29] = -0.0
    i = rng.integers(-5, 5, n)
    b = rng.random(n) < 0.5
    valid = rng.random(n) < 0.9
    for asc, nf in ((True, False), (False, True), (True, True), (False, False)):
        keys, v = [i, f, b], [valid, None, valid]
        want = port_sort.sort_rows(keys, [asc, not asc, asc], [nf, nf, not nf], v, 10)
        got = port_sort.argsort_device(keys, [asc, not asc, asc], [nf, nf, not nf], v)
        np.testing.assert_array_equal(got, want)
        head = port_sort.argsort_device(keys, [asc, not asc, asc], [nf, nf, not nf], v, head=5)
        np.testing.assert_array_equal(head, want[:5])


# --------------------------------------------------------------------------- hashes, int_agg


def test_device_hash_bits_equal_the_host_hash():
    """splitmix64 over the host's bits, for int32, f32 and f32-exact f64
    values (subnormals included: torch keeps them)."""
    from infera_tpu_torch.ops.hashing import hash_array_host

    rng = np.random.default_rng(8)
    i32 = rng.integers(-2**31, 2**31 - 1, 4000).astype(np.int32)
    f32 = np.concatenate([rng.standard_normal(3990).astype(np.float32),
                          np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-40, 3.4e38,
                                    -1.0, 2.0**-126, 7.5], np.float32)])
    for a, dt in ((i32, "int32"), (f32, "float32"), (i32.astype(np.int64) * 3, "int64")):
        got = H.splitmix64_device(H.value_bits64_device(torch.from_numpy(a), dt))
        np.testing.assert_array_equal(got.numpy().view(np.uint64), hash_array_host(a))
    f64 = f32.astype(np.float64)   # f32-exact: reaches the device as f32
    got = H.splitmix64_device(H.value_bits64_device(torch.from_numpy(f32), "float64"))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), hash_array_host(f64))


def test_device_hash32_equals_infera_tpus():
    """hash_array_device and combine_hashes_device bit for bit (normal
    floats: XLA on the CPU flushes subnormals)."""
    import jax.numpy as jnp

    from infera_tpu.ops import hashing as R

    rng = np.random.default_rng(9)
    for a in (rng.integers(-2**31, 2**31 - 1, 2000).astype(np.int32),
              np.concatenate([rng.standard_normal(1996).astype(np.float32),
                              np.array([0.0, -0.0, np.inf, 1.5], np.float32)])):
        got = H.hash_array_device(torch.from_numpy(a))
        want = np.asarray(R.hash_array_device(jnp.asarray(a)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        rev = torch.from_numpy(got.numpy()[::-1].copy())
        both_ = H.combine_hashes_device([got, rev]).numpy()
        ref = np.asarray(R.combine_hashes_device([jnp.asarray(want), jnp.asarray(want[::-1])]))
        np.testing.assert_array_equal(both_, ref.astype(np.int64))


def test_int_agg_mode_and_presence_equal_infera_tpus():
    import jax
    import jax.numpy as jnp

    from infera_tpu.sql import int_agg as R

    rng = np.random.default_rng(10)
    n, G, V = 20000, 16, 32
    keys = rng.integers(0, G, n).astype(np.int32)
    vals = rng.integers(0, 20, n).astype(np.float32)
    mask = rng.random(n) < 0.8
    t = torch.from_numpy
    mv, mc, bad = int_agg.device_mode(t(vals), t(mask), t(keys).long(), G, V,
                                      torch.arange(n))
    rmv, rmc, rbad = R.device_mode(jnp, jax, jnp.asarray(vals), jnp.asarray(mask),
                                   jnp.asarray(keys), G, V, jnp.arange(n, dtype=jnp.float32))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(rmv))
    np.testing.assert_array_equal(mc.numpy(), np.asarray(rmc))
    assert bool(bad) == bool(rbad) is False
    pres, bad = int_agg.device_presence(t(vals), t(mask), t(keys).long(), G, V)
    rpres, rbad = R.device_presence(jnp, jnp.asarray(vals), jnp.asarray(mask),
                                    jnp.asarray(keys), G, V)
    np.testing.assert_array_equal(pres.numpy(), np.asarray(rpres) > 0)
    dcount, dsum = int_agg.presence_reduce(pres, V)
    rc, rlo, rhi = R.presence_reduce(jnp, rpres, V)
    np.testing.assert_array_equal(dcount.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(dsum.numpy(), np.asarray(rlo) + 128 * np.asarray(rhi))
    vals[5] = 2.5   # a fractional selected value sets the flag
    mask[5] = True
    assert bool(int_agg.device_presence(t(vals), t(mask), t(keys).long(), G, V)[1])


def test_int_agg_sums_and_extremes_are_exact_int64():
    rng = np.random.default_rng(11)
    n, G = 30000, 9
    v = rng.integers(-2**61, 2**61, n)
    keys = rng.integers(0, G, n)
    mask = rng.random(n) < 0.6
    t = torch.from_numpy
    total, est = int_agg.device_limb_sums(t(v), t(mask), t(keys), G)
    mn = int_agg.device_lex_minmax(t(v), t(mask), t(keys), G, True)
    for g in range(G):
        sel = v[(keys == g) & mask]
        assert total[g].item() == int(np.sum(sel, dtype=np.int64))   # modulo 2**64
        assert est[g].item() == pytest.approx(float(np.abs(sel.astype(np.float64)).sum()))
        assert mn[g].item() == sel.min()


# --------------------------------------------------------------------------- R2

R2_SCRIPT = """
import numpy as np, infera_tpu_torch as itt
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_plan as dp
itt.set_device("cpu")
c = Connection()
c.execute("create table h as select x % 9 as g, ((x * 13) % 1001)::float as hv, "
          "(x * 7) % 5003 as iv from range(40000) r(x)")
q = "select g, approx_count_distinct(hv), approx_count_distinct(iv) from h group by g order by g"
dev = c.execute(q).rows
assert c._exec_path == "device_plan", c._exec_path
dp.try_execute_on_device = lambda *a, **k: None
host = Connection(c.catalog).execute(q).rows
print(dev == host, dev[:2])
"""


def test_r2_hll_equals_the_host_in_a_fresh_interpreter():
    """R2: approx_count_distinct's device HLL must not depend on test order;
    one query in a fresh interpreter, held to the host HLL bit for bit."""
    out = subprocess.run([sys.executable, "-c", R2_SCRIPT], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("True"), out.stdout
