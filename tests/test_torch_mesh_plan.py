"""Mesh-partitioned SQL (``sql/mesh_plan.py``) on the CPU against the host
and ``infera_tpu``.

Every test of ``tests/test_mesh_plan.py``, the mesh cases of
``tests/test_path_equivalence.py:268-290`` and the mesh parameter of
``tests/test_agg_tail_device.py`` run here through both packages over the
same tables, each connection with ``set_mesh(8)``: the port's mesh is 8
shards on ``cpu``, ``infera_tpu``'s the 8-device virtual CPU mesh of
``tests/conftest.py``. Each query takes the path ``infera_tpu`` records
(``device_plan_mesh``, ``device_join_plan_mesh``, or the host where a
guard trips); the port's rows equal its host executor's (keys, counts,
integers, DISTINCT, MODE, HLL exact; float aggregates 1e-6 relative, 1e-5
where a model is read) and ``infera_tpu``'s at 1e-4, the bound of
``tests/test_mesh_plan.py``: its mesh partials are f32 and its columns
narrowed to f32 and int32 (``_canonical_host``), where the port reads the
same f32 block as its single-device program and merges in f64 and int64.
Then the exchange probe, the declines, the guards, K2 off on a mesh, and
the per-mesh caches.
"""

import os

import numpy as np
import pytest

import infera_tpu as it
import infera_tpu_torch as itt
from infera_tpu import config as ref_config
from infera_tpu.sql import Connection as RefConnection
from infera_tpu_torch import config as port_config
from infera_tpu_torch.ops import fused_sql as FS
from infera_tpu_torch.parallel import shuffle as port_shuffle
from infera_tpu_torch.parallel.mesh import make_mesh
from infera_tpu_torch.registry import MODELS as PORT_MODELS
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_join_plan as djp
from infera_tpu_torch.sql import device_plan as dp
from infera_tpu_torch.sql import mesh_plan as MP

NDEV = 8
N = dp.MIN_DEVICE_ROWS * 2 + 13   # deliberately no multiple of the mesh
BIG = (f"create table big as select x % 7 as g, (x % 100)::float / 10.0 as f1, "
       f"((x + 3) % 50)::float / 5.0 as f2, ((x * 7) % 30)::float / 3.0 as f3 "
       f"from range({N}) r(x)")
TAIL = (f"create table t as select x % 5 as g, (x % 40)::float / 4.0 - 3.0 as v, "
        f"(x % 7) as iv, ((x * 13) % 101)::float as hv from range({N}) r(x)")
MESH, JMESH, HOST = "device_plan_mesh", "device_join_plan_mesh", "host"
REF_REL = 1e-4   # infera_tpu's f32 mesh partials (tests/test_mesh_plan.py's bound)


@pytest.fixture()
def both(clean_registry, model_dir, monkeypatch):
    """Both packages on the CPU, each connection on an 8-shard mesh over the
    same tables, the linear model loaded into both registries, K2 off."""
    monkeypatch.delenv("INFERA_PALLAS_SQL", raising=False)
    itt.set_device("cpu")
    PORT_MODELS.clear()
    port, ref = Connection(), RefConnection()
    for conn in (port, ref):
        conn.set_mesh(NDEV)
        conn.execute(BIG)
        conn.execute(TAIL)
    it.load_model("linear", f"{model_dir}/linear.onnx")
    itt.load_model("linear", f"{model_dir}/linear.onnx")
    yield port, ref
    PORT_MODELS.clear()
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


def _close(rows, want, rel, abs_=1e-9):
    assert len(rows) == len(want), (rows, want)
    for a, b in zip(rows, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(y, float) and not isinstance(x, (bool, str)) and x is not None:
                assert x == pytest.approx(y, rel=rel, abs=abs_, nan_ok=True), (a, b)
            else:
                assert x == y, (a, b)


def _check(port, ref, q, path, monkeypatch, rel=1e-6, ref_rel=REF_REL):
    """The query through both packages on the mesh: both on ``path``; the
    port's rows equal its host's at ``rel`` and infera_tpu's at
    ``ref_rel``."""
    rows = port.execute(q).rows
    assert port._exec_path == path, (q, port._exec_path, getattr(port, "_mesh_decline", None))
    ref_rows = ref.execute(q).rows
    assert ref._exec_path == path, (q, ref._exec_path)
    _close(rows, _host_rows(port, q, monkeypatch), rel)
    _close(rows, ref_rows, ref_rel)
    return rows


def _probe(monkeypatch):
    """Count the calls of the exchange's bucket packer."""
    calls = {"n": 0}
    orig = port_shuffle._pack_buckets

    def probed(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(port_shuffle, "_pack_buckets", probed)
    return calls


P = "infera_predict('linear', f1, f2, f3)"
# reference test -> (tables, [(query, path, rel against the host)])
CASES = {
    "test_mesh_groupby_predict_matches_host": ([], [
        (f"select g, count(*) c, avg({P}) p, sum(f1) s, min(f2), max(f3) from big "
         f"where f1 > 5.0 group by g order by g", MESH, 1e-5)]),
    "test_mesh_global_aggregate": ([], [
        (f"select count(*), avg({P}), sum(f1) from big", MESH, 1e-5)]),
    "test_mesh_global_aggregate_empty_filter": ([], [
        ("select count(*) from big where f1 > 1e9", MESH, 0)]),
    "test_mesh_multikey_groupby_having": (
        [f"create table mk as select x % 5 as a, x % 3 as b, (x % 100)::float / 10.0 as f1 "
         f"from range({N}) r(x)"],
        [("select a, b, count(*) c from mk group by a, b having avg(f1) > 4.9 order by a, b",
          MESH, 0)]),
    "test_mesh_int_sum_exact_on_mesh": ([], [("select sum(g) from big", MESH, 0)]),
    "test_mesh_int_aggs_wide_values": (
        [f"create table wide as select x % 4 as g, {(1 << 41) + 1} + x as v, "
         f"-{(1 << 41) + 1} - 2 * x as nv from range({N}) r(x)"],
        # avg: an exact int64 total over the count, where the host sums in f64
        [("select g, sum(v), avg(v), min(v), max(v), sum(nv), min(nv) from wide "
          "group by g order by g", MESH, 1e-12)]),
    "test_mesh_stddev_variance": ([], [
        ("select g, stddev(f1), var_pop(f2), variance(f3), stddev_pop(f1) from big "
         "group by g order by g", MESH, 1e-6)]),
    "test_mesh_stddev_int_column": ([], [("select stddev(g) from big", MESH, 1e-6)]),
    "test_mesh_distinct_aggregates": (
        [f"create table dd as select x % 6 as g, (x * x) % 97 as v from range({N}) r(x)"],
        [("select g, count(distinct v) c, sum(distinct v) s, avg(distinct v) a from dd "
          "group by g order by g", MESH, 1e-12)]),
    "test_mesh_distinct_fractional_falls_back": ([], [
        ("select count(distinct f1) from big", HOST, 0)]),
    "test_mesh_having_stddev": ([], [
        ("select g, count(*) from big group by g having stddev(f1) > 0 order by g", MESH, 0)]),
    "test_mesh_int64_key_guard_falls_back": (
        [f"create table bigg as select case when x % 2 = 0 then {1 << 32} else 0 end as g2 "
         f"from range({N}) r(x)"],
        [("select g2, count(*) from bigg group by g2 order by g2", HOST, 0)]),
    "test_mesh_join_aggregate": (
        ["create table dim as select x as k, (x * 2)::float as w, x % 3 as cat "
         "from range(100) r(x)",
         f"create table fact as select x % 100 as k, (x % 40)::float / 4.0 as f1 "
         f"from range({N}) r(x)"],
        [("select cat, count(*) c, sum(w) sw, max(f1) from fact join dim on fact.k = dim.k "
          "group by cat order by cat", JMESH, 1e-6)]),
    "test_mesh_high_cardinality_groups": (
        [f"create table hc as select x % 3000 as g, (x % 10)::float as f from range({N}) r(x)"],
        [("select g, count(*) c, sum(f) s from hc group by g order by g", MESH, 1e-6)]),
    "test_mesh_mode": (
        [f"create table mo as select x % 5 as g, case when x % 7 < 3 then 11 else x % 13 end "
         f"as v from range({N}) r(x)"],
        [("select g, mode(v), count(*) from mo group by g order by g", MESH, 0)]),
    "test_mesh_float_sum_compensated": (
        [f"create table fs as select x % 5 as g, (2048.0 + (x % 7)::float / 1024.0)::float "
         f"as f1 from range({dp.MIN_DEVICE_ROWS * 8}) r(x)"],
        [("select g, sum(f1) s, avg(f1) a, count(*) c from fs group by g order by g",
          MESH, 1e-12)]),
    "test_mesh_left_join_aggregate": (
        ["create table ldim as select x as k, (x * 2)::float as w from range(60) r(x)",
         f"create table lfact as select x % 100 as k, x % 5 as g, (x % 40)::float / 4.0 as v "
         f"from range({N}) r(x)"],
        [("select g, count(*) c, count(w) cw, sum(v) sv, sum(w) sw, avg(w) aw, min(w) mnw, "
          "max(w) mxw from lfact left join ldim on lfact.k = ldim.k group by g order by g",
          JMESH, 1e-6)]),
    "test_mesh_right_join_global": (
        ["create table rdim as select x as k, (x * 3)::float as w from range(80) r(x)",
         f"create table rfact as select x % 120 as k, (x % 10)::float as v "
         f"from range({N}) r(x)"],
        [("select count(*) c, count(w) cw, sum(coalesce(w, -1.0)) sc from rdim "
          "right join rfact on rdim.k = rfact.k", JMESH, 1e-6)]),
    "test_mesh_full_join_global": (
        ["create table fdim as select x as k, (x * 2)::float as w from range(200) r(x)",
         f"create table ffact as select x % 120 as k, (x % 10)::float as v "
         f"from range({N}) r(x)"],
        [("select count(*) c, count(w) cw, count(v) cv, sum(w) sw from ffact "
          "full join fdim on ffact.k = fdim.k", JMESH, 1e-6)]),
    "test_mesh_outer_join_never_regresses_to_host": (
        ["create table ndim as select x as k, (x * 2)::float as w from range(50) r(x)",
         f"create table nfact as select x % 100 as k, (x % 40)::float as v "
         f"from range({N}) r(x)"],
        [("select count(w), avg(w) from nfact left join ndim on nfact.k = ndim.k",
          JMESH, 1e-6)]),
    # tests/test_agg_tail_device.py, the mesh parameter and its mesh tests
    "test_count_if": ([], [
        ("select g, count_if(v > 0.0) c from t group by g order by g", MESH, 0)]),
    "test_bool_and_or": ([], [
        ("select g, bool_and(v > -4.0) ba, bool_or(v > 9.0) bo, bool_and(v > 0.0) bf "
         "from t group by g order by g", MESH, 0)]),
    "test_arg_min_max": ([], [
        ("select g, arg_min(iv, v) am, arg_max(iv, v) ax from t group by g order by g",
         MESH, 0)]),
    "test_approx_count_distinct_host_exact": ([], [
        ("select g, approx_count_distinct(hv) a, approx_count_distinct(iv) b from t "
         "group by g order by g", MESH, 0),
        ("select approx_count_distinct(hv) from t", MESH, 0)]),
    # the tail tests' product tolerance: a log2 sum of f32 values
    "test_product": (
        [f"create table pz as select x % 3 as g, case when x % 8 = 0 then 0.0 else "
         f"(x % 5)::float - 2.0 end as v from range({N}) r(x)"],
        [("select g, product(1.0 + v / 1000.0) p from t group by g order by g", MESH, 1e-3),
         ("select g, product(v) from pz group by g order by g", MESH, 0)]),
    "test_mesh_hll_large_group_count": (
        ["create table hb as select x % 2000 as g, x % 13 as v from range(65536) r(x)"],
        [("select g, approx_count_distinct(v) a from hb group by g order by g", MESH, 0)]),
    "test_mesh_median_quantile_bisection": ([], [
        ("select g, median(v) m, quantile_cont(v, 0.25) qc, quantile_disc(v, 0.9) qd from t "
         "group by g order by g", MESH, 1e-12)]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_reference_mesh_cases(both, monkeypatch, name):
    port, ref = both
    tables, queries = CASES[name]
    for conn in (port, ref):
        for sql in tables:
            conn.execute(sql)
    for q, path, rel in queries:
        _check(port, ref, q, path, monkeypatch, rel)


def test_mesh_values_against_numpy(both):
    """Spot values of tests/test_mesh_plan.py, computed by numpy: the
    filtered predict aggregate and the compensated-sum bound."""
    port, _ = both
    rows = port.execute(f"select g, count(*) c, avg({P}) p, sum(f1) s, min(f2), max(f3) "
                        f"from big where f1 > 5.0 group by g order by g").rows
    x = np.arange(N)
    g = x % 7
    f1 = (x % 100).astype(np.float32) / np.float32(10.0)
    f2 = ((x + 3) % 50).astype(np.float32) / np.float32(5.0)
    f3 = ((x * 7) % 30).astype(np.float32) / np.float32(3.0)
    pred = 2 * f1 - f2 + 0.5 * f3 + np.float32(0.25)
    sel = f1 > 5.0
    assert len(rows) == 7
    for key, c, p, s, mn, mx in rows:
        m = sel & (g == key)
        assert c == int(m.sum())
        assert p == pytest.approx(float(pred[m].astype(np.float64).mean()), rel=1e-5)
        assert s == pytest.approx(float(f1[m].astype(np.float64).sum()), rel=1e-12)
        assert (mn, mx) == (float(f2[m].min()), float(f3[m].max()))


def test_exchange_runs_on_the_mesh(both, monkeypatch):
    """The plan and the outer join route through the bucket packer."""
    port, _ = both
    calls = _probe(monkeypatch)
    port.execute(f"select g, avg({P}) from big group by g")
    assert port._exec_path == MESH and calls["n"] >= NDEV
    port.execute("create table ldim as select x as k, (x * 2)::float as w from range(60) r(x)")
    port.execute(f"create table lfact as select x % 100 as k, x % 5 as g from range({N}) r(x)")
    n0 = calls["n"]
    port.execute("select g, count(w) from lfact left join ldim on lfact.k = ldim.k group by g")
    assert port._exec_path == JMESH and calls["n"] > n0


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_sql_random_aggregates_agree_on_mesh(both, monkeypatch, seed):
    """tests/test_path_equivalence.py's randomized mesh queries; int64 SUM
    exact."""
    port, ref = both
    rng = np.random.default_rng(seed + 50)
    n = 1 << 15
    sql = (f"create table rt as select x % {int(rng.integers(2, 9))} as g, "
           f"(x % {int(rng.integers(10, 200))})::float / 7.0 as f1, "
           f"((x * 13 + 5) % {int(rng.integers(20, 99))})::float as f2, "
           f"x * 1000003 as big from range({n}) r(x)")
    for conn in (port, ref):
        conn.execute(sql)
    q = ("select g, count(*) c, sum(f1) s1, avg(f2) a2, min(f1) mn, max(f2) mx, "
         "stddev(f1) sd, sum(big) sb from rt where f1 > 2.0 group by g order by g")
    rows = _check(port, ref, q, MESH, monkeypatch, 1e-6)
    assert all(isinstance(r[7], int) for r in rows)


def test_mesh_int_sum_overflow_raises(both):
    port, ref = both
    big = (1 << 62) // (N // 2)
    for conn in (port, ref):
        conn.execute(f"create table ovf as select {big} as v from range({N}) r(x)")
    with pytest.raises(Exception, match="Out of Range Error: overflow in SUM\\(BIGINT\\)"):
        port.execute("select sum(v) from ovf")
    with pytest.raises(Exception, match="overflow in SUM"):
        ref.execute("select sum(v) from ovf")


def test_mesh_volatile_semantics(both):
    """An unloaded model fails on the mesh as on the host."""
    port, _ = both
    port.execute(f"select avg({P}) from big")
    assert port._exec_path == MESH
    itt.unload_model("linear")
    with pytest.raises(Exception, match="Model not found: linear"):
        port.execute(f"select avg({P}) from big")


def test_mesh_disabled_uses_single_device(both):
    port, ref = both
    for conn in (port, ref):
        conn.set_mesh(None)
    rows = port.execute("select g, count(*) from big group by g order by g").rows
    assert port._exec_path == "device_plan"
    assert rows == ref.execute("select g, count(*) from big group by g order by g").rows
    assert ref._exec_path == "device_plan"


def test_mesh_env_knob(clean_registry, monkeypatch):
    """INFERA_MESH enables the mesh path in both packages."""
    itt.set_device("cpu")
    monkeypatch.setenv("INFERA_MESH", str(NDEV))
    port_config.reset_config_for_tests()
    ref_config.reset_config_for_tests()
    try:
        sql = (f"create table t as select x % 4 as g, (x % 9)::float as f "
               f"from range({N}) r(x)")
        q = "select g, count(*), avg(f) from t group by g order by g"
        port, ref = Connection(), RefConnection()
        for conn in (port, ref):
            conn.execute(sql)
        rows = port.execute(q).rows
        assert port._exec_path == MESH and MP.get_mesh(port).shape["dp"] == NDEV
        _close(rows, ref.execute(q).rows, REF_REL)
        assert ref._exec_path == MESH
    finally:
        port_config.reset_config_for_tests()
        ref_config.reset_config_for_tests()
        itt.set_device(None)


def test_empty_selection_renders_null_on_the_mesh(both, monkeypatch):
    """tests/test_agg_tail_device.py's empty selection on the mesh: the
    identities never leak (a NULL-producing group goes to the host)."""
    port, ref = both
    q = ("select bool_and(v > 0), bool_or(v > 0), product(v), approx_count_distinct(iv), "
         "sum(v), min(v) from t where v > 1000.0")
    assert port.execute(q).rows == [(None,) * 6] == ref.execute(q).rows
    assert port._exec_path == HOST


def test_mesh_declines_by_explicit_rule():
    """The mesh declines: fewer rows than shards, the HLL register bound,
    DISTINCT or MODE without a value domain, an aggregate other than
    count/sum/avg/min/max over an outer join's matched rows; otherwise
    None."""
    mesh = make_mesh(NDEV, device="cpu")
    plans = [("count_star", None), ("sum", None)]
    assert MP.mesh_declines(mesh, 1 << 15, 64, plans) is None
    assert "fewer than the 8 shards" in MP.mesh_declines(mesh, 7, 64, plans)
    assert "HLL" in MP.mesh_declines(mesh, 1 << 15, 8192, [("hll", None)])
    assert MP.mesh_declines(mesh, 1 << 15, 4096, [("hll", None)]) is None
    assert "value domain" in MP.mesh_declines(mesh, 1 << 15, 64, [("mode", None)])
    assert MP.mesh_declines(mesh, 1 << 15, 64, [("mode", None)], {0: 16}) is None
    assert "matched" in MP.mesh_declines(mesh, 1 << 15, 64, [("var", None)], None, ["matched"])
    assert MP.mesh_declines(mesh, 1 << 15, 64, [("max", None)], None, ["matched"]) is None


def test_declined_plan_runs_the_program_and_never_k2(both, monkeypatch):
    """A plan the mesh declines (here: more shards than rows) runs the
    single-device torch program, never K2, even with K2 switched on; a
    meshed plan with K2 on never launches it either."""
    port, _ = both
    monkeypatch.setenv("INFERA_PALLAS_SQL", "1")
    monkeypatch.setattr(FS, "fused_sql", lambda *a, **k: pytest.fail("K2 ran on a mesh"))
    q = "select g, count(*), sum(f1) from big group by g order by g"
    port.execute(q)
    assert port._exec_path == MESH
    port.set_mesh(make_mesh(1 << 16, device="cpu"))
    rows = port.execute(q).rows
    assert port._exec_path == "device_plan"
    assert "fewer than the 65536 shards" in port._mesh_decline
    _close(rows, _host_rows(port, q, monkeypatch), 1e-6)


@pytest.mark.parametrize("case", ["collision", "past_f32", "nan_arg"])
def test_tripped_guard_goes_to_the_host_not_one_device(both, monkeypatch, case):
    """A guard that trips in the mesh result sends the query to the host;
    the single-device program does not run."""
    port, _ = both
    k = {"collision": f"(x % 2) * {1 << 16}", "past_f32": "(x % 3) * 20000000.0",
         "nan_arg": "x % 3"}[case]
    port.execute(f"create table kg as select {k} as k, x * 0.5 as v, "
                 f"case when x = 77 then 0.0 / 0.0 else x * 1.0 end as o from range({N}) r(x)")
    q = ("select k, arg_max(v, o) from kg group by k order by k" if case == "nan_arg"
         else "select k, count(*), sum(v) from kg group by k order by k")
    monkeypatch.setattr(dp, "_build_program", lambda *a, **k: pytest.fail("one device ran"))
    rows = port.execute(q).rows
    assert port._exec_path == HOST
    _close(rows, _host_rows(port, q, monkeypatch), 0)


def test_plans_and_shards_are_cached_per_mesh(both, monkeypatch):
    """A connection that switches meshes never reuses another mesh's shards;
    the answers agree."""
    port, _ = both
    q = "select g, count(*), sum(f1), median(f2) from big group by g order by g"
    a = port.execute(q).rows
    port.set_mesh(3)
    b = port.execute(q).rows
    assert port._exec_path == MESH
    col = port.catalog.get("big").columns["f1"]
    meshes = {ent[0].shape["dp"] for ent in col._mesh_shards.values()}
    assert meshes == {NDEV, 3}
    _close(a, b, 1e-12)


def test_phases_name_the_exchange(both):
    port, _ = both
    port.execute("select g, count(*), median(f1) from big group by g")
    assert {"mesh_partials_ms", "mesh_exchange_ms", "mesh_merge_ms",
            "mesh_exec_ms"} <= set(port._last_phases)


def _chip_smoke_tables(port, ref, save_dir, n):
    """chip_smoke's tables (big, tail, t, and config 3's src, meta, fact,
    dim) and models (m, mt, m3) at ``n`` rows in both packages, from the
    same files (saved under ``save_dir``) and draws."""
    import chip_smoke as cs
    from infera_tpu.columnar import Column as RCol, Table as RTable
    from infera_tpu.columnar import types as RT
    from infera_tpu_torch.columnar import Column, Table
    from infera_tpu_torch.columnar import types as T
    from infera_tpu_torch.onnx import builder, proto

    for name, model in (("m", builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1)),
                        ("mt", builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1,
                                                 softmax=False)),
                        ("m3", builder.mlp_model(in_dim=8, hidden=(), out_dim=4, softmax=False,
                                                 seed=0))):
        path = f"{save_dir}/cs_{name}.onnx"
        proto.save_model_file(model, path)
        it.load_model(name, path)
        itt.load_model(name, path)
    rng = np.random.default_rng(0)
    ids = rng.permutation(n).astype(np.int64)
    x = rng.standard_normal((n, 8), dtype=np.float32)
    mid = np.arange(n, dtype=np.int64)
    w_meta = np.random.default_rng(1).standard_normal(n, dtype=np.float32)
    for conn, col, tab, ty in ((port, Column, Table, T), (ref, RCol, RTable, RT)):
        for sql in (cs.BIG_TABLE, cs.TAIL_TABLE, cs.DP_T):
            conn.execute(sql.format(n=n))
        src = {"id": col(ids, ty.BIGINT)}
        src.update({f"x{k}": col(np.ascontiguousarray(x[:, k]), ty.FLOAT) for k in range(8)})
        conn.register_table("src", tab(src))
        conn.register_table("meta", tab({"id": col(mid, ty.BIGINT), "w": col(w_meta, ty.FLOAT),
                                         "cat": col(mid % 16, ty.BIGINT)}))
        conn.execute(f"create table fact as select x % 1100 as k, (x % 40)::float / 4.0 as v, "
                     f"x % 6 as og from range({n}) r(x)")
        conn.execute("create table dim as select x as k, (x * 2)::float as w "
                     "from range(1000) r(x)")


def test_chip_smoke_mesh_queries_take_the_reference_paths(both, model_dir, tmp_path,
                                                         monkeypatch):
    """chip_smoke's mesh phase at 2**15 rows: queries A, C, I, J, L, M, N,
    F and G-LEFT take the path infera_tpu's mesh records for the same plan,
    with the host's rows at each query's chip_smoke tolerance and
    infera_tpu's at 1e-4 (its f32 partials)."""
    import chip_smoke as cs

    port, ref = Connection(), RefConnection()
    for conn in (port, ref):
        conn.set_mesh(NDEV)
    shared = sorted(os.listdir(model_dir))
    _chip_smoke_tables(port, ref, tmp_path, 1 << 15)
    # the shared model_dir fixture is autoloaded by other tests
    assert sorted(os.listdir(model_dir)) == shared
    for key, (q, path, tol) in cs.mesh_queries().items():
        rows = port.execute(q).rows
        assert port._exec_path == path, (key, port._exec_path, port._mesh_decline)
        ref_rows = ref.execute(q).rows
        assert ref._exec_path == path, (key, ref._exec_path)
        cs.compare_rows(key, rows, _host_rows(port, q, monkeypatch), tol)
        _close(rows, ref_rows, REF_REL)
