"""Streaming and the shuffle join over the mesh on the CPU against the host
and ``infera_tpu``.

Every test of ``tests/test_streaming_mesh.py`` and the mesh tests of
``tests/test_shuffle_join.py`` (:120-160) run here through both packages,
each connection on an 8-shard mesh (the port: 8 shards on ``cpu``;
``infera_tpu``: the 8-device virtual CPU mesh), with ``STREAM_MIN_ROWS``,
``CHUNK_ROWS`` and ``A_CHUNK_ROWS`` lowered in both packages as
``tests/test_torch_streaming.py`` lowers them. Both take the same path
(``streaming_plan_mesh``, ``shuffle_join_mesh``); the port's rows equal its
host executor's and the numpy oracle (keys, counts, int64 sums past 2**53
and pair counts exact; float sums 1e-6 relative, the bound of the reference
tests) and ``infera_tpu``'s at the same bound. The reference's 64M-row
columnar scan runs at 2**20 rows with chunks cut by the same factor, so the
table still spans many global chunks.
"""

import numpy as np
import pytest

import infera_tpu as it
import infera_tpu_torch as itt
from infera_tpu.sql import Connection as RefConnection
from infera_tpu.sql import shuffle_join_plan as ref_sjp
from infera_tpu.sql import streaming_plan as ref_sp
from infera_tpu_torch.columnar import Column, Table
from infera_tpu_torch.columnar import types as T
from infera_tpu_torch.columnar.diskfile import write_columnar
from infera_tpu_torch.registry import MODELS as PORT_MODELS
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_join_plan as djp
from infera_tpu_torch.sql import device_plan as dp
from infera_tpu_torch.sql import shuffle_join_plan as sjp
from infera_tpu_torch.sql import streaming_plan as sp

NDEV = 8


@pytest.fixture()
def both(clean_registry, model_dir, monkeypatch):
    """Both packages on the CPU on an 8-shard mesh, tests/test_streaming_mesh.py's
    thresholds (2**14 rows, chunks of 4,096 a shard), the linear model in
    both registries."""
    itt.set_device("cpu")
    PORT_MODELS.clear()
    for mod in (sp, ref_sp):
        monkeypatch.setattr(mod, "STREAM_MIN_ROWS", 1 << 14)
        monkeypatch.setattr(mod, "CHUNK_ROWS", 4096)
    it.load_model("linear", f"{model_dir}/linear.onnx")
    itt.load_model("linear", f"{model_dir}/linear.onnx")
    port, ref = Connection(), RefConnection()
    port.set_mesh(NDEV)
    ref.set_mesh(NDEV)
    yield port, ref
    PORT_MODELS.clear()
    itt.set_device(None)


def _host_rows(port, q, monkeypatch):
    host = Connection(port.catalog)
    with monkeypatch.context() as m:
        m.setattr(sp, "try_execute_streaming", lambda *a, **k: None)
        m.setattr(dp, "try_execute_on_device", lambda *a, **k: None)
        m.setattr(djp, "try_execute_join_on_device", lambda *a, **k: None)
        rows = host.execute(q).rows
    assert host._exec_path in ("host", "device_join")
    return rows


def _same(rows, want, rel=1e-6):
    assert len(rows) == len(want), (rows, want)
    for a, b in zip(rows, want):
        for x, y in zip(a, b):
            if isinstance(y, float) and x is not None:
                assert x == pytest.approx(y, rel=rel, abs=1e-9), (a, b)
            else:
                assert x == y, (a, b)


# infera_tpu's shuffle join sums f32 partials chunk by chunk (ROADMAP R19),
# and its error grows with the lowered A_CHUNK_ROWS: 1.6e-6 here on a grouped
# pair sum the port gives exactly; tests/test_mesh_plan.py's 1e-4 bounds it
SHUFFLE_REF_REL = 1e-4


def _check(port, ref, q, path, monkeypatch, rel=1e-6, host=True, ref_rel=None):
    """Both packages on ``path``, the port's rows equal its host executor's
    (with ``host``; the shuffle join's comparator is its numpy oracle
    instead, as the host join would build every pair) at ``rel`` and
    infera_tpu's at ``ref_rel`` (default ``rel``)."""
    rows = port.execute(q).rows
    assert port._exec_path == path, (q, port._exec_path)
    ref_rows = ref.execute(q).rows
    assert ref._exec_path == path, (q, ref._exec_path)
    if host:
        _same(rows, _host_rows(port, q, monkeypatch), rel)
    _same(rows, ref_rows, rel if ref_rel is None else ref_rel)
    return rows


def test_streaming_mesh_matches_host(both, monkeypatch):
    """Grouped f32 floats, exact int64 sums past 2**53, int64 min/max and a
    model's predictions over 2 global chunks and a ragged tail."""
    port, ref = both
    n = 4096 * NDEV * 2 + 777
    base = (1 << 41) + 1
    for conn in both:
        conn.execute(
            f"create table big as select x % 6 as g, {base} + x as v, "
            f"(x % 100)::float / 10.0 as f1, ((x + 3) % 50)::float / 5.0 as f2, "
            f"((x * 7) % 30)::float / 3.0 as f3 from range({n}) r(x)")
    q = ("select g, count(*) c, sum(v) s, min(v), max(v), sum(f1), "
         "avg(infera_predict('linear', f1, f2, f3)) p from big where f1 > 1.0 "
         "group by g order by g")
    rows = _check(port, ref, q, "streaming_plan_mesh", monkeypatch, 1e-5)
    x = np.arange(n, dtype=np.int64)
    f1 = (x % 100).astype(np.float32) / np.float32(10.0)
    for key, c, s, mn, mx, *_ in rows:
        idx = x[(f1 > 1.0) & (x % 6 == key)]
        assert c == len(idx) and s == sum(base + int(i) for i in idx)
        assert (mn, mx) == (base + int(idx.min()), base + int(idx.max()))


def test_streaming_mesh_global_aggregate(both, monkeypatch):
    port, ref = both
    n = 4096 * NDEV * 3 + 5
    for conn in both:
        conn.execute(f"create table t as select x % 9 as h, (x % 13)::float as f "
                     f"from range({n}) r(x)")
    rows = _check(port, ref, "select count(*), sum(f), max(f) from t",
                  "streaming_plan_mesh", monkeypatch, 1e-9)
    assert rows[0][0] == n and rows[0][2] == 12.0


def test_streaming_mesh_no_mesh_single_device(both, monkeypatch):
    """Without a mesh the path stays streaming_plan."""
    port, ref = both
    n = 4096 * 8 + 1
    for conn in both:
        conn.set_mesh(None)
        conn.execute(f"create table t as select x % 3 as g, (x % 7)::float as f "
                     f"from range({n}) r(x)")
    rows = _check(port, ref, "select g, count(*) from t group by g order by g",
                  "streaming_plan", monkeypatch, 0)
    assert sum(r[1] for r in rows) == n


def test_streaming_mesh_columnar(both, monkeypatch, tmp_path):
    """tests/test_streaming_mesh.py's memmap-backed read_columnar GROUP BY,
    at 2**20 rows with 2**14-row chunks a shard (the reference's 64M rows
    with its 2**20-row chunks, cut 64-fold each): int64 sums past 2**53
    exact against the closed form."""
    port, ref = both
    for mod in (sp, ref_sp):
        monkeypatch.setattr(mod, "CHUNK_ROWS", 1 << 14)
    n = 1 << 20
    base = (1 << 44) + 1
    x = np.arange(n, dtype=np.int64)
    d = tmp_path / "big_col"
    write_columnar(Table({"g": Column((x % 16).astype(np.int64), T.BIGINT),
                          "v": Column(base + x, T.BIGINT)}), str(d))
    q = f"select g, count(*) c, sum(v) s from read_columnar('{d}') group by g order by g"
    rows = _check(port, ref, q, "streaming_plan_mesh", monkeypatch, 0)
    per = n // 16
    assert len(rows) == 16
    for key, c, s in rows:
        assert c == per
        assert s == per * base + per * key + 16 * (per * (per - 1) // 2)


NS = 1 << 16  # per side, tests/test_shuffle_join.py's N


def _mk_shuffle(both):
    """tests/test_shuffle_join.py's skewed tables: a hot key 7 on 30 % of A's
    rows and 2 in 7 of B's."""
    for conn in both:
        conn.execute(f"create table fa as select case when x % 10 < 3 then 7 "
                     f"else x % 200 end as k, x % 5 as g, (x % 40)::float / 4.0 as v "
                     f"from range({NS}) r(x)")
        conn.execute(f"create table fb as select case when x % 7 < 2 then 7 "
                     f"else (x * 3) % 250 end as k, (x % 90)::float / 9.0 as w "
                     f"from range({NS}) r(x)")
    x = np.arange(NS)
    ka = np.where(x % 10 < 3, 7, x % 200)
    kb = np.where(x % 7 < 2, 7, (x * 3) % 250)
    return ka, kb, x % 5, (x % 40) / 4.0, (x % 90) / 9.0


@pytest.fixture()
def small_a_chunks(monkeypatch):
    for mod in (sjp, ref_sjp):
        monkeypatch.setattr(mod, "A_CHUNK_ROWS", 4096)


def test_shuffle_join_mesh(both, monkeypatch, small_a_chunks):
    """B pre-reduced per shard before the exchange, group partials merged."""
    port, ref = both
    ka, kb, g, v, w = _mk_shuffle(both)
    q = ("select g, count(*) c, sum(v) sv, sum(w) sw, min(w) mnw from fa join fb "
         "on fa.k = fb.k group by g order by g")
    rows = _check(port, ref, q, "shuffle_join_mesh", monkeypatch, host=False,
                  ref_rel=SHUFFLE_REF_REL)
    cnt = np.bincount(kb, minlength=300)
    swk = np.bincount(kb, weights=w, minlength=300)
    mnk = np.full(300, np.inf)
    np.minimum.at(mnk, kb, w.astype(np.float32))
    for key, c, sv, sw, mnw in rows:
        m = g == key
        assert c == int(cnt[ka[m]].sum())
        assert sv == pytest.approx((v[m] * cnt[ka[m]]).sum(), rel=1e-6)
        assert sw == pytest.approx(swk[ka[m]].sum(), rel=1e-6)
        assert mnw == float(mnk[ka[m & (cnt[ka] > 0)]].min())   # an f32 value, exact


@pytest.mark.parametrize("meshed", [False, True])
def test_shuffle_join_mixed_side_product(both, monkeypatch, small_a_chunks, meshed):
    """sum(f(a) * g(b)) through the per-key B partials, both tiers."""
    port, ref = both
    if not meshed:
        for conn in both:
            conn.set_mesh(None)
    ka, kb, g, v, w = _mk_shuffle(both)
    path = "shuffle_join_mesh" if meshed else "shuffle_join"
    rows = _check(port, ref, "select sum(v * w), avg(v * w), count(*) from fa join fb "
                  "on fa.k = fb.k", path, monkeypatch, host=False,
                  ref_rel=SHUFFLE_REF_REL)
    sw = np.bincount(kb, weights=w, minlength=300)
    assert rows[0][2] == int(np.bincount(kb, minlength=300)[ka].sum())
    assert rows[0][0] == pytest.approx(float((v * sw[ka]).sum()), rel=1e-6)
    rows = _check(port, ref, "select g, sum(v * 2.0 * w) s, sum(v) sv from fa join fb "
                  "on fa.k = fb.k group by g order by g", path, monkeypatch, host=False,
                  ref_rel=SHUFFLE_REF_REL)
    for kg, s2, sv in rows:
        m = g == kg
        assert s2 == pytest.approx(float((2.0 * v[m] * sw[ka[m]]).sum()), rel=1e-6)


@pytest.mark.parametrize("shards", [1, 3, 13])
def test_shuffle_join_mesh_any_shard_count(clean_registry, small_a_chunks, shards):
    """At 1, 3 and 13 shards with ragged sides (65,541 and 65,539 rows) the
    pair counts, keys and extremes equal the single-device shuffle join's
    exactly, the sums to 1e-12 (f64 adds in another order), and the pair
    counts equal numpy's."""
    itt.set_device("cpu")
    try:
        port = Connection()
        port.execute(f"create table fa as select case when x % 10 < 3 then 7 else x % 200 end "
                     f"as k, x % 5 as g, (x % 40)::float / 4.0 as v from range({NS + 5}) r(x)")
        port.execute(f"create table fb as select case when x % 7 < 2 then 7 "
                     f"else (x * 3) % 250 end as k, (x % 90)::float / 9.0 as w "
                     f"from range({NS + 3}) r(x)")
        q = ("select g, count(*) c, min(w), max(v), sum(v) from fa join fb on fa.k = fb.k "
             "group by g order by g")
        one = port.execute(q).rows
        assert port._exec_path == "shuffle_join"
        port.set_mesh(shards)
        rows = port.execute(q).rows
        assert port._exec_path == "shuffle_join_mesh"
        _same(rows, one, 1e-12)
        xa, xb = np.arange(NS + 5), np.arange(NS + 3)
        ka = np.where(xa % 10 < 3, 7, xa % 200)
        cnt = np.bincount(np.where(xb % 7 < 2, 7, (xb * 3) % 250), minlength=300)
        assert [r[1] for r in rows] == [int(cnt[ka[xa % 5 == k]].sum()) for k in range(5)]
    finally:
        itt.set_device(None)
