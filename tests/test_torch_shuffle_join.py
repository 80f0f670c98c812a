"""The big×big shuffle join (``sql/shuffle_join_plan.py``) on the CPU against
``infera_tpu``.

Every non-mesh test of ``tests/test_shuffle_join.py`` runs here through both
packages over the same tables: both take the same path (``shuffle_join``,
or the host join where the tier declines), and the port's rows equal
``infera_tpu``'s and the numpy per-key oracle (pair counts exact, no pair
built; sums, averages and extremes to 1e-6 relative, the bound of
``infera_tpu``'s tests). Then a group key past 2**24, join keys at the
int32 bounds, and NaN B values against the port's host join.
"""

import time

import numpy as np
import pytest

import infera_tpu_torch as itt
from infera_tpu.sql import Connection as RefConnection
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_join_plan as djp
from infera_tpu_torch.sql import device_plan as dp
from infera_tpu_torch.sql import shuffle_join_plan as sjp

N = 1 << 16  # per side, as tests/test_shuffle_join.py
SJ = "shuffle_join"


@pytest.fixture()
def both():
    itt.set_device("cpu")
    yield Connection(), RefConnection()
    itt.set_device(None)


def _create(both, *sqls):
    for conn in both:
        for q in sqls:
            conn.execute(q)


def _mk(both, skewed=False):
    """tests/test_shuffle_join.py's tables: A keys 0..199 (skewed: a hot key
    7 on 30 % of the rows), B keys (x * 3) % 250 (skewed: 7 on 2 rows in 7)."""
    if skewed:
        _create(both,
                f"create table fa as select case when x % 10 < 3 then 7 "
                f"else x % 200 end as k, x % 5 as g, (x % 40)::float / 4.0 as v "
                f"from range({N}) r(x)",
                f"create table fb as select case when x % 7 < 2 then 7 "
                f"else (x * 3) % 250 end as k, (x % 90)::float / 9.0 as w "
                f"from range({N}) r(x)")
    else:
        _create(both,
                f"create table fa as select x % 200 as k, x % 5 as g, "
                f"(x % 40)::float / 4.0 as v from range({N}) r(x)",
                f"create table fb as select (x * 3) % 250 as k, "
                f"(x % 90)::float / 9.0 as w from range({N}) r(x)")


def _oracle(skewed=False):
    x = np.arange(N)
    if skewed:
        ka = np.where(x % 10 < 3, 7, x % 200)
        kb = np.where(x % 7 < 2, 7, (x * 3) % 250)
    else:
        ka = x % 200
        kb = (x * 3) % 250
    g = x % 5
    v = (x % 40).astype(np.float64) / 4.0
    w = (x % 90).astype(np.float64) / 9.0
    return ka, kb, g, v, w


def _b_per_key(kb, w, bmask=None, size=300):
    sel = np.ones(len(kb), bool) if bmask is None else bmask
    cnt = np.bincount(kb[sel], minlength=size).astype(np.int64)
    sw = np.bincount(kb[sel], weights=w[sel], minlength=size)
    mn = np.full(size, np.inf)
    np.minimum.at(mn, kb[sel], w[sel])
    mx = np.full(size, -np.inf)
    np.maximum.at(mx, kb[sel], w[sel])
    return cnt, sw, mn, mx


def _same(rows, want, rel=1e-6):
    """Integers and NULLs exact, floats to ``rel`` (NaN equal to NaN)."""
    assert len(rows) == len(want), (rows, want)
    for a, b in zip(rows, want):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            if x is None or y is None or isinstance(x, int) and isinstance(y, int):
                assert x == y, (a, b)
            elif np.isnan(x) or np.isnan(y):
                assert np.isnan(x) and np.isnan(y), (a, b)
            else:
                assert x == pytest.approx(y, rel=rel), (a, b)


def _run(both, q, path=SJ, rel=1e-6):
    """The port's rows, held to infera_tpu's on the same path (``rel`` None:
    not compared, a logged R-case); returns both."""
    port, ref = both
    got = port.execute(q).rows
    assert port._exec_path == path, port._exec_path
    want = ref.execute(q).rows
    assert ref._exec_path == path, ref._exec_path
    if rel is not None:
        _same(got, want, rel)
    return got, want


def _host_rows(port, q, monkeypatch):
    """The port's host join over the same catalog (the join and shuffle
    tiers turned away); over 2**14 rows a side it is the device sort-join."""
    host = Connection(port.catalog)
    with monkeypatch.context() as m:
        m.setattr(sjp, "try_execute_shuffle_join", lambda *a, **k: None)
        m.setattr(djp, "try_execute_join_on_device", lambda *a, **k: None)
        m.setattr(dp, "try_execute_on_device", lambda *a, **k: None)
        rows = host.execute(q).rows
    assert host._exec_path in ("host", "device_join")
    return rows


# ---------------------------------------------------------------- tests/test_shuffle_join.py


@pytest.mark.parametrize("skewed", [False, True])
def test_shuffle_join_grouped(both, skewed):
    _mk(both, skewed)
    rows, _ = _run(both, "select g, count(*) c, sum(v) sv, sum(w) sw, avg(w) aw, "
                      "min(w) mnw, max(v) mxv from fa join fb on fa.k = fb.k "
                      "group by g order by g")
    ka, kb, g, v, w = _oracle(skewed)
    cnt, swk, mnk, _ = _b_per_key(kb, w)
    assert len(rows) == 5
    for key, c, sv, sw, aw, mnw, mxv in rows:
        m = g == key
        pairs = int(cnt[ka[m]].sum())
        assert c == pairs  # exact pair count
        assert sv == pytest.approx((v[m] * cnt[ka[m]]).sum(), rel=1e-6)
        assert sw == pytest.approx(swk[ka[m]].sum(), rel=1e-6)
        assert aw == pytest.approx(swk[ka[m]].sum() / pairs, rel=1e-6)
        live = m & (cnt[ka] > 0)
        assert mnw == pytest.approx(mnk[ka[live]].min())
        assert mxv == pytest.approx(v[live].max())


def test_shuffle_join_where_both_sides(both):
    _mk(both)
    ((c, sv, sw),), _ = _run(both, "select count(*) c, sum(v) sv, sum(w) sw from fa join fb "
                              "on fa.k = fb.k where v > 2.0 and w < 8.0")
    ka, kb, g, v, w = _oracle()
    am = v > 2.0
    cnt, swk, _, _ = _b_per_key(kb, w, w < 8.0)
    assert c == int(cnt[ka[am]].sum())
    assert sv == pytest.approx((v[am] * cnt[ka[am]]).sum(), rel=1e-6)
    assert sw == pytest.approx(swk[ka[am]].sum(), rel=1e-6)


def test_shuffle_join_host_parity(both, monkeypatch):
    """Row-exact agreement with the host join on a small instance."""
    _mk(both)
    q = ("select g, count(*) c, sum(w) sw from fa join fb on fa.k = fb.k "
         "group by g order by g")
    rows, _ = _run(both, q)
    hrows = _host_rows(both[0], q, monkeypatch)
    assert len(rows) == len(hrows)
    for a, b in zip(rows, hrows):
        assert a[0] == b[0] and a[1] == b[1]
        assert a[2] == pytest.approx(b[2], rel=1e-6)


def test_shuffle_join_mixed_side_product(both):
    """sum(f(a)*g(b)) decomposes through the per-key B partials; exact
    against the numpy pair oracle."""
    _mk(both, skewed=True)
    ka, kb, g, v, w = _oracle(skewed=True)
    cnt, sw, _mn, _mx = _b_per_key(kb, w)
    rows, _ = _run(both, "select sum(v * w), avg(v * w), count(*) from fa join fb on fa.k = fb.k")
    pair_sum = float((v * sw[ka]).sum())
    pair_cnt = int(cnt[ka].sum())
    assert rows[0][2] == pair_cnt
    assert rows[0][0] == pytest.approx(pair_sum, rel=1e-6)
    assert rows[0][1] == pytest.approx(pair_sum / pair_cnt, rel=1e-6)

    rows, _ = _run(both, "select g, sum(v * 2.0 * w) s, sum(v) sv from fa join fb "
                      "on fa.k = fb.k group by g order by g")
    for kg, s, sv in rows:
        m = g == kg
        assert s == pytest.approx(float((2.0 * v[m] * sw[ka[m]]).sum()), rel=1e-6)
        assert sv == pytest.approx(float((v[m] * cnt[ka[m]]).sum()), rel=1e-6)


def test_shuffle_join_ineligible_shapes(both):
    """Small inputs and a mixed-side WHERE stay on the host join, in both."""
    _create(both, "create table sa as select x % 5 as k, x as v from range(100) r(x)",
            "create table sb as select x % 5 as k, x as w from range(100) r(x)")
    rows, _ = _run(both, "select count(*) from sa join sb on sa.k = sb.k", path="host")
    assert rows[0][0] == 100 * 20
    _mk(both)
    port, ref = both
    q = "select count(*) from fa join fb on fa.k = fb.k where v + w > 100.0"
    assert port.execute(q).rows == ref.execute(q).rows
    assert port._exec_path == ref._exec_path != SJ


def test_count_nullable_arg_stays_off_shuffle_join(both):
    """count(expr) is the pair count only for an argument that is never
    NULL: a nullable argument takes the host join in both."""
    _create(both, f"create table na as select x % 50 as k from range({N}) r(x)",
            "create table nb as select x % 50 as k, case when x % 2 = 0 then NULL "
            "else (x * 1.0)::float end as w from range(4096) r(x)")
    port, ref = both
    q = "select count(w) from na join nb on na.k = nb.k"
    rows = port.execute(q).rows
    assert rows == ref.execute(q).rows
    assert port._exec_path == ref._exec_path != SJ
    per_key_nonnull = np.bincount((np.arange(4096) % 50)[np.arange(4096) % 2 == 1], minlength=50)
    assert rows[0][0] == int(per_key_nonnull[np.arange(N) % 50].sum())


def test_zero_pair_join_renders_null(both):
    """A join with no pairs answers count 0 and NULL aggregates."""
    _create(both, f"create table za as select x % 50 as k, (x * 1.0)::float as v "
                  f"from range({N}) r(x)",
            f"create table zb as select 1000 + x % 50 as k, (x * 2.0)::float as w "
            f"from range({N}) r(x)")
    rows, _ = _run(both, "select count(*), sum(w), min(w), avg(w) from za join zb on za.k = zb.k")
    assert rows[0] == (0, None, None, None)


# ---------------------------------------------------------------- edge cases


def test_group_key_past_2_24(both):
    """An A-side group key past 2**24 is read as int64: neighbouring keys
    stay apart and come back exact, in both packages. infera_tpu sums
    v·|B_k| in f32 (ROADMAP R19: 7e-6 off the oracle here): the port is
    held to the oracle at 1e-6 and to infera_tpu at 1e-5."""
    k0 = (1 << 25) + 3
    _create(both, f"create table ga as select x % 300 as k, {k0} + x % 6 as g, "
                  f"(x % 40)::float / 4.0 as v from range({N}) r(x)",
            f"create table gb as select (x * 7) % 250 as k, (x % 90)::float / 9.0 as w "
            f"from range({N}) r(x)")
    rows, _ = _run(both, "select g, count(*), sum(v), max(w) from ga join gb on ga.k = gb.k "
                         "group by g order by g", rel=1e-5)
    x = np.arange(N)
    ka, kb, v = x % 300, (x * 7) % 250, (x % 40) / 4.0
    cnt = np.bincount(kb, minlength=300)
    assert [r[0] for r in rows] == [k0 + j for j in range(6)]
    for (gk, c, sv, _mx), j in zip(rows, range(6)):
        m = x % 6 == j
        assert c == int(cnt[ka[m]].sum())
        assert sv == pytest.approx(float((v[m] * cnt[ka[m]]).sum()), rel=1e-6)


@pytest.mark.parametrize("top,path", [((1 << 31) - 1, "device_join"), ((1 << 31) - 2, SJ)])
def test_join_keys_at_the_int32_bounds(both, monkeypatch, top, path):
    """Join keys from -2**31 up: INT32_MAX is the B sort's filler, so a key
    of 2**31 - 1 is declined by both (the host join answers); up to
    2**31 - 2 both run the shuffle join. Rows equal the host join's, and
    infera_tpu's within its f32 sums (ROADMAP R19: 1e-5)."""
    lo = -(1 << 31)
    _create(both, f"create table ia as select case when x % 3 = 0 then {lo} + x % 1000 "
                  f"when x = 1 then {top} else x % 1000 end as k, (x % 9)::float as v "
                  f"from range({N}) r(x)",
            f"create table ib as select case when x % 5 = 0 then {lo} + x % 1100 "
            f"when x = 1 then {top} else x % 1200 end as k, (x % 13)::float as w "
            f"from range({1 << 15}) r(x)")
    q = "select count(*), sum(v), sum(w), min(w), max(v) from ia join ib on ia.k = ib.k"
    rows, _ = _run(both, q, path=path, rel=1e-5)
    _same(rows, _host_rows(both[0], q, monkeypatch))


def test_r18_nan_b_values_against_the_host(both, monkeypatch):
    """NaN B values: the key that holds one gives NaN sums, minima and
    maxima to the one group whose rows reach it, as the host join does.
    ROADMAP R18: infera_tpu's one-hot group-by (chunks of 2**17 rows or
    more, 512 groups or fewer) multiplies that NaN by the other groups'
    zeros, so every group's sum is NaN there."""
    _create(both, f"create table qa as select x % 400 as k, x % 4 as g, (x % 10)::float as v "
                  f"from range({N}) r(x)",
            f"create table qb as select x % 500 as k, case when x = 4321 then 'nan'::float "
            f"else (x % 17)::float end as w from range({1 << 15}) r(x)")
    q = ("select g, count(*), sum(w), min(w), max(w), avg(w), sum(v * w) from qa join qb "
         "on qa.k = qb.k group by g order by g")
    rows, want = _run(both, q, rel=None)
    _same(rows, _host_rows(both[0], q, monkeypatch))
    assert [bool(np.isnan(r[2])) for r in rows] == [False, True, False, False]
    assert all(np.isnan(r[2]) for r in want)


def test_explain_names_the_shuffle_join(both):
    _mk(both)
    port, _ = both
    lines = [r[0] for r in port.execute(
        "explain select count(*) from fa join fb on fa.k = fb.k").rows]
    assert any("shuffle join" in ln for ln in lines), lines


def test_shuffle_join_phases_fit_inside_the_query_wall_time(both):
    """Each phase times its own interval: together they take no more than
    the query's wall time."""
    _mk(both)
    port, _ = both
    t0 = time.perf_counter()
    port.execute("select g, count(*), sum(w) from fa join fb on fa.k = fb.k group by g")
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert port._exec_path == SJ
    ms = [port._last_phases[k] for k in ("plan_ms", "b_prepass_ms", "a_stream_ms",
                                         "assemble_ms")]
    assert all(v >= 0 for v in ms) and sum(ms) <= wall_ms, (ms, wall_ms)
