"""The port's device group-by (``infera_tpu_torch/ops/device_groupby.py``)
against ``infera_tpu``'s, on the CPU: the same dense ids and first rows, and
the same GROUP BY rows, in the same order, at 2^15 rows or more."""

import numpy as np
import pytest

import infera_tpu_torch as itt
from infera_tpu.columnar import Column as RefColumn
from infera_tpu.columnar import Table as RefTable
from infera_tpu.columnar import types as RT
from infera_tpu.ops.device_groupby import group_ids_device as ref_group_ids
from infera_tpu.sql import Connection as RefConnection
from infera_tpu_torch.columnar import Column, Table
from infera_tpu_torch.columnar import types as T
from infera_tpu_torch.ops import aggregate
from infera_tpu_torch.ops.device_groupby import group_ids_device
from infera_tpu_torch.sql import Connection


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.delenv("INFERA_PALLAS_SQL", raising=False)
    itt.set_device("cpu")
    yield
    itt.set_device(None)


def _assert_same_ids(values, sql_type, ref_type):
    got = group_ids_device([Column(values, sql_type)], len(values))
    want = ref_group_ids([RefColumn(values, ref_type)], len(values))
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    return got


def test_ids_of_tests_device_ops():
    """tests/test_device_ops.py:13's keys."""
    keys = np.random.default_rng(0).integers(0, 37, 5000).astype(np.int64)
    groups, firsts = _assert_same_ids(keys, T.BIGINT, RT.BIGINT)
    assert len(firsts) == len(np.unique(keys))
    for g in range(len(firsts)):
        assert (keys[groups == g] == keys[firsts[g]]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,domain", [(100, 5), (1000, 100), (3000, 2)])
def test_ids_of_tests_path_equivalence(seed, n, domain):
    """tests/test_path_equivalence.py:22's keys, negative ones included."""
    keys = np.random.default_rng(seed).integers(-domain, domain, n).astype(np.int64)
    _assert_same_ids(keys, T.BIGINT, RT.BIGINT)


def test_f64_keys_beyond_int32_do_not_merge():
    """tests/test_path_equivalence.py:69's keys: f64 bit patterns past int32
    are rank-remapped, not cut."""
    vals = np.tile(np.array([1.45, 1.95, 0.2, 0.7], np.float64), 4096)
    _, firsts = _assert_same_ids(vals, T.DOUBLE, RT.DOUBLE)
    assert len(firsts) == 4


def test_nan_keys_are_one_group_and_strings_are_codes():
    x = np.arange(3000, dtype=np.float64)
    vals = x % 7
    vals[::4] = np.nan
    _, firsts = _assert_same_ids(vals, T.DOUBLE, RT.DOUBLE)
    assert len(firsts) == 8
    words = np.array([f"w{i % 11}" for i in range(3000)], dtype=object)
    _assert_same_ids(words, T.VARCHAR, RT.VARCHAR)


def test_no_rows():
    ids, firsts = group_ids_device([Column(np.zeros(0, np.int64), T.BIGINT)], 0)
    assert ids.size == 0 and firsts.size == 0


N_PROBE = 40_000


def _both(columns):
    port, ref = Connection(), RefConnection()
    port.register_table("t", Table({k: Column(v, T.DOUBLE) for k, v in columns.items()}))
    ref.register_table("t", RefTable({k: RefColumn(v, RT.DOUBLE) for k, v in columns.items()}))
    return port, ref


def _same_rows(rows, want):
    assert len(rows) == len(want)
    for a, b in zip(rows, want):
        for x, y in zip(a, b):
            if isinstance(y, float) and np.isnan(y):
                assert np.isnan(x)
            else:
                assert x == pytest.approx(y, rel=1e-12)


def test_nan_key_probe_gives_infera_tpus_rows():
    """40,000 rows with a NaN key on every 4th row: one NaN group, so 4
    rows, in sorted key order, as infera_tpu answers (the dict path gave
    one group for each NaN row)."""
    assert N_PROBE >= aggregate.DEVICE_GROUPBY_THRESHOLD
    x = np.arange(N_PROBE, dtype=np.float64)
    k = x % 3
    k[::4] = np.nan
    port, ref = _both({"k": k, "f": x * 0.5})
    q = "select k, count(*), sum(f) from t group by k"
    rows = port.execute(q).rows
    assert len(rows) == 4
    _same_rows(rows, ref.execute(q).rows)
    assert [r[1] for r in rows] == [10000] * 4


def test_group_order_without_order_by_is_infera_tpus():
    port, ref = Connection(), RefConnection()
    for conn in (port, ref):
        conn.execute(f"create table t as select (x * 7) % 5 as g, x from range({N_PROBE}) r(x)")
    q = "select g, count(*), sum(x) from t group by g"
    rows = port.execute(q).rows
    assert [r[0] for r in rows] == [0, 1, 2, 3, 4]
    _same_rows(rows, ref.execute(q).rows)


def test_small_tables_keep_the_dict_path():
    """Below the threshold both packages group on the host: first-seen
    order, and one group for each NaN row (R9)."""
    x = np.arange(1000, dtype=np.float64)
    k = x % 3
    k[::4] = np.nan
    port, ref = _both({"k": k})
    q = "select k, count(*) from t group by k"
    rows = port.execute(q).rows
    assert len(rows) == 3 + 250
    _same_rows(rows, ref.execute(q).rows)
