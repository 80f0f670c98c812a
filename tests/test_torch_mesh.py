"""The port's mesh (``parallel/``) on the CPU against ``infera_tpu``'s.

The dp part of ``tests/test_parallel.py`` (:18-84, :128-160, :193-218)
runs here through both packages: the mesh's shape, the shuffle round trip,
the distributed query step against a single-device evaluation and against
``infera_tpu``'s step on the same draws, the skew split, the MLP's f32
precision, data-parallel ONNX and a GBT. The port's mesh is 8 shards on
``cpu``; ``infera_tpu``'s is the 8-device virtual CPU mesh of
``tests/conftest.py``. Then the collectives themselves, and exact SQL
results at 1, 2, 3, 8 and 13 shards with ragged row counts: the shard
count never changes a key, a count, an integer, a DISTINCT, a MODE, an
HLL estimate or a median.

Tolerances: counts, keys and row routing exact; the step's f32 sums 1e-5
relative (an MLP is read; the shards add in another order than one
device); ONNX outputs 1e-5 / 1e-6, ``tests/test_parallel.py``'s bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infera_tpu_torch as itt
from infera_tpu.parallel.mesh import make_mesh as ref_make_mesh
from infera_tpu.parallel.pipeline import example_inputs as ref_example_inputs
from infera_tpu.parallel.pipeline import make_distributed_query_step as ref_step
from infera_tpu_torch.parallel import mesh as M
from infera_tpu_torch.parallel import shuffle as S
from infera_tpu_torch.parallel.pipeline import (
    _bucket_slots,
    example_inputs,
    make_distributed_query_step,
    mlp_apply,
)
from infera_tpu_torch.sql import Connection
from infera_tpu_torch.sql import device_plan as dp


@pytest.fixture(scope="module")
def mesh():
    return M.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def ref_mesh():
    return ref_make_mesh(8)


def _numpy_step(params, x, keys, n_groups):
    h = x
    for i, (w, b) in enumerate(params):
        h = h @ w + b
        if i < len(params) - 1:
            h = np.maximum(h, 0)
    sel = h[:, 0] > 0
    sums, counts = np.zeros(n_groups), np.zeros(n_groups)
    np.add.at(sums, keys % n_groups, np.where(sel, h[:, 0], 0.0))
    np.add.at(counts, keys % n_groups, sel.astype(np.float64))
    return sums, counts, sel.sum()


def test_mesh_shape(mesh, ref_mesh):
    assert mesh.shape["dp"] == ref_mesh.shape["dp"] == 8
    assert mesh.shape["mp"] == ref_mesh.shape["mp"] == 1
    assert mesh.axis_names == tuple(ref_mesh.axis_names) == ("dp", "mp")
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert mesh.n_physical == 1 and mesh.local == list(range(8))
    m2 = M.make_mesh(8, mp=2, device="cpu")
    assert m2.shape == {"dp": 4, "mp": 2}
    with pytest.raises(ValueError, match="not divisible by mp"):
        M.make_mesh(6, mp=4, device="cpu")


def test_make_mesh_on_cuda_places_shards_on_cards(monkeypatch):
    """On CUDA shard i sits on cuda:(i % device_count), never on the CPU
    (the devices are only named here: no card is touched)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = M.make_mesh(5, device="cuda")
    assert [str(d) for d in m.devices.flat] == ["cuda:0", "cuda:1", "cuda:0", "cuda:1", "cuda:0"]
    assert m.n_physical == 2


def test_shuffle_roundtrip(mesh, ref_mesh):
    """Every row arrives exactly once at the shard owning its hash, the
    same rows in the same slots as infera_tpu's shuffle."""
    from infera_tpu.parallel.shuffle import shuffle_by_hash as ref_shuffle

    n = 8 * 64
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 30, n).astype(np.uint32)
    vals = rng.standard_normal(n).astype(np.float32)
    valid, keys_out, vals_out = S.shuffle_by_hash(
        mesh, torch.from_numpy(keys.astype(np.int64)),
        [torch.from_numpy(keys.astype(np.int32)), torch.from_numpy(vals)])
    valid, keys_out, vals_out = valid.numpy(), keys_out.numpy(), vals_out.numpy()
    got = sorted(zip(keys_out[valid].tolist(), vals_out[valid].tolist()))
    want = sorted(zip(keys.astype(np.int32).tolist(), vals.tolist()))
    assert got == want
    per_dev = len(valid) // 8
    for d in range(8):
        seg = slice(d * per_dev, (d + 1) * per_dev)
        assert (keys_out[seg][valid[seg]].astype(np.uint32) % 8 == d).all()
    rv, rk, rvals = (np.asarray(a) for a in ref_shuffle(
        ref_mesh, jnp.asarray(keys), [jnp.asarray(keys.astype(np.int32)), jnp.asarray(vals)]))
    np.testing.assert_array_equal(valid, rv)
    np.testing.assert_array_equal(keys_out[valid], rk[rv])
    np.testing.assert_array_equal(vals_out[valid], rvals[rv])


def test_distributed_step_matches_single_device_and_the_reference(mesh, ref_mesh):
    n_rows, in_dim, out_dim, n_groups = 8 * 32, 8, 4, 8
    cap = n_rows // 8
    params, x, keys = example_inputs(mesh, n_rows, in_dim, out_dim, n_groups)
    sums, counts, total = make_distributed_query_step(mesh, n_groups, cap)(params, x, keys)
    rparams, rx, rkeys = ref_example_inputs(ref_mesh, n_rows, in_dim, out_dim, n_groups)
    np.testing.assert_array_equal(torch.cat(x).numpy(), np.asarray(rx))
    np.testing.assert_array_equal(torch.cat(keys).numpy(), np.asarray(rkeys))
    for (w, b), (rw, rb) in zip(params[0], rparams):
        np.testing.assert_array_equal(w.numpy(), np.asarray(rw))
    ws, wc, wt = _numpy_step([(np.asarray(w), np.asarray(b)) for w, b in rparams],
                             np.asarray(rx), np.asarray(rkeys), n_groups)
    assert float(total) == float(wt)
    np.testing.assert_array_equal(counts.numpy(), wc)
    np.testing.assert_allclose(sums.numpy(), ws, rtol=1e-5, atol=1e-5)
    rs, rc, rt = (np.asarray(a) for a in jax.block_until_ready(
        ref_step(ref_mesh, n_groups=n_groups, cap=cap)(rparams, rx, rkeys)))
    np.testing.assert_array_equal(counts.numpy(), rc)
    assert float(total) == float(rt)
    np.testing.assert_allclose(sums.numpy(), rs, rtol=1e-5, atol=1e-5)


def test_example_inputs_take_a_generator(mesh):
    g = torch.Generator().manual_seed(5)
    a = example_inputs(mesh, 64, 4, 2, 8, generator=g)
    b = example_inputs(mesh, 64, 4, 2, 8, seed=5)
    assert all(torch.equal(u, v) for u, v in zip(a[1], b[1]))


def test_mlp_apply_precision():
    rng = np.random.default_rng(0)
    w1, w2 = rng.standard_normal((4, 8)), rng.standard_normal((8, 2))
    x = rng.standard_normal((16, 4))
    params = [(torch.tensor(w1, dtype=torch.float32), torch.zeros(8)),
              (torch.tensor(w2, dtype=torch.float32), torch.zeros(2))]
    out = mlp_apply(params, torch.tensor(x, dtype=torch.float32))
    want = np.maximum(x.astype(np.float32) @ w1.astype(np.float32), 0) @ w2.astype(np.float32)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hot_factor", [2.0, 4.0])
def test_skewed_keys_with_split_matches_reference(mesh, ref_mesh, hot_factor):
    """A 90 %-hot key: the split keeps the results exact and spreads the
    hot partition's rows over every shard, as infera_tpu's split does."""
    from infera_tpu.parallel.shuffle import skew_split_partitions as ref_split

    n_rows, in_dim, out_dim, n_groups = 8 * 64, 8, 4, 8
    cap = n_rows // 8
    params, x, _ = example_inputs(mesh, n_rows, in_dim, out_dim, n_groups)
    rng = np.random.default_rng(7)
    raw = np.where(rng.random(n_rows) < 0.9, 3, rng.integers(0, n_groups, n_rows))
    step = make_distributed_query_step(mesh, n_groups, cap, skew_split=True,
                                       hot_factor=hot_factor)
    sums, counts, total = step(params, x, raw.astype(np.int64))
    ws, wc, wt = _numpy_step([(w.numpy(), b.numpy()) for w, b in params[0]],
                             torch.cat(x).numpy(), raw, n_groups)
    np.testing.assert_array_equal(counts.numpy(), wc)
    np.testing.assert_allclose(sums.numpy(), ws, rtol=1e-5, atol=1e-5)
    assert float(total) == float(wt)
    parts = [torch.from_numpy(p % 8) for p in np.split(raw, 8)]
    split = torch.cat(S.skew_split_partitions(mesh, parts, hot_factor)).numpy()
    sharding = jax.sharding.NamedSharding(ref_mesh, jax.sharding.PartitionSpec("dp"))
    ref = jax.jit(jax.shard_map(lambda p: ref_split(p, 8, "dp", hot_factor), mesh=ref_mesh,
                                in_specs=jax.sharding.PartitionSpec("dp"),
                                out_specs=jax.sharding.PartitionSpec("dp"),
                                check_vma=False))(
        jax.device_put(jnp.asarray((raw % 8).astype(np.int32)), sharding))
    np.testing.assert_array_equal(split, np.asarray(ref))
    assert len(np.unique(split[raw == 3])) == 8


def test_bucket_slots_mirror_the_packing():
    part = torch.tensor([2, 0, 2, 1, 0, 2])
    assert _bucket_slots(part, 3).tolist() == [0, 0, 1, 0, 1, 2]
    packed, valid = S._pack_buckets(part, [torch.arange(6)], 3, 3)
    slots = _bucket_slots(part, 3)
    assert all(packed[0][int(p), int(s)] == i for i, (p, s) in enumerate(zip(part, slots)))
    assert valid.sum() == 6


def test_pack_buckets_drops_rows_past_the_cap():
    packed, valid = S._pack_buckets(torch.tensor([1, 1, 1, 0]), [torch.tensor([5, 6, 7, 8])], 2, 2)
    assert valid.tolist() == [[True, False], [True, True]]
    assert packed[0].tolist() == [[8, 0], [5, 6]]


@pytest.mark.parametrize("model_kind", ["mlp", "gbt"])
def test_onnx_model_data_parallel_inference(mesh, ref_mesh, model_kind):
    """Any model runs dp-sharded and equals its single-device run and
    infera_tpu's run_data_parallel; a row count dp does not divide raises."""
    from infera_tpu.onnx import builder as ref_builder
    from infera_tpu.onnx.executor import compile_model_bytes as ref_compile
    from infera_tpu_torch.errors import OnnxError
    from infera_tpu_torch.onnx.executor import compile_model_bytes

    if model_kind == "mlp":
        data = ref_builder.mlp_model(in_dim=8, hidden=(16,), out_dim=4).serialize()
        x = np.random.default_rng(0).standard_normal((8 * 16, 8)).astype(np.float32)
    else:
        data = ref_builder.gbt_regressor_model(n_features=4, n_trees=4, depth=3).serialize()
        x = np.random.default_rng(1).standard_normal((8 * 8, 4)).astype(np.float32)
    model = compile_model_bytes(data, "m", device="cpu")
    sharded = model.run_data_parallel(mesh, x)[0].numpy()
    np.testing.assert_allclose(sharded, model.run(x)[0].numpy(), rtol=1e-5, atol=1e-6)
    ref = np.asarray(ref_compile(data, "r").run_data_parallel(ref_mesh, jnp.asarray(x))[0])
    np.testing.assert_allclose(sharded, ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(OnnxError, match="do not split evenly"):
        model.run_data_parallel(mesh, x[:13])


def test_collectives(mesh):
    xs = [torch.tensor([float(i), -float(i)]) for i in range(8)]
    assert [t.tolist() for t in M.psum(mesh, xs)] == [[28.0, -28.0]] * 8
    assert M.pmin(mesh, xs)[3].tolist() == [0.0, -7.0]
    assert M.pmax(mesh, xs)[5].tolist() == [7.0, 0.0]
    assert M.psum(mesh, [torch.tensor(True)] * 8)[0].item() == 8
    nan = [torch.tensor([1.0])] * 7 + [torch.tensor([float("nan")])]
    assert torch.isnan(M.pmin(mesh, nan)[0]).all()
    gathered = M.all_gather(mesh, [torch.tensor([i, 10 * i]) for i in range(8)])
    assert gathered[2].tolist() == [v for i in range(8) for v in (i, 10 * i)]
    a2a = M.all_to_all(mesh, [torch.arange(8) + 100 * s for s in range(8)])
    assert a2a[3].tolist() == [3 + 100 * s for s in range(8)]
    with pytest.raises(ValueError, match="all_to_all needs"):
        M.all_to_all(mesh, [torch.zeros(3)] * 8)


def test_shard_rows_pad_and_mask(mesh):
    shards, valid = M.shard_rows(mesh, np.arange(13, dtype=np.int64))
    assert [len(s) for s in shards] == [2] * 8
    assert torch.cat(shards)[:13].tolist() == list(range(13))
    assert torch.cat(valid).tolist() == [True] * 13 + [False] * 3
    assert [r.tolist() for r in M.replicate(mesh, np.array([1, 2]))] == [[1, 2]] * 8


N = dp.MIN_DEVICE_ROWS * 2 + 13
EXACT = [
    "select g, h, count(*), sum(v), min(v), max(v) from t where f > 1.0 group by g, h "
    "order by g, h",
    "select g, count(distinct d), sum(distinct d), mode(d), approx_count_distinct(d) "
    "from t group by g order by g",
    "select g, median(f), quantile_disc(f, 0.3), quantile_cont(f, 0.8) from t group by g "
    "order by g",
    "select g, arg_max(id, f), arg_min(id, f), count_if(f > 2.0) from t group by g order by g",
]


@pytest.fixture(scope="module")
def exact_host():
    itt.set_device("cpu")
    conn = Connection()
    conn.execute(f"create table t as select x % 11 as g, x % 3 as h, x as id, "
                 f"{(1 << 45) + 1} + x * 3 as v, (x * 7) % 37 as d, "
                 f"((x * 13) % 101)::float / 8.0 as f from range({N}) r(x)")
    host = Connection(conn.catalog)
    saved = dp.try_execute_on_device
    dp.try_execute_on_device = lambda *a, **k: None
    try:
        rows = [host.execute(q).rows for q in EXACT]
    finally:
        dp.try_execute_on_device = saved
    yield conn, rows
    itt.set_device(None)


@pytest.mark.parametrize("shards", [1, 2, 3, 8, 13])
def test_exact_results_do_not_depend_on_the_shard_count(exact_host, shards):
    """At 1, 2, 3, 8 and 13 shards over 32,781 rows (ragged for each):
    keys, counts, int64 sums past 2**53 and extremes, DISTINCT, MODE, HLL,
    arg rows, medians and quantiles all equal the host's exactly."""
    itt.set_device("cpu")
    conn, want = exact_host
    conn.set_mesh(shards)
    try:
        for q, rows in zip(EXACT, want):
            assert conn.execute(q).rows == rows, q
            assert conn._exec_path == "device_plan_mesh"
    finally:
        conn.set_mesh(None)
