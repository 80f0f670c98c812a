"""The port's model-parallel forms and ``mp`` collectives on the CPU against
``infera_tpu``'s.

Mirrors of four tests of ``tests/test_parallel.py`` (:163, :220, :245,
:276): tensor-parallel MLP, GPipe pipeline, expert-parallel routing and ring
attention (causal and not). Each feeds the same seeded numpy inputs through
``infera_tpu`` (the 8 virtual CPU devices of ``tests/conftest.py``) and the
port (8 logical shards on ``cpu``) and holds both to the numpy oracle and
to each other. Then expert routing with ``cap`` below the largest bucket,
the ``mp`` collectives (``psum``, ``all_gather``, ``all_to_all``,
``ppermute`` with a partial ``perm``) and the ``dp`` collectives, which an
``mp`` axis must leave as they were.

Tolerance: 1e-5 relative and absolute, ``tests/test_parallel.py``'s bound
(the port's products are f32 ``torch.matmul``, the reference's f32
``jnp.dot`` at HIGHEST; they add in another order). Routed counts, dropped
rows and zero fills exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infera_tpu.parallel.mesh import make_mesh as ref_make_mesh
from infera_tpu.parallel.pipeline import make_ep_inference_step as ref_ep
from infera_tpu.parallel.pipeline import make_pp_inference_step as ref_pp
from infera_tpu.parallel.pipeline import make_tp_inference_step as ref_tp
from infera_tpu.parallel.ring_attention import make_ring_attention_step as ref_ring
from infera_tpu_torch.parallel import mesh as M
from infera_tpu_torch.parallel.pipeline import (
    make_ep_inference_step,
    make_pp_inference_step,
    make_tp_inference_step,
)
from infera_tpu_torch.parallel.ring_attention import make_ring_attention_step

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


def test_tensor_parallel_mlp_matches_replicated():
    """(dp=4, mp=2): column/row-sharded weights + psum equal the replicated
    MLP, and infera_tpu's step on the same draws."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax

    rng = np.random.default_rng(0)
    d_in, hidden, d_out, n = 8, 32, 4, 4 * 16
    w1 = rng.standard_normal((d_in, hidden)).astype(np.float32) * 0.3
    b1 = rng.standard_normal(hidden).astype(np.float32) * 0.1
    w2 = rng.standard_normal((hidden, d_out)).astype(np.float32) * 0.3
    b2 = rng.standard_normal(d_out).astype(np.float32) * 0.1
    x = rng.standard_normal((n, d_in)).astype(np.float32)

    mesh = M.make_mesh(8, mp=2, device="cpu")
    got = make_tp_inference_step(mesh)(((w1, b1), (w2, b2)), x)
    assert got.shape == (n, d_out) and got.dtype == torch.float32

    rmesh = ref_make_mesh(8, mp=2)
    params = (
        (jax.device_put(jnp.asarray(w1), NamedSharding(rmesh, P(None, "mp"))),
         jax.device_put(jnp.asarray(b1), NamedSharding(rmesh, P("mp")))),
        (jax.device_put(jnp.asarray(w2), NamedSharding(rmesh, P("mp", None))),
         jax.device_put(jnp.asarray(b2), NamedSharding(rmesh, P()))),
    )
    ref = ref_tp(rmesh)(params, jax.device_put(jnp.asarray(x),
                                               NamedSharding(rmesh, P("dp", None))))
    want = np.maximum(x @ w1 + b1, 0) @ w2 + b2
    _close(got, want, rtol=1e-4, atol=1e-5)
    _close(got, ref)


def test_tensor_parallel_takes_grid_lists():
    """Arguments already sharded (grid lists) give what global arrays do."""
    rng = np.random.default_rng(3)
    w1, w2 = (rng.standard_normal(s).astype(np.float32) for s in ((8, 16), (16, 4)))
    b1, b2 = np.zeros(16, np.float32), np.ones(4, np.float32)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    mesh = M.make_mesh(8, mp=2, device="cpu")
    step = make_tp_inference_step(mesh)
    sharded = ((M.shard(mesh, w1, (None, "mp")), M.shard(mesh, b1, ("mp",))),
               (M.shard(mesh, w2, ("mp", None)), M.shard(mesh, b2, ())))
    a = step(sharded, M.shard(mesh, x, ("dp", None)))
    b = step(((w1, b1), (w2, b2)), torch.from_numpy(x))
    assert torch.equal(a, b)


def test_pipeline_parallel_matches_sequential():
    """GPipe over mp=4 equals the sequential stack and infera_tpu's step."""
    n_stages, n_micro, mb, d = 4, 6, 8, 16
    rng = np.random.default_rng(0)
    W = rng.standard_normal((n_stages, d, d)).astype(np.float32) * np.float32(0.3)
    B = rng.standard_normal((n_stages, d)).astype(np.float32) * np.float32(0.1)
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)

    got = make_pp_inference_step(M.make_mesh(4, mp=4, device="cpu"), n_stages, n_micro)(
        (W, B), x)
    ref = ref_pp(ref_make_mesh(4, mp=4), n_stages, n_micro)(
        (jnp.asarray(W), jnp.asarray(B)), jnp.asarray(x))
    h = x.reshape(-1, d)
    for s in range(n_stages):
        h = np.maximum(h @ W[s] + B[s], 0.0)
    want = h.reshape(n_micro, mb, d)
    assert got.shape == (n_micro, mb, d)
    _close(got, want)
    _close(got, ref)


def test_pipeline_replicated_over_dp():
    """A (dp=2, mp=4) mesh runs the pipeline on each dp row: the same
    answer as dp=1 (infera_tpu's x and y are replicated on dp)."""
    n_stages, n_micro, mb, d = 4, 3, 4, 8
    rng = np.random.default_rng(5)
    W = rng.standard_normal((n_stages, d, d)).astype(np.float32) * np.float32(0.3)
    B = np.zeros((n_stages, d), np.float32)
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    a = make_pp_inference_step(M.make_mesh(8, mp=4, device="cpu"), n_stages, n_micro)((W, B), x)
    b = make_pp_inference_step(M.make_mesh(4, mp=4, device="cpu"), n_stages, n_micro)((W, B), x)
    ref = ref_pp(ref_make_mesh(8, mp=4), n_stages, n_micro)(
        (jnp.asarray(W), jnp.asarray(B)), jnp.asarray(x))
    assert torch.equal(a, b)
    _close(a, ref)


def _ep_inputs(seed=1, n_experts=4, d=8, n=64):
    rng = np.random.default_rng(seed)
    EW = rng.standard_normal((n_experts, d, d)).astype(np.float32) * np.float32(0.4)
    EB = rng.standard_normal((n_experts, d)).astype(np.float32) * np.float32(0.1)
    x = rng.standard_normal((n, d)).astype(np.float32)
    eid = rng.integers(0, n_experts, n).astype(np.int32)
    return EW, EB, x, eid


def _ep_dense(EW, EB, x, eid):
    return np.maximum(np.einsum("nd,nde->ne", x, EW[eid]) + EB[eid], 0.0)


def _ep_kept(eid, n_experts, n_shards, cap):
    """A numpy model of the packing: (kept, last_kept). A row is kept when
    fewer than ``cap`` earlier rows of its source shard go to its expert;
    ``last_kept`` marks the kept row of rank ``cap - 1`` in a bucket that
    overflows."""
    loc = len(eid) // n_shards
    kept = np.zeros(len(eid), bool)
    last = np.zeros(len(eid), bool)
    for s in range(n_shards):
        for e in range(n_experts):
            rows = np.nonzero(eid[s * loc:(s + 1) * loc] % n_experts == e)[0] + s * loc
            kept[rows[:cap]] = True
            if len(rows) > cap:
                last[rows[cap - 1]] = True
    return kept, last


def test_expert_parallel_routing_matches_dense():
    """Every row gets its own expert's output; ``routed`` counts them all."""
    n_experts = 4
    EW, EB, x, eid = _ep_inputs()
    n = len(x)
    got, routed = make_ep_inference_step(M.make_mesh(4, mp=4, device="cpu"), n_experts,
                                         cap=n)(EW, EB, x, eid)
    ref, ref_routed = ref_ep(ref_make_mesh(4, mp=4), n_experts, cap=n)(
        jnp.asarray(EW), jnp.asarray(EB), jnp.asarray(x), jnp.asarray(eid))
    assert int(routed) == int(ref_routed) == n
    _close(got, _ep_dense(EW, EB, x, eid))
    _close(got, ref)


@pytest.mark.parametrize("cap", [1, 3])
def test_expert_parallel_past_cap(cap):
    """``cap`` below the largest (source, expert) bucket: the rows the
    numpy model of the packing drops give 0 and are not counted, in both
    packages; every kept row equals the dense oracle.

    infera_tpu differs on one row a full bucket: its ``_pack_buckets``
    scatters the dropped rows' zeros onto slot ``cap - 1``
    (``infera_tpu/parallel/shuffle.py:36,42``), and XLA's CPU scatter lets
    the last write win, so the kept row of rank ``cap - 1`` comes back as
    its expert applied to a zero row, ``relu(b)``. The port writes kept
    rows only and returns that row's own value."""
    n_experts = 4
    EW, EB, x, eid = _ep_inputs()
    got, routed = make_ep_inference_step(M.make_mesh(4, mp=4, device="cpu"), n_experts,
                                         cap=cap)(EW, EB, x, eid)
    ref, ref_routed = ref_ep(ref_make_mesh(4, mp=4), n_experts, cap=cap)(
        jnp.asarray(EW), jnp.asarray(EB), jnp.asarray(x), jnp.asarray(eid))
    got, ref = got.numpy(), np.asarray(ref)
    kept, last = _ep_kept(eid, n_experts, 4, cap)
    assert 0 < kept.sum() < len(x) and last.any()
    assert int(routed) == int(ref_routed) == int(kept.sum())
    dense = _ep_dense(EW, EB, x, eid)
    assert (got[~kept] == 0).all() and (ref[~kept] == 0).all()
    _close(got[kept], dense[kept])
    _close(got[kept & ~last], ref[kept & ~last])
    _close(ref[last], np.maximum(EB[eid[last]], 0.0))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_dense(causal):
    """Ring attention over mp=4 equals dense softmax attention and
    infera_tpu's ring."""
    seq, d = 32, 16
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((seq, d)).astype(np.float32) for _ in range(3))
    got = make_ring_attention_step(M.make_mesh(4, mp=4, device="cpu"), causal=causal)(q, k, v)
    ref = ref_ring(ref_make_mesh(4, mp=4), causal=causal)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    scores = (q @ k.T) / np.sqrt(d)
    if causal:
        scores = np.where(np.triu(np.ones((seq, seq), bool), 1), -np.inf, scores)
    w = np.exp(scores - scores.max(axis=1, keepdims=True))
    want = (w / w.sum(axis=1, keepdims=True)) @ v
    assert got.shape == (seq, d)
    _close(got, want)
    _close(got, ref)


def test_ring_attention_on_a_dp_by_mp_mesh():
    """(dp=4, mp=2), as the dry run builds it: each dp row runs the ring."""
    seq, d = 16, 8
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((seq, d)).astype(np.float32) for _ in range(3))
    got = make_ring_attention_step(M.make_mesh(8, mp=2, device="cpu"), causal=True)(q, k, v)
    ref = ref_ring(ref_make_mesh(8, mp=2), causal=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(got, ref)


@pytest.fixture(scope="module")
def grid():
    """(dp=2, mp=4); shard (i, j) of a grid list holds 10 * i + j."""
    mesh = M.make_mesh(8, mp=4, device="cpu")
    return mesh, [torch.tensor([10.0 * i + j, 1.0]) for i in range(2) for j in range(4)]


def test_mp_psum_and_all_gather(grid):
    mesh, xs = grid
    assert len(mesh.local_grid) == 8 and mesh.local_devices == [torch.device("cpu")] * 2
    sums = M.psum(mesh, xs, axis="mp")
    assert [t.tolist() for t in sums] == [[6.0, 4.0]] * 4 + [[46.0, 4.0]] * 4
    gathered = M.all_gather(mesh, xs, axis="mp")
    assert gathered[6].tolist() == [10, 1, 11, 1, 12, 1, 13, 1]
    with pytest.raises(ValueError, match="grid list of 8"):
        M.psum(mesh, xs[:2], axis="mp")
    with pytest.raises(ValueError, match="no mesh axis"):
        M.psum(mesh, xs, axis="tp")


def test_mp_all_to_all(grid):
    mesh, _ = grid
    # shard (i, j) sends row d = 100 * i + 10 * j + d to shard (i, d)
    xs = [torch.tensor([100 * i + 10 * j + d for d in range(4)]) for i in range(2)
          for j in range(4)]
    got = M.all_to_all(mesh, xs, axis="mp")
    for i in range(2):
        for d in range(4):
            assert got[4 * i + d].tolist() == [100 * i + 10 * s + d for s in range(4)]
    with pytest.raises(ValueError, match="all_to_all needs"):
        M.all_to_all(mesh, [torch.zeros(3)] * 8, axis="mp")


def test_mp_ppermute_partial_perm_fills_zeros(grid):
    """A shard that no pair names as a destination receives zeros, as
    ``jax.lax.ppermute`` (the pipeline's stage 0 relies on it)."""
    mesh, xs = grid
    got = M.ppermute(mesh, xs, [(0, 1), (1, 2), (2, 3)])
    want = [[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [2.0, 1.0],
            [0.0, 0.0], [10.0, 1.0], [11.0, 1.0], [12.0, 1.0]]
    assert [t.tolist() for t in got] == want
    ring = M.ppermute(mesh, xs, [(j, (j + 1) % 4) for j in range(4)])
    assert [t[0].item() for t in ring] == [3, 0, 1, 2, 13, 10, 11, 12]
    with pytest.raises(ValueError, match="distinct sources"):
        M.ppermute(mesh, xs, [(0, 1), (2, 1)])


def test_dp_collectives_unchanged_by_the_mp_axis():
    """``axis="dp"`` (the default) over dp lists, on a mesh with mp=1 and on
    one with mp=2: the same results as before the mp axis, and an explicit
    ``axis="dp"`` equals the default."""
    for mp in (1, 2):
        mesh = M.make_mesh(8, mp=mp, device="cpu")
        dp = mesh.shape["dp"]
        xs = [torch.tensor([float(i), -float(i)]) for i in range(dp)]
        total = float(sum(range(dp)))
        assert [t.tolist() for t in M.psum(mesh, xs)] == [[total, -total]] * dp
        assert M.psum(mesh, xs, axis="dp")[0].tolist() == [total, -total]
        assert M.pmin(mesh, xs)[1].tolist() == [0.0, -(dp - 1.0)]
        assert M.all_gather(mesh, xs)[0].tolist() == [v for i in range(dp)
                                                      for v in (i, -i)]
        sends = [torch.tensor([100 * s + d for d in range(dp)]) for s in range(dp)]
        assert M.all_to_all(mesh, sends)[1].tolist() == [100 * s + 1 for s in range(dp)]
        with pytest.raises(ValueError, match="over mp only"):
            M.ppermute(mesh, xs, [(0, 1)], axis="dp")


def test_shard_and_gather_round_trip():
    mesh = M.make_mesh(8, mp=2, device="cpu")
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for spec in ((), ("dp", None), (None, "mp"), ("dp", "mp")):
        parts = M.shard(mesh, x, spec)
        assert len(parts) == 8
        assert torch.equal(M.gather(mesh, parts, spec), x)
    assert M.shard(mesh, x, ("dp", "mp"))[3].tolist() == [[15.0, 16.0, 17.0], [21.0, 22.0, 23.0]]
    with pytest.raises(ValueError, match="does not split evenly"):
        M.shard(mesh, torch.zeros(8, 5), (None, "mp"))
