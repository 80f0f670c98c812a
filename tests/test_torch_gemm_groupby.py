"""The port's ``ops/gemm_groupby.py`` against numpy and ``infera_tpu``'s
one-hot matmul reductions (``tests/test_gemm_groupby.py``'s cases), with the
same inputs made from a numpy seed. The port sums in f64 and counts in
int64, so its sums are held to numpy's f64 sums at 1e-12 and to
``infera_tpu``'s f32 sums at the reference test's bounds; minima, maxima,
integer sums and counts are exact."""

import numpy as np
import pytest
import torch

from infera_tpu_torch.ops import gemm_groupby as GG

I32_MAX, I32_MIN = 2**31 - 1, -(2**31)


def _ref():
    import jax
    import jax.numpy as jnp

    from infera_tpu.ops import gemm_groupby as RG

    return jax, jnp, RG


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,G", [(1 << 17, 64), ((1 << 17) + 777, 13), (4096, 512)])
def test_segment_sum_matches_numpy(n, G):
    rng = np.random.default_rng(n % 97)
    keys = rng.integers(0, G, n).astype(np.int32)
    vals = rng.standard_normal(n).astype(np.float32)
    got = GG.segment_sum(_t(vals), _t(keys).long(), G).numpy()
    want = np.zeros(G)
    np.add.at(want, keys, vals.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    jax, jnp, RG = _ref()
    ref = np.asarray(RG.segment_sum(jnp, jax, jnp.asarray(vals), jnp.asarray(keys), G))
    np.testing.assert_allclose(got, ref, atol=5e-3)


def test_segment_sum_multi_slot():
    rng = np.random.default_rng(0)
    n, G = 100000, 32
    keys = rng.integers(0, G, n).astype(np.int32)
    a = rng.standard_normal(n).astype(np.float32)
    outs = GG.segment_sum([_t(a), _t(a * 3)], _t(keys).long(), G)
    w = np.zeros(G)
    np.add.at(w, keys, a.astype(np.float64))
    w3 = np.zeros(G)
    np.add.at(w3, keys, (a * 3).astype(np.float64))
    np.testing.assert_allclose(outs[0].numpy(), w, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(outs[1].numpy(), w3, rtol=1e-12, atol=1e-9)
    jax, jnp, RG = _ref()
    ref = RG.segment_sum(jnp, jax, [jnp.asarray(a), jnp.asarray(a * 3)], jnp.asarray(keys), G)
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(ref[0]), atol=5e-3)
    np.testing.assert_allclose(outs[1].numpy(), np.asarray(ref[1]), atol=2e-2)


def test_key_g_drops_a_row():
    """A row whose key is G adds to no group (the WHERE's dropped rows)."""
    keys = torch.tensor([0, 1, 2, 1, 2])
    got = GG.segment_sum(torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0]), keys, 2)
    assert got.tolist() == [1.0, 10.0]


def test_segment_minmax_with_masks_and_empty_groups():
    rng = np.random.default_rng(1)
    n, G = 50000, 16
    keys = rng.integers(0, G - 2, n).astype(np.int32)  # last 2 groups empty
    vals = rng.standard_normal(n).astype(np.float32)
    m = vals > 0.5
    (mns,), (mxs,) = GG.segment_minmax([_t(vals)], _t(keys).long(), G, [_t(m)])
    mns, mxs = mns.numpy(), mxs.numpy()
    for g in range(G):
        sel = (keys == g) & m
        if sel.any():
            assert mns[g] == vals[sel].min()
            assert mxs[g] == vals[sel].max()
        else:
            assert mns[g] == np.inf and mxs[g] == -np.inf
    jax, jnp, RG = _ref()
    (rmn,), (rmx,) = RG.segment_minmax(jnp, jax, [jnp.asarray(vals)], jnp.asarray(keys), G,
                                       [jnp.asarray(m)])
    np.testing.assert_array_equal(mns, np.asarray(rmn))
    np.testing.assert_array_equal(mxs, np.asarray(rmx))


def test_segment_minmax_propagates_nan():
    vals = torch.tensor([1.0, float("nan"), 3.0, -2.0])
    (mn,), (mx,) = GG.segment_minmax([vals], torch.tensor([0, 0, 1, 1]), 2)
    assert np.isnan(mn[0].item()) and np.isnan(mx[0].item())
    assert (mn[1].item(), mx[1].item()) == (-2.0, 3.0)


def test_segment_minmax_int32_exact_beyond_f32():
    """Values above 2^24 (where an f32 reduction would round) stay exact."""
    rng = np.random.default_rng(2)
    n, G = 40000, 8
    keys = rng.integers(0, G, n).astype(np.int32)
    k = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    k[0], k[1] = 2**30 + 1, 2**30 + 2
    keys[0] = keys[1] = 0
    mn, mx = GG.segment_minmax_int32(_t(k), _t(keys).long(), G, torch.ones(n, dtype=torch.bool))
    assert mn.dtype == mx.dtype == torch.int32
    wmn = np.full(G, I32_MAX, np.int64)
    wmx = np.full(G, I32_MIN, np.int64)
    np.minimum.at(wmn, keys, k.astype(np.int64))
    np.maximum.at(wmx, keys, k.astype(np.int64))
    np.testing.assert_array_equal(mn.numpy(), wmn)
    np.testing.assert_array_equal(mx.numpy(), wmx)
    jax, jnp, RG = _ref()
    rmn, rmx = RG.segment_minmax_int32(jnp, jax, jnp.asarray(k), jnp.asarray(keys), G,
                                       jnp.asarray(np.ones(n, bool)))
    np.testing.assert_array_equal(mn.numpy(), np.asarray(rmn))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(rmx))


def test_segment_sum_int_exact_matches_the_reference_limb_sums():
    """int64 sums, exact; on 8-bit limb rows infera_tpu's int32 result."""
    rng = np.random.default_rng(4)
    n, G = 70000, 24
    keys = rng.integers(0, G, n).astype(np.int32)
    rows = [rng.integers(0, 256, n).astype(np.int32) for _ in range(3)]
    got = GG.segment_sum_int_exact([_t(r) for r in rows], _t(keys).long(), G)
    jax, jnp, RG = _ref()
    ref = RG.segment_sum_int_exact(jnp, jax, [jnp.asarray(r) for r in rows],
                                   jnp.asarray(keys), G)
    for g, r, w in zip(got, ref, rows):
        want = np.zeros(G, np.int64)
        np.add.at(want, keys, w.astype(np.int64))
        np.testing.assert_array_equal(g.numpy(), want)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    wide = torch.tensor([2**62, 2**62, 2**62, -5])   # wraps modulo 2**64 as int64
    (s,) = GG.segment_sum_int_exact([wide], torch.tensor([0, 0, 0, 1]), 2)
    assert s.tolist() == [np.int64(3 * 2**62 - 2**64), -5]


@pytest.mark.parametrize("is_min", [True, False])
def test_segment_lex_minmax_matches_the_reference(is_min):
    """The (hi, lo-biased) int32 word contract, empty groups included."""
    rng = np.random.default_rng(5)
    n, G = 30000, 10
    v = rng.integers(-2**62, 2**62, n).astype(np.int64)
    v[:8] = [2**40, 2**40 + 1, -2**40, -2**40 - 1, 0, -1, 2**32 - 1, 2**32]
    keys = rng.integers(0, G - 1, n).astype(np.int32)   # group G-1 empty
    mask = rng.random(n) < 0.7
    lo = (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    hi = (v >> 32).astype(np.int32)
    lo_b = lo ^ np.int32(I32_MIN)
    got = GG.segment_lex_minmax(_t(lo_b), _t(hi), _t(keys).long(), G, _t(mask), is_min)
    jax, jnp, RG = _ref()
    ref = RG.segment_lex_minmax(jnp, jax, jnp.asarray(lo_b), jnp.asarray(hi),
                                jnp.asarray(keys), G, jnp.asarray(mask), is_min)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    ext = GG.segment_extreme_int64(_t(v), _t(keys).long(), G, _t(mask), is_min).numpy()
    for g in range(G - 1):
        sel = v[(keys == g) & mask]
        assert ext[g] == (sel.min() if is_min else sel.max())


def test_segment_count_matrix_matches_the_reference():
    rng = np.random.default_rng(6)
    n, G, V = 20000, 12, 40
    keys = rng.integers(0, G, n).astype(np.int32)
    vals = rng.integers(0, V, n).astype(np.int32)
    ok = rng.random(n) < 0.8
    got = GG.segment_count_matrix(_t(keys).long(), _t(vals), G, V, _t(ok))
    assert got.dtype == torch.int64 and tuple(got.shape) == (G, V)
    want = np.zeros((G, V), np.int64)
    np.add.at(want, (keys[ok], vals[ok]), 1)
    np.testing.assert_array_equal(got.numpy(), want)
    jax, jnp, RG = _ref()
    ref = RG.segment_count_matrix(jnp, jax, jnp.asarray(keys), jnp.asarray(vals), G, V,
                                  jnp.asarray(ok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_eligibility_bounds():
    assert GG.eligible(1 << 17, 512)
    assert not GG.eligible(1 << 17, 513)
    assert not GG.eligible((1 << 17) - 1, 8)
