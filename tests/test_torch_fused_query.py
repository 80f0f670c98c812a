"""K1, K7a, K3 and K7b (``infera_tpu_torch/ops/fused_query.py``) against
``infera_tpu``'s Pallas kernels in interpret mode, on the CPU.

On the CPU each wrapper runs its kernel's plain version; the CUDA kernels are
held against those plain versions on the card (tests/test_torch_cuda_kernels.py
and chip_smoke.py). The blob tests read the weight blobs the way
csrc/fused_query.cu does, in numpy, so the layouts are checked here too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import emulate_int8_static
from infera_tpu.ops import pallas_query as pq
from infera_tpu_torch.ops import fused_query as fq
from infera_tpu_torch.ops.fused_mlp import pad8
from test_torch_cuda_kernels import synthetic_shift_qparams

N_ROWS = 2048


def _params(dims, seed):
    rng = np.random.default_rng(seed)
    params = []
    for i in range(len(dims) - 1):
        w = rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) \
            / np.float32(np.sqrt(dims[i]))
        b = rng.standard_normal(dims[i + 1]).astype(np.float32) * np.float32(0.1)
        params.append((w, b))
    return params


def _table(seed, d0=32, n=N_ROWS):
    return np.random.default_rng(seed).standard_normal((n, d0)).astype(np.float32)


def _jax_query(params, xc, dtype):
    jp = [(jnp.asarray(w), jnp.asarray(b)) for w, b in params]
    c, s = pq.fused_mlp_query_columnar(jp, jnp.asarray(xc), tile_n=256, interpret=True,
                                       compute_dtype=dtype)
    return np.asarray(c), np.asarray(s)


@pytest.mark.parametrize("dims", [(32, 64, 64, 16), (32, 64, 16)])
def test_k1_f32_matches_pallas_interpret(dims):
    params = _params(dims, seed=2)
    xc = np.ascontiguousarray(_table(3).T)
    want_c, want_s = _jax_query(params, xc, jnp.float32)
    before = dict(fq.fused_mlp_query_columnar.launches)
    got_c, got_s = fq.fused_mlp_query_columnar(fq.params_from_numpy(params, "cpu"),
                                               torch.from_numpy(xc))
    assert fq.fused_mlp_query_columnar.launches == before
    assert got_c.dtype == torch.int64
    # counts exact; sums are f32 adds in another order
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [2, 4])
def test_k1_bf16_matches_pallas_interpret(seed):
    params = _params((32, 64, 64, 16), seed=seed)
    xc = np.ascontiguousarray(_table(seed + 1).T)
    want_c, want_s = _jax_query(params, xc, jnp.bfloat16)
    weights = fq.params_from_numpy(params, "cpu", torch.bfloat16)
    got_c, got_s = fq.fused_mlp_query_columnar(weights, torch.from_numpy(xc).to(torch.bfloat16))
    # a ReLU output whose f32 sum differs in its last bit can round to the
    # other bf16 neighbour: at most one row of 2,048 moves
    assert np.abs(got_c.numpy() - want_c).sum() <= 1
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=2e-2, atol=1e-2)


def _shift_setup(seed):
    params = _params((32, 64, 16), seed=seed)
    x = _table(seed + 1)
    return params, x


@pytest.mark.parametrize("seed", [5, 6])
def test_quantize_mlp_shift_is_the_reference_copy(seed):
    params, x = _shift_setup(seed)
    want = pq.quantize_mlp_shift(params, x[:512], max_flip_rate=0.05)
    got = fq.quantize_mlp_shift(params, x[:512], max_flip_rate=0.05)
    assert (want is None) == (got is None)
    qp_w, s0_w, flip_w = want
    qp_g, s0_g, flip_g = got
    assert s0_g == s0_w and flip_g == flip_w
    for layer_w, layer_g in zip(qp_w, qp_g):
        for a_w, a_g in zip(layer_w, layer_g):
            assert a_g.dtype == a_w.dtype
            np.testing.assert_array_equal(a_g, a_w)
    assert fq.quantize_mlp_shift(params, x[:512], max_flip_rate=0.0) is None or flip_g == 0.0


@pytest.mark.parametrize("seed", [5, 6])
def test_k3_matches_pallas_interpret(seed):
    params, x = _shift_setup(seed)
    qparams, s0, _ = fq.quantize_mlp_shift(params, x[:512], max_flip_rate=0.05)
    xq = np.clip(np.rint(x / s0), -127, 127).astype(np.int8).T.copy()
    want_c, want_s = pq.fused_mlp_query_columnar_int8_shift(
        qparams, jnp.asarray(xq), tile_n=256, interpret=True)
    got_c, got_s = fq.fused_mlp_query_columnar_int8_shift(
        fq.qparams_from_numpy(qparams, "cpu"), torch.from_numpy(xq))
    # integer layers are exact and the last layer is the same f32 multiply
    # and add: the counts are bit-exact
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)


def test_carriers_hold_the_tpu_kernels_shapes():
    params = _params((32, 64, 16), seed=1)
    w = fq.params_from_numpy(params, "cpu", torch.bfloat16)
    assert w.dims == (32, 64, 16)
    for (wt, b), (w_np, b_np) in zip(w.layers, params):
        assert wt.dtype == torch.bfloat16 and tuple(wt.shape) == w_np.T.shape
        assert b.dtype == torch.float32 and tuple(b.shape) == (b_np.size, 1)
    with pytest.raises(ValueError, match="compute_dtype"):
        fq.params_from_numpy(params, "cpu", torch.float16)


def _simulate_f32_blob(weights, xc):
    """The layer stack as the kernel reads the f32 blob (numpy, f64)."""
    dims, blob = weights.dims, weights.blob.numpy().astype(np.float64)
    n_layers = len(dims) - 1
    off, ws = 0, []
    for i in range(n_layers):
        ws.append(blob[off:off + dims[i] * pad8(dims[i + 1])].reshape(dims[i], -1))
        off += ws[-1].size
    h = xc.T.astype(np.float64)
    for i in range(n_layers):
        b = blob[off:off + pad8(dims[i + 1])]
        off += b.size
        h = (h @ ws[i] + b)[:, :dims[i + 1]]
        if i < n_layers - 1:
            h = np.maximum(h, 0)
    assert off == blob.size
    return h


def test_f32_blob_layout_is_what_the_kernel_reads():
    params = _params((32, 20, 12), seed=7)
    xc = np.ascontiguousarray(_table(8, n=300).T)
    h = _simulate_f32_blob(fq.params_from_numpy(params, "cpu"), xc)
    ref = xc.T.astype(np.float64)
    for i, (w, b) in enumerate(params):
        ref = ref @ w + b
        if i < len(params) - 1:
            ref = np.maximum(ref, 0)
    np.testing.assert_allclose(h, ref, rtol=1e-12, atol=1e-12)


def _simulate_int8_blob(weights, xq):
    """Per-class counts as K3 or K7b computes them from the int32 blob:
    W^T int8 [pad8(dout)][imma_wstride(din)] per layer, then (sl, sr,
    bias_pre) or (comb, 0, bias) per layer; K7b's hidden layers read (comb,
    0, bq) and requantize with rint."""
    dims, raw = weights.dims, weights.blob.numpy()
    blob, n_layers = raw.view(np.int8), len(dims) - 1
    off, ws = 0, []
    for i in range(n_layers):
        dp, sw = pad8(dims[i + 1]), fq.imma_wstride(dims[i])
        ws.append(blob[off:off + dp * sw].reshape(dp, sw)[:, :dims[i]].T.astype(np.int64))
        off += dp * sw
    assert off % 4 == 0
    off //= 4
    q = xq.T.astype(np.int64)
    for i in range(n_layers):
        dp = pad8(dims[i + 1])
        e = raw[off:off + 3 * dp].reshape(3, dp)
        off += 3 * dp
        y = q @ ws[i]
        if i < n_layers - 1 and isinstance(weights, fq.StaticInt8Weights):
            t = y.astype(np.float32) * e[0].view(np.float32) + e[2].view(np.float32)
            q = np.clip(np.rint(t), 0, 127).astype(np.int64)[:, :dims[i + 1]]
        elif i < n_layers - 1:
            if weights.need_sl[i]:
                y = y << e[0]
            q = np.clip((y + e[2]) >> np.minimum(e[1], 31), 0, 127)[:, :dims[i + 1]]
        else:
            comb, bias = e[0].view(np.float32), e[2].view(np.float32)
            h = (y.astype(np.float32) * comb + bias)[:, :dims[-1]]
    assert off == raw.size
    pred, sel = h.argmax(1), h[:, 0] > 0
    return np.bincount(pred[sel], minlength=dims[-1])


@pytest.mark.parametrize("dims", [(32, 64, 16), (30, 20, 6)])
def test_int8_blob_layout_is_what_the_kernel_reads(dims):
    params = _params(dims, seed=9)
    x = _table(10, d0=dims[0], n=1000)
    qparams, s0, _ = fq.quantize_mlp_shift(params, x, max_flip_rate=1.0)
    xq = np.clip(np.rint(x / s0), -127, 127).astype(np.int8).T.copy()
    weights = fq.qparams_from_numpy(qparams, "cpu")
    counts, _ = fq.fused_mlp_query_columnar_int8_shift(weights, torch.from_numpy(xq))
    np.testing.assert_array_equal(_simulate_int8_blob(weights, xq), counts.numpy())


def test_shared_memory_of_the_main_path():
    dims = (32, 128, 128, 16)
    # K1: 22,800 f32 words of weights and biases, the tail's scratch and two
    # 64-row tiles of 128 activations
    assert fq.query_smem_bytes(dims) == 4 * 22_800 + (16 * 16 + 512) + 8 * 128 * 68
    assert fq.query_smem_bytes(dims) <= fq.SMEM_LIMIT
    assert fq.int8_smem_bytes(dims) <= fq.SMEM_LIMIT


def test_wrappers_refuse_a_tensor_that_is_neither_cpu_nor_cuda():
    params = _params((32, 16), seed=1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fq.fused_mlp_query_columnar(fq.params_from_numpy(params, "cpu"),
                                    torch.empty((32, 8), device="meta"))
    qparams, _, _ = fq.quantize_mlp_shift(params, _table(1, n=64), max_flip_rate=1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fq.fused_mlp_query_columnar_int8_shift(fq.qparams_from_numpy(qparams, "cpu"),
                                               torch.empty((32, 8), dtype=torch.int8,
                                                           device="meta"))


def test_k3_with_left_shifts_matches_pallas_interpret():
    qparams = synthetic_shift_qparams((32, 64, 48, 16), seed=11)
    xq = np.random.default_rng(12).integers(-127, 128, (32, N_ROWS)).astype(np.int8)
    weights = fq.qparams_from_numpy(qparams, "cpu")
    assert weights.need_sl == (True, True, False)
    want_c, want_s = pq.fused_mlp_query_columnar_int8_shift(
        qparams, jnp.asarray(xq), tile_n=256, interpret=True)
    got_c, got_s = fq.fused_mlp_query_columnar_int8_shift(weights, torch.from_numpy(xq))
    assert got_c.sum() > N_ROWS // 8  # the filter keeps a real share of the rows
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_simulate_int8_blob(weights, xq), got_c.numpy())


# --------------------------------------------------------------------------- K7a


def _jax_rows_query(params, x, dtype):
    jp = [(jnp.asarray(w), jnp.asarray(b)) for w, b in params]
    xin = jnp.asarray(x).astype(dtype) if dtype == jnp.bfloat16 else jnp.asarray(x)
    c, s = pq.fused_mlp_query(jp, xin, tile_n=256, interpret=True, compute_dtype=dtype)
    return np.asarray(c), np.asarray(s)


@pytest.mark.parametrize("dims", [(32, 64, 64, 16), (32, 64, 16)])
def test_k7a_f32_matches_pallas_interpret(dims):
    params = _params(dims, seed=12)
    x = _table(13)
    want_c, want_s = _jax_rows_query(params, x, jnp.float32)
    before = dict(fq.fused_mlp_query.launches)
    got_c, got_s = fq.fused_mlp_query(fq.params_from_numpy(params, "cpu"), torch.from_numpy(x))
    assert fq.fused_mlp_query.launches == before
    assert got_c.dtype == torch.int64
    # counts exact; sums are f32 adds in another order
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [14, 16])
@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32])
def test_k7a_bf16_matches_pallas_interpret(seed, table_dtype):
    """bf16 mode over a bf16 table (the bench's ``cuda_bf16_io``) and over
    an f32 table rounded at load (``cuda_bf16``)."""
    params = _params((32, 64, 64, 16), seed=seed)
    x = _table(seed + 1)
    want_c, want_s = _jax_rows_query(params, x, jnp.bfloat16)
    weights = fq.params_from_numpy(params, "cpu", torch.bfloat16)
    got_c, got_s = fq.fused_mlp_query(weights, torch.from_numpy(x).to(table_dtype))
    # a ReLU output whose f32 sum differs in its last bit can round to the
    # other bf16 neighbour: at most 0.1 % of the kept rows move
    assert np.abs(got_c.numpy() - want_c).sum() <= max(1, 1e-3 * want_c.sum())
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_major_and_columnar_ports_agree(dtype):
    params = _params((32, 64, 16), seed=17)
    x = torch.from_numpy(_table(18))
    weights = fq.params_from_numpy(params, "cpu", dtype)
    rows = fq.fused_mlp_query(weights, x.to(dtype))
    cols = fq.fused_mlp_query_columnar(weights, x.T.contiguous().to(dtype))
    for a, b in zip(rows, cols):
        assert torch.equal(a, b)


def test_rows_shared_memory_adds_the_staging_tile():
    dims = (32, 128, 128, 16)
    # K1's budget and the ring's buffers: a bf16 row of 32 values is 4
    # 16-byte words, padded to 5; 1 + 20 KB / 4 KB tiles = 6 buffers
    assert fq.ring_stride(32, 2) == 80 and fq.ring_stages(dims, 2) == 6
    assert fq.rows_query_smem_bytes(dims, 2) == fq.query_smem_bytes(dims) + 6 * 64 * 80
    # f32: 8 words padded to 9, 1 + 20 KB / 8 KB tiles = 4 buffers
    assert fq.ring_stride(32, 4) == 144 and fq.ring_stages(dims, 4) == 4
    assert fq.rows_query_smem_bytes(dims) == fq.query_smem_bytes(dims) + 4 * 64 * 144
    # a row that is no whole number of 16-byte words takes the scalar load
    assert fq.ring_stages((7, 9, 3), 4) == 0
    assert fq.rows_query_smem_bytes((7, 9, 3)) == fq.query_smem_bytes((7, 9, 3))
    assert fq.rows_query_smem_bytes(dims) <= fq.SMEM_LIMIT


# --------------------------------------------------------------------------- K7b


def _static_setup(seed, dims=(32, 64, 64, 16)):
    params = _params(dims, seed=seed)
    x = _table(seed + 1, d0=dims[0])
    qparams, s0 = fq.quantize_mlp_static(params, x[:512])
    xq = np.clip(np.rint(x / s0), -127, 127).astype(np.int8).T.copy()
    return params, x, qparams, s0, xq


@pytest.mark.parametrize("seed", [20, 21])
def test_quantize_mlp_static_is_the_reference_copy(seed):
    params, x = _params((32, 64, 64, 16), seed=seed), _table(seed + 1)
    want_qp, want_s0 = pq.quantize_mlp_static(params, x[:512])
    got_qp, got_s0 = fq.quantize_mlp_static(params, x[:512])
    assert got_s0.dtype == want_s0.dtype == np.float32 and got_s0 == want_s0
    for layer_w, layer_g in zip(want_qp, got_qp, strict=True):
        for a_w, a_g in zip(layer_w, layer_g, strict=True):
            assert a_g.dtype == a_w.dtype
            np.testing.assert_array_equal(a_g.view(np.uint8), a_w.view(np.uint8))


def _rows_moved_by_one_rounding(qparams, xq) -> int:
    """Rows whose requantized hidden values differ between the epilogue
    f32(y) * comb + bq rounded twice (a multiply, then an add: the port) and
    rounded once (an FMA: XLA on the CPU contracts it so). The two differ by
    at most an ulp of t, so a value moves only where t lies within an ulp of
    a half-integer, and only such a row can change its class or filter."""
    q1 = q2 = xq.astype(np.float64)
    moved = np.zeros(xq.shape[1], bool)
    for wq, comb, bq in qparams[:-1]:
        y1, y2 = wq.astype(np.float64) @ q1, wq.astype(np.float64) @ q2
        t1 = y1.astype(np.float32) * comb + bq
        t2 = (y2 * comb.astype(np.float64) + bq.astype(np.float64)).astype(np.float32)
        q1 = np.clip(np.rint(t1), 0, 127).astype(np.float64)
        q2 = np.clip(np.rint(t2), 0, 127).astype(np.float64)
        moved |= (q1 != q2).any(axis=0)
    return int(moved.sum())


@pytest.mark.parametrize("seed", [22, 24, 28])
def test_k7b_matches_pallas_interpret(seed):
    """XLA on the CPU contracts the epilogue into an FMA, where the port and
    its CUDA kernel round twice, as the TPU kernel writes the multiply and
    the add: the counts may differ by the rows that one rounding moves
    (none, for these seeds); the sums see the last layer's ulp only."""
    _, _, qparams, _, xq = _static_setup(seed)
    want_c, want_s = pq.fused_mlp_query_columnar_int8(
        qparams, jnp.asarray(xq), tile_n=256, interpret=True)
    weights = fq.qparams_static_from_numpy(qparams, "cpu")
    before = fq.fused_mlp_query_columnar_int8.launches
    got_c, got_s = fq.fused_mlp_query_columnar_int8(weights, torch.from_numpy(xq))
    assert fq.fused_mlp_query_columnar_int8.launches == before
    assert got_c.dtype == torch.int64 and got_c.sum() > N_ROWS // 8
    moved = _rows_moved_by_one_rounding(qparams, xq)
    assert np.abs(got_c.numpy() - np.asarray(want_c)).sum() <= moved
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)


def test_xla_contracts_the_epilogue_and_the_port_does_not():
    """What the bound above rests on: XLA's f32(y) * comb + bq equals the
    product and sum rounded once; the port's plain epilogue rounds twice."""
    rng = np.random.default_rng(27)
    y = rng.integers(-3_000_000, 3_000_000, (64, 4096)).astype(np.int32)
    comb = (rng.standard_normal((64, 1)) * 1e-4).astype(np.float32)
    bq = (rng.standard_normal((64, 1)) * 10).astype(np.float32)
    xla = np.asarray(jax.jit(lambda a, c, b: a.astype(jnp.float32) * c + b)(y, comb, bq))
    once = (y.astype(np.float64) * comb.astype(np.float64) + bq.astype(np.float64))
    twice = y.astype(np.float32) * comb + bq
    port = (torch.from_numpy(y).float() * torch.from_numpy(comb) + torch.from_numpy(bq)).numpy()
    np.testing.assert_array_equal(xla, once.astype(np.float32))
    np.testing.assert_array_equal(port, twice)
    assert not np.array_equal(once.astype(np.float32), twice)


@pytest.mark.parametrize("dims", [(32, 64, 64, 16), (30, 20, 6)])
def test_k7b_counts_equal_the_numpy_emulation(dims):
    _, _, qparams, _, xq = _static_setup(25, dims)
    weights = fq.qparams_static_from_numpy(qparams, "cpu")
    counts, _ = fq.fused_mlp_query_columnar_int8(weights, torch.from_numpy(xq))
    np.testing.assert_array_equal(emulate_int8_static(qparams, xq), counts.numpy())
    # and the blob holds what the kernel reads
    np.testing.assert_array_equal(_simulate_int8_blob(weights, xq), counts.numpy())


def test_static_carrier_holds_the_tpu_kernels_shapes():
    _, _, qparams, _, _ = _static_setup(26, (32, 64, 16))
    w = fq.qparams_static_from_numpy(qparams, "cpu")
    assert w.dims == (32, 64, 16)
    for (wq, comb, bq), (wq_np, comb_np, bq_np) in zip(w.layers, qparams, strict=True):
        assert wq.dtype == torch.int8 and tuple(wq.shape) == wq_np.shape
        assert comb.dtype == bq.dtype == torch.float32
        assert tuple(comb.shape) == tuple(bq.shape) == (wq_np.shape[0], 1)
        np.testing.assert_array_equal(comb.numpy(), comb_np)


def test_new_wrappers_refuse_a_tensor_that_is_neither_cpu_nor_cuda():
    params = _params((32, 16), seed=1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fq.fused_mlp_query(fq.params_from_numpy(params, "cpu"), torch.empty((8, 32), device="meta"))
    qparams, _ = fq.quantize_mlp_static(params, _table(1, n=64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fq.fused_mlp_query_columnar_int8(fq.qparams_static_from_numpy(qparams, "cpu"),
                                         torch.empty((32, 8), dtype=torch.int8, device="meta"))
