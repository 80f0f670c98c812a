"""The tensor-core layout of K1 and K7a in bf16 and of K8b
(``csrc/mma_tile.cuh``), on the CPU.

A numpy model of ``mma.sync.m16n8k16`` (its A, B and C fragment maps, as the
PTX ISA defines them) and of ``ldmatrix.x4`` (which row address each lane
gives, which bytes each lane receives) runs a layer the way ``dense_mma``
indexes it: the same warp split, lane addresses, tile clamping and epilogue
coordinates, over the blob ``pack_mma_blob`` builds and an A tile laid out as
the loads lay it out. The product must equal ``x @ W.T`` in f64 exactly: the
values are multiples of 1/64 below 4, so every product and sum is exact.
Then the padding, the banks of every ldmatrix row address and the
shared-memory budget. Nothing here needs the card."""

import numpy as np
import pytest
import torch

from infera_tpu_torch.ops import _kernels
from infera_tpu_torch.ops import fused_query as fq
from infera_tpu_torch.testing import profile_query as pq

BENCH = (32, 128, 128, 16)
WIDTHS = [BENCH, (30, 200, 7), (5, 3), (30, 64, 48, 10)]
LANES = np.arange(32)
G, TG = LANES >> 2, LANES & 3


def _dyadic(rng, shape):
    """Values k / 64, |k| < 256: exact in bf16, and their products and sums
    exact in f64."""
    return rng.integers(-255, 256, shape).astype(np.float32) / np.float32(64)


def _weights(dims, seed):
    rng = np.random.default_rng(seed)
    return [(_dyadic(rng, (dims[i], dims[i + 1])), _dyadic(rng, dims[i + 1]))
            for i in range(len(dims) - 1)]


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    bits = a.astype(np.float32).view(np.uint32)
    assert not (bits & 0xFFFF).any(), "values must be exact in bf16"
    return (bits >> 16).astype(np.uint16)


def _unbf16(h: np.ndarray) -> np.ndarray:
    return (h.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


class Smem:
    """Shared memory as bytes, with the ldmatrix bank check on every read."""

    def __init__(self, nbytes):
        self.b = np.zeros(nbytes, np.uint8)

    def put(self, off, arr):
        raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        self.b[off:off + raw.size] = raw

    def ldmatrix_x4(self, addrs):
        """addrs: the 32 lanes' row addresses. Lane l gives row l % 8 of
        matrix l // 8; reg i of lane l is the two b16 at 4 (l % 4) of row
        l // 4 of matrix i."""
        addrs = np.asarray(addrs)
        assert (addrs % 16 == 0).all(), "an ldmatrix row must be 16-byte aligned"
        for m in range(4):
            groups = (addrs[8 * m:8 * m + 8] // 16) % 8
            assert len(set(groups.tolist())) == 8, f"bank conflict: {addrs[8 * m:8 * m + 8]}"
        regs = np.zeros((32, 4), np.uint32)
        for i in range(4):
            at = addrs[8 * i + G] + 4 * TG
            regs[:, i] = np.stack([self.b[at + k] for k in range(4)], 1).copy().view(np.uint32)[:, 0]
        return regs


def _halves(regs):
    return regs & 0xFFFF, regs >> 16


def mma(acc, a_regs, b0, b1):
    """acc [32][4] f64 += A (from the A fragments) x B (from the B
    fragments), by the PTX fragment maps of m16n8k16 with .row A and .col B."""
    A = np.full((16, 16), np.nan)
    B = np.full((16, 8), np.nan)
    for r in range(4):
        for h, vals in enumerate(_halves(a_regs[:, r])):
            A[G + 8 * (r & 1), 2 * TG + h + 8 * (r >> 1)] = _unbf16(vals)
    for r, reg in enumerate((b0, b1)):
        for h, vals in enumerate(_halves(reg)):
            B[2 * TG + h + 8 * r, G] = _unbf16(vals)
    assert not np.isnan(A).any() and not np.isnan(B).any(), "a fragment element is missing"
    D = A @ B
    for e in range(4):
        acc[:, e] += D[G + 8 * (e >> 1), 2 * TG + (e & 1)]


def dense_mma(smem, a_off, din, w_off, dout):
    """``dense_mma``'s products over the tile at a_off and the weights at
    w_off, scattered by the C fragment map and the epilogue's coordinates:
    out [64][pad8(dout)] f64, each element written once."""
    sa = fq.mma_stride(din)
    ksteps = fq.pad16(din) // 16
    nt = fq.pad8(dout) // 8
    out = np.full((64, fq.pad8(dout)), np.nan)
    for warp in range(8):
        wm, wn = warp & 1, warp >> 1
        a_addr = a_off + 2 * ((32 * wm + (LANES & 15)) * sa + ((LANES >> 4) << 3))
        a_next = 16 * sa * 2
        for t0 in range(wn, nt, 16):
            b_addr = []
            for q in range(2):
                tile = np.minimum(t0 + 4 * (2 * q + (LANES >> 4)), nt - 1)
                b_addr.append(w_off + 2 * ((8 * tile + (LANES & 7)) * sa
                                           + (((LANES >> 3) & 1) << 3)))
            live = [t0 + 4 * j < nt for j in range(4)]
            acc = np.zeros((2, 4, 32, 4))
            for ks in range(ksteps):
                a = [smem.ldmatrix_x4(a_addr + 32 * ks), smem.ldmatrix_x4(a_addr + a_next + 32 * ks)]
                b = [smem.ldmatrix_x4(b_addr[0] + 32 * ks), smem.ldmatrix_x4(b_addr[1] + 32 * ks)]
                for j in range(4):
                    if live[j]:
                        for i in range(2):
                            q, jj = j >> 1, j & 1
                            mma(acc[i, j], a[i], b[q][:, 2 * jj], b[q][:, 2 * jj + 1])
            for j in range(4):
                if not live[j]:
                    continue
                col = 8 * (t0 + 4 * j) + 2 * TG
                for i in range(2):
                    row = 32 * wm + 16 * i + G
                    for e, (dr, dc) in enumerate(((0, 0), (0, 1), (8, 0), (8, 1))):
                        assert np.isnan(out[row + dr, col + dc]).all(), "written twice"
                        out[row + dr, col + dc] = acc[i, j, :, e]
    assert not np.isnan(out).any(), "an output was not written"
    return out


def _blob_layers(dims, blob_bytes):
    """(weights [pad8(dout)][mma_stride(din)] u16, biases [pad8(dout)] f32)
    of every layer, read back from the blob's bytes."""
    ws, off = [], 0
    for i in range(len(dims) - 1):
        n = fq.pad8(dims[i + 1]) * fq.mma_stride(dims[i])
        ws.append(blob_bytes[off:off + 2 * n].view(np.uint16).reshape(fq.pad8(dims[i + 1]), -1))
        off += 2 * n
    bs = []
    for d in dims[1:]:
        bs.append(blob_bytes[off:off + 4 * fq.pad8(d)].view(np.float32))
        off += 4 * fq.pad8(d)
    assert off == blob_bytes.size == fq.mma_blob_bytes(dims)
    return ws, bs


def _blob(dims, seed=0):
    params = _weights(dims, seed)
    w = fq.params_from_numpy(params, "cpu", torch.bfloat16)
    return params, w.mma_blob.numpy().view(np.uint8)


@pytest.mark.parametrize("dims", WIDTHS)
def test_blob_holds_wt_in_bf16_with_zero_padding(dims):
    params, raw = _blob(dims)
    ws, bs = _blob_layers(dims, raw)
    for (w, b), wt, bias in zip(params, ws, bs):
        din, dout = w.shape
        assert np.array_equal(wt[:dout, :din], _bf16_bits(w.T))
        assert not wt[dout:].any() and not wt[:, din:].any()
        assert np.array_equal(bias[:dout], b) and not bias[dout:].any()
    assert raw.size % 16 == 0


def _a_tile_cols(x: np.ndarray) -> np.ndarray:
    """``load_cols_tile_bf16``: thread item i takes row i % 64 and features
    8 (i // 64) .. + 7 of the feature-major table, one 16-byte word."""
    rows, d0 = x.shape
    sa = fq.mma_stride(d0)
    a = np.full((64, sa), 0xFFFF, np.uint16)    # garbage where nothing writes
    for i in range(64 * fq.pad16(d0) // 8):
        r, k0 = i & 63, 8 * (i // 64)
        for u in range(8):
            k = k0 + u
            a[r, k] = _bf16_bits(np.float32(x[r, k] if r < rows and k < d0 else 0.0))
    return a


def _a_tile_ring(x: np.ndarray, itemsize: int) -> np.ndarray:
    """``load_rows_tile_bf16``'s ring path: word w of row r (8 bf16 or 4
    f32 values) to a[r][per * w], then zero pairs from d0 to pad16(d0)."""
    rows, d0 = x.shape
    per = 16 // itemsize
    sa = fq.mma_stride(d0)
    a = np.full((64, sa), 0xFFFF, np.uint16)
    for i in range(64 * d0 // per):
        r, w = i & 63, i // 64
        a[r, per * w:per * w + per] = _bf16_bits(x[r, per * w:per * w + per])
    pairs = (fq.pad16(d0) - d0) // 2
    for i in range(64 * pairs):
        r = i // pairs
        a[r, d0 + 2 * (i - r * pairs):d0 + 2 * (i - r * pairs) + 2] = 0
    return a


@pytest.mark.parametrize("d0", [5, 30, 32, 40, 128])
def test_loads_write_the_a_tile_with_zero_padding(d0):
    """K1's load and K7a's ring copy give the same A tile: the values in
    [0, d0), zeros in [d0, pad16(d0)) and in rows past n."""
    x = _dyadic(np.random.default_rng(d0), (50, d0))
    a = _a_tile_cols(x)
    k = fq.pad16(d0)
    assert np.array_equal(a[:50, :d0], _bf16_bits(x))
    assert not a[:, d0:k].any() and not a[50:, :k].any()
    if d0 % 8 == 0:
        full = _dyadic(np.random.default_rng(d0 + 1), (64, d0))
        for item in (2, 4):
            assert np.array_equal(_a_tile_ring(full, item)[:, :k], _a_tile_cols(full)[:, :k])


@pytest.mark.parametrize("dims", WIDTHS)
def test_fragments_rebuild_every_layer_exactly(dims):
    """Each layer's product, read through the modelled ldmatrix and mma
    fragments from the packed blob and an A tile, equals x @ W.T in f64
    exactly, zero in the padded columns; every ldmatrix is conflict-free."""
    params, raw = _blob(dims, seed=len(dims))
    rng = np.random.default_rng(7)
    off = 0
    for i, (w, _b) in enumerate(params):
        din, dout = w.shape
        wbytes = 2 * fq.pad8(dout) * fq.mma_stride(din)
        x = _dyadic(rng, (64, din))
        a = _a_tile_cols(x)
        smem = Smem(raw.size + a.nbytes)
        smem.put(0, raw)
        smem.put(raw.size, a)
        got = dense_mma(smem, raw.size, din, off, dout)
        want = x.astype(np.float64) @ w.astype(np.float64)
        assert np.array_equal(got[:, :dout], want), f"layer {i}"
        assert not got[:, dout:].any()
        off += wbytes


def test_bank_check_catches_an_even_stride():
    """The model's bank check is live: rows 16 words apart (a stride of
    pad16(k) with no +8) share one bank group."""
    smem = Smem(64 * 64 * 2)
    with pytest.raises(AssertionError, match="bank conflict"):
        smem.ldmatrix_x4(2 * (LANES & 15) * 32 + 2 * ((LANES >> 4) << 3))


# MLP widths whose f32 shared memory fits: the tests', the main path's and
# some near the 227 KB limit
SIZES = [(32, 64, 64, 16), BENCH, (30, 200, 7), (32, 16), (5, 3), (4, 32, 1), (8, 4),
         (30, 64, 48, 10), (1, 64, 10), (33, 64, 10), (128, 64, 10), (5, 130, 3), (1, 400),
         (1, 300, 8), (8, 256, 256, 8), (64, 320, 10), (128, 128, 128, 128), (3, 16, 200, 3)]


@pytest.mark.parametrize("dims", SIZES)
def test_every_mlp_that_fit_still_fits_in_bf16(dims):
    """K1, K7a (bf16 and f32 tables) and K8b's stages: an MLP whose f32
    layout fit one block still fits in bf16."""
    limit = fq.SMEM_LIMIT
    if fq.query_smem_bytes(dims) <= limit:
        assert fq.query_smem_bytes_bf16(dims) <= limit
    for item in (2, 4):
        if fq.rows_query_smem_bytes(dims, item) <= limit:
            assert fq.rows_query_smem_bytes_bf16(dims, item) <= limit
        stages = fq.ring_stages_bf16(dims, item)
        assert 0 <= stages <= fq.BF16_RING_STAGES
        assert fq.rows_query_smem_bytes_bf16(dims, item) == (
            fq.query_smem_bytes_bf16(dims) + stages * 64 * fq.ring_stride(dims[0], item))
    if dims[0] <= pq.OUT_WIDTH:
        old = fq.rows_query_smem_bytes(dims, 2, pq._SCRATCH) + pq._SCRATCH
        for stage_dims in (dims, dims[:2], dims[:1]):
            if old <= limit:
                assert pq._stage_smem_bytes(stage_dims) <= limit


def test_bench_mlp_fits_two_blocks_an_sm():
    """At the bench MLP K1, K7a and the stage kernel each take at most half
    an SM's shared memory (less the 1 KB reserved a block), with two ring
    buffers; the parts are the design's."""
    half = 233472 // 2 - 1024
    assert fq.TWO_BLOCK_SMEM == half
    assert fq.mma_blob_bytes(BENCH) == 49_408 + 1_088
    assert fq.mma_tile_bytes(BENCH) == (17_408, 17_408)
    assert fq.query_smem_bytes_bf16(BENCH) == 49_408 + 1_088 + 768 + 2 * 17_408
    for item in (2, 4):
        assert fq.ring_stages_bf16(BENCH, item) == 2
        assert fq.rows_query_smem_bytes_bf16(BENCH, item) <= half
    assert fq.rows_query_smem_bytes_bf16(BENCH, 2) == 86_080 + 2 * 64 * 80
    for stage_dims in (BENCH, BENCH[:2], BENCH[:1]):
        assert pq._stage_smem_bytes(stage_dims) <= half
    assert _kernels.smem_blocks_per_sm(fq.rows_query_smem_bytes_bf16(BENCH, 4)) == 2


def test_wide_ring_rows_shrink_to_fit_two_blocks():
    """A row of 128 bf16 values (16 KB a tile): one buffer where two would
    push the block past half an SM; where not even one fits there, the one
    block's budget decides."""
    assert fq.ring_stages_bf16((128, 128, 64, 16), 2) == 1
    assert fq.rows_query_smem_bytes_bf16((128, 128, 64, 16), 2) <= fq.TWO_BLOCK_SMEM
    wide = (128, 256, 16)
    assert fq.query_smem_bytes_bf16(wide) + 64 * fq.ring_stride(128, 4) > fq.TWO_BLOCK_SMEM
    assert fq.ring_stages_bf16(wide, 4) == 2
    assert fq.ring_stages_bf16((33, 64, 10), 2) == 0


SASS = """
        code for sm_90a
                Function : _Z17query_bf16_kernelI13__nv_bfloat16Lb1EEvPKT_xPKhi7MlpDimsiPxPd
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;       /* 0x00000a00ff017b82 */
        /*0c40*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;   /* 0x000000000c04723c */
        /*0c50*/              @!P0 HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
        /*0c60*/                   LDSM.16.M88.4 R8, [R2] ;
                Function : _Z16query_f32_kernelIfLb1EEvPKT_xPKfi7MlpDimsiiPxPd
        /*0000*/                   FFMA R4, R5, R6, R4 ;
        /*0010*/                   EXIT ;
"""


def test_sass_counts_hmma_by_kernel():
    counts = _kernels.count_sass(SASS, "HMMA")
    assert counts == {"_Z17query_bf16_kernelI13__nv_bfloat16Lb1EEvPKT_xPKhi7MlpDimsiPxPd": 2,
                      "_Z16query_f32_kernelIfLb1EEvPKT_xPKfi7MlpDimsiiPxPd": 0}
    assert sum(_kernels.count_sass(SASS, "LDSM").values()) == 1


def _ab_run(out_dir, tag, k7a_bf16, k7a_f32, k3_sums=(5.0, 6.0), k7a_f32_counts=(7, 8)):
    np.savez(out_dir / f"ab_{tag}.npz", **{"K7a bf16:sums": np.float32(k7a_bf16),
                                          "K7a f32:sums": np.float32(k7a_f32),
                                          "K7a f32:counts": np.int64(k7a_f32_counts),
                                          "K3:counts": np.arange(3),
                                          "K3:sums": np.float32(k3_sums),
                                          "A:count": np.arange(4)})


def test_ab_compare_holds_each_side_bit_equal_and_the_redesign_within_tolerance(tmp_path):
    """``ab_kernels.compare``: parent against parent2 and change against
    change2 bit for bit; across the sides K7a bf16 (redesigned) within
    rtol 2e-2, K7a f32's sums within rtol 1e-6 (a launch shape may group
    their f64 partials otherwise) but its counts bit for bit, and K3
    (redesigned, exact integer layers) bit for bit too."""
    from infera_tpu_torch.testing import ab_kernels as ab

    tags = ["parent", "change", "change2", "parent2"]
    for tag in tags:
        _ab_run(tmp_path, tag, [1.0, 2.0] if tag.startswith("parent") else [1.001, 2.0], [3.0])
    assert ab.compare(str(tmp_path), tags)
    _ab_run(tmp_path, "change2", [1.0, 2.0], [3.0])        # a side that does not repeat
    assert not ab.compare(str(tmp_path), tags)
    _ab_run(tmp_path, "change2", [1.001, 2.0], [3.0])
    _ab_run(tmp_path, "change", [1.001, 2.0], [3.0000002])  # f32 sums moved by 2 ulp
    _ab_run(tmp_path, "change2", [1.001, 2.0], [3.0000002])
    assert ab.compare(str(tmp_path), tags)
    _ab_run(tmp_path, "change", [1.001, 2.0], [3.00003])    # by 1e-5
    _ab_run(tmp_path, "change2", [1.001, 2.0], [3.00003])
    assert not ab.compare(str(tmp_path), tags)
    for tag in ("change", "change2"):                       # f32 counts moved
        _ab_run(tmp_path, tag, [1.001, 2.0], [3.0], k7a_f32_counts=(8, 7))
    assert not ab.compare(str(tmp_path), tags)
    ulp = np.nextafter(np.float32(5.0), np.float32(6.0))
    for tag in ("change", "change2"):                       # K3's sums moved by an ulp
        _ab_run(tmp_path, tag, [1.001, 2.0], [3.0], k3_sums=(ulp, 6.0))
    assert not ab.compare(str(tmp_path), tags)
    for tag in ("change", "change2"):
        _ab_run(tmp_path, tag, [1.001, 2.0], [3.0])
    assert ab.compare(str(tmp_path), tags)
