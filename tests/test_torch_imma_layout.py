"""The int8 tensor-core layout of K3 and K7b (``csrc/imma_tile.cuh``), on the
CPU.

A numpy model of ``mma.sync.m16n8k32`` with s8 operands (its A, B and C
fragment maps, as the PTX ISA defines them) and of ``ldmatrix.x4`` over
byte tiles (``test_torch_mma_layout.Smem``: alignment and bank groups
checked on every read) runs the kernel's layer stack the way ``dense_imma``
indexes it: the same warp split, lane addresses, tile clamping, buffer
parity and epilogue coordinates, over the blob ``_int8_blob`` builds and A
tiles written by a model of ``load_cols_tile_int8`` (its funnel shifts and
``__byte_perm`` transpositions, and its byte path). Every layer's s32
products must equal ``x @ W.T`` exactly, every requantized byte the numpy
requantization of K3 and K7b, and the last layer's f32 scores the plain
version's bit for bit. Then the padding and the shared-memory budget.
Nothing here needs the card."""

import itertools
import re

import numpy as np
import pytest
import torch

from infera_tpu_torch.ops import _kernels
from infera_tpu_torch.ops import fused_query as fq
from infera_tpu_torch.ops.fused_mlp import ACT_STRIDE, SMEM_LIMIT, pad8
from test_torch_cuda_kernels import synthetic_shift_qparams
from test_torch_mma_layout import BENCH, G, LANES, SIZES, TG, WIDTHS, Smem

GARBAGE = 0xA5   # bytes the kernel never writes; a read of one shows in a product


def _constant(name: str) -> int:
    """A constexpr int of csrc/imma_tile.cuh, so the model follows the kernel."""
    src = (_kernels.CSRC / "imma_tile.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


TILES = _constant("kImmaTiles")    # n8 tiles a warp multiplies at once


def _s8(reg: np.ndarray) -> np.ndarray:
    """[32] u32 registers -> [32, 4] their bytes as signed ints, byte 0 first."""
    return np.ascontiguousarray(reg, np.uint32).view(np.int8).reshape(32, 4).astype(np.int64)


def mma_s8(acc, a_regs, b0, b1):
    """acc [32][4] int64 += A (16 x 32, from the A fragments) x B (32 x 8,
    from the B fragments), by the PTX fragment maps of m16n8k32 with .row A,
    .col B and s8 operands."""
    A = np.full((16, 32), np.iinfo(np.int64).min)
    B = np.full((32, 8), np.iinfo(np.int64).min)
    for r in range(4):
        by = _s8(a_regs[:, r])
        for b in range(4):
            A[G + 8 * (r & 1), 4 * TG + b + 16 * (r >> 1)] = by[:, b]
    for r, reg in enumerate((b0, b1)):
        by = _s8(reg)
        for b in range(4):
            B[4 * TG + b + 16 * r, G] = by[:, b]
    assert (A > -999).all() and (B > -999).all(), "a fragment element is missing"
    D = A @ B
    for e in range(4):
        acc[:, e] += D[G + 8 * (e >> 1), 2 * TG + (e & 1)]


def dense_imma(smem, a_off, din, w_off, dout, epilogue):
    """``dense_imma``'s products over the A tile at a_off and W^T at w_off;
    each lane's four C values go to ``epilogue(rows, cols, y)`` at the
    kernel's coordinates. Returns the products [64][pad8(dout)], each
    element written once."""
    sa, sw = fq.imma_astride(din), fq.imma_wstride(din)
    ksteps = fq.pad32(din) // 32
    nt = pad8(dout) // 8
    out = np.full((64, pad8(dout)), np.iinfo(np.int64).min)
    for warp in range(8):
        wm, wn = warp & 1, warp >> 1
        a_addr = a_off + (32 * wm + (LANES & 15)) * sa + ((LANES >> 4) << 4)
        for t0 in range(wn, nt, 4 * TILES):
            b_addr = []
            for q in range(TILES // 2):
                tile = np.minimum(t0 + 4 * (2 * q + (LANES >> 4)), nt - 1)
                b_addr.append(w_off + (8 * tile + (LANES & 7)) * sw + (((LANES >> 3) & 1) << 4))
            live = [t0 + 4 * j < nt for j in range(TILES)]
            acc = np.zeros((2, TILES, 32, 4), np.int64)
            for ks in range(ksteps):
                a = [smem.ldmatrix_x4(a_addr + 32 * ks),
                     smem.ldmatrix_x4(a_addr + 16 * sa + 32 * ks)]
                b = [smem.ldmatrix_x4(addr + 32 * ks) for addr in b_addr]
                for j in range(TILES):
                    if live[j]:
                        for i in range(2):
                            q, jj = j >> 1, j & 1
                            mma_s8(acc[i, j], a[i], b[q][:, 2 * jj], b[q][:, 2 * jj + 1])
            for j in range(TILES):
                if not live[j]:
                    continue
                col = 8 * (t0 + 4 * j) + 2 * TG
                for i in range(2):
                    for e in range(4):
                        rows, cols = 32 * wm + 16 * i + G + 8 * (e >> 1), col + (e & 1)
                        assert (out[rows, cols] == np.iinfo(np.int64).min).all(), "written twice"
                        y = acc[i, j, :, e]
                        assert (np.abs(y) < 2 ** 31).all()
                        out[rows, cols] = y
                        epilogue(rows, cols, y)
    assert (out != np.iinfo(np.int64).min).all(), "an output was not written"
    return out


def _requant_shift(y, sl, sr, bias_pre, need_sl):
    """K3's hidden epilogue in int32: the unsigned left shift, the add, the
    arithmetic right shift with sr capped at 31, the clip."""
    y = y.astype(np.int64)
    if need_sl:
        y = ((y << sl) & 0xFFFFFFFF).astype(np.uint32).view(np.int32).astype(np.int64)
    y = ((y + bias_pre) & 0xFFFFFFFF).astype(np.uint32).view(np.int32).astype(np.int64)
    return np.clip(y >> np.minimum(sr, 31), 0, 127)


def _requant_static(y, comb, bq):
    """K7b's hidden epilogue: two f32 roundings, rint half to even, clip."""
    t = y.astype(np.float32) * comb + bq
    return np.clip(np.rint(t), 0, 127).astype(np.int64)


# --------------------------------------------------------------------------- the load


def _funnel_r(lo, hi, s):
    return ((hi.astype(np.uint64) << 32 | lo.astype(np.uint64)) >> (s & 31)).astype(np.uint32)


def _byte_perm(x, y, sel):
    by = np.concatenate([np.asarray(x, np.uint32).view(np.uint8).reshape(-1, 4),
                         np.asarray(y, np.uint32).view(np.uint8).reshape(-1, 4)], axis=1)
    idx = [(sel >> (4 * k)) & 7 for k in range(4)]
    return np.ascontiguousarray(by[:, idx]).view(np.uint32).reshape(-1)


def _transpose4x4(v):
    t0, t1 = _byte_perm(v[0], v[1], 0x5140), _byte_perm(v[2], v[3], 0x5140)
    t2, t3 = _byte_perm(v[0], v[1], 0x7362), _byte_perm(v[2], v[3], 0x7362)
    return [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
            _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]


def load_cols_tile_int8(mem, base, n, d0, row0, tile, stages=fq.INT8_RING_STAGES):
    """``load_cols_tile_int8``: rows row0 .. + 63 of the table [d0, n] at
    byte ``base`` of ``mem`` into ``tile`` [64][imma_astride(d0)] (u8),
    through the ring's staging words where the kernel copies them."""
    k32 = fq.pad32(d0)
    if stages > 0 and row0 + 64 + 4 <= n and base % 4 == 0:
        st = np.zeros((d0, fq.STAGE_WORDS), np.uint32)
        for c in range(fq.STAGE_WORDS * d0):             # col_ring_issue's copies
            f, w = divmod(c, fq.STAGE_WORDS)
            a = base + 4 * (((f * n + row0) >> 2) + w)
            assert base <= a and a + 4 <= base + d0 * n, "a copy outside the table"
            st[f, w] = mem[a:a + 4].view(np.uint32)[0]
        for i in range(16 * (k32 // 4)):
            fg, rq = (i & 7) + 8 * (i >> 7), (i >> 3) & 15
            v = []
            for j in range(4):
                f = 4 * fg + j
                w = np.zeros(1, np.uint32)
                if f < d0:
                    w = _funnel_r(st[f, rq:rq + 1], st[f, rq + 1:rq + 2], 8 * ((f * (n & 3)) & 3))
                v.append(w)
            for r, word in enumerate(_transpose4x4(v)):
                tile[4 * rq + r, 4 * fg:4 * fg + 4] = word.view(np.uint8)
        return
    for i in range(64 * (k32 // 4)):
        r, k4 = i & 63, i >> 6
        for b in range(4):
            f = 4 * k4 + b
            ok = row0 + r < n and f < d0
            tile[r, 4 * k4 + b] = mem[base + f * n + row0 + r] if ok else 0


def _table(d0, n, seed, offset=0):
    """An int8 table [d0, n] in a byte buffer at ``offset``, with garbage
    around it; returns (mem, table)."""
    x = np.random.default_rng(seed).integers(-127, 128, (d0, n)).astype(np.int8)
    mem = np.full(offset + d0 * n + 64, GARBAGE, np.uint8)
    mem[offset:offset + d0 * n] = x.view(np.uint8).reshape(-1)
    return mem, x


@pytest.mark.parametrize("d0", [5, 30, 32, 33, 48, 128])
@pytest.mark.parametrize("n,offset,stages", [(1003, 0, 2), (1024, 0, 2), (1003, 1, 2),
                                             (1003, 0, 0)])
def test_load_writes_the_a_tile_with_zero_padding(d0, n, offset, stages):
    """The ring's path (unaligned feature rows where n is odd; every copy
    inside the table), the byte path (the tiles within 4 bytes of n, an
    unaligned table, no staging buffer) and the ragged last tile all give
    the transposed table: features d0 .. pad32(d0) and rows past n zero."""
    mem, x = _table(d0, n, seed=d0 + n, offset=offset)
    k32 = fq.pad32(d0)
    for row0 in range(0, n, 64):
        tile = np.full((64, fq.imma_astride(d0)), GARBAGE, np.uint8)
        load_cols_tile_int8(mem, offset, n, d0, row0, tile, stages)
        rows = min(64, n - row0)
        assert np.array_equal(tile[:rows, :d0].view(np.int8), x[:, row0:row0 + rows].T)
        assert not tile[:rows, d0:k32].any() and not tile[rows:, :k32].any()


def test_the_transposition_is_free_of_bank_conflicts():
    """A warp's transposition (8 feature groups x 4 row quads): with a
    buffer's rows 17 words apart, each read (and its neighbour word) falls
    on 32 banks; each word written to the A tile on 16, two lanes a bank."""
    for d0, warp in ((32, 0), (32, 3), (128, 9)):
        i = 32 * warp + LANES
        fg, rq = (i & 7) + 8 * (i >> 7), (i >> 3) & 15
        sa = fq.imma_astride(d0)
        for j in range(4):
            for hi in (0, 1):
                banks = (fq.STAGE_WORDS * (4 * fg + j) + rq + hi) % 32
                assert len(set(banks.tolist())) == 32
            banks = (((4 * rq + j) * sa + 4 * fg) // 4) % 32
            assert np.bincount(banks, minlength=32).max() == 2


# --------------------------------------------------------------------------- the stack


def _layers(dims, kind, seed):
    """(weights, epilogue) of a K3 (``shift``) or K7b (``static``) MLP of
    ``dims`` on the CPU, with its qparams."""
    if kind == "shift":
        qparams = synthetic_shift_qparams(dims, seed)
        return fq.qparams_from_numpy(qparams, "cpu"), qparams
    rng = np.random.default_rng(seed)
    params = [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32)
               / np.float32(np.sqrt(dims[i])),
               rng.standard_normal(dims[i + 1]).astype(np.float32) * np.float32(0.1))
              for i in range(len(dims) - 1)]
    x = rng.standard_normal((512, dims[0])).astype(np.float32)
    qparams, _ = fq.quantize_mlp_static(params, x)
    return fq.qparams_static_from_numpy(qparams, "cpu"), qparams


def _blob_parts(dims, raw):
    """(W^T [pad8(dout)][imma_wstride(din)] int8, epilogue [3][pad8(dout)]
    int32) of every layer, and each layer's weight offset, from the blob."""
    by, ws, offs, off = raw.view(np.int8), [], [], 0
    for i in range(len(dims) - 1):
        dp, sw = pad8(dims[i + 1]), fq.imma_wstride(dims[i])
        ws.append(by[off:off + dp * sw].reshape(dp, sw))
        offs.append(off)
        off += dp * sw
    epis = []
    for d in dims[1:]:
        epis.append(raw[off // 4:off // 4 + 3 * pad8(d)].reshape(3, pad8(d)))
        off += 12 * pad8(d)
    assert off == raw.nbytes and off % 16 == 0
    return ws, epis, offs


@pytest.mark.parametrize("dims", WIDTHS)
@pytest.mark.parametrize("kind", ["shift", "static"])
def test_blob_holds_wt_in_int8_with_zero_padding(dims, kind):
    weights, qparams = _layers(dims, kind, seed=3)
    raw = weights.blob.numpy()
    ws, epis, _ = _blob_parts(dims, raw)
    for qp, wt, epi in zip(qparams, ws, epis):
        dout, din = qp[0].shape
        assert np.array_equal(wt[:dout, :din], qp[0])
        assert not wt[dout:].any() and not wt[:, din:].any()
        assert not epi[:, dout:].any()
    assert raw.nbytes == sum(pad8(dims[i + 1]) * (fq.imma_wstride(dims[i]) + 12)
                             for i in range(len(dims) - 1))


def _run_tile(dims, weights, qparams, kind, mem, base, n, row0):
    """K3's or K7b's layer stack over one tile, through the model, in a
    shared memory laid out as the kernel's: the blob, then act0 and act1
    (the tail's scratch is not modelled). Checks each layer and returns the
    scores [pad8(C)][kActStride] f32 of the tile."""
    raw = weights.blob.numpy()
    blob = raw.view(np.uint8)
    ws, epis, offs = _blob_parts(dims, raw)
    act = fq.int8_act_bytes(dims)
    smem = Smem(blob.size + sum(act))
    smem.b[:] = GARBAGE
    smem.put(0, blob)
    buf = [blob.size, blob.size + act[0]]   # act0, act1
    n_layers = len(dims) - 1
    cur = 0 if n_layers % 2 else 1
    tile = np.full((64, fq.imma_astride(dims[0])), GARBAGE, np.uint8)
    load_cols_tile_int8(mem, base, n, dims[0], row0, tile)
    smem.put(buf[cur], tile)
    x = tile[:, :dims[0]].view(np.int8).astype(np.int64)
    for i in range(n_layers):
        din, dout = dims[i], dims[i + 1]
        dp = pad8(dout)
        epi = epis[i]
        last = i == n_layers - 1
        out_off = buf[1 - cur]
        if last:
            h = np.full((dp, ACT_STRIDE), np.nan, np.float32)

            def epilogue(rows, cols, y):
                h[cols, rows] = (y.astype(np.float32) * epi[0][cols].view(np.float32)
                                 + epi[2][cols].view(np.float32))
        else:
            so = fq.imma_astride(dout)
            nxt = np.full((64, so), GARBAGE, np.uint8)

            def epilogue(rows, cols, y):
                if kind == "static":
                    q = _requant_static(y, epi[0][cols].view(np.float32),
                                        epi[2][cols].view(np.float32))
                else:
                    q = _requant_shift(y, epi[0][cols], epi[1][cols], epi[2][cols],
                                       weights.need_sl[i])
                nxt[rows, cols] = q
        got = dense_imma(smem, buf[cur], din, offs[i], dout, epilogue)
        want = x @ qparams[i][0].astype(np.int64).T
        assert np.array_equal(got[:, :dout], want), f"layer {i}"
        assert not got[:, dout:].any()
        if last:
            return h
        # the kernel zeroes the next tile's k padding pad8(dout) .. pad32(dout)
        nxt[:, dp:fq.pad32(dout)] = 0
        smem.put(out_off, nxt)
        y = want
        if kind == "static":
            _, comb, bq = qparams[i]
            q = np.clip(np.rint(y.astype(np.float32) * comb.T + bq.T), 0, 127)
        else:
            _, sl, sr, bias_pre = qparams[i]
            if weights.need_sl[i]:
                y = y << sl.T
            q = np.clip((y + bias_pre.T) >> np.minimum(sr.T, 31), 0, 127)
        assert np.array_equal(nxt[:, :dout].astype(np.int64), q), f"requantized bytes, layer {i}"
        assert not nxt[:, dout:fq.pad32(dout)].any()
        x = q.astype(np.int64)
        cur = 1 - cur


@pytest.mark.parametrize("dims", WIDTHS + [(48, 40, 9)])
@pytest.mark.parametrize("kind", ["shift", "static"])
def test_fragments_rebuild_every_layer_exactly(dims, kind, monkeypatch):
    """Each layer's s32 products, read through the modelled ldmatrix and
    mma fragments from the blob and the loaded A tile, equal x @ W.T
    exactly, zero in the padded columns; the requantized bytes equal K3's or
    K7b's numpy requantization; the scores equal the plain version's bit for
    bit, over a full tile with unaligned feature rows and the ragged last
    one."""
    weights, qparams = _layers(dims, kind, seed=len(dims) + 5)
    n = 203
    mem, x = _table(dims[0], n, seed=11)
    plain = (fq.fused_mlp_query_columnar_int8_shift_plain if kind == "shift"
             else fq.fused_mlp_query_columnar_int8_plain)
    captured = {}
    monkeypatch.setattr(fq, "query_tail_plain", lambda h: captured.setdefault("h", h.numpy()))
    plain(weights, torch.from_numpy(x))
    C = dims[-1]
    for row0 in range(0, n, 64):
        h = _run_tile(dims, weights, qparams, kind, mem, 0, n, row0)
        rows = min(64, n - row0)
        assert np.array_equal(h[:C, :rows].view(np.uint32),
                              captured["h"][:, row0:row0 + rows].view(np.uint32))


# --------------------------------------------------------------------------- budget


def _parent_int8_smem_bytes(dims) -> int:
    """The shared memory of the __dp4a kernels this design replaced: packed
    int32 weights [ceil(din/4)][pad8(dout)] and epilogue rows, the tail's
    scratch, two packed activation tiles at the widest width and the
    scores."""
    widest4 = max([-(-dims[0] // 4)] + [pad8(d) // 4 for d in dims[1:-1]])
    blob = sum(-(-dims[i] // 4) * pad8(dims[i + 1]) + 3 * pad8(dims[i + 1])
               for i in range(len(dims) - 1))
    return (4 * blob + fq._tail_bytes(dims[-1]) + 8 * widest4 * ACT_STRIDE
            + 4 * pad8(dims[-1]) * ACT_STRIDE)


# near the parent's limit: wide hidden layers, many classes
NEAR_LIMIT = [(32, 1000, 16), (32, 1024, 10), (256, 512, 16), (128, 256, 256, 128),
              (64, 900, 32), (512, 256, 16), (64, 256, 256, 256, 16), (200, 300, 100)]


@pytest.mark.parametrize("dims", SIZES + NEAR_LIMIT)
def test_every_mlp_that_fit_still_fits_in_the_tensor_core_layout(dims):
    assert _parent_int8_smem_bytes(dims) <= SMEM_LIMIT
    assert fq.int8_smem_bytes(dims) <= SMEM_LIMIT


def test_only_mlps_at_the_margin_no_longer_fit():
    """Over a grid of widths, an MLP that fit the parent's layout and no
    longer fits took more than 90 % of its budget there: W^T's rows are
    whole 16-byte words (the parent packed 4 inputs a word), which only an
    MLP at the margin, with a wide layer over a narrow input or hundreds of
    classes, cannot spare."""
    ws = [1, 5, 17, 32, 33, 100, 128, 256, 400, 512, 700, 1000, 1200]
    lost = []
    for layers in (1, 2, 3):
        for dims in itertools.product(ws, repeat=layers + 1):
            old = _parent_int8_smem_bytes(dims)
            if old <= SMEM_LIMIT and fq.int8_smem_bytes(dims) > SMEM_LIMIT:
                lost.append(dims)
                assert old > 0.9 * SMEM_LIMIT, dims
    assert lost and (17, 700) in lost


def test_the_model_follows_the_kernels_constants():
    assert TILES in (2, 4) and _constant("kStageWords") == fq.STAGE_WORDS


def test_bench_mlp_fits_four_blocks_an_sm_by_shared_memory():
    """At the bench MLP: 30,144 B of weights and epilogue rows, the tail's
    768, act0 and act1 of 9,216 each (64 rows of 144 bytes; the scores,
    4,352, lie in act1) and two staging buffers of 32 x 17 words: four
    blocks an SM by shared memory."""
    assert fq.int8_act_bytes(BENCH) == (9_216, 9_216)
    assert fq.int8_ring_stages(BENCH) == 2 and fq.int8_stage_bytes(32) == 2_176
    assert fq.int8_smem_bytes(BENCH) == 30_144 + 768 + 2 * 9_216 + 2 * 2_176
    assert _kernels.smem_blocks_per_sm(fq.int8_smem_bytes(BENCH)) == 4


def test_staging_buffers_shrink_to_fit():
    """Where two staging buffers would push the block past its 227 KB, one;
    where not even one fits, none (the byte path)."""
    assert fq.int8_ring_stages((512, 256, 16)) == 1
    assert fq.int8_smem_bytes((512, 256, 16)) <= SMEM_LIMIT
    assert fq.int8_ring_stages((1000, 100, 10)) == 0


SASS = """
        code for sm_90a
                Function : _Z17query_int8_kernelILb1EEvPKaxPKhi7MlpDimsiPxPd
        /*0c40*/                   IMMA.16832.S8.S8 R4, R8.ROW, R12.COL, R4 ;
        /*0c50*/              @!P0 IMMA.16832.S8.S8 R16, R8.ROW, R14.COL, R16 ;
                Function : _Z16query_f32_kernelIfLb1EEvPKT_xPKfi7MlpDimsiiPxPd
        /*0000*/                   FFMA R4, R5, R6, R4 ;
"""


def test_sass_counts_imma_by_kernel():
    counts = _kernels.count_sass(SASS, "IMMA")
    assert counts == {"_Z17query_int8_kernelILb1EEvPKaxPKhi7MlpDimsiPxPd": 2,
                      "_Z16query_f32_kernelIfLb1EEvPKT_xPKfi7MlpDimsiiPxPd": 0}
