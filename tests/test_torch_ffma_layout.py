"""The f32 layer stack of K6, K1 and K7a (``csrc/mlp_tile.cuh``
``mlp_stack_ffma``) and their two halves a block, on the CPU.

A numpy model of ``dense_units`` deals each layer's 64 x pad8(dout) outputs
to the 256 threads of a half the way the kernel does (the wide 4 x 8 tile
over 128-column passes, the narrow or thin tile over the rest, with the
tile shapes read from the source) and computes every output from the
shared-memory layouts the kernel reads: the f32 blob ``pack_f32_blob``
builds and feature-major activation tiles of 68 words a feature. Each
output must be written once, every thread of a half must work where a
pass has enough outputs, a warp's step must read one 128-byte run of
activations, and each layer must equal ``chip_smoke.fma_map`` (from 0, one
fused multiply-add per input in input order, then the bias) bit for bit.
Then the halves' walk over the tiles, the halves chosen for each MLP and
their shared memory, and the whole kernel (its tiles, tail, partials and
fold) against ``infera_tpu``'s Pallas kernels in interpret mode. Nothing
here needs the card."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import fma_map
from infera_tpu.ops import pallas_query as pallas_q
from infera_tpu.ops.pallas_mlp import fused_mlp_padded
from infera_tpu_torch.ops import _kernels
from infera_tpu_torch.ops import fused_mlp as fm
from infera_tpu_torch.ops import fused_query as fq
from test_torch_kernel_layout import MLPS

BENCH = (32, 128, 128, 16)
SRC = (_kernels.CSRC / "mlp_tile.cuh").read_text()


def _constant(name: str) -> int:
    """A constexpr int of csrc/mlp_tile.cuh, so the model follows the kernel."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


THREADS = _constant("kThreads")
ROWS = _constant("kTileRows")
STRIDE = fm.ACT_STRIDE
PASS = _constant("kPassCols")
HALVES = _constant("kMaxHalves")
WIDE = tuple(_constant(f"kWide{k}") for k in ("Rows", "Cols", "Lanes"))
NARROW = tuple(_constant(f"kNarrow{k}") for k in ("Rows", "Cols", "Lanes"))
THIN = tuple(_constant(f"kThin{k}") for k in ("Rows", "Cols", "Lanes"))


def passes(doutp: int) -> list:
    """``dense_ffma``'s passes over a layer of ``doutp`` columns:
    (first column, end column, (rows, columns, row lanes) of the tile)."""
    wide = doutp // PASS * PASS
    out = [(0, wide, WIDE)] if wide else []
    if doutp - wide >= 16:
        out.append((wide, doutp, NARROW))
    elif doutp > wide:
        out.append((wide, doutp, THIN))
    return out


def units(c0: int, c1: int, tile) -> tuple:
    """``dense_units``'s map of columns c0 .. c1 - 1: for every unit its
    thread, warp slot, first row and first column (numpy arrays)."""
    rm, cn, rl = tile
    row_warps, col_lanes = ROWS // (rl * rm), 32 // rl
    u = np.arange((ROWS // rm) * ((c1 - c0) // cn))
    lane, slot = u & 31, u >> 5
    r = rm * ((slot % row_warps) * rl + lane % rl)
    c = c0 + cn * ((slot // row_warps) * col_lanes + lane // rl)
    return u % THREADS, slot, r, c


def dense_model(act, din, blob, wl, bl, doutp, hidden, widest):
    """One layer as the half computes it: [widest * STRIDE] f32, NaN where
    no thread wrote. Checks that every output is written once and that the
    vector loads and stores are aligned."""
    out = np.full(widest * STRIDE, np.nan, np.float32)
    writes = np.zeros((doutp, ROWS), np.int64)
    for c0, c1, (rm, cn, rl) in passes(doutp):
        _, _, r, c = units(c0, c1, (rm, cn, rl))
        vec = min(cn, 4)   # floats of one load of weights (cn = 8: two float4)
        assert STRIDE % rm == 0 and (r % rm == 0).all()
        assert doutp % vec == 0 and (c % vec == 0).all()
        acc = np.zeros((r.size, rm, cn), np.float32)
        for k in range(din):
            av = act[k * STRIDE + r[:, None] + np.arange(rm)].astype(np.float64)
            bv = blob[wl + k * doutp + c[:, None] + np.arange(cn)].astype(np.float64)
            acc = (acc.astype(np.float64) + av[:, :, None] * bv[:, None, :]).astype(np.float32)
        t = acc + blob[bl + c[:, None] + np.arange(cn)][:, None, :]
        if hidden:
            t = np.where(t < 0, np.float32(0), t)
        for i in range(rm):
            for j in range(cn):
                out[(c + j) * STRIDE + r + i] = t[:, i, j]
                np.add.at(writes, (c + j, r + i), 1)
    assert (writes == 1).all()
    return out


def stack_model(dims, blob, tile_x):
    """``mlp_stack_ffma`` over one tile ``tile_x`` [64, d0] f32: every
    layer's output [dout, 64] (the scores last)."""
    widest = max(fm.pad8(d) for d in dims)
    cur = np.full(widest * STRIDE, np.nan, np.float32)
    for k in range(dims[0]):
        cur[k * STRIDE:k * STRIDE + ROWS] = tile_x[:, k]
    w_total = sum(dims[i] * fm.pad8(dims[i + 1]) for i in range(len(dims) - 1))
    wl, bl, outs = 0, w_total, []
    for l in range(len(dims) - 1):
        doutp = fm.pad8(dims[l + 1])
        cur = dense_model(cur, dims[l], blob, wl, bl, doutp, l + 2 < len(dims), widest)
        outs.append(cur[:dims[l + 1] * STRIDE].reshape(dims[l + 1], STRIDE)[:, :ROWS])
        wl += dims[l] * doutp
        bl += doutp
    return outs


def _params(dims, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32)
             / np.float32(np.sqrt(dims[i])),
             rng.standard_normal(dims[i + 1]).astype(np.float32) * np.float32(0.1))
            for i in range(len(dims) - 1)]


def _blob(params) -> np.ndarray:
    return fm.pack_f32_blob([torch.from_numpy(w) for w, _ in params],
                            [torch.from_numpy(b) for _, b in params]).numpy()


# --------------------------------------------------------------------------- the thread map


@pytest.mark.parametrize("dims", MLPS)
def test_every_output_once_and_every_thread_at_work(dims):
    for dout in dims[1:]:
        doutp = fm.pad8(dout)
        owner = np.full((doutp, ROWS), -1)
        for c0, c1, (rm, cn, rl) in passes(doutp):
            tid, _, r, c = units(c0, c1, (rm, cn, rl))
            assert tid.max() < THREADS
            for i in range(rm):
                for j in range(cn):
                    assert (owner[c + j, r + i] == -1).all()
                    owner[c + j, r + i] = tid
            if ROWS * (c1 - c0) >= THREADS * rm * cn:
                assert np.unique(tid).size == THREADS, (dims, doutp, c0, c1)
        assert (owner >= 0).all()


def test_the_narrow_last_layer_runs_on_a_warp_of_each_scheduler():
    """The bench MLP's 16 classes: 128 threads, warps 0-3, one on each of
    the SM's four schedulers, where the 4 x 8 tile left them to one warp."""
    (c0, c1, tile), = passes(16)
    assert tile == NARROW and tile[0] * tile[1] < WIDE[0] * WIDE[1]
    tid, _, _, _ = units(c0, c1, tile)
    warps = np.unique(tid // 32)
    assert tid.size == 128 and list(warps) == [0, 1, 2, 3]
    assert sorted(set(warps % 4)) == [0, 1, 2, 3]


@pytest.mark.parametrize("doutp", range(8, PASS, 8))
def test_a_warp_step_reads_one_run_of_activations(doutp):
    """A step k of the narrow or thin tile: a warp's activation reads are
    one contiguous run of at most 128 bytes (one wavefront) and its weight
    reads at most 128 bytes."""
    (c0, c1, (rm, cn, rl)), = passes(doutp)
    _, slot, r, c = units(c0, c1, (rm, cn, rl))
    for s in np.unique(slot):
        rows = np.unique((r[slot == s, None] + np.arange(rm)).ravel())
        cols = np.unique((c[slot == s, None] + np.arange(cn)).ravel())
        assert rows.size * 4 <= 128 and rows.max() - rows.min() + 1 == rows.size
        assert cols.size * 4 <= 128


@pytest.mark.parametrize("dims", [BENCH, (30, 200, 7), (5, 130, 3), (33, 64, 10), (4, 32, 1),
                                  (8, 4), (30, 64, 48, 10)])
def test_model_rebuilds_every_layer_as_fma_map(dims):
    """Every layer's output, computed by the thread map from the blob and
    the activation tiles, equals chip_smoke.fma_map's order bit for bit (a
    ragged tile of 50 rows: the rows past n are zero)."""
    params = _params(dims, seed=len(dims) + dims[0])
    x = np.zeros((ROWS, dims[0]), np.float32)
    x[:50] = np.random.default_rng(5).standard_normal((50, dims[0])).astype(np.float32)
    outs = stack_model(dims, _blob(params), x)
    h = x
    for l, (w, b) in enumerate(params):
        h = fma_map(h, w, b)
        if l + 1 < len(params):
            h = np.where(h < 0, np.float32(0), h)
        assert np.array_equal(outs[l], h.T), (dims, l)


# --------------------------------------------------------------------------- two halves a block


@pytest.fixture()
def card(monkeypatch):
    """A device of 132 SMs without a card: grid_blocks reads the SM count
    from its cache."""
    monkeypatch.setitem(_kernels._SM_COUNT, 0, 132)
    return torch.device("cuda", 0)


def half_tiles(n_tiles: int, grid: int, halves: int) -> dict:
    """{(block, half): its tiles}: half h of block b takes halves * b + h,
    then steps of halves * grid (``Half.index``, ``Half.step``)."""
    return {(b, h): list(range(halves * b + h, n_tiles, halves * grid))
            for b in range(grid) for h in range(halves)}


@pytest.mark.parametrize("n_tiles", [1, 3, 131, 263, 264, 265, 16_384, 15_626])
@pytest.mark.parametrize("halves", [1, 2])
def test_halves_walk_every_tile_once(card, n_tiles, halves):
    grid = fm.grid_for(card, n_tiles * ROWS, halves, 232_000, 1)
    assert grid == min(132, -(-n_tiles // halves))
    walk = half_tiles(n_tiles, grid, halves)
    tiles = sorted(t for ts in walk.values() for t in ts)
    assert tiles == list(range(n_tiles))
    # each half's row of the partials is its first tile's index
    rows = sorted(halves * b + h for b, h in walk)
    assert rows == list(range(halves * grid))
    if n_tiles < halves * grid:
        assert any(not ts for ts in walk.values()) or halves * grid - n_tiles < halves


def test_the_bench_mlp_runs_two_halves(card):
    """K1: 91,200 B of weights and biases, and each half 768 B of tail and
    two 64 x 128 activation tiles of 68 words a feature; K6 the same
    without the tail; K7a K1's without its ring. 132 blocks over 1,048,576
    rows."""
    assert fq.query_halves(BENCH) == fm.mlp_halves(BENCH) == HALVES == 2
    assert fq.query_smem_bytes(BENCH, 2) == 91_200 + 2 * (768 + 2 * 128 * 68 * 4) == 232_000
    assert fm.smem_bytes(BENCH, 2) == 91_200 + 2 * 2 * 128 * 68 * 4 == 230_464
    assert fq.query_smem_bytes(BENCH, 2) <= fm.SMEM_LIMIT
    for item in (2, 4):
        assert fq.rows_query_layout(BENCH, item) == (2, 0, 232_000)
        assert fq.rows_query_layout(BENCH, item, 1) == (
            1, fq.ring_stages(BENCH, item), fq.rows_query_smem_bytes(BENCH, item))
    assert fm.grid_for(card, 1 << 20, 2, 232_000, 1) == 132
    assert fm.THREADS == THREADS and fm.MAX_HALVES == HALVES


@pytest.mark.parametrize("dims", [(30, 200, 7), (32, 300, 16), (64, 256, 10)])
def test_one_half_where_two_do_not_fit(dims):
    assert fq.query_smem_bytes(dims) <= fm.SMEM_LIMIT < fq.query_smem_bytes(dims, 2)
    assert fq.query_halves(dims) == 1
    assert fq.rows_query_layout(dims, 4) == (1, fq.ring_stages(dims, 4),
                                             fq.rows_query_smem_bytes(dims, 4))
    if fm.smem_bytes(dims) <= fm.SMEM_LIMIT < fm.smem_bytes(dims, 2):
        assert fm.mlp_halves(dims) == 1


def _sweep():
    rng = np.random.default_rng(0)
    dims = list(MLPS)
    for _ in range(300):
        n_layers = int(rng.integers(1, 5))
        dims.append(tuple(int(v) for v in rng.integers(1, 260, n_layers + 1)))
    return dims


def test_every_mlp_admitted_before_still_is():
    """The halves are a launch shape: an MLP whose one-half budget fits (as
    every MLP did before the halves) still gets a shape that fits."""
    admitted = {1: 0, 2: 0}
    for dims in _sweep():
        if fq.query_smem_bytes(dims) <= fm.SMEM_LIMIT:
            admitted[fq.query_halves(dims)] += 1
            assert fq.query_smem_bytes(dims, fq.query_halves(dims)) <= fm.SMEM_LIMIT
            for item in (2, 4):
                if fq.rows_query_smem_bytes(dims, item) <= fm.SMEM_LIMIT:
                    assert fq.rows_query_layout(dims, item)[2] <= fm.SMEM_LIMIT
        if fm.smem_fits(dims):
            assert fm.smem_bytes(dims, fm.mlp_halves(dims)) <= fm.SMEM_LIMIT
    assert admitted[1] > 20 and admitted[2] > 20, admitted


def _kernel_body(name: str, kernel: str) -> str:
    src = (_kernels.CSRC / name).read_text()
    start = src.index(f"\n{kernel}(")
    return src[src.rindex("__global__", 0, start):src.index("\n}\n", start)]


@pytest.mark.parametrize("name,kernel", [("fused_query.cu", "query_f32_kernel"),
                                         ("fused_mlp.cu", "fused_mlp_kernel")])
def test_halves_synchronise_only_themselves(name, kernel):
    """Inside the tile loop a half waits on its own named barrier (1 + h, 256
    threads), never on __syncthreads, and the block is 512 threads at most
    128 registers."""
    body = _kernel_body(name, kernel)
    assert "__launch_bounds__(kMaxHalves * kThreads, 1)" in body
    loop = body[body.index("for (long long tile = g.index()"):]
    assert "__syncthreads" not in loop and "g.sync()" in loop
    assert body.count("__syncthreads") == 1        # after the one copy of the weights
    half = SRC[SRC.index("struct Half"):SRC.index("};", SRC.index("struct Half"))]
    assert re.search(r'"bar\.sync %0, %1;\\n" ::"r"\(1 \+ h\), "r"\(kThreads\)', half)
    assert "mlp_stack_ffma" in body and "mlp_stack_f32" not in body.replace("mlp_stack_ffma", "")


# --------------------------------------------------------------------------- the whole kernel


def query_model(params, xc: np.ndarray, grid: int, halves: int):
    """K1 in f32 as the card runs it, from the model of its layers: the
    halves walk their tiles, each keeps per-class counts and f64 sums in
    row order, writes its row of the partials, and the fold adds the rows
    in order. Returns (counts int64, sums f32)."""
    dims = (xc.shape[0],) + tuple(w.shape[1] for w, _ in params)
    blob, n, C = _blob(params), xc.shape[1], dims[-1]
    n_tiles = -(-n // ROWS)
    part_cnt = np.zeros((halves * grid, C), np.int64)
    part_sum = np.zeros((halves * grid, C), np.float64)
    for (b, h), tiles in half_tiles(n_tiles, grid, halves).items():
        for tile in tiles:
            x = np.zeros((ROWS, dims[0]), np.float32)
            rows = min(ROWS, n - tile * ROWS)
            x[:rows] = xc[:, tile * ROWS:tile * ROWS + rows].T
            s = stack_model(dims, blob, x)[-1]                 # [C, 64]
            keep = (np.arange(ROWS) < rows) & (s[0] > 0)
            pred = np.where(keep, s.argmax(0), -1)
            for c in range(C):
                part_cnt[halves * b + h, c] += (pred == c).sum()
                part_sum[halves * b + h, c] += sum(float(v) for v in s[0][pred == c])
    sums = np.zeros(C, np.float64)
    for row in part_sum:
        sums += row
    return part_cnt.sum(0), sums.astype(np.float32)


def test_query_model_matches_pallas_interpret():
    """K1's kernel, modelled on 3 blocks of two halves over 2,048 rows (32
    tiles), against infera_tpu's Pallas kernel in interpret mode: counts
    exact, sums (f32 scores summed in f64 here, in f32 there) within rtol
    1e-4, as tests/test_torch_fused_query.py holds the port's plain
    version; and against the port's plain version, counts exact."""
    dims = (32, 64, 64, 16)
    params = _params(dims, seed=12)
    xc = np.random.default_rng(13).standard_normal((32, 2048)).astype(np.float32)
    got_c, got_s = query_model(params, xc, grid=3, halves=2)
    jp = [(jnp.asarray(w), jnp.asarray(b)) for w, b in params]
    want_c, want_s = pallas_q.fused_mlp_query_columnar(jp, jnp.asarray(xc), tile_n=256,
                                                       interpret=True)
    assert got_c.sum() > 2048 // 8
    np.testing.assert_array_equal(got_c, np.asarray(want_c))
    np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=1e-4, atol=1e-4)
    plain_c, _ = fq.fused_mlp_query_columnar_plain(fq.params_from_numpy(params, "cpu"),
                                                   torch.from_numpy(xc))
    np.testing.assert_array_equal(got_c, plain_c.numpy())


def test_one_and_two_halves_give_the_same_counts_and_close_sums():
    """The same tiles on another launch shape: the scores are the same
    bits, only the f64 sums' grouping over partial rows changes."""
    dims = (30, 64, 48, 10)
    params = _params(dims, seed=3)
    xc = np.random.default_rng(4).standard_normal((30, 1000)).astype(np.float32)   # ragged
    c1, s1 = query_model(params, xc, grid=5, halves=1)
    c2, s2 = query_model(params, xc, grid=5, halves=2)
    c3, s3 = query_model(params, xc, grid=40, halves=2)     # more halves than tiles
    assert np.array_equal(c1, c2) and np.array_equal(c1, c3)
    np.testing.assert_allclose(s2, s1, rtol=1e-6)
    np.testing.assert_allclose(s3, s1, rtol=1e-6)


def test_k6_model_matches_pallas_interpret():
    """K6's layers, modelled tile by tile over 300 rows (a ragged last
    tile), then the softmax as the kernel takes it (exp(x - max) / sum, in
    f32), against infera_tpu's Pallas kernel in interpret mode within the
    tolerance tests/test_torch_fused_mlp.py holds the port to."""
    dims = (12, 40, 5)
    params = _params(dims, seed=8)
    x = np.random.default_rng(9).standard_normal((300, 12)).astype(np.float32)
    blob = _blob(params)
    out = []
    for t0 in range(0, 300, ROWS):
        tile = np.zeros((ROWS, 12), np.float32)
        rows = min(ROWS, 300 - t0)
        tile[:rows] = x[t0:t0 + rows]
        h = stack_model(dims, blob, tile)[-1].T[:rows]
        e = np.exp(h - h.max(1, keepdims=True))
        out.append(e / e.sum(1, keepdims=True))
    got = np.concatenate(out)
    want = fused_mlp_padded([(jnp.asarray(w), jnp.asarray(b)) for w, b in params],
                            jnp.asarray(x), tile_n=256, final_softmax=True, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
