"""K2′'s MLP slots inside the fused SQL kernel (``csrc/fused_sql.cu``
``mlp_slot``), on the CPU.

A numpy model of the tile's kept-row list (a warp ballot, each warp's count
before it), of the sub-tiles the MLP runs on and of the scatter back to the
tile's rows; the header word that turns the list on (``pack_plan``); the
bf16 slot's A-tile writer, fed through the fragment and ``ldmatrix`` model
of ``test_torch_mma_layout``; query B's shared-memory budget in bf16; and
the sources: f32 slots on ``mlp_stack_ffma``, bf16 slots on
``mlp_stack_bf16``, the old f32 stack gone. Nothing here needs the card."""

import re

import numpy as np
import pytest
import torch

from infera_tpu_torch.ops import _kernels
from infera_tpu_torch.ops import fused_query as fq
from infera_tpu_torch.ops import fused_sql as fs
from test_torch_mma_layout import Smem, _bf16_bits, _blob, _dyadic, dense_mma

ROWS = fs.SLOT_ROWS          # rows of a tile, one per thread
SUB = 64                     # rows of an MLP sub-tile (kTileRows)
THREADS = 256
BENCH = (32, 128, 128, 16)


def kept_list(mask: np.ndarray) -> np.ndarray:
    """The kernel's list of a tile's kept rows: each warp's ballot of its
    32 rows, each warp's count of the warps before it, and lane l of a warp
    at its count plus the kept lanes below it. Returns the list (-1 past the
    kept rows) as kslot holds it."""
    assert mask.shape == (ROWS,)
    ballots = [sum(1 << lane for lane in range(32) if mask[32 * w + lane]) for w in range(8)]
    warp_kept = [bin(b).count("1") for b in ballots]
    rows = np.full(ROWS, -1, np.int64)
    for t in range(ROWS):
        w, lane = divmod(t, 32)
        if mask[t]:
            before = sum(warp_kept[:w])
            pos = before + bin(ballots[w] & ((1 << lane) - 1)).count("1")
            assert rows[pos] == -1, "two rows at one place"
            rows[pos] = t
    return rows


def _masks():
    rng = np.random.default_rng(0)
    out = {"none": np.zeros(ROWS, bool), "all": np.ones(ROWS, bool),
           "p=0.5": rng.random(ROWS) < 0.5}
    for k in (1, 63, 64, 65, 129):
        m = np.zeros(ROWS, bool)
        m[rng.choice(ROWS, k, replace=False)] = True
        out[str(k)] = m
    return out


MASKS = _masks()


@pytest.mark.parametrize("name", list(MASKS))
def test_kept_list_holds_every_kept_row_once_in_row_order(name):
    mask = MASKS[name]
    rows = kept_list(mask)
    kept = int(mask.sum())
    assert np.array_equal(rows[:kept], np.flatnonzero(mask))
    assert (rows[kept:] == -1).all()


def _layers(params):
    return [(torch.as_tensor(w.T.copy()), torch.as_tensor(b.reshape(-1, 1)))
            for w, b in params]


def _stack(layers, h: torch.Tensor) -> torch.Tensor:
    """The f32 layers as the kernel sums them (``_dense_fma``), [d_in, rows]."""
    for i, (wt, b) in enumerate(layers):
        h = fs._dense_fma(wt, h) + b
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def subtile_preds(layers, feats: np.ndarray, rows: np.ndarray, kept: int, oc: int):
    """``mlp_slot`` over a tile, thread by thread: ceil(kept / 64)
    sub-tiles; thread tid takes entry p = 64 sub + (tid & 63) of the list,
    row t = rows[p] (-1 past kept: zeros), and features tid // 64, + 4,
    ...; the prediction of entry p goes to pred[t]. Returns (pred [256],
    sub-tiles run); rows no sub-tile holds keep NaN."""
    d_in = feats.shape[0]
    pred = np.full(ROWS, np.nan, np.float32)
    n_sub = -(-kept // SUB)
    for sub in range(n_sub):
        act = np.full((d_in, SUB), np.nan, np.float32)
        for tid in range(THREADS):
            r = tid & (SUB - 1)
            p = sub * SUB + r
            t = rows[p] if p < kept else -1
            for k in range(tid // SUB, d_in, THREADS // SUB):
                act[k, r] = feats[k, t] if t >= 0 else 0.0
        assert not np.isnan(act).any(), "an activation was not written"
        out = _stack(layers, torch.as_tensor(act)).numpy()
        for r in range(SUB):
            p = sub * SUB + r
            if p < kept:
                assert np.isnan(pred[rows[p]]), "a row written twice"
                pred[rows[p]] = out[oc, r]
    return pred, n_sub


@pytest.mark.parametrize("name", list(MASKS))
@pytest.mark.parametrize("dims", [(4, 32, 1), (8, 4), (5, 130, 3)])
def test_predictions_on_the_kept_rows_equal_the_dense_pass_bit_for_bit(name, dims):
    """A row's sum does not depend on its place in the sub-tile: the
    scattered predictions equal a pass over all 256 rows on every kept row,
    bit for bit, in ceil(kept / 64) sub-tiles."""
    rng = np.random.default_rng(len(dims))
    params = [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32),
               rng.standard_normal(dims[i + 1]).astype(np.float32))
              for i in range(len(dims) - 1)]
    layers = _layers(params)
    feats = rng.standard_normal((dims[0], ROWS)).astype(np.float32)
    mask = MASKS[name]
    kept = int(mask.sum())
    oc = dims[-1] - 1
    pred, n_sub = subtile_preds(layers, feats, kept_list(mask), kept, oc)
    dense = _stack(layers, torch.as_tensor(feats)).numpy()[oc]
    assert n_sub == -(-kept // SUB)
    assert np.array_equal(pred[mask], dense[mask])
    assert np.isnan(pred[~mask]).all()


def test_subtile_count_of_a_plan_follows_its_where():
    """``mlp_subtiles``: per 256-row tile ceil(kept / 64) sub-tiles a slot
    on the rows the WHERE keeps, ceil(rows / 64) on every row."""
    n = 1000
    x = np.random.default_rng(3).standard_normal((2, n)).astype(np.float32)
    xc = torch.as_tensor(x)
    where = [(fs.COL, 0), (fs.CONST, 0), (fs.GT, 0)]
    plan = _plan(where, [_mlp((2, 4, 1)), _mlp((2, 3))], consts=[0.0])
    packed = fs.pack_plan(plan, "cpu")
    run, dense = fs.mlp_subtiles(packed, xc, n)
    want_run = want_dense = 0
    for row0 in range(0, n, ROWS):
        rows = min(ROWS, n - row0)
        want_run += -(-int((x[0, row0:row0 + rows] > 0).sum()) // SUB)
        want_dense += -(-rows // SUB)
    assert (run, dense) == (2 * want_run, 2 * want_dense)
    assert dense == 2 * (4 + 4 + 4 + 4)      # 1000 rows: tiles of 256, 256, 256, 232
    plan.where = [(fs.PRED, 0), (fs.CONST, 0), (fs.GT, 0)]
    assert fs.mlp_subtiles(fs.pack_plan(plan, "cpu"), xc, n) == (dense, dense)


# --------------------------------------------------------------------------- the header word


def _mlp(dims, bf16=False, feature_rows=None):
    params = [(np.zeros((dims[i], dims[i + 1]), np.float32), np.zeros(dims[i + 1], np.float32))
              for i in range(len(dims) - 1)]
    rows = feature_rows or [k % 2 for k in range(dims[0])]
    return fs.MlpSlot(params=params, final_softmax=True, out_col=0, bf16=bf16,
                      features=[[(fs.COL, r)] for r in rows])


def _forest():
    """One tree: the root tests feature 0 against 0.5, two leaves."""
    node = np.array([[[0, fs._f32_bits(0.5), 1, 2], [-1, 0, 0, 0], [-1, 0, 0, 0]]], np.int32)
    weights = np.array([[[0.0], [1.0], [2.0]]], np.float32)
    return fs.ForestSlot(node=node, weights=weights, max_depth=1, strict=False,
                         features=[[(fs.COL, 0)]])


def _plan(where, preds, consts=(), join=None):
    return fs.FusedPlan(where=where, keys=[[(fs.COL, 1)]], sums=[[(fs.PRED, 0)]], mins=[],
                        maxs=[], strides=[1], n_groups=8, consts=list(consts), preds=preds,
                        join=join)


GT0 = [(fs.COL, 0), (fs.CONST, 0), (fs.GT, 0)]
CASES = {
    "WHERE over columns": (_plan(GT0, [_mlp((2, 4, 1))], [0.0]), 1),
    "WHERE over columns, bf16": (_plan(GT0, [_mlp(BENCH, True)], [0.0]), 1),
    "WHERE over columns, MLP and forest": (_plan(GT0, [_mlp((2, 3)), _forest()], [0.0]), 1),
    "WHERE reads a prediction": (_plan([(fs.PRED, 0), (fs.CONST, 0), (fs.GT, 0)],
                                       [_mlp((2, 4, 1))], [0.0]), 0),
    "WHERE reads a prediction, deep": (_plan(GT0 + [(fs.PRED, 0), (fs.AND, 0)],
                                             [_mlp((2, 4, 1))], [0.0]), 0),
    "no WHERE": (_plan(None, [_mlp((2, 4, 1))]), 0),
    "forest only": (_plan(GT0, [_forest()], [0.0]), 0),
    "no prediction slot": (fs.FusedPlan(where=GT0, keys=[], sums=[[(fs.COL, 1)]], mins=[],
                                        maxs=[], strides=[], n_groups=1, consts=[0.0]), 0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_header_word_turns_the_kept_rows_on(name):
    plan, want = CASES[name]
    packed = fs.pack_plan(plan, "cpu")
    assert fs.mlp_on_kept_rows(plan) == bool(want)
    assert int(packed.words[fs.H_KEPT]) == want
    assert fs.H_KEPT == fs.H_TAIL + 1 < fs.H_SMEM


@pytest.mark.parametrize("dims,bf16,wide", [((4, 32, 1), False, False), ((8, 4), False, False),
                                            ((30, 120, 7), False, False), (BENCH, False, True),
                                            ((5, 130, 3), False, True), ((4, 121), False, True),
                                            ((4, 32, 1), True, True), ((8, 4), True, True)])
def test_the_wide_instance_runs_the_128_column_passes_and_bf16(dims, bf16, wide):
    """K2's kWide instance (2 blocks an SM) for a bf16 slot or an f32 layer
    of 128 columns or more (pad8), and for a forest slot (K4); the other one
    (3 blocks) for the rest, and for a plan without a prediction slot."""
    plan = _plan(GT0, [_mlp((4, 32, 1)), _mlp(dims, bf16)], [0.0])
    assert fs.wide_instance(plan) == wide
    assert fs.wide_instance(_plan(GT0, [_forest()], [0.0]))    # K4 lives there alone
    assert not fs.wide_instance(CASES["no prediction slot"][0])


def test_header_word_of_a_join_plan_whose_where_is_the_match():
    """K5: a WHERE over MATCHED and dim columns reads no prediction."""
    where = [(fs.MATCHED, 0), (fs.DIM, 0), (fs.CONST, 0), (fs.GT, 0), (fs.AND, 0)]
    spec = fs.JoinSpec(fact_key=2, kmax=9, n_dim=10, n_cols=1)
    plan = _plan(where, [_mlp((2, 4, 1))], [0.0], join=spec)
    packed = fs.pack_plan(plan, "cpu", np.arange(10, dtype=np.int32))
    assert int(packed.words[fs.H_KEPT]) == 1


def test_header_layout_matches_the_kernel():
    src = (_kernels.CSRC / "fused_sql.cu").read_text()
    assert re.search(r"H_TAIL, H_KEPT,\s*H_SM_BLOB = 24", src)
    assert "H_TAIL == 22 && H_KEPT == 23 && H_SM_TOTAL == 42" in src
    assert fs.H_SMEM == 24 and fs.H_TAIL == 22 and fs.H_KEPT == 23


# --------------------------------------------------------------------------- the bf16 A tile


def a_tile_writer(feats: np.ndarray, rows: np.ndarray, kept: int, sub: int) -> np.ndarray:
    """``mlp_slot``'s bf16 writer: thread tid takes entry p = 64 sub + (tid
    & 63) of the list and feature pairs k = 2 (tid // 64), + 8, ... below
    mma_stride(d_in), writing bf16(feature k of its row) (RN, zero past d_in
    and for an entry past kept) and of k + 1 as one 4-byte word at A[r][k]."""
    d_in = feats.shape[0]
    sa = fq.mma_stride(d_in)
    a = np.full((SUB, sa), 0xFFFF, np.uint16)      # garbage where nothing writes
    written = np.zeros((SUB, sa), bool)
    for tid in range(THREADS):
        r = tid & (SUB - 1)
        p = sub * SUB + r
        t = rows[p] if p < kept else -1
        for k in range(2 * (tid // SUB), sa, 2 * (THREADS // SUB)):
            for kk in (k, k + 1):
                v = feats[kk, t] if t >= 0 and kk < d_in else 0.0
                bits = torch.tensor([v], dtype=torch.float32).to(torch.bfloat16).view(torch.int16)
                assert not written[r, kk], "written twice"
                a[r, kk] = np.uint16(int(bits) & 0xFFFF)
                written[r, kk] = True
    assert written.all(), "an A-tile element was not written"
    return a


@pytest.mark.parametrize("d_in", [4, 8, 30, 32])
@pytest.mark.parametrize("name", ["p=0.5", "65", "all"])
def test_a_tile_through_the_fragments_is_the_bf16_product(d_in, name):
    """Feature k of the sub-tile's row i lands at A[i][k] as bf16 (RN), the
    k padding and the rows past kept are zero; read through the modelled
    ldmatrix and mma fragments with the blob pack_mma_blob builds, the
    first layer equals bf16(x) @ bf16(W) within f32 rounding."""
    dims = (d_in, 24, 3)
    params, raw = _blob(dims, seed=d_in)
    rng = np.random.default_rng(d_in)
    feats = rng.standard_normal((d_in, ROWS)).astype(np.float32)   # not exact in bf16
    mask = MASKS[name]
    rows, kept = kept_list(mask), int(mask.sum())
    xb = torch.as_tensor(feats).to(torch.bfloat16).float().numpy().astype(np.float64)
    w = params[0][0].astype(np.float64)                            # dyadic: exact in bf16
    for sub in range(-(-kept // SUB)):
        a = a_tile_writer(feats, rows, kept, sub)
        n_rows = min(SUB, kept - sub * SUB)
        ent = rows[sub * SUB:sub * SUB + n_rows]
        assert np.array_equal(a[:n_rows, :d_in], _bf16_bits(xb[:, ent].T.astype(np.float32)))
        assert not a[:, d_in:].any() and not a[n_rows:].any()
        smem = Smem(raw.size + a.nbytes)
        smem.put(0, raw)
        smem.put(raw.size, a)
        got = dense_mma(smem, raw.size, d_in, 0, dims[1])[:, :dims[1]]
        want = np.zeros((SUB, dims[1]))
        want[:n_rows] = xb[:, ent].T @ w
        scale = np.abs(xb[:, ent].T) @ np.abs(w)
        assert (np.abs(got[:n_rows] - want[:n_rows]) <= 2.0 ** -23 * scale + 1e-30).all()
        assert not got[n_rows:].any()


def test_a_tile_writer_with_exact_features_is_exact():
    """With features exact in bf16 (dyadic), the fragments give x @ W in
    f64 exactly, as for K1's load."""
    dims = (32, 16)
    params, raw = _blob(dims, seed=1)
    feats = _dyadic(np.random.default_rng(2), (32, ROWS))
    mask = MASKS["129"]
    rows, kept = kept_list(mask), int(mask.sum())
    a = a_tile_writer(feats, rows, kept, 1)
    smem = Smem(raw.size + a.nbytes)
    smem.put(0, raw)
    smem.put(raw.size, a)
    got = dense_mma(smem, raw.size, 32, 0, 16)
    ent = rows[64:128]
    assert np.array_equal(got[:, :16], feats[:, ent].T.astype(np.float64) @ params[0][0])


# --------------------------------------------------------------------------- budget


def test_smem_budget_of_the_bench_plan_in_bf16():
    """Query B's bf16 plan: the bench MLP in pack_mma_blob's layout (50,496
    B), two A tiles of 17,408 B (the widest layer input, 128, at
    mma_stride 136), G = 64, one key, one sum and one max slot; two blocks
    fit an SM, where the f32 plan's 170 KB fit one."""
    plan = fs.FusedPlan(where=[(fs.COL, 0), (fs.CONST, 0), (fs.GT, 0)], keys=[[(fs.COL, 32)]],
                        sums=[[(fs.PRED, 0)]], mins=[], maxs=[[(fs.PRED, 0)]], strides=[1],
                        n_groups=64, consts=[0.0],
                        preds=[_mlp(BENCH, True, feature_rows=list(range(32)))])
    n_words = fs._HEADER + 2 * 36 + 2 * 38 + 1 + 1 + 16
    assert fq.mma_blob_bytes(BENCH) == 50496
    layout = fs.smem_layout(plan, n_words, 50496 // 4)
    assert fs.smem_bytes(plan) == layout["total"]
    expect = (-(-4 * n_words // 16) * 16 + 50496 + 2 * 17408 + 1024
              + 2 * 1024 + 1024 + 1024 + 8 * 64 + 8 * 64 + 4 * 3 * 64 + 16)
    assert layout["total"] == expect
    assert layout["act1"] - layout["act0"] == 17408 == 2 * 64 * fq.mma_stride(128)
    assert expect <= fq.TWO_BLOCK_SMEM               # two blocks an SM
    assert fs.smem_fits(plan)
    packed = fs.pack_plan(plan, "cpu")
    assert packed.blob_floats == 50496 // 4
    assert all(v % 16 == 0 for k, v in packed.smem.items() if k not in ("widest", "lead"))
    # the blob is pack_mma_blob's, bit for bit
    want = fq.params_from_numpy(plan.preds[0].params, "cpu", torch.bfloat16).mma_blob
    assert torch.equal(packed.blob.view(torch.int32), want)


def test_a_mixed_plan_sizes_its_tiles_for_both_slots():
    """An f32 slot and a bf16 slot: each tile the larger of the f32 tile at
    the f32 slot's widest width and the bf16 slot's A tile or scores."""
    f32, bf16 = _mlp((4, 200, 1)), _mlp(BENCH, True)
    plan = _plan(GT0, [f32, bf16], [0.0])
    n_words, blob_floats = fs._sizes(plan)
    assert blob_floats == (4 * 200 + 200 + 200 * 8 + 8) + 50496 // 4
    layout = fs.smem_layout(plan, n_words, blob_floats)
    f32_tile = 4 * 200 * fs.ACT_STRIDE
    assert layout["act1"] - layout["act0"] == max(f32_tile, 17408)
    assert layout["pred"] - layout["act1"] == max(f32_tile, 17408)


# --------------------------------------------------------------------------- sources


def test_fused_sql_runs_f32_on_ffma_and_bf16_on_the_tensor_cores():
    sql = (_kernels.CSRC / "fused_sql.cu").read_text()
    tile = (_kernels.CSRC / "mlp_tile.cuh").read_text()
    body = sql[sql.index("__device__ void mlp_slot("):sql.index("__device__ inline bool is_finite")]
    assert "mlp_stack_ffma<Block, kWide>(" in body and "mlp_stack_bf16(" in body
    assert '#include "mma_tile.cuh"' in sql
    for gone in ("dense_f32", "mlp_stack_f32", "kRoundBf16", "round_bf16"):
        assert gone not in tile and gone not in sql
    # two instances: 3 blocks an SM without the 4 x 8 tile and the tensor
    # cores, 2 with them
    assert "__launch_bounds__(kThreads, kWide ? 2 : 3)" in sql
    assert "const bool mma = kWide && md[12] != 0;" in body
    # a bare-column feature is read straight from the block
    assert "mlp_feature(plan, feat + k," in body and "run_program(plan, feat" not in body
    assert "pt[1] == 1 && code[0] == COL" in sql
