"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA card (H100, sm_90a) and skip without one. On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``
(the file imports no JAX, so it runs where JAX is not installed). The shapes
cover what the main path does not: one row, ragged tiles, a layer wider than
one 128-column pass, widths that are no multiple of 4 or 8, and left shifts
in K3; K7a over row-major f32 and bf16 tables and K7b with its f32
epilogues, at a tile multiple and ragged row counts, and the engine's int8
chain against the CPU's; for K2, every opcode of the programs, the key guards, MLP slots in
f32 and bf16 on the rows a WHERE keeps (none, one, about half, every row)
and on every row where the WHERE reads the prediction (f32 without a
softmax bit for bit), an f32 and a bf16 slot in one plan, and the SQL
flagship through Connection.execute; for K4,
regressors and classifiers (binary, 3 and 6 classes) over heap and non-heap
trees, 61 trees, a NaN feature, on every route (records in shared or device
memory, and without the feature tile) at 1,000,003 rows, run-to-run equality, and tree queries
through Connection.execute; for K5, a permuted 1:1 key, keys
with no dim row, negative keys, outer masking over NaN dim values, an MLP
over dim columns (in f32 and bf16), ragged row counts, the no-fallback rule and join queries
through Connection.execute; for K2 b–e (the aggregate tail), every tail
slot against plain at the main path's row counts, the run-to-run equality of
their partials, the group-key probe as a K2 launch, and the tail's queries
through Connection.execute; for K8a and K8b (the profiling kernels), ragged
row counts, another MLP's widths and an odd table width, K8a against K8b's
scan and K8b's full stage against K7a bf16; for K2's tile reduction, one
group, 512 groups, a tile in one group, a group a lane, empty groups, with
and without its lead table, and run-to-run equality; for K7a's ring,
table widths of 1, 33 and 128 values and an unaligned table against the
scalar load; for the tensor-core path of K1, K7a and K8b in bf16, odd
widths, HMMA in the bf16 kernels' SASS (K2's bf16 instance included) and
none in the f32 ones, and two resident blocks an SM at the bench MLP; for K3 and K7b on the tensor cores,
the layout tests' widths, an unaligned table, IMMA in their SASS and none
elsewhere, no spill, and a grid of their resident blocks; for the f32 layer
stack of K1, K7a and K6 (two halves a block), every width of
``test_torch_kernel_layout.MLPS`` at 1,000,003 rows and at fewer tiles than
the grid has halves, one half against two on the same MLP, K6 in
``chip_smoke.fma_map``'s order bit for bit, and no spill at 128 registers
on a grid of 132 blocks of 512 threads."""

import numpy as np
import pytest
import torch

from infera_tpu_torch.ops import fused_mlp as fm
from infera_tpu_torch.ops import fused_query as fq
from infera_tpu_torch.ops import fused_sql as fs
from infera_tpu_torch.testing import profile_query as pq
from test_torch_kernel_layout import MLPS

pytestmark = pytest.mark.cuda


def synthetic_shift_qparams(dims, seed):
    """Random int8 weights with left shifts in use (the benchmark's
    calibration happens to need none), in quantize_mlp_shift's layout."""
    rng = np.random.default_rng(seed)
    qparams = []
    for i in range(len(dims) - 1):
        dout, din = dims[i + 1], dims[i]
        wq = rng.integers(-127, 128, (dout, din)).astype(np.int8)
        if i < len(dims) - 2:
            qparams.append((wq, rng.integers(0, 3, (dout, 1)).astype(np.int32),
                            rng.integers(8, 14, (dout, 1)).astype(np.int32),
                            rng.integers(-2000, 2000, (dout, 1)).astype(np.int32)))
        else:
            qparams.append((wq, np.exp2(rng.integers(-12, -8, (dout, 1))).astype(np.float32),
                            np.zeros((dout, 1), np.int32),
                            (rng.standard_normal((dout, 1)) * 0.1).astype(np.float32)))
    return qparams


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _params(dims, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32)
             / np.float32(np.sqrt(dims[i])),
             rng.standard_normal(dims[i + 1]).astype(np.float32) * np.float32(0.1))
            for i in range(len(dims) - 1)]


def _rows(n, d0, seed, device):
    x = np.random.default_rng(seed).standard_normal((n, d0)).astype(np.float32)
    return torch.as_tensor(x, device=device)


@pytest.mark.parametrize("softmax", [False, True])
@pytest.mark.parametrize("dims,n", [((3, 1), 1), ((32, 128, 128, 16), 1000),
                                    ((12, 200, 5), 777), ((7, 9, 9, 9, 3), 64)])
def test_k6_matches_plain(cuda, dims, n, softmax):
    weights = fm.mlp_weights(_params(dims, seed=n), cuda)
    x = _rows(n, dims[0], 1, cuda)
    before = fm.fused_mlp.launches
    got = fm.fused_mlp(weights, x, softmax)
    torch.cuda.synchronize()
    assert fm.fused_mlp.launches == before + 1
    want = fm.fused_mlp_plain(weights, x, softmax)
    # f32 on both sides, sums in another order: the 1e-5 parity bound
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_k6_refuses_what_it_does_not_take(cuda):
    weights = fm.mlp_weights(_params((4, 2), seed=0), cuda)
    with pytest.raises(ValueError):
        fm.fused_mlp(weights, torch.zeros((8, 4), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        fm.fused_mlp(weights, torch.zeros((8, 5), device=cuda))
    with pytest.raises(ValueError):
        fm.fused_mlp(weights, torch.zeros((4, 8), device=cuda).T)


def _query_close(got, want, count_tol, rtol):
    gc, gs = (t.cpu().numpy() for t in got)
    wc, ws = (t.cpu().numpy() for t in want)
    assert np.abs(gc - wc).sum() <= count_tol
    np.testing.assert_allclose(gs, ws, rtol=rtol, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims,n", [((32, 64, 64, 16), 5000), ((30, 200, 7), 65),
                                    ((32, 16), 1), ((5, 3), 63)])
def test_k1_matches_plain(cuda, dims, n, dtype):
    weights = fq.params_from_numpy(_params(dims, seed=n), cuda, dtype)
    xc = _rows(n, dims[0], 2, cuda).T.contiguous().to(dtype)
    before = fq.fused_mlp_query_columnar.launches[fq._COMPUTE[dtype]]
    got = fq.fused_mlp_query_columnar(weights, xc)
    torch.cuda.synchronize()
    assert fq.fused_mlp_query_columnar.launches[fq._COMPUTE[dtype]] == before + 1
    # another summation order can flip a near-tie or a near-zero score0 in
    # f32, and then a bf16 rounding of a ReLU output
    _query_close(got, fq.fused_mlp_query_columnar_plain(weights, xc),
                 count_tol=1 if dtype == torch.float32 else max(1, n // 500),
                 rtol=1e-4 if dtype == torch.float32 else 2e-2)


def test_k1_f32_table_in_bf16_mode(cuda):
    """A f32 table in bf16 mode is rounded to bf16 by the kernel, as the
    TPU kernel's astype does."""
    weights = fq.params_from_numpy(_params((32, 64, 16), seed=3), cuda, torch.bfloat16)
    xc = _rows(3000, 32, 4, cuda).T.contiguous()
    got = fq.fused_mlp_query_columnar(weights, xc)
    want = fq.fused_mlp_query_columnar(weights, xc.to(torch.bfloat16))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("dims,n,seed", [((32, 64, 48, 16), 4099, 11), ((30, 20, 6), 64, 12),
                                         ((9, 130, 3), 1, 13), ((30, 200, 7), 4161, 19),
                                         ((5, 3), 63, 20), ((30, 64, 48, 10), 100_003, 21),
                                         ((32, 128, 128, 16), 100_003, 22)])
def test_k3_matches_plain_exactly(cuda, dims, n, seed):
    qparams = synthetic_shift_qparams(dims, seed)
    weights = fq.qparams_from_numpy(qparams, cuda)
    xq = torch.as_tensor(
        np.random.default_rng(seed).integers(-127, 128, (dims[0], n)).astype(np.int8),
        device=cuda)
    before = fq.fused_mlp_query_columnar_int8_shift.launches
    got = fq.fused_mlp_query_columnar_int8_shift(weights, xq)
    torch.cuda.synchronize()
    assert fq.fused_mlp_query_columnar_int8_shift.launches == before + 1
    want = fq.fused_mlp_query_columnar_int8_shift_plain(weights, xq)
    # integer layers are exact and the last layer is the same f32 multiply
    # and add on both sides: counts are bit-exact
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dims,n", [((32, 64, 64, 16), 5000), ((32, 128, 128, 16), 4096),
                                    ((30, 200, 7), 65), ((32, 16), 1), ((5, 3), 63)])
@pytest.mark.parametrize("compute,table", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.bfloat16),
                                           (torch.bfloat16, torch.float32)])
def test_k7a_matches_plain(cuda, dims, n, compute, table):
    """K7a over a row-major table: f32, bf16 over a bf16 table, and bf16 over
    an f32 table rounded at load."""
    weights = fq.params_from_numpy(_params(dims, seed=n + 1), cuda, compute)
    x = _rows(n, dims[0], 3, cuda).to(table)
    before = fq.fused_mlp_query.launches[fq._COMPUTE[compute]]
    got = fq.fused_mlp_query(weights, x)
    torch.cuda.synchronize()
    assert fq.fused_mlp_query.launches[fq._COMPUTE[compute]] == before + 1
    f32 = compute == torch.float32
    _query_close(got, fq.fused_mlp_query_plain(weights, x),
                 count_tol=1 if f32 else max(1, n // 500), rtol=1e-4 if f32 else 2e-2)


def test_k7a_equals_k1_on_the_transposed_table(cuda):
    """The same tile, read row-major and transposed in shared memory, goes
    through the same layer stack and tail: bit-equal to K1."""
    for dtype in (torch.float32, torch.bfloat16):
        weights = fq.params_from_numpy(_params((32, 128, 128, 16), seed=8), cuda, dtype)
        x = _rows(100_003, 32, 9, cuda).to(dtype)
        rows = fq.fused_mlp_query(weights, x)
        cols = fq.fused_mlp_query_columnar(weights, x.T.contiguous())
        for a, b in zip(rows, cols):
            assert torch.equal(a, b)


def _static_qparams(dims, seed, n):
    params = _params(dims, seed)
    x = np.random.default_rng(seed + 1).standard_normal((n, dims[0])).astype(np.float32)
    qparams, s0 = fq.quantize_mlp_static(params, x[:4096])
    xq = np.clip(np.rint(x / s0), -127, 127).astype(np.int8).T.copy()
    return qparams, xq


@pytest.mark.parametrize("dims,n,seed", [((32, 128, 128, 16), 4096, 14),
                                         ((32, 64, 48, 16), 4099, 15), ((30, 20, 6), 64, 16),
                                         ((9, 130, 3), 1, 17), ((30, 200, 7), 4161, 23),
                                         ((5, 3), 63, 24), ((30, 64, 48, 10), 100_003, 25),
                                         ((32, 128, 128, 16), 100_003, 26)])
def test_k7b_matches_plain_exactly(cuda, dims, n, seed):
    qparams, xq_np = _static_qparams(dims, seed, n)
    weights = fq.qparams_static_from_numpy(qparams, cuda)
    xq = torch.as_tensor(xq_np, device=cuda)
    before = fq.fused_mlp_query_columnar_int8.launches
    got = fq.fused_mlp_query_columnar_int8(weights, xq)
    torch.cuda.synchronize()
    assert fq.fused_mlp_query_columnar_int8.launches == before + 1
    want = fq.fused_mlp_query_columnar_int8_plain(weights, xq)
    # exact integer layers and the same two-rounding f32 epilogues with
    # rint on both sides: counts are bit-exact
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("static", [False, True])
def test_int8_unaligned_table_equals_the_aligned_one(cuda, static):
    """A table whose base is not 4-byte aligned takes the load's byte path:
    the same counts and sums as the word path over the same values."""
    dims = (32, 128, 128, 16)
    if static:
        qparams, xq_np = _static_qparams(dims, 27, 100_003)
        weights = fq.qparams_static_from_numpy(qparams, cuda)
        kern = fq.fused_mlp_query_columnar_int8
    else:
        weights = fq.qparams_from_numpy(synthetic_shift_qparams(dims, 28), cuda)
        xq_np = np.random.default_rng(28).integers(-127, 128, (32, 100_003)).astype(np.int8)
        kern = fq.fused_mlp_query_columnar_int8_shift
    xq = torch.as_tensor(xq_np, device=cuda)
    for a, b in zip(kern(weights, xq), kern(weights, _unaligned(xq))):
        assert torch.equal(a, b)


def test_int8_grid_is_the_resident_blocks(cuda):
    """K3's and K7b's grid is the blocks resident on the card at the bench
    MLP (at least two an SM), at most one a tile."""
    dims = (32, 128, 128, 16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for static in (False, True):
        xq = torch.zeros((32, 1 << 20), dtype=torch.int8, device=cuda)
        blocks, smem = fq.int8_grid(xq, dims, static)
        per_sm = fq.int8_resident_blocks(cuda, static, smem)
        assert smem == fq.int8_smem_bytes(dims) and 2 <= per_sm <= 8
        assert blocks == sms * per_sm
        assert fq.int8_grid(xq[:, :130].contiguous(), dims, static)[0] == 3


def test_k7b_refuses_an_input_too_wide_for_exact_f32(cuda):
    rng = np.random.default_rng(18)
    qparams = [(rng.integers(-127, 128, (8, 1041)).astype(np.int8),
                np.full((8, 1), 1e-3, np.float32), np.zeros((8, 1), np.float32))]
    weights = fq.qparams_static_from_numpy(qparams, cuda)
    with pytest.raises(ValueError, match="1040"):
        fq.fused_mlp_query_columnar_int8(weights, torch.zeros((1041, 64), dtype=torch.int8,
                                                               device=cuda))


def test_int8_engine_chain_on_the_card(cuda, tmp_path):
    """Engine int8 predict on the card runs the fused chain through
    torch._int_mm and equals the same chain on the CPU on the same scales."""
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.onnx.executor import compile_model_file

    path = str(tmp_path / "m.onnx")
    proto.save_model_file(builder.mlp_model(in_dim=32, hidden=(128, 128), out_dim=16), path)
    gpu = compile_model_file(path, "g", "int8", cuda)
    cpu = compile_model_file(path, "c", "int8", torch.device("cpu"))
    x = np.random.default_rng(19).standard_normal((5000, 32)).astype(np.float32)
    got = gpu.run(x)[0]
    assert got.is_cuda and len(gpu._int8_fused_cache) == 1
    cpu._int8_calibrated = True
    for a, b in zip(cpu.mlp_plan[2], gpu.mlp_plan[2]):
        a._infera_act_scale = b._infera_act_scale
    torch.testing.assert_close(got.cpu(), cpu.run(x)[0], rtol=1e-5, atol=1e-5)


def test_query_sums_are_the_same_from_run_to_run(cuda):
    weights = fq.params_from_numpy(_params((32, 128, 128, 16), seed=5), cuda)
    xc = _rows(200_000, 32, 6, cuda).T.contiguous()
    first = fq.fused_mlp_query_columnar(weights, xc)
    for _ in range(3):
        again = fq.fused_mlp_query_columnar(weights, xc)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


# --------------------------------------------------------------------------- K2 / K2'


def _sql_block(n, seed, cuda):
    """Rows of a table block: 0 an integer key in [0, 40), 1 normal values,
    2 normal values with NaN in every 997th row, 3 values in [-9, 9] with
    negatives for floor-mod, 4 halves (x.5) for round-half-to-even, 5
    positive values for sqrt and log."""
    rng = np.random.default_rng(seed)
    b = np.empty((6, n), np.float32)
    b[0] = rng.integers(0, 40, n)
    b[1] = rng.standard_normal(n)
    b[2] = rng.standard_normal(n)
    b[2, ::997] = np.nan
    b[3] = rng.uniform(-9, 9, n)
    b[4] = rng.integers(-6, 6, n) + 0.5
    b[5] = rng.uniform(0.1, 5, n)
    return torch.as_tensor(b, device=cuda)


def _c(consts, v):
    consts.append(float(np.float32(v)))
    return (fs.CONST, len(consts) - 1)


def _ops_plan(G=64):
    consts = []
    col = [(fs.COL, i) for i in range(6)]
    sums = [
        [col[3], _c(consts, 3.0), (fs.MOD, 0)],
        [col[3], _c(consts, -2.5), (fs.MOD, 0)],
        [col[4], (fs.ROUND, 0)],
        [col[1], col[5], (fs.DIV, 0)],
        [col[1], _c(consts, 2.0), (fs.MUL, 0), col[3], (fs.ADD, 0)],
        [col[1], _c(consts, -0.5), _c(consts, 0.5), (fs.BETWEEN, 0), (fs.NOT, 0)],
        [col[3], (fs.CAST_INT, 0), (fs.NEG, 0), (fs.CAST_FLOAT, 0)],
        [col[1], col[3], (fs.LE, 0), col[4], _c(consts, 0.0), (fs.NE, 0), (fs.AND, 0),
         col[1], col[3], (fs.EQ, 0), (fs.OR, 0)],
        [col[3], (fs.ABS, 0), (fs.FLOOR, 0), col[1], (fs.CEIL, 0), (fs.SUB, 0)],
        [col[5], (fs.SQRT, 0), col[1], col[3], (fs.GE, 0), (fs.ADD, 0), col[1], col[3],
         (fs.LT, 0), (fs.SUB, 0)],
    ]
    return fs.FusedPlan(where=[col[1], _c(consts, -1.0), (fs.GT, 0)], keys=[[col[0]]],
                        sums=sums, mins=[[col[2]], [col[3]]], maxs=[[col[2]], [col[5]]],
                        strides=[1], n_groups=G, consts=consts)


def _assert_k2_close(got, want, sum_rtol, mm_rtol=0.0):
    torch.testing.assert_close(got["count"], want["count"], rtol=0, atol=0)
    torch.testing.assert_close(got["flags"], want["flags"], rtol=0, atol=0)
    torch.testing.assert_close(got["sums"], want["sums"], rtol=sum_rtol, atol=1e-9)
    torch.testing.assert_close(got["mm"], want["mm"], rtol=mm_rtol, atol=mm_rtol,
                               equal_nan=True)


@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
def test_k2_programs_match_plain(cuda, n):
    """Every opcode but exp and log: each row's value is the same f32 on
    both sides (no FMA contraction, floor-mod, half-to-even round), so only
    the f64 summation order differs; min/max (NaN included) are exact."""
    packed = fs.pack_plan(_ops_plan(), cuda)
    xc = _sql_block(n, 7, cuda)
    before = fs.fused_sql.launches["f32"]
    got = fs.fused_sql(packed, xc, n)
    torch.cuda.synchronize()
    assert fs.fused_sql.launches["f32"] == before + 1
    _assert_k2_close(got, fs.fused_sql_plain(packed, xc, n), sum_rtol=1e-12)


def test_k2_exp_log_within_two_ulp(cuda):
    consts = []
    plan = fs.FusedPlan(where=None, keys=[[(fs.COL, 0)]],
                        sums=[[(fs.COL, 5), (fs.LOG, 0)], [(fs.COL, 1), (fs.EXP, 0)]],
                        mins=[[(fs.COL, 1), (fs.EXP, 0)]], maxs=[[(fs.COL, 5), (fs.LOG, 0)]],
                        strides=[1], n_groups=64, consts=consts)
    packed = fs.pack_plan(plan, cuda)
    xc = _sql_block(50_000, 8, cuda)
    # CUDA's expf/logf and torch's exp/log differ by up to 2 ulp
    _assert_k2_close(fs.fused_sql(packed, xc, 50_000), fs.fused_sql_plain(packed, xc, 50_000),
                     sum_rtol=1e-6, mm_rtol=5e-7)


def test_k2_key_guards(cuda):
    """A fractional key sets its flag bit; a key of magnitude >= 2**24 sets
    bit K; negative keys land in floor-mod buckets."""
    n = 4096
    xc = _sql_block(n, 9, cuda)
    xc[0, 5] = 3.5
    xc[0, 6] = -7.0
    xc[1, 7] = float(1 << 25)
    consts = []
    plan = fs.FusedPlan(where=None, keys=[[(fs.COL, 0)], [(fs.COL, 1), (fs.FLOOR, 0)]],
                        sums=[], mins=[], maxs=[], strides=[64, 1], n_groups=128,
                        consts=consts)
    packed = fs.pack_plan(plan, cuda)
    got = fs.fused_sql(packed, xc, n)
    want = fs.fused_sql_plain(packed, xc, n)
    assert int(got["flags"][0]) == 0b101
    _assert_k2_close(got, want, sum_rtol=0)


def _where(kind, consts, xc):
    """A WHERE of the MLP plans: ``half`` keeps about half the rows (column
    3 > 0), ``none`` no row, ``one`` the row of column 1's value at row n //
    2, ``all`` every row (column 5 > 0), ``pred`` reads the prediction (the
    MLP then runs on every row)."""
    if kind == "half":
        return [(fs.COL, 3), _c(consts, 0.0), (fs.GT, 0)]
    if kind == "none":
        return [(fs.COL, 3), _c(consts, 100.0), (fs.GT, 0)]
    if kind == "one":
        return [(fs.COL, 1), _c(consts, float(xc[1, xc.shape[1] // 2])), (fs.EQ, 0)]
    if kind == "all":
        return [(fs.COL, 5), _c(consts, 0.0), (fs.GT, 0)]
    return [(fs.PRED, 0), _c(consts, 0.0), (fs.GT, 0), (fs.COL, 3), _c(consts, 0.0), (fs.GT, 0),
            (fs.OR, 0)]


def _mlp_plan(dims, softmax, bf16, oc, seed, G=64, where="half", xc=None):
    """An MLP slot over the table's columns without NaN: even features bare
    columns (read straight from the block), odd ones an expression (run by
    the interpreter)."""
    params = _params(dims, seed)
    consts = []
    half = _c(consts, 0.5)
    feats = [[(fs.COL, (1, 3, 4, 5)[k % 4])] + ([half, (fs.MUL, 0)] if k % 2 else [])
             for k in range(dims[0])]
    slot = fs.MlpSlot(params=params, final_softmax=softmax, out_col=oc, bf16=bf16,
                      features=feats)
    return fs.FusedPlan(where=_where(where, consts, xc), keys=[[(fs.COL, 0)]],
                        sums=[[(fs.PRED, 0)]], mins=[[(fs.PRED, 0)]], maxs=[[(fs.PRED, 0)]],
                        strides=[1], n_groups=G, consts=consts, preds=[slot])


@pytest.mark.parametrize("where", ["half", "none", "one", "all", "pred"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("dims,softmax,oc,n", [((4, 32, 1), False, 0, 100_003),
                                               ((32, 128, 128, 16), True, 1, 70_001),
                                               ((5, 130, 3), False, 2, 1)])
def test_k2_mlp_slots_match_plain(cuda, dims, softmax, oc, n, bf16, where):
    """The MLP slots on the rows the WHERE keeps (none, one, about half,
    every row) or, where the WHERE reads the prediction, on every row: the
    same results as the plain version's dense pass; in f32 without a
    softmax each prediction is the plain version's bit for bit (minima and
    maxima exact)."""
    xc = _sql_block(n, 10, cuda)
    packed = fs.pack_plan(_mlp_plan(dims, softmax, bf16, oc, seed=n, where=where, xc=xc), cuda)
    assert int(packed.words[fs.H_KEPT]) == int(where != "pred")
    got = fs.fused_sql(packed, xc, n)
    want = fs.fused_sql_plain(packed, xc, n)
    if where == "one":
        assert int(got["count"].sum()) >= 1
    if not bf16 and not softmax:
        # the layers sum in the plain version's order: only the f64 sums of
        # the predictions differ, in their order
        _assert_k2_close(got, want, sum_rtol=1e-12, mm_rtol=0.0)
    elif not bf16:
        # expf differs from torch's exp in the last bits: the 1e-5 parity bound
        _assert_k2_close(got, want, sum_rtol=1e-5, mm_rtol=1e-5)
    else:
        # a bf16 rounding of a ReLU output can go the other way when the f32
        # sum before it differs in its last bit
        _assert_k2_close(got, want, sum_rtol=1e-3, mm_rtol=2e-2)


@pytest.mark.parametrize("where", ["half", "pred"])
def test_k2_f32_and_bf16_mlp_slots_in_one_plan(cuda, where):
    """One plan with an f32 slot and a bf16 slot: the f32 slot's
    predictions are the plain version's bit for bit, the bf16 slot's within
    the bf16 bounds."""
    n = 100_003
    xc = _sql_block(n, 12, cuda)
    consts = []
    f32 = fs.MlpSlot(params=_params((4, 32, 1), 5), final_softmax=False, out_col=0, bf16=False,
                     features=[[(fs.COL, k)] for k in (1, 3, 4, 5)])
    bf16 = fs.MlpSlot(params=_params((32, 128, 128, 16), 6), final_softmax=True, out_col=1,
                      bf16=True, features=[[(fs.COL, (1, 3, 4, 5)[k % 4])] for k in range(32)])
    plan = fs.FusedPlan(where=_where(where, consts, xc), keys=[[(fs.COL, 0)]],
                        sums=[[(fs.PRED, 0)], [(fs.PRED, 1)]], mins=[[(fs.PRED, 0)]],
                        maxs=[[(fs.PRED, 1)]], strides=[1], n_groups=64, consts=consts,
                        preds=[f32, bf16])
    packed = fs.pack_plan(plan, cuda)
    before = fs.fused_sql.launches["bf16"]
    got = fs.fused_sql(packed, xc, n)
    torch.cuda.synchronize()
    assert fs.fused_sql.launches["bf16"] == before + 1
    want = fs.fused_sql_plain(packed, xc, n)
    torch.testing.assert_close(got["count"], want["count"], rtol=0, atol=0)
    torch.testing.assert_close(got["sums"][0], want["sums"][0], rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(got["mm"][0], want["mm"][0], rtol=0, atol=0)
    torch.testing.assert_close(got["sums"][1], want["sums"][1], rtol=1e-3, atol=1e-9)
    torch.testing.assert_close(got["mm"][1], want["mm"][1], rtol=2e-2, atol=2e-2)


def test_k2_sums_are_the_same_from_run_to_run(cuda):
    packed = fs.pack_plan(_mlp_plan((32, 128, 128, 16), True, 1, False, seed=3), cuda)
    xc = _sql_block(300_000, 11, cuda)
    first = fs.fused_sql(packed, xc, 300_000)
    for _ in range(2):
        again = fs.fused_sql(packed, xc, 300_000)
        for k in first:
            assert torch.equal(first[k], again[k])


def test_k2_sql_flagship_on_the_card(cuda, monkeypatch, tmp_path):
    """Connection.execute runs the flagship through K2 on CUDA and answers
    as the host executor does."""
    import infera_tpu_torch as itt
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.registry import MODELS
    from infera_tpu_torch.sql import Connection

    monkeypatch.delenv("INFERA_PALLAS_SQL", raising=False)
    itt.set_device(cuda)
    MODELS.clear()
    try:
        proto.save_model_file(builder.mlp_model(in_dim=4, hidden=(32,), out_dim=1),
                              tmp_path / "m.onnx")
        itt.load_model("m", str(tmp_path / "m.onnx"))
        conn = Connection()
        conn.execute("create table big as select x % 64 as g, (x % 100)::float / 10.0 as f1, "
                     "((x + 3) % 50)::float / 5.0 as f2, ((x * 7) % 30)::float / 3.0 as f3, "
                     "((x * 11) % 90)::float / 9.0 as f4 from range(100003) r(x)")
        q = ("select g, count(*) c, avg(infera_predict('m', f1, f2, f3, f4)) p, sum(f1) s "
             "from big where f2 > 1.0 group by g order by g")
        before = fs.fused_sql.launches["f32"]
        rows = conn.execute(q).rows
        assert conn._exec_path == "device_plan_cuda"
        # the group-key probe, then the plan
        assert fs.fused_sql.launches["f32"] == before + 2
        monkeypatch.setenv("INFERA_PALLAS_SQL", "0")
        host = conn.execute(q).rows
        assert conn._exec_path == "host"
        assert len(rows) == len(host) == 64
        for a, b in zip(rows, host):
            assert a[:2] == b[:2]
            np.testing.assert_allclose(a[2:], b[2:], rtol=1e-6)
    finally:
        MODELS.clear()
        itt.set_device(None)


# --------------------------------------------------------------------------- K4


def _shuffled_tree_model(model, seed, mode="BRANCH_LEQ"):
    """The builder's heap-layout forest with node ids permuted per tree (the
    root stays 0), so children are no longer 2i+1 / 2i+2, and every branch
    in ``mode``."""
    from infera_tpu_torch.onnx.proto import Attribute

    node = model.graph.nodes[0]
    a = {k: v.value for k, v in node.attributes.items()}
    rng = np.random.default_rng(seed)
    n_nodes = max(a["nodes_nodeids"]) + 1
    perm = {t: np.concatenate([[0], 1 + rng.permutation(n_nodes - 1)])
            for t in set(a["nodes_treeids"])}
    trees = a["nodes_treeids"]
    new = {
        "nodes_nodeids": [int(perm[t][i]) for t, i in zip(trees, a["nodes_nodeids"])],
        "nodes_truenodeids": [int(perm[t][i]) for t, i in zip(trees, a["nodes_truenodeids"])],
        "nodes_falsenodeids": [int(perm[t][i]) for t, i in zip(trees, a["nodes_falsenodeids"])],
        "nodes_modes": [m if m == "LEAF" else mode for m in a["nodes_modes"]],
    }
    wkey = "target" if "target_nodeids" in a else "class"
    new[f"{wkey}_nodeids"] = [int(perm[t][i]) for t, i in
                              zip(a[f"{wkey}_treeids"], a[f"{wkey}_nodeids"])]
    for k, v in new.items():
        node.attributes[k] = Attribute.make(k, v)
    return model


def _forest_slot(kind, d_in, seed):
    """A forest slot as the planner builds it, reading feature k from block
    row (1, 2, 3, 4, 5)[k % 5]: row 2 holds NaN in every 997th row."""
    from infera_tpu_torch.onnx import builder, ml_ops

    if kind.startswith("clf"):
        # clf2: one score column, expanded to (-s, s) over two labels; clf6:
        # six classes, past the class sums K4 keeps in registers
        labels = {"clf2": [5], "clf6": [2, 3, 5, 7, 11, 13]}.get(kind, [7, 19, 42])
        model = builder.gbt_classifier_model(n_features=d_in, n_trees=16, depth=5,
                                             n_classes=len(labels), labels=labels, seed=seed)
    else:
        # reg61: 61 trees, no multiple of the trees a thread walks at once
        model = builder.gbt_regressor_model(n_features=d_in, n_trees=61 if kind == "reg61" else 24,
                                            depth=6, seed=seed)
    if kind in ("reg_shuffled_lt", "clf_shuffled"):
        model = _shuffled_tree_model(model, seed, "BRANCH_LT" if kind.startswith("reg") else
                                     "BRANCH_LEQ")
    node = model.graph.nodes[0]
    clf = kind.startswith("clf")
    n_out = len(node.attr("classlabels_int64s")) if clf else 1
    packed = ml_ops._PackedTrees(node, n_out, "class" if clf else "target")
    tables = packed.kernel_forest(d_in)
    assert tables is not None
    assert packed.heap_layout == (kind not in ("reg_shuffled_lt", "clf_shuffled"))
    feats = [[(fs.COL, (1, 2, 3, 4, 5)[k % 5])] for k in range(d_in)]
    slot = fs.ForestSlot(node=tables["node"], weights=packed.weights,
                         max_depth=tables["max_depth"], strict=tables["strict"], features=feats,
                         bias=0.5 if kind == "reg" else 0.0, logistic=kind == "reg_logistic")
    if clf:
        slot.classifier = True
        slot.binary = kind == "clf2"
        slot.labels = np.asarray([5, 11] if slot.binary else node.attr("classlabels_int64s"),
                                 np.float32)
        slot.class_bias = np.linspace(-0.1, 0.1, n_out).astype(np.float32)
    return slot


def _forest_plan(slot, G=64):
    consts = []
    return fs.FusedPlan(where=[(fs.COL, 3), _c(consts, -4.0), (fs.GT, 0)], keys=[[(fs.COL, 0)]],
                        sums=[[(fs.PRED, 0)]], mins=[[(fs.PRED, 0)]], maxs=[[(fs.PRED, 0)]],
                        strides=[1], n_groups=G, consts=consts, preds=[slot])


FOREST_KINDS = ["reg", "reg_logistic", "reg_shuffled_lt", "reg61", "clf", "clf_shuffled", "clf2",
                "clf6"]
# where K4 reads a forest (fused_sql.forest_routes): the records (and leaf
# weights) in shared memory as the plan places them, in device memory, or
# in device memory without the feature tile (each node's program)
FOREST_ROUTES = ["shared", "device", "programs"]


def _route(packed, route):
    """The packed plan with its forest read from ``route``: the kernel takes
    the placement from the plan's words, so clearing a descriptor's
    shared-memory offsets (or the feature tile's) moves the walk to device
    memory (or the interpreted path). A plan past two blocks' share of an
    SM keeps its records in device memory; for the shared route it is
    packed again with one block's 227 KB as their budget."""
    words = packed.words
    d = int(words[fs.H_PREDS])
    if route == "shared" and int(words[d + fs.F_REC_SMEM]) < 0:
        two_blocks, fs.TWO_BLOCK_SMEM = fs.TWO_BLOCK_SMEM, fs.SMEM_LIMIT
        try:
            packed = fs.pack_plan(packed.plan, words.device)
        finally:
            fs.TWO_BLOCK_SMEM = two_blocks
        words = packed.words
    if route == "shared":
        assert int(words[d + fs.F_REC_SMEM]) >= 0
    if route in ("device", "programs"):
        words[d + fs.F_REC_SMEM] = words[d + fs.F_W_SMEM] = -1
    if route == "programs":
        words[fs.H_FTILE] = -1
    return packed


@pytest.mark.parametrize("route", FOREST_ROUTES)
@pytest.mark.parametrize("kind", FOREST_KINDS)
def test_k4_forest_matches_plain(cuda, kind, route):
    """Each row's prediction is the plain version's bit for bit (leaf weights
    added in the same tree order; a row with NaN in one feature sees NaN at
    the nodes of the others), but for logistic, whose exp differs from
    torch's by an ulp or two. So counts, flags, min and max are exact and
    the f64 sums differ only in their order; on every route."""
    n = 1_000_003
    packed = _route(fs.pack_plan(_forest_plan(_forest_slot(kind, 7, seed=21)), cuda), route)
    xc = _sql_block(n, 12, cuda)
    before = dict(fs.fused_sql.launches)
    got = fs.fused_sql(packed, xc, n)
    torch.cuda.synchronize()
    assert fs.fused_sql.launches["forest"] == before["forest"] + 1
    assert fs.fused_sql.launches["f32"] == before["f32"] + 1
    want = fs.fused_sql_plain(packed, xc, n)
    if kind == "reg_logistic":
        _assert_k2_close(got, want, sum_rtol=1e-6, mm_rtol=5e-7)
    else:
        _assert_k2_close(got, want, sum_rtol=1e-12)


@pytest.mark.parametrize("route", FOREST_ROUTES)
@pytest.mark.parametrize("kind", ["reg_shuffled_lt", "reg61", "clf6", "clf2"])
def test_k4_predictions_equal_plain_bit_for_bit(cuda, kind, route):
    """The forest's per-row values through a plan whose min and max keep
    every row: one group per row of a 4096-row block."""
    n = 4096
    slot = _forest_slot(kind, 7, seed=5)
    xc = _sql_block(n, 13, cuda)
    xc[0] = torch.arange(n, device=cuda, dtype=torch.float32)
    plan = fs.FusedPlan(where=None, keys=[[(fs.COL, 0)]], sums=[], mins=[[(fs.PRED, 0)]],
                        maxs=[], strides=[1], n_groups=n, consts=[], preds=[slot])
    packed = _route(fs.pack_plan(plan, cuda), route)
    got = fs.fused_sql(packed, xc, n)["mm"][0]
    want = fs.forest_plain(slot, packed.slots[0], xc[[1, 2, 3, 4, 5, 1, 2]])
    assert torch.equal(got, want)


@pytest.mark.parametrize("route", ["shared", "device"])
def test_k4_sums_are_the_same_from_run_to_run(cuda, route):
    for kind in ("reg", "clf6"):
        packed = _route(fs.pack_plan(_forest_plan(_forest_slot(kind, 16, seed=2)), cuda), route)
        xc = _sql_block(1_000_003, 14, cuda)
        first = fs.fused_sql(packed, xc, 1_000_003)
        for _ in range(2):
            again = fs.fused_sql(packed, xc, 1_000_003)
            for k in first:
                assert torch.equal(first[k], again[k])


def test_k4_tree_plan_raises_without_its_library(cuda, monkeypatch, tmp_path):
    """A tree plan on a CUDA table launches K4 or raises: a library that
    cannot load is an error, never a quiet run of the plain version."""
    import infera_tpu_torch as itt
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.ops import _kernels
    from infera_tpu_torch.registry import MODELS
    from infera_tpu_torch.sql import Connection

    def no_library(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran on the card")

    packed = fs.pack_plan(_forest_plan(_forest_slot("clf", 7, seed=1)), cuda)
    xc = _sql_block(10_000, 15, cuda)
    monkeypatch.setattr(_kernels, "load", no_library)
    monkeypatch.setattr(fs, "fused_sql_plain", no_plain)
    monkeypatch.setattr(fs, "forest_plain", no_plain)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fs.fused_sql(packed, xc, 10_000)
    monkeypatch.delenv("INFERA_PALLAS_SQL", raising=False)
    itt.set_device(cuda)
    MODELS.clear()
    try:
        proto.save_model_file(builder.gbt_regressor_model(n_features=4, n_trees=8, depth=4),
                              tmp_path / "gbt.onnx")
        itt.load_model("gbt", str(tmp_path / "gbt.onnx"))
        conn = Connection()
        conn.execute("create table t as select x % 8 as g, (x % 100)::float / 10.0 as f1, "
                     "(x % 7)::float as f2, (x % 13)::float as f3, (x % 3)::float as f4 "
                     "from range(50000) r(x)")
        with pytest.raises(RuntimeError, match="nvcc failed"):
            conn.execute("select g, avg(infera_predict('gbt', f1, f2, f3, f4)) from t group by g")
    finally:
        MODELS.clear()
        itt.set_device(None)


@pytest.mark.parametrize("model", ["gbt", "gbc"])
def test_k4_sql_tree_query_on_the_card(cuda, monkeypatch, tmp_path, model):
    """Connection.execute runs a tree query through K2+K4 on CUDA and answers
    as the host executor does: keys and counts exact, predictions to 1e-5
    (the host's GEMM forest adds the leaves in another order), labels exact."""
    import infera_tpu_torch as itt
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.registry import MODELS
    from infera_tpu_torch.sql import Connection

    monkeypatch.delenv("INFERA_PALLAS_SQL", raising=False)
    itt.set_device(cuda)
    MODELS.clear()
    try:
        m = (builder.gbt_regressor_model(n_features=4, n_trees=12, depth=4, seed=7)
             if model == "gbt" else
             builder.gbt_classifier_model(n_features=4, n_trees=8, depth=3, n_classes=3,
                                          labels=[7, 19, 42], seed=3))
        proto.save_model_file(m, tmp_path / "m.onnx")
        itt.load_model(model, str(tmp_path / "m.onnx"))
        conn = Connection()
        conn.execute("create table big as select x % 64 as g, (x % 100)::float / 10.0 as f1, "
                     "((x + 3) % 50)::float / 5.0 as f2, ((x * 7) % 30)::float / 3.0 as f3, "
                     "((x * 11) % 90)::float / 9.0 as f4 from range(100003) r(x)")
        p = f"infera_predict('{model}', f1, f2, f3, f4)"
        q = f"select g, count(*) c, avg({p}), min({p}), max({p}) from big group by g order by g"
        before = fs.fused_sql.launches["forest"]
        rows = conn.execute(q).rows
        assert conn._exec_path == "device_plan_cuda"
        assert fs.fused_sql.launches["forest"] == before + 1
        monkeypatch.setenv("INFERA_PALLAS_SQL", "0")
        host = conn.execute(q).rows
        assert conn._exec_path == "host"
        assert len(rows) == len(host) == 64
        for a, b in zip(rows, host):
            assert a[:2] == b[:2]
            if model == "gbc":
                assert a == b
            else:
                np.testing.assert_allclose(a[2:], b[2:], rtol=1e-5)
    finally:
        MODELS.clear()
        itt.set_device(None)


# --------------------------------------------------------------------------- K5


def _join_inputs(n, kind, seed, cuda):
    """(table block, dim block [3, n_dim], lookup) of a fact→dim join. The
    fact key is block row 6. ``permuted``: a 1:1 permuted key over n dim
    rows. ``holes``: 5,000 dim keys drawn from [0, 8000), fact keys in
    [-50, 9000): negative keys, keys past the largest dim key and keys with
    no dim row; there dim row 0 holds NaN in column 1 and no fact row has its
    key, so only unmatched rows, which read dim row 0, meet that NaN."""
    rng = np.random.default_rng(seed)
    if kind == "permuted":
        n_dim = n
        dkeys = rng.permutation(n_dim)
        fk = rng.permutation(n).astype(np.float32)
    else:
        n_dim = 5000
        dkeys = rng.choice(8000, n_dim, replace=False)
        fk = rng.integers(-50, 9000, n)
        fk[fk == dkeys[0]] = -7
        fk = fk.astype(np.float32)
    lookup = np.full(int(dkeys.max()) + 1, -1, np.int32)
    lookup[dkeys] = np.arange(n_dim, dtype=np.int32)
    dim = np.empty((3, n_dim), np.float32)
    dim[0] = rng.standard_normal(n_dim)
    dim[1] = rng.standard_normal(n_dim)
    if kind == "holes":
        dim[1, 0] = np.nan
    dim[2] = rng.integers(0, 40, n_dim)
    xc = torch.cat([_sql_block(n, seed, cuda), torch.as_tensor(fk, device=cuda)[None]])
    return xc, torch.as_tensor(dim, device=cuda), lookup


def _join_plan(shape, lookup, n_dim, G=64, bf16=False):
    consts = []
    col = [(fs.COL, i) for i in range(7)]
    dim = [(fs.DIM, i) for i in range(3)]
    m = (fs.MATCHED, 0)
    sel = (fs.SEL, 0)
    spec = fs.JoinSpec(fact_key=6, kmax=len(lookup) - 1, n_dim=n_dim, n_cols=3)
    if shape == "inner":
        return fs.FusedPlan(
            where=[m, col[1], _c(consts, -1.0), (fs.GT, 0), (fs.AND, 0)], keys=[[dim[2]]],
            sums=[[dim[0]], [col[1], dim[0], (fs.MUL, 0)], [dim[1], (fs.ABS, 0)]],
            mins=[[dim[1]]], maxs=[[dim[0]], [col[3]]], strides=[1], n_groups=G,
            consts=consts, join=spec)
    if shape == "outer":
        return fs.FusedPlan(
            where=None, keys=[[col[0]]],
            sums=[[m], [m, dim[1], _c(consts, 0.0), sel], [col[1]],
                  [m, dim[0], col[3], sel]],
            mins=[[m, dim[1], _c(consts, np.inf), sel]],
            maxs=[[m, dim[0], _c(consts, -np.inf), sel]], strides=[1], n_groups=G,
            consts=consts, join=spec)
    # an MLP slot whose features read dim columns (K2' inside K5)
    slot = fs.MlpSlot(params=_params((4, 32, 1), seed=9), final_softmax=False, out_col=0,
                      bf16=bf16, features=[[dim[0]], [col[1]], [dim[2]], [col[3]]])
    return fs.FusedPlan(where=[m], keys=[[col[0]]], sums=[[(fs.PRED, 0)]],
                        mins=[[(fs.PRED, 0)]], maxs=[[(fs.PRED, 0)]], strides=[1], n_groups=G,
                        consts=consts, preds=[slot], join=spec)


@pytest.mark.parametrize("shape", ["inner", "outer", "mlp"])
@pytest.mark.parametrize("kind,n", [("permuted", 1_000_003), ("holes", 1_000_003),
                                    ("holes", 257), ("permuted", 1)])
def test_k5_join_matches_plain(cuda, kind, n, shape):
    """Each row's dim row, match and dim values are the plain version's bit
    for bit, and so is every program over them (the MLP's layers sum in the
    kernel's order): counts, flags, minima and maxima (NaN included) are
    exact and the f64 sums differ only in their order. The NaN that
    unmatched rows read never reaches an outer join's selected sums."""
    xc, dim, lookup = _join_inputs(n, kind, seed=n % 97, cuda=cuda)
    packed = fs.pack_plan(_join_plan(shape, lookup, dim.shape[1]), cuda, lookup)
    before = dict(fs.fused_sql.launches)
    got = fs.fused_sql(packed, xc, n, dim)
    torch.cuda.synchronize()
    assert fs.fused_sql.launches["join"] == before["join"] + 1
    assert fs.fused_sql.launches["f32"] == before["f32"] + 1
    want = fs.fused_sql_plain(packed, xc, n, dim)
    _assert_k2_close(got, want, sum_rtol=1e-12)
    if shape == "outer":
        assert bool(torch.isfinite(got["sums"]).all())
        assert int(got["count"].sum()) == n
        if kind == "holes" and n > 1:
            assert 0 < float(got["sums"][0].sum()) < n   # some rows matched, some not


@pytest.mark.parametrize("kind,n", [("holes", 1_000_003), ("permuted", 257)])
def test_k5_bf16_mlp_over_dim_columns_matches_plain(cuda, kind, n):
    """K2' in bf16 inside K5: the MLP's features read dim columns, on the
    rows the WHERE (the match) keeps, its layers on the tensor cores; within
    the bf16 bounds of the plain version."""
    xc, dim, lookup = _join_inputs(n, kind, seed=n % 89, cuda=cuda)
    packed = fs.pack_plan(_join_plan("mlp", lookup, dim.shape[1], bf16=True), cuda, lookup)
    assert int(packed.words[fs.H_KEPT]) == 1
    got = fs.fused_sql(packed, xc, n, dim)
    want = fs.fused_sql_plain(packed, xc, n, dim)
    _assert_k2_close(got, want, sum_rtol=1e-3, mm_rtol=2e-2)


def test_k5_join_plan_raises_without_its_library(cuda, monkeypatch):
    """A join plan on a CUDA table launches K5 or raises: a library that
    cannot load reaches Connection.execute, and the plain version never runs
    on the card."""
    import infera_tpu_torch as itt
    from infera_tpu_torch.ops import _kernels
    from infera_tpu_torch.sql import Connection

    def no_library(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran on the card")

    xc, dim, lookup = _join_inputs(10_000, "holes", seed=3, cuda=cuda)
    packed = fs.pack_plan(_join_plan("outer", lookup, dim.shape[1]), cuda, lookup)
    monkeypatch.setattr(_kernels, "load", no_library)
    monkeypatch.setattr(fs, "fused_sql_plain", no_plain)
    monkeypatch.setattr(fs, "join_plain", no_plain)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fs.fused_sql(packed, xc, 10_000, dim)
    monkeypatch.delenv("INFERA_PALLAS_SQL", raising=False)
    itt.set_device(cuda)
    try:
        conn = Connection()
        conn.execute("create table f as select x % 1100 as k, (x % 40)::float / 4.0 as v "
                     "from range(50000) r(x)")
        conn.execute("create table d as select x as k, (x * 2)::float as w from range(1000) r(x)")
        with pytest.raises(RuntimeError, match="nvcc failed"):
            conn.execute("select count(*), count(w), sum(v), sum(coalesce(w, 0.0)) "
                         "from f left join d on f.k = d.k")
    finally:
        itt.set_device(None)


JOIN_QUERIES = [
    "select count(*), count(w), sum(v), sum(coalesce(w, 0.0)) from f left join d on f.k = d.k",
    "select count(*), count(w), sum(v), sum(coalesce(w, 0.0)) from f full join d on f.k = d.k",
    "select og, count(*), sum(w), min(w), max(v) from f left join d on f.k = d.k "
    "group by og order by og",
    "select cat, count(*), avg(v * w), max(w) from f join d on f.k = d.k where v > 2.0 "
    "group by cat order by cat",
]


@pytest.mark.parametrize("q", JOIN_QUERIES)
def test_k5_sql_join_on_the_card(cuda, monkeypatch, q):
    """Connection.execute runs a fact→dim join through one launch of K5 and
    answers as the host executor does, whose join is the device sort-join:
    keys, counts, minima and maxima exact, sums to 1e-6."""
    import infera_tpu_torch as itt
    from infera_tpu_torch.sql import Connection

    monkeypatch.delenv("INFERA_PALLAS_SQL", raising=False)
    itt.set_device(cuda)
    try:
        conn = Connection()
        conn.execute("create table f as select x % 1100 as k, (x % 40)::float / 4.0 as v, "
                     "x % 6 as og from range(100003) r(x)")
        conn.execute("create table d as select x as k, (x * 2)::float as w, x % 5 as cat "
                     "from range(1200) r(x) where x % 7 <> 3")
        before = fs.fused_sql.launches["join"]
        rows = conn.execute(q).rows
        assert conn._exec_path == "device_join_plan_cuda"
        assert fs.fused_sql.launches["join"] == before + 1
        monkeypatch.setenv("INFERA_PALLAS_SQL", "0")
        host = conn.execute(q).rows
        assert conn._exec_path == "device_join"
        assert len(rows) == len(host)
        for a, b in zip(rows, host):
            for x, y in zip(a, b):
                if isinstance(y, float) and not float(y).is_integer():
                    assert x == pytest.approx(y, rel=1e-6)
                else:
                    assert x == y
    finally:
        itt.set_device(None)


# --------------------------------------------------------------------------- K2 b-e


def _tail_inputs(n, seed, cuda):
    """The f32 block of _sql_block and an int64 block: 0 values near
    +-2**50, 1 values across int64's range (sums of them wrap modulo
    2**64 on both sides), 2 a small-integer column."""
    xc = _sql_block(n, seed, cuda)
    rng = np.random.default_rng(seed)
    xi = np.empty((3, n), np.int64)
    xi[0] = rng.integers(-(1 << 50), 1 << 50, n)
    xi[1] = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n, endpoint=True)
    xi[2] = rng.integers(-9, 9, n)
    return xc, torch.as_tensor(xi, device=cuda)


def _tail_plan(G=64, bad_values=False, nan_order=False):
    """Every tail slot: var, count_if, product (with LOG2) and bool_and/or on
    the core slots, int sum/min/max, a DISTINCT and a MODE slot, and
    arg_min/arg_max over ties (halves) and over distinct values."""
    consts = []
    zero = _c(consts, 0.0)
    v = [(fs.COL, 3)]
    centred = v + [_c(consts, 0.25), (fs.SUB, 0)]
    sums = [centred, centred + centred + [(fs.MUL, 0)], v + [zero, (fs.NE, 0)],
            v + [zero, (fs.LT, 0)], v + [zero, (fs.EQ, 0)],
            v + [zero, (fs.NE, 0)] + v + [(fs.ABS, 0), (fs.LOG2, 0), zero, (fs.SEL, 0)]]
    dist_col = [(fs.COL, 3)] if bad_values else [(fs.COL, 0), _c(consts, 7.0), (fs.MOD, 0)]
    order = [(fs.COL, 2)] if nan_order else [(fs.COL, 1)]
    return fs.FusedPlan(
        where=[(fs.COL, 5), _c(consts, 0.3), (fs.GT, 0)], keys=[[(fs.COL, 0)]], sums=sums,
        mins=[v + [zero, (fs.NE, 0)]], maxs=[[(fs.COL, 1), _c(consts, 2.0), (fs.GT, 0)]],
        strides=[1], n_groups=G, consts=consts,
        ints=[(0, "sum"), (1, "min"), (1, "max"), (2, "sum"), (0, "max")],
        dists=[(dist_col, 8, "dist"), ([(fs.COL, 0)], 64, "mode")],
        args=[([(fs.COL, 4)], True), ([(fs.COL, 4)], False), (order, True), (order, False)])


def _assert_tail_equal(got, want):
    """Integers exact (counts, int slots, arg words, DISTINCT counts,
    flags); min/max rows exact; the f64 sums to 1e-12 (only their order
    differs), but the log2 row to 1e-6: CUDA's log2f and torch's log2 may
    differ in the last bit of a value."""
    for k in ("count", "flags", "ints", "args", "dist", "mm"):
        assert torch.equal(got[k], want[k]), k
    torch.testing.assert_close(got["sums"][:5], want["sums"][:5], rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(got["sums"][5:], want["sums"][5:], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got["iest"], want["iest"], rtol=1e-12, atol=0)


@pytest.mark.parametrize("n", [1, 257, 1_000_003, 1_048_576])
def test_k2_tail_matches_plain(cuda, n):
    xc, xi = _tail_inputs(n, seed=n % 89, cuda=cuda)
    packed = fs.pack_plan(_tail_plan(), cuda)
    before = dict(fs.fused_sql.launches)
    got = fs.fused_sql(packed, xc, n, int_xc=xi)
    torch.cuda.synchronize()
    for key in ("f32", "int_sum", "distinct", "arg", "int_minmax"):
        assert fs.fused_sql.launches[key] == before[key] + 1, key
    want = fs.fused_sql_plain(packed, xc, n, int_xc=xi)
    _assert_tail_equal(got, want)
    assert int(got["flags"][0]) == 0


# flag bits with one key: K + 1 + d for DISTINCT/MODE slot d, K + 1 + D + a
# for arg slot a (the last two arg slots read the NaN column)
@pytest.mark.parametrize("bad_values,nan_order,flags", [(True, False, 1 << 2),
                                                        (False, True, 1 << 6 | 1 << 7)])
def test_k2_tail_flags(cuda, bad_values, nan_order, flags):
    """A DISTINCT value outside its domain and a selected NaN order value set
    their slot's flag bit, as in the plain version."""
    n = 100_003
    xc, xi = _tail_inputs(n, seed=4, cuda=cuda)
    packed = fs.pack_plan(_tail_plan(bad_values=bad_values, nan_order=nan_order), cuda)
    got = fs.fused_sql(packed, xc, n, int_xc=xi)
    _assert_tail_equal(got, fs.fused_sql_plain(packed, xc, n, int_xc=xi))
    assert int(got["flags"][0]) == flags


def test_k2_tail_is_the_same_from_run_to_run(cuda):
    n = 1_048_576
    xc, xi = _tail_inputs(n, seed=5, cuda=cuda)
    packed = fs.pack_plan(_tail_plan(G=512), cuda)
    first = fs.fused_sql(packed, xc, n, int_xc=xi)
    for _ in range(2):
        again = fs.fused_sql(packed, xc, n, int_xc=xi)
        for k in first:
            assert torch.equal(first[k], again[k]), k


def test_k2_group_key_probe_is_a_launch(cuda, monkeypatch, tmp_path):
    """A GROUP BY over a prediction sizes its key through K2 on the card:
    the plain version never runs there."""
    import infera_tpu_torch as itt
    from infera_tpu_torch.onnx import builder, proto
    from infera_tpu_torch.registry import MODELS
    from infera_tpu_torch.sql import Connection

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.delenv("INFERA_PALLAS_SQL", raising=False)
    itt.set_device(cuda)
    MODELS.clear()
    try:
        proto.save_model_file(builder.mlp_model(in_dim=2, hidden=(8,), out_dim=1, softmax=False),
                              tmp_path / "m.onnx")
        itt.load_model("m", str(tmp_path / "m.onnx"))
        conn = Connection()
        conn.execute("create table t as select (x % 10)::float as a, (x % 7)::float as b "
                     "from range(100003) r(x)")
        q = ("select round(abs(infera_predict('m', a, b))) k, count(*) from t "
             "group by round(abs(infera_predict('m', a, b))) order by k")
        with monkeypatch.context() as m:
            m.setattr(fs, "predictions_plain", no_plain)
            m.setattr(fs, "fused_sql_plain", no_plain)
            before = fs.fused_sql.launches["f32"]
            rows = conn.execute(q).rows
            assert conn._exec_path == "device_plan_cuda"
            assert fs.fused_sql.launches["f32"] == before + 2   # the probe, then the plan
        monkeypatch.setenv("INFERA_PALLAS_SQL", "0")
        assert rows == conn.execute(q).rows
    finally:
        MODELS.clear()
        itt.set_device(None)


TAIL_TABLE = ("create table tail as select x % 64 as g, x % 5 as h, x as id, x % 500 as k500, "
              "((x % 12) * (x % 5)) % 9 as mv, "
              "(case when x % 3 = 0 then -1 else 1 end) * (17592186044421 + x * 7) as v, "
              "((x * 13) % 97)::float as o, (x % 100)::float / 10.0 as f1, "
              "((x + 3) % 50)::float / 5.0 as f2, ((x * 7) % 30)::float / 3.0 as f3 "
              "from range(100003) r(x)")
TAIL_QUERIES = [
    "select g, stddev(f1), var_pop(f2), count_if(f1 > 4.0), bool_and(f1 >= 0.0), "
    "bool_or(f2 > 9.0), product(1.0 + f3 / 1000.0), avg(h) from tail group by g order by g",
    "select g, count(distinct h), sum(distinct k500), avg(distinct k500), mode(mv), count(*) "
    "from tail group by g order by g",
    "select g, arg_max(id, o), arg_min(id, o), arg_max(id, h) from tail group by g order by g",
    "select g, sum(v), avg(v), min(v), max(v) from tail where f1 > 1.0 group by g order by g",
]


@pytest.mark.parametrize("q", TAIL_QUERIES)
def test_k2_tail_sql_on_the_card(cuda, monkeypatch, q):
    """Connection.execute runs each family of the tail as one K2 launch (once
    its probes are cached) and answers as the host executor does: integers,
    DISTINCT values, modes and arg values exact, the rest to 1e-3 (the
    tolerance of the reference's tail tests)."""
    import infera_tpu_torch as itt
    from infera_tpu_torch.sql import Connection

    monkeypatch.delenv("INFERA_PALLAS_SQL", raising=False)
    itt.set_device(cuda)
    try:
        conn = Connection()
        conn.execute(TAIL_TABLE)
        conn.execute(q)
        before = fs.fused_sql.launches["f32"]
        rows = conn.execute(q).rows
        assert conn._exec_path == "device_plan_cuda"
        assert fs.fused_sql.launches["f32"] == before + 1
        monkeypatch.setenv("INFERA_PALLAS_SQL", "0")
        host = conn.execute(q).rows
        assert conn._exec_path == "host"
        assert len(rows) == len(host) == 64
        for a, b in zip(rows, host):
            for x, y in zip(a, b):
                if isinstance(y, float):
                    assert x == pytest.approx(y, rel=1e-3)
                else:
                    assert x == y
    finally:
        itt.set_device(None)


# --------------------------------------------------------------------------- K8a, K8b


@pytest.mark.parametrize("n,d0", [(1, 32), (63, 32), (4099, 30), (1_000_003, 32)])
def test_k8a_matches_plain(cuda, n, d0):
    x = _rows(n, d0, 21, cuda).to(torch.bfloat16)
    before = pq.empty_grid_scan.launches
    got = pq.empty_grid_scan(x)
    torch.cuda.synchronize()
    assert pq.empty_grid_scan.launches == before + 1
    # f32 tile sums on both sides, in another order
    err = (got - pq.empty_grid_scan_plain(x)).abs()
    assert bool((err <= 1e-6 * x.float().abs().sum(0)).all()), float(err.max())
    assert torch.equal(got, pq.empty_grid_scan(x))    # no atomics: the same bits again


@pytest.mark.parametrize("variant", pq.VARIANTS)
@pytest.mark.parametrize("dims,n", [((32, 128, 128, 16), 1_000_003), ((30, 64, 48, 10), 4161),
                                    ((32, 128, 128, 16), 65)])
def test_k8b_matches_plain(cuda, variant, dims, n):
    weights = pq.stage_weights(_params(dims, seed=23), cuda)
    x = _rows(n, dims[0], 24, cuda).to(torch.bfloat16)
    before = pq.query_stage.launches[variant]
    got = pq.query_stage(weights, x, variant)
    torch.cuda.synchronize()
    assert pq.query_stage.launches[variant] == before + 1
    want = pq.query_stage_plain(weights, x, variant)
    if variant in ("scan", "mm1", "mm_all"):
        # f32 sums in another order: the plain version's matmul, the tiles
        if variant == "scan":
            c, tol = dims[0], 1e-6 * x.float().abs().sum(0)
        else:
            h = fq.mlp_scores_plain(weights.first if variant == "mm1" else weights.full, x.T)
            c, tol = h.shape[0], 1e-4 * h.abs().double().sum(1).float()
        assert bool(((got[:c] - want[:c]).abs() <= tol).all())
        assert not bool(got[c:].any())
    else:
        # the layers accumulate in the tensor core's order, so a bf16
        # rounding of a ReLU output can go the other way: K7a bf16's bounds
        c = dims[-1]
        assert float((got[:c] - want[:c]).abs().sum()) <= max(1, n // 500)
        torch.testing.assert_close(got[c:2 * c], want[c:2 * c], rtol=2e-2, atol=1e-3)
        assert not bool(got[2 * c:].any())


def test_k8a_equals_k8b_scan(cuda):
    x = _rows(100_003, 32, 25, cuda).to(torch.bfloat16)
    scan = pq.query_stage(pq.stage_weights(pq._params(), cuda), x, "scan")
    assert torch.equal(scan[:32], pq.empty_grid_scan(x))


@pytest.mark.parametrize("n", [4096, 1_000_003])
def test_k8b_full_equals_k7a_bf16(cuda, n):
    """The full stage runs K7a's load, layers, tail and fold on K7a's grid:
    its counts are K7a bf16's and its sums K7a's bits."""
    weights = pq.stage_weights(pq._params(), cuda)
    x = _rows(n, 32, 26, cuda).to(torch.bfloat16)
    full = pq.query_stage(weights, x, "full")
    counts, sums = fq.fused_mlp_query(weights.full, x)
    assert torch.equal(full[:16].long(), counts)
    assert torch.equal(full[16:32], sums)


def test_k8_refuses_what_it_does_not_take(cuda):
    weights = pq.stage_weights(pq._params(), cuda)
    x = _rows(100, 32, 27, cuda)
    with pytest.raises(ValueError):
        pq.empty_grid_scan(x)                              # f32, not bf16
    with pytest.raises(ValueError):
        pq.query_stage(weights, x.to(torch.bfloat16)[:, :31].contiguous(), "full")
    with pytest.raises(ValueError):
        pq.query_stage(weights, x.to(torch.bfloat16), "argmax")


# --------------------------------------------------------------------------- K2's tile reduction

# the group key of each row: one group; 512 groups at random; a whole tile
# in one group; every lane of a warp (every row of a tile) in its own group;
# three groups of 512, the rest empty
RED_KEYS = {"one": 1, "g512": 512, "tile": 8, "lane": 256, "sparse": 512}


def _red_inputs(kind, n, seed, cuda):
    xc, xi = _tail_inputs(n, seed, cuda)
    r = np.arange(n)
    rng = np.random.default_rng(seed)
    key = {"one": np.zeros(n), "g512": rng.integers(0, 512, n), "tile": (r // 256) % 7,
           "lane": r % 256, "sparse": rng.integers(0, 3, n) * 97}[kind]
    xc[0] = torch.as_tensor(key.astype(np.float32), device=cuda)
    return xc, xi


def _red_check(plan_name, got, want):
    if plan_name == "ops":
        _assert_k2_close(got, want, sum_rtol=1e-12)
    else:
        _assert_tail_equal(got, want)


@pytest.mark.parametrize("plan_name", ["ops", "tail"])
@pytest.mark.parametrize("kind", list(RED_KEYS))
@pytest.mark.parametrize("lead", [True, False])
def test_k2_reduction_matches_plain(cuda, plan_name, kind, lead):
    """The warp folds and their combine against the plain version: every
    slot family (NaN in min/max rows, raw keys, int64 sums that wrap, arg
    words with ties across warps, empty groups) over a ragged last tile;
    with the lead table and without it (the combine by column)."""
    n = 100_003
    G = RED_KEYS[kind]
    xc, xi = _red_inputs(kind, n, 31, cuda)
    plan = _ops_plan(G) if plan_name == "ops" else _tail_plan(G)
    packed = fs.pack_plan(plan, cuda)
    assert packed.smem["lead"] >= 0
    if not lead:
        packed.words[fs.H_SMEM + fs._SMEM_KEYS.index("lead")] = -1
    int_xc = xi if plan_name == "tail" else None
    got = fs.fused_sql(packed, xc, n, int_xc=int_xc)
    torch.cuda.synchronize()
    _red_check(plan_name, got, fs.fused_sql_plain(packed, xc, n, int_xc=int_xc))
    if kind == "sparse":
        assert int((got["count"] > 0).sum()) == 3


@pytest.mark.parametrize("kind", ["one", "g512", "lane"])
def test_k2_reduction_is_the_same_from_run_to_run(cuda, kind):
    n = 1_000_003
    xc, xi = _red_inputs(kind, n, 32, cuda)
    packed = fs.pack_plan(_tail_plan(RED_KEYS[kind]), cuda)
    first = fs.fused_sql(packed, xc, n, int_xc=xi)
    for _ in range(2):
        again = fs.fused_sql(packed, xc, n, int_xc=xi)
        for k in first:
            assert torch.equal(first[k], again[k]), k


def test_k2_grid_is_the_resident_blocks(cuda):
    """The grid is the blocks resident on the card at the plan's shared
    memory, at most one a tile."""
    packed = fs.pack_plan(_tail_plan(), cuda)
    per_sm = fs.resident_blocks(cuda, packed.smem_bytes)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 1 <= per_sm <= 8
    from infera_tpu_torch.ops import _kernels
    assert _kernels.grid_blocks(cuda, 1 << 20, packed.smem_bytes, per_sm) == sms * per_sm
    assert _kernels.grid_blocks(cuda, 3, packed.smem_bytes, per_sm) == 3
    # query B's bf16 plan (the kWide instance): two blocks an SM or more
    bf16 = fs.pack_plan(_mlp_plan((32, 128, 128, 16), True, True, 1, seed=1), cuda)
    grid, per_sm = fs.plan_grid(bf16, 1 << 20, cuda)
    assert per_sm >= 2 and grid == sms * per_sm


# --------------------------------------------------------------------------- K7a's ring


def _unaligned(x):
    """x's values in a fresh tensor whose base is 1 element past 16-byte
    alignment: the ring's scalar path."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = flat[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 != 0 and y.is_contiguous()
    return y


@pytest.mark.parametrize("d0", [1, 33, 128])
@pytest.mark.parametrize("compute,table", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("n", [4099, 100_003])
def test_k7a_ring_widths_match_plain(cuda, d0, compute, table, n):
    """Table widths whose rows are less than, not a whole number of, and
    many 16-byte words; n no multiple of 64."""
    dims = (d0, 64, 10)
    weights = fq.params_from_numpy(_params(dims, seed=d0), cuda, compute)
    x = _rows(n, d0, 33, cuda).to(table)
    f32 = compute == torch.float32
    got = fq.fused_mlp_query(weights, x)
    _query_close(got, fq.fused_mlp_query_plain(weights, x),
                 count_tol=1 if f32 else max(1, n // 500), rtol=1e-4 if f32 else 2e-2)


@pytest.mark.parametrize("table", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d0", [32, 128])
def test_k7a_ring_equals_the_scalar_load(cuda, table, d0):
    """The ring is a copy: K7a over an aligned table (the ring) and over the
    same values at an unaligned base (the scalar path) are bit-equal."""
    dims = (d0, 128, 64, 16)
    weights = fq.params_from_numpy(_params(dims, seed=34), cuda, torch.bfloat16)
    x = _rows(100_003, d0, 35, cuda).to(table)
    assert fq.ring_stages_bf16(dims, x.element_size()) > 0
    a = fq.fused_mlp_query(weights, x)
    b = fq.fused_mlp_query(weights, _unaligned(x))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_k8a_ring_equals_the_scalar_load(cuda):
    x = _rows(1_000_003, 32, 36, cuda).to(torch.bfloat16)
    assert torch.equal(pq.empty_grid_scan(x), pq.empty_grid_scan(_unaligned(x)))


# --------------------------------------------------------------------------- the tensor-core path


@pytest.mark.parametrize("dims,n", [((30, 200, 7), 4161), ((5, 3), 63), ((30, 64, 48, 10), 1000),
                                    ((32, 128, 128, 16), 100_003)])
def test_mma_path_runs_the_odd_widths(cuda, dims, n):
    """K1, K7a and K8b's full stage in bf16 at widths that pad k to 16 and n
    to 8 (a layer wider than one 128-column pass, one class tile): within
    K7a bf16's bounds of plain, and K7a bit-equal to K1 and to K8b full."""
    weights = fq.params_from_numpy(_params(dims, seed=n + 7), cuda, torch.bfloat16)
    x = _rows(n, dims[0], 41, cuda).to(torch.bfloat16)
    before = (fq.fused_mlp_query.launches["bf16"], fq.fused_mlp_query_columnar.launches["bf16"])
    rows = fq.fused_mlp_query(weights, x)
    cols = fq.fused_mlp_query_columnar(weights, x.T.contiguous())
    torch.cuda.synchronize()
    assert (fq.fused_mlp_query.launches["bf16"],
            fq.fused_mlp_query_columnar.launches["bf16"]) == (before[0] + 1, before[1] + 1)
    _query_close(rows, fq.fused_mlp_query_plain(weights, x), count_tol=max(1, n // 500),
                 rtol=2e-2)
    for a, b in zip(rows, cols):
        assert torch.equal(a, b)
    if dims[0] <= pq.OUT_WIDTH and 2 * dims[-1] <= pq.OUT_WIDTH:
        sw = pq.StageWeights(full=weights,
                             first=fq.params_from_numpy(_params(dims, seed=n + 7)[:1], cuda,
                                                        torch.bfloat16))
        full = pq.query_stage(sw, x, "full")
        c = dims[-1]
        assert torch.equal(full[:c].long(), rows[0]) and torch.equal(full[c:2 * c], rows[1])


def test_hmma_in_the_bf16_kernels_only(cuda):
    """The built libraries' SASS: HMMA in every bf16 instantiation of K1 and
    K7a, in the stage kernel (K8a, K8b) and in K2's kWide instance, none
    in the f32 and int8 ones nor in K2's other instance; neither K2
    instance spills."""
    from infera_tpu_torch.ops import _kernels
    for lib, mma_kernel, n_mma in (("fused_query", "6infera17query_bf16_kernel", 4),
                                   ("profile_query", "6infera12stage_kernel", 1),
                                   ("fused_sql", "3sql16fused_sql_kernelILb1E", 1)):
        counts = _kernels.sass_opcodes(lib, "HMMA")
        mma = {k: v for k, v in counts.items() if mma_kernel in k}
        rest = {k: v for k, v in counts.items() if mma_kernel not in k}
        assert len(mma) == n_mma and all(v > 0 for v in mma.values()), mma
        assert rest and not any(rest.values()), rest
    for stem in ("3sql16fused_sql_kernelILb1E", "3sql16fused_sql_kernelILb0E"):
        assert _kernels.ptxas_usage("fused_sql", stem)[2] == 0, stem


def test_imma_in_the_int8_kernel_only(cuda):
    """The built library's SASS: IMMA in both instantiations of K3's and
    K7b's kernel, none in the f32 and bf16 ones; ptxas spills nothing
    there."""
    from infera_tpu_torch.ops import _kernels
    counts = _kernels.sass_opcodes("fused_query", "IMMA")
    imma = {k: v for k, v in counts.items() if "6infera17query_int8_kernel" in k}
    rest = {k: v for k, v in counts.items() if k not in imma}
    assert len(imma) == 2 and all(v > 0 for v in imma.values()), imma
    assert rest and not any(rest.values()), rest
    for fn in imma:
        assert _kernels.ptxas_usage("fused_query", fn)[2] == 0, fn


@pytest.mark.parametrize("table", [torch.bfloat16, torch.float32])
def test_bf16_kernels_hold_two_blocks_an_sm(cuda, table):
    """At the bench MLP K1 and K7a in bf16 and the stage kernel fit two
    blocks an SM (registers and shared memory), and the grid is that."""
    dims = (32, 128, 128, 16)
    x = _rows(1 << 20, 32, 42, cuda).to(table)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for row_major in (True, False):
        t = x if row_major else x.T.contiguous()
        blocks, smem = fq.bf16_grid(t, dims, row_major)
        assert fq.resident_blocks(cuda, table == torch.bfloat16, row_major, smem) >= 2
        assert blocks == sms * fq.resident_blocks(cuda, table == torch.bfloat16, row_major, smem)
    assert pq.stage_resident_blocks(cuda, pq._stage_smem_bytes(dims)) >= 2


# ------------------------------------------------------------------ the f32 stack, two halves

FEW_TILES = 64 * 100 + 5   # 101 tiles, fewer than a 132-block grid's 264 halves


@pytest.mark.parametrize("n", [1_000_003, FEW_TILES])
@pytest.mark.parametrize("dims", MLPS)
def test_f32_kernels_match_plain_at_the_layout_widths(cuda, dims, n):
    """K1 and K7a in f32 and K6 (with its softmax) against their plain
    versions, at one half or two as each MLP fits: counts within the main
    path's 4 rows (a near-tie in another summation order), sums rtol 1e-4;
    K6 within the 1e-5 parity bound."""
    params = _params(dims, seed=dims[0] + n % 7)
    x = _rows(n, dims[0], 51, cuda)
    xc = x.T.contiguous()
    w = fq.params_from_numpy(params, cuda)
    plain = fq.fused_mlp_query_columnar_plain(w, xc)
    for got in (fq.fused_mlp_query_columnar(w, xc), fq.fused_mlp_query(w, x)):
        _query_close(got, plain, count_tol=4, rtol=1e-4)
    mw = fm.mlp_weights(params, cuda)
    torch.testing.assert_close(fm.fused_mlp(mw, x, True), fm.fused_mlp_plain(mw, x, True),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dims", [(32, 128, 128, 16), (30, 64, 48, 10), (5, 130, 3)])
def test_one_half_and_two_halves_agree(cuda, dims):
    """The same MLP at one half a block and at two: the same scores, so
    equal counts and K6 outputs bit for bit; the sums differ only in how
    the f64 partials group (rtol 1e-6)."""
    assert fq.query_halves(dims) == fm.mlp_halves(dims) == 2
    params = _params(dims, seed=52)
    x = _rows(100_003, dims[0], 53, cuda)
    w = fq.params_from_numpy(params, cuda)
    for row_major, t in ((False, x.T.contiguous()), (True, x)):
        one, two = fq._launch_f32(w, t, row_major, 1), fq._launch_f32(w, t, row_major, 2)
        assert torch.equal(one[0], two[0])
        torch.testing.assert_close(two[1], one[1], rtol=1e-6, atol=0)
    mw = fm.mlp_weights(params, cuda)
    for softmax in (False, True):
        assert torch.equal(fm._launch(mw, x, softmax, 1), fm._launch(mw, x, softmax, 2))


@pytest.mark.parametrize("dims", [(32, 128, 128, 16), (30, 200, 7), (5, 3)])
def test_k6_sums_in_fma_map_order(cuda, dims):
    """K6 without its softmax equals chip_smoke.fma_map's layers (from 0,
    one fused multiply-add per input in input order, then the bias, ReLU
    between) bit for bit, at one half or two, over 200 rows."""
    from chip_smoke import fma_map

    params = _params(dims, seed=54)
    x = np.random.default_rng(55).standard_normal((200, dims[0])).astype(np.float32)
    h = x
    for l, (w, b) in enumerate(params):
        h = fma_map(h, w, b)
        if l + 1 < len(params):
            h = np.where(h < 0, np.float32(0), h)
    mw = fm.mlp_weights(params, cuda)
    xd = torch.as_tensor(x, device=cuda)
    for halves in sorted({1, fm.mlp_halves(dims)}):
        got = fm._launch(mw, xd, False, halves).cpu().numpy()
        assert np.array_equal(got, h), (dims, halves)


def test_f32_kernels_run_two_halves_without_spill(cuda):
    """At the bench MLP over 1,048,576 rows K1 and K7a in f32 run two halves
    on one block of 512 threads an SM (K7a without its ring) and K6 the
    same; every instantiation of the f32 query kernel and K6 keep to 128
    registers without a spill."""
    from infera_tpu_torch.ops import _kernels

    dims = (32, 128, 128, 16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for table in (torch.float32, torch.bfloat16):
        rows = torch.empty((1 << 20, 32), dtype=table, device=cuda)
        assert fq.f32_grid(rows, dims, True) == (sms, 2, 0, 232_000)
        assert fq.f32_grid(rows.T.contiguous(), dims, False) == (sms, 2, 0, 232_000)
    assert fm.mlp_grid(cuda, dims, 1 << 20) == (sms, 2, 230_464)
    for lib, kernel, count in (("fused_query", "6infera16query_f32_kernel", 4),
                               ("fused_mlp", "6infera16fused_mlp_kernel", 1)):
        ffma = {k: v for k, v in _kernels.sass_opcodes(lib, "FFMA").items() if kernel in k}
        assert len(ffma) == count and all(v > 0 for v in ffma.values()), ffma
        for fn in ffma:
            regs, _, spill = _kernels.ptxas_usage(lib, fn)
            assert regs <= 128 and spill == 0, (fn, regs, spill)
