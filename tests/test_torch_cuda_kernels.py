"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA card (H100, sm_90a) and skip without one. On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``
(the file imports no JAX, so it runs where JAX is not installed). The shapes
cover what the main path does not: one row, ragged tiles, a layer wider than
one 128-column pass, widths that are no multiple of 4 or 8, and left shifts
in K3; for K2, every opcode of the programs, the key guards, MLP slots in
f32 and bf16, and the SQL flagship through Connection.execute."""

import numpy as np
import pytest
import torch

from infera_tpu_torch.ops import fused_mlp as fm
from infera_tpu_torch.ops import fused_query as fq
from infera_tpu_torch.ops import fused_sql as fs

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
                                         ((9, 130, 3), 1, 13)])
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


def _mlp_plan(dims, softmax, bf16, oc, seed, G=64):
    params = _params(dims, seed)
    feats = [[(fs.COL, (1, 3, 4, 5)[k % 4])] for k in range(dims[0])]  # no NaN column
    slot = fs.MlpSlot(params=params, final_softmax=softmax, out_col=oc, bf16=bf16,
                      features=feats)
    consts = []
    return fs.FusedPlan(where=[(fs.COL, 3), _c(consts, 0.0), (fs.GT, 0)], keys=[[(fs.COL, 0)]],
                        sums=[[(fs.PRED, 0)]], mins=[[(fs.PRED, 0)]], maxs=[[(fs.PRED, 0)]],
                        strides=[1], n_groups=G, consts=consts, mlps=[slot])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("dims,softmax,oc,n", [((4, 32, 1), False, 0, 100_003),
                                               ((32, 128, 128, 16), True, 1, 70_001),
                                               ((5, 130, 3), False, 2, 1)])
def test_k2_mlp_slots_match_plain(cuda, dims, softmax, oc, n, bf16):
    packed = fs.pack_plan(_mlp_plan(dims, softmax, bf16, oc, seed=n), cuda)
    xc = _sql_block(n, 10, cuda)
    got = fs.fused_sql(packed, xc, n)
    want = fs.fused_sql_plain(packed, xc, n)
    if not bf16:
        # f32 layers summed in another order: the 1e-5 parity bound
        _assert_k2_close(got, want, sum_rtol=1e-5, mm_rtol=1e-5)
    else:
        # a bf16 rounding of a ReLU output can go the other way when the f32
        # sum before it differs in its last bit
        _assert_k2_close(got, want, sum_rtol=1e-3, mm_rtol=2e-2)


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
        assert fs.fused_sql.launches["f32"] == before + 1
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
