"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA card (H100, sm_90a) and skip without one. On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``
(the file imports no JAX, so it runs where JAX is not installed). The shapes
cover what the main path does not: one row, ragged tiles, a layer wider than
one 128-column pass, widths that are no multiple of 4 or 8, and left shifts
in K3."""

import numpy as np
import pytest
import torch

from infera_tpu_torch.ops import fused_mlp as fm
from infera_tpu_torch.ops import fused_query as fq

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
