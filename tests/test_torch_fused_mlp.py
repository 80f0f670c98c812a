"""K6 (``infera_tpu_torch/ops/fused_mlp.py``) against ``infera_tpu``'s Pallas
kernel in interpret mode, on the CPU.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel itself
is held against that plain version on the card (tests/test_torch_cuda_kernels.py
and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infera_tpu.ops.pallas_mlp import fused_mlp_padded
from infera_tpu_torch.ops import fused_mlp as fm


def _params(dims, seed=0, scale=0.2):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * np.float32(scale),
             rng.standard_normal(dims[i + 1]).astype(np.float32) * np.float32(0.1))
            for i in range(len(dims) - 1)]


@pytest.mark.parametrize("softmax", [False, True])
@pytest.mark.parametrize("dims", [(32, 64, 64, 16), (3, 1), (12, 40, 5)])
def test_plain_matches_pallas_interpret(dims, softmax):
    params = _params(dims)
    x = np.random.default_rng(1).standard_normal((1000, dims[0])).astype(np.float32)
    want = fused_mlp_padded([(jnp.asarray(w), jnp.asarray(b)) for w, b in params],
                            jnp.asarray(x), tile_n=256, final_softmax=softmax,
                            interpret=True)
    before = fm.fused_mlp.launches
    got = fm.fused_mlp(fm.mlp_weights(params, "cpu"), torch.from_numpy(x), softmax)
    assert fm.fused_mlp.launches == before  # the CPU runs the plain version
    assert tuple(got.shape) == (1000, dims[-1])
    # f32 on both sides, sums in another order: the tolerance of
    # tests/test_pallas_kernels.py for the same kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_budget_holds_the_main_path_and_refuses_wide_models():
    # 32-128-128-16: weights 90,112 B + biases 1,088 B + 2 tiles 69,632 B
    assert fm.smem_bytes((32, 128, 128, 16)) == 160_832
    assert fm.smem_fits((32, 128, 128, 16))
    assert fm.smem_fits((3, 1))
    assert not fm.smem_fits((4096, 4096))
    assert not fm.smem_fits((32, 256, 256, 16))  # 311 KB of weights alone
    assert not fm.smem_fits((4,) * (fm.MAX_LAYERS + 2))
    assert fm.smem_fits((4,) * (fm.MAX_LAYERS + 1))


def test_blob_is_the_kernels_layout():
    """The blob holds every W as [din][pad8(dout)] and then every b as
    [pad8(dout)], zero-padded, as csrc/mlp_tile.cuh reads it."""
    dims = (5, 12, 3)
    params = _params(dims, seed=3)
    w = fm.mlp_weights(params, "cpu")
    blob = w.blob.numpy()
    assert blob.dtype == np.float32 and blob.size == 5 * 16 + 12 * 8 + 16 + 8
    w0 = blob[:80].reshape(5, 16)
    w1 = blob[80:176].reshape(12, 8)
    np.testing.assert_array_equal(w0[:, :12], params[0][0])
    np.testing.assert_array_equal(w0[:, 12:], 0)
    np.testing.assert_array_equal(w1[:, :3], params[1][0])
    np.testing.assert_array_equal(blob[176:188], params[0][1])
    np.testing.assert_array_equal(blob[188:192], 0)
    np.testing.assert_array_equal(blob[192:195], params[1][1])
    assert w.dims == dims


def test_wrapper_refuses_a_tensor_that_is_neither_cpu_nor_cuda():
    w = fm.mlp_weights(_params((4, 2)), "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fm.fused_mlp(w, torch.empty((8, 4), device="meta"))
