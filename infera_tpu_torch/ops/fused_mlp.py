"""K6: the fused MLP kernel of the engine's predict path.

Counterpart of ``infera_tpu/ops/pallas_mlp.py``. A row-major ReLU MLP over
``x [N, d0]`` with an optional final softmax runs as one CUDA kernel
(``csrc/fused_mlp.cu``): the layer stack runs on 64-row tiles in shared
memory, so device memory sees only ``x`` read once and ``out`` written once.
The kernel takes any N >= 1 and masks the ragged last tile itself.

``fused_mlp`` launches the kernel for a CUDA tensor and runs
``fused_mlp_plain`` for a CPU tensor; it raises for anything else.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _kernels

TILE_ROWS = 64
ACT_STRIDE = TILE_ROWS + 4       # words per activation row in shared memory
MAX_LAYERS = 8
SMEM_LIMIT = 232448              # bytes of shared memory one Hopper block may use (227 KB)


def pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def smem_bytes(dims) -> int:
    """Shared memory K6 needs for an MLP of widths ``dims`` = [d0, .., dL]:
    every layer's weights and biases at f32 (output widths padded to 8), and
    two activation tiles of 64 rows at the widest width. The main path's
    32-128-128-16 MLP needs 90,112 + 1,088 + 69,632 = 160,832 bytes; a
    128-row tile would need 139,264 bytes of activations, too many beside
    the weights."""
    weights = sum(dims[i] * pad8(dims[i + 1]) for i in range(len(dims) - 1))
    biases = sum(pad8(d) for d in dims[1:])
    widest = max(pad8(d) for d in dims)
    return 4 * (weights + biases + 2 * widest * ACT_STRIDE)


def smem_fits(dims) -> bool:
    """Hopper budget check, in place of the TPU's VMEM rule (``vmem_fits``):
    the kernel's weights and activation tiles must fit one block's 227 KB."""
    return 1 <= len(dims) - 1 <= MAX_LAYERS and smem_bytes(dims) <= SMEM_LIMIT


def pack_f32_blob(ws, bs) -> torch.Tensor:
    """Weights [din, dout] and biases [dout] (float tensors) packed in the
    kernels' shared-memory layout: every W as [din][pad8(dout)], then every b
    as [pad8(dout)], zero-padded; f32, on the weights' device."""
    parts = []
    for w in ws:
        din, dout = w.shape
        parts.append(torch.nn.functional.pad(w.float(), (0, pad8(dout) - dout)).reshape(-1))
    for b in bs:
        parts.append(torch.nn.functional.pad(b.float().reshape(-1), (0, pad8(b.numel()) - b.numel())))
    return torch.cat(parts).contiguous()


@dataclass(frozen=True)
class MlpWeights:
    """A ReLU MLP's weights on one device, as K6 and its plain version take
    them: ``layers`` = [(w [din, dout] f32, b [dout] f32), ...] and ``blob``,
    the same numbers in the kernel's layout."""

    dims: tuple
    layers: list
    blob: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.blob.device


def mlp_weights(params, device) -> MlpWeights:
    """Move numpy ``[(w [din, dout], b [dout]), ...]`` to ``device`` once."""
    layers = [(torch.as_tensor(np.asarray(w, np.float32), device=device),
               torch.as_tensor(np.asarray(b, np.float32), device=device)) for w, b in params]
    dims = (layers[0][0].shape[0],) + tuple(w.shape[1] for w, _ in layers)
    blob = pack_f32_blob([w for w, _ in layers], [b for _, b in layers])
    return MlpWeights(dims=dims, layers=layers, blob=blob)


def fused_mlp_plain(weights: MlpWeights, x: torch.Tensor,
                    final_softmax: bool = False) -> torch.Tensor:
    """K6's function in plain PyTorch (f32 matmuls, TF32 off)."""
    h = x
    last = len(weights.layers) - 1
    for i, (w, b) in enumerate(weights.layers):
        h = h @ w + b
        if i < last:
            h = torch.relu(h)
    if final_softmax:
        h = torch.softmax(h, dim=-1)
    return h


def fused_mlp(weights: MlpWeights, x: torch.Tensor,
              final_softmax: bool = False) -> torch.Tensor:
    """Run the MLP over ``x [N, d0]`` f32; returns ``[N, dout]`` f32."""
    if x.device.type == "cpu":
        return fused_mlp_plain(weights, x, final_softmax)
    _kernels.require_cuda(x, "x")
    dims = weights.dims
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != dims[0]:
        raise ValueError(f"x must be f32 [N, {dims[0]}], got {x.dtype} {tuple(x.shape)}")
    if weights.device != x.device:
        raise ValueError(f"weights on {weights.device}, x on {x.device}")
    if not smem_fits(dims):
        raise ValueError(f"MLP {dims} exceeds the kernel's shared-memory budget")
    n = x.shape[0]
    out = torch.empty((n, dims[-1]), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    smem = smem_bytes(dims)
    n_blocks = _kernels.grid_blocks(x.device, -(-n // TILE_ROWS), smem)
    lib = _kernels.load("fused_mlp")
    rc = lib.infera_fused_mlp(
        x.data_ptr(), n, weights.blob.data_ptr(), weights.blob.numel(),
        _kernels.int_array(dims), len(dims) - 1, max(pad8(d) for d in dims),
        int(final_softmax), out.data_ptr(), n_blocks, smem,
        _kernels.stream_handle(x.device))
    _kernels.check(lib, rc, "fused_mlp")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
