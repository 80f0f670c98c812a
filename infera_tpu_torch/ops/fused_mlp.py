"""K6: the fused MLP kernel of the engine's predict path.

Counterpart of ``infera_tpu/ops/pallas_mlp.py``. A row-major ReLU MLP over
``x [N, d0]`` with an optional final softmax runs as one CUDA kernel
(``csrc/fused_mlp.cu``): the layer stack runs on 64-row tiles in shared
memory, so device memory sees only ``x`` read once and ``out`` written once.
The kernel takes any N >= 1 and masks the ragged last tile itself. A block
runs two halves of 256 threads over one copy of the weights where two
halves' activation tiles fit beside them (``mlp_halves``), else one.

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
THREADS = 256                    # threads of a tile group (csrc/mlp_tile.cuh kThreads)
MAX_HALVES = 2                   # tile groups a block of the f32 kernels holds (kMaxHalves)


def pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def smem_bytes(dims, halves: int = 1) -> int:
    """Shared memory K6 needs for an MLP of widths ``dims`` = [d0, .., dL]
    at ``halves`` tile groups a block: every layer's weights and biases at
    f32 (output widths padded to 8) once, and each half's two activation
    tiles of 64 rows at the widest width. The main path's 32-128-128-16 MLP
    needs 90,112 + 1,088 + 69,632 = 160,832 bytes at one half and 230,464
    at two; a 128-row tile would need 139,264 bytes of activations a half."""
    weights = sum(dims[i] * pad8(dims[i + 1]) for i in range(len(dims) - 1))
    biases = sum(pad8(d) for d in dims[1:])
    widest = max(pad8(d) for d in dims)
    return 4 * (weights + biases + halves * 2 * widest * ACT_STRIDE)


def mlp_halves(dims) -> int:
    """Tile groups a block of K6 runs for an MLP of ``dims``: two where two
    halves fit one block's 227 KB, else one (``smem_fits`` checks that one
    does)."""
    return MAX_HALVES if smem_bytes(dims, MAX_HALVES) <= SMEM_LIMIT else 1


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
    out = _launch(weights, x, final_softmax)
    fused_mlp.launches += 1
    return out


def _launch(weights: MlpWeights, x: torch.Tensor, final_softmax: bool,
            halves: int | None = None) -> torch.Tensor:
    """Launch K6 over a checked ``x`` at ``mlp_grid``'s shape (``halves``
    asks for one; the tests and ``testing/ab_kernels.py`` compare the
    two)."""
    dims = weights.dims
    n = x.shape[0]
    out = torch.empty((n, dims[-1]), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    n_blocks, halves, smem = mlp_grid(x.device, dims, n, halves)
    lib = _kernels.load("fused_mlp")
    rc = lib.infera_fused_mlp(
        x.data_ptr(), n, weights.blob.data_ptr(), weights.blob.numel(),
        _kernels.int_array(dims), len(dims) - 1, max(pad8(d) for d in dims),
        int(final_softmax), out.data_ptr(), n_blocks, halves, smem,
        _kernels.stream_handle(x.device))
    _kernels.check(lib, rc, "fused_mlp")
    return out


fused_mlp.launches = 0


def grid_for(device: torch.device, n_rows: int, halves: int, smem: int, per_sm: int) -> int:
    """Blocks of a persistent grid of the f32 kernels: the blocks resident
    on the card (``per_sm`` an SM at ``smem`` bytes), at most one half a
    tile."""
    n_tiles = -(-n_rows // TILE_ROWS)
    return _kernels.grid_blocks(device, -(-n_tiles // halves), smem, per_sm)


def mlp_grid(device: torch.device, dims, n_rows: int, halves: int | None = None) -> tuple:
    """(blocks, halves, shared-memory bytes) of K6 over ``n_rows`` rows:
    ``mlp_halves`` tile groups a block, or ``halves`` (1 or 2) where given,
    on the blocks resident on the card at that shape (registers, shared
    memory and threads all counted)."""
    if halves not in (None, 1, 2):
        raise ValueError(f"halves must be 1 or 2, got {halves}")
    halves = halves or mlp_halves(dims)
    smem = smem_bytes(dims, halves)
    if smem > SMEM_LIMIT:
        raise ValueError(f"MLP {dims} at {halves} halves exceeds the kernel's shared-memory budget")
    per_sm = _kernels.resident_blocks(device, "fused_mlp", "infera_fused_mlp_occupancy",
                                      halves, smem)
    return grid_for(device, n_rows, halves, smem, per_sm), halves, smem
