"""Group-by segment reductions in torch ops.

Counterpart of ``infera_tpu/ops/gemm_groupby.py``, with its names and
contracts. There the reductions ran as one-hot matmuls on the MXU because
XLA's scatters were the TPU's weak spot; the one-hot form is the TPU's
layout, not the contract. Here they are torch's segment ops
(``index_add_``, ``scatter_reduce_``), summing in f64 and counting in int64,
so the sums need no compensation and the integer results are exact
(``segment_sum_int_exact`` adds modulo 2**64).

``keys`` are int64 group ids in ``[0, G]``: a row whose key is ``G`` is
dropped, as ``infera_tpu``'s padding rows were (the device plan gives the
rows its WHERE drops the key ``G``). ``index_add_`` on CUDA adds in no fixed
order, so an f64 sum can differ from run to run in its last bits; counts and
integer sums cannot.
"""

from __future__ import annotations

import math

import torch

MAX_GEMM_GROUPS = 512
MIN_GEMM_ROWS = 1 << 17
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
_I64 = torch.iinfo(torch.int64)


def eligible(n: int, G: int) -> bool:
    """``infera_tpu``'s bound for its one-hot path (the port's segment ops
    take any ``G``; held by the reference's tests)."""
    return G <= MAX_GEMM_GROUPS and n >= MIN_GEMM_ROWS


def _rows(vals):
    single = not isinstance(vals, (list, tuple))
    return single, [vals] if single else list(vals)


def segment_sum(vals, keys: torch.Tensor, G: int):
    """Per-group f64 sums of ``vals`` ([N], or a list of [N] rows: a list
    back); ``jax.ops.segment_sum(vals, keys, num_segments=G)``."""
    single, rows = _rows(vals)
    outs = []
    for v in rows:
        acc = torch.zeros(G + 1, dtype=torch.float64, device=keys.device)
        outs.append(acc.index_add_(0, keys, v.double())[:G])
    return outs[0] if single else outs


def segment_minmax(vals, keys: torch.Tensor, G: int, masks=None):
    """Per-group (mins, maxs) lists, f32, of each [N] row in ``vals``;
    ``masks`` (optional, a bool row each) drops rows. An empty group gives
    +inf and -inf; a NaN among a group's rows gives NaN, as XLA's min."""
    rows = [v.float() for v in vals]
    masks = masks or [None] * len(rows)
    mns, mxs = [], []
    for v, m in zip(rows, masks):
        k = keys if m is None else torch.where(m, keys, G)
        nan = torch.zeros(G + 1, dtype=torch.float32, device=v.device)
        nan = nan.index_add_(0, k, torch.isnan(v).float())[:G] > 0
        for out, fill, how in ((mns, math.inf, "amin"), (mxs, -math.inf, "amax")):
            acc = torch.full((G + 1,), fill, dtype=torch.float32, device=v.device)
            acc = acc.scatter_reduce_(0, k, v, how)[:G]
            out.append(torch.where(nan, math.nan, acc))
    return mns, mxs


def segment_minmax_int32(k: torch.Tensor, keys: torch.Tensor, G: int, mask):
    """Exact per-group (min, max) of int32-range values ``k`` over the rows
    ``mask`` keeps, int32; an empty group gives INT32_MAX and INT32_MIN."""
    kk = torch.where(mask, keys, G)
    v = k.long()
    mn = torch.full((G + 1,), _I32_MAX, dtype=torch.int64, device=v.device)
    mx = torch.full((G + 1,), _I32_MIN, dtype=torch.int64, device=v.device)
    return (mn.scatter_reduce_(0, kk, v, "amin")[:G].int(),
            mx.scatter_reduce_(0, kk, v, "amax")[:G].int())


def segment_sum_int_exact(rows, keys: torch.Tensor, G: int) -> list:
    """Exact per-group int64 sums of each integer row (modulo 2**64)."""
    outs = []
    for v in rows:
        acc = torch.zeros(G + 1, dtype=torch.int64, device=keys.device)
        outs.append(acc.index_add_(0, keys, v.long())[:G])
    return outs


def segment_extreme_int64(v: torch.Tensor, keys: torch.Tensor, G: int, mask,
                          is_min: bool) -> torch.Tensor:
    """Exact per-group int64 min (or max) of ``v`` over the rows ``mask``
    keeps; an empty group gives the int64 maximum (minimum)."""
    kk = keys if mask is None else torch.where(mask, keys, G)
    acc = torch.full((G + 1,), _I64.max if is_min else _I64.min, dtype=torch.int64,
                     device=v.device)
    return acc.scatter_reduce_(0, kk, v.long(), "amin" if is_min else "amax")[:G]


def segment_lex_minmax(lo_b: torch.Tensor, hi: torch.Tensor, keys: torch.Tensor, G: int,
                       mask, is_min: bool) -> tuple:
    """Exact int64 per-group extreme of the values given as (hi, lo-biased)
    int32 words, where ``lo_b`` is the low word xor INT32_MIN (so that its
    signed order is the unsigned order of the low word); returns the
    extreme's words the same way. An empty group gives (INT32_MAX,
    INT32_MAX) for a min and (INT32_MIN, INT32_MIN) for a max, as
    ``infera_tpu``'s identities."""
    lo_u = (lo_b.long() ^ _I32_MIN) & 0xFFFFFFFF
    ext = segment_extreme_int64((hi.long() << 32) | lo_u, keys, G, mask, is_min)
    return (ext >> 32).int(), ((ext & 0xFFFFFFFF) ^ (1 << 31)).int()


def segment_count_matrix(keys: torch.Tensor, vals: torch.Tensor, G: int, V: int,
                         ok) -> torch.Tensor:
    """[G, V] int64 counts of (group, value) pairs over the rows ``ok``
    keeps; ``vals`` are integers in ``[0, V)``. Feeds DISTINCT presence
    (counts > 0) and the MODE count matrix."""
    cell = torch.where(ok, keys * V + vals.long(), G * V)
    acc = torch.zeros(G * V + 1, dtype=torch.int64, device=keys.device)
    acc.index_add_(0, cell, torch.ones_like(cell))
    return acc[:G * V].view(G, V)
