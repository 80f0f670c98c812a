"""Exact integer aggregation on the device (the device plan's helpers).

Counterpart of ``infera_tpu/sql/int_agg.py``. ``infera_tpu`` runs JAX with
x64 off, so it splits each int64 into 32-bit words, sums 8-bit limbs and
reduces min/max word by word. The H100 has native int64, so here an
integer column reaches the device as int64 (``device_plan.get_int_block``)
and the sums, minima and maxima are plain int64 segment reductions
(``ops/gemm_groupby.py``): a sum adds modulo 2**64, with an f64 sum of
``|v|`` beside it that the finalize reads for SUM(BIGINT)'s overflow rule.
The planner keeps ``infera_tpu``'s bounds (``MAX_LIMB_ROWS``,
``MAX_DISTINCT_SUM_DOMAIN``, ``MAX_PRESENCE_ELEMS``), so both packages send
the same plans to the device.

COUNT/SUM/AVG(DISTINCT e) and MODE over a small integer domain build a
[G, V] count matrix; MODE breaks a tie of counts by the earliest first
occurrence, the host's rule (``ops/aggregate._agg_mode``).

Reference parity note: the reference keeps all SQL aggregation inside DuckDB
(upstream infera/bindings/infera_extension.cpp only computes model
predictions); exact integer aggregate semantics here mirror DuckDB's
hugeint-backed SUM(BIGINT) to the extent of int64 range + overflow error.
"""

from __future__ import annotations

import torch

from ..ops import gemm_groupby as GG

# infera_tpu's 8-bit-limb exactness bound on the rows of an integer sum
MAX_LIMB_ROWS = 1 << 23

# DISTINCT: infera_tpu's limb-matmul bound on a SUM/AVG(DISTINCT) domain and
# its cap on G*V presence cells
MAX_DISTINCT_SUM_DOMAIN = 1 << 15
MAX_PRESENCE_ELEMS = 1 << 22


def device_limb_sums(v: torch.Tensor, mask: torch.Tensor, keys: torch.Tensor,
                     n_groups: int) -> tuple:
    """Per-group exact int64 sums of the int64 values ``v`` over the rows
    ``mask`` keeps (modulo 2**64), and the f64 sums of ``|v|`` (the overflow
    guard). The name is ``infera_tpu``'s, whose sums ran in 8-bit limbs."""
    k = torch.where(mask, keys, n_groups)
    (total,) = GG.segment_sum_int_exact([v], k, n_groups)
    return total, GG.segment_sum(v.double().abs(), k, n_groups)


def device_lex_minmax(v: torch.Tensor, mask: torch.Tensor, keys: torch.Tensor,
                      n_groups: int, is_min: bool) -> torch.Tensor:
    """Per-group exact int64 min (or max) of ``v`` over the rows ``mask``
    keeps; an empty group holds the int64 maximum (minimum)."""
    return GG.segment_extreme_int64(v, keys, n_groups, mask, is_min)


def _domain(vals: torch.Tensor, mask: torch.Tensor, v_domain: int) -> tuple:
    """(int64 values, rows in the domain, invalid flag): a selected value
    that is fractional, negative, NaN or ``>= v_domain`` sets the flag."""
    vt = torch.trunc(vals)
    ok = (vt == vals) & (vals >= 0) & (vals < v_domain)
    return torch.where(ok, vt, 0.0).long(), mask & ok, (mask & ~ok).any()


def device_presence(vals: torch.Tensor, mask: torch.Tensor, keys: torch.Tensor,
                    n_groups: int, v_domain: int) -> tuple:
    """([G, V] bool presence, invalid flag) of the f32 values ``vals`` over
    the rows ``mask`` keeps; the flag sends the plan to the host."""
    vi, ok, invalid = _domain(vals, mask, v_domain)
    return GG.segment_count_matrix(keys, vi, n_groups, v_domain, ok) > 0, invalid


def presence_reduce(presence: torch.Tensor, v_domain: int) -> tuple:
    """(distinct count [G], sum of the distinct values [G]), int64."""
    values = torch.arange(v_domain, dtype=torch.int64, device=presence.device)
    p = presence.long()
    return p.sum(dim=1), (p * values).sum(dim=1)   # no int64 matmul on CUDA


def mode_matrices(vals: torch.Tensor, mask: torch.Tensor, keys: torch.Tensor,
                  n_groups: int, v_domain: int, row_idx: torch.Tensor) -> tuple:
    """([G, V] counts, [G, V] first-occurrence row index, invalid flag);
    a (group, value) pair never seen holds the int64 maximum."""
    vi, ok, invalid = _domain(vals, mask, v_domain)
    counts = GG.segment_count_matrix(keys, vi, n_groups, v_domain, ok)
    cell = torch.where(ok, keys * v_domain + vi, n_groups * v_domain)
    first = torch.full((n_groups * v_domain + 1,), torch.iinfo(torch.int64).max,
                       dtype=torch.int64, device=vals.device)
    first = first.scatter_reduce_(0, cell, row_idx, "amin")[:-1]
    return counts, first.view(n_groups, v_domain), invalid


def mode_select(counts: torch.Tensor, first: torch.Tensor, v_domain: int) -> tuple:
    """(mode value [G], its count [G]): the largest count, a tie to the
    value seen first."""
    mcount = counts.max(dim=1).values
    cand = counts == mcount[:, None]
    fmin = torch.where(cand, first, torch.iinfo(torch.int64).max).min(dim=1).values
    at = cand & (first == fmin[:, None])
    values = torch.arange(v_domain, dtype=torch.int64, device=counts.device)
    return torch.where(at, values, v_domain).min(dim=1).values, mcount


def device_mode(vals: torch.Tensor, mask: torch.Tensor, keys: torch.Tensor, n_groups: int,
                v_domain: int, row_idx: torch.Tensor) -> tuple:
    """Per-group MODE of the f32 values ``vals`` over the rows ``mask``
    keeps, over ``[0, v_domain)``: (mode value, its count, invalid flag),
    the host catalog's semantics (max count, then earliest first
    occurrence)."""
    counts, first, invalid = mode_matrices(vals, mask, keys, n_groups, v_domain, row_idx)
    mode_v, mcount = mode_select(counts, first, v_domain)
    return mode_v, mcount, invalid
