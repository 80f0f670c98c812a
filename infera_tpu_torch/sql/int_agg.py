"""Exact integer aggregation on a 32-bit device (shared helpers).

JAX runs x64-disabled here (SURVEY.md §7.3), so int64 columns cannot ride to
the device directly. The trick (first used by sql/streaming_plan.py, now
shared by the single-device and mesh fused plans): split each int64 into
two's-complement (lo32, hi32) words host-side, segment-sum 8-bit limbs of
each word in int32 on device (exact while rows x 255 < 2^31), and fold the
limb sums back into int64 on the host with mod-2^64 arithmetic. Min/max
reduce lexicographically on (hi, lo-as-unsigned) without 64-bit compares.

Reference parity note: the reference keeps all SQL aggregation inside DuckDB
(upstream infera/bindings/infera_extension.cpp only computes model
predictions); exact integer aggregate semantics here mirror DuckDB's
hugeint-backed SUM(BIGINT) to the extent of int64 range + overflow error.
"""

from __future__ import annotations

import numpy as np

# 8-bit limb int32 segment sums stay exact while rows*255 < 2^31
MAX_LIMB_ROWS = 1 << 23


class WordColumn:
    """A lightweight stand-in for columnar.Column holding one 32-bit word of
    an int64 column, so mesh upload caching (`_mesh_array`) works unchanged."""

    __slots__ = ("data", "_mesh_array", "_device_array")

    def __init__(self, data: np.ndarray):
        self.data = data


def split_words_host(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int64 array -> (lo int32, hi int32) two's-complement words."""
    v = np.asarray(v).astype(np.int64)
    lo = (v & np.int64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (v >> 32).astype(np.int32)
    return lo, hi


def word_columns(col) -> tuple[WordColumn, WordColumn]:
    """(lo, hi) WordColumns for an integer Column, cached on the Column."""
    cached = getattr(col, "_word_cols", None)
    if cached is not None:
        return cached
    lo, hi = split_words_host(col.data)
    pair = (WordColumn(lo), WordColumn(hi))
    col._word_cols = pair
    return pair


def byte_columns(col):
    """Eight uint8 arrays — the 8-bit limbs of an int64 column's
    two's-complement words — cached on the Column. The Pallas fused plan
    stacks these as f32 block rows (bytes are f32-exact) and sums each
    masked limb per group: with rows <= MAX_LIMB_ROWS every 128-lane
    accumulator sees at most 2^16 rows x 255 < 2^24, so the f32 lane sums
    never round and the host f64 fold is exact (VERDICT r4 item 2)."""
    cached = getattr(col, "_byte_cols", None)
    if cached is not None:
        return cached
    lo, hi = split_words_host(col.data)
    rows = []
    for word in (lo, hi):
        u = word.view(np.uint32)
        for j in range(4):
            rows.append(((u >> np.uint32(8 * j))
                         & np.uint32(0xFF)).astype(np.uint8))
    col._byte_cols = rows
    return rows


def device_limb_sums(jnp, jax, lo, hi, wi, keys, n_groups, gg=None):
    """Per-group exact partial sums of (lo,hi)-word rows as [G, 8] int32
    8-bit-limb sums plus an f32 magnitude estimate (overflow guard).
    Caller guarantees rows <= MAX_LIMB_ROWS. ``gg``: the gemm_groupby
    module when the caller's plan uses the scatter-free GEMM path — the 8
    limb rows then share ONE one-hot chunk scan (exact: per-chunk byte
    sums < 2^24 in f32, int32 cross-chunk accumulator)."""
    byte_rows = []
    for word in (lo, hi):
        for j in range(4):
            byte_rows.append(jnp.bitwise_and(
                jnp.right_shift(word, 8 * j), 0xFF) * wi)
    if gg is not None:
        limbs = gg.segment_sum_int_exact(jnp, jax, byte_rows, keys,
                                         n_groups)
    else:
        limbs = [jax.ops.segment_sum(b, keys, num_segments=n_groups)
                 for b in byte_rows]
    lof = jnp.where(lo < 0, lo.astype(jnp.float32) + np.float32(2.0**32),
                    lo.astype(jnp.float32))
    vf = hi.astype(jnp.float32) * np.float32(2.0**32) + lof
    est_in = jnp.abs(vf) * wi.astype(jnp.float32)
    if gg is not None:
        est = gg.segment_sum(jnp, jax, est_in, keys, n_groups)
    else:
        est = jax.ops.segment_sum(est_in, keys, num_segments=n_groups)
    return jnp.stack(limbs, axis=1), est


def fold_limbs_host(limbs: np.ndarray) -> np.ndarray:
    """[G, 8] limb sums -> exact int64 totals (mod-2^64 two's complement)."""
    u = np.zeros(limbs.shape[0], np.uint64)
    for j in range(8):
        u = u + (limbs[:, j].astype(np.uint64) << np.uint64(8 * j))
    return u.astype(np.int64)


def fold_lex_host(hi: np.ndarray, lo_biased: np.ndarray) -> np.ndarray:
    """(hi int32, lo-xor-INT32_MIN int32) lexicographic words -> int64."""
    lo_u = ((lo_biased.astype(np.int64) ^ -(np.int64(1) << 31))
            & np.int64(0xFFFFFFFF))
    return (hi.astype(np.int64) << 32) + lo_u


def device_lex_minmax(jnp, jax, lo, hi, mask, keys, n_groups, is_min: bool,
                      gg=None):
    """Exact int64 per-group min/max without 64-bit arithmetic: reduce hi
    first, then lo (as unsigned) among rows whose hi equals the winner.
    With ``gg`` the reductions run scatter-free (gemm_groupby)."""
    if gg is not None:
        lo_b = jnp.bitwise_xor(lo, np.int32(-(1 << 31)))
        return gg.segment_lex_minmax(jnp, jax, lo_b, hi, keys, n_groups,
                                     mask, is_min)
    INT32_MIN = np.int32(-(1 << 31))
    INT32_MAX = np.int32((1 << 31) - 1)
    lo_b = jnp.bitwise_xor(lo, INT32_MIN)  # unsigned order
    if is_min:
        hi_eff = jnp.where(mask, hi, INT32_MAX)
        sel_hi = jax.ops.segment_min(hi_eff, keys, num_segments=n_groups)
        at_sel = mask & (hi == sel_hi[keys])
        lo_eff = jnp.where(at_sel, lo_b, INT32_MAX)
        sel_lo = jax.ops.segment_min(lo_eff, keys, num_segments=n_groups)
    else:
        hi_eff = jnp.where(mask, hi, INT32_MIN)
        sel_hi = jax.ops.segment_max(hi_eff, keys, num_segments=n_groups)
        at_sel = mask & (hi == sel_hi[keys])
        lo_eff = jnp.where(at_sel, lo_b, INT32_MIN)
        sel_lo = jax.ops.segment_max(lo_eff, keys, num_segments=n_groups)
    return sel_hi, sel_lo


# --- DISTINCT via dense presence ------------------------------------------
# COUNT/SUM/AVG(DISTINCT e) over small integer-valued domains: scatter-max a
# [G, V] 0/1 presence matrix, then reduce over V. Presence commutes with the
# mesh exchange (max-merge). SUM(DISTINCT) folds exactly through two f32
# limb matmuls: v = lo7 + (hi << 7); each limb product sum stays < 2^24.

MAX_DISTINCT_SUM_DOMAIN = 1 << 15     # sum/avg: limb exactness bound
MAX_PRESENCE_ELEMS = 1 << 22          # G*V cap (f32 presence <= 16 MiB)


def device_presence(jnp, vals_f32, mask, keys, n_groups, v_domain,
                    gg=None, jax=None):
    """([G, V] presence, invalid_flag). Rows whose value is fractional,
    negative, or >= v_domain raise the flag (host path takes over).
    With ``gg`` the matrix builds as one-hot outer-product matmuls
    (gemm_groupby.segment_count_matrix) instead of a 2-D scatter."""
    vi = vals_f32.astype(jnp.int32)
    in_range = (vi >= 0) & (vi < v_domain) & (
        vi.astype(jnp.float32) == vals_f32)
    invalid = jnp.any(mask & ~in_range)
    ok = mask & in_range
    if gg is not None:
        counts = gg.segment_count_matrix(
            jnp, jax, keys, jnp.clip(vi, 0, v_domain - 1), n_groups,
            v_domain, ok)
        return (counts > 0).astype(jnp.float32), invalid
    idx = keys * np.int32(v_domain) + jnp.clip(vi, 0, v_domain - 1)
    flat = jnp.zeros(n_groups * v_domain, jnp.float32)
    flat = flat.at[idx].max(ok.astype(jnp.float32))
    return flat.reshape(n_groups, v_domain), invalid


def device_mode(jnp, jax, vals_f32, mask, keys, n_groups, v_domain,
                row_idx_f32, gg=None):
    """Per-group MODE over a small integer domain: scatter-add a [G, V]
    count matrix plus a first-occurrence-index matrix (scatter-min), then
    select max count with earliest-first-seen tie-break — the host
    catalog's exact semantics (ops/aggregate.py _agg_mode).

    Returns (mode_value [G] f32, max_count [G] f32, invalid_flag). The two
    matrices commute with the mesh exchange (sum- and min-merge)."""
    counts, first, invalid = mode_matrices(
        jnp, vals_f32, mask, keys, n_groups, v_domain, row_idx_f32,
        gg=gg, jax=jax)
    mode_v, mcount = mode_select(jnp, counts, first, v_domain)
    return mode_v, mcount, invalid


def mode_matrices(jnp, vals_f32, mask, keys, n_groups, v_domain,
                  row_idx_f32, gg=None, jax=None):
    """([G,V] counts, [G,V] first-occurrence row index, invalid flag).
    With ``gg`` the count matrix builds as one-hot matmuls; the
    first-occurrence matrix (a min, not a sum) keeps its scatter."""
    import numpy as _np

    vi = vals_f32.astype(jnp.int32)
    in_range = (vi >= 0) & (vi < v_domain) & (
        vi.astype(jnp.float32) == vals_f32)
    invalid = jnp.any(mask & ~in_range)
    ok = mask & in_range
    idx = keys * _np.int32(v_domain) + jnp.clip(vi, 0, v_domain - 1)
    if gg is not None:
        flat_c = gg.segment_count_matrix(
            jnp, jax, keys, jnp.clip(vi, 0, v_domain - 1), n_groups,
            v_domain, ok)
    else:
        fc = jnp.zeros(n_groups * v_domain, jnp.float32)
        flat_c = fc.at[idx].add(
            ok.astype(jnp.float32)).reshape(n_groups, v_domain)
    flat_f = jnp.full(n_groups * v_domain, _np.float32(_np.inf))
    flat_f = flat_f.at[idx].min(jnp.where(ok, row_idx_f32, _np.inf))
    return (flat_c, flat_f.reshape(n_groups, v_domain), invalid)


def mode_select(jnp, counts, first, v_domain):
    """(mode value [G], max count [G]) from the two matrices."""
    import numpy as _np

    mcount = jnp.max(counts, axis=1)
    cand = counts == mcount[:, None]
    fmin = jnp.min(jnp.where(cand, first, _np.inf), axis=1)
    at = cand & (first == fmin[:, None])
    iota = jnp.arange(v_domain, dtype=jnp.float32)[None, :]
    mode_v = jnp.min(jnp.where(at, iota, _np.float32(v_domain)), axis=1)
    return mode_v, mcount


def presence_reduce(jnp, presence, v_domain):
    """(dcount [G], dsum_lo [G], dsum_hi [G]) from a presence matrix; host
    folds dsum = lo + (hi << 7) exactly."""
    iota = jnp.arange(v_domain, dtype=jnp.int32)
    lo7 = jnp.bitwise_and(iota, 0x7F).astype(jnp.float32)
    hi = jnp.right_shift(iota, 7).astype(jnp.float32)
    dcount = jnp.sum(presence, axis=1)
    dsum_lo = presence @ lo7
    dsum_hi = presence @ hi
    return dcount, dsum_lo, dsum_hi
