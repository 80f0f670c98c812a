"""Device equi-join: the sort-based join in torch ops.

Counterpart of ``infera_tpu/ops/device_join.py``: sort the build side by
key, binary-search the probe side (``torch.searchsorted``), and expand
duplicate matches with a prefix sum and a gather — no hash table, no
scatter. The one host sync is the output cardinality. The tensors live on
``get_device()``: the card unless the caller asked for the CPU. The sort is
stable, as ``jnp.argsort`` is, so the pairs come out in ``infera_tpu``'s
order.

The key encoding (``_encode_keys``, ``narrow_keys32``,
``dict_encode_strings``, ``_device_key_columns``) is numpy, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device


def _encode_keys(cols: list) -> np.ndarray:
    """Encode join key columns into a single int64 array (exact for ints
    that fit 64 bits and for f32/f64 values by bit pattern)."""
    if len(cols) == 1:
        c = cols[0]
        if c.data.dtype.kind in "iub":
            return c.data.astype(np.int64)
        if c.data.dtype.kind == "f":
            # bit-pattern equality == value equality for non-NaN canonical floats
            d = c.data.astype(np.float64)
            d = np.where(d == 0.0, 0.0, d)
            return d.view(np.int64)
    # multi-column: combine via hashing (exactness verified by the caller for
    # pathological collision cases; 64-bit mix collisions are ~2^-64)
    from .hashing import hash_columns_host

    return hash_columns_host(cols).view(np.int64)


def narrow_keys32(*key_arrays: np.ndarray) -> list:
    """Reduce int64 key arrays to a SHARED exact int32 encoding.

    Keys already within int32 range pass through; otherwise a joint
    np.unique rank remap yields collision-free int32 keys (rank order
    preserves key order, so sort-based device paths stay valid)."""
    arrays = [np.ascontiguousarray(a, np.int64) for a in key_arrays]
    lo = min((int(a.min()) for a in arrays if a.size), default=0)
    hi = max((int(a.max()) for a in arrays if a.size), default=0)
    if lo >= -(1 << 31) and hi < (1 << 31):
        return [a.astype(np.int32) for a in arrays]
    allk = np.concatenate(arrays) if len(arrays) > 1 else arrays[0]
    _, inv = np.unique(allk, return_inverse=True)
    inv = inv.astype(np.int32)
    out, off = [], 0
    for a in arrays:
        out.append(inv[off:off + len(a)])
        off += len(a)
    return out


def dict_encode_strings(*arrays: np.ndarray) -> list:
    """Exact shared dictionary encoding of string (object-dtype) key arrays
    → int32 codes (np.unique rank; order-preserving, collision-free). The
    device data path then treats VARCHAR keys like any integer key."""
    sizes = [len(a) for a in arrays]
    allv = np.concatenate([np.asarray(a, object) for a in arrays]) if len(arrays) > 1 \
        else np.asarray(arrays[0], object)
    _, inv = np.unique(allv.astype("U"), return_inverse=True)
    inv = inv.astype(np.int32)
    out, off = [], 0
    for s in sizes:
        out.append(inv[off:off + s])
        off += s
    return out


def _device_key_columns(*col_lists):
    """Per key position, replace object-dtype columns with shared int32
    dictionary-code columns (device-eligible); numeric columns pass through.
    col_lists are parallel lists (e.g. left keys / right keys)."""
    from ..columnar import Column
    from ..columnar import types as T

    out = [list(cols) for cols in col_lists]
    for pos in range(len(col_lists[0])):
        cols = [cl[pos] for cl in col_lists]
        if any(c.data.dtype == object for c in cols):
            codes = dict_encode_strings(*[c.data for c in cols])
            for li, code in enumerate(codes):
                out[li][pos] = Column(code.astype(np.int64), T.BIGINT)
    return out


def _host(*tensors) -> list:
    return [t.cpu().numpy().astype(np.int64) for t in tensors]


def _probe(left_keys: np.ndarray, right_keys: np.ndarray):
    """Sort the build side, search the probe side: (order, lb, cnt) with
    cnt[i] the number of build rows equal to probe key i, starting at
    position lb[i] of the sorted build side."""
    dev = get_device()
    lk = torch.as_tensor(left_keys, device=dev)
    rk = torch.as_tensor(right_keys, device=dev)
    rk_sorted, order = torch.sort(rk, stable=True)
    lb = torch.searchsorted(rk_sorted, lk, side="left")
    ub = torch.searchsorted(rk_sorted, lk, side="right")
    return order, lb, ub - lb


def inner_join_indices_device(left_keys: np.ndarray, right_keys: np.ndarray):
    """Return (li, ri) index arrays of matching pairs, computed on device."""
    order, lb, cnt = _probe(left_keys, right_keys)
    offsets = torch.cumsum(cnt, 0)
    total = int(offsets[-1]) if offsets.shape[0] else 0  # one scalar sync
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    excl = offsets - cnt  # exclusive prefix
    pos = torch.arange(total, device=offsets.device)
    li = torch.searchsorted(offsets, pos, side="right")
    within = pos - excl[li]
    ri = order[lb[li] + within]
    return tuple(_host(li, ri))


def left_join_indices_device(left_keys: np.ndarray, right_keys: np.ndarray):
    """LEFT OUTER join pairs on device: every left row appears; unmatched
    rows carry ri = -1 (NULL marker). Same sort + searchsorted + prefix-sum
    expansion as the inner join, with per-left output count max(cnt, 1).
    The build side must not be empty when the probe side is not
    (``device_join_eligible``)."""
    n_right = len(right_keys)
    order, lb, cnt = _probe(left_keys, right_keys)
    out_cnt = cnt.clamp(min=1)
    offsets = torch.cumsum(out_cnt, 0)
    total = int(offsets[-1]) if offsets.shape[0] else 0
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    if n_right == 0:
        raise ValueError("LEFT join on the device needs a non-empty build side")
    excl = offsets - out_cnt
    pos = torch.arange(total, device=offsets.device)
    li = torch.searchsorted(offsets, pos, side="right")
    within = pos - excl[li]
    matched = within < cnt[li]
    gather = (lb[li] + within).clamp(max=n_right - 1)
    ri = torch.where(matched, order[gather], -1)
    return tuple(_host(li, ri))


def _unmatched_mask_device(probe_keys: np.ndarray, build_keys: np.ndarray) -> np.ndarray:
    """Boolean mask over probe rows with NO equal key on the build side."""
    _order, _lb, cnt = _probe(probe_keys, build_keys)
    return (cnt == 0).cpu().numpy()


def device_join_eligible(lkey_cols: list, rkey_cols: list, n_left: int, n_right: int,
                         kind: str) -> bool:
    """Whether the sort-join takes this join; the host join answers the rest.

    - ``infera_tpu``'s sort-join raises (and falls back to its host join) for
      an outer join whose build side is empty while the preserved side is
      not.
    - It joins on an encoding that its host join does not share (fault R4):
      an integer key and a float key are encoded apart (1 never meets 1.0),
      and NaN float keys share one bit pattern (NaN meets NaN). Such keys go
      to the host join here, which answers as SQL does."""
    if kind in ("LEFT", "FULL"):
        if n_right == 0 and n_left > 0:
            return False
    elif kind == "RIGHT":
        if n_left == 0 and n_right > 0:
            return False
    elif kind != "INNER":
        return False
    for lc, rc in zip(lkey_cols, rkey_cols):
        kinds = {c.data.dtype.kind for c in (lc, rc)}
        if "O" in kinds:
            continue  # dictionary-encoded together
        if "f" in kinds and (kinds - {"f"} or any(np.isnan(c.data).any() for c in (lc, rc))):
            return False
    return True


def device_join_indices(lkey_cols: list, rkey_cols: list, kind: str = "INNER"):
    """SQL-layer entry: equi-join on Column lists; returns (li, ri) numpy
    index arrays where -1 marks the NULL side of an outer row. Handles
    INNER / LEFT / RIGHT / FULL and many-to-many duplicates (prefix-sum
    expansion). VARCHAR keys dictionary-encode (shared across both sides)."""
    lkey_cols, rkey_cols = _device_key_columns(lkey_cols, rkey_cols)
    lk, rk = narrow_keys32(_encode_keys(lkey_cols), _encode_keys(rkey_cols))
    if kind == "INNER":
        return inner_join_indices_device(lk, rk)
    if kind == "LEFT":
        return left_join_indices_device(lk, rk)
    if kind == "RIGHT":
        ri, li = left_join_indices_device(rk, lk)
        return li, ri
    if kind == "FULL":
        li, ri = left_join_indices_device(lk, rk)
        lonely = np.flatnonzero(_unmatched_mask_device(rk, lk))
        if len(lonely):
            li = np.concatenate([li, np.full(len(lonely), -1, np.int64)])
            ri = np.concatenate([ri, lonely.astype(np.int64)])
        return li, ri
    raise ValueError(f"unsupported join kind {kind}")
