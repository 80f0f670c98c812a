"""Key hashing for join / group-by / partitioning.

Host half of ``infera_tpu/ops/hashing.py``: vectorized 64-bit splitmix
hashing over columns in numpy. The device versions of the same hash family
come with the port's device group-by and shuffle tiers.
"""

from __future__ import annotations

import numpy as np

_MULT1 = np.uint64(0xBF58476D1CE4E5B9)
_MULT2 = np.uint64(0x94D049BB133111EB)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _mix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (public-domain constant set)."""
    x = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= _MULT1
        x ^= x >> np.uint64(27)
        x *= _MULT2
        x ^= x >> np.uint64(31)
    return x


def hash_array_host(arr: np.ndarray) -> np.ndarray:
    """Hash one numeric numpy array to uint64."""
    if arr.dtype == object:
        out = np.empty(len(arr), dtype=np.uint64)
        for i, v in enumerate(arr):
            out[i] = np.uint64(hash(v) & 0xFFFFFFFFFFFFFFFF)
        return _mix64_np(out)
    if arr.dtype.kind == "f":
        # canonicalize -0.0 / NaN, then bit-cast
        arr64 = arr.astype(np.float64)
        arr64 = np.where(arr64 == 0.0, 0.0, arr64)
        bits = arr64.view(np.uint64).copy()
        bits[np.isnan(arr64)] = np.uint64(0x7FF8000000000000)
        return _mix64_np(bits)
    if arr.dtype == np.bool_:
        return _mix64_np(arr.astype(np.uint64))
    return _mix64_np(arr.astype(np.int64).view(np.uint64))


def hash_columns_host(cols: list) -> np.ndarray:
    """Combine hashes of several Column objects (validity-aware)."""
    acc = None
    for col in cols:
        h = hash_array_host(col.data)
        valid = col.valid_mask()
        h = np.where(valid, h, np.uint64(0x5555555555555555))
        if acc is None:
            acc = h
        else:
            with np.errstate(over="ignore"):
                acc = _mix64_np(acc ^ (h + _GOLDEN + (acc << np.uint64(6)) + (acc >> np.uint64(2))))
    if acc is None:
        return np.zeros(0, dtype=np.uint64)
    return acc
