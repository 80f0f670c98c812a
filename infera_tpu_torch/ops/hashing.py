"""Key hashing for join / group-by / partitioning.

Counterpart of ``infera_tpu/ops/hashing.py``: vectorized 64-bit splitmix
hashing over columns, on the host in numpy and on the device in torch ops.
``splitmix64_device(value_bits64_device(x, dtype))`` gives the bits of
``hash_array_host`` for int, f32 and f32-exact f64 values: the device HLL of
``sql/device_plan.py`` depends on it. ``infera_tpu`` emulates the 64-bit
words in 32-bit limbs (x64 is off there); here they are int64 tensors, with
wrapping multiplies and masked logical shifts. ``hash_array_device`` and
``combine_hashes_device`` are ``infera_tpu``'s 32-bit murmur3-style
finisher, bit for bit, as uint32 values held in int64.
"""

from __future__ import annotations

import numpy as np
import torch

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


# --- device half: 64-bit words as int64 tensors ------------------------------

def _signed(c: int) -> int:
    """The uint64 constant ``c`` as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_M1, _M2 = _signed(int(_MULT1)), _signed(int(_MULT2))
_MASK32 = 0xFFFFFFFF


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 words by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64_device(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer of ``_mix64_np`` over int64 words (the
    uint64 bits), multiplies wrapping modulo 2**64: bit-exact with it."""
    x = x ^ _srl(x, 30)
    x = x * _M1
    x = x ^ _srl(x, 27)
    x = x * _M2
    return x ^ _srl(x, 31)


def value_bits64_device(x: torch.Tensor, src_dtype: str) -> torch.Tensor:
    """The int64 words ``hash_array_host`` hashes, for a column whose
    values reached the device as ``x``: a float column (``src_dtype``
    "float32"/"float64"/"f4"/"f8") its float64 bit pattern (widening f32 is
    exact), -0.0 read as +0.0 and every NaN as 0x7FF8000000000000; a bool
    column 0 or 1; an integer column its sign-extended int64."""
    if src_dtype.startswith("float") or src_dtype in ("f4", "f8"):
        v = x.double()
        v = torch.where(v == 0, 0.0, v)
        return torch.where(torch.isnan(v), 0x7FF8000000000000, v.view(torch.int64))
    return x.long()


def _mix32(h: torch.Tensor, steps: tuple) -> torch.Tensor:
    """uint32 shifts and multiplies (``infera_tpu``'s finisher) on int64."""
    for shift, mult in steps:
        h = h ^ (h >> shift)
        if mult:
            h = (h * mult) & _MASK32
    return h


def hash_array_device(x: torch.Tensor) -> torch.Tensor:
    """``infera_tpu``'s device hash: the value's 32-bit pattern (a float as
    f32 with -0.0 read as +0.0, anything else as int32) through a
    murmur3-style finisher; uint32 values in an int64 tensor."""
    if x.is_floating_point():
        xf = x.float()
        h = torch.where(xf == 0, 0.0, xf).view(torch.int32).long() & _MASK32
    else:
        h = x.to(torch.int32).long() & _MASK32
    return _mix32(h, ((16, 0x85EBCA6B), (13, 0xC2B2AE35), (16, 0)))


def combine_hashes_device(hashes: list) -> torch.Tensor:
    """``infera_tpu``'s combine of ``hash_array_device`` hashes (uint32
    arithmetic, as int64)."""
    acc = hashes[0]
    for h in hashes[1:]:
        acc = acc ^ ((h + 0x9E3779B9 + ((acc << 6) & _MASK32) + (acc >> 2)) & _MASK32)
        acc = _mix32(acc, ((16, 0x85EBCA6B), (13, 0)))
    return acc
