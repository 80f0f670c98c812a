"""Sort operators.

Counterpart of ``infera_tpu/ops/sort.py``: ORDER BY's composite argsort
runs as a host lexsort for small or mixed-type inputs and on the device for
2**15 numeric rows or more (``DEVICE_SORT_THRESHOLD``), as there. The device
path sorts int64 and f64 keys natively with stable ``torch.sort``, one pass
a level, least significant first. ``infera_tpu`` splits each key into f32
levels (x64 is off there), which ties f64 keys past f32's range and keys
that differ only below about 48 bits (ROADMAP R13); the host lexsort below
reads every key as f64, which ties integers past 2**53. The device path
does neither.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device

DEVICE_SORT_THRESHOLD = 1 << 15


def _levels(key: np.ndarray, asc: bool, nulls_first: bool, valid, device) -> list:
    """One key as the device sorts it, most significant level first, in
    the host lexsort's order: a float key is f64 with NULL rows at -inf or
    +inf (descending negated, so NaN stays last), an integer key int64
    (descending by ``~``, exact over the whole range) behind a NULL level."""
    if key.dtype.kind == "f":
        v = torch.from_numpy(np.ascontiguousarray(key, np.float64)).to(device)
        v = v if asc else -v
        if valid is not None:
            v = torch.where(torch.from_numpy(valid).to(device), v,
                            -np.inf if nulls_first else np.inf)
        # one NaN and one zero: the sort's radix route orders bit patterns
        return [torch.where(torch.isnan(v), np.nan, v + 0.0)]
    if key.dtype == np.uint64:
        v = torch.from_numpy(key.view(np.int64) ^ np.int64(-(1 << 63))).to(device)
    else:
        v = torch.from_numpy(key.astype(np.int64)).to(device)
    v = v if asc else ~v
    if valid is None:
        return [v]
    ok = torch.from_numpy(valid).to(device)
    return [(ok if nulls_first else ~ok).to(torch.int8), torch.where(ok, v, 0)]


def argsort_device(keys: list, ascending: list, nulls_first: list,
                   valid_masks: list, head: int | None = None) -> np.ndarray:
    """Composite stable argsort of numeric key columns on the device, in
    the host lexsort's order. ``head``: ORDER BY ... LIMIT k reads back only
    the first k indices."""
    device = get_device()
    levels = []
    for key, asc, nf, valid in zip(keys, ascending, nulls_first, valid_masks):
        levels += _levels(np.asarray(key), asc, nf, valid, device)
    order = torch.arange(len(keys[0]), device=device)
    for lv in reversed(levels):
        order = order[torch.sort(lv[order], stable=True).indices]
    if head is not None:
        order = order[:head]
    return order.cpu().numpy()


def sort_rows(keys: list, ascending: list, nulls_first: list,
              valid_masks: list, n_rows: int,
              head: int | None = None) -> np.ndarray:
    """Composite stable argsort of the key columns in SQL order: on the
    device for 2**15 numeric rows or more, else a host lexsort. ``head``
    truncates the returned permutation (ORDER BY ... LIMIT) so callers
    gather only the surviving rows."""
    if all(k.dtype != object for k in keys) and n_rows >= DEVICE_SORT_THRESHOLD:
        return argsort_device(keys, ascending, nulls_first, valid_masks, head=head)
    encoded = []
    for key, asc, nf, valid in zip(keys, ascending, nulls_first, valid_masks):
        if key.dtype == object:
            ranks = np.argsort(np.argsort([str(v) for v in key]))
            vals = ranks.astype(np.float64)
        else:
            vals = key.astype(np.float64)
        if not asc:
            vals = -vals
        sentinel = -np.inf if nf else np.inf
        if valid is not None:
            vals = np.where(valid, vals, sentinel)
        encoded.append(vals)
    order = np.lexsort(list(reversed(encoded)))
    return order[:head] if head is not None else order
