"""Device group-id assignment for the hash aggregate.

Counterpart of ``infera_tpu/ops/device_groupby.py``, in torch ops on
``get_device()``: encode the group keys to one int32 key per row (the
device join's encoding, so VARCHAR keys are dictionary codes and a float key
is its bit pattern: every NaN key is one group), sort, mark where the sorted
key changes, prefix-sum to dense ids and invert the permutation. Ids are
dense in sorted-key order, and the sort is stable, as ``jnp.argsort`` is, so
ids and first rows come out as ``infera_tpu``'s do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device
from .device_join import _device_key_columns, _encode_keys, narrow_keys32


def group_ids_device(key_cols: list, n_rows: int) -> tuple:
    """Device analog of aggregate.group_ids_host: (groups[int64],
    first_row_indices)."""
    if n_rows == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    [key_cols] = _device_key_columns(key_cols)  # VARCHAR → dict codes
    [keys32] = narrow_keys32(_encode_keys(key_cols))
    keys = torch.as_tensor(keys32, device=get_device())
    sorted_keys, order = torch.sort(keys, stable=True)
    boundary = torch.ones_like(sorted_keys, dtype=torch.bool)
    boundary[1:] = sorted_keys[1:] != sorted_keys[:-1]
    dense_sorted = torch.cumsum(boundary, 0) - 1
    dense = torch.empty_like(dense_sorted)
    dense[order] = dense_sorted
    # the first row of each group in sorted order is its smallest row id
    firsts = order[boundary]
    return dense.cpu().numpy().astype(np.int64), firsts.cpu().numpy().astype(np.int64)
