"""Sort operators.

Host half of ``infera_tpu/ops/sort.py``: ORDER BY runs as a host lexsort.
The device argsort for large numeric keys comes with the port's torch-op
device tier.
"""

from __future__ import annotations

import numpy as np


def sort_rows(keys: list, ascending: list, nulls_first: list,
              valid_masks: list, n_rows: int,
              head: int | None = None) -> np.ndarray:
    """Composite stable argsort of the key columns in SQL order. ``head``
    truncates the returned permutation (ORDER BY ... LIMIT) so callers
    gather only the surviving rows."""
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
