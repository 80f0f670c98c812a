"""pandas interop: DataFrame ⇄ columnar Table.

DuckDB (the reference's host) lets users query pandas DataFrames directly;
this module provides the same on-ramp: ``table_from_pandas(df)`` /
``table_to_pandas(table)``, surfaced as ``Connection.register_table(name,
df)`` (auto-detected) and ``QueryResult.df()``. Zero-copy for numeric
columns without NULLs (the Table wraps the DataFrame's numpy buffers).
"""

from __future__ import annotations

import numpy as np

from . import types as T
from .batch import Column, Table

_DTYPE_MAP = {
    "float32": T.FLOAT,
    "float64": T.DOUBLE,
    "int8": T.TINYINT,
    "int16": T.SMALLINT,
    "int32": T.INTEGER,
    "int64": T.BIGINT,
    "uint8": T.SMALLINT,
    "uint16": T.INTEGER,
    "uint32": T.BIGINT,
    "uint64": T.BIGINT,
    "bool": T.BOOLEAN,
}


def table_from_pandas(df) -> Table:
    """Convert a pandas DataFrame to a Table. Numeric columns map to their
    SQL types (NaN → NULL for floats); everything else becomes VARCHAR
    (None/NaN → NULL)."""
    cols: dict = {}
    for name in df.columns:
        s = df[name]
        dt = str(s.dtype)
        if dt in _DTYPE_MAP:
            data = np.ascontiguousarray(s.to_numpy())
            validity = None
            if data.dtype.kind == "f":
                nan = np.isnan(data)
                if nan.any():
                    validity = ~nan
            cols[str(name)] = Column(data, _DTYPE_MAP[dt], validity)
        elif dt.startswith("Int") or dt.startswith("Float"):  # nullable ext
            mask = s.isna().to_numpy()
            filled = s.fillna(0).to_numpy()
            base = str(np.asarray(filled).dtype)
            cols[str(name)] = Column(
                np.ascontiguousarray(filled),
                _DTYPE_MAP.get(base, T.DOUBLE),
                None if not mask.any() else ~mask,
            )
        else:
            vals = s.tolist()
            data = np.empty(len(vals), object)
            validity = np.ones(len(vals), bool)
            for i, v in enumerate(vals):
                if v is None or (isinstance(v, float) and np.isnan(v)):
                    validity[i] = False
                    data[i] = ""
                else:
                    data[i] = str(v)
            cols[str(name)] = Column(
                data, T.VARCHAR, None if validity.all() else validity)
    return Table(cols)


def table_to_pandas(table: Table):
    """Convert a Table to a pandas DataFrame (NULLs → NaN/None)."""
    import pandas as pd

    out = {}
    for name in table.names:
        col = table.columns[name]
        if col.validity is None:
            out[name] = col.data
        elif col.data.dtype == object:
            vals = [col.value(i) for i in range(len(col))]
            out[name] = vals
        else:
            vals = col.data.astype(np.float64)
            vals = np.where(col.validity, vals, np.nan)
            out[name] = vals
    return pd.DataFrame(out)
