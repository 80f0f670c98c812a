"""Columnar data: Column / Table.

TPU-first replacement for DuckDB's DataChunk + Vector
(SURVEY.md §7.1 row 1): a column is a dense array plus a validity mask —
never row-at-a-time boxed Values (the reference's hot-loop cost,
infera_extension.cpp:199-227 ExtractFeatures). Numeric columns can move to the
device as-is; NULL policy is a mask reduction instead of a per-cell branch.

Strings/blobs/lists stay host-side as object arrays; ``dictionary_encode``
produces int32 codes so relational device ops (join/group-by) can run string
keys on the MXU-friendly integer path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import types as T


@dataclass
class Column:
    data: np.ndarray          # physical values (undefined where invalid)
    sql_type: T.SqlType
    validity: np.ndarray | None = None  # bool mask, True = valid; None = all valid

    def __post_init__(self):
        if self.sql_type.np_dtype is not None and self.data.dtype == object:
            self.data = self.data.astype(self.sql_type.np_dtype)

    def __len__(self):
        return len(self.data)

    @property
    def all_valid(self) -> bool:
        return self.validity is None or bool(self.validity.all())

    def valid_mask(self) -> np.ndarray:
        if self.validity is None:
            return np.ones(len(self.data), dtype=bool)
        return self.validity

    def is_null(self, i: int) -> bool:
        return self.validity is not None and not self.validity[i]

    def value(self, i: int):
        """Python value at row i, or None when NULL."""
        if self.is_null(i):
            return None
        v = self.data[i]
        if isinstance(v, np.generic):
            return v.item()
        return v

    def take(self, indices: np.ndarray) -> "Column":
        v = None if self.validity is None else self.validity[indices]
        return Column(self.data[indices], self.sql_type, v)

    def filter(self, mask: np.ndarray) -> "Column":
        v = None if self.validity is None else self.validity[mask]
        return Column(self.data[mask], self.sql_type, v)

    def cast(self, target: T.SqlType) -> "Column":
        """Vectorized cast; replaces the reference's per-cell type switch
        (infera_extension.cpp:211-222)."""
        if target is self.sql_type or (
            target.name == self.sql_type.name and target.np_dtype == self.sql_type.np_dtype
        ):
            return self
        if target.np_dtype is not None:
            if self.data.dtype == object:
                n = len(self.data)
                out = np.zeros(n, dtype=target.np_dtype)
                validity = self.valid_mask().copy()
                for i in range(n):
                    if validity[i]:
                        try:
                            out[i] = target.np_dtype(self.data[i])
                        except (TypeError, ValueError):
                            validity[i] = False
                return Column(out, target, validity)
            data = self.data.astype(target.np_dtype)
            if target.name == "DECIMAL":
                data = np.round(data * (10 ** target.scale)) / (10 ** target.scale)
            return Column(data, target, self.validity)
        # numeric/other → VARCHAR/BLOB
        out = np.empty(len(self.data), dtype=object)
        for i in range(len(self.data)):
            out[i] = None if self.is_null(i) else _to_host(self.data[i], target)
        return Column(out, target, self.validity)

    @staticmethod
    def from_values(values: list, sql_type: T.SqlType) -> "Column":
        n = len(values)
        validity = np.array([v is not None for v in values], dtype=bool)
        if sql_type.np_dtype is not None:
            data = np.zeros(n, dtype=sql_type.np_dtype)
            for i, v in enumerate(values):
                if v is not None:
                    data[i] = v
        else:
            data = np.empty(n, dtype=object)
            for i, v in enumerate(values):
                data[i] = v
        return Column(data, sql_type, None if validity.all() else validity)

    @staticmethod
    def constant(value, sql_type: T.SqlType, n: int) -> "Column":
        if value is None:
            if sql_type.np_dtype is not None:
                data = np.zeros(n, dtype=sql_type.np_dtype)
            else:
                data = np.empty(n, dtype=object)
            return Column(data, sql_type, np.zeros(n, dtype=bool))
        if sql_type.np_dtype is not None:
            data = np.full(n, value, dtype=sql_type.np_dtype)
        else:
            data = np.empty(n, dtype=object)
            data[:] = [value] * n
        return Column(data, sql_type, None)

    def to_pylist(self) -> list:
        return [self.value(i) for i in range(len(self))]

    def dictionary_encode(self) -> tuple[np.ndarray, list]:
        """Return (int32 codes, dictionary). NULLs get code -1."""
        codes = np.empty(len(self.data), dtype=np.int32)
        mapping: dict = {}
        dictionary: list = []
        valid = self.valid_mask()
        for i in range(len(self.data)):
            if not valid[i]:
                codes[i] = -1
                continue
            v = self.data[i]
            key = v.item() if isinstance(v, np.generic) else v
            code = mapping.get(key)
            if code is None:
                code = len(dictionary)
                mapping[key] = code
                dictionary.append(key)
            codes[i] = code
        return codes, dictionary


def _to_host(v, target: T.SqlType):
    if isinstance(v, np.generic):
        v = v.item()
    if target.name == "VARCHAR":
        return format_sql_value(v)
    return v


def format_sql_value(v) -> str:
    """Render a value the way DuckDB casts it to VARCHAR."""
    if isinstance(v, bool) or isinstance(v, np.bool_):
        return "true" if v else "false"
    if isinstance(v, float):
        return format_float(v)
    return str(v)


def format_float(v: float) -> str:
    """DuckDB-style float rendering: no trailing zeros, '.0' for integers."""
    if v != v:
        return "nan"
    if v in (float("inf"), float("-inf")):
        return "inf" if v > 0 else "-inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return f"{v:.1f}"
    return repr(float(np.float64(v)))


@dataclass
class Table:
    """Named, ordered columns with uniform row count."""

    columns: dict = field(default_factory=dict)  # name → Column (ordered)

    def __post_init__(self):
        lens = {len(c) for c in self.columns.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged table: column lengths {lens}")

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    @property
    def names(self) -> list:
        return list(self.columns.keys())

    def column(self, name: str) -> Column:
        return self.columns[name]

    def filter(self, mask: np.ndarray) -> "Table":
        return Table({k: c.filter(mask) for k, c in self.columns.items()})

    def take(self, indices: np.ndarray) -> "Table":
        return Table({k: c.take(indices) for k, c in self.columns.items()})

    def slice(self, start: int, stop: int) -> "Table":
        idx = np.arange(start, min(stop, self.num_rows))
        return self.take(idx)

    def with_column(self, name: str, col: Column) -> "Table":
        cols = dict(self.columns)
        cols[name] = col
        return Table(cols)

    def row(self, i: int) -> tuple:
        return tuple(c.value(i) for c in self.columns.values())

    def to_pylist(self) -> list:
        return [self.row(i) for i in range(self.num_rows)]

    @staticmethod
    def from_pydict(data: dict, sql_types: dict | None = None) -> "Table":
        cols = {}
        for name, values in data.items():
            if isinstance(values, Column):
                cols[name] = values
                continue
            t = (sql_types or {}).get(name)
            if t is None:
                t = infer_sql_type(values)
            cols[name] = Column.from_values(list(values), t)
        return Table(cols)


def infer_sql_type(values) -> T.SqlType:
    if isinstance(values, np.ndarray) and values.dtype != object:
        for t in (T.BOOLEAN, T.TINYINT, T.SMALLINT, T.INTEGER, T.BIGINT, T.FLOAT, T.DOUBLE):
            if t.np_dtype == values.dtype:
                return t
        return T.DOUBLE
    for v in values:
        if v is None:
            continue
        if isinstance(v, bool):
            return T.BOOLEAN
        if isinstance(v, (int, np.integer)):
            return T.INTEGER if -(2**31) <= int(v) < 2**31 else T.BIGINT
        if isinstance(v, (float, np.floating)):
            return T.DOUBLE
        if isinstance(v, (bytes, bytearray)):
            return T.BLOB
        if isinstance(v, str):
            return T.VARCHAR
        if isinstance(v, (list, np.ndarray)):
            return T.LIST_FLOAT
    return T.SQLNULL
