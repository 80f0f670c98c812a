"""SQL logical types.

The reference rides on DuckDB's type system; its binding accepts FLOAT,
DOUBLE, INTEGER, BIGINT and DECIMAL feature columns
(upstream infera/bindings/infera_extension.cpp:199-227) plus VARCHAR,
BLOB, BOOLEAN and LIST(FLOAT) at the function surface (SURVEY.md §2.2).
This module defines those logical types and the numpy physical mapping used
by the columnar engine; numeric columns promote to device arrays, while
VARCHAR/BLOB/LIST stay host-side (object arrays) and are dictionary-encoded
for device relational ops.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SqlType:
    name: str
    np_dtype: object | None  # numpy dtype for physical storage; None → object
    # decimal parameters (DuckDB DECIMAL(width, scale))
    width: int = 0
    scale: int = 0

    def __str__(self):
        if self.name == "DECIMAL":
            return f"DECIMAL({self.width},{self.scale})"
        return self.name

    @property
    def is_numeric(self) -> bool:
        return self.name in ("TINYINT", "SMALLINT", "INTEGER", "BIGINT",
                             "FLOAT", "DOUBLE", "DECIMAL", "BOOLEAN")

    @property
    def is_integer(self) -> bool:
        return self.name in ("TINYINT", "SMALLINT", "INTEGER", "BIGINT")

    @property
    def is_float(self) -> bool:
        return self.name in ("FLOAT", "DOUBLE")


BOOLEAN = SqlType("BOOLEAN", np.bool_)
TINYINT = SqlType("TINYINT", np.int8)
SMALLINT = SqlType("SMALLINT", np.int16)
INTEGER = SqlType("INTEGER", np.int32)
BIGINT = SqlType("BIGINT", np.int64)
FLOAT = SqlType("FLOAT", np.float32)
DOUBLE = SqlType("DOUBLE", np.float64)
VARCHAR = SqlType("VARCHAR", None)
BLOB = SqlType("BLOB", None)
LIST_FLOAT = SqlType("LIST_FLOAT", None)
SQLNULL = SqlType("NULL", None)


def decimal(width: int, scale: int) -> SqlType:
    """DECIMAL stored as float64; the reference's feature-extraction path
    converts DECIMAL → f32 anyway (infera_extension.cpp:219-222)."""
    return SqlType("DECIMAL", np.float64, width, scale)


_BY_NAME = {
    "BOOLEAN": BOOLEAN, "BOOL": BOOLEAN,
    "TINYINT": TINYINT, "SMALLINT": SMALLINT,
    "INTEGER": INTEGER, "INT": INTEGER, "INT4": INTEGER,
    "BIGINT": BIGINT, "INT8": BIGINT, "LONG": BIGINT,
    "FLOAT": FLOAT, "REAL": FLOAT, "FLOAT4": FLOAT,
    "DOUBLE": DOUBLE, "FLOAT8": DOUBLE,
    "VARCHAR": VARCHAR, "TEXT": VARCHAR, "STRING": VARCHAR,
    "BLOB": BLOB, "BYTEA": BLOB,
}


def type_from_name(name: str, width: int = 0, scale: int = 0) -> SqlType:
    upper = name.upper()
    if upper == "DECIMAL" or upper == "NUMERIC":
        return decimal(width or 18, scale if width else 3)
    t = _BY_NAME.get(upper)
    if t is None:
        raise ValueError(f"unknown type name '{name}'")
    return t


_NUMERIC_ORDER = ["BOOLEAN", "TINYINT", "SMALLINT", "INTEGER", "BIGINT",
                  "DECIMAL", "FLOAT", "DOUBLE"]


def common_numeric_type(a: SqlType, b: SqlType) -> SqlType:
    """Result type for arithmetic/comparison between two numeric types."""
    if a.name == "NULL":
        return b
    if b.name == "NULL":
        return a
    ia, ib = _NUMERIC_ORDER.index(a.name), _NUMERIC_ORDER.index(b.name)
    hi = a if ia >= ib else b
    # int op float → DOUBLE for precision (DuckDB promotes similarly)
    if hi.name == "FLOAT" and (a.is_integer or b.is_integer):
        return FLOAT
    if hi.name == "DECIMAL":
        return decimal(max(a.width, b.width, 18), max(a.scale, b.scale))
    return hi
