"""CSV import/export for the SQL engine.

The reference rides on DuckDB's readers; this engine provides its own
``read_csv('path')`` table function and ``COPY <table|query> TO 'path'``
statement so real datasets can flow through the inference operators.
Type inference: BIGINT → DOUBLE → VARCHAR per column; empty fields are NULL.
"""

from __future__ import annotations

import csv

import numpy as np

from ..columnar import Column, Table, format_sql_value
from ..columnar import types as T
from ..errors import SqlError


def read_csv(path: str, header: bool = True, delimiter: str = ",") -> Table:
    # native path: an unquoted all-numeric body parses in C
    # (runtime/src/infera_host.cpp infera_csv_parse_numeric); anything the
    # C parser cannot prove numeric goes to the general reader
    try:
        with open(path, "rb") as fb:
            raw_bytes = fb.read()
    except OSError as e:
        raise SqlError(f"IO Error: {e}")
    native_table = _read_csv_native(raw_bytes, header, delimiter)
    if native_table is not None:
        return native_table
    rows = list(csv.reader(
        raw_bytes.decode("utf-8", errors="replace").splitlines(),
        delimiter=delimiter))
    if not rows:
        return Table({})
    if header:
        names = [c.strip() or f"col{i}" for i, c in enumerate(rows[0])]
        data_rows = rows[1:]
    else:
        names = [f"col{i}" for i in range(len(rows[0]))]
        data_rows = rows
    cols: dict = {}
    for j, name in enumerate(names):
        raw = [r[j] if j < len(r) else "" for r in data_rows]
        cols[_dedupe(name, cols)] = _infer_column(raw)
    return Table(cols)


def _read_csv_native(raw: bytes, header: bool, delimiter: str):
    """The C-parsed Table of an unquoted numeric CSV, or None (the general
    reader): a quote in the first 4,096 bytes, a header-only file, or a body
    the C parser refuses."""
    if not raw or b'"' in raw[:4096]:
        return None
    from ..runtime.native import csv_parse_numeric

    if header:
        nl = raw.find(b"\n")
        if nl < 0:
            return None
        head = raw[:nl].rstrip(b"\r").decode("utf-8", errors="replace")
        names = [c.strip() or f"col{i}" for i, c in enumerate(head.split(delimiter))]
        body = raw[nl + 1:]
    else:
        first = raw.split(b"\n", 1)[0].rstrip(b"\r")
        names = [f"col{i}" for i in range(first.count(delimiter.encode()) + 1)]
        body = raw
    if not body:
        return None  # header-only file: the general reader's empty table
    parsed = csv_parse_numeric(body, len(names), delimiter)
    if parsed is None:
        return None
    values, valid, is_float = parsed
    cols: dict = {}
    for j, name in enumerate(names):
        validity = None if valid[j].all() else valid[j]
        if is_float[j]:
            cols[_dedupe(name, cols)] = Column(values[j], T.DOUBLE, validity)
        else:
            cols[_dedupe(name, cols)] = Column(values[j].astype(np.int64), T.BIGINT, validity)
    return Table(cols)


def _dedupe(name: str, existing: dict) -> str:
    base, k = name, 1
    while name in existing:
        name = f"{base}_{k}"
        k += 1
    return name


def _infer_column(raw: list) -> Column:
    vals: list = []
    kind = "int"
    for s in raw:
        s = s.strip()
        if s == "":
            vals.append(None)
            continue
        if kind == "int":
            try:
                vals.append(int(s))
                continue
            except ValueError:
                kind = "float"
                vals = [float(v) if v is not None else None for v in vals]
        if kind == "float":
            try:
                vals.append(float(s))
                continue
            except ValueError:
                kind = "str"
                vals = [repr(v) if isinstance(v, float) and v is not None else
                        (str(v) if v is not None else None) for v in vals]
        vals.append(s)
    if kind == "int":
        return Column.from_values(vals, T.BIGINT)
    if kind == "float":
        return Column.from_values(vals, T.DOUBLE)
    return Column.from_values(vals, T.VARCHAR)


def write_csv(table: Table, path: str, header: bool = True,
              delimiter: str = ",") -> int:
    try:
        f = open(path, "w", newline="")
    except OSError as e:
        raise SqlError(f"IO Error: {e}")
    with f:
        writer = csv.writer(f, delimiter=delimiter)
        if header:
            writer.writerow(table.names)
        for i in range(table.num_rows):
            out = []
            for v in table.row(i):
                if v is None:
                    out.append("")
                elif isinstance(v, float):
                    out.append(repr(v))
                elif isinstance(v, bool):
                    out.append("true" if v else "false")
                else:
                    out.append(format_sql_value(v) if not isinstance(v, (int, str)) else str(v))
            writer.writerow(out)
    return table.num_rows
