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
    # the general reader; infera_tpu's native C parser for unquoted numeric
    # bodies is a host speed-up that the port does not carry
    try:
        with open(path, "rb") as fb:
            raw_bytes = fb.read()
    except OSError as e:
        raise SqlError(f"IO Error: {e}")
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
