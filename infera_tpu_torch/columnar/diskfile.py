"""Out-of-core columnar table files.

A table persists as a directory: ``manifest.json`` plus one raw
native-endian binary file per column (``<name>.bin``, optional
``<name>.valid.bin`` bool mask). Numeric columns read back as read-only
``np.memmap`` views, so a table far larger than RAM scans through the OS
page cache — the analog of the reference's on-disk model cache as "state
that survives restart" (SURVEY.md §5 checkpoint row), extended to data.
VARCHAR columns store a UTF-8 blob + int64 offsets and materialize on read
(documented v1 limitation).

SQL surface: ``COPY t TO 'dir' (FORMAT columnar)`` and
``read_columnar('dir')``; see sql/csv_io.py for the CSV counterparts.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import types as T
from .batch import Column, Table

_MANIFEST = "manifest.json"
_FORMAT_VERSION = 1


def _safe_name(name: str, used: set) -> str:
    base = "".join(c if c.isalnum() or c in "_-" else "_" for c in name) or "col"
    out, k = base, 1
    while out in used:
        out = f"{base}_{k}"
        k += 1
    used.add(out)
    return out


def write_columnar(table: Table, dir_path: str) -> int:
    """Write a Table as a columnar directory; returns the row count."""
    os.makedirs(dir_path, exist_ok=True)
    manifest = {"version": _FORMAT_VERSION, "num_rows": table.num_rows,
                "columns": []}
    used: set = set()
    for name in table.names:
        col = table.columns[name]
        fname = _safe_name(name, used)
        entry = {"name": name, "sql_type": col.sql_type.name,
                 "width": col.sql_type.width, "scale": col.sql_type.scale}
        if col.data.dtype == object:
            vals = ["" if col.is_null(i) else str(col.value(i))
                    for i in range(len(col))]
            blob = b"".join(v.encode("utf-8") for v in vals)
            offsets = np.zeros(len(vals) + 1, np.int64)
            np.cumsum([len(v.encode("utf-8")) for v in vals],
                      out=offsets[1:]) if vals else None
            with open(os.path.join(dir_path, fname + ".str.bin"), "wb") as f:
                f.write(blob)
            offsets.tofile(os.path.join(dir_path, fname + ".off.bin"))
            entry.update(kind="string", file=fname + ".str.bin",
                         offsets=fname + ".off.bin")
        else:
            data = np.ascontiguousarray(col.data)
            data.tofile(os.path.join(dir_path, fname + ".bin"))
            entry.update(kind="numeric", file=fname + ".bin",
                         dtype=data.dtype.str)
        if col.validity is not None:
            np.ascontiguousarray(col.validity, np.bool_).tofile(
                os.path.join(dir_path, fname + ".valid.bin"))
            entry["validity"] = fname + ".valid.bin"
        manifest["columns"].append(entry)
    with open(os.path.join(dir_path, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    return table.num_rows


def read_columnar(dir_path: str) -> Table:
    """Open a columnar directory as a Table. Numeric columns are read-only
    memmaps (out-of-core); string columns materialize."""
    mpath = os.path.join(dir_path, _MANIFEST)
    if not os.path.isfile(mpath):
        raise FileNotFoundError(f"not a columnar table dir: {dir_path}")
    with open(mpath) as f:
        manifest = json.load(f)
    n = int(manifest["num_rows"])
    cols: dict = {}
    for entry in manifest["columns"]:
        if entry["sql_type"] == "DECIMAL":
            sql_type = T.decimal(entry.get("width", 18), entry.get("scale", 3))
        else:
            sql_type = getattr(T, entry["sql_type"], None)
        if not isinstance(sql_type, T.SqlType):
            sql_type = T.DOUBLE
        if entry["kind"] == "string":
            offsets = np.fromfile(os.path.join(dir_path, entry["offsets"]),
                                  np.int64)
            with open(os.path.join(dir_path, entry["file"]), "rb") as f:
                blob = f.read()
            data = np.empty(n, object)
            for i in range(n):
                data[i] = blob[offsets[i]:offsets[i + 1]].decode("utf-8")
        else:
            data = np.memmap(os.path.join(dir_path, entry["file"]), mode="r",
                             dtype=np.dtype(entry["dtype"]), shape=(n,))
        validity = None
        if entry.get("validity"):
            validity = np.memmap(os.path.join(dir_path, entry["validity"]),
                                 mode="r", dtype=np.bool_, shape=(n,))
            validity = np.asarray(validity)
        cols[entry["name"]] = Column(data, sql_type, validity)
    return Table(cols)
