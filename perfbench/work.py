"""What a query needs from the card, counted from its shapes and the
reference's row counts, independent of what implements it; the card's
published peaks; and the least time that follows from both.

Counted (a floor, never the most the query could touch):
- operations: each model's ``ops_per_row`` over the rows it must score.
  The MLP scores only the rows the WHERE keeps when the WHERE reads no
  prediction; a WHERE on the prediction scores every row.
- bytes: each column the query reads, once, at the device plan's stored
  width (4 bytes: the f32 table block), plus the group table written once
  (8 bytes an output value).
"""

from __future__ import annotations

import importlib

from . import reference

# Published dense peaks of an H100 (NVIDIA data sheets): f32 on the CUDA
# cores, bf16 and int8 on the tensor cores, and the HBM rate, keyed by a
# word of the card's name; the SXM part is the default.
PEAKS = {
    "PCIe": {"f32": 51e12, "bf16": 756e12, "int8": 1513e12, "bytes": 2.0e12},
    "NVL": {"f32": 60e12, "bf16": 835e12, "int8": 1671e12, "bytes": 3.9e12},
    "SXM": {"f32": 67e12, "bf16": 989e12, "int8": 1979e12, "bytes": 3.35e12},
}
STORED_BYTES = 4          # the device plan's table block is f32
OUT_BYTES = 8


def card_peaks(name: str) -> dict:
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def columns_read(config: dict, template: dict) -> set:
    """The table columns a query reads: the key, the WHERE's column, and
    the model's features."""
    table = config["table"]
    cols = {table["key"]["name"]}
    where = template.get("where")
    if where is not None and where["column"] != "prediction":
        cols.add(where["column"])
    for _, expr in template["aggregates"]:
        if expr not in ("*", "prediction"):
            cols.add(expr)
    pred = template.get("prediction")
    if pred is not None:
        spec = next(m for m in config["models"] if m["name"] == pred["model"])
        cols.update(reference.feature_names(config)[:spec["features"]])
    return cols


def count(config: dict, template: dict, kept_rows: int, groups: int) -> tuple:
    """(operations, bytes) of one query; ``kept_rows`` is what its WHERE
    keeps, ``groups`` the groups it returns; the model kind's
    ``ops_per_row`` counts a row's operations."""
    n = config["table"]["rows"]
    ops = 0
    pred = template.get("prediction")
    if pred is not None:
        spec = next(m for m in config["models"] if m["name"] == pred["model"])
        kind = importlib.import_module(f"perfbench.models.{spec['kind']}")
        where = template.get("where")
        scored = n if where is None or where["column"] == "prediction" else kept_rows
        ops = kind.ops_per_row(spec) * scored
    out = groups * (1 + len(template["aggregates"])) * OUT_BYTES
    return ops, len(columns_read(config, template)) * n * STORED_BYTES + out


def least_seconds(ops: int, nbytes: int, peaks: dict, precision: str) -> float:
    """The larger of the operations over the peak at ``precision`` and the
    bytes over the memory's peak."""
    return max(ops / peaks[precision], nbytes / peaks["bytes"])
