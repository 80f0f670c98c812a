"""Billion-row streaming through the port's streaming plan.

Counterpart of ``infera_tpu/testing/billion_stream.py``, with the
generator its docstring names. ``write_table`` writes the table in the
columnar directory format (``columnar/diskfile.py``) chunk by chunk through
``np.memmap``, so RAM never holds it; its formulas make every aggregate
closed-form:

    g = x % 16                 INTEGER
    v = 30000000000 + 7x       BIGINT
    f = (x % 1000) / 8         FLOAT (every value k/8: exact in f32 and f64)

``main`` runs ``select g, count(*) c, sum(v) sv, sum(f) sf from
read_columnar(dir) group by g order by g`` on ``streaming_plan`` (a
memmap scan in ``CHUNK_ROWS`` chunks through the device, int64 sums past
2**53, f64 float sums) and holds all 16 groups to the closed form.

Usage (on the card):
    python -m infera_tpu_torch.testing.billion_stream DIR [ROWS] [--write]
``--write`` writes the table first. One JSON line: rows/s, seconds, chunk
rows, the device's peak allocation over the query, the card's name and
power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROWS = 1_000_000_000
GENERATE_ROWS = 1 << 22   # rows a generator step writes


def write_table(path: str, n: int = ROWS, step: int = GENERATE_ROWS) -> int:
    """Write the n-row table to the columnar directory ``path``; returns
    the bytes of its column files."""
    os.makedirs(path, exist_ok=True)
    cols = (("g", "INTEGER", np.int32), ("v", "BIGINT", np.int64), ("f", "FLOAT", np.float32))
    maps = {name: np.memmap(os.path.join(path, f"{name}.bin"), mode="w+", dtype=dt, shape=(n,))
            for name, _t, dt in cols}
    for start in range(0, n, step):
        x = np.arange(start, min(start + step, n), dtype=np.int64)
        stop = start + len(x)
        maps["g"][start:stop] = x % 16
        maps["v"][start:stop] = 30_000_000_000 + 7 * x
        maps["f"][start:stop] = (x % 1000).astype(np.float32) / np.float32(8.0)
    for m in maps.values():
        m.flush()
    manifest = {"version": 1, "num_rows": n, "columns": [
        {"name": name, "sql_type": t, "width": 0, "scale": 0, "kind": "numeric",
         "file": f"{name}.bin", "dtype": np.dtype(dt).str} for name, t, dt in cols]}
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    return n * sum(np.dtype(dt).itemsize for _n, _t, dt in cols)


def expected(n: int) -> list:
    """The closed-form rows (g, count, sum(v), sum(f)) of the n-row table."""
    rows = []
    for g in range(16):
        cnt = (n - g + 15) // 16   # x = g, g + 16, ... < n
        sx = cnt * g + 16 * (cnt * (cnt - 1) // 2)
        # x % 1000 over x = g + 16k has period lcm(16, 1000) / 16 = 125 in k
        full, rem = divmod(cnt, 125)
        cyc = sum((g + 16 * k) % 1000 for k in range(125))
        tail = sum((g + 16 * k) % 1000 for k in range(rem))
        rows.append((g, cnt, 30_000_000_000 * cnt + 7 * sx, (full * cyc + tail) / 8.0))
    return rows


def check_rows(rows, n: int, rel: float = 1e-9) -> None:
    """Counts and int64 sums exact, float sums within ``rel``."""
    want = expected(n)
    assert len(rows) == len(want), (len(rows), len(want))
    for (g, c, sv, sf), (wg, wc, wsv, wsf) in zip(rows, want):
        assert (g, c, sv) == (wg, wc, wsv), ((g, c, sv), (wg, wc, wsv))
        assert abs(sf - wsf) <= rel * abs(wsf), (g, sf, wsf)


QUERY = ("select g, count(*) c, sum(v) sv, sum(f) sf from read_columnar('{path}') "
         "group by g order by g")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(path: str, n: int = ROWS) -> dict:
    import torch

    from ..sql import Connection
    from ..sql.streaming_plan import CHUNK_ROWS

    conn = Connection()
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = conn.execute(QUERY.format(path=path)).rows
    dt = time.perf_counter() - t0
    assert conn._exec_path == "streaming_plan", conn._exec_path
    check_rows(rows, n)
    out = {
        "metric": "billion_row_streaming_rows_per_s_single_card",
        "rows": n,
        "seconds": dt,
        "rows_per_s": n / dt,
        "path": conn._exec_path,
        "chunk_rows": CHUNK_ROWS,
        "phases": conn._last_phases,
        "device_peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
        "card": card() if cuda else None,
        "exactness": "counts and int64 sums exact past 2**53, f64 float sums within 1e-9, "
                     "all 16 groups against the closed form",
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--write"]
    target = args[0]
    rows_n = int(args[1]) if len(args) > 1 else ROWS
    if "--write" in sys.argv:
        write_table(target, rows_n)
    main(target, rows_n)
