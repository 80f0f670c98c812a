"""Randomized aggregate queries through the device tiers against the host.

Each seed makes a table (small and wide integers, f32 and f64 columns, a
column with NaN values) and a list of random single-table aggregate
queries (WHERE, up to two GROUP BY keys, one to four aggregates of every
family the device plan carries) and runs each twice: through
``Connection.execute`` on the port's device (kernel K2, the torch program
or the host, as the planner routes it) and on the host executor (a second
Connection over the same catalog with the device plan turned away). Rows
must be equal: integers, keys and counts exactly, floats within 1e-3
relative (the reference tests' bound for var/stddev and product; sums
agree far closer), NaN with NaN.

    python -m infera_tpu_torch.testing.plan_fuzz --device cuda --seeds 0 1 2 3

prints one JSON line a seed (the paths taken, the mismatches) and exits
non-zero on a mismatch. ``INFERA_PALLAS_SQL`` switches K2 as usual.
"""

from __future__ import annotations

import argparse
import json
import math
import random
import sys

import numpy as np

AGGS = ("count(*)", "sum({f})", "avg({f})", "min({f})", "max({f})", "median({f})",
        "quantile_cont({f}, 0.3)", "quantile_disc({f}, 0.7)", "stddev({f})", "var_pop({f})",
        "count_if({f} > 0)", "bool_and({f} > -3)", "bool_or({f} > 2)",
        "product(1.0 + {f} / 100.0)", "arg_min(k, {f})", "arg_max(g, {f})", "sum(k)", "avg(w)",
        "min(w)", "max(k)", "count(distinct h)", "sum(distinct g)", "mode(h)", "mode(z)",
        "approx_count_distinct({f})", "approx_count_distinct(k)", "count({f})")
FLOATS = ("a", "b", "c", "a * 2.0 + b", "abs(b)", "z")
WHERES = ("", "where a > 0", "where b < 1.0", "where k % 3 = 1", "where c > 10.0",
          "where z between 1 and 3")
KEYS = ((), ("g",), ("g", "h"), ("h", "z"), ("k",))


def make_table(seed: int, n: int):
    """The seed's table: keys g, h, k (small ints), w (ints past 2**24), a
    (f32), b (f64 quarters), c (f32 with 1 % NaN), z (f64 small ints)."""
    from ..columnar import Column, Table
    from ..columnar import types as T

    rng = np.random.default_rng(seed)
    c = rng.standard_normal(n).astype(np.float32)
    c[rng.random(n) < 0.01] = np.nan
    cols = {"g": (rng.integers(0, 7, n), T.BIGINT), "h": (rng.integers(0, 3, n), T.BIGINT),
            "k": (rng.integers(-50, 50, n), T.BIGINT),
            "w": (rng.integers(-2**40, 2**40, n), T.BIGINT),
            "a": (rng.standard_normal(n).astype(np.float32), T.FLOAT),
            "b": (np.round(rng.standard_normal(n) * 4) / 4, T.DOUBLE), "c": (c, T.FLOAT),
            "z": (rng.integers(0, 5, n).astype(np.float64), T.DOUBLE)}
    return Table({k: Column(np.ascontiguousarray(v), t) for k, (v, t) in cols.items()})


def random_queries(seed: int, count: int) -> list:
    r = random.Random(seed)
    out = []
    for _ in range(count):
        keys = list(r.choice(KEYS))
        items = keys + [a.format(f=r.choice(FLOATS)) for a in r.sample(AGGS, r.randint(1, 4))]
        q = f"select {', '.join(items)} from t {r.choice(WHERES)}"
        if keys:
            q += f" group by {', '.join(keys)} order by {', '.join(keys)}"
        out.append(q)
    return out


def _close(x, y) -> bool:
    if isinstance(x, float) and isinstance(y, float):
        if math.isnan(x) or math.isnan(y):
            return math.isnan(x) and math.isnan(y)
        return abs(x - y) <= 1e-3 * abs(y) + 1e-6
    return x == y


def _rows(conn, q):
    from ..errors import OnnxError, SqlError

    try:
        return conn.execute(q).rows
    except (SqlError, OnnxError) as e:  # the user's error is an answer to compare
        return f"{type(e).__name__}: {e}"


def run_seed(seed: int, n: int = 20000, count: int = 40) -> dict:
    """{"seed", "paths": {path: queries}, "mismatches": [(query, rows, host rows)]}
    over the seed's table and queries on the port's current device."""
    from ..sql import Connection, device_plan

    conn = Connection()
    conn.register_table("t", make_table(seed, n))
    host = Connection(conn.catalog)
    paths: dict = {}
    bad = []
    for q in random_queries(seed, count):
        got = _rows(conn, q)
        paths[conn._exec_path] = paths.get(conn._exec_path, 0) + 1
        saved = device_plan.try_execute_on_device
        device_plan.try_execute_on_device = lambda *a, **k: None
        try:
            want = _rows(host, q)
        finally:
            device_plan.try_execute_on_device = saved
        same = got == want or (
            isinstance(got, list) and isinstance(want, list) and len(got) == len(want)
            and all(len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
                    for a, b in zip(got, want)))
        if not same:
            bad.append((q, str(got)[:400], str(want)[:400]))
    return {"seed": seed, "paths": paths, "mismatches": bad}


def main(argv=None) -> int:
    import infera_tpu_torch as itt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=150)
    args = ap.parse_args(argv)
    itt.set_device(args.device)
    failed = False
    for seed in args.seeds:
        res = run_seed(seed, args.rows, args.queries)
        failed |= bool(res["mismatches"])
        print(json.dumps(res))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
