"""Randomized queries through the device tiers against the host.

Each seed makes tables and a list of random queries of one kind and runs
each twice: through ``Connection.execute`` on the port's device (as the
planner routes it) and on the host executor (a second Connection over the
same catalog with both device tiers turned away). The kinds:

- ``agg``: a table of small and wide integers, f32 and f64 columns and a
  column with NaN values; single-table aggregate queries (WHERE, up to two
  GROUP BY keys, one to four aggregates of every family the device plan
  carries) through kernel K2, the torch program or the host;
- ``join``: a fact table joined to a dimension on a key that some fact rows
  miss (INNER, LEFT, FULL), one to three aggregates over either side,
  an optional WHERE and a fact-side GROUP BY of 8 to 4,096 groups, through
  K5, the torch join program or the host;
- ``window``: aggregates over a windowed subquery (every window the
  program computes, its three frames, 0–2 partition keys, an ascending or
  descending order key) that the program fuses, or the host.

Rows must be equal: integers, keys and counts exactly, floats within 1e-3
relative (the reference tests' bound for var/stddev and product; sums
agree far closer), NaN with NaN.

    python -m infera_tpu_torch.testing.plan_fuzz --device cuda --seeds 0 1 2 3

prints one JSON line a seed and kind (the paths taken, the mismatches) and
exits non-zero on a mismatch. ``INFERA_PALLAS_SQL`` switches K2 and K5 as
usual.
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


def make_join_tables(seed: int, n: int) -> dict:
    """The seed's fact table (join key k with unmatched values, fact-side
    keys g8, g100, g600, g4096, f32 v) and dimension (unique keys in a
    random order, f32 w, a small-int cat)."""
    from ..columnar import Column, Table
    from ..columnar import types as T

    rng = np.random.default_rng(seed)
    n_dim = int(rng.integers(50, 2000))
    span = int(n_dim * rng.uniform(1.0, 1.5))
    fact = {"k": (rng.integers(0, span, n), T.BIGINT), "v": (rng.standard_normal(n, np.float32),
                                                             T.FLOAT)}
    for g in (8, 100, 600, 4096):
        fact[f"g{g}"] = (rng.integers(0, g, n), T.BIGINT)
    dim = {"k": (rng.permutation(n_dim), T.BIGINT),
           "w": (rng.standard_normal(n_dim, np.float32), T.FLOAT),
           "cat": (rng.integers(0, 5, n_dim), T.BIGINT)}
    return {name: Table({k: Column(np.ascontiguousarray(v), t) for k, (v, t) in cols.items()})
            for name, cols in (("fact", fact), ("dim", dim))}


JOIN_AGGS = ("count(*)", "count(w)", "sum(v)", "sum(w)", "avg(w)", "avg(v)", "min(w)", "max(w)",
             "min(v)", "max(v)", "sum(v * w)", "sum(coalesce(w, -1.0))")
JOIN_KINDS = ("join", "left join", "full join")
JOIN_WHERES = ("", "where v > 0.3", "where v * 2.0 < 1.0")
JOIN_KEYS = ((), ("g8",), ("g100",), ("g600",), ("g4096",))


def random_join_queries(seed: int, count: int) -> list:
    r = random.Random(seed)
    out = []
    for _ in range(count):
        keys = list(r.choice(JOIN_KEYS))
        items = keys + r.sample(JOIN_AGGS, r.randint(1, 3))
        q = (f"select {', '.join(items)} from fact {r.choice(JOIN_KINDS)} dim "
             f"on fact.k = dim.k {r.choice(JOIN_WHERES)}")
        if keys:
            q += f" group by {keys[0]} order by {keys[0]}"
        out.append(q)
    return out


def make_window_table(seed: int, n: int) -> dict:
    """The seed's table: partition keys p8, p3, an order key k with ties,
    an outer key g and f32 v."""
    from ..columnar import Column, Table
    from ..columnar import types as T

    rng = np.random.default_rng(seed)
    cols = {"p8": rng.integers(0, 8, n), "p3": rng.integers(0, 3, n),
            "k": rng.integers(0, n // 4, n), "g": rng.integers(0, 6, n)}
    tab = {k: Column(np.ascontiguousarray(v), T.BIGINT) for k, v in cols.items()}
    tab["v"] = Column(rng.standard_normal(n, np.float32) * 8, T.FLOAT)
    return {"t": Table(tab)}


WINDOWS = ("row_number()", "rank()", "dense_rank()", "count(*)", "count(v)", "sum(v)", "avg(v)",
           "min(v)", "max(v)")
FRAMES = ("", " rows between unbounded preceding and current row",
          " rows between unbounded preceding and unbounded following")
PARTS = ((), ("p8",), ("p8", "p3"))
OUTER = ("avg(w)", "max(w)", "min(w)", "count(*)", "sum(w)")


def random_window_queries(seed: int, count: int) -> list:
    r = random.Random(seed)
    out = []
    for _ in range(count):
        win, parts = r.choice(WINDOWS), r.choice(PARTS)
        over = f"partition by {', '.join(parts)} " if parts else ""
        if r.random() < 0.8:
            over += f"order by k{r.choice(('', ' desc'))}{r.choice(FRAMES)}"
        aggs = r.sample(OUTER, r.randint(1, 2))
        where = r.choice(("", " where w > 1.0"))
        out.append(f"select g, {', '.join(aggs)} from (select g, {win} over ({over.strip()}) as w "
                   f"from t) sub{where} group by g order by g")
    return out


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


KINDS = {"agg": (lambda seed, n: {"t": make_table(seed, n)}, random_queries),
         "join": (make_join_tables, random_join_queries),
         "window": (make_window_table, random_window_queries)}


def run_seed(seed: int, n: int = 20000, count: int = 40, kind: str = "agg") -> dict:
    """{"seed", "kind", "paths": {path: queries}, "mismatches": [(query, rows,
    host rows)]} over the seed's tables and queries of ``kind`` on the
    port's current device."""
    from ..sql import Connection, device_join_plan, device_plan

    make, queries = KINDS[kind]
    conn = Connection()
    for name, table in make(seed, n).items():
        conn.register_table(name, table)
    host = Connection(conn.catalog)
    paths: dict = {}
    bad = []
    for q in queries(seed, count):
        got = _rows(conn, q)
        paths[conn._exec_path] = paths.get(conn._exec_path, 0) + 1
        saved = device_plan.try_execute_on_device, device_join_plan.try_execute_join_on_device
        device_plan.try_execute_on_device = lambda *a, **k: None
        device_join_plan.try_execute_join_on_device = lambda *a, **k: None
        try:
            want = _rows(host, q)
        finally:
            device_plan.try_execute_on_device, device_join_plan.try_execute_join_on_device = saved
        same = got == want or (
            isinstance(got, list) and isinstance(want, list) and len(got) == len(want)
            and all(len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
                    for a, b in zip(got, want)))
        if not same:
            bad.append((q, str(got)[:400], str(want)[:400]))
    return {"seed": seed, "kind": kind, "paths": paths, "mismatches": bad}


def main(argv=None) -> int:
    import infera_tpu_torch as itt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=150)
    ap.add_argument("--kinds", nargs="+", default=list(KINDS), choices=list(KINDS))
    args = ap.parse_args(argv)
    itt.set_device(args.device)
    failed = False
    for kind in args.kinds:
        for seed in args.seeds:
            res = run_seed(seed, args.rows, args.queries, kind)
            failed |= bool(res["mismatches"])
            print(json.dumps(res))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
