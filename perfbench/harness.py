"""One run of one cell: the inputs from the seed, the program set up over
them, the closed-loop window, the reference's check, and the metrics.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names
the cell's configuration (``configs/<name>.json``), its traffic mix
(``mixes/<name>.json``) and its metrics (``metrics/<name>.py``); a
configuration names its models' kinds (``models/<kind>.py``).

The program under test is ``infera_tpu_torch``, imported only by
``Program``; the reference imports nothing of it.
"""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import profiler_trace, reference, work

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "infera_tpu")
# the traced part of a --trace 1 window: from 30 % of it, for at most 3 s
TRACE_FROM, TRACE_SHARE, TRACE_MAX_S = 0.3, 0.5, 3.0
LATE_S = 60                 # how long after the window an answer is waited for


def load(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_metric(name: str):
    """The reader ``metrics/<name>.py``: ``read(run)`` gives the number or
    None where the run holds nothing to read. A metric split by cell,
    ``<base>.<part>``, reads as ``metrics/<base>.py`` unless it has a file
    of its own."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    workload: dict
    config: dict
    mix: dict
    metrics: list          # [(BENCHMARK.json entry, reader module)]


def cell(bench: dict, name: str, trace: bool) -> Cell:
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entries = bench["per_layer" if trace else "end_to_end"]
    mine = [m for m in entries if name in m.get("workloads", [name])]
    return Cell(wl, load("configs", wl["config"]), load("mixes", wl["traffic"]),
                [(m, load_metric(m["name"])) for m in mine])


# ---------------------------------------------------------------------- inputs


def make_inputs(config: dict, seed: int, device) -> tuple:
    """(features [F, n] f32, keys [n] int64, {model: params}) from the seed:
    one generator on ``device``, each column group in one call (a one-hot
    group from one uniform draw of which of its columns is 1), the keys as
    the configuration's counts in a seeded order, so every seed has the same
    groups, then each model's weights in the configuration's order; the
    table comes to the host, where the program's catalog keeps it."""
    table = config["table"]
    n, key = table["rows"], table["key"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    parts = []
    for group in table["columns"]:
        if group["draw"] == "standard_normal":
            parts.append(torch.randn((len(group["names"]), n), generator=gen, device=device))
        else:
            level = torch.randint(0, group["count"], (n,), generator=gen, device=device)
            parts.append(torch.nn.functional.one_hot(level, group["count"]).T.float())
    counts = torch.tensor(reference.key_counts(config), device=device)
    g = torch.repeat_interleave(torch.arange(len(counts), device=device), counts)
    g = g[torch.randperm(n, generator=gen, device=device)] + key["first"]
    params = {m["name"]: reference.model_kind(m["kind"]).make(m, gen, device)
              for m in config["models"]}
    features, keys = torch.cat(parts).cpu().numpy(), g.cpu().numpy()
    del parts, g
    return features, keys, params


@dataclass
class Query:
    template: str
    value: object
    t0: float
    t1: float
    rows: list | None
    error: str | None
    path: str
    phases: dict | None

    @property
    def latency_s(self) -> float:
        return self.t1 - self.t0


def sql_of(config: dict, template: dict, value) -> str:
    """The SQL text of a mix template at one parameter value."""
    table = config["table"]
    key = table["key"]["name"]
    pred = template.get("prediction")
    p = None
    if pred is not None:
        spec = next(m for m in config["models"] if m["name"] == pred["model"])
        cols = ", ".join(reference.feature_names(config)[:spec["features"]])
        p = (f"infera_predict('{spec['name']}', {cols})" if pred.get("output") is None else
             f"infera_predict_multi_list('{spec['name']}', {cols})[{pred['output']}]")
    items = [key] + [f"{func}({'*' if expr == '*' else p if expr == 'prediction' else expr})"
                     for func, expr in template["aggregates"]]
    sql = f"select {', '.join(items)} from {table['name']}"
    where = template.get("where")
    if where is not None:
        col = p if where["column"] == "prediction" else where["column"]
        sql += f" where {col} {where['op']} {float(value)!r}"
    return sql + f" group by {key} order by {key}"


def client_plans(mix: dict, seed: int) -> list:
    """Each client's template and its parameter draws: rounds that are each
    a permutation of the template's values, from (seed, client), so every
    seed sends the same set of queries in another order."""
    plans = []
    for entry in mix["clients"]:
        for _ in range(entry["count"]):
            plans.append(entry["template"])
    return [(t, np.random.default_rng([seed % (1 << 63), i])) for i, t in enumerate(plans)]


def values_of(template: dict) -> list:
    where = template.get("where")
    return [None] if where is None else list(where["values"])


def draws(template: dict, rng):
    """Endless parameter values: shuffled rounds of the template's values."""
    vals = values_of(template)
    while True:
        for i in rng.permutation(len(vals)):
            yield vals[i]


# ---------------------------------------------------------------------- the program


class Program:
    """The program under test over the benchmark's inputs: the models loaded
    from the files the benchmark wrote, one Connection a client over one
    Table. ``table_precision`` / ``model_precision`` set the control."""

    def __init__(self, config: dict, features: np.ndarray, keys: np.ndarray, params: dict,
                 tmpdir: Path, n_clients: int, control: dict | None = None):
        import infera_tpu_torch as itt
        from infera_tpu_torch.columnar import Column, Table
        from infera_tpu_torch.columnar import types as T
        from infera_tpu_torch.sql import Connection

        control = control or {}
        self.itt = itt
        table = config["table"]
        if control.get("table_precision") == "bf16":
            features = torch.as_tensor(features).bfloat16().float().numpy()
        cols = {name: Column(np.ascontiguousarray(features[k]), T.FLOAT)
                for k, name in enumerate(reference.feature_names(config))}
        cols[table["key"]["name"]] = Column(np.ascontiguousarray(keys), T.BIGINT)
        self.table = Table(cols)
        for m in config["models"]:
            path = tmpdir / f"{m['name']}.onnx"
            path.write_bytes(reference.model_kind(m["kind"]).onnx_bytes(m, params[m["name"]]))
            itt.load_model(m["name"], str(path),
                           control.get("model_precision", config["precision"]))
        self.conns = []
        for _ in range(n_clients):
            conn = Connection()
            conn.register_table(table["name"], self.table)
            self.conns.append(conn)

    def close(self) -> None:
        self.itt.unload_all_models()
        self.conns.clear()
        self.table = None


def execute(conn, sql: str, label: str) -> tuple:
    """(rows, error, path, phases) of one query, inside a span named after
    its template."""
    with torch.profiler.record_function(label):
        try:
            rows, err = conn.execute(sql).rows, None
        except Exception as e:      # a failed query is counted, not fatal
            rows, err = None, f"{type(e).__name__}: {e}"
    phases = getattr(conn, "_last_phases", None)
    return rows, err, conn._exec_path, dict(phases) if phases else None


# ---------------------------------------------------------------------- the window


def drive(program: Program, config: dict, mix: dict, seed: int, seconds: float,
          trace: bool) -> tuple:
    """The closed loop: each client sends its next query when its last one
    has its rows. Returns (queries, window start, window end, Trace or
    None); queries started before the end all finish and are kept."""
    templates = mix["templates"]
    plans = client_plans(mix, seed)
    out: list = []
    pending: dict = {}          # connection -> the query it waits on
    lock = threading.Lock()
    go = threading.Event()
    bounds = {}

    def client(conn, tname, rng):
        vals = draws(templates[tname], rng)
        go.wait()
        while True:
            value = next(vals)
            sql = sql_of(config, templates[tname], value)
            t0 = time.perf_counter()
            if t0 >= bounds["end"]:
                return
            pending[conn] = (tname, value, t0)
            rows, err, path, phases = execute(conn, sql, tname)
            q = Query(tname, value, t0, time.perf_counter(), rows, err, path, phases)
            with lock:
                out.append(q)
                del pending[conn]

    threads = [threading.Thread(target=client, args=(conn, t, rng), daemon=True)
               for conn, (t, rng) in zip(program.conns, plans)]
    for th in threads:
        th.start()
    t_start = time.perf_counter()
    # a traced window keeps the clients running until the trace has ended
    bounds["end"] = math.inf if trace else t_start + seconds
    go.set()
    tr = None
    if trace:
        time.sleep(TRACE_FROM * seconds)
        win = profiler_trace.Window()
        win.start()
        time.sleep(min(TRACE_MAX_S, TRACE_SHARE * seconds))
        tr = win.stop()
        bounds["end"] = max(t_start + seconds, time.perf_counter())
    time.sleep(max(0.0, bounds["end"] - time.perf_counter()))
    for th in threads:
        th.join(timeout=max(0.0, bounds["end"] + LATE_S - time.perf_counter()))
    with lock:
        # an answer that has not come a minute after the close never came
        out += [Query(t, v, t0, math.inf, None, f"no answer {LATE_S} s after the window",
                      "none", None) for t, v, t0 in pending.values()]
    return out, t_start, bounds["end"], tr


def warm(program: Program, config: dict, mix: dict, seed: int) -> None:
    """Each client's distinct queries once on its own connection, so the
    window compiles, plans and probes nothing."""
    for conn, (tname, _) in zip(program.conns, client_plans(mix, seed)):
        for v in values_of(mix["templates"][tname]):
            rows, err, _, _ = execute(conn, sql_of(config, mix["templates"][tname], v), tname)
            if err is not None:
                raise RuntimeError(f"warm-up of {tname} at {v}: {err}")
    if torch.cuda.is_available():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------- the check


@dataclass
class Checked:
    limits: dict
    values: dict = field(default_factory=dict)
    failed: int = 0
    expected: dict = field(default_factory=dict)     # (template, value) -> Expected

    @property
    def correct(self) -> bool:
        return all(self.values[k] <= self.limits[k] for k in self.limits)


def check(config: dict, mix: dict, queries: list, features, keys, params, device,
          path: str) -> Checked:
    """Every answer against the reference's interval answer of its query:
    a query that raised or whose rows have the wrong shape is a bad answer;
    one that the program served on another path than ``path`` (the mix's:
    the tier whose kernels the cell exists for) is off its path; each is
    failed, and every other answer is held to the configuration's limits."""
    limits = {"bad_answers": 0, "off_path": 0, **config["limits"]}
    res = Checked(limits={k: limits[k] for k in ("bad_answers", "off_path", "count_gap",
                                                 "agg_gap")})
    templates = mix["templates"]
    needed = {(templates[t]["prediction"]["model"], templates[t]["prediction"].get("output"))
              for t in {q.template for q in queries} if "prediction" in templates[t]}
    outs = reference.model_outputs(config, params, features, needed, device)
    for q in queries:
        key = (q.template, q.value)
        if key not in res.expected:
            res.expected[key] = reference.expected(config, templates[q.template], q.value,
                                                   features, keys, outs, device)
    del outs
    bad, off, count_gap, agg_gap = 0, 0, 0.0, 0.0
    for q in queries:
        off += q.error is None and q.path != path
        if q.error is not None:
            wrong, cg, ag = True, math.inf, math.inf
        else:
            wrong, cg, ag = reference.judge(res.expected[(q.template, q.value)], q.rows)
        if wrong:
            bad += 1
        else:
            count_gap, agg_gap = max(count_gap, cg), max(agg_gap, ag)
        if (wrong or (q.error is None and q.path != path) or cg > res.limits["count_gap"]
                or ag > res.limits["agg_gap"]):
            res.failed += 1
    res.values = {"bad_answers": bad, "off_path": off, "count_gap": count_gap,
                  "agg_gap": agg_gap}
    return res


# ---------------------------------------------------------------------- metrics


@dataclass
class Run:
    """What a metric reader sees."""
    config: dict
    mix: dict
    queries: list
    start: float
    end: float
    setup_s: float
    trace: profiler_trace.Trace | None
    least_s: dict          # (template, value) -> least seconds on the card
    table_rows: int

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def completed(self) -> list:
        """Queries that got their rows inside the window."""
        return [q for q in self.queries if q.error is None and q.t1 <= self.end]

    def traced(self) -> list:
        """Queries that got their rows inside the traced window."""
        if self.trace is None:
            return []
        return [q for q in self.queries
                if q.error is None and self.trace.t0 <= q.t1 <= self.trace.t1]


def least_times(config: dict, mix: dict, checked: Checked, peaks: dict) -> dict:
    out = {}
    for (tname, value), exp in checked.expected.items():
        ops, nbytes = work.count(config, mix["templates"][tname], exp.kept_rows, len(exp.keys))
        out[(tname, value)] = work.least_seconds(ops, nbytes, peaks, config["precision"])
    return out


def breakdown(run: Run) -> dict:
    """The device operations with the most time in the traced window, and
    its longest idle gaps named by the templates in flight at their middle."""
    tr = run.trace
    by_op: dict = {}
    for name, _, lo, hi in tr.events:
        by_op[name] = by_op.get(name, 0.0) + (hi - lo)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    for lo, hi in sorted(tr.gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (lo + hi) / 2
        flying = sorted(q.template for q in run.queries if q.t0 <= mid <= q.t1)
        name = "host: " + (" ".join(f"{t}x{flying.count(t)}" for t in sorted(set(flying)))
                           or "no query in flight")
        gaps.append([name, hi - lo])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def run(bench: dict, workload: str, seed: int, seconds: float, trace: bool, t_process: float,
        *, device: str = "cuda", rows: int | None = None, control: dict | None = None,
        tmpdir: Path) -> dict:
    """One run of a cell; returns the result line's object. ``rows``
    overrides the configuration's table size (the CPU tests), ``control``
    switches the configuration's lower precision on (its control runs)."""
    c = cell(bench, workload, trace)
    config = copy.deepcopy(c.config)
    if rows is not None:
        config["table"]["rows"] = rows
    n_clients = sum(e["count"] for e in c.mix["clients"])
    dev = torch.device(device)

    stamps = [time.perf_counter()]
    features, keys, params = make_inputs(config, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    stamps.append(time.perf_counter())
    program = Program(config, features, keys, params, tmpdir, n_clients, control)
    stamps.append(time.perf_counter())
    warm(program, config, c.mix, seed)
    if trace:
        profiler_trace.warm()
    # everything set-up made lives as long as the process: frozen, it is
    # never scanned again by the collections the window's work triggers
    gc.collect()
    gc.freeze()
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    print(f"set-up {setup_s:.3f} s: imports and the card {stamps[0] - t_process:.3f}, inputs "
          f"{stamps[1] - stamps[0]:.3f}, models and catalog {stamps[2] - stamps[1]:.3f}, "
          f"each client's queries once {t_start - stamps[2]:.3f}")
    queries, start, end, tr = drive(program, config, c.mix, seed, seconds, trace)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    paths: dict = {}
    for q in queries:
        paths[q.path] = paths.get(q.path, 0) + 1
    print(f"queries by path: {json.dumps(paths, sort_keys=True)}; window {end - start:.3f} s "
          f"(from {start - t_start:.6f} s after set-up)")
    program.close()
    del program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    checked = check(config, c.mix, queries, features, keys, params, dev, c.mix["path"])
    print(f"reference and comparison: {time.perf_counter() - t_ref:.3f} s, "
          f"{len(checked.expected)} distinct queries")
    peaks = work.card_peaks(torch.cuda.get_device_name(0) if dev.type == "cuda" else "")
    view = Run(config, c.mix, queries, start, end, setup_s, tr,
               least_times(config, c.mix, checked, peaks), config["table"]["rows"])
    metrics = {}
    for entry, reader in c.metrics:
        v = reader.read(view)
        if v is not None:
            metrics[entry["name"]] = {"value": v, "unit": entry["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device_info["power"] = power_limit()
    result = {"correct": checked.correct and bool(queries), "attempted": len(queries),
              "failed": checked.failed, "metrics": metrics, "device": device_info}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = breakdown(view)
    result["checks"] = {k: {"value": checked.values[k], "limit": checked.limits[k]}
                        for k in checked.limits}
    return result


def scrub_environment(cache: Path, tmpdir: Path) -> None:
    """The program's settings at their defaults, its kernel builds in the
    checkout's fixed cache, its own cache under the run's temporary
    directory."""
    for k in list(os.environ):
        if k.startswith("INFERA_"):
            del os.environ[k]
    os.environ["INFERA_CACHE_DIR"] = str(tmpdir / "infera_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
