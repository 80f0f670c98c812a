"""Fused device execution of SQL queries: the planner, kernel K2 and the
torch program.

Counterpart of ``infera_tpu/sql/device_plan.py``. For the query shapes the
benchmarks care about — aggregates over a scan of one table with a numeric
WHERE filter, optional GROUP BY over up to 4 integer-valued keys
(mixed-radix combined key), and ``infera_predict`` /
``infera_predict_multi_list(...)[k]`` calls in expressions — the table
lives on the device as one stacked f32 block (``get_table_block``; integer
columns past +-2**24 as an int64 block, ``get_int_block``) and only the
per-group results return to the host. Two tiers run a plan, in
``infera_tpu``'s order:

1. **Kernel K2** (``ops/fused_sql.py``; path ``device_plan_cuda``), where
   ``FS.tier_enabled``: the planner's expressions become postfix programs
   (``_ProgramLowerer``, the counterpart of ``_PallasLowerer``) that the
   kernel interprets per row, every MLP (K2′) and forest (K4) inside it.
   It carries ``infera_tpu``'s Pallas aggregates (``_KERNEL_AGGS``) and
   declines the rest — median, quantiles, approx_count_distinct, a MODE
   that ties, more than 512 groups, a plan over its shared-memory budget,
   a model that is neither an f32/bf16 MLP nor a forest it takes.
2. **The torch program** (``_build_program``; path ``device_plan``),
   ``infera_tpu``'s fused XLA program as eager torch ops on the port's
   device, for every plan K2 declines or with K2 off: ``_Lowerer`` builds
   torch closures with K2's f32 semantics, ``infera_predict`` runs the
   model's graph on the ONNX engine, sums run in f64 and integer
   aggregates in int64 (``sql/int_agg.py``, ``ops/gemm_groupby.py``),
   median and quantiles from one stable sort, the HLL with the host's
   hash bit for bit (``ops/hashing.py``), MODE with the host's tie-break;
   up to ``MAX_GROUPS`` groups. All results come back in one copy.

Windows (``_Lowerer._lower_window``; a windowed subquery that
``sql/window_fusion.py`` flattens into its outer aggregate) run in the
program only: one stable device sort and segmented scans a window
(``ops/window.window_device``); K2 declines them, as ``infera_tpu``'s
Pallas kernel does. The join tier (``sql/device_join_plan.py``) runs its
program through ``_build_program`` too, with a join prologue and
per-aggregate validity.

A key guard that trips in either tier (a fractional key, a key past
f32's exact integers, two keys in one bucket), a NULL-producing group, a
value outside a DISTINCT/MODE domain, a NaN arg order or a window value
that is not finite sends the query to the host executor, as does anything
the planner declines (an integer column past +-2**24 inside an expression,
which ``infera_tpu`` reads as int32: R10), so semantics never regress.

``INFERA_PALLAS_SQL`` switches K2 only, as ``infera_tpu``'s switches its
Pallas kernel (``ops/fused_sql.fused_sql_mode``): unset, K2 is on when the
device is CUDA; "0" turns it off; "1" turns it on, and on the CPU it then
runs K2's plain version (the tests' hook, as interpret mode is for
Pallas). The program runs on the port's device (``get_device()``): the
card by default, the CPU where the caller asks for it.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar import types as T
from ..device import get_device
from ..errors import OnnxError, SqlError
from ..onnx import ml_ops as ML
from ..onnx.fusion import detect_tree
from ..ops.aggregate import hll_estimate_from_hist
from ..ops import fused_sql as FS
from ..ops import gemm_groupby as GG
from ..ops import hashing as H
from ..ops.window import window_device
from ..registry import MODELS
from . import ast as A
from . import int_agg
from . import mesh_plan as MP

# row count below which fusion isn't worth the launch
MIN_DEVICE_ROWS = 1 << 14

_AGG_NAMES = {"count", "sum", "avg", "mean", "min", "max",
              "stddev", "stddev_samp", "stddev_pop",
              "var_samp", "var_pop", "variance", "median", "mode",
              "quantile_cont", "quantile_disc", "quantile",
              "percentile_cont", "percentile_disc",
              "count_if", "countif", "bool_and", "bool_or", "product",
              "arg_min", "arg_max", "min_by", "max_by",
              "approx_count_distinct"}

# quantile family: name -> continuous interpolation? (the program's sort)
_QUANTILE_FAMILY = {"quantile_cont": True, "percentile_cont": True,
                    "quantile_disc": False, "quantile": False,
                    "percentile_disc": False}

# variance family: (ddof, apply_sqrt) — K2's shifted (sum, sum of squares)
# slots, the program's two f64 passes
_VAR_FAMILY = {
    "stddev": (1, True), "stddev_samp": (1, True), "stddev_pop": (0, True),
    "var_samp": (1, False), "variance": (1, False), "var_pop": (0, False),
}

# the agg_plans entries K2 carries (infera_tpu's _PALLAS_OK_AGGS): the core
# slots, then the tail's families b–e
_KERNEL_AGGS = frozenset(
    {"key", "count", "count_star", "sum", "avg", "mean", "min", "max",
     "var", "cif", "band", "bor", "prod", "isum", "iavg",
     "dcount", "dsum", "davg", "argmn", "argmx", "imin", "imax",
     "mode"})
_INT_AGGS = {"isum": "sum", "iavg": "sum", "imin": "min", "imax": "max"}

# DISTINCT/MODE value domains K2 takes (infera_tpu's four 128-value banks)
PALLAS_MAX_DIST_DOMAIN = 512
# block rows of one plan (infera_tpu's PALLAS_MAX_COLS); an int64 column
# counts 8, as infera_tpu stacks it as eight byte-limb rows
PALLAS_MAX_COLS = 64

# group-count cap of the mixed-radix key (static shape requirement)
MAX_GROUPS = 1 << 16


class _Unsupported(Exception):
    pass


def _contains_int_window(e) -> bool:
    """True when the expression contains an integer-valued window (ranking
    or count): a SUM/MIN/MAX over it renders BIGINT on the host, which the
    f32 carrier would demote to DOUBLE."""
    return A.contains_node(
        e, lambda x: isinstance(x, A.WindowFunc) and x.name.lower() in (
            "row_number", "rank", "dense_rank", "ntile", "count"))


def _decoded(attr):
    return attr.decode() if isinstance(attr, bytes) else attr


# --- shared device-resident table block ----------------------------------
# ONE stacked feature-major [C, n] f32 tensor per table on the card: K2 reads
# it directly (programs address its rows), and the key probes evaluate over
# it. No padding: the kernel masks rows >= n itself.

# {(source array ids, n, device): (pinned arrays, block)} — process-global so
# every Connection over the same catalog shares one upload
_TABLE_BLOCK_CACHE: dict = {}


def _int_range(col) -> tuple:
    """(min, max) of an integer column, cached on the column."""
    rng = getattr(col, "_int_range", None)
    if rng is None:
        d = col.data
        rng = (int(d.min()), int(d.max())) if d.size else (0, 0)
        col._int_range = rng
    return rng


def _f32_exact(col) -> bool:
    """False for an f64 column holding a value f32 does not hold exactly
    (cached on the column, as infera_tpu's HLL planner caches it)."""
    d = col.data
    if d.dtype.kind != "f" or d.dtype.itemsize <= 4 or not d.size:
        return True
    exact = getattr(col, "_f32_exact", None)
    if exact is None:
        exact = bool(np.all(d.astype(np.float32).astype(np.float64) == d))
        col._f32_exact = exact
    return exact


def _block_eligible(col) -> bool:
    d = col.data
    if getattr(col, "validity", None) is not None:
        return False
    if d.dtype.kind == "f":
        return True
    if d.dtype.kind in "iu":
        lo, hi = _int_range(col)
        return lo >= -(1 << 24) and hi <= (1 << 24)
    return False


def get_table_block(table, device):
    """(xc [C, n] f32 tensor on ``device``, {column key: row}) over the
    table's block-eligible numeric columns, cached process-wide (source
    arrays pinned in the cache value against id reuse). None when nothing is
    eligible. Aliased keys ("t.f1" and "f1" sharing one array) map to one
    row."""
    n = table.num_rows
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    by_id: dict = {}
    row_map: dict = {}
    for k, c in table.columns.items():
        if not _block_eligible(c):
            continue
        i = by_id.get(id(c.data))
        if i is None:
            i = len(by_id)
            by_id[id(c.data)] = i
        row_map[k] = i
    if not by_id:
        return None
    arrs = [None] * len(by_id)
    for k, i in row_map.items():
        arrs[i] = table.columns[k].data
    bkey = (tuple(id(a) for a in arrs), n, str(device))
    ent = _TABLE_BLOCK_CACHE.get(bkey)
    if ent is None:
        host = np.empty((len(arrs), n), np.float32)
        for i, a in enumerate(arrs):
            host[i] = np.asarray(a, np.float32)
        xc = torch.from_numpy(host).to(device)
        if len(_TABLE_BLOCK_CACHE) >= 4:
            _TABLE_BLOCK_CACHE.pop(next(iter(_TABLE_BLOCK_CACHE)))
        ent = (tuple(arrs), xc)  # the VALUE pins the source arrays
        _TABLE_BLOCK_CACHE[bkey] = ent
    return ent[1], row_map


# {(source array ids, n, device): (pinned arrays, int64 block)} — the integer
# columns an int slot reads, beside _TABLE_BLOCK_CACHE and with its rules
_INT_BLOCK_CACHE: dict = {}


def get_int_block(table, device, keys: list) -> torch.Tensor:
    """[len(keys), n] int64 tensor on ``device`` of the table's integer
    columns ``keys``, in that order, cached process-wide (the source arrays
    pinned in the cache value against id reuse). The f32 table block leaves
    out integers beyond ±2**24 (``_block_eligible``): exactly the columns
    whose sums, minima and maxima need exact int64."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    arrs = [table.columns[k].data for k in keys]
    n = table.num_rows
    bkey = (tuple(id(a) for a in arrs), n, str(device))
    ent = _INT_BLOCK_CACHE.get(bkey)
    if ent is None:
        host = np.empty((len(arrs), n), np.int64)
        for i, a in enumerate(arrs):
            host[i] = a
        if len(_INT_BLOCK_CACHE) >= 4:
            _INT_BLOCK_CACHE.pop(next(iter(_INT_BLOCK_CACHE)))
        ent = (tuple(arrs), torch.from_numpy(host).to(device))  # the VALUE pins the arrays
        _INT_BLOCK_CACHE[bkey] = ent
    return ent[1]


def device_column_array(key: str, block, n: int) -> torch.Tensor:
    """THE device array of one column in the program: its row of the shared
    f32 table block (``get_table_block``), rows [0, n). A column the block
    leaves out (an integer past +-2**24, a column with NULLs) is read only
    by the exact int slots and the HLL (``get_int_block``); anywhere else
    the plan declines it, as infera_tpu's int32 upload would wrap it (R10)."""
    row = None if block is None else block[1].get(key)
    if row is None:
        raise _Unsupported(f"column {key} is not in the table block")
    return block[0][row, :n]


def _full(v: torch.Tensor, n: int) -> torch.Tensor:
    """A closure's value over the n rows (a constant is 0-dim)."""
    return v.expand(n) if v.dim() == 0 else v


class _Lowerer:
    """AST → torch closure over a dict of device columns (``infera_tpu``'s
    ``_Lowerer``): ``fn(cols)`` gives an f32 tensor over the table's rows,
    or a 0-dim one for a constant. The cases of ``lower`` are
    ``infera_tpu``'s, with the semantics K2's programs have
    (``fused_sql.apply_unary``/``apply_binary``): f32 ``/``, floor ``%``,
    casts to an integer type that truncate and stay f32, half-to-even
    ``round``, comparisons as 1.0/0.0. Columns are rows of the f32 table
    block. ``infera_predict`` runs the port's ONNX engine
    (``CompiledOnnxModel._run_graph``) on the stacked ``[n, d]`` features,
    so any model the engine runs can sit inside a plan; a call the plan
    makes twice runs once. A window runs ``_lower_window``."""

    def __init__(self, table: Table, device=None):
        self.table = table
        self.device = device
        self.used_columns: dict = {}
        self.models: dict = {}
        self.has_window = False

    def _column(self, name: str, qualifier):
        key = f"{qualifier}.{name}" if qualifier else name
        col = self.table.columns.get(key)
        if col is None:
            for k in self.table.columns:
                parts = k.split(".")
                if qualifier is not None:
                    # EXACT qualified match only (case-insensitive): a
                    # bare-name fallback here captured OTHER tables'
                    # qualified refs — a correlated subquery's `o.k`
                    # silently bound to the inner `i.k`
                    if len(parts) >= 2 \
                            and parts[0].lower() == qualifier.lower() \
                            and parts[-1].lower() == name.lower():
                        col = self.table.columns[k]
                        key = k
                        break
                elif parts[-1].lower() == name.lower():
                    col = self.table.columns[k]
                    key = k
                    break
        if col is None:
            raise _Unsupported(f"unknown column {name}")
        if not col.sql_type.is_numeric or col.validity is not None:
            raise _Unsupported(f"column {name} not device-eligible")
        self.used_columns[key] = col
        return key

    def col_for_key(self, key: str):
        """The Column a key from ``_column`` names."""
        return self.table.columns[key]

    def _const(self, v: float):
        c = float(np.float32(v))
        dev = self.device
        return lambda cols: torch.full((), c, dtype=torch.float32, device=dev)

    def lower(self, expr: A.Expr):
        """Return fn(cols) -> f32 tensor [n] (or 0-dim)."""
        if isinstance(expr, A.Literal):
            if expr.value is None or isinstance(expr.value, str):
                raise _Unsupported("non-numeric literal")
            return self._const(float(expr.value))
        if isinstance(expr, A.ColumnRef):
            key = self._column(expr.name, expr.table)
            if not _block_eligible(self.col_for_key(key)):
                raise _Unsupported(f"column {key} is past f32's exact integers")
            return lambda cols: cols[key]
        if isinstance(expr, A.Cast):
            tname = expr.type_name.upper()
            if tname not in (
                "FLOAT", "REAL", "DOUBLE", "INTEGER", "INT", "BIGINT", "DECIMAL",
            ):
                raise _Unsupported(f"cast to {expr.type_name}")
            inner = self.lower(expr.operand)
            op = FS.CAST_INT if tname in ("INTEGER", "INT", "BIGINT") else FS.CAST_FLOAT
            return lambda cols: FS.apply_unary(op, inner(cols))
        if isinstance(expr, A.Unary):
            inner = self.lower(expr.operand)
            op = {"-": FS.NEG, "NOT": FS.NOT}.get(expr.op)
            if op is None:
                raise _Unsupported(f"unary {expr.op}")
            return lambda cols: FS.apply_unary(op, inner(cols))
        if isinstance(expr, A.Binary):
            op = FS.BINARY_OPS.get(expr.op)
            if op is None:
                raise _Unsupported(f"binary {expr.op}")
            left, right = self.lower(expr.left), self.lower(expr.right)
            return lambda cols: FS.apply_binary(op, left(cols), right(cols))
        if isinstance(expr, A.Between):
            v, lo, hi = (self.lower(e) for e in (expr.operand, expr.low, expr.high))
            if expr.negated:
                return lambda cols: FS.apply_unary(FS.NOT, FS.between(v(cols), lo(cols), hi(cols)))
            return lambda cols: FS.between(v(cols), lo(cols), hi(cols))
        if isinstance(expr, A.FuncCall):
            name = expr.name.lower()
            if name == "infera_predict":
                return self._lower_predict(expr)
            if name == "list_extract":
                # infera_predict_multi_list(...)[k] — a multi-output model's
                # k-th (1-based) output column, fused into the device plan
                inner, idx = expr.args[0], expr.args[1]
                if (isinstance(inner, A.FuncCall)
                        and inner.name.lower() == "infera_predict_multi_list"
                        and isinstance(idx, A.Literal)
                        and isinstance(idx.value, (int, float))
                        and not isinstance(idx.value, bool)):
                    return self._lower_predict(inner, out_col=int(idx.value) - 1)
                raise _Unsupported("list_extract outside predict_multi_list")
            if name in FS.SCALAR_OPS:
                inner = self.lower(expr.args[0])
                op = FS.SCALAR_OPS[name]
                return lambda cols: FS.apply_unary(op, inner(cols))
            raise _Unsupported(f"function {name}")
        if isinstance(expr, A.WindowFunc):
            return self._lower_window(expr)
        raise _Unsupported(type(expr).__name__)

    # the window names the program computes (infera_tpu's _WIN_OK)
    _WIN_OK = frozenset({"row_number", "rank", "dense_rank", "count",
                         "sum", "avg", "mean", "min", "max"})

    def _lower_window(self, wf: A.WindowFunc):
        """A window's closure (``infera_tpu``'s ``_lower_window``): the
        default RANGE frame (peers), ROWS UNBOUNDED PRECEDING..CURRENT ROW
        and the whole partition; any other frame raises, and the host keeps
        it. Its argument must read float columns only (an integer window
        sum would lose BIGINT exactness in the f32 carrier), its keys
        columns that f32 holds exactly (integers within +-2**24 and f64
        columns of f32 values, so no two of the host's keys meet). It runs
        once an execution however often the plan reads it."""
        name = wf.name.lower()
        if name not in self._WIN_OK:
            raise _Unsupported(f"window {name}")
        self.has_window = True
        frame = wf.frame
        if not wf.order_by:
            fkind = "whole"
        elif frame is None:
            fkind = "default"
        else:
            unit, start, end = frame
            if start == "unbounded_preceding" and end == "current":
                fkind = "default" if unit == "range" else "rows_cur"
            elif start == "unbounded_preceding" and end == "unbounded_following":
                fkind = "whole"
            else:
                raise _Unsupported("window frame")
        if name in ("row_number", "rank", "dense_rank"):
            arg_fn = None
        elif not wf.args:
            if name != "count":
                raise _Unsupported(f"window {name} without argument")
            arg_fn = None
        else:
            self._require_float_refs(wf.args[0])
            arg_fn = self.lower(wf.args[0])
        for e in [*wf.partition_by, *(oi.expr for oi in wf.order_by)]:
            self._require_f32_exact_refs(e)
        part_fns = [self.lower(e) for e in wf.partition_by]
        ord_specs = [(self.lower(oi.expr), oi.ascending) for oi in wf.order_by]
        wf_key = repr(wf)

        def run(cols):
            done = cols.setdefault("__window__", {})
            if wf_key not in done:
                done[wf_key] = _run_window(cols, part_fns, ord_specs, arg_fn, name, fkind)
            return done[wf_key]

        return run

    def _require_float_refs(self, e):
        refs: list = []
        _find_column_refs(e, refs)
        for r in refs:
            t = self.col_for_key(self._column(r.name, r.table)).sql_type
            if not (t.is_float or t.name == "DECIMAL"):
                raise _Unsupported("integer window argument (host path)")

    def _require_f32_exact_refs(self, e):
        refs: list = []
        _find_column_refs(e, refs)
        for r in refs:
            col = self.col_for_key(self._column(r.name, r.table))
            if col.data.dtype.kind in "iu" and col.data.size:
                lo, hi = _int_range(col)
                if lo < -(1 << 24) or hi > (1 << 24):
                    raise _Unsupported("window key beyond f32 exactness")
            elif not _f32_exact(col):
                raise _Unsupported("window key of f64 values f32 does not hold")

    def _lower_predict(self, expr: A.FuncCall, out_col: int | None = None):
        """infera_predict (out_col None → requires a 1-column output) or an
        infera_predict_multi_list element (0-based out_col) through the
        model's graph, which runs once for every element the plan reads."""
        if (not expr.args or not isinstance(expr.args[0], A.Literal)
                or not isinstance(expr.args[0].value, str)):
            raise _Unsupported("infera_predict needs a constant model name")
        model_name = expr.args[0].value
        model = MODELS.get(model_name)
        if model is None:
            raise _Unsupported(f"model {model_name} not loaded at plan time")
        if out_col is not None and out_col < 0:
            raise _Unsupported("list index < 1")
        if torch.device(model.device).type != torch.device(self.device).type:
            raise _Unsupported(f"model {model_name} lives on {model.device}")
        feature_fns = [self.lower(a) for a in expr.args[1:]]
        inner = model.input_shape[1:]
        if inner and all(d > 0 for d in inner) and int(np.prod(inner)) != len(feature_fns):
            raise _Unsupported("feature count mismatch (host path reports it)")
        self.models[model_name] = model
        call = (model_name, id(model), repr(expr.args[1:]))

        def run(cols):
            done = cols["__pred__"]
            if call not in done:
                n = cols["__n__"]
                feats = torch.stack([_full(f(cols), n).float() for f in feature_fns], dim=1)
                done[call] = model._run_graph(feats)[0]
            out = done[call]
            if out_col is not None:
                out = out.reshape(out.shape[0], -1)
                if out_col >= out.shape[1]:
                    raise _Unsupported("list index beyond model output width")
                out = out[:, out_col]
            elif out.dim() > 1:
                if out.shape[1] != 1:
                    raise _Unsupported("multi-output model under infera_predict")
                out = out[:, 0]
            return out.to(torch.float32)

        return run


class _ProgramLowerer(_Lowerer):
    """AST → postfix program (a list of ``(op, arg)``; ``ops/fused_sql.py``
    holds the opcodes): the lowering of K2's plans, counterpart of
    ``infera_tpu``'s ``_PallasLowerer``. The cases of ``lower`` are
    ``_Lowerer``'s, and where it builds a torch closure this emits
    instructions. COL args are column keys until ``resolve`` maps them to
    rows of the table block. ``infera_predict`` lowers to ``PRED j``:
    prediction slot j, run inside the kernel, an MLP slot (K2′) over the
    model's ``mlp_plan`` or a forest slot (K4) over its tree ensemble; one
    slot per distinct call."""

    def __init__(self, table: Table):
        super().__init__(table)
        self.consts: list = []
        self.preds: list = []   # prediction slots (MLP or forest), PRED j's order
        self._slots: dict = {}  # repr of a predict call -> slot index

    def _const(self, v: float) -> list:
        self.consts.append(float(np.float32(v)))
        return [(FS.CONST, len(self.consts) - 1)]

    def lower(self, expr: A.Expr) -> list:
        if isinstance(expr, A.Literal):
            if expr.value is None or isinstance(expr.value, str):
                raise _Unsupported("non-numeric literal")
            return self._const(float(expr.value))
        if isinstance(expr, A.ColumnRef):
            return [(FS.COL, self._column(expr.name, expr.table))]
        if isinstance(expr, A.Cast):
            tname = expr.type_name.upper()
            if tname not in (
                "FLOAT", "REAL", "DOUBLE", "INTEGER", "INT", "BIGINT", "DECIMAL",
            ):
                raise _Unsupported(f"cast to {expr.type_name}")
            inner = self.lower(expr.operand)
            # host casts truncate toward zero; keep the f32 carrier
            op = FS.CAST_INT if tname in ("INTEGER", "INT", "BIGINT") else FS.CAST_FLOAT
            return inner + [(op, 0)]
        if isinstance(expr, A.Unary):
            inner = self.lower(expr.operand)
            if expr.op == "-":
                return inner + [(FS.NEG, 0)]
            if expr.op == "NOT":
                return inner + [(FS.NOT, 0)]
            raise _Unsupported(f"unary {expr.op}")
        if isinstance(expr, A.Binary):
            op = FS.BINARY_OPS.get(expr.op)
            if op is None:
                raise _Unsupported(f"binary {expr.op}")
            return self.lower(expr.left) + self.lower(expr.right) + [(op, 0)]
        if isinstance(expr, A.Between):
            code = (self.lower(expr.operand) + self.lower(expr.low)
                    + self.lower(expr.high) + [(FS.BETWEEN, 0)])
            return code + [(FS.NOT, 0)] if expr.negated else code
        if isinstance(expr, A.FuncCall):
            name = expr.name.lower()
            if name == "infera_predict":
                return self._lower_predict(expr)
            if name == "list_extract":
                # infera_predict_multi_list(...)[k] — a multi-output model's
                # k-th (1-based) output column, fused into the device plan
                inner, idx = expr.args[0], expr.args[1]
                if (isinstance(inner, A.FuncCall)
                        and inner.name.lower() == "infera_predict_multi_list"
                        and isinstance(idx, A.Literal)
                        and isinstance(idx.value, (int, float))
                        and not isinstance(idx.value, bool)):
                    return self._lower_predict(inner, out_col=int(idx.value) - 1)
                raise _Unsupported("list_extract outside predict_multi_list")
            if name in FS.SCALAR_OPS:
                return self.lower(expr.args[0]) + [(FS.SCALAR_OPS[name], 0)]
            raise _Unsupported(f"function {name}")
        if isinstance(expr, A.WindowFunc):
            return self._lower_window(expr)
        raise _Unsupported(type(expr).__name__)

    def _lower_window(self, wf):
        # a window needs a global sort, which the row-local kernel has not;
        # the torch program carries it (infera_tpu's _PallasLowerer declines
        # it the same way)
        raise _Unsupported("window functions stay on the torch program")

    def _lower_predict(self, expr: A.FuncCall, out_col: int | None = None) -> list:
        """Prediction slot for infera_predict (out_col None → requires a
        1-column output) or an infera_predict_multi_list element (0-based
        out_col): K2′ over the model's ``mlp_plan``, else K4 over a
        tree-ensemble graph (``fusion.detect_tree``). One slot per distinct
        call."""
        if (not expr.args or not isinstance(expr.args[0], A.Literal)
                or not isinstance(expr.args[0].value, str)):
            raise _Unsupported("infera_predict needs a constant model name")
        model_name = expr.args[0].value
        model = MODELS.get(model_name)
        if model is None:
            raise _Unsupported(f"model {model_name} not loaded at plan time")
        self.models[model_name] = model
        key = (model_name, id(model), out_col, repr(expr.args[1:]))
        j = self._slots.get(key)
        if j is None:
            plan = getattr(model, "mlp_plan", None)
            if plan is not None:
                slot = self._lower_mlp(expr, model, plan, out_col)
            else:
                tree = detect_tree(model.graph)
                if tree is None:
                    raise _Unsupported("the kernel plan needs an MLP or tree-forest model")
                slot = self._lower_tree(expr, model, tree[0], out_col, is_classifier=tree[1])
            self.preds.append(slot)
            j = len(self.preds) - 1
            self._slots[key] = j
        return [(FS.PRED, j)]

    def _lower_mlp(self, expr, model, plan, out_col) -> FS.MlpSlot:
        precision = getattr(model, "precision", "f32") or "f32"
        if precision not in ("f32", "bf16"):
            raise _Unsupported("the kernel plan needs an f32 or bf16 MLP model")
        params, final_softmax = plan[0], plan[1]
        oc = self._pick_out_col(out_col, params[-1][0].shape[1])
        features = [self.lower(a) for a in expr.args[1:]]
        if len(features) != params[0][0].shape[0]:
            raise _Unsupported("feature count mismatch (host path reports it)")
        return FS.MlpSlot(params=params, final_softmax=bool(final_softmax), out_col=oc,
                          bf16=precision == "bf16", features=features)

    def _lower_tree(self, expr, model, node, out_col, is_classifier=False) -> FS.ForestSlot:
        """K4 slot: the forest of a TreeEnsembleRegressor or -Classifier,
        with ``infera_tpu``'s ``_lower_tree`` declines. A classifier keeps
        its label (argmax-invariant post transforms skip); a regressor its
        column, AVERAGE folded into the leaf weights, optional LOGISTIC."""
        if is_classifier:
            labels_int = node.attr("classlabels_int64s")
            labels_str = node.attr("classlabels_strings")
            n_cls = len(labels_int or labels_str or [])
            if n_cls == 0:
                raise _Unsupported("classifier without class labels")
            post = _decoded(node.attr("post_transform", "NONE"))
            # argmax-invariant transforms only (SOFTMAX_ZERO is not; PROBIT's
            # erfinv is NaN outside [0, 1], where the host's argmax differs)
            if post not in (None, "NONE", "SOFTMAX", "LOGISTIC"):
                raise _Unsupported(f"post_transform {post}")
            if labels_int is not None and any(abs(int(v)) > (1 << 24) for v in labels_int):
                raise _Unsupported("class label beyond f32 exactness")
            return self._lower_tree_tables(
                expr, model, node, out_col, n_out_attr=n_cls, weights_key="class",
                classifier=(labels_int, n_cls), logistic=False, agg="SUM")
        n_targets = int(node.attr("n_targets", 1))
        agg = _decoded(node.attr("aggregate_function", "SUM"))
        if agg not in ("SUM", "AVERAGE", None):
            raise _Unsupported(f"aggregate_function {agg}")
        post = _decoded(node.attr("post_transform", "NONE"))
        if post not in (None, "NONE", "LOGISTIC"):
            raise _Unsupported(f"post_transform {post}")
        return self._lower_tree_tables(
            expr, model, node, out_col, n_out_attr=n_targets, weights_key="target",
            classifier=None, logistic=post == "LOGISTIC", agg=agg)

    def _lower_tree_tables(self, expr, model, node, out_col, *, n_out_attr, weights_key,
                           classifier, logistic, agg) -> FS.ForestSlot:
        ishape = model.input_shape
        d_in = ishape[1] if len(ishape) > 1 and ishape[1] > 0 else None
        if d_in is None:
            d_in = len(expr.args) - 1
        packed = ML._cached_pack(node, n_out_attr, weights_key)
        tables = packed.kernel_forest(d_in)
        if tables is None:
            raise _Unsupported("forest exceeds the strip-packing limits")
        n_out = packed.weights.shape[2]
        # the classifier's OUTPUT is one label column
        oc = self._pick_out_col(out_col, 1 if classifier is not None else n_out)
        features = [self.lower(a) for a in expr.args[1:]]
        if len(features) != d_in:
            raise _Unsupported("feature count mismatch (host path reports it)")
        bvals = node.attr("base_values")
        weights = packed.weights
        bias = 0.0
        if bvals and classifier is None:
            bias = float(bvals[oc])
        if agg == "AVERAGE":
            # the host divides AFTER the base add (ml_ops._tree_regressor)
            weights = weights * np.float32(1.0 / packed.n_trees)
            bias = bias / packed.n_trees
        slot = FS.ForestSlot(node=tables["node"], weights=weights,
                             max_depth=tables["max_depth"], strict=tables["strict"],
                             features=features, out_col=oc, bias=float(np.float32(bias)),
                             logistic=logistic)
        if classifier is not None:
            labels_int, n_cls = classifier
            slot.classifier = True
            slot.out_col = 0
            if bvals:
                cb = np.asarray(bvals, np.float32).reshape(-1)
                if cb.size not in (1, n_out):
                    raise _Unsupported("class base values of another width")
                slot.class_bias = np.ascontiguousarray(np.broadcast_to(cb, (n_out,)))
            slot.binary = n_cls == 2 and n_out == 1
            if labels_int is not None:
                slot.labels = np.asarray(labels_int, np.float32)
        return slot

    @staticmethod
    def _pick_out_col(out_col, d_out):
        if out_col is None:
            if d_out != 1:
                raise _Unsupported("multi-output model under infera_predict")
            return 0
        if out_col < 0 or out_col >= d_out:
            raise _Unsupported("list index beyond model output width")
        return out_col

    def _resolve(self, op, arg, row_map) -> tuple:
        """One COL instruction's column key → its row of the table block."""
        if arg not in row_map:
            raise _Unsupported(f"column {arg} is not in the table block")
        return op, row_map[arg]

    def fused_plan(self, where, keys, sums, mins, maxs, strides, n_groups,
                   row_map, join=None, ints=(), dists=(), args=()) -> FS.FusedPlan:
        """The kernel's plan, COL keys resolved to rows of the table block;
        ``join`` (a ``FusedPlan.join``) makes it a join plan; ``ints``,
        ``dists`` and ``args`` are the tail's slots (``FS.FusedPlan``)."""
        def resolve(code):
            out = [self._resolve(op, arg, row_map) if op == FS.COL else (op, arg)
                   for op, arg in code]
            if FS.stack_depth(out) > FS.MAX_STACK:
                raise _Unsupported("expression deeper than the kernel's stack")
            return out

        preds = [dataclasses.replace(s, features=[resolve(f) for f in s.features])
                 for s in self.preds]
        return FS.FusedPlan(
            where=None if where is None else resolve(where),
            keys=[resolve(c) for c in keys], sums=[resolve(c) for c in sums],
            mins=[resolve(c) for c in mins], maxs=[resolve(c) for c in maxs],
            strides=list(strides), n_groups=n_groups, consts=list(self.consts), preds=preds,
            join=join, ints=list(ints),
            dists=[(resolve(c), v_dom, kind) for c, v_dom, kind in dists],
            args=[(resolve(c), is_min) for c, is_min in args])


def _packed(conn, plan_key, plan: FS.FusedPlan, block_xc, lookup=None,
            dim_xc=None, int_xc=None) -> FS.PackedPlan:
    """The plan (with a join plan's key lookup) on the block's device,
    cached per connection by plan key as (block, packed plan, dim block or
    None, int block or None)."""
    cache = getattr(conn, "_device_plan_cache", None)
    if cache is None:
        cache = {}
        conn._device_plan_cache = cache
    ent = cache.get(plan_key)
    if ent is None:
        ent = (block_xc, FS.pack_plan(plan, block_xc.device, lookup), dim_xc, int_xc)
        if len(cache) >= 16:
            cache.pop(next(iter(cache)))
        cache[plan_key] = ent  # the VALUE pins the blocks its rows address
    return ent[1]


# _try_cuda_fused's answer when a guard of K2 tripped: the host answers
_TRIPPED = object()


def _try_cuda_fused(conn, sel, table, n, n_groups, strides, agg_plans, items_plan,
                    having_aggs, plan_key, block, dist_domains):
    """Lower the fused plan onto K2's slots, as ``infera_tpu``'s
    ``_try_pallas_fused`` lowers it onto its Pallas kernel, and run it.
    Returns the _assemble_result 5-tuple; None when K2 declines the plan
    (an aggregate outside ``_KERNEL_AGGS``, an expression or model it does
    not lower, group count, value domain, column cap, shared-memory budget,
    a MODE that ties in a live group), and the torch program runs it;
    ``_TRIPPED`` when a key reached past f32's exact integers or an arg
    slot met a NaN, and the host executor answers. A kernel that fails to
    build or launch raises."""
    if not 1 <= n_groups <= FS.MAX_GROUPS:
        return None
    if any(p[0] not in _KERNEL_AGGS for p in agg_plans):
        return None
    low = _ProgramLowerer(table)
    sums: list = []
    mins: list = []
    maxs: list = []
    ints: list = []   # (int-block row, kind)
    dists: list = []  # (program, v_dom, "dist" | "mode")
    args: list = []   # (program, is_min)
    int_keys = sorted({payload for pname, payload in agg_plans if pname in _INT_AGGS})
    slot_map: list = []  # per agg_plans entry
    nodes = [node for _k, node in items_plan] + list(having_aggs)
    try:
        where = low.lower(sel.where) if sel.where is not None else None
        keys = [low.lower(g) for g in sel.group_by]
        zero = low._const(0.0)
        for ai, ((pname, payload), node) in enumerate(zip(agg_plans, nodes)):
            if pname == "key":
                slot_map.append(("key", payload))
            elif pname in ("count", "count_star"):
                # device-eligible columns carry no NULLs → count(expr)
                # counts exactly the selected rows
                slot_map.append(("count", None))
            elif pname in _INT_AGGS:
                # exact int64 over a plain integer column: the int block
                ints.append((int_keys.index(payload), _INT_AGGS[pname]))
                slot_map.append((pname, len(ints) - 1))
            elif pname == "var":
                # shifted sum and sum of squares, in f32 as the TPU closures
                centred = low.lower(node.args[0]) + low._const(float(payload[3])) \
                    + [(FS.SUB, 0)]
                sums += [centred, centred + centred + [(FS.MUL, 0)]]
                slot_map.append(("var", len(sums) - 2))
            elif pname in ("dcount", "dsum", "davg", "mode"):
                v_dom = dist_domains.get(ai)
                if v_dom is None or v_dom > PALLAS_MAX_DIST_DOMAIN:
                    return None
                dists.append((low.lower(node.args[0]), v_dom,
                              "mode" if pname == "mode" else "dist"))
                slot_map.append((pname, len(dists) - 1))
            elif pname in ("argmn", "argmx"):
                # the winning row id in the kernel; the host gathers the arg
                args.append((low.lower(node.args[1]), pname == "argmn"))
                slot_map.append((pname, len(args) - 1))
            else:
                v = low.lower(node.args[0])
                truth = v + zero + [(FS.NE, 0)]  # NaN is true, as jnp.asarray(v, bool)
                if pname in ("sum", "avg", "mean"):
                    sums.append(v)
                    slot_map.append((pname, len(sums) - 1))
                elif pname == "cif":
                    sums.append(truth)
                    slot_map.append(("cif", len(sums) - 1))
                elif pname == "prod":
                    # negatives, zeros, and sum of log2|v| over the others
                    sums += [v + zero + [(FS.LT, 0)], v + zero + [(FS.EQ, 0)],
                             truth + v + [(FS.ABS, 0), (FS.LOG2, 0)] + zero + [(FS.SEL, 0)]]
                    slot_map.append(("prod", len(sums) - 3))
                elif pname in ("min", "band"):
                    mins.append(truth if pname == "band" else v)
                    slot_map.append((pname, len(mins) - 1))
                else:
                    maxs.append(truth if pname == "bor" else v)
                    slot_map.append((pname, len(maxs) - 1))
        if len(low.used_columns) + 8 * len(int_keys) > PALLAS_MAX_COLS:
            return None
        xc, row_map = block
        plan = low.fused_plan(where, keys, sums, mins, maxs, strides, n_groups, row_map,
                              ints=ints, dists=dists, args=args)
    except _Unsupported:
        return None
    if not FS.smem_fits(plan):
        return None
    int_xc = get_int_block(table, xc.device, int_keys) if int_keys else None
    packed = _packed(conn, plan_key, plan, xc, int_xc=int_xc)
    res = FS.execute_fused_plan(packed, xc, n, int_xc=int_xc)
    if res is None:
        return _TRIPPED
    results: list = []
    for spec, si in slot_map:
        if spec == "key":
            results.append(np.asarray(res["kmaxs"][si]))
        elif spec == "count":
            results.append(res["count"])
        elif spec in ("sum", "avg", "mean", "cif"):
            results.append(res["sums"][si])  # (f64 sum, 0) pair
        elif spec == "var":
            results.append((res["sums"][si][0], res["sums"][si + 1][0]))
        elif spec == "prod":
            results.append((res["sums"][si][0], res["sums"][si + 1][0]) + res["sums"][si + 2])
        elif spec in ("min", "band"):
            results.append(np.asarray(res["mins"][si]))
        elif spec in ("max", "bor"):
            results.append(np.asarray(res["maxs"][si]))
        elif spec in ("isum", "iavg"):
            results.append((res["ints"][si], res["iests"][si]))
        elif spec in ("imin", "imax"):
            results.append(res["ints"][si])
        elif spec in ("argmn", "argmx"):
            results.append((res["argrids"][si],))
        elif spec == "mode":
            # unique max only: a tie needs the host's first-occurrence
            # tie-break, which the torch program carries; a dead group
            # (count 0) "ties" at 0 and is ignored
            mval, mcount, ties, bad = res["dists"][si]
            if bool(((ties > 1) & (res["count"] > 0)).any()):
                return None
            results.append((mval, mcount, bad))
        elif spec == "dcount":
            dcount, _dsum, bad = res["dists"][si]
            results.append((dcount, bad))
        else:  # dsum / davg
            results.append(res["dists"][si])
    return (results, res["count"], res["kmins"], res["kmaxs"], res["fracs"])


# --- the torch program: infera_tpu's fused XLA program as eager torch ops --

_INT = "#i64"   # the key suffix of a column's int64 block row in the cols dict
_HLL_B = 2048   # registers a group (ops/aggregate._HLL_B)
_HLL_HIST = 55  # register values 0..54


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative int64 values (no float log2, which
    rounds near powers of two)."""
    n = torch.zeros_like(v)
    for shift in (32, 16, 8, 4, 2, 1):
        top = v >> shift
        hit = top > 0
        n = n + hit.long() * shift
        v = torch.where(hit, top, v)
    return n + (v > 0).long()


def _hll_registers(x: torch.Tensor, dtype: str, mask, keys, G: int) -> torch.Tensor:
    """[G, 2048] int64 HLL registers of each group, the host's
    (``ops/aggregate._agg_approx_count_distinct``) bit for bit: the
    splitmix64 hash of the value's host bits, bucket = its low 11 bits,
    register = 54 - bit length of the other 53 (0: no row)."""
    h = H.splitmix64_device(H.value_bits64_device(x, dtype))
    rho = 54 - _bit_length((h >> 11) & ((1 << 53) - 1))
    cell = torch.where(mask, keys * _HLL_B + (h & (_HLL_B - 1)), G * _HLL_B)
    regs = torch.zeros(G * _HLL_B + 1, dtype=torch.int64, device=x.device)
    return regs.scatter_reduce_(0, cell, rho, "amax")[:-1].view(G, _HLL_B)


def _hll_histogram(regs: torch.Tensor) -> torch.Tensor:
    """[G, 55] int64 histogram of each group's registers ``[G, 2048]``."""
    G = regs.shape[0]
    regs = regs.reshape(-1)
    group = torch.arange(G * _HLL_B, device=regs.device) // _HLL_B
    (hist,) = GG.segment_sum_int_exact([torch.ones_like(regs)], group * _HLL_HIST + regs,
                                       G * _HLL_HIST)
    return hist.view(G, _HLL_HIST)


def _hll_hist(x: torch.Tensor, dtype: str, mask, keys, G: int) -> torch.Tensor:
    """[G, 55] int64 histogram of each group's 2048 HLL registers."""
    return _hll_histogram(_hll_registers(x, dtype, mask, keys, G))


def _group_sorted(v: torch.Tensor, slot: torch.Tensor, count: torch.Tensor) -> tuple:
    """The selected rows' values sorted by (group, value) with one stable
    sort, as ``jnp.lexsort((vals, keys))``: (sorted values, each group's
    first position). NaN sorts last in its group, -0.0 ties +0.0."""
    c = torch.where(torch.isnan(v), math.nan, v + 0.0)
    bits = c.view(torch.int32).long() & 0xFFFFFFFF
    order_key = torch.where(bits >= 1 << 31, bits ^ 0xFFFFFFFF, bits | 1 << 31)
    perm = torch.sort(slot * (1 << 32) + order_key, stable=True).indices
    return v[perm], torch.cumsum(count, 0) - count


def _run_window(cols, part_fns, ord_specs, arg_fn, name, fkind) -> torch.Tensor:
    """One window of the program, f32 in row order (``infera_tpu``'s f32
    carrier): its keys and argument evaluated over the rows, then
    ``ops/window.window_device``. A sum, average, minimum or maximum that
    is not finite somewhere adds a trip to ``cols["__trip__"]``: the host
    renders such a minimum or maximum NULL and carries a NaN or infinite
    prefix sum into later partitions (ROADMAP R15), so the host answers."""
    n = cols["__n__"]
    parts = [f(cols) for f in part_fns]
    orders = [f(cols) if asc else -f(cols) for f, asc in ord_specs]
    av = None if arg_fn is None else arg_fn(cols)
    if all(v.dim() == 0 for v in parts + orders + ([] if av is None else [av])):
        raise _Unsupported("window over constants")
    out = window_device([_full(v, n) for v in parts], [_full(v, n) for v in orders],
                        None if av is None else _full(av, n), name, fkind).float()
    if name in ("sum", "avg", "mean", "min", "max"):
        cols.setdefault("__trip__", []).append(~torch.isfinite(out).all())
    return out


def _build_program(where_fn, key_fns, strides, n_groups, agg_plans, dist_domains, n, device,
                   prologue=None, validity=None):
    """``infera_tpu``'s fused program (``sql/device_plan.py`` ``program``)
    as eager torch ops over one device: the WHERE mask, the mixed-radix key
    mod ``n_groups``, the key guards, then one entry per agg_plans entry in
    ``_finalize_agg``'s shapes. Sums run in f64 (no compensated pairs), the
    variance family in two f64 passes, integer aggregates in int64.

    The join tier's program (``infera_tpu``'s ``device_join_plan``
    ``program``) is this one with ``prologue(cols)``, run first: it fills
    the columns it gathers and ``cols["__matched__"]`` and returns the base
    mask (None: every row); and ``validity``, one "all" or "matched" per
    agg_plans entry: a "matched" sum, min or max reads only the rows
    ``__matched__`` keeps and carries their count, in K5's
    ``(sum, comp, count)`` and ``(value, count)`` shapes, and
    "count_matched" is that count alone.

    Returns fn(cols) -> (results, group count, key mins, key maxs,
    fractional-key flags, trip): ``trip`` is set when a key reached past
    f32's exact integers (two keys could share a bucket unseen), an arg
    slot met a NaN (the host lets a NaN win only as its group's first row)
    or a window tripped (``_run_window``); the host executor then
    answers."""
    G = n_groups
    f32 = torch.float32

    def program(cols):
        cols = dict(cols, __n__=n, __pred__={})
        base = None if prologue is None else prologue(cols)
        mask = torch.ones(n, dtype=torch.bool, device=device) if base is None else base
        if where_fn is not None:
            # NaN is true, as jnp.asarray(v, bool)
            mask = mask & (_full(where_fn(cols), n) != 0)
        keys = torch.zeros(n, dtype=torch.int64, device=device)
        trip = torch.zeros((), dtype=torch.bool, device=device)
        raws, fracs = [], []
        for kf, stride in zip(key_fns, strides):
            r = _full(kf(cols), n)
            ri = FS.key_to_int32(r)
            # the int32 wrap of infera_tpu's sum is the same modulo 2**k
            keys = keys + ri * (stride & 0x7FFFFFFF)
            fracs.append((mask & (r != ri.to(f32))).any())
            trip = trip | (mask & (r.abs() >= FS.F32_EXACT)).any()
            raws.append(ri)
        keys = torch.remainder(keys, G)
        slot = torch.where(mask, keys, G)   # G: a row the WHERE drops
        (count,) = GG.segment_sum_int_exact([torch.ones_like(slot)], slot, G)
        guards = [GG.segment_minmax_int32(ri, keys, G, mask) for ri in raws]
        rows = torch.arange(n, dtype=torch.int64, device=device)
        matched: list = []   # (slot of the rows __matched__ keeps, their count)

        def matched_slot():
            if not matched:
                ms = torch.where(mask & cols["__matched__"], keys, G)
                matched.append((ms, GG.segment_sum_int_exact([torch.ones_like(ms)], ms, G)[0]))
            return matched[0]

        outs = []
        for ai, (name, fn) in enumerate(agg_plans):
            if name == "key":
                outs.append(guards[fn][1])
                continue
            if name in ("count", "count_star"):
                # device-eligible columns carry no NULLs
                outs.append(count)
                continue
            if name == "count_matched":
                outs.append(matched_slot()[1])
                continue
            if name in ("isum", "iavg"):
                outs.append(int_agg.device_limb_sums(cols[fn + _INT], mask, keys, G))
                continue
            if name in ("imin", "imax"):
                outs.append(int_agg.device_lex_minmax(cols[fn + _INT], mask, keys, G,
                                                      name == "imin"))
                continue
            if name == "hll":
                ckey, dt = fn
                x = cols[ckey] if dt.startswith("float") else cols[ckey + _INT]
                outs.append(_hll_hist(x, dt, mask, keys, G))
                continue
            vfn = fn[0] if name in ("var", "quantile", "argmn", "argmx") else fn
            v = _full(vfn(cols), n)
            if validity is not None and validity[ai] == "matched":
                # a dropped row's gathers read dim row 0, maybe a NaN: the
                # slot drops it rather than multiplying it by 0
                ms, mcount = matched_slot()
                if name in ("sum", "avg", "mean"):
                    outs.append((GG.segment_sum(v, ms, G), 0.0, mcount))
                else:
                    (mn,), (mx,) = GG.segment_minmax([v], ms, G)
                    outs.append((mn if name == "min" else mx, mcount))
                continue
            if name in ("sum", "avg", "mean"):
                outs.append((GG.segment_sum(v, slot, G), 0.0))
            elif name == "var":
                # two passes in f64: a constant group's deviations are 0
                v = v.double()
                mean = GG.segment_sum(v, slot, G) / count.clamp(min=1)
                d = v - mean[keys]
                outs.append(tuple(GG.segment_sum([d, d * d], slot, G)))
            elif name in ("median", "quantile"):
                svals, start = _group_sorted(v, slot, count)

                def at(r):
                    return svals[(start + r.clamp(min=0)).clamp(0, n - 1)]

                if name == "median":
                    outs.append((at((count - 1) // 2), at(count // 2)))
                elif fn[2]:   # continuous: (floor value, ceil value, fraction)
                    pos = fn[1] * (count.double() - 1.0)
                    lo = torch.floor(pos).long()
                    outs.append((at(lo), at(torch.minimum(lo + 1, count - 1)),
                                 pos - lo.double()))
                else:         # discrete: the ceil(q*n)-1 element
                    outs.append((at(torch.ceil(fn[1] * count.double()).long() - 1),))
            elif name == "cif":
                outs.append((GG.segment_sum(v != 0, slot, G), 0.0))
            elif name in ("band", "bor", "min", "max"):
                if name in ("band", "bor"):
                    v = (v != 0).to(f32)
                (mn,), (mx,) = GG.segment_minmax([v], slot, G)
                outs.append(mn if name in ("band", "min") else mx)
            elif name == "prod":
                # negatives, zeros, and the sum of log2|v| over the others
                lv = torch.where(v != 0, torch.log2(v.double().abs()), 0.0)
                outs.append(tuple(GG.segment_sum([v < 0, v == 0, lv], slot, G)) + (0.0,))
            elif name in ("argmn", "argmx"):
                # the smallest row id at the extreme (K2 d's word order)
                is_min = name == "argmn"
                nan = torch.isnan(v)
                trip = trip | (mask & nan).any()
                empty = torch.iinfo(torch.int64).max if is_min else torch.iinfo(torch.int64).min
                w = torch.where(nan, empty, FS.arg_words(v, rows, is_min))
                best = GG.segment_extreme_int64(w, slot, G, None, is_min)
                low = best & ((1 << FS.ROW_BITS) - 1)
                rid = low if is_min else (1 << FS.ROW_BITS) - 1 - low
                outs.append((torch.where(best == empty, -1, rid),))
            elif name == "mode":
                outs.append(int_agg.device_mode(v, mask, keys, G, dist_domains[ai], rows))
            else:  # dcount / dsum / davg
                pres, bad = int_agg.device_presence(v, mask, keys, G, dist_domains[ai])
                dcount, dsum = int_agg.presence_reduce(pres, dist_domains[ai])
                outs.append((dcount, bad) if name == "dcount" else (dcount, dsum, bad))
        for t in cols.get("__trip__", ()):
            trip = trip | t
        return (outs, count, [g[0] for g in guards], [g[1] for g in guards], fracs, trip)

    return program


def _to_host(tree):
    """Every tensor of a nested list/tuple structure read back in ONE
    device-to-host copy (each leaf's bits as int64, concatenated), the
    structure rebuilt with numpy arrays of the leaves' dtypes."""
    leaves: list = []

    def flat(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                flat(y)

    flat(tree)
    words = []
    for t in leaves:
        t = t.reshape(-1)
        if t.is_floating_point():
            t = t.double().view(torch.int64)
        words.append(t.long())
    host = torch.cat(words).cpu().numpy() if words else np.zeros(0, np.int64)
    it = iter(leaves)
    pos = 0

    def build(x):
        nonlocal pos
        if isinstance(x, torch.Tensor):
            t = next(it)
            a = host[pos:pos + t.numel()]
            pos += t.numel()
            if t.is_floating_point():
                a = a.view(np.float64).astype(str(t.dtype).replace("torch.", ""))
            elif t.dtype == torch.bool:
                a = a != 0
            return a.reshape(tuple(t.shape))
        if isinstance(x, (list, tuple)):
            return type(x)(build(y) for y in x)
        return x

    return build(tree)


def _having_supported(expr: A.Expr) -> bool:
    """HAVING predicates the device path handles: aggregate calls, numeric
    literals, and arithmetic/comparison/boolean combinators (no bare column
    refs — the host path keeps those)."""
    if isinstance(expr, A.Literal):
        return expr.value is None or not isinstance(expr.value, str)
    if isinstance(expr, A.FuncCall):
        return expr.name.lower() in _AGG_NAMES
    if isinstance(expr, A.Unary):
        return expr.op in ("-", "NOT") and _having_supported(expr.operand)
    if isinstance(expr, A.Binary):
        return (expr.op in ("+", "-", "*", "/", "%", "=", "<>", "<", "<=",
                            ">", ">=", "AND", "OR")
                and _having_supported(expr.left)
                and _having_supported(expr.right))
    if isinstance(expr, A.Between):
        return (_having_supported(expr.operand)
                and _having_supported(expr.low)
                and _having_supported(expr.high))
    return False


def _eval_having(expr: A.Expr, agg_arrays: dict) -> np.ndarray:
    """Evaluate the HAVING predicate over per-group numpy arrays
    (agg_arrays maps id(agg node) → np array)."""
    if isinstance(expr, A.Literal):
        return np.asarray(expr.value)
    if isinstance(expr, A.FuncCall):
        return agg_arrays[id(expr)]
    if isinstance(expr, A.Unary):
        v = _eval_having(expr.operand, agg_arrays)
        return np.logical_not(v) if expr.op == "NOT" else -v
    if isinstance(expr, A.Between):
        v = _eval_having(expr.operand, agg_arrays)
        lo = _eval_having(expr.low, agg_arrays)
        hi = _eval_having(expr.high, agg_arrays)
        res = (v >= lo) & (v <= hi)
        return np.logical_not(res) if expr.negated else res
    l_ = _eval_having(expr.left, agg_arrays)
    r_ = _eval_having(expr.right, agg_arrays)
    ops = {"+": np.add, "-": np.subtract, "*": np.multiply,
           "/": np.divide, "%": np.mod,
           "=": np.equal, "<>": np.not_equal, "<": np.less,
           "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
           "AND": np.logical_and, "OR": np.logical_or}
    return ops[expr.op](l_, r_)


def _find_column_refs(expr: A.Expr, out: list):
    if isinstance(expr, A.ColumnRef):
        out.append(expr)
        return
    for attr in ("operand", "left", "right", "low", "high"):
        child = getattr(expr, attr, None)
        if isinstance(child, A.Expr):
            _find_column_refs(child, out)
    if isinstance(expr, A.FuncCall):
        for a in expr.args:
            if isinstance(a, A.Expr):
                _find_column_refs(a, out)


def _group_keys_int32_safe(lowerer, group_by) -> bool:
    """Group keys combine as int32: an int64/uint64 column with values
    outside int32 would alias mod 2^32, which slips past the per-bucket
    collision guard (it compares post-truncation values). Probe referenced
    wide-integer columns host-side; out of range → host path."""
    for g in group_by:
        refs: list = []
        _find_column_refs(g, refs)
        for e in refs:
            try:
                key = lowerer._column(e.name, e.table)
            except _Unsupported:
                return False
            col = lowerer.col_for_key(key)
            d = col.data
            if d.dtype.kind in "iu" and d.dtype.itemsize > 4 and d.size:
                lo, hi = _int_range(col)
                if lo < -(1 << 31) or hi >= (1 << 31):
                    return False
    return True


def _find_aggs(expr: A.Expr, out: list):
    if isinstance(expr, A.FuncCall) and expr.name.lower() in _AGG_NAMES:
        out.append(expr)
        return
    for attr in ("operand", "left", "right", "low", "high"):
        child = getattr(expr, attr, None)
        if isinstance(child, A.Expr):
            _find_aggs(child, out)
    if isinstance(expr, A.FuncCall):
        for a in expr.args:
            if isinstance(a, A.Expr):
                _find_aggs(a, out)


def _finalize_agg(pname, payload, res, group_count):
    """Fold one device aggregate's raw output into final host values.

    Returns (values [G], sql_type, badmask | None) — badmask marks groups
    whose result is undefined (var with count <= ddof, avg or min of 0
    rows); the caller falls back to the host path when a LIVE group is bad.
    Returns None for host fallback (DISTINCT/MODE invalid flag, iavg
    overflow); raises SqlError for genuine SUM(BIGINT) overflow, the host's
    own rule. The branches of ``infera_tpu``'s ``_finalize_agg`` on the
    port's native results (int64 in place of byte limbs and 16-bit words),
    with the outer join's matched-validity forms."""
    empty = np.asarray(group_count) == 0
    if pname in ("count", "count_star", "count_matched"):
        return np.asarray(res).astype(np.int64), T.BIGINT, None
    if pname == "cif":
        s64 = np.asarray(res[0], np.float64) + np.asarray(res[1], np.float64)
        return np.rint(s64).astype(np.int64), T.BIGINT, None
    if pname in ("band", "bor"):
        # the and/or distinction lives in the min-vs-max slot upstream
        return np.asarray(res, np.float64) >= 0.5, T.BOOLEAN, empty
    if pname == "prod":
        neg, zero, ls, lc = (np.asarray(a, np.float64) for a in res)
        sign = np.where(np.rint(neg).astype(np.int64) % 2 == 1, -1.0, 1.0)
        with np.errstate(over="ignore"):
            # sign * 0.0 keeps IEEE's signed zero, as the host's product
            vals = np.where(zero > 0.5, sign * 0.0, sign * np.exp2(ls + lc))
        return vals, T.DOUBLE, empty
    if pname in ("argmn", "argmx"):
        _code, acol = payload
        rid = np.asarray(res[0]).astype(np.int64)
        bad = (rid < 0) | (rid >= len(acol.data))
        vals = np.empty(len(rid), dtype=object)
        for i, r in enumerate(rid):
            vals[i] = acol.value(int(r)) if not bad[i] else None
        return vals, acol.sql_type, bad
    if pname in ("isum", "iavg"):
        total, est = np.asarray(res[0], np.int64), np.asarray(res[1], np.float64)
        if pname == "isum":
            if (est >= 2.0**62).any():
                raise SqlError("Out of Range Error: overflow in SUM(BIGINT)")
            return total, T.BIGINT, empty
        if (est >= 2.0**62).any():
            return None  # exact int64 sum impossible → host path
        c = np.asarray(group_count, np.float64)
        return total.astype(np.float64) / np.where(c == 0, 1.0, c), T.DOUBLE, empty
    if pname in ("imin", "imax"):
        return np.asarray(res, np.int64), T.BIGINT, empty
    if pname == "var":
        _code, ddof, sq, _shift = payload
        s = np.asarray(res[0], np.float64)
        s2 = np.asarray(res[1], np.float64)
        c = np.asarray(group_count, np.float64)
        bad = c <= ddof
        var = (s2 - s * s / np.where(c == 0, 1.0, c)) / np.where(bad, 1.0, c - ddof)
        var = np.maximum(var, 0.0)
        return (np.sqrt(var) if sq else var), T.DOUBLE, bad
    if pname == "median":
        lo, hi = res
        vals = (np.asarray(lo, np.float64) + np.asarray(hi, np.float64)) / 2.0
        return vals, T.DOUBLE, empty
    if pname == "quantile":
        if len(res) == 3:  # continuous: (floor value, ceil value, fraction)
            lo, hi, frac = (np.asarray(a, np.float64) for a in res)
            with np.errstate(invalid="ignore"):
                return lo + (hi - lo) * frac, T.DOUBLE, empty
        return np.asarray(res[0], np.float64), T.DOUBLE, empty
    if pname == "hll":
        return hll_estimate_from_hist(res), T.BIGINT, empty
    if pname == "mode":
        # K2's unique maximum, or the program's tie-break by first occurrence
        mode_v, mcount, bad = res
        if bad:
            return None  # fractional / out-of-domain values → host
        return np.asarray(mode_v, np.int64), T.BIGINT, np.asarray(mcount) == 0
    if pname == "dcount":
        dcount, bad = res
        if bad:
            return None  # fractional / negative / out-of-domain values
        return np.asarray(dcount, np.int64), T.BIGINT, None
    if pname in ("dsum", "davg"):
        dcount, total, bad = res
        if bad:
            return None
        if pname == "dsum":
            return np.asarray(total, np.int64), T.BIGINT, empty
        c = np.asarray(dcount, np.float64)
        return np.asarray(total, np.float64) / np.where(c == 0, 1.0, c), T.DOUBLE, c == 0
    if pname in ("min", "max") and isinstance(res, tuple):
        # outer-join matched-validity min/max: (values, non-NULL count); a
        # LIVE group with zero valid rows renders NULL → host path
        v, cntv = res
        return np.asarray(v).astype(np.float64), T.DOUBLE, np.asarray(cntv, np.float64) == 0
    if pname in ("sum", "avg", "mean") and isinstance(res, tuple) and len(res) == 3:
        # outer-join matched-validity sum/avg: (sum, comp, non-NULL count);
        # avg divides by that count, not by the group's rows
        s64 = np.asarray(res[0], np.float64) + np.asarray(res[1], np.float64)
        c = np.asarray(res[2], np.float64)
        bad = c == 0
        if pname == "sum":
            return s64, T.DOUBLE, bad
        return s64 / np.where(bad, 1.0, c), T.DOUBLE, bad
    if pname in ("sum", "avg", "mean"):
        # (sum, comp) pair, folded in f64 (exact)
        v = np.asarray(res[0], np.float64) + np.asarray(res[1], np.float64)
        if pname == "sum":
            return v, T.DOUBLE, empty
        c = np.asarray(group_count, np.float64)
        return v / np.where(c == 0, 1.0, c), T.DOUBLE, empty
    # min/max; an EMPTY live group (global aggregate, all-false WHERE) must
    # render NULL, not +-inf — the badmask sends it to the host path
    return np.asarray(res).astype(np.float64), T.DOUBLE, empty


def _assemble_result(sel: A.Select, items_plan, agg_plans, having_plan,
                     results, group_count, key_mins, key_maxs, frac_flags,
                     has_keys: bool):
    """Host-side post-processing of the device group table: live-group
    mask, key collision guards, HAVING, rendering. Returns a Table, or None
    when a guard trips (caller falls back to host)."""
    if has_keys:
        live = group_count > 0
    else:
        # the global group always exists (count 0 is a valid result row)
        live = np.zeros(len(group_count), bool)
        live[0] = True
    for kmin_d, kmax_d, frac_d in zip(key_mins, key_maxs, frac_flags):
        if bool(np.asarray(frac_d)):
            return None  # fractional key values — int bucketing would merge
        kmin = np.asarray(kmin_d)[live]
        kmax = np.asarray(kmax_d)[live]
        if (kmin != kmax).any():
            return None  # modulo bucket held distinct keys — host path
    # finalize every aggregate once (select items + hidden HAVING outputs)
    finals = []
    for (pname, payload), res in zip(agg_plans, results):
        if pname == "key":
            finals.append(None)
            continue
        fin = _finalize_agg(pname, payload, res, group_count)
        if fin is None:
            return None
        vals, styp, badmask = fin
        if badmask is not None and bool((badmask & live).any()):
            return None  # NULL-producing group → host path renders it
        finals.append((vals, styp))
    hmask = None
    if sel.having is not None:
        agg_arrays = {}
        for hnode, pidx in having_plan:
            agg_arrays[id(hnode)] = finals[pidx][0][live]
        try:
            hmask = np.asarray(_eval_having(sel.having, agg_arrays), bool)
        except Exception:
            return None
        if hmask.ndim == 0:
            hmask = np.full(int(np.sum(live)), bool(hmask))
    out_cols: dict = {}
    for (kind, node), (pname, _), res, fin in zip(
            items_plan, agg_plans, results, finals):
        idx = len(out_cols)
        item = sel.items[idx]
        # match host-path naming: bare key columns keep their name so a
        # trailing ORDER BY <key> resolves against the fused result instead
        # of silently de-fusing to the host path
        name = item.alias or (
            item.expr.name if isinstance(item.expr, A.ColumnRef)
            else node.name if isinstance(node, A.FuncCall) else f"col{idx}")
        base, k = name, 1
        while name in out_cols:
            name = f"{base}_{k}"
            k += 1
        if pname == "key":
            vals = np.asarray(res)[live]
            if hmask is not None:
                vals = vals[hmask]
            is_int = np.all(vals == np.round(vals))
            out_cols[name] = Column(
                vals.astype(np.int64) if is_int else vals,
                T.BIGINT if is_int else T.DOUBLE)
            continue
        vals, styp = fin
        vals = vals[live]
        if hmask is not None:
            vals = vals[hmask]
        if vals.dtype == object:
            # arg_min/arg_max values gathered on the host can be any type
            # (strings, NULLs): from_values carries their validity
            out_cols[name] = Column.from_values(list(vals), styp)
        else:
            out_cols[name] = Column(vals, styp)
    return Table(out_cols)


def _ms(t0: float) -> float:
    return round((time.perf_counter() - t0) * 1e3, 3)


def _kernel_lowers(table: Table, sel: A.Select, agg_plans, nodes) -> bool:
    """Whether K2 can take the plan as far as the plan alone tells (its
    aggregate kinds, its expressions, its models); the group count and the
    shared-memory budget are known only at run time."""
    if any(p[0] not in _KERNEL_AGGS for p in agg_plans):
        return False
    low = _ProgramLowerer(table)
    try:
        for e in [sel.where, *sel.group_by]:
            if e is not None:
                low.lower(e)
        for (pname, _), node in zip(agg_plans, nodes):
            if pname in ("argmn", "argmx"):
                low.lower(node.args[1])
            elif pname not in ("key", "count_star", "isum", "iavg", "imin", "imax"):
                low.lower(node.args[0])
    except _Unsupported:
        return False
    return True


def try_execute_on_device(conn, sel: A.Select, table: Table,
                          analyze_only: bool = False):
    """Run the SELECT on the device; returns a Table or None (the host
    executor answers).

    The tiers run in ``infera_tpu``'s order: kernel K2 where
    ``FS.tier_enabled`` (``conn._cuda_plan_used``; path
    ``device_plan_cuda``), then the torch program for a plan K2 declines or
    with K2 off (path ``device_plan``); a key guard that trips in either
    tier, a NULL-producing group or a value outside a DISTINCT/MODE domain
    sends the query to the host. A planning decline (``_Unsupported``, or
    the engine's own OnnxError/SqlError) goes to the host, which raises the
    user's message; a CUDA error propagates.

    With ``analyze_only`` returns the tier's name ("kernel K2" or "torch
    program") or None after eligibility checking and lowering, without
    touching the device (used by EXPLAIN).

    Records a per-phase wall-clock breakdown on ``conn._last_phases``
    (plan_ms, upload_ms, probe_ms, exec_ms: the tier's run with the read
    back of the group table, assemble_ms) — surfaced through METRICS and
    EXPLAIN ANALYZE."""
    t0 = time.perf_counter()
    phases: dict = {}
    conn._last_phases = None
    conn._cuda_plan_used = False
    if (
        sel.from_ is None
        or table.num_rows < MIN_DEVICE_ROWS
        or table.num_rows >= (1 << 24)  # infera_tpu's f32 count bound
        or sel.distinct
        or len(sel.group_by) > 4  # mixed-radix combined-key bound
    ):
        return None
    # HAVING: aggregates compute on device as hidden outputs; the predicate
    # itself evaluates host-side over the (tiny) per-group result arrays
    having_aggs: list = []
    if sel.having is not None:
        if not _having_supported(sel.having):
            return None
        _find_aggs(sel.having, having_aggs)

    agg_nodes: list = []
    for item in sel.items:
        _find_aggs(item.expr, agg_nodes)
    if not agg_nodes:
        return None
    # every select item must be exactly one aggregate call or a group key
    items_plan = []
    for item in sel.items:
        e = item.expr
        if isinstance(e, A.FuncCall) and e.name.lower() in _AGG_NAMES:
            items_plan.append(("agg", e))
        elif sel.group_by and e in sel.group_by:
            items_plan.append(("key", sel.group_by.index(e)))
        else:
            return None

    device = get_device()
    lowerer = _Lowerer(table, device)

    def _column_type(e):
        return table.columns[lowerer._column(e.name, e.table)]

    def _refs_ok(expr: A.Expr, int_ok) -> bool:
        """Every column the expression reads outside a prediction is a
        float (or DECIMAL) column, or an integer column ``int_ok`` admits."""
        if isinstance(expr, A.ColumnRef):
            try:
                col = _column_type(expr)
            except _Unsupported:
                return False
            t = col.sql_type
            return t.is_float or t.name == "DECIMAL" or int_ok(col)
        if isinstance(expr, A.FuncCall):
            if expr.name.lower() == "infera_predict":
                return True  # prediction output is f32 by construction
            return all(_refs_ok(a, int_ok) for a in expr.args if isinstance(a, A.Expr))
        return all(_refs_ok(c, int_ok) for c in
                   (getattr(expr, a, None) for a in ("operand", "left", "right", "low", "high"))
                   if isinstance(c, A.Expr))

    def _float_only(expr: A.Expr) -> bool:
        """sum/avg/min/max run on f32 values — only allow when every
        referenced column is already a float type (integer sums need exact
        arithmetic; the host path keeps those)."""
        return _refs_ok(expr, lambda col: False)

    def _f32_safe(expr: A.Expr) -> bool:
        """Like _float_only, but additionally admits integer columns whose
        value range fits f32 exactly (|v| <= 2^24) — var/stddev, medians
        and orders over small-int columns lose nothing to the f32 block."""
        return _refs_ok(expr, lambda col: col.data.dtype.kind in "iu" and col.data.size > 0
                        and _block_eligible(col))

    def _f64_refs_f32_exact(expr: A.Expr) -> bool:
        """Every f64 column the expression reads outside a prediction holds
        only f32-exact values (cached on the column as ``_f32_exact``, as
        infera_tpu's HLL planner caches it). The block carries f64 columns
        as f32, so two rows whose order values differ below f32 precision
        would tie in an arg slot (the smaller row id wins) where the host
        tells them apart (R6). A prediction is f32 on both paths."""
        if isinstance(expr, A.FuncCall):
            if expr.name.lower() in ("infera_predict", "list_extract"):
                return True
            return all(_f64_refs_f32_exact(a) for a in expr.args if isinstance(a, A.Expr))
        if isinstance(expr, A.ColumnRef):
            return _f32_exact(_column_type(expr))
        return all(_f64_refs_f32_exact(c) for c in
                   (getattr(expr, a, None) for a in ("operand", "left", "right", "low", "high"))
                   if isinstance(c, A.Expr))

    def _order_is_exact_on_card(expr: A.Expr) -> bool:
        """An arg slot's order value is a column, a prediction or the
        negation of one. A computed order expression is evaluated in f32
        on the device where the host evaluates it in f64, so rows whose
        values differ below f32 precision would tie there and the smallest
        row id would win (R8); a negation is exact in both."""
        if isinstance(expr, A.Unary) and expr.op == "-":
            return _order_is_exact_on_card(expr.operand)
        if isinstance(expr, A.FuncCall):
            return expr.name.lower() in ("infera_predict", "list_extract")
        return isinstance(expr, A.ColumnRef)

    n = table.num_rows

    def _plan_one_agg(node):
        """One aggregate call -> agg_plans entry, or None (host path); the
        planner of infera_tpu's ``_plan_one_agg``.

        Entry shapes: (name, fn) float aggs; ("count_star", None);
        ("isum"|"iavg"|"imin"|"imax", col_key) exact int64 over a plain
        integer column (the int block); ("var", (fn, ddof, sqrt, shift))
        variance family; ("median", fn) and ("quantile", (fn, q, cont)) by
        one sort; ("hll", (col_key, dtype)) approx_count_distinct;
        ("dcount"|"dsum"|"davg"|"mode", fn) DISTINCT and MODE via the
        [G, V] counts (V probed after analyze_only); ("argmn"|"argmx",
        (fn, arg column))."""
        name = node.name.lower()
        if node.is_star or not node.args:
            if name != "count" or node.distinct:
                return None
            return ("count_star", None)
        arg = node.args[0]
        if node.distinct:
            if name == "count":
                return ("dcount", lowerer.lower(arg))
            if name in ("sum", "avg", "mean"):
                return ("dsum" if name == "sum" else "davg", lowerer.lower(arg))
            if name not in ("min", "max"):
                return None  # DISTINCT var/stddev stays on the host path
            # min/max are distinct-insensitive — plan as plain min/max
        if name == "mode":
            # counts-matrix mode over a probed small-int domain (tie-break =
            # earliest first occurrence); domain probed below with the
            # DISTINCT machinery
            return ("mode", lowerer.lower(arg))
        if name == "median":
            # one sort by (group, value), then the middle gathers
            if not _f32_safe(arg):
                return None
            return ("median", lowerer.lower(arg))
        if name in _QUANTILE_FAMILY:
            # the median's sort, ranks from a literal fraction; a bad
            # fraction goes to the host, which raises the error
            if len(node.args) != 2:
                return None
            qlit = node.args[1]
            if not (isinstance(qlit, A.Literal) and isinstance(qlit.value, (int, float))
                    and not isinstance(qlit.value, bool)):
                return None
            q = float(qlit.value)
            if not (0.0 <= q <= 1.0) or not _f32_safe(arg):
                return None
            return ("quantile", (lowerer.lower(arg), q, _QUANTILE_FAMILY[name]))
        if name in _VAR_FAMILY:
            if not _f32_safe(arg):
                return None
            fn = lowerer.lower(arg)
            # K2 shifts by a sample mean for conditioning: var is shift-
            # invariant, and |x - mean| << |x| keeps s^2 - s*s/c from
            # cancelling (the program centres on each group's mean instead)
            shift = 0.0
            if isinstance(arg, A.ColumnRef):
                col = _column_type(arg)
                shift = getattr(col, "_var_shift", None)
                if shift is None:
                    # finite values only: infera_tpu's mean of a head holding
                    # a NaN makes every group's variance NaN (R14)
                    head = col.data[:4096].astype(np.float64)
                    head = head[np.isfinite(head)]
                    shift = float(head.mean()) if len(head) else 0.0
                    col._var_shift = shift
            ddof, sq = _VAR_FAMILY[name]
            return ("var", (fn, ddof, sq, np.float32(shift)))
        if name in ("count_if", "countif"):
            return ("cif", lowerer.lower(arg))
        if name in ("bool_and", "bool_or"):
            return ("band" if name == "bool_and" else "bor", lowerer.lower(arg))
        if name == "product":
            # sign count + log2-sum decomposition; FLOAT columns only (an
            # integer product user expects bit-exact 24.0, which the log
            # path renders as 23.999998 — host path)
            if not _float_only(arg):
                return None
            return ("prod", lowerer.lower(arg))
        if name in ("arg_min", "arg_max", "min_by", "max_by"):
            # value of args[0] at the extreme of args[1]: the device finds
            # the winning ROW ID, the host gathers the arg — so the returned
            # column may be ANY type incl. strings
            if len(node.args) != 2 or not isinstance(node.args[0], A.ColumnRef):
                return None
            order = node.args[1]
            if (not _order_is_exact_on_card(order) or not _f32_safe(order)
                    or not _f64_refs_f32_exact(order)):
                return None
            ref = node.args[0]
            acol = None
            for k, c in table.columns.items():
                if k.split(".")[-1].lower() == ref.name.lower():
                    acol = c
                    break
            if acol is None:
                return None
            is_min = name in ("arg_min", "min_by")
            return ("argmn" if is_min else "argmx", (lowerer.lower(order), acol))
        if name == "approx_count_distinct":
            # the host's splitmix64 HLL, bit for bit: an integer column
            # within int32's range (infera_tpu's bound) from the int block,
            # a float column from the f32 block when its values are f32-exact
            if not isinstance(arg, A.ColumnRef):
                return None
            key = lowerer._column(arg.name, arg.table)
            col = table.columns[key]
            d = col.data
            if d.dtype.kind in "iu":
                lo, hi = _int_range(col)
                if lo < -(1 << 31) or hi >= (1 << 31):
                    return None
            elif d.dtype.kind != "f" or not _f32_exact(col):
                return None
            return ("hll", (key, str(d.dtype)))
        if name in ("sum", "min", "max") and _contains_int_window(arg):
            return None  # the host keeps the BIGINT typing of ranking windows
        # exact int64: sum/avg/min/max over a plain no-NULL integer column
        if name in ("sum", "avg", "mean", "min", "max") and isinstance(arg, A.ColumnRef):
            key = lowerer._column(arg.name, arg.table)
            col = table.columns[key]
            if col.validity is None and (col.sql_type.is_integer or col.data.dtype.kind in "iu"):
                if name in ("sum", "avg", "mean") and n > int_agg.MAX_LIMB_ROWS:
                    return None  # infera_tpu's 8-bit-limb exactness bound
                return ({"sum": "isum", "avg": "iavg", "mean": "iavg",
                         "min": "imin", "max": "imax"}[name], key)
        if name != "count" and not _float_only(arg):
            return None
        return (name, lowerer.lower(arg))

    try:
        where_fn = lowerer.lower(sel.where) if sel.where is not None else None
        key_fns = [lowerer.lower(g) for g in sel.group_by]
        if key_fns and not _group_keys_int32_safe(lowerer, sel.group_by):
            return None
        agg_plans = []
        for kind, node in items_plan:
            if kind == "key":
                agg_plans.append(("key", node))  # node = group_by index
                continue
            plan = _plan_one_agg(node)
            if plan is None:
                return None
            agg_plans.append(plan)
        # hidden device outputs for HAVING aggregates
        having_plan = []
        for node in having_aggs:
            plan = _plan_one_agg(node)
            if plan is None:
                return None
            agg_plans.append(plan)
            having_plan.append((node, len(agg_plans) - 1))
    except (_Unsupported, OnnxError, SqlError):
        return None
    nodes = [node for _k, node in items_plan] + list(having_aggs)
    mesh = MP.get_mesh(conn)
    kernel_on = FS.tier_enabled(device) and mesh is None   # with a mesh set K2 does not run

    if analyze_only:
        return ("kernel K2" if kernel_on and _kernel_lowers(table, sel, agg_plans, nodes)
                else "torch program")
    phases["plan_ms"] = _ms(t0)
    t0 = time.perf_counter()
    block = get_table_block(table, device)
    xc = None if block is None else block[0]
    try:
        cols = {k: device_column_array(k, block, n) for k, c in lowerer.used_columns.items()
                if _block_eligible(c)}
    except _Unsupported:
        return None
    int_keys = sorted({p[1] for p in agg_plans if p[0] in _INT_AGGS}
                      | {p[1][0] for p in agg_plans
                         if p[0] == "hll" and not p[1][1].startswith("float")})
    if int_keys:
        int_xc = get_int_block(table, device, int_keys)
        cols.update({k + _INT: int_xc[i, :n] for i, k in enumerate(int_keys)})
    phases["upload_ms"] = _ms(t0)
    t0 = time.perf_counter()

    # --- value probes (cached): one max per key expression and DISTINCT/
    # MODE argument, for the adaptive group-key radices and value domains;
    # each a K2 launch where K2 is on and takes it, else torch ops
    kmax_cache = getattr(conn, "_device_plan_kmax_cache", None)
    if kmax_cache is None:
        kmax_cache = {}
        conn._device_plan_kmax_cache = kmax_cache

    def _probe_max(tag, expr, fn):
        """max(int32(expr), 0) over every row of the table (NaN read as 0),
        cached per (tag, block)."""
        probe_key = (tag, id(xc))
        got = kmax_cache.get(probe_key)
        if got is None:
            top = _kernel_probe(expr) if kernel_on else None
            if top is None:
                v = _full(fn(dict(cols, __n__=n, __pred__={})), n)
                top = int(FS.key_to_int32(v).clamp(min=0).max())
            got = (xc, top)
            if len(kmax_cache) >= 64:
                kmax_cache.pop(next(iter(kmax_cache)))
            kmax_cache[probe_key] = got  # the VALUE pins the block
        return got[1]

    def _kernel_probe(expr):
        """The probe as one K2 launch (on the CPU, its plain version) of a
        one-group plan whose max slot reads the program with NaN as 0, as
        key_to_int32 reads it; the conversion toward zero is monotone, so
        int32 of the max is the max of int32. None when K2 does not lower
        the expression or the plan does not fit."""
        if block is None:
            return None
        low = _ProgramLowerer(table)
        try:
            code = low.lower(expr)
            prog = code + code + [(FS.NE, 0)] + low._const(0.0) + code + [(FS.SEL, 0)]
            plan = low.fused_plan(None, [], [], [], [prog], [], 1, block[1])
        except _Unsupported:
            return None
        if not FS.smem_fits(plan):
            return None
        top = FS.fused_sql(FS.pack_plan(plan, xc.device), xc, n)["mm"][0]
        return int(FS.key_to_int32(top).clamp(min=0)[0])

    n_groups = 1
    strides = []
    try:
        if key_fns:
            # Adaptive segment count, sized to the actual combined key domain
            # (bucketed to a power of two and cached in the plan key).
            # Multi-key GROUP BY packs the keys mixed-radix (radix_i = kmax_i
            # + 1); domains beyond MAX_GROUPS wrap and rely on the collision
            # guard.
            radices = [_probe_max(repr(g), g, kf) + 1 for g, kf in zip(sel.group_by, key_fns)]
            domain = 1
            for r in radices:
                domain = min(domain * r, 1 << 40)
            # mixed-radix strides, last key contiguous
            strides = [1] * len(radices)
            for i in range(len(radices) - 2, -1, -1):
                strides[i] = strides[i + 1] * radices[i + 1]
            n_groups = 8
            while n_groups < domain and n_groups < MAX_GROUPS:
                n_groups <<= 1

        # --- DISTINCT value domains: probe max(expr), pick V = next pow2;
        # the counts matrix is [n_groups, V] so cap the product; negative or
        # fractional values raise the invalid flag (guard -> host), oversized
        # domains are rejected here
        dist_domains: dict = {}
        for ai, ((pname, fn), node) in enumerate(zip(agg_plans, nodes)):
            if pname == "hll" and n_groups * _HLL_B > (1 << 22):
                return None  # infera_tpu's register-table bound
            if pname not in ("dcount", "dsum", "davg", "mode"):
                continue
            vmax = _probe_max((f"dist{ai}", repr(sel)), node.args[0], fn)
            v_dom = 8
            while v_dom <= vmax:
                v_dom <<= 1
            if pname in ("dsum", "davg") and v_dom > int_agg.MAX_DISTINCT_SUM_DOMAIN:
                return None  # infera_tpu's limb-matmul exactness bound
            mats = 2 if pname == "mode" else 1  # infera_tpu's mode carries two
            if n_groups * v_dom * mats > int_agg.MAX_PRESENCE_ELEMS:
                return None
            dist_domains[ai] = v_dom
    except (_Unsupported, OnnxError):
        return None
    phases["probe_ms"] = _ms(t0)
    t0 = time.perf_counter()

    plan_key = (
        repr(sel),
        tuple(sorted((k, c.data.dtype.str, len(c))
                     for k, c in lowerer.used_columns.items())),
        tuple(sorted((name, id(m)) for name, m in lowerer.models.items())),
        n,
        n_groups,
        tuple(sorted(dist_domains.items())),
        id(xc),
    )
    # --- the mesh (``Connection.set_mesh`` / ``INFERA_MESH``): the plan runs
    # over the shards with a partial-table exchange (sql/mesh_plan.py); with
    # a mesh set K2 does not run, and a plan the mesh declines runs the
    # program below. A plan with a window takes no mesh (a row-sharded
    # window would split its partitions).
    conn._mesh_plan_used = False
    conn._mesh_decline = None
    if mesh is not None and not lowerer.has_window:
        conn._mesh_decline = MP.mesh_declines(mesh, n, n_groups, agg_plans, dist_domains)
        if conn._mesh_decline is None:
            sharded = {k: (c, "f32") for k, c in lowerer.used_columns.items()
                       if _block_eligible(c)}
            sharded.update({k + _INT: (table.columns[k], "i64") for k in int_keys})
            out = MP.execute_fused_on_mesh(
                conn, mesh, n=n, sharded=sharded, replicated={}, prologue=None,
                where_fn=where_fn, key_fns=key_fns, strides=strides, n_groups=n_groups,
                agg_plans=agg_plans, dist_domains=dist_domains, phases=phases)
            phases["mesh_exec_ms"] = _ms(t0)
            if out is None:
                return None   # a guard tripped in the program: the host answers
            t0 = time.perf_counter()
            out_table = _assemble_result(sel, items_plan, agg_plans, having_plan, *out,
                                         has_keys=bool(key_fns))
            phases["assemble_ms"] = _ms(t0)
            if out_table is not None:
                conn._mesh_plan_used = True
                conn._last_phases = phases
            return out_table   # None: a guard tripped, the host answers, not one device

    if kernel_on and block is not None:
        out = _try_cuda_fused(conn, sel, table, n, n_groups, strides, agg_plans, items_plan,
                              having_aggs, plan_key, block, dist_domains)
        if out is _TRIPPED:
            return None
        if out is not None:
            phases["exec_ms"] = _ms(t0)
            t0 = time.perf_counter()
            out_table = _assemble_result(sel, items_plan, agg_plans, having_plan, *out,
                                         has_keys=bool(key_fns))
            phases["assemble_ms"] = _ms(t0)
            if out_table is not None:
                conn._cuda_plan_used = True
                conn._last_phases = phases
            return out_table  # None: a guard tripped, the program would trip it too

    # --- the torch program, cached per plan key (the VALUE pins the block)
    cache = getattr(conn, "_device_program_cache", None)
    if cache is None:
        cache = {}
        conn._device_program_cache = cache
    ent = cache.get(plan_key)
    if ent is None:
        ent = (xc, _build_program(where_fn, key_fns, strides, n_groups, agg_plans,
                                  dist_domains, n, device))
        if len(cache) >= 16:
            cache.pop(next(iter(cache)))
        cache[plan_key] = ent
    try:
        results, group_count, key_mins, key_maxs, fracs, trip = _to_host(ent[1](cols))
    except (_Unsupported, OnnxError):
        return None
    phases["exec_ms"] = _ms(t0)
    if trip:
        return None
    t0 = time.perf_counter()
    out_table = _assemble_result(sel, items_plan, agg_plans, having_plan, results,
                                 group_count, key_mins, key_maxs, fracs,
                                 has_keys=bool(key_fns))
    phases["assemble_ms"] = _ms(t0)
    if out_table is not None:
        conn._last_phases = phases
    return out_table
