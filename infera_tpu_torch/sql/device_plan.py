"""Fused device execution of SQL queries: the planner and the kernel tier.

Counterpart of ``infera_tpu/sql/device_plan.py`` (its planner, its
``_PallasLowerer`` and ``_try_pallas_fused``). For the query shapes the
benchmarks care about — aggregates over a scan of one table with a numeric
WHERE filter, optional GROUP BY over up to 4 integer-valued keys
(mixed-radix combined key), and ``infera_predict`` /
``infera_predict_multi_list(...)[k]`` calls in expressions — the whole plan
runs as ONE launch of kernel K2 (``ops/fused_sql.py``): the table lives on
the card as one stacked f32 block, every MLP runs inside the kernel (K2′),
and only the per-group results return to the host.

The planner lowers each expression to a postfix program (``_ProgramLowerer``)
in place of ``infera_tpu``'s JAX closures. The kernel tier carries the core
aggregates: count, sum, avg/mean, min, max and the group key. Anything else
— another aggregate, a window, a model that is no MLP, a plan over the
shared-memory budget, a key guard that trips — returns None and the host
executor answers, so semantics never regress. ``infera_tpu``'s XLA tier
between the two (a torch-op program here) is not in the port yet.

Path selection reads ``INFERA_PALLAS_SQL`` as ``infera_tpu`` does
(``ops/fused_sql.fused_sql_mode``): unset, the tier is on when the device is
CUDA; "0" turns it off; "1" turns it on, and on the CPU it then runs K2's
plain version (the tests' hook, as interpret mode is for Pallas).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar import types as T
from ..device import get_device
from ..ops import fused_sql as FS
from ..registry import MODELS
from . import ast as A

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

# the aggregates K2's core slots carry; the rest (infera_tpu's slot
# families b-e: var, count_if, bool_and/or, product, exact int64 sums and
# extremes, DISTINCT, mode, arg_min/arg_max, ...) answer on the host
_CORE_AGGS = frozenset({"count", "count_star", "sum", "avg", "mean", "min", "max"})

# group-count cap of the mixed-radix key (static shape requirement)
MAX_GROUPS = 1 << 16


class _Unsupported(Exception):
    pass


# --- shared device-resident table block ----------------------------------
# ONE stacked feature-major [C, n] f32 tensor per table on the card: K2 reads
# it directly (programs address its rows), and the key probes evaluate over
# it. No padding: the kernel masks rows >= n itself.

# {(source array ids, n, device): (pinned arrays, block)} — process-global so
# every Connection over the same catalog shares one upload
_TABLE_BLOCK_CACHE: dict = {}


def _block_eligible(col) -> bool:
    d = col.data
    if getattr(col, "validity", None) is not None:
        return False
    if d.dtype.kind == "f":
        return True
    if d.dtype.kind in "iu":
        if not d.size:
            return True
        rng = getattr(col, "_int_range", None)
        if rng is None:
            rng = (int(d.min()), int(d.max()))
            col._int_range = rng
        return rng[0] >= -(1 << 24) and rng[1] <= (1 << 24)
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


class _ProgramLowerer:
    """AST → postfix program (a list of ``(op, arg)``; ``ops/fused_sql.py``
    holds the opcodes). Counterpart of ``infera_tpu``'s ``_Lowerer`` and
    ``_PallasLowerer``: the cases of ``lower`` are theirs, and where they
    built a JAX closure this emits instructions. COL args are column keys
    until ``resolve`` maps them to rows of the table block. ``infera_predict``
    lowers to ``PRED j``: MLP slot j (K2′), run inside the kernel over the
    model's ``mlp_plan``; one slot per distinct call."""

    def __init__(self, table: Table):
        self.table = table
        self.used_columns: dict = {}
        self.models: dict = {}
        self.consts: list = []
        self.mlps: list = []
        self._slots: dict = {}  # repr of a predict call -> MLP slot

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
        # windows need a global sort — impossible inside the row-local kernel
        raise _Unsupported(type(expr).__name__)

    def _lower_predict(self, expr: A.FuncCall, out_col: int | None = None) -> list:
        """K2′ slot for infera_predict (out_col None → requires a 1-column
        output) or an infera_predict_multi_list element (0-based out_col)."""
        if (not expr.args or not isinstance(expr.args[0], A.Literal)
                or not isinstance(expr.args[0].value, str)):
            raise _Unsupported("infera_predict needs a constant model name")
        model_name = expr.args[0].value
        model = MODELS.get(model_name)
        if model is None:
            raise _Unsupported(f"model {model_name} not loaded at plan time")
        precision = getattr(model, "precision", "f32") or "f32"
        plan = getattr(model, "mlp_plan", None)
        if plan is None or precision not in ("f32", "bf16"):
            raise _Unsupported("the kernel plan needs an f32 or bf16 MLP model")
        self.models[model_name] = model
        params, final_softmax = plan[0], plan[1]
        oc = self._pick_out_col(out_col, params[-1][0].shape[1])
        key = (model_name, id(model), oc, repr(expr.args[1:]))
        j = self._slots.get(key)
        if j is None:
            features = [self.lower(a) for a in expr.args[1:]]
            if len(features) != params[0][0].shape[0]:
                raise _Unsupported("feature count mismatch (host path reports it)")
            self.mlps.append(FS.MlpSlot(params=params, final_softmax=bool(final_softmax),
                                        out_col=oc, bf16=precision == "bf16",
                                        features=features))
            j = len(self.mlps) - 1
            self._slots[key] = j
        return [(FS.PRED, j)]

    @staticmethod
    def _pick_out_col(out_col, d_out):
        if out_col is None:
            if d_out != 1:
                raise _Unsupported("multi-output model under infera_predict")
            return 0
        if out_col < 0 or out_col >= d_out:
            raise _Unsupported("list index beyond model output width")
        return out_col

    def fused_plan(self, where, keys, sums, mins, maxs, strides, n_groups,
                   row_map) -> FS.FusedPlan:
        """The kernel's plan, COL keys resolved to rows of the table block."""
        def resolve(code):
            out = []
            for op, arg in code:
                if op == FS.COL:
                    if arg not in row_map:
                        raise _Unsupported(f"column {arg} is not in the table block")
                    arg = row_map[arg]
                out.append((op, arg))
            if FS.stack_depth(out) > FS.MAX_STACK:
                raise _Unsupported("expression deeper than the kernel's stack")
            return out

        mlps = [FS.MlpSlot(params=m.params, final_softmax=m.final_softmax,
                           out_col=m.out_col, bf16=m.bf16,
                           features=[resolve(f) for f in m.features]) for m in self.mlps]
        return FS.FusedPlan(
            where=None if where is None else resolve(where),
            keys=[resolve(c) for c in keys], sums=[resolve(c) for c in sums],
            mins=[resolve(c) for c in mins], maxs=[resolve(c) for c in maxs],
            strides=list(strides), n_groups=n_groups, consts=list(self.consts), mlps=mlps)


def _packed(conn, plan_key, plan: FS.FusedPlan, block_xc) -> FS.PackedPlan:
    """The plan on the block's device, cached per connection by plan key."""
    cache = getattr(conn, "_device_plan_cache", None)
    if cache is None:
        cache = {}
        conn._device_plan_cache = cache
    ent = cache.get(plan_key)
    if ent is None:
        ent = (block_xc, FS.pack_plan(plan, block_xc.device))
        if len(cache) >= 16:
            cache.pop(next(iter(cache)))
        cache[plan_key] = ent  # the VALUE pins the block its rows address
    return ent[1]


def _try_cuda_fused(conn, sel, table, n, n_groups, strides, agg_plans, items_plan,
                    having_aggs, plan_key, block):
    """Lower the fused plan onto K2's core slots and run it. Returns the
    _assemble_result 5-tuple, or None when the plan does not fit the kernel
    (group count, shared-memory budget) or the magnitude guard trips: the
    host executor then answers. A kernel that fails to build or launch
    raises."""
    if not 1 <= n_groups <= FS.MAX_GROUPS:
        return None
    low = _ProgramLowerer(table)
    sums: list = []
    mins: list = []
    maxs: list = []
    slot_map: list = []  # per agg_plans entry
    nodes = [node for _k, node in items_plan] + list(having_aggs)
    try:
        where = low.lower(sel.where) if sel.where is not None else None
        keys = [low.lower(g) for g in sel.group_by]
        for (pname, payload), node in zip(agg_plans, nodes):
            if pname == "key":
                slot_map.append(("key", payload))
            elif pname in ("count", "count_star"):
                # device-eligible columns carry no NULLs → count(expr)
                # counts exactly the selected rows
                slot_map.append(("count", None))
            elif pname in ("sum", "avg", "mean"):
                sums.append(low.lower(node.args[0]))
                slot_map.append((pname, len(sums) - 1))
            elif pname == "min":
                mins.append(low.lower(node.args[0]))
                slot_map.append(("min", len(mins) - 1))
            else:
                maxs.append(low.lower(node.args[0]))
                slot_map.append(("max", len(maxs) - 1))
        xc, row_map = block
        plan = low.fused_plan(where, keys, sums, mins, maxs, strides, n_groups, row_map)
    except _Unsupported:
        return None
    if not FS.smem_fits(plan):
        return None
    res = FS.execute_fused_plan(_packed(conn, plan_key, plan, xc), xc, n)
    if res is None:
        return None
    results: list = []
    for spec, si in slot_map:
        if spec == "key":
            results.append(np.asarray(res["kmaxs"][si]))
        elif spec == "count":
            results.append(res["count"])
        elif spec in ("sum", "avg", "mean"):
            results.append(res["sums"][si])  # (f64 sum, 0) pair
        elif spec == "min":
            results.append(np.asarray(res["mins"][si]))
        else:
            results.append(np.asarray(res["maxs"][si]))
    return (results, res["count"], res["kmins"], res["kmaxs"], res["fracs"])


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
            col = lowerer.table.columns[key]
            d = col.data
            if d.dtype.kind in "iu" and d.dtype.itemsize > 4 and d.size:
                rng = getattr(col, "_int_range", None)
                if rng is None:
                    rng = (int(d.min()), int(d.max()))
                    col._int_range = rng
                if rng[0] < -(1 << 31) or rng[1] >= (1 << 31):
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
    whose result is undefined (avg or min of 0 rows); the caller falls back
    to the host path when a LIVE group is bad. The branches of the core
    slots of ``infera_tpu``'s ``_finalize_agg``."""
    if pname in ("count", "count_star"):
        return np.asarray(res).astype(np.int64), T.BIGINT, None
    empty = np.asarray(group_count) == 0
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
        vals, styp, badmask = _finalize_agg(pname, payload, res, group_count)
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
        out_cols[name] = Column(vals, styp)
    return Table(out_cols)


def _ms(t0: float) -> float:
    return round((time.perf_counter() - t0) * 1e3, 3)


def try_execute_on_device(conn, sel: A.Select, table: Table,
                          analyze_only: bool = False):
    """Run the SELECT as kernel K2; returns a Table or None.

    With ``analyze_only`` returns True/None after eligibility checking +
    lowering, without touching the device (used by EXPLAIN).

    Records a per-phase wall-clock breakdown on ``conn._last_phases``
    (plan_ms, upload_ms, probe_ms, exec_ms: K2 with its fold and the read
    back of the group table, assemble_ms) — surfaced through METRICS and
    EXPLAIN ANALYZE."""
    t0 = time.perf_counter()
    phases: dict = {}
    conn._last_phases = None
    if (
        sel.from_ is None
        or table.num_rows < MIN_DEVICE_ROWS
        or table.num_rows >= (1 << 24)  # infera_tpu's f32 count bound
        or sel.distinct
        or len(sel.group_by) > 4  # mixed-radix combined-key bound
    ):
        return None
    if FS.fused_sql_mode() == "0":
        return None
    device = get_device()
    if not FS.tier_enabled(device):
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

    lowerer = _ProgramLowerer(table)

    def _float_only(expr: A.Expr) -> bool:
        """sum/avg/min/max run in f32 on device — only allow when every
        referenced column is already a float type (integer sums need exact
        arithmetic; the host path keeps those)."""
        ok = True

        def walk(e):
            nonlocal ok
            if isinstance(e, A.ColumnRef):
                try:
                    key = lowerer._column(e.name, e.table)
                except _Unsupported:
                    ok = False
                    return
                t = table.columns[key].sql_type
                if not (t.is_float or t.name == "DECIMAL"):
                    ok = False
            if isinstance(e, A.FuncCall):
                if e.name.lower() == "infera_predict":
                    return  # prediction output is f32 by construction
                for a in e.args:
                    if isinstance(a, A.Expr):
                        walk(a)
                return
            for attr in ("operand", "left", "right", "low", "high"):
                child = getattr(e, attr, None)
                if isinstance(child, A.Expr):
                    walk(child)

        walk(expr)
        return ok

    def _plan_one_agg(node):
        """One aggregate call -> agg_plans entry (name, program), or None
        (host path) for an aggregate outside K2's core slots."""
        name = node.name.lower()
        if node.is_star or not node.args:
            if name != "count" or node.distinct:
                return None
            return ("count_star", None)
        arg = node.args[0]
        if node.distinct and name not in ("min", "max"):
            return None  # min/max are distinct-insensitive — plain min/max
        if name not in _CORE_AGGS:
            return None
        # integer inputs (exact int64 sums and extremes: infera_tpu's limb
        # slots, P6 of the port) stay on the host; a window does not lower
        if name != "count" and not _float_only(arg):
            return None
        return (name, lowerer.lower(arg))

    try:
        key_progs = [lowerer.lower(g) for g in sel.group_by]
        if sel.where is not None:
            lowerer.lower(sel.where)
        if key_progs and not _group_keys_int32_safe(lowerer, sel.group_by):
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
    except _Unsupported:
        return None

    if analyze_only:
        return True
    n = table.num_rows
    phases["plan_ms"] = _ms(t0)
    t0 = time.perf_counter()
    block = get_table_block(table, device)
    if block is None:
        return None
    xc, row_map = block
    phases["upload_ms"] = _ms(t0)
    t0 = time.perf_counter()

    # --- key probes (cached): one max per key expression over the block,
    # as torch ops on the device, for the adaptive group-key radices
    kmax_cache = getattr(conn, "_device_plan_kmax_cache", None)
    if kmax_cache is None:
        kmax_cache = {}
        conn._device_plan_kmax_cache = kmax_cache

    def _probe_max(tag, code):
        """max(int32(program), 0) over the table, cached per (tag, block)."""
        probe_key = (tag, id(xc))
        got = kmax_cache.get(probe_key)
        if got is None:
            plan = lowerer.fused_plan(None, [code], [], [], [], [1], 1, row_map)
            # the MLPs run only for a key that reads a prediction
            preds = (FS.predictions_plain(FS.pack_plan(plan, device), xc, n)
                     if any(op == FS.PRED for op, _ in plan.keys[0]) else [])
            v = FS.eval_program(plan.keys[0], plan.consts, xc, n, preds)
            got = (xc, int(FS.key_to_int32(v).clamp(min=0).max()))
            if len(kmax_cache) >= 64:
                kmax_cache.pop(next(iter(kmax_cache)))
            kmax_cache[probe_key] = got  # the VALUE pins the block
        return got[1]

    n_groups = 1
    strides = []
    if key_progs:
        # Adaptive segment count, sized to the actual combined key domain
        # (one device max per key, bucketed to a power of two and cached in
        # the plan key). Multi-key GROUP BY packs the keys mixed-radix
        # (radix_i = kmax_i + 1); domains beyond MAX_GROUPS wrap and rely on
        # the collision guard.
        try:
            radices = []
            for gi, kp in enumerate(key_progs):
                kmax = _probe_max(repr(sel.group_by[gi]), kp)
                radices.append(max(kmax, 0) + 1)
        except _Unsupported:
            return None
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
    phases["probe_ms"] = _ms(t0)
    t0 = time.perf_counter()

    plan_key = (
        repr(sel),
        tuple(sorted((k, c.data.dtype.str, len(c))
                     for k, c in lowerer.used_columns.items())),
        tuple(sorted((name, id(m)) for name, m in lowerer.models.items())),
        n,
        n_groups,
        id(xc),
    )
    out = _try_cuda_fused(conn, sel, table, n, n_groups, strides, agg_plans, items_plan,
                          having_aggs, plan_key, block)
    phases["exec_ms"] = _ms(t0)
    if out is None:
        return None
    t0 = time.perf_counter()
    out_table = _assemble_result(sel, items_plan, agg_plans, having_plan, *out,
                                 has_keys=bool(key_progs))
    phases["assemble_ms"] = _ms(t0)
    if out_table is not None:
        conn._last_phases = phases
    return out_table
