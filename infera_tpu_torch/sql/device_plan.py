"""Fused device execution of SQL queries: the planner and the kernel tier.

Counterpart of ``infera_tpu/sql/device_plan.py`` (its planner, its
``_PallasLowerer`` and ``_try_pallas_fused``). For the query shapes the
benchmarks care about — aggregates over a scan of one table with a numeric
WHERE filter, optional GROUP BY over up to 4 integer-valued keys
(mixed-radix combined key), and ``infera_predict`` /
``infera_predict_multi_list(...)[k]`` calls in expressions — the whole plan
runs as ONE launch of kernel K2 (``ops/fused_sql.py``): the table lives on
the card as one stacked f32 block, every MLP (K2′) and every tree ensemble
(K4) runs inside the kernel, and only the per-group results return to the
host.

The planner lowers each expression to a postfix program (``_ProgramLowerer``)
in place of ``infera_tpu``'s JAX closures. The kernel tier carries every
aggregate ``infera_tpu``'s Pallas tier carries (``_KERNEL_AGGS``): count,
sum, avg/mean, min, max and the group key on K2's core slots, and the
aggregate tail (slot families b–e): the variance family, count_if,
bool_and/or and product lowered onto the sum, min and max slots; exact
int64 sum/avg/min/max over a plain integer column (the int64 block,
``get_int_block``); COUNT/SUM/AVG(DISTINCT) and MODE over a probed small
integer domain; arg_min/arg_max. Anything else — median, quantiles,
approx_count_distinct, a tied MODE, a window, a model that is neither an
MLP nor a forest the kernel takes (``infera_tpu``'s declines: branch modes,
tree sizes, post transforms), a plan over the shared-memory budget, a key
guard that trips — returns None and the host executor answers, so
semantics never regress. ``infera_tpu``'s XLA tier between the two (a
torch-op program here) is not in the port yet.

Path selection reads ``INFERA_PALLAS_SQL`` as ``infera_tpu`` does
(``ops/fused_sql.fused_sql_mode``): unset, the tier is on when the device is
CUDA; "0" turns it off; "1" turns it on, and on the CPU it then runs K2's
plain version (the tests' hook, as interpret mode is for Pallas).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..columnar import Column, Table
from ..columnar import types as T
from ..device import get_device
from ..errors import SqlError
from ..onnx import ml_ops as ML
from ..onnx.fusion import detect_tree
from ..ops import fused_sql as FS
from ..registry import MODELS
from . import ast as A
from . import int_agg

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

# quantile family: name -> continuous interpolation? (planned by
# infera_tpu for its XLA program; the port's host executor answers them)
_QUANTILE_FAMILY = {"quantile_cont": True, "percentile_cont": True,
                    "quantile_disc": False, "quantile": False,
                    "percentile_disc": False}

# variance family: (ddof, apply_sqrt) — shifted (sum, sum of squares) slots
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


def _decoded(attr):
    return attr.decode() if isinstance(attr, bytes) else attr


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


class _ProgramLowerer:
    """AST → postfix program (a list of ``(op, arg)``; ``ops/fused_sql.py``
    holds the opcodes). Counterpart of ``infera_tpu``'s ``_Lowerer`` and
    ``_PallasLowerer``: the cases of ``lower`` are theirs, and where they
    built a JAX closure this emits instructions. COL args are column keys
    until ``resolve`` maps them to rows of the table block. ``infera_predict``
    lowers to ``PRED j``: prediction slot j, run inside the kernel, an MLP
    slot (K2′) over the model's ``mlp_plan`` or a forest slot (K4) over its
    tree ensemble; one slot per distinct call."""

    def __init__(self, table: Table):
        self.table = table
        self.used_columns: dict = {}
        self.models: dict = {}
        self.consts: list = []
        self.preds: list = []   # prediction slots (MLP or forest), PRED j's order
        self._slots: dict = {}  # repr of a predict call -> slot index

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


def _try_cuda_fused(conn, sel, table, n, n_groups, strides, agg_plans, items_plan,
                    having_aggs, plan_key, block, dist_domains):
    """Lower the fused plan onto K2's slots, as ``infera_tpu``'s
    ``_try_pallas_fused`` lowers it onto its Pallas kernel, and run it.
    Returns the _assemble_result 5-tuple, or None when the plan does not fit
    the kernel (an aggregate outside ``_KERNEL_AGGS``, group count, value
    domain, column cap, shared-memory budget), a guard trips or a MODE ties
    in a live group: the host executor then answers. A kernel that fails to
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
        return None
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
            # tie-break (infera_tpu's XLA program); a dead group (count 0)
            # "ties" at 0 and is ignored
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
            col = (lowerer.col_for_key(key) if hasattr(lowerer, "col_for_key")
                   else lowerer.table.columns[key])
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
    if pname == "mode":
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

    def _f32_safe(expr: A.Expr) -> bool:
        """Like _float_only, but additionally admits integer columns whose
        probed value range fits f32 exactly (|v| <= 2^24) — var/stddev over
        small-int columns lose nothing to the f32 carrier."""
        ok = True

        def walk(e):
            nonlocal ok
            if isinstance(e, A.ColumnRef):
                try:
                    key = lowerer._column(e.name, e.table)
                except _Unsupported:
                    ok = False
                    return
                col = table.columns[key]
                t = col.sql_type
                if t.is_float or t.name == "DECIMAL":
                    return
                d = col.data
                if d.dtype.kind in "iu" and d.size:
                    rng = getattr(col, "_int_range", None)
                    if rng is None:
                        rng = (int(d.min()), int(d.max()))
                        col._int_range = rng
                    if rng[0] >= -(1 << 24) and rng[1] <= (1 << 24):
                        return
                ok = False
                return
            if isinstance(e, A.FuncCall):
                if e.name.lower() == "infera_predict":
                    return
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
            col = table.columns[lowerer._column(expr.name, expr.table)]
            d = col.data
            if d.dtype.kind == "f" and d.dtype.itemsize > 4 and d.size:
                exact = getattr(col, "_f32_exact", None)
                if exact is None:
                    exact = bool(np.all(d.astype(np.float32).astype(np.float64) == d))
                    col._f32_exact = exact
                return exact
            return True
        return all(_f64_refs_f32_exact(c) for c in
                   (getattr(expr, a, None) for a in ("operand", "left", "right", "low", "high"))
                   if isinstance(c, A.Expr))

    def _order_is_exact_on_card(expr: A.Expr) -> bool:
        """An arg slot's order value is a column, a prediction or the
        negation of one. K2 evaluates a computed order expression in f32
        where the host evaluates it in f64, so rows whose values differ
        below f32 precision would tie on the card and the smallest row id
        would win (R8); a negation is exact in both."""
        if isinstance(expr, A.Unary) and expr.op == "-":
            return _order_is_exact_on_card(expr.operand)
        if isinstance(expr, A.FuncCall):
            return expr.name.lower() in ("infera_predict", "list_extract")
        return isinstance(expr, A.ColumnRef)

    n = table.num_rows

    def _plan_one_agg(node):
        """One aggregate call -> agg_plans entry, or None (host path); the
        planner of infera_tpu's ``_plan_one_agg``.

        Entry shapes: (name, program) float aggs; ("count_star", None);
        ("isum"|"iavg"|"imin"|"imax", col_key) exact int64 over a plain
        integer column (the int block); ("var", (program, ddof, sqrt,
        shift)) variance family via shifted (sum, sum^2) slots;
        ("dcount"|"dsum"|"davg"|"mode", program) DISTINCT and MODE via the
        [G, V] counts (V probed after analyze_only); ("argmn"|"argmx",
        (program, arg column)). Median, quantiles and approx_count_distinct
        run in infera_tpu's XLA program, which the port does not have: the
        host answers them."""
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
            # counts-matrix mode over a probed small-int domain, unique max
            # only; domain probed below with the DISTINCT machinery
            return ("mode", lowerer.lower(arg))
        if name == "median" or name in _QUANTILE_FAMILY or name == "approx_count_distinct":
            return None
        if name in _VAR_FAMILY:
            if not _f32_safe(arg):
                return None
            code = lowerer.lower(arg)
            # shift by a sample mean for conditioning: var is shift-
            # invariant, and |x - mean| << |x| keeps s^2 - s*s/c from
            # cancelling
            shift = 0.0
            if isinstance(arg, A.ColumnRef):
                col = table.columns[lowerer._column(arg.name, arg.table)]
                shift = getattr(col, "_var_shift", None)
                if shift is None:
                    head = col.data[:4096]
                    shift = float(head.astype(np.float64).mean()) if len(head) else 0.0
                    col._var_shift = shift
            ddof, sq = _VAR_FAMILY[name]
            return ("var", (code, ddof, sq, np.float32(shift)))
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
            # value of args[0] at the extreme of args[1]: the kernel finds
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
        # exact int64: sum/avg/min/max over a plain no-NULL integer column
        # (a window never lowers: the kernel tier has none)
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
    phases["plan_ms"] = _ms(t0)
    t0 = time.perf_counter()
    block = get_table_block(table, device)
    if block is None:
        return None
    xc, row_map = block
    phases["upload_ms"] = _ms(t0)
    t0 = time.perf_counter()

    # --- value probes (cached): one max per key expression and DISTINCT/
    # MODE argument over the block, each a K2 launch, for the adaptive
    # group-key radices and value domains
    kmax_cache = getattr(conn, "_device_plan_kmax_cache", None)
    if kmax_cache is None:
        kmax_cache = {}
        conn._device_plan_kmax_cache = kmax_cache

    def _probe_max(tag, code):
        """max(int32(program), 0) over every row of the table, cached per
        (tag, block), or None when its plan does not fit the kernel. One K2
        launch (on the CPU, its plain version) of a one-group plan whose max
        slot reads the program with NaN as 0, as key_to_int32 reads it; the
        conversion toward zero is monotone, so int32 of the max is the max
        of int32. The plan keeps only the prediction slots the program
        reads (and the earlier ones their features may read)."""
        probe_key = (tag, id(xc))
        got = kmax_cache.get(probe_key)
        if got is None:
            prog = code + code + [(FS.NE, 0)] + lowerer._const(0.0) + code + [(FS.SEL, 0)]
            plan = lowerer.fused_plan(None, [], [], [], [prog], [], 1, row_map)
            last = max((arg for op, arg in prog if op == FS.PRED), default=-1)
            plan = dataclasses.replace(plan, preds=plan.preds[:last + 1])
            if not FS.smem_fits(plan):
                return None
            top = FS.fused_sql(FS.pack_plan(plan, xc.device), xc, n)["mm"][0]
            got = (xc, int(FS.key_to_int32(top).clamp(min=0)[0]))
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
                if kmax is None:
                    return None
                radices.append(kmax + 1)
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

    # --- DISTINCT value domains: probe max(expr), pick V = next pow2; the
    # counts matrix is [n_groups, V] so cap the product; negative or
    # fractional values are caught in the kernel by the invalid flag (guard
    # -> host), oversized domains are rejected here
    dist_domains: dict = {}
    for ai, (pname, code) in enumerate(agg_plans):
        if pname not in ("dcount", "dsum", "davg", "mode"):
            continue
        try:
            vmax = _probe_max((f"dist{ai}", repr(sel)), code)
        except _Unsupported:
            return None
        if vmax is None:
            return None
        v_dom = 8
        while v_dom <= vmax:
            v_dom <<= 1
        if pname in ("dsum", "davg") and v_dom > int_agg.MAX_DISTINCT_SUM_DOMAIN:
            return None  # infera_tpu's limb-matmul exactness bound
        mats = 2 if pname == "mode" else 1  # infera_tpu's mode carries two
        if n_groups * v_dom * mats > int_agg.MAX_PRESENCE_ELEMS:
            return None
        dist_domains[ai] = v_dom
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
    out = _try_cuda_fused(conn, sel, table, n, n_groups, strides, agg_plans, items_plan,
                          having_aggs, plan_key, block, dist_domains)
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
