"""K2, K2′, K4 and K5: the fused SQL plan as one CUDA kernel.

Counterpart of ``infera_tpu/ops/pallas_sql.py`` ``build_fused_plan_call``
(core slots) and of ``sql/device_plan.py`` ``_lower_mlp`` and
``_lower_tree_tables``, which run inside it. Over the stacked feature-major
table block ``xc [C, n_pad]`` f32, for every row ``r < n_valid`` the kernel
(``csrc/fused_sql.cu``) computes

    mask = where(r)                                  (true without a WHERE)
    key  = (sum_k int32(key_k(r)) * stride_k) mod G  (0 without GROUP BY)

and adds to group ``key`` of the selected rows: the row count (int64), a sum
per sum slot (f64), a min per min slot and a max per max slot (f32, NaN
propagates, empty groups stay at +-inf), and per key the raw-key min and max.
Two flags travel with the result: a key value that is not an integer, and a
key value with ``|key| >= 2**24`` (past f32's exact integers).

The TPU kernel ran the planner's Python closures, which JAX traced. A CUDA
kernel cannot, so the planner emits a small postfix **program** per slot
(``sql/device_plan._ProgramLowerer``): the WHERE predicate, each key, each
sum/min/max input and each feature of each ``infera_predict``. The kernel
interprets the programs per row in registers; ``fused_sql_plain`` evaluates
the same programs with torch ops over whole columns. ``PRED j`` reads
prediction slot ``j``, which the kernel computes on the tile before the slot
programs run, in slot order (a feature may read an earlier slot):

- an MLP slot (K2′): a ReLU MLP in f32, or in bf16 (the features and every
  ReLU output rounded to bf16, f32 accumulation, on the tensor cores), an
  optional softmax over the classes, then output column ``oc``. Where the
  WHERE reads no prediction (``mlp_on_kept_rows``), the kernel runs the MLP
  slots only on the rows it keeps;
- a forest slot (K4): the row's features staged once per tile, every tree
  walked per row over compact node records (``forest_records``, in shared
  memory where ``smem_layout`` places them), ``TREES_IN_FLIGHT`` trees at
  once, the leaf weights added in tree order, then the regressor's column
  plus its base (optional logistic), or the classifier's first-index argmax
  over the per-class scores mapped through its labels. ``forest_plain`` is
  the same function in torch ops.

K5 is K2 over a fact→dimension join (``sql/device_join_plan.py``): the plan
carries a ``JoinSpec`` and the kernel a dense key lookup (int32, -1 where no
dim row holds the key) and the dim table's own block ``[D, n_dim]``. Once
per tile, before the prediction slots, each row looks up its dim row

    fk      = int32(xc[fact_key, r])
    ridx    = (0 <= fk <= kmax) ? lookup[fk] : -1
    matched = ridx >= 0

and the programs read the join through three opcodes: ``DIM d`` (dim column
``d`` of the row's dim row, row 0 for an unmatched row, as the TPU gathers),
``MATCHED`` (1.0 or 0.0) and ``SEL`` (``c != 0 ? a : b``, a true select, so
that a NaN in an unmatched row's garbage dim row never reaches a sum). The
joined relation is never built.

The aggregate tail (``infera_tpu``'s slot families b–e) adds three slot
lists to the plan, each over the selected rows of a group:

- ``ints`` (K2 b, e): an exact int64 sum (added modulo 2**64, with an f64
  sum of ``|v|`` beside it for the overflow rule), min or max of a row of
  the int64 block ``xi [I, n]``, the integer columns the f32 block cannot
  hold exactly;
- ``dists`` (K2 c): a count per (group, value) for a program whose value is
  an integer in ``[0, v_dom)``, kept in an int32 matrix ``[G, v_dom]`` in
  device memory; any other selected value sets the slot's invalid flag.
  COUNT/SUM/AVG(DISTINCT) and MODE fold the matrix (``execute_fused_plan``);
- ``args`` (K2 d): per group the smallest row id at the extreme of a
  program, as one 64-bit word: an order-preserving 32-bit key of the f32
  value (``-0.0`` read as ``+0.0``) above 24 bits of row id (``2**24 - 1 -
  id`` for a max, so that the smallest id wins a tie either way). A selected
  NaN sets the slot's NaN flag and the host answers.

The variance, count_if, bool_and/or and product families need no slot of
their own: the planner lowers them onto sum, min and max slots.

``fused_sql`` launches the kernel for a CUDA table and runs
``fused_sql_plain`` for a CPU table; it raises for anything else.
"""

from __future__ import annotations

import ctypes
import math
import os
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from . import _kernels
from .fused_mlp import ACT_STRIDE, MAX_LAYERS, SMEM_LIMIT, pad8
from .fused_query import (TWO_BLOCK_SMEM, QueryWeights, mma_blob_bytes, mma_tile_bytes,
                          params_from_numpy)

# --------------------------------------------------------------------------- programs

# opcodes, shared with csrc/fused_sql.cu; an instruction is (op, arg)
COL, CONST, PRED, NEG, NOT = 0, 1, 2, 3, 4
ADD, SUB, MUL, DIV, MOD = 5, 6, 7, 8, 9
EQ, NE, LT, LE, GT, GE, AND, OR = 10, 11, 12, 13, 14, 15, 16, 17
BETWEEN, CAST_INT, CAST_FLOAT = 18, 19, 20
ABS, SQRT, FLOOR, CEIL, ROUND, EXP, LOG = 21, 22, 23, 24, 25, 26, 27
DIM, MATCHED, SEL = 28, 29, 30     # K5's join opcodes
LOG2 = 31                          # the product slot's log2|v| (jnp.log2)

BINARY_OPS = {"+": ADD, "-": SUB, "*": MUL, "/": DIV, "%": MOD, "=": EQ, "<>": NE,
              "<": LT, "<=": LE, ">": GT, ">=": GE, "AND": AND, "OR": OR}
SCALAR_OPS = {"abs": ABS, "sqrt": SQRT, "floor": FLOOR, "ceil": CEIL, "round": ROUND,
              "exp": EXP, "log": LOG}
_UNARY = {NEG, NOT, CAST_INT, CAST_FLOAT, ABS, SQRT, FLOOR, CEIL, ROUND, EXP, LOG, LOG2}

MAX_STACK = 16       # evaluation stack of one program, in registers
MAX_GROUPS = 512     # group slots of one plan (as PALLAS_MAX_GROUPS)
SLOT_ROWS = 256      # rows of a tile: one per thread in the slot phase
F32_EXACT = float(1 << 24)
INT_KINDS = ("sum", "min", "max")   # an int slot's kind, by its code
ROW_BITS = 24        # row ids of an arg word (try_execute_on_device keeps n < 2**24)
ARG_EMPTY_MIN = 1 << 62   # an empty arg_min group's word; an arg_max group's is 0


def stack_depth(code) -> int:
    """The deepest stack a program reaches; raises ValueError for a program
    that underflows or leaves other than one value."""
    depth = top = 0
    for op, _arg in code:
        if op in (COL, CONST, PRED, DIM, MATCHED):
            depth += 1
        elif op in (BETWEEN, SEL):
            depth -= 2
        elif op not in _UNARY:
            depth -= 1
        if depth < 1:
            raise ValueError("program stack underflow")
        top = max(top, depth)
    if depth != 1:
        raise ValueError("a program must leave exactly one value")
    return top


@dataclass
class MlpSlot:
    """One ``infera_predict`` inside the plan (K2′): the model's ReLU MLP
    ``params`` [(w [din, dout], b [dout])] as numpy f32 (``mlp_plan[0]`` of
    the model), its softmax flag, the output column it keeps, its precision,
    and one feature program per input."""

    params: list
    final_softmax: bool
    out_col: int
    bf16: bool
    features: list

    @property
    def dims(self) -> tuple:
        return (self.params[0][0].shape[0],) + tuple(w.shape[1] for w, _ in self.params)


@dataclass
class ForestSlot:
    """One ``infera_predict`` of a tree ensemble inside the plan (K4): the
    walk tables of ``onnx/ml_ops._PackedTrees.kernel_forest`` (``node``
    [T, M, 4] int32: feature or -1 for a leaf, threshold bits, true child,
    false child; ``max_depth`` steps reach every leaf; ``strict`` compares
    with ``<`` instead of ``<=``), the leaf weights [T, M, n_out] f32 with
    an AVERAGE already folded in, one feature program per input, and the
    tail of ``infera_tpu``'s ``_lower_tree_tables``: a regressor keeps
    column ``out_col`` plus the scalar ``bias``, then an optional logistic;
    a classifier adds ``class_bias`` per class, expands one score column to
    (-s, s) when ``binary``, takes the first-index argmax and maps it
    through ``labels`` (f32), or returns the index without labels."""

    node: np.ndarray
    weights: np.ndarray
    max_depth: int
    strict: bool
    features: list
    out_col: int = 0
    bias: float = 0.0
    logistic: bool = False
    classifier: bool = False
    class_bias: np.ndarray | None = None
    binary: bool = False
    labels: np.ndarray | None = None
    # forest_records of this slot, made once
    _records: tuple | None = field(default=None, init=False, repr=False, compare=False)

    @property
    def n_trees(self) -> int:
        return self.node.shape[0]

    @property
    def n_out(self) -> int:
        return self.weights.shape[2]

    def records(self) -> tuple:
        """``forest_records`` of the slot, made at the first call."""
        if self._records is None:
            self._records = forest_records(self)
        return self._records

    def smem_bytes(self) -> tuple:
        """(bytes of shared memory K4 keeps for the records, for a
        classifier's leaf weights, 0 for a regressor): 8 B, and n_out f32,
        for each of the node table's slots. That holds what
        ``forest_records`` packs (its reachable nodes), and the budget,
        which the planner checks at every execution, walks no tree."""
        T, M = self.node.shape[:2]
        return 8 * T * M, 4 * T * M * self.n_out if self.classifier else 0


def forest_records(s: ForestSlot) -> tuple:
    """K4's compact tables of forest slot ``s``: (records uint32 [T, M, 2],
    a classifier's leaf weights [T, M, n_out] f32 or None for a regressor).
    Each tree's reachable nodes are numbered level by level from the root
    (the true child first), so one level of one tree is one run of records;
    M is the most nodes of a tree. Word 0 of a record holds the threshold's
    f32 bits (a regressor's leaf: the leaf weight of column ``out_col``),
    word 1 the feature | true child << 16 | false child << 24; a leaf's
    feature is LEAF_FEATURE and its children are itself, so a walk that has
    reached it stays. ``kernel_forest`` admits trees of at most 128 internal
    nodes and 128 leaves, so every child fits its byte; a feature past
    65,534 or a child past 255 raises ValueError, never wraps."""
    node = s.node
    T = node.shape[0]
    orders = []
    for t in range(T):
        order, seen = [0], {0}
        for nd in order:                      # grows while it is read: breadth first
            if node[t, nd, 0] >= 0:
                for c in (int(node[t, nd, 2]), int(node[t, nd, 3])):
                    if c not in seen:
                        seen.add(c)
                        order.append(c)
        orders.append(np.asarray(order))
    M = max(len(o) for o in orders)
    if M > 256:
        raise ValueError(f"a tree of {M} nodes: K4's records hold children below 256")
    feats = node[:, :, 0]
    if feats.max(initial=-1) > LEAF_FEATURE - 1:
        raise ValueError(f"feature {int(feats.max())} past K4's records' {LEAF_FEATURE - 1}")
    rec = np.zeros((T, M, 2), np.uint32)
    w = None if not s.classifier else np.zeros((T, M, s.n_out), np.float32)
    for t, old in enumerate(orders):
        j = np.arange(len(old))
        new = np.zeros(node.shape[1], np.int64)
        new[old] = j
        nd = node[t, old]
        leaf = nd[:, 0] < 0
        tc = np.where(leaf, j, new[nd[:, 2]])
        fc = np.where(leaf, j, new[nd[:, 3]])
        if s.classifier:
            rec[t, j, 0] = np.where(leaf, 0, nd[:, 1].view(np.uint32))
            w[t, j] = s.weights[t, old]
        else:
            lw = s.weights[t, old, s.out_col].view(np.uint32)
            rec[t, j, 0] = np.where(leaf, lw, nd[:, 1].view(np.uint32))
        feat = np.where(leaf, LEAF_FEATURE, nd[:, 0]).astype(np.int64)
        rec[t, j, 1] = (feat | tc << 16 | fc << 24).astype(np.uint32)
    return rec, w


@dataclass
class JoinSpec:
    """K5's join prologue: the fact key's row of the table block, the largest
    dim key (the lookup has ``kmax + 1`` entries) and the dim block's shape
    ``[n_cols, n_dim]`` (``n_dim`` is the dim table's row count, the block's
    row stride)."""

    fact_key: int
    kmax: int
    n_dim: int
    n_cols: int


@dataclass
class FusedPlan:
    """Programs of one fused plan; COL args are block rows, DIM args rows of
    the dim block. ``preds`` are the prediction slots (``MlpSlot`` or
    ``ForestSlot``) that ``PRED j`` indexes, in the order the kernel runs
    them; ``join`` makes the plan K5's. The tail's slots: ``ints``
    (int-block row, kind in ``INT_KINDS``), ``dists`` (program, v_dom,
    "dist" or "mode") and ``args`` (program, is_min)."""

    where: list | None
    keys: list
    sums: list
    mins: list
    maxs: list
    strides: list
    n_groups: int
    consts: list = field(default_factory=list)
    preds: list = field(default_factory=list)
    join: JoinSpec | None = None
    ints: list = field(default_factory=list)
    dists: list = field(default_factory=list)
    args: list = field(default_factory=list)

    @property
    def slot_programs(self) -> list:
        return ([] if self.where is None else [self.where]) + self.keys + self.sums \
            + self.mins + self.maxs + [d[0] for d in self.dists] + [a[0] for a in self.args]

    @property
    def int_sums(self) -> list:
        """Indices into ``ints`` of the sum slots, which carry an estimate."""
        return [i for i, (_row, kind) in enumerate(self.ints) if kind == "sum"]

    @property
    def dist_offsets(self) -> list:
        """Each DISTINCT/MODE slot's first element in the flat count buffer."""
        offs, off = [], 0
        for _code, v_dom, _kind in self.dists:
            offs.append(off)
            off += self.n_groups * v_dom
        return offs + [off]

    @property
    def mlps(self) -> list:
        return [s for s in self.preds if isinstance(s, MlpSlot)]

    @property
    def forests(self) -> list:
        return [s for s in self.preds if isinstance(s, ForestSlot)]

    @property
    def bf16(self) -> bool:
        return any(m.bf16 for m in self.mlps)


# --------------------------------------------------------------------------- packing

_SLOT_DESC = 17      # words of a prediction slot's descriptor; the last says its kind
SLOT_MLP, SLOT_FOREST = 0, 1
_TAIL_DESC = 4       # words of an int, DISTINCT/MODE or arg slot's descriptor
# header words, shared with csrc/fused_sql.cu; K5's join descriptor is
# H_JOIN_* (-1 in H_JOIN_KEY: no join); H_TAIL points at the tail slots'
# descriptors: per int slot (block row, kind, estimate row or -1), per
# DISTINCT/MODE slot (v_dom, first element of its counts), per arg slot
# (is_min); H_KEPT is 1 where the MLP slots run on the rows the WHERE keeps
# (``mlp_on_kept_rows``)
(H_WORDS, H_K, H_S, H_M, H_X, H_WHERE, H_J, H_G, H_NPROG, H_PROGS, H_CODE, H_CONSTS,
 H_STRIDES, H_PREDS, H_JOIN_KEY, H_JOIN_KMAX, H_JOIN_NDIM, H_JOIN_NCOLS, H_I, H_IS, H_D, H_A,
 H_TAIL, H_KEPT) = range(24)
# a forest slot's descriptor words, shared with csrc/fused_sql.cu: the
# device-memory word offsets of its records (F_NODE_OFF; a regressor's
# leaf weights of its kept column lie in them), a classifier's leaf
# weights, class base values and labels (-1: none), and the byte offsets of
# the records and the leaf weights in shared memory (-1: the kernel reads
# them from device memory)
(F_TREES, F_NODES, F_DEPTH, F_NOUT, F_DIN, F_NODE_OFF, F_W_OFF, F_STRICT, F_BIAS, F_LOGISTIC,
 F_MODE, F_CBIAS_OFF, F_FEAT, F_LABEL_OFF, F_REC_SMEM, F_W_SMEM) = range(16)
TREES_IN_FLIGHT = 8  # trees a thread of K4 walks at once (kTreesInFlight)
OUT_CHUNK = 4        # class sums K4 keeps in registers, a walk each (kOutChunk)
LEAF_FEATURE = 0xFFFF   # a leaf record's feature
_SMEM_KEYS = ("blob", "act0", "act1", "pred", "vals", "kraw", "kslot", "ridx", "cnt", "sums",
              "mm", "flags", "ivals", "avals", "iacc", "iest", "aacc", "lead", "total")
H_SMEM = 24          # header words 24..42: byte offsets of _SMEM_KEYS in shared memory
H_FTILE = 43         # byte offset of K4's feature tile [d_in][SLOT_ROWS] f32, -1: none
WARPS = SLOT_ROWS // 32   # warps of a block; the reduction's lead table is [WARPS][G] bytes
_HEADER = 48


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


@dataclass
class ForestTables:
    """A forest slot's tables on the device, for the plain version: per
    node of the flattened [T * M] table its feature (-1 for a leaf),
    threshold and children, the leaf weights [T * M, n_out], and the
    classifier's per-class base values and labels."""

    feature: torch.Tensor
    threshold: torch.Tensor
    true_child: torch.Tensor
    false_child: torch.Tensor
    weights: torch.Tensor
    class_bias: torch.Tensor | None
    labels: torch.Tensor | None


@dataclass
class PackedPlan:
    """A plan on one device: ``words`` int32 (header, program table, code,
    constants, strides, slot descriptors), ``blob`` f32 (every distinct MLP's
    weights in the kernel's layout, ``blob_floats`` of them), ``trees`` int32
    (every forest slot's records and a classifier's leaf weights,
    ``forest_records``, class base values and labels; K4 copies them into
    shared memory where ``smem_layout`` places them), per prediction slot its
    weights for the plain version (``QueryWeights`` or ``ForestTables``),
    the kernel's shared-memory layout, and a join plan's key lookup (int32
    ``[kmax + 1]``, None without a join)."""

    plan: FusedPlan
    words: torch.Tensor
    blob: torch.Tensor
    blob_floats: int
    trees: torch.Tensor
    slots: list
    smem: dict
    lookup: torch.Tensor | None = None
    # workspace_layout per grid size, made at a launch
    workspaces: dict = field(default_factory=dict, repr=False)

    @property
    def smem_bytes(self) -> int:
        return self.smem["total"]


def smem_layout(plan: FusedPlan, n_words: int, blob_floats: int) -> dict:
    """Byte offsets of K2's shared memory: the plan words, the MLP weights
    (f32, or ``pack_mma_blob``'s bf16 layout for a bf16 slot), two 64-row
    activation tiles (only with an MLP), each the larger of an f32 tile at
    the widest f32 MLP width and a bf16 slot's A tile or scores
    (``mma_tile_bytes``), the tile's predictions (one row per slot, MLP or
    forest), slot values, raw keys, group slots and a join's dim row per row
    of the tile (only with a join), then the block's accumulators (int64
    counts, f64 sums, f32 min/max rows), the flag word, the tile's int64
    values and arg words, and the int slots' and arg slots' per-group
    accumulators (int64, f64 estimates, 64-bit words), and the reduction's
    lead table
    ([WARPS][G] bytes, laid over the MLP tiles and predictions when they
    hold it). A plan with a forest slot adds K4's feature tile and each
    forest's records and leaf weights where they fit (``ftile``,
    ``forests``: per forest slot the byte offsets of its records and leaf
    weights, -1 where they stay in device memory).
    ``total`` is the budget that must fit one block's 227 KB. The DISTINCT
    counts stay in device memory and take none of it."""
    K, S, M, X = len(plan.keys), len(plan.sums), len(plan.mins), len(plan.maxs)
    G, J = plan.n_groups, len(plan.preds)
    I, A = len(plan.ints), len(plan.args)
    widest = max((pad8(d) for m in plan.mlps if not m.bf16 for d in m.dims), default=0)
    act0 = act1 = 4 * widest * ACT_STRIDE
    for m in plan.mlps:
        if m.bf16:
            a0, a1 = mma_tile_bytes(m.dims)
            act0, act1 = max(act0, a0), max(act1, a1)
    sizes = [
        ("blob", 4 * blob_floats),
        ("act0", act0),
        ("act1", act1),
        ("pred", 4 * J * SLOT_ROWS),
        ("vals", 4 * (S + M + X) * SLOT_ROWS),
        ("kraw", 4 * K * SLOT_ROWS),
        ("kslot", 4 * SLOT_ROWS),
        ("ridx", 4 * SLOT_ROWS if plan.join is not None else 0),
        ("cnt", 8 * G),
        ("sums", 8 * S * G),
        ("mm", 4 * (M + X + 2 * K) * G),
        ("flags", 4),
        ("ivals", 8 * I * SLOT_ROWS),
        ("avals", 8 * A * SLOT_ROWS),
        ("iacc", 8 * I * G),
        ("iest", 8 * len(plan.int_sums) * G),
        ("aacc", 8 * A * G),
    ]
    off = _align16(4 * n_words)
    layout = {}
    for name, size in sizes:
        layout[name] = off
        off += _align16(size)
    # the reduction's lead table: over the MLP tiles and predictions, dead
    # once the slot phase has read them, else after the rest, else none (-1:
    # the kernel combines without it) rather than a plan stop fitting
    lead = WARPS * G
    if lead <= layout["vals"] - layout["act0"]:
        layout["lead"] = layout["act0"]
    elif off + _align16(lead) <= SMEM_LIMIT:
        layout["lead"] = off
        off += _align16(lead)
    else:
        layout["lead"] = -1
    if plan.forests:
        # K4: the feature tile [d_in][SLOT_ROWS] f32 at the widest forest's
        # inputs where it fits beside the rest, else none (-1: the kernel
        # runs each visited node's feature program) rather than a plan stop
        # fitting; per forest, in slot order, its records beside a feature
        # tile, then a classifier's leaf weights, each where the plan still
        # fits two blocks an SM (-1: device memory, where two blocks walk
        # the same records through __ldg)
        tile = 4 * max(len(f.features) for f in plan.forests) * SLOT_ROWS
        layout["ftile"] = -1
        if off + _align16(tile) <= SMEM_LIMIT:
            layout["ftile"] = off
            off += _align16(tile)
        places = []
        for f in plan.forests:
            rec_bytes, w_bytes = f.smem_bytes()
            rec = w = -1
            if layout["ftile"] >= 0 and off + _align16(rec_bytes) <= TWO_BLOCK_SMEM:
                rec = off
                off += _align16(rec_bytes)
                if w_bytes and off + _align16(w_bytes) <= TWO_BLOCK_SMEM:
                    w = off
                    off += _align16(w_bytes)
            places.append((rec, w))
        layout["forests"] = places
    layout["total"] = off
    layout["widest"] = widest
    return layout


def forest_routes(packed: PackedPlan) -> list:
    """Where K4 reads each forest slot's tables, in slot order: its records
    and leaf weights ("shared" memory or "device" memory; a regressor's
    weights lie in its records) and its features ("tile": staged once per
    row; "programs": each visited node's program run)."""
    lay = packed.smem
    tile = "tile" if lay.get("ftile", -1) >= 0 else "programs"
    return [{"records": "shared" if rec >= 0 else "device",
             "weights": "shared" if (w if f.classifier else rec) >= 0 else "device",
             "features": tile}
            for f, (rec, w) in zip(packed.plan.forests, lay.get("forests", []))]


def mlp_on_kept_rows(plan: FusedPlan) -> bool:
    """Whether K2 runs the plan's MLP slots only on the rows its WHERE keeps:
    the plan has an MLP slot and a WHERE that reads no prediction (the
    kernel evaluates it before the slots). Forest slots run on every row."""
    return bool(plan.mlps) and plan.where is not None and all(op != PRED for op, _ in plan.where)


def smem_bytes(plan: FusedPlan) -> int:
    """Shared memory K2 needs for ``plan`` (see ``smem_layout``)."""
    n_words, blob_floats = _sizes(plan)
    return smem_layout(plan, n_words, blob_floats)["total"]


def smem_fits(plan: FusedPlan) -> bool:
    """Hopper budget check of a plan, beside K6's ``fused_mlp.smem_fits``: a
    plan over one block's 227 KB, with an MLP deeper than the kernel's
    layer limit, or with more DISTINCT/MODE and arg slots than its flag
    word has bits, stays on the host executor."""
    if any(not 1 <= len(m.dims) - 1 <= MAX_LAYERS for m in plan.mlps):
        return False
    if len(plan.keys) + 1 + len(plan.dists) + len(plan.args) > 31:
        return False
    return smem_bytes(plan) <= SMEM_LIMIT


def _distinct_params(plan: FusedPlan) -> list:
    """(params, bf16) of every distinct MLP of the plan, in first-use order:
    two predicts of one model share one copy of its weights."""
    seen = []
    for m in plan.mlps:
        if not any(p is m.params and b == m.bf16 for p, b in seen):
            seen.append((m.params, m.bf16))
    return seen


def _blob_floats(params, bf16: bool) -> int:
    """4-byte words of one MLP's weights in the kernel: f32 ``[din][pad8(dout)]``
    and biases, or ``pack_mma_blob``'s bf16 layout for a bf16 slot."""
    dims = (params[0][0].shape[0],) + tuple(w.shape[1] for w, _ in params)
    if bf16:
        return mma_blob_bytes(dims) // 4
    return sum(dims[i] * pad8(dims[i + 1]) + pad8(dims[i + 1]) for i in range(len(dims) - 1))


def _programs(plan: FusedPlan) -> list:
    """Every program of the plan in the kernel's order: the slot programs,
    then each prediction slot's features."""
    return plan.slot_programs + [f for s in plan.preds for f in s.features]


def _sizes(plan: FusedPlan) -> tuple:
    progs = _programs(plan)
    n_code = sum(len(p) for p in progs)
    n_words = (_HEADER + 2 * len(progs) + 2 * n_code + len(plan.consts) + len(plan.keys)
               + _SLOT_DESC * len(plan.preds)
               + _TAIL_DESC * (len(plan.ints) + len(plan.dists) + len(plan.args)))
    blob = sum(_blob_floats(p, bf16) for p, bf16 in _distinct_params(plan))
    return n_words, blob


def _pack_forest(s: ForestSlot, parts: list, start: int, device) -> tuple:
    """Append forest slot ``s``'s tables to ``parts`` (int32 arrays of the
    trees buffer, whose next word is ``start``), each section 16-byte
    aligned: its records and a classifier's leaf weights (``forest_records``),
    class base values and labels. Returns (section offsets, the words
    appended, ForestTables of the plain version over the original node
    table)."""
    rec, w = s.records()
    offs = []
    pos = start
    for a in (rec, w, s.class_bias, s.labels):
        if a is None:
            offs.append(-1)
            continue
        words = np.ascontiguousarray(a).view(np.int32).reshape(-1)
        offs.append(pos)
        parts.append(words)
        parts.append(np.zeros(-words.size % 4, np.int32))
        pos += words.size + (-words.size % 4)
    node = torch.as_tensor(s.node.reshape(-1, 4), device=device)
    f32 = torch.float32

    def t(a):
        return None if a is None else torch.as_tensor(np.asarray(a, np.float32), device=device)

    tables = ForestTables(feature=node[:, 0].long(), threshold=node[:, 1].contiguous().view(f32),
                          true_child=node[:, 2].long(), false_child=node[:, 3].long(),
                          weights=t(s.weights.reshape(-1, s.n_out)), class_bias=t(s.class_bias),
                          labels=t(s.labels))
    return offs, pos - start, tables


def pack_plan(plan: FusedPlan, device, lookup=None) -> PackedPlan:
    """Move ``plan`` to ``device`` in the kernel's layout (header word
    offsets are int32 word indices; shared-memory offsets are bytes), with
    a join plan's key lookup (int32 ``[kmax + 1]``)."""
    if (plan.join is None) != (lookup is None):
        raise ValueError("a join plan needs its key lookup, and only a join plan takes one")
    if plan.join is not None and len(lookup) != plan.join.kmax + 1:
        raise ValueError(f"lookup of {len(lookup)} entries for keys up to {plan.join.kmax}")
    distinct = _distinct_params(plan)
    weights, offsets, parts = [], [], []
    off = 0
    for params, bf16 in distinct:
        qw = params_from_numpy(params, device, torch.bfloat16 if bf16 else torch.float32)
        weights.append(qw)
        offsets.append(off)
        # a bf16 slot runs on the tensor cores, over pack_mma_blob's layout
        part = qw.mma_blob.view(torch.float32) if bf16 else qw.blob
        parts.append(part)
        off += part.numel()

    progs = _programs(plan)
    n_words, blob_floats = _sizes(plan)
    layout = smem_layout(plan, n_words, blob_floats)
    words = np.zeros(n_words, np.int32)
    words[H_WORDS] = n_words
    words[H_K], words[H_S] = len(plan.keys), len(plan.sums)
    words[H_M], words[H_X] = len(plan.mins), len(plan.maxs)
    words[H_WHERE] = int(plan.where is not None)
    words[H_KEPT] = int(mlp_on_kept_rows(plan))
    words[H_J], words[H_G], words[H_NPROG] = len(plan.preds), plan.n_groups, len(progs)
    words[H_I], words[H_IS] = len(plan.ints), len(plan.int_sums)
    words[H_D], words[H_A] = len(plan.dists), len(plan.args)
    for i, key in enumerate(_SMEM_KEYS):
        words[H_SMEM + i] = layout[key]
    words[H_FTILE] = layout.get("ftile", -1)
    words[H_JOIN_KEY] = -1
    if plan.join is not None:
        j = plan.join
        words[H_JOIN_KEY], words[H_JOIN_KMAX] = j.fact_key, j.kmax
        words[H_JOIN_NDIM], words[H_JOIN_NCOLS] = j.n_dim, j.n_cols
    pos = _HEADER
    words[H_PROGS] = pos
    start = 0
    for p in progs:
        words[pos], words[pos + 1] = start, len(p)
        pos += 2
        start += len(p)
    words[H_CODE] = pos
    for p in progs:
        for op, arg in p:
            words[pos], words[pos + 1] = op, arg
            pos += 2
    words[H_CONSTS] = pos
    for c in plan.consts:
        words[pos] = _f32_bits(c)
        pos += 1
    words[H_STRIDES] = pos
    for s in plan.strides:
        words[pos] = int(s) & 0x7FFFFFFF
        pos += 1
    words[H_PREDS] = pos
    feat = len(plan.slot_programs)
    tree_parts: list = []
    n_tree_words = n_forests = 0
    slots = []
    for s in plan.preds:
        d = words[pos:pos + _SLOT_DESC]
        if isinstance(s, MlpSlot):
            i = next(i for i, (p, b) in enumerate(distinct) if p is s.params and b == s.bf16)
            dims = s.dims
            d[0] = len(dims) - 1
            d[1:1 + len(dims)] = dims
            d[10] = offsets[i]
            d[11] = int(s.final_softmax)
            d[12] = int(s.bf16)
            d[13] = feat
            d[14] = s.out_col
            d[_SLOT_DESC - 1] = SLOT_MLP
            slots.append(weights[i])
        else:
            offs, used, tables = _pack_forest(s, tree_parts, n_tree_words, device)
            n_tree_words += used
            d[F_TREES], d[F_NODES] = s.n_trees, s.records()[0].shape[1]
            d[F_REC_SMEM], d[F_W_SMEM] = layout["forests"][n_forests]
            n_forests += 1
            d[F_DEPTH], d[F_NOUT], d[F_DIN] = s.max_depth, s.n_out, len(s.features)
            d[F_NODE_OFF], d[F_W_OFF], d[F_CBIAS_OFF], d[F_LABEL_OFF] = offs
            d[F_STRICT] = int(s.strict)
            d[F_BIAS] = _f32_bits(s.bias)
            d[F_LOGISTIC] = int(s.logistic)
            d[F_MODE] = (2 if s.binary else 1) if s.classifier else 0
            d[F_FEAT] = feat
            d[_SLOT_DESC - 1] = SLOT_FOREST
            slots.append(tables)
        feat += len(s.features)
        pos += _SLOT_DESC
    words[H_TAIL] = pos
    int_sums = plan.int_sums
    for i, (row, kind) in enumerate(plan.ints):
        words[pos:pos + 3] = row, INT_KINDS.index(kind), int_sums.index(i) if i in int_sums else -1
        pos += _TAIL_DESC
    for (_code, v_dom, _kind), first in zip(plan.dists, plan.dist_offsets):
        words[pos:pos + 2] = v_dom, first
        pos += _TAIL_DESC
    for _code, is_min in plan.args:
        words[pos] = int(is_min)
        pos += _TAIL_DESC
    assert pos == n_words
    blob = (torch.cat(parts) if parts else torch.zeros(4, dtype=torch.float32, device=device))
    trees = np.concatenate(tree_parts) if tree_parts else np.zeros(4, np.int32)
    lk = None if lookup is None else torch.as_tensor(np.asarray(lookup, np.int32), device=device)
    return PackedPlan(plan=plan, words=torch.as_tensor(words, device=device),
                      blob=blob.contiguous(), blob_floats=off,
                      trees=torch.as_tensor(trees, device=device), slots=slots, smem=layout,
                      lookup=lk)


def _f32_bits(v: float) -> int:
    return struct.unpack("<i", struct.pack("<f", v))[0]


# --------------------------------------------------------------------------- plain version


def _truthy(v: torch.Tensor) -> torch.Tensor:
    return v != 0          # NaN is true, as jnp.asarray(v, bool)


@dataclass
class JoinRows:
    """K5's prologue over rows [0, n): each row's dim row (0 where it has
    none, as the kernel reads it), whether it has one, and the dim block."""

    ridx: torch.Tensor
    matched: torch.Tensor
    dim: torch.Tensor


def join_plain(packed: PackedPlan, xc: torch.Tensor, n: int, dim_xc: torch.Tensor) -> JoinRows:
    """K5's join prologue in torch ops: the fact key as the kernel converts
    it (toward zero), its dim row through the dense lookup, the match."""
    j = packed.plan.join
    if dim_xc is None or tuple(dim_xc.shape) != (j.n_cols, j.n_dim):
        raise ValueError(f"a join plan needs its dim block [{j.n_cols}, {j.n_dim}]")
    fk = key_to_int32(xc[j.fact_key, :n])
    raw = packed.lookup[fk.clamp(0, j.kmax)]
    matched = (fk >= 0) & (fk <= j.kmax) & (raw >= 0)
    return JoinRows(ridx=torch.where(matched, raw, 0).long(), matched=matched, dim=dim_xc)


def eval_program(code, consts, xc: torch.Tensor, n: int, preds: list,
                 join: JoinRows | None = None) -> torch.Tensor:
    """One program over rows [0, n) of the block in plain torch ops: the
    same f32 operations, in the same order, as the kernel's interpreter.
    ``join`` carries a join plan's prologue. Returns a [n] f32 tensor."""
    st: list = []
    f32 = torch.float32
    for op, arg in code:
        if op == COL:
            st.append(xc[arg, :n])
        elif op == DIM:
            st.append(join.dim[arg].index_select(0, join.ridx))
        elif op == MATCHED:
            st.append(join.matched.to(f32))
        elif op == SEL:
            b, a, c = st.pop(), st.pop(), st.pop()
            st.append(torch.where(_truthy(c), a, b))
        elif op == CONST:
            st.append(torch.tensor(consts[arg], dtype=f32, device=xc.device))
        elif op == PRED:
            st.append(preds[arg])
        elif op in _UNARY:
            a = st.pop()
            if op == NEG:
                r = -a
            elif op == NOT:
                r = (~_truthy(a)).to(f32)
            elif op == CAST_INT:
                r = torch.trunc(a)
            elif op == CAST_FLOAT:
                r = a
            else:
                r = {ABS: torch.abs, SQRT: torch.sqrt, FLOOR: torch.floor, CEIL: torch.ceil,
                     ROUND: torch.round, EXP: torch.exp, LOG: torch.log, LOG2: torch.log2}[op](a)
            st.append(r)
        elif op == BETWEEN:
            hi, lo, v = st.pop(), st.pop(), st.pop()
            st.append(((v >= lo) & (v <= hi)).to(f32))
        else:
            b, a = st.pop(), st.pop()
            if op == ADD:
                r = a + b
            elif op == SUB:
                r = a - b
            elif op == MUL:
                r = a * b
            elif op == DIV:
                r = a / b
            elif op == MOD:
                # floor-mod as jnp.mod: C's fmod, moved to the divisor's sign
                m = torch.fmod(a, b)
                r = torch.where((m != 0) & ((m < 0) != (b < 0)), m + b, m)
            elif op == AND:
                r = (_truthy(a) & _truthy(b)).to(f32)
            elif op == OR:
                r = (_truthy(a) | _truthy(b)).to(f32)
            else:
                r = {EQ: torch.eq, NE: torch.ne, LT: torch.lt, LE: torch.le, GT: torch.gt,
                     GE: torch.ge}[op](a, b).to(f32)
            st.append(r)
    (v,) = st
    return v.to(f32).expand(n).contiguous() if v.dim() == 0 else v.to(f32)


def _dense_fma(wt: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``wt [d_out, d_in] @ h [d_in, n]`` as the kernel's f32 layer computes it
    (``csrc/mlp_tile.cuh`` ``dense_units``): from 0, one ``fmaf`` per input
    in input order, each rounded once to f32. The product of two f32 values
    is exact in f64, so each step is the f64 sum rounded to f32."""
    w64 = wt.double()
    h64 = h.double()
    acc = torch.zeros(wt.shape[0], h.shape[1], dtype=torch.float32, device=h.device)
    for k in range(wt.shape[1]):
        acc = (acc.double() + w64[:, k:k + 1] * h64[k:k + 1]).float()
    return acc


def mlp_plain(weights: QueryWeights, feats: torch.Tensor, final_softmax: bool,
              out_col: int) -> torch.Tensor:
    """K2′ in plain torch ops over feature-major ``feats [d_in, n]``: the
    layer stack of ``fused_query.fused_mlp_query_columnar_plain`` (bf16 mode
    rounds the features and every ReLU output to bf16), an optional softmax
    over the classes, then output row ``out_col``. Each layer's products
    are summed in the f32 kernel's order (``_dense_fma``), so in f32 without
    a softmax every prediction equals the kernel's bit for bit. The kernel
    runs bf16 layers on the tensor cores (``mma.sync``: bf16 products, f32
    sums in the tensor core's order), so in bf16 the two agree within the
    bf16 bounds (a ReLU output's rounding can go the other way when its f32
    sum differs in the last bit), not bit for bit. Returns [n] f32."""
    bf16 = weights.compute_dtype == torch.bfloat16
    h = feats.to(torch.bfloat16).float() if bf16 else feats
    last = len(weights.layers) - 1
    for i, (wt, b) in enumerate(weights.layers):
        h = _dense_fma(wt.float(), h) + b
        if i < last:
            h = torch.relu(h)
            if bf16:
                h = h.to(torch.bfloat16).float()
    if final_softmax:
        # the kernel's softmax (``mlp_slot``): exp(x - max), summed over
        # the classes in class order, one f32 rounding a step
        e = torch.exp(h - h.max(dim=0).values)
        s = e[0]
        for c in range(1, e.shape[0]):
            s = s + e[c]
        return e[out_col] / s
    return h[out_col]


def forest_plain(slot: ForestSlot, tables: ForestTables, feats: torch.Tensor) -> torch.Tensor:
    """K4 in plain torch ops over feature-major ``feats [d_in, n]``: every
    tree walked ``max_depth`` steps per row, the leaf weights added in tree
    order (as the kernel's ``__fadd_rn`` chain, so the sums agree bit for
    bit), then the regressor's or the classifier's tail. A row holding a
    non-finite feature sees NaN at each node that tests another feature, as
    the one-hot product of ``infera_tpu``'s GEMM forest gives (``inf * 0``
    is NaN). Returns [n] f32."""
    x = feats.T.contiguous()
    n = x.shape[0]
    T, M = slot.n_trees, slot.node.shape[1]
    nonfin = (~torch.isfinite(x)).sum(dim=1, keepdim=True)
    cur = torch.zeros((n, T), dtype=torch.int64, device=x.device)
    tree_off = torch.arange(T, device=x.device)[None, :] * M
    for _ in range(slot.max_depth):
        flat = tree_off + cur
        f = tables.feature[flat]
        v = torch.gather(x, 1, f.clamp(min=0))
        v = torch.where(nonfin > (~torch.isfinite(v)).long(), math.nan, v)
        th = tables.threshold[flat]
        go = v < th if slot.strict else v <= th
        nxt = torch.where(go, tables.true_child[flat], tables.false_child[flat])
        cur = torch.where(f < 0, cur, nxt)
    leaf_w = tables.weights[tree_off + cur]                     # [n, T, n_out]
    if not slot.classifier:
        leaf_w = leaf_w[:, :, slot.out_col:slot.out_col + 1]
    acc = torch.zeros((n, leaf_w.shape[2]), dtype=torch.float32, device=x.device)
    for t in range(T):
        acc = acc + leaf_w[:, t]
    if not slot.classifier:
        y = acc[:, 0] + torch.tensor(slot.bias, dtype=torch.float32, device=x.device)
        return 1.0 / (1.0 + torch.exp(-y)) if slot.logistic else y
    scores = acc if tables.class_bias is None else acc + tables.class_bias
    if slot.binary:
        scores = torch.cat([-scores, scores], dim=1)
    idx = torch.argmax(scores, dim=1)     # first index; a NaN wins, as jnp.argmax
    return idx.to(torch.float32) if tables.labels is None else tables.labels[idx]


def predictions_plain(packed: PackedPlan, xc: torch.Tensor, n: int,
                      join: JoinRows | None = None) -> list:
    """Every prediction slot's value over rows [0, n), in slot order (a
    feature may read an earlier slot's prediction or a join's dim row)."""
    plan = packed.plan
    preds: list = []
    for s, w in zip(plan.preds, packed.slots):
        feats = torch.stack([eval_program(f, plan.consts, xc, n, preds, join)
                             for f in s.features])
        if isinstance(s, MlpSlot):
            preds.append(mlp_plain(w, feats, s.final_softmax, s.out_col))
        else:
            preds.append(forest_plain(s, w, feats))
    return preds


def mlp_subtiles(packed: PackedPlan, xc: torch.Tensor, n: int,
                 dim_xc: torch.Tensor | None = None) -> tuple:
    """(64-row sub-tiles K2 runs its MLP slots on, sub-tiles a pass over
    every row runs) over rows [0, n), all slots together: per 256-row tile
    ``ceil(kept / 64)`` (``mlp_on_kept_rows``) or ``ceil(rows / 64)``. The
    WHERE is evaluated by the plain version."""
    plan = packed.plan
    tiles = -(-n // SLOT_ROWS)
    rows = torch.full((tiles * SLOT_ROWS,), False, dtype=torch.bool, device=xc.device)
    rows[:n] = True
    dense = int((-(-rows.view(tiles, SLOT_ROWS).sum(1) // 64)).sum())
    if mlp_on_kept_rows(plan):
        join = None if plan.join is None else join_plain(packed, xc, n, dim_xc)
        rows[:n] = _truthy(eval_program(plan.where, plan.consts, xc, n, [], join))
    run = int((-(-rows.view(tiles, SLOT_ROWS).sum(1) // 64)).sum())
    return len(plan.mlps) * run, len(plan.mlps) * dense


def key_to_int32(r: torch.Tensor) -> torch.Tensor:
    """int32(r) as the kernel converts (``__float2int_rz``): toward zero,
    saturating, NaN to 0; as int64."""
    return torch.nan_to_num(r.double(), nan=0.0).trunc().clamp(-2**31, 2**31 - 1).to(torch.int64)


def arg_words(v: torch.Tensor, rows: torch.Tensor, is_min: bool) -> torch.Tensor:
    """K2 d's 64-bit word of each row (int64): the f32 value's order key
    (``-0.0`` read as ``+0.0``; the sign bit flips a positive value, every
    bit of a negative one) above ``ROW_BITS`` bits of its row id, the id
    mirrored for a max so that the smallest id wins a tie."""
    bits = torch.where(v == 0, torch.zeros_like(v), v).view(torch.int32).long() & 0xFFFFFFFF
    key = torch.where(bits >= 1 << 31, bits ^ 0xFFFFFFFF, bits | 1 << 31)
    low = rows if is_min else (1 << ROW_BITS) - 1 - rows
    return key << ROW_BITS | low


def _group_min_max(vals: torch.Tensor, slot: torch.Tensor, G: int, is_min: bool):
    fill = math.inf if is_min else -math.inf
    out = torch.full((G + 1,), fill, dtype=torch.float32, device=vals.device)
    out = out.scatter_reduce(0, slot, vals, "amin" if is_min else "amax", include_self=True)
    nan = torch.zeros(G + 1, dtype=torch.float32, device=vals.device)
    nan.index_add_(0, slot, torch.isnan(vals).to(torch.float32))
    return torch.where(nan > 0, torch.full_like(out, math.nan), out)[:G]


def fused_sql_plain(packed: PackedPlan, xc: torch.Tensor, n_valid: int,
                    dim_xc: torch.Tensor | None = None,
                    int_xc: torch.Tensor | None = None) -> dict:
    """K2's (and K5's, with the dim block ``dim_xc``) function in plain torch
    ops, the int slots over rows of the int64 block ``int_xc``. Returns the
    kernel's result: ``count`` [G] int64, ``sums`` [S, G] f64, ``mm`` [M +
    X + 2K, G] f32 (the min slots, the max slots, then per key the raw-key
    min and max), ``ints`` [I, G] int64 (sums modulo 2**64, minima, maxima;
    an empty group's min or max stays at the int64 extreme), ``iest`` [IS,
    G] f64 (per int sum slot the sum of ``|v|``), ``args`` [A, G] int64
    (arg words; an empty group keeps ``ARG_EMPTY_MIN`` or 0), ``dist`` the
    DISTINCT/MODE counts, int32, each slot's [G, v_dom] flat at its
    ``dist_offsets`` entry, and ``flags`` [1] int32 (bit k: key k held a
    fractional value; bit K: a key with |value| >= 2**24; bit K+1+d:
    DISTINCT/MODE slot d met a value outside its domain; bit K+1+D+a: arg
    slot a met a NaN)."""
    plan = packed.plan
    G, K = plan.n_groups, len(plan.keys)
    n = n_valid
    dev = xc.device
    join = None if plan.join is None else join_plain(packed, xc, n, dim_xc)
    preds = predictions_plain(packed, xc, n, join)

    def run(code):
        return eval_program(code, plan.consts, xc, n, preds, join)

    mask = _truthy(run(plan.where)) if plan.where is not None else \
        torch.ones(n, dtype=torch.bool, device=dev)
    combined = torch.zeros(n, dtype=torch.int64, device=dev)
    flags = 0
    kraw = []
    for k, (code, stride) in enumerate(zip(plan.keys, plan.strides)):
        r = run(code)
        ri = key_to_int32(r)
        rt = ri.to(torch.float32)
        if bool((mask & (r != rt)).any()):
            flags |= 1 << k
        if bool((mask & (r.abs() >= F32_EXACT)).any()):
            flags |= 1 << K
        combined = (combined + ((ri * (int(stride) & 0x7FFFFFFF)) & 0xFFFFFFFF)) & 0xFFFFFFFF
        kraw.append(rt)
    combined = combined - (combined >> 31) * (1 << 32)           # wrap to int32
    key = torch.remainder(combined, G)
    slot = torch.where(mask, key, torch.full_like(key, G))       # G: rows not selected
    count = torch.bincount(slot, minlength=G + 1)[:G]
    sums = torch.zeros((len(plan.sums), G + 1), dtype=torch.float64, device=dev)
    for s, code in enumerate(plan.sums):
        sums[s].index_add_(0, slot, run(code).double())
    rows = [_group_min_max(run(c), slot, G, True) for c in plan.mins]
    rows += [_group_min_max(run(c), slot, G, False) for c in plan.maxs]
    rows += [_group_min_max(rt, slot, G, True) for rt in kraw]
    rows += [_group_min_max(rt, slot, G, False) for rt in kraw]
    mm = torch.stack(rows) if rows else torch.zeros((0, G), dtype=torch.float32, device=dev)

    # K2 b, e: exact int64 sums (and sums of |v|), minima and maxima
    i64 = torch.int64
    ints = torch.zeros((len(plan.ints), G + 1), dtype=i64, device=dev)
    iest = torch.zeros((len(plan.int_sums), G + 1), dtype=torch.float64, device=dev)
    for i, (row, kind) in enumerate(plan.ints):
        v = int_xc[row, :n]
        if kind == "sum":
            ints[i].index_add_(0, slot, v)
            iest[plan.int_sums.index(i)].index_add_(0, slot, v.double().abs())
        else:
            info = torch.iinfo(i64)
            ints[i].fill_(info.max if kind == "min" else info.min)
            ints[i].scatter_reduce_(0, slot, v, "amin" if kind == "min" else "amax")
    # K2 c: counts per (group, value) over the values in [0, v_dom)
    dist = []
    for d, (code, v_dom, _kind) in enumerate(plan.dists):
        v = run(code)
        vt = torch.trunc(v)
        ok = (v == vt) & (v >= 0) & (v < v_dom)
        if bool((mask & ~ok).any()):
            flags |= 1 << (K + 1 + d)
        sel = mask & ok
        cells = slot[sel] * v_dom + vt[sel].long()
        dist.append(torch.bincount(cells, minlength=G * v_dom).to(torch.int32))
    # K2 d: the smallest row id at each group's extreme
    args = torch.zeros((len(plan.args), G + 1), dtype=i64, device=dev)
    rows_id = torch.arange(n, dtype=i64, device=dev)
    for a, (code, is_min) in enumerate(plan.args):
        v = run(code)
        nan = torch.isnan(v)
        if bool((mask & nan).any()):
            flags |= 1 << (K + 1 + len(plan.dists) + a)
        fill = ARG_EMPTY_MIN if is_min else 0
        w = torch.where(nan, fill, arg_words(v, rows_id, is_min))
        args[a].fill_(fill)
        args[a].scatter_reduce_(0, slot, w, "amin" if is_min else "amax")
    return {"count": count, "sums": sums[:, :G], "mm": mm, "ints": ints[:, :G],
            "iest": iest[:, :G], "args": args[:, :G],
            "dist": torch.cat(dist) if dist else torch.zeros(0, dtype=torch.int32, device=dev),
            "flags": torch.tensor([flags], dtype=torch.int32, device=dev)}


# --------------------------------------------------------------------------- kernel

_OUT_KEYS = ("count", "sums", "mm", "ints", "iest", "args", "flags")
def wide_instance(plan: FusedPlan) -> bool:
    """Whether K2 runs ``plan`` in its kWide instance (at most 2 blocks an
    SM, 128 registers), which alone holds the tensor-core layers, the
    128-column passes of the f32 layers and K4 (its trees in flight spill at
    80 registers): a plan with a bf16 MLP slot, an f32 layer of 128 columns
    or more, or a forest slot. Every other plan runs the instance of 3
    blocks an SM (80 registers), its f32 layers on the narrow tile."""
    return bool(plan.forests) or any(m.bf16 or any(pad8(d) >= 128 for d in m.dims[1:])
                                     for m in plan.mlps)


def resident_blocks(device: torch.device, smem: int, wide: bool = False) -> int:
    """Blocks of K2 resident on one SM at ``smem`` bytes of dynamic shared
    memory (``_kernels.resident_blocks``), in the kernel's kWide instance
    (``wide``) or the other one."""
    return _kernels.resident_blocks(device, "fused_sql", "infera_fused_sql_occupancy", smem,
                                    int(wide))


def plan_grid(packed: PackedPlan, n_valid: int, device: torch.device) -> tuple:
    """(blocks of the launch, blocks resident an SM) of K2 on ``packed``
    over ``n_valid`` rows: the resident blocks of the plan's instance at its
    shared memory, at most one a tile."""
    per_sm = resident_blocks(device, packed.smem_bytes, wide_instance(packed.plan))
    return _kernels.grid_blocks(device, -(-n_valid // SLOT_ROWS), packed.smem_bytes,
                                per_sm), per_sm


def workspace_layout(plan: FusedPlan, n_blocks: int) -> tuple:
    """The one device allocation of a launch: per section (the seven
    partials, then the seven outputs and the DISTINCT/MODE counts) its byte
    offset, byte size, dtype and shape, each 16-byte aligned; and the total
    bytes."""
    G, S = plan.n_groups, len(plan.sums)
    R = len(plan.mins) + len(plan.maxs) + 2 * len(plan.keys)
    I, IS, A = len(plan.ints), len(plan.int_sums), len(plan.args)
    i64, f64, f32, i32 = torch.int64, torch.float64, torch.float32, torch.int32
    shapes = [(i64, (G,)), (f64, (S, G)), (f32, (R, G)), (i64, (I, G)), (f64, (IS, G)),
              (i64, (A, G)), (i32, (1,))]
    sections = [(dt, (n_blocks,) + shp) for dt, shp in shapes[:6]] + [(i32, (n_blocks,))]
    sections += shapes + [(i32, (plan.dist_offsets[-1],))]
    off, out = 0, []
    for dt, shp in sections:
        nbytes = math.prod(shp) * (4 if dt in (f32, i32) else 8)
        out.append((off, nbytes, dt, shp))
        off += _align16(nbytes)
    return out, max(off, 16)


def _workspace(packed: PackedPlan, n_blocks: int, dev) -> tuple:
    """One allocation for a launch: (the partials' addresses, the outputs
    carved from it with ``set_``, which keep it alive)."""
    lay = packed.workspaces.get(n_blocks)
    if lay is None:
        lay = packed.workspaces[n_blocks] = workspace_layout(packed.plan, n_blocks)
    sections, total = lay
    ws = torch.empty(total, dtype=torch.uint8, device=dev)
    base = ws.data_ptr()
    store = ws.untyped_storage()
    part = [base + off for off, _n, _dt, _shp in sections[:7]]
    out = {}
    for key, (off, _n, dt, shp) in zip(_OUT_KEYS + ("dist",), sections[7:]):
        size = 4 if dt in (torch.float32, torch.int32) else 8
        out[key] = torch.empty(0, dtype=dt, device=dev).set_(store, off // size, shp)
    return part, out


def _launch_words(packed: PackedPlan, xc, n_valid, dim_xc, int_xc, part, out, n_blocks,
                  smem) -> ctypes.Array:
    """The int64 argument block of ``infera_fused_sql_launch`` (the Arg enum
    of csrc/fused_sql.cu)."""
    plan = packed.plan
    join = plan.join is not None
    I = len(plan.ints)
    words = [xc.data_ptr(), xc.shape[1], n_valid, packed.words.data_ptr(),
             packed.blob.data_ptr(), packed.blob_floats, packed.trees.data_ptr(),
             packed.lookup.data_ptr() if join else 0, dim_xc.data_ptr() if join else 0,
             int_xc.data_ptr() if I else 0, int_xc.shape[1] if I else 0,
             out["dist"].data_ptr(), *part, n_blocks, smem, plan.n_groups, len(plan.sums),
             len(plan.mins) + len(plan.maxs) + 2 * len(plan.keys), I, len(plan.int_sums),
             len(plan.args), *(out[k].data_ptr() for k in _OUT_KEYS), int(wide_instance(plan))]
    return (ctypes.c_longlong * len(words))(*words)


def fused_sql(packed: PackedPlan, xc: torch.Tensor, n_valid: int,
              dim_xc: torch.Tensor | None = None, int_xc: torch.Tensor | None = None) -> dict:
    """K2 (with K2′ and K4 inside it for the plan's prediction slots, and
    K5's join prologue for a join plan, whose dim block is ``dim_xc [D,
    n_dim]`` f32) over rows [0, n_valid) of the table block ``xc [C, n_pad]``
    f32, the int slots over rows of the int64 block ``int_xc [I, n]``;
    returns ``fused_sql_plain``'s dict."""
    if xc.device.type == "cpu":
        return fused_sql_plain(packed, xc, n_valid, dim_xc, int_xc)
    _kernels.require_cuda(xc, "table block")
    if xc.dtype != torch.float32 or xc.dim() != 2 or not 1 <= n_valid <= xc.shape[1]:
        raise ValueError(f"table block must be f32 [C, n_pad >= {n_valid}], "
                         f"got {xc.dtype} {tuple(xc.shape)}")
    if packed.words.device != xc.device or packed.trees.device != xc.device:
        raise ValueError(f"plan on {packed.words.device}, table on {xc.device}")
    plan = packed.plan
    join = plan.join
    if join is not None:
        _kernels.require_cuda(dim_xc, "dim block")
        if dim_xc.dtype != torch.float32 or tuple(dim_xc.shape) != (join.n_cols, join.n_dim):
            raise ValueError(f"dim block must be f32 [{join.n_cols}, {join.n_dim}], "
                             f"got {dim_xc.dtype} {tuple(dim_xc.shape)}")
        if dim_xc.device != xc.device or packed.lookup.device != xc.device:
            raise ValueError(f"dim block on {dim_xc.device}, lookup on "
                             f"{packed.lookup.device}, table on {xc.device}")
    if plan.ints:
        _kernels.require_cuda(int_xc, "int block")
        rows = 1 + max(row for row, _kind in plan.ints)
        if (int_xc.dtype != torch.int64 or int_xc.dim() != 2 or int_xc.shape[0] < rows
                or int_xc.shape[1] < n_valid or int_xc.device != xc.device):
            raise ValueError(f"int block must be int64 [>= {rows}, >= {n_valid}] on "
                             f"{xc.device}, got {int_xc.dtype} {tuple(int_xc.shape)}")
    smem = packed.smem_bytes
    if smem > SMEM_LIMIT:
        raise ValueError(f"plan needs {smem} bytes of shared memory, over {SMEM_LIMIT}")
    dev = xc.device
    n_blocks, _per_sm = plan_grid(packed, n_valid, dev)
    part, out = _workspace(packed, n_blocks, dev)
    if plan.dists:
        out["dist"].zero_()   # the kernel adds to the counts with atomics
    words = _launch_words(packed, xc, n_valid, dim_xc, int_xc, part, out, n_blocks, smem)
    lib = _kernels.load("fused_sql")
    _kernels.check(lib, lib.infera_fused_sql_launch(words, 3, _kernels.stream_handle(dev)),
                   "fused_sql")
    counts = fused_sql.launches
    counts["bf16" if plan.bf16 else "f32"] += 1
    n_isum = len(plan.int_sums)
    for key, on in (("forest", plan.forests), ("join", join is not None),
                     ("int_sum", n_isum), ("distinct", plan.dists), ("arg", plan.args),
                     ("int_minmax", len(plan.ints) - n_isum)):
        if on:
            counts[key] += 1
    return out


# K2 launches by precision; "forest" counts the launches that ran K4 inside,
# "join" those of a join plan (K5), and the tail's keys those of a plan with
# int sum slots (K2 b), DISTINCT/MODE slots (c), arg slots (d) and int
# min/max slots (e)
fused_sql.launches = {"f32": 0, "bf16": 0, "forest": 0, "join": 0, "int_sum": 0,
                      "distinct": 0, "arg": 0, "int_minmax": 0}


def fused_sql_mode() -> str:
    """``INFERA_PALLAS_SQL``, read as ``infera_tpu`` reads it: "0" turns the
    kernel tier off, "1" turns it on (on the CPU it then runs the plain
    version, the tests' hook), anything else is "auto": on when the device
    is CUDA."""
    v = os.environ.get("INFERA_PALLAS_SQL", "auto")
    return v if v in ("0", "1") else "auto"


def tier_enabled(device: torch.device) -> bool:
    mode = fused_sql_mode()
    return mode == "1" or (mode == "auto" and device.type == "cuda")


def fold_dists(plan: FusedPlan, dist: torch.Tensor) -> list:
    """The DISTINCT/MODE counts folded per slot, in torch ops on their
    device (``infera_tpu``'s ``_fold_call``): a "dist" slot gives (distinct
    count, sum of the distinct values) per group, int64; a "mode" slot
    (the value of the largest count, that count, how many values share
    it), the value the smallest one reaching it."""
    G = plan.n_groups
    out = []
    for (_code, v_dom, kind), off in zip(plan.dists, plan.dist_offsets):
        m = dist[off:off + G * v_dom].view(G, v_dom).long()
        if kind == "mode":
            top = m.max(dim=1).values
            at = m == top[:, None]
            out.append((at.long().argmax(dim=1), top, at.sum(dim=1)))
        else:
            pres = (m > 0).long()
            values = torch.arange(v_dom, dtype=torch.int64, device=m.device)
            out.append((pres.sum(dim=1), (pres * values).sum(dim=1)))
    return out


def arg_rows(plan: FusedPlan, args: torch.Tensor) -> torch.Tensor:
    """Each arg slot's winning row id per group from its words [A, G]; -1
    for an empty group."""
    low = args & ((1 << ROW_BITS) - 1)
    is_min = torch.tensor([m for _c, m in plan.args], dtype=torch.bool, device=args.device)
    rid = torch.where(is_min[:, None], low, (1 << ROW_BITS) - 1 - low)
    empty = args == torch.where(is_min, ARG_EMPTY_MIN, 0)[:, None]
    return torch.where(empty, -1, rid)


def execute_fused_plan(packed: PackedPlan, xc: torch.Tensor, n_valid: int,
                       dim_xc: torch.Tensor | None = None,
                       int_xc: torch.Tensor | None = None) -> dict | None:
    """Run K2 or K5 (or its plain version on the CPU) and hand back host arrays in
    the contract of ``infera_tpu``'s ``execute_fused_plan``: ``count`` [G],
    ``sums`` [(sum f64, 0) per slot], ``mins``/``maxs`` [G] per slot,
    ``kmins``/``kmaxs`` [G] per key, ``fracs`` [bool per key]; for the tail,
    in the port's native types: ``ints`` [G] int64 per int slot, ``iests``
    per int slot the f64 sum of ``|v|`` (None for a min or max), ``dists``
    per DISTINCT/MODE slot ``fold_dists``'s arrays plus its invalid flag,
    and ``argrids`` [G] int64 per arg slot (-1: empty). None when a key
    reached |value| >= 2**24 (past f32's exact integers two keys could share
    a bucket unseen) or an arg slot met a NaN (the host's order lets a NaN
    win only as its group's first row): the host executor answers."""
    plan = packed.plan
    res = fused_sql(packed, xc, n_valid, dim_xc, int_xc)
    flags = int(res["flags"].cpu()[0])
    K, M, X, D = len(plan.keys), len(plan.mins), len(plan.maxs), len(plan.dists)
    if flags >> K & 1 or flags >> (K + 1 + D) & ((1 << len(plan.args)) - 1):
        return None
    count = res["count"].cpu().numpy()
    sums = res["sums"].cpu().numpy()
    mm = res["mm"].cpu().numpy()
    ints = res["ints"].cpu().numpy()
    iest = res["iest"].cpu().numpy()
    dists = [tuple(a.cpu().numpy() for a in f) for f in fold_dists(plan, res["dist"])]
    rids = arg_rows(plan, res["args"]).cpu().numpy() if plan.args else []
    zeros = np.zeros(plan.n_groups, np.float64)
    est_of = {i: iest[j] for j, i in enumerate(plan.int_sums)}
    return {
        "count": count,
        "sums": [(sums[i], zeros) for i in range(len(plan.sums))],
        "mins": [mm[i] for i in range(M)],
        "maxs": [mm[M + i] for i in range(X)],
        "kmins": [mm[M + X + i] for i in range(K)],
        "kmaxs": [mm[M + X + K + i] for i in range(K)],
        "fracs": [bool(flags >> i & 1) for i in range(K)],
        "ints": [ints[i] for i in range(len(plan.ints))],
        "iests": [est_of.get(i) for i in range(len(plan.ints))],
        "dists": [f + (bool(flags >> (K + 1 + d) & 1),) for d, f in enumerate(dists)],
        "argrids": [rids[a] for a in range(len(plan.args))],
    }
