"""K2 and K2′: the fused SQL plan as one CUDA kernel.

Counterpart of ``infera_tpu/ops/pallas_sql.py`` ``build_fused_plan_call``
(core slots) and of ``sql/device_plan.py`` ``_lower_mlp``, which runs inside
it. Over the stacked feature-major table block ``xc [C, n_pad]`` f32, for
every row ``r < n_valid`` the kernel (``csrc/fused_sql.cu``) computes

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
the same programs with torch ops over whole columns. ``PRED j`` reads the
output column ``oc`` of MLP slot ``j`` (K2′), which the kernel computes on
the tile before the slot programs run: a ReLU MLP in f32, or in bf16 (the
features and every ReLU output rounded to bf16, f32 accumulation), then an
optional softmax over the classes.

``fused_sql`` launches the kernel for a CUDA table and runs
``fused_sql_plain`` for a CPU table; it raises for anything else.
"""

from __future__ import annotations

import math
import os
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from . import _kernels
from .fused_mlp import ACT_STRIDE, MAX_LAYERS, SMEM_LIMIT, pad8
from .fused_query import QueryWeights, params_from_numpy

# --------------------------------------------------------------------------- programs

# opcodes, shared with csrc/fused_sql.cu; an instruction is (op, arg)
COL, CONST, PRED, NEG, NOT = 0, 1, 2, 3, 4
ADD, SUB, MUL, DIV, MOD = 5, 6, 7, 8, 9
EQ, NE, LT, LE, GT, GE, AND, OR = 10, 11, 12, 13, 14, 15, 16, 17
BETWEEN, CAST_INT, CAST_FLOAT = 18, 19, 20
ABS, SQRT, FLOOR, CEIL, ROUND, EXP, LOG = 21, 22, 23, 24, 25, 26, 27

BINARY_OPS = {"+": ADD, "-": SUB, "*": MUL, "/": DIV, "%": MOD, "=": EQ, "<>": NE,
              "<": LT, "<=": LE, ">": GT, ">=": GE, "AND": AND, "OR": OR}
SCALAR_OPS = {"abs": ABS, "sqrt": SQRT, "floor": FLOOR, "ceil": CEIL, "round": ROUND,
              "exp": EXP, "log": LOG}
_UNARY = {NEG, NOT, CAST_INT, CAST_FLOAT, ABS, SQRT, FLOOR, CEIL, ROUND, EXP, LOG}

MAX_STACK = 16       # evaluation stack of one program, in registers
MAX_GROUPS = 512     # group slots of one plan (as PALLAS_MAX_GROUPS)
SLOT_ROWS = 256      # rows of a tile: one per thread in the slot phase
F32_EXACT = float(1 << 24)


def stack_depth(code) -> int:
    """The deepest stack a program reaches; raises ValueError for a program
    that underflows or leaves other than one value."""
    depth = top = 0
    for op, _arg in code:
        if op in (COL, CONST, PRED):
            depth += 1
        elif op == BETWEEN:
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
class FusedPlan:
    """Programs of one fused plan; COL args are block rows."""

    where: list | None
    keys: list
    sums: list
    mins: list
    maxs: list
    strides: list
    n_groups: int
    consts: list = field(default_factory=list)
    mlps: list = field(default_factory=list)

    @property
    def slot_programs(self) -> list:
        return ([] if self.where is None else [self.where]) + self.keys + self.sums \
            + self.mins + self.maxs

    @property
    def bf16(self) -> bool:
        return any(m.bf16 for m in self.mlps)


# --------------------------------------------------------------------------- packing

_HEADER = 32
_MLP_DESC = 16
(H_WORDS, H_K, H_S, H_M, H_X, H_WHERE, H_J, H_G, H_NPROG, H_PROGS, H_CODE, H_CONSTS,
 H_STRIDES, H_MLPS) = range(14)
_SMEM_KEYS = ("blob", "act0", "act1", "pred", "vals", "kraw", "kslot", "cnt", "sums", "mm",
              "flags", "total")
H_SMEM = 16          # header words 16..27: byte offsets of _SMEM_KEYS in shared memory


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


@dataclass
class PackedPlan:
    """A plan on one device: ``words`` int32 (header, program table, code,
    constants, strides, MLP descriptors), ``blob`` f32 (every distinct MLP's
    weights in the kernel's layout), the MLP weights for the plain version,
    and the kernel's shared-memory layout."""

    plan: FusedPlan
    words: torch.Tensor
    blob: torch.Tensor
    weights: list
    smem: dict

    @property
    def smem_bytes(self) -> int:
        return self.smem["total"]


def smem_layout(plan: FusedPlan, n_words: int, blob_floats: int) -> dict:
    """Byte offsets of K2's shared memory: the plan words, the MLP weights,
    two 64-row activation tiles at the widest MLP width (only with an MLP),
    the tile's predictions, slot values, raw keys and group slots, then the
    block's accumulators (int64 counts, f64 sums, f32 min/max rows) and the
    flag word. ``total`` is the budget that must fit one block's 227 KB."""
    K, S, M, X = len(plan.keys), len(plan.sums), len(plan.mins), len(plan.maxs)
    G, J = plan.n_groups, len(plan.mlps)
    widest = max((pad8(d) for m in plan.mlps for d in m.dims), default=0)
    sizes = [
        ("blob", 4 * blob_floats),
        ("act0", 4 * widest * ACT_STRIDE),
        ("act1", 4 * widest * ACT_STRIDE),
        ("pred", 4 * J * SLOT_ROWS),
        ("vals", 4 * (S + M + X) * SLOT_ROWS),
        ("kraw", 4 * K * SLOT_ROWS),
        ("kslot", 4 * SLOT_ROWS),
        ("cnt", 8 * G),
        ("sums", 8 * S * G),
        ("mm", 4 * (M + X + 2 * K) * G),
        ("flags", 4),
    ]
    off = _align16(4 * n_words)
    layout = {}
    for name, size in sizes:
        layout[name] = off
        off += _align16(size)
    layout["total"] = off
    layout["widest"] = widest
    return layout


def smem_bytes(plan: FusedPlan) -> int:
    """Shared memory K2 needs for ``plan`` (see ``smem_layout``)."""
    n_words, blob_floats = _sizes(plan)
    return smem_layout(plan, n_words, blob_floats)["total"]


def smem_fits(plan: FusedPlan) -> bool:
    """Hopper budget check of a plan, beside K6's ``fused_mlp.smem_fits``: a
    plan over one block's 227 KB, or with an MLP deeper than the kernel's
    layer limit, stays on the host executor."""
    if any(not 1 <= len(m.dims) - 1 <= MAX_LAYERS for m in plan.mlps):
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


def _blob_floats(params) -> int:
    dims = (params[0][0].shape[0],) + tuple(w.shape[1] for w, _ in params)
    return sum(dims[i] * pad8(dims[i + 1]) + pad8(dims[i + 1]) for i in range(len(dims) - 1))


def _sizes(plan: FusedPlan) -> tuple:
    progs = plan.slot_programs + [f for m in plan.mlps for f in m.features]
    n_code = sum(len(p) for p in progs)
    n_words = (_HEADER + 2 * len(progs) + 2 * n_code + len(plan.consts) + len(plan.keys)
               + _MLP_DESC * len(plan.mlps))
    blob = sum(_blob_floats(p) for p, _ in _distinct_params(plan))
    return n_words, blob


def pack_plan(plan: FusedPlan, device) -> PackedPlan:
    """Move ``plan`` to ``device`` in the kernel's layout (header word
    offsets are int32 word indices; shared-memory offsets are bytes)."""
    distinct = _distinct_params(plan)
    weights, offsets, parts = [], [], []
    off = 0
    for params, bf16 in distinct:
        qw = params_from_numpy(params, device, torch.bfloat16 if bf16 else torch.float32)
        weights.append(qw)
        offsets.append(off)
        parts.append(qw.blob)
        off += qw.blob.numel()
    slot_w = []
    for m in plan.mlps:
        i = next(i for i, (p, b) in enumerate(distinct) if p is m.params and b == m.bf16)
        slot_w.append((weights[i], offsets[i]))

    progs = plan.slot_programs + [f for m in plan.mlps for f in m.features]
    n_words, blob_floats = _sizes(plan)
    layout = smem_layout(plan, n_words, blob_floats)
    words = np.zeros(n_words, np.int32)
    words[H_WORDS] = n_words
    words[H_K], words[H_S] = len(plan.keys), len(plan.sums)
    words[H_M], words[H_X] = len(plan.mins), len(plan.maxs)
    words[H_WHERE] = int(plan.where is not None)
    words[H_J], words[H_G], words[H_NPROG] = len(plan.mlps), plan.n_groups, len(progs)
    for i, key in enumerate(_SMEM_KEYS):
        words[H_SMEM + i] = layout[key]
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
        words[pos] = struct.unpack("<i", struct.pack("<f", c))[0]
        pos += 1
    words[H_STRIDES] = pos
    for s in plan.strides:
        words[pos] = int(s) & 0x7FFFFFFF
        pos += 1
    words[H_MLPS] = pos
    feat = len(plan.slot_programs)
    for m, (qw, boff) in zip(plan.mlps, slot_w):
        dims = m.dims
        words[pos] = len(dims) - 1
        words[pos + 1:pos + 1 + len(dims)] = dims
        words[pos + 10] = boff
        words[pos + 11] = int(m.final_softmax)
        words[pos + 12] = int(m.bf16)
        words[pos + 13] = feat
        words[pos + 14] = m.out_col
        feat += len(m.features)
        pos += _MLP_DESC
    assert pos == n_words
    blob = (torch.cat(parts) if parts else torch.zeros(4, dtype=torch.float32, device=device))
    return PackedPlan(plan=plan, words=torch.as_tensor(words, device=device),
                      blob=blob.contiguous(), weights=[w for w, _ in slot_w], smem=layout)


# --------------------------------------------------------------------------- plain version


def _truthy(v: torch.Tensor) -> torch.Tensor:
    return v != 0          # NaN is true, as jnp.asarray(v, bool)


def eval_program(code, consts, xc: torch.Tensor, n: int, preds: list) -> torch.Tensor:
    """One program over rows [0, n) of the block in plain torch ops: the
    same f32 operations, in the same order, as the kernel's interpreter.
    Returns a [n] f32 tensor."""
    st: list = []
    f32 = torch.float32
    for op, arg in code:
        if op == COL:
            st.append(xc[arg, :n])
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
                     ROUND: torch.round, EXP: torch.exp, LOG: torch.log}[op](a)
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


def mlp_plain(weights: QueryWeights, feats: torch.Tensor, final_softmax: bool,
              out_col: int) -> torch.Tensor:
    """K2′ in plain torch ops over feature-major ``feats [d_in, n]``: the
    layer stack of ``fused_query.fused_mlp_query_columnar_plain`` (bf16 mode
    rounds the features and every ReLU output to bf16), an optional softmax
    over the classes, then output row ``out_col``. Returns [n] f32."""
    bf16 = weights.compute_dtype == torch.bfloat16
    h = feats.to(torch.bfloat16).float() if bf16 else feats
    last = len(weights.layers) - 1
    for i, (wt, b) in enumerate(weights.layers):
        h = wt.float() @ h + b
        if i < last:
            h = torch.relu(h)
            if bf16:
                h = h.to(torch.bfloat16).float()
    if final_softmax:
        h = torch.softmax(h, dim=0)
    return h[out_col]


def predictions_plain(packed: PackedPlan, xc: torch.Tensor, n: int) -> list:
    """Every MLP slot's kept column over rows [0, n), in slot order (a
    feature may read an earlier slot's prediction)."""
    plan = packed.plan
    preds: list = []
    for m, w in zip(plan.mlps, packed.weights):
        feats = torch.stack([eval_program(f, plan.consts, xc, n, preds) for f in m.features])
        preds.append(mlp_plain(w, feats, m.final_softmax, m.out_col))
    return preds


def key_to_int32(r: torch.Tensor) -> torch.Tensor:
    """int32(r) as the kernel converts (``__float2int_rz``): toward zero,
    saturating, NaN to 0; as int64."""
    return torch.nan_to_num(r.double(), nan=0.0).trunc().clamp(-2**31, 2**31 - 1).to(torch.int64)


def _group_min_max(vals: torch.Tensor, slot: torch.Tensor, G: int, is_min: bool):
    fill = math.inf if is_min else -math.inf
    out = torch.full((G + 1,), fill, dtype=torch.float32, device=vals.device)
    out = out.scatter_reduce(0, slot, vals, "amin" if is_min else "amax", include_self=True)
    nan = torch.zeros(G + 1, dtype=torch.float32, device=vals.device)
    nan.index_add_(0, slot, torch.isnan(vals).to(torch.float32))
    return torch.where(nan > 0, torch.full_like(out, math.nan), out)[:G]


def fused_sql_plain(packed: PackedPlan, xc: torch.Tensor, n_valid: int) -> dict:
    """K2's function in plain torch ops. Returns the kernel's result:
    ``count`` [G] int64, ``sums`` [S, G] f64, ``mm`` [M + X + 2K, G] f32
    (the min slots, the max slots, then per key the raw-key min and max) and
    ``flags`` [1] int32 (bit k: key k held a fractional value; bit K: a key
    with |value| >= 2**24)."""
    plan = packed.plan
    G, K = plan.n_groups, len(plan.keys)
    n = n_valid
    dev = xc.device
    preds = predictions_plain(packed, xc, n)

    def run(code):
        return eval_program(code, plan.consts, xc, n, preds)

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
    return {"count": count, "sums": sums[:, :G], "mm": mm,
            "flags": torch.tensor([flags], dtype=torch.int32, device=dev)}


# --------------------------------------------------------------------------- kernel


def fused_sql(packed: PackedPlan, xc: torch.Tensor, n_valid: int) -> dict:
    """K2 over rows [0, n_valid) of the table block ``xc [C, n_pad]`` f32;
    returns ``fused_sql_plain``'s dict."""
    if xc.device.type == "cpu":
        return fused_sql_plain(packed, xc, n_valid)
    _kernels.require_cuda(xc, "table block")
    if xc.dtype != torch.float32 or xc.dim() != 2 or not 1 <= n_valid <= xc.shape[1]:
        raise ValueError(f"table block must be f32 [C, n_pad >= {n_valid}], "
                         f"got {xc.dtype} {tuple(xc.shape)}")
    if packed.words.device != xc.device:
        raise ValueError(f"plan on {packed.words.device}, table on {xc.device}")
    smem = packed.smem_bytes
    if smem > SMEM_LIMIT:
        raise ValueError(f"plan needs {smem} bytes of shared memory, over {SMEM_LIMIT}")
    plan = packed.plan
    G, S = plan.n_groups, len(plan.sums)
    R = len(plan.mins) + len(plan.maxs) + 2 * len(plan.keys)
    dev = xc.device
    n_blocks = _kernels.grid_blocks(dev, -(-n_valid // SLOT_ROWS), smem)
    part_cnt = torch.empty((n_blocks, G), dtype=torch.int64, device=dev)
    part_sum = torch.empty((n_blocks, S, G), dtype=torch.float64, device=dev)
    part_mm = torch.empty((n_blocks, R, G), dtype=torch.float32, device=dev)
    part_flags = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    out = {"count": torch.empty(G, dtype=torch.int64, device=dev),
           "sums": torch.empty((S, G), dtype=torch.float64, device=dev),
           "mm": torch.empty((R, G), dtype=torch.float32, device=dev),
           "flags": torch.empty(1, dtype=torch.int32, device=dev)}
    lib = _kernels.load("fused_sql")
    stream = _kernels.stream_handle(dev)
    rc = lib.infera_fused_sql(
        xc.data_ptr(), xc.shape[1], n_valid, packed.words.data_ptr(), packed.blob.data_ptr(),
        packed.blob.numel(), part_cnt.data_ptr(), part_sum.data_ptr(), part_mm.data_ptr(),
        part_flags.data_ptr(), n_blocks, smem, stream)
    _kernels.check(lib, rc, "fused_sql")
    rc = lib.infera_fused_sql_fold(
        part_cnt.data_ptr(), part_sum.data_ptr(), part_mm.data_ptr(), part_flags.data_ptr(),
        n_blocks, G, S, len(plan.mins), len(plan.maxs), len(plan.keys), out["count"].data_ptr(),
        out["sums"].data_ptr(), out["mm"].data_ptr(), out["flags"].data_ptr(), stream)
    _kernels.check(lib, rc, "fused_sql fold")
    fused_sql.launches["bf16" if plan.bf16 else "f32"] += 1
    return out


fused_sql.launches = {"f32": 0, "bf16": 0}


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


def execute_fused_plan(packed: PackedPlan, xc: torch.Tensor, n_valid: int) -> dict | None:
    """Run K2 (or its plain version on the CPU) and hand back host arrays in
    the contract of ``infera_tpu``'s ``execute_fused_plan``: ``count`` [G],
    ``sums`` [(sum f64, 0) per slot], ``mins``/``maxs`` [G] per slot,
    ``kmins``/``kmaxs`` [G] per key, ``fracs`` [bool per key]. None when a
    key reached |value| >= 2**24: past f32's exact integers two keys could
    share a bucket unseen, so the host executor answers."""
    plan = packed.plan
    res = fused_sql(packed, xc, n_valid)
    count = res["count"].cpu().numpy()
    sums = res["sums"].cpu().numpy()
    mm = res["mm"].cpu().numpy()
    flags = int(res["flags"].cpu()[0])
    K, M, X = len(plan.keys), len(plan.mins), len(plan.maxs)
    if flags >> K & 1:
        return None
    zeros = np.zeros(plan.n_groups, np.float64)
    return {
        "count": count,
        "sums": [(sums[i], zeros) for i in range(len(plan.sums))],
        "mins": [mm[i] for i in range(M)],
        "maxs": [mm[M + i] for i in range(X)],
        "kmins": [mm[M + X + i] for i in range(K)],
        "kmaxs": [mm[M + X + K + i] for i in range(K)],
        "fracs": [bool(flags >> i & 1) for i in range(K)],
    }
