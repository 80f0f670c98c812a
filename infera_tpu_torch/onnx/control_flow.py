"""ONNX control-flow operators: If / Loop / Scan.

Counterpart of ``infera_tpu/onnx/control_flow.py``, which lowers them to
``lax.cond`` / ``while_loop`` / ``scan`` inside one XLA computation. Here
they are Python loops over eager subgraph runs (``_Ctx.run_subgraph``, with
outer-scope capture), and the host decides only what it must:

- ``If``: a static condition folds to its branch; a runtime condition is
  read on the host (one sync) and only the chosen branch runs. ``lax.cond``
  refuses branches whose outputs differ in shape or dtype; the port compares
  the branches' declared output types at load (``check_branches``) and
  refuses the same graphs where both declare them.
- ``Loop`` without scan outputs: exact early exit; the trip count is read on
  the host, no trip count means "until cond is false", and a condition that
  is a device value is read each iteration (one sync), unless it is known on
  the host (a static value, or the very tensor the loop passed in).
- ``Loop`` with scan outputs: a static trip count M is required, all M
  iterations run, carried values freeze once the condition fails (a
  ``torch.where``, no sync), and each iteration adds its scan row.
- ``Scan``: scan axes moved to the front, reversed directions flipped.

The refusals keep ``infera_tpu``'s message prefixes (the part before ``: ``
and the JAX error it wraps).
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import OnnxError
from . import proto
from .ops import register

# JAX's x64 is off in infera_tpu: these declared types meet as one there
_CANONICAL = {proto.DataType.DOUBLE: proto.DataType.FLOAT,
              proto.DataType.INT64: proto.DataType.INT32,
              proto.DataType.UINT64: proto.DataType.UINT32}


def _branch_mismatch(then_g: proto.Graph, else_g: proto.Graph):
    """Why the branches' declared outputs cannot meet under ``lax.cond``, or
    None. Outputs that declare no type are not compared."""
    if len(then_g.outputs) != len(else_g.outputs):
        return (f"then_branch has {len(then_g.outputs)} outputs, "
                f"else_branch {len(else_g.outputs)}")
    for a, b in zip(then_g.outputs, else_g.outputs):
        if not (a.has_shape and b.has_shape):
            continue
        ta, tb = (_CANONICAL.get(t, t) for t in (a.elem_type, b.elem_type))
        if ta != tb:
            return f"output types {a.elem_type} and {b.elem_type} differ"
        if len(a.shape) != len(b.shape) or any(
                x > 0 and y > 0 and x != y for x, y in zip(a.shape, b.shape)):
            return f"output shapes {list(a.shape)} and {list(b.shape)} differ"
    return None


def check_branches(node) -> None:
    """At load: record on an If node why its branches cannot run under a
    runtime condition (None when they can, or when nothing is declared)."""
    then_g = node.attr("then_branch")
    else_g = node.attr("else_branch")
    node._infera_branch_mismatch = (
        None if then_g is None or else_g is None else _branch_mismatch(then_g, else_g))


@register("If", host=True)
def op_if(node, inputs, ctx):
    then_g = node.attr("then_branch")
    else_g = node.attr("else_branch")
    if then_g is None or else_g is None:
        raise OnnxError(f"If '{node.name}': missing then/else branch graph")
    cond = inputs[0]
    static = ctx.as_static(cond)
    if static is not None:
        chosen = then_g if bool(np.asarray(static).reshape(())) else else_g
        return list(ctx.run_subgraph(chosen, []))
    why = getattr(node, "_infera_branch_mismatch", None)
    if why is not None:
        raise OnnxError(
            f"If '{node.name}': branches must produce matching "
            f"shapes/dtypes under a traced condition: {why}")
    take = bool(cond.reshape(()).item())  # the one sync
    outs = ctx.run_subgraph(then_g if take else else_g, [])
    # under lax.cond the outputs are traced, never static
    return [ctx.tensor(node, ("out", k), o) for k, o in enumerate(outs)]


class _Cond:
    """A loop condition: a bool device tensor, and its value when the host
    knows it without a sync (None otherwise)."""

    def __init__(self, t: torch.Tensor, known):
        self.t = t
        self.known = known

    def value(self) -> bool:
        return self.known if self.known is not None else bool(self.t.item())


def _carried_check(what, old, new) -> None:
    for k, (a, b) in enumerate(zip(old, new)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise OnnxError(
                f"{what}: value {k} is {a.dtype}{list(a.shape)} before the "
                f"body and {b.dtype}{list(b.shape)} after it")


@register("Loop", host=True)
def op_loop(node, inputs, ctx):
    body = node.attr("body")
    if body is None:
        raise OnnxError(f"Loop '{node.name}': missing body graph")
    m_in, cond_in = inputs[0], inputs[1]
    vs = [ctx.tensor(node, 2 + k, v) for k, v in enumerate(inputs[2:])]
    n_state = len(vs)
    # body: (iter_num, cond, v_1..v_N) -> (cond, v_1..v_N, scan_1..scan_K)
    n_scan = len(body.outputs) - 1 - n_state
    if n_scan < 0:
        raise OnnxError(
            f"Loop '{node.name}': body declares {len(body.outputs)} outputs "
            f"for {n_state} loop-carried values")
    refuse = (f"Loop '{node.name}': body must preserve the shapes/dtypes "
              f"of loop-carried values")
    # the two conditions the host knows, as device tensors made once
    flags = (ctx.tensor(node, "false", np.asarray(False)),
             ctx.tensor(node, "true", np.asarray(True)))

    def as_cond(value) -> _Cond:
        if value is None:
            return _Cond(flags[1], True)
        for known, t in enumerate(flags):
            if value is t:
                return _Cond(t, bool(known))
        static = ctx.as_static(value)
        if static is not None:
            known = bool(np.asarray(static).reshape(()))
            return _Cond(flags[known], known)
        return _Cond(value.reshape(()).bool(), None)

    def run_body(i_t, cond: _Cond, vs):
        outs = ctx.run_subgraph(body, [i_t, cond.t, *vs])
        new_vs = [ctx.tensor(node, ("v", k), o) for k, o in enumerate(outs[1:1 + n_state])]
        _carried_check(refuse, vs, new_vs)
        scans = [ctx.tensor(node, ("s", k), o) for k, o in enumerate(outs[1 + n_state:])]
        return as_cond(outs[0]), new_vs, scans

    m_static = ctx.as_static(m_in) if m_in is not None else None
    cond = as_cond(cond_in)
    if n_scan == 0:
        # exact ONNX semantics incl. early exit; the trip count is read on
        # the host (infera_tpu's is int32)
        if m_in is None:
            m = np.iinfo(np.int32).max
        elif m_static is not None:
            m = int(np.asarray(m_static).reshape(()))
        else:
            m = int(m_in.reshape(()).item())
        i_t = ctx.tensor(node, "i0", np.asarray(0, np.int64))
        k = 0
        while k < m and cond.value():
            cond, vs, _ = run_body(i_t, cond, vs)
            k += 1
            i_t = i_t + 1
        return vs

    # scan outputs: infera_tpu's lax.scan needs a static trip count. All M
    # iterations run; carried values freeze after the exit, and the rows
    # after it come from the body run on the frozen values.
    if m_static is None:
        raise OnnxError(
            f"Loop '{node.name}': scan outputs require a statically known "
            f"trip count (XLA cannot size outputs dynamically)")
    m = int(np.asarray(m_static).reshape(()))
    iters = torch.arange(max(m, 1), device=ctx.device)
    rows = [[] for _ in range(n_scan)]
    for k in range(max(m, 0)):
        new_cond, new_vs, scans = run_body(iters[k], cond, vs)
        if cond.known is None:
            vs = [torch.where(cond.t, nv, v) for nv, v in zip(new_vs, vs)]
        elif cond.known:
            vs = new_vs
        if cond.known is False or new_cond.known is False:
            cond = _Cond(flags[0], False)
        elif cond.known and new_cond.known:
            cond = _Cond(flags[1], True)
        else:
            cond = _Cond(torch.logical_and(cond.t, new_cond.t), None)
        for r, s in zip(rows, scans):
            r.append(s)
    if m <= 0:  # no iteration: one run of the body gives the rows' shapes
        scans = run_body(iters[0], cond, vs)[2]
        return vs + [s.new_empty((0, *s.shape)) for s in scans]
    try:
        return vs + [torch.stack(r) for r in rows]
    except RuntimeError as e:
        raise OnnxError(f"{refuse}: {e}")


@register("Scan", host=True)
def op_scan(node, inputs, ctx):
    body = node.attr("body")
    if body is None:
        raise OnnxError(f"Scan '{node.name}': missing body graph")
    n_scan_in = int(node.attr("num_scan_inputs", 0))
    if n_scan_in <= 0 or n_scan_in > len(inputs):
        raise OnnxError(f"Scan '{node.name}': bad num_scan_inputs {n_scan_in}")
    n_state = len(inputs) - n_scan_in
    states = [ctx.tensor(node, k, v) for k, v in enumerate(inputs[:n_state])]
    xs = [ctx.tensor(node, n_state + k, v) for k, v in enumerate(inputs[n_state:])]
    n_out_scan = len(body.outputs) - n_state
    if n_out_scan < 0:
        raise OnnxError(
            f"Scan '{node.name}': body declares {len(body.outputs)} outputs "
            f"for {n_state} state variables")
    refuse = (f"Scan '{node.name}': body must preserve state shapes/dtypes "
              f"and scan inputs must share a leading length")

    in_axes = list(node.attr("scan_input_axes", [0] * n_scan_in))
    in_dirs = list(node.attr("scan_input_directions", [0] * n_scan_in))
    out_axes = list(node.attr("scan_output_axes", [0] * n_out_scan))
    out_dirs = list(node.attr("scan_output_directions", [0] * n_out_scan))

    moved = []
    for x, ax, d in zip(xs, in_axes, in_dirs):
        x = torch.movedim(x, ax % x.dim(), 0)
        if d:  # reverse direction
            x = torch.flip(x, (0,))
        moved.append(x)
    lengths = [x.shape[0] for x in moved]
    if len(set(lengths)) > 1:  # lax.scan's own refusal, which infera_tpu passes on
        raise OnnxError("scan got values with different leading axis sizes: "
                        + ", ".join(str(n) for n in lengths) + ".")

    def step(t, states):
        outs = ctx.run_subgraph(body, [*states, *(x[t] for x in moved)])
        new_states = [ctx.tensor(node, ("v", k), o) for k, o in enumerate(outs[:n_state])]
        _carried_check(refuse, states, new_states)
        return new_states, [ctx.tensor(node, ("s", k), o) for k, o in enumerate(outs[n_state:])]

    rows = [[] for _ in range(n_out_scan)]
    for t in range(lengths[0]):
        states, scans = step(t, states)
        for r, s in zip(rows, scans):
            r.append(s)
    if lengths[0] == 0:  # no step: the body on empty rows gives the shapes
        moved = [x.new_zeros((1, *x.shape[1:])) for x in moved]
        ys = [s.new_empty((0, *s.shape)) for s in step(0, states)[1]]
    else:
        try:
            ys = [torch.stack(r) for r in rows]
        except RuntimeError as e:
            raise OnnxError(f"{refuse}: {e}")
    outs = list(states)
    for k, y in enumerate(ys):
        if out_dirs[k]:
            y = torch.flip(y, (0,))
        outs.append(torch.movedim(y, 0, out_axes[k] % y.dim()))
    return outs
