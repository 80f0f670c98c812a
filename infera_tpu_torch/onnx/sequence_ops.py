"""ONNX Sequence and Optional ops: the static-structure subset.

Counterpart of ``infera_tpu/onnx/sequence_ops.py``. A sequence is a Python
tuple of values and an Optional is ``None`` or its value, so the structure
(length, membership) is known on the host while the elements stay tensors on
the device, or numpy where they are static, as in ``infera_tpu``'s
trace-time tuples. Positions and split sizes must be static (an
initializer or a folded value): a position computed from tensor values is
refused, as ``infera_tpu`` refuses it. Every op is registered ``host=True``
(its inputs come as they are: a tuple cannot become one tensor); the two
that compute on elements move them to the device themselves. A sequence as a
graph output is refused by the executor with ``infera_tpu``'s message.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import OnnxError
from .ops import _fill_value, register


def _static_int(node, v, what: str) -> int:
    """A position or length operand must be static: a tensor's value is
    data-dependent structure, which ``infera_tpu`` cannot trace."""
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, np.ndarray):
        return int(v.reshape(()))
    raise OnnxError(
        f"{node.op_type}: {what} must be static (trace-time constant); "
        f"data-dependent sequence structure has no fixed-shape form")


def _as_seq(node, v):
    if isinstance(v, tuple):
        return v
    raise OnnxError(f"{node.op_type}: input is not a sequence")


def _norm_pos(pos: int, n: int, insert: bool = False) -> int:
    hi = n if insert else n - 1
    p = pos + n if pos < 0 else pos
    if p < 0 or p > hi:
        raise OnnxError(f"sequence position {pos} out of range for length {n}")
    return p


@register("SequenceEmpty", host=True)
def _seq_empty(node, inputs, ctx):
    return [()]


@register("SequenceConstruct", host=True)
def _seq_construct(node, inputs, ctx):
    return [tuple(inputs)]


@register("SequenceLength", host=True)
def _seq_length(node, inputs, ctx):
    return [np.int64(len(_as_seq(node, inputs[0])))]


@register("SequenceAt", host=True)
def _seq_at(node, inputs, ctx):
    seq = _as_seq(node, inputs[0])
    return [seq[_norm_pos(_static_int(node, inputs[1], "position"), len(seq))]]


@register("SequenceInsert", host=True)
def _seq_insert(node, inputs, ctx):
    seq = _as_seq(node, inputs[0])
    if len(inputs) > 2 and inputs[2] is not None:
        pos = _norm_pos(_static_int(node, inputs[2], "position"), len(seq), insert=True)
    else:
        pos = len(seq)
    return [seq[:pos] + (inputs[1],) + seq[pos:]]


@register("SequenceErase", host=True)
def _seq_erase(node, inputs, ctx):
    seq = _as_seq(node, inputs[0])
    if len(inputs) > 1 and inputs[1] is not None:
        pos = _norm_pos(_static_int(node, inputs[1], "position"), len(seq))
    else:
        pos = len(seq) - 1
        if pos < 0:
            raise OnnxError("SequenceErase on empty sequence")
    return [seq[:pos] + seq[pos + 1:]]


@register("ConcatFromSequence", host=True)
def _concat_from_seq(node, inputs, ctx):
    seq = _as_seq(node, inputs[0])
    if not seq:
        raise OnnxError("ConcatFromSequence on empty sequence")
    axis = node.attr("axis")
    ts = [ctx.tensor(node, ("element", k), t) for k, t in enumerate(seq)]
    if node.attr("new_axis", 0):
        return [torch.stack(ts, dim=axis)]
    return [torch.cat(ts, dim=axis)]


def _piece(x, axis, start, size):
    """``jnp.take(x, arange(start, start + size), axis)``: past the end fills."""
    n = x.shape[axis]
    stop = min(start + size, n)
    out = x.narrow(axis, min(start, n), max(stop - start, 0))
    if stop - start < size:
        shape = list(x.shape)
        shape[axis] = size - max(stop - start, 0)
        out = torch.cat([out, torch.full(shape, _fill_value(x.dtype), dtype=x.dtype,
                                         device=x.device)], dim=axis)
    return out


@register("SplitToSequence", host=True)
def _split_to_seq(node, inputs, ctx):
    x = ctx.tensor(node, 0, inputs[0])
    axis = node.attr("axis", 0)
    n = x.shape[axis]
    if len(inputs) > 1 and inputs[1] is not None:
        split = inputs[1]
        if isinstance(split, np.generic):
            split = np.asarray(split)
        if not isinstance(split, np.ndarray):
            raise OnnxError("SplitToSequence: split sizes must be static")
        if split.ndim == 0:
            size = int(split)
            sizes = [size] * (n // size) + ([n % size] if n % size else [])
        else:
            sizes = [int(s) for s in split]
        out, start = [], 0
        for s in sizes:
            out.append(_piece(x, axis, start, s))
            start += s
        return [tuple(out)]
    # no split operand: one element a slice, the axis squeezed unless keepdims
    keep = node.attr("keepdims", 1)
    return [tuple(x.narrow(axis, i, 1) if keep else x.select(axis, i) for i in range(n))]


# --- Optional ---------------------------------------------------------------

@register("Optional", host=True)
def _optional(node, inputs, ctx):
    return [inputs[0] if inputs else None]


@register("OptionalHasElement", host=True)
def _optional_has(node, inputs, ctx):
    return [np.asarray(bool(inputs) and inputs[0] is not None)]


@register("OptionalGetElement", host=True)
def _optional_get(node, inputs, ctx):
    if inputs[0] is None:
        raise OnnxError("OptionalGetElement on empty optional")
    return [inputs[0]]
