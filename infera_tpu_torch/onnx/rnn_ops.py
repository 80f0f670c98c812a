"""ONNX recurrent ops: RNN, GRU and LSTM.

Counterpart of ``infera_tpu/onnx/rnn_ops.py``, which scans over time with
``lax.scan``. Here the input projection X·Wᵀ + Wb (with the recurrent bias
Rb folded in) runs for every step at once, as one matmul over seq·batch
rows, and then one step at a time: per step one matmul of the hidden state
against Rᵀ for every gate (``torch.addmm``) and the gates' elementwise
math. Torch's own ``nn.LSTM``/``nn.GRU`` are not used: their gate orders
(ifgo, rzn) differ from ONNX's (LSTM iofc, GRU zrh), and GRU's
``linear_before_reset=0`` has no torch form.

Layouts follow the ONNX spec: X [seq, batch, input]; W [dirs, G*hidden,
input]; R [dirs, G*hidden, hidden]; B [dirs, 2*G*hidden]; outputs Y [seq,
dirs, batch, hidden], Y_h [dirs, batch, hidden] (and Y_c for LSTM).
Directions: forward, reverse and bidirectional. As in ``infera_tpu``, only
the default activations run, and ``sequence_lens`` and LSTM's peepholes
are refused.
"""

from __future__ import annotations

import torch

from ..errors import OnnxError
from .ops import register


def _dirs(node):
    d = node.attr("direction", "forward")
    if isinstance(d, bytes):
        d = d.decode()
    if d not in ("forward", "reverse", "bidirectional"):
        raise OnnxError(f"{node.op_type}: unknown direction {d}")
    return d


def _check_unsupported(node, inputs, seq_lens_idx):
    if len(inputs) > seq_lens_idx and inputs[seq_lens_idx] is not None:
        raise OnnxError(f"{node.op_type}: sequence_lens not supported")
    acts = node.attr("activations")
    if acts:
        names = [a.decode() if isinstance(a, bytes) else a for a in acts]
        n = len(names) // 2 if _dirs(node) == "bidirectional" else len(names)
        defaults = {"RNN": ["Tanh"], "GRU": ["Sigmoid", "Tanh"],
                    "LSTM": ["Sigmoid", "Tanh", "Tanh"]}[node.op_type]
        for i, a in enumerate(names):
            if a != defaults[i % n if n else 0] and a not in defaults:
                raise OnnxError(f"{node.op_type}: activation {a} not supported")


def _prep(node, inputs, b_idx, h_idx):
    x = inputs[0].float()       # [seq, batch, input]
    w = inputs[1].float()       # [dirs, G*h, input]
    r = inputs[2].float()       # [dirs, G*h, h]
    hidden = int(node.attr("hidden_size", r.shape[-1]))
    n_dirs, batch = w.shape[0], x.shape[1]
    b = inputs[b_idx].float() if len(inputs) > b_idx and inputs[b_idx] is not None else None
    h0 = inputs[h_idx].float() if len(inputs) > h_idx and inputs[h_idx] is not None else None
    if h0 is None:
        h0 = torch.zeros((n_dirs, batch, hidden), device=x.device)
    return x, w, r, b, h0, hidden, n_dirs


def _directions(node, n_dirs):
    """(index, reverse) of each direction."""
    direction = _dirs(node)
    return [(d, direction == "reverse" or (direction == "bidirectional" and d == 1))
            for d in range(n_dirs)]


def _projection(x, w_d, bias):
    """[seq, batch, input] @ w_dᵀ + bias → [seq, batch, G*h], every step."""
    seq, batch, _ = x.shape
    proj = torch.matmul(x.reshape(seq * batch, -1), w_d.T)
    if bias is not None:
        proj = proj + bias
    return proj.reshape(seq, batch, -1)


def _steps(seq, reverse):
    return range(seq - 1, -1, -1) if reverse else range(seq)


@register("RNN")
def _rnn(node, inputs, ctx):
    _check_unsupported(node, inputs, 4)
    x, w, r, b, h0, hidden, n_dirs = _prep(node, inputs, 3, 5)
    ys_dirs, h_dirs = [], []
    for d, reverse in _directions(node, n_dirs):
        bias = b[d, :hidden] + b[d, hidden:] if b is not None else None
        xp = _projection(x, w[d], bias)
        r_t = r[d].T
        h = h0[d]
        ys = [None] * x.shape[0]
        for t in _steps(x.shape[0], reverse):
            h = torch.tanh(torch.addmm(xp[t], h, r_t))
            ys[t] = h
        ys_dirs.append(torch.stack(ys, 0))
        h_dirs.append(h)
    return [torch.stack(ys_dirs, 1), torch.stack(h_dirs, 0)]


@register("GRU")
def _gru(node, inputs, ctx):
    _check_unsupported(node, inputs, 4)
    x, w, r, b, h0, hidden, n_dirs = _prep(node, inputs, 3, 5)
    lbr = bool(node.attr("linear_before_reset", 0))
    ys_dirs, h_dirs = [], []
    for d, reverse in _directions(node, n_dirs):
        h2 = 2 * hidden
        if b is not None:
            wb, rb = b[d, :3 * hidden], b[d, 3 * hidden:]
            # the z and r gates' recurrent bias folds into the projection;
            # h's stays inside the reset product when linear_before_reset
            bias = wb + torch.cat([rb[:h2], torch.zeros_like(rb[h2:]) if lbr else rb[h2:]])
            rbh = rb[h2:]
        else:
            bias, rbh = None, None
        xp = _projection(x, w[d], bias)
        r_t = r[d].T  # [h, 3h]: the z, r and h gates' columns
        h = h0[d]
        ys = [None] * x.shape[0]
        for t in _steps(x.shape[0], reverse):
            xt = xp[t]
            if lbr:
                g = torch.matmul(h, r_t)
                zr = torch.sigmoid(xt[:, :h2] + g[:, :h2])
                hg = g[:, h2:] if rbh is None else g[:, h2:] + rbh
                hh = torch.tanh(xt[:, h2:] + zr[:, hidden:] * hg)
            else:
                zr = torch.sigmoid(torch.addmm(xt[:, :h2], h, r_t[:, :h2]))
                hh = torch.tanh(torch.addmm(xt[:, h2:], zr[:, hidden:] * h, r_t[:, h2:]))
            z = zr[:, :hidden]
            h = (1.0 - z) * hh + z * h
            ys[t] = h
        ys_dirs.append(torch.stack(ys, 0))
        h_dirs.append(h)
    return [torch.stack(ys_dirs, 1), torch.stack(h_dirs, 0)]


@register("LSTM")
def _lstm(node, inputs, ctx):
    _check_unsupported(node, inputs, 4)
    if len(inputs) > 7 and inputs[7] is not None:
        raise OnnxError("LSTM: peepholes (P) not supported")
    x, w, r, b, h0, hidden, n_dirs = _prep(node, inputs, 3, 5)
    c0 = inputs[6].float() if len(inputs) > 6 and inputs[6] is not None else None
    if c0 is None:
        c0 = torch.zeros((n_dirs, x.shape[1], hidden), device=x.device)
    h3 = 3 * hidden
    ys_dirs, h_dirs, c_dirs = [], [], []
    for d, reverse in _directions(node, n_dirs):
        bias = b[d, :4 * hidden] + b[d, 4 * hidden:] if b is not None else None
        xp = _projection(x, w[d], bias)
        r_t = r[d].T
        h, c = h0[d], c0[d]
        ys = [None] * x.shape[0]
        for t in _steps(x.shape[0], reverse):
            gates = torch.addmm(xp[t], h, r_t)         # i, o, f, c
            iof = torch.sigmoid(gates[:, :h3])
            g = torch.tanh(gates[:, h3:])
            c = iof[:, 2 * hidden:] * c + iof[:, :hidden] * g
            h = iof[:, hidden:2 * hidden] * torch.tanh(c)
            ys[t] = h
        ys_dirs.append(torch.stack(ys, 0))
        h_dirs.append(h)
        c_dirs.append(c)
    return [torch.stack(ys_dirs, 1), torch.stack(h_dirs, 0), torch.stack(c_dirs, 0)]
