"""Graph pattern fusion: recognize MLP-shaped ONNX graphs and run them
through the fused MLP kernel K6 (f32) or the fused int8 chain (int8).

Counterpart of ``infera_tpu/onnx/fusion.py``. Detection walks the graph for
the exact chain
``X → (MatMul|Gemm)(+bias) → Relu → ... → (MatMul|Gemm)(+bias) [→ Softmax] → Y``
with all weights as initializers (``detect_mlp`` and ``detect_tree`` are
copied unchanged; they are numpy).

Path selection: a matched f32 model whose widths fit K6's shared-memory
budget always runs K6 on CUDA (its plain version on the CPU). There is no
timed kernel-vs-graph probe: a probe could quietly hide the kernel.
``INFERA_PALLAS_MLP=0`` selects the op-by-op graph path; a model above the
budget takes that path too. An int8 model runs ``maybe_run_int8_fused``
once its activation scales are calibrated; ``infera_tpu`` computes that chain
in XLA, outside any Pallas kernel, and the port in torch ops.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.fused_mlp import fused_mlp, mlp_weights, smem_fits
from . import proto
from .ops import _quantize_weight_int8, int8_matmul, int8_weight_tensors


def detect_mlp(graph: proto.Graph):
    """Return (params [(w, b), ...], final_softmax, matmul_nodes) or None.
    ``matmul_nodes`` aligns with params — the int8 fused path reads each
    layer's calibrated activation scale off its node."""
    runtime_inputs = [v.name for v in graph.inputs
                      if v.name not in graph.initializers]
    if len(runtime_inputs) != 1 or len(graph.outputs) != 1:
        return None
    # consumer map: value name → list of consuming nodes
    consumers: dict = {}
    for node in graph.nodes:
        for i in node.inputs:
            consumers.setdefault(i, []).append(node)

    def only_consumer(name):
        c = consumers.get(name, [])
        return c[0] if len(c) == 1 else None

    def init_array(name):
        t = graph.initializers.get(name)
        return None if t is None else np.asarray(t.array)

    params = []
    matmul_nodes = []
    cur = runtime_inputs[0]
    out_name = graph.outputs[0].name
    final_softmax = False
    while True:
        node = only_consumer(cur)
        if node is None:
            return None
        if node.op_type in ("MatMul", "Gemm"):
            if node.op_type == "Gemm" and (
                node.attr("transA", 0) or node.attr("alpha", 1.0) != 1.0
                or node.attr("beta", 1.0) != 1.0
            ):
                return None
            w = init_array(node.inputs[1])
            if w is None or w.ndim != 2:
                return None
            if node.op_type == "Gemm" and node.attr("transB", 0):
                w = w.T
            b = None
            nxt = node.outputs[0]
            if node.op_type == "Gemm" and len(node.inputs) > 2:
                b = init_array(node.inputs[2])
            else:
                add = only_consumer(nxt)
                if add is not None and add.op_type == "Add":
                    cand = (init_array(add.inputs[1])
                            if add.inputs[0] == nxt else init_array(add.inputs[0]))
                    if cand is not None and cand.ndim == 1:
                        b = cand
                        nxt = add.outputs[0]
            if b is None:
                b = np.zeros(w.shape[1], np.float32)
            if b.shape != (w.shape[1],):
                return None
            params.append((w.astype(np.float32), b.astype(np.float32)))
            matmul_nodes.append(node)
            cur = nxt
        elif node.op_type == "Relu":
            if not params:
                return None
            cur = node.outputs[0]
        elif node.op_type == "Softmax":
            if node.attr("axis", -1) not in (-1, 1):
                return None
            final_softmax = True
            cur = node.outputs[0]
            break
        elif node.op_type == "Identity":
            cur = node.outputs[0]
        else:
            return None
        if cur == out_name:
            break
    if cur != out_name or not params:
        return None
    # activations between layers must be Relu (already enforced by the walk:
    # anything else bailed out)
    return params, final_softmax, matmul_nodes


def detect_tree(graph: proto.Graph):
    """Return (node, is_classifier) when the graph is a single ai.onnx.ml
    TreeEnsemble node (Identity wrappers allowed) — the shape the SQL
    Pallas lowerer turns into an in-kernel GEMM forest. None otherwise."""
    runtime_inputs = [v.name for v in graph.inputs
                      if v.name not in graph.initializers]
    if len(runtime_inputs) != 1:
        return None
    core = [n for n in graph.nodes if n.op_type != "Identity"]
    if len(core) != 1:
        return None
    node = core[0]
    if node.op_type not in ("TreeEnsembleRegressor",
                            "TreeEnsembleClassifier"):
        return None
    # the tree input must resolve to the runtime input through Identities
    alias = {}
    for n in graph.nodes:
        if n.op_type == "Identity":
            alias[n.outputs[0]] = n.inputs[0]
    src = node.inputs[0]
    seen = 0
    while src in alias and seen < len(alias) + 1:
        src = alias[src]
        seen += 1
    if src != runtime_inputs[0]:
        return None
    return node, node.op_type == "TreeEnsembleClassifier"


def mlp_weights_for(plan, device):
    """K6's weights on ``device`` for a matched plan within the kernel's
    budget, moved there once at load; None otherwise."""
    if plan is None:
        return None
    params = plan[0]
    dims = [params[0][0].shape[0]] + [w.shape[1] for w, _ in params]
    if not smem_fits(dims):
        return None
    return mlp_weights(params, device)


def maybe_run_fused(model, x):
    """Run ``x`` through K6 when the model matched and fits the kernel.
    Returns the output tensor, or None for the op-by-op graph path."""
    weights = model.mlp_weights
    if weights is None or os.environ.get("INFERA_PALLAS_MLP") == "0":
        return None
    if x.dim() != 2 or x.shape[1] != weights.dims[0] or x.dtype != torch.float32:
        return None
    return fused_mlp(weights, x.contiguous(), final_softmax=model.mlp_plan[1])


def _int8_chain(nodes, params, scales, final_softmax, device):
    """The fused int8 forward of ``infera_tpu``'s ``maybe_run_int8_fused``
    with its constants on ``device``: hidden activations stay int8 between
    layers, each requantized in its layer's epilogue as
    q = clip(rint(max(y * comb + bq, 0)), 0, 127) with
    comb = w_scale * (s_i / s_{i+1}) and bq = b / s_{i+1} (f32, computed in
    numpy as ``infera_tpu`` computes them, so they are bit-equal)."""
    n_layers = len(params)
    inv0 = float(np.float32(1.0 / scales[0]))
    layers = []
    for i, (nd, (w, b)) in enumerate(zip(nodes, params)):
        w_q, _ = int8_weight_tensors(nd, w, device)
        w_scale = _quantize_weight_int8(nd, w)[1]
        if i < n_layers - 1:
            comb = np.asarray(w_scale * np.float32(scales[i] / scales[i + 1]), np.float32)
            bias = np.asarray(b / np.float32(scales[i + 1]), np.float32)
        else:
            comb = np.asarray(w_scale * np.float32(scales[i]), np.float32)
            bias = np.asarray(b, np.float32)
        layers.append((w_q, torch.as_tensor(comb, device=device),
                       torch.as_tensor(bias, device=device)))

    def forward(x):
        q = torch.clamp(torch.round(x * inv0), -127, 127).to(torch.int8)
        for i, (w_q, comb, bias) in enumerate(layers):
            # a multiply, then an add: two roundings, as K7b's epilogue (XLA
            # on the CPU contracts them into one FMA: an ulp apart)
            t = int8_matmul(q, w_q) * comb + bias
            if i < n_layers - 1:
                # ReLU and requantize in one epilogue, written as int8
                q = torch.clamp(torch.round(torch.clamp_min(t, 0.0)), 0, 127).to(torch.int8)
        return torch.softmax(t, dim=-1) if final_softmax else t

    return forward


def maybe_run_int8_fused(model, x):
    """Run ``x`` through the fused int8 MLP chain: hidden activations stay
    int8 between layers instead of round-tripping through f32. Needs the
    calibrated per-tensor activation scales. Returns the output tensor, or
    None when there is no plan, ``x`` has the wrong shape, or a node is
    uncalibrated (the caller runs the graph's per-layer path).

    The chain's constants are cached on the model under the input shape and
    the scales: a re-calibration with new scales must not reuse old ones."""
    plan = model.mlp_plan
    if plan is None or len(plan) < 3:
        return None
    params, final_softmax, nodes = plan
    if x.dim() != 2 or x.shape[1] != params[0][0].shape[0]:
        return None
    scales = [getattr(nd, "_infera_act_scale", None) for nd in nodes]
    if any(not s for s in scales):
        return None
    cache = model._int8_fused_cache
    key = (tuple(x.shape), tuple(float(s) for s in scales))
    fn = cache.get(key)
    if fn is None:
        fn = _int8_chain(nodes, params, scales, final_softmax, x.device)
        cache[key] = fn
    return fn(x.float())
