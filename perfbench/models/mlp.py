"""A dense classifier: Gemm + Relu layers, then Softmax (scikit-learn's
MLPClassifier as skl2onnx writes it, MatMul and Add as one Gemm). Weights from the run's generator; the ONNX file the program
loads; the plain reference; the work one row needs."""

from __future__ import annotations

import numpy as np
import torch

from .. import onnx_writer as ow


def _dims(spec: dict) -> list:
    return [spec["features"], *spec["hidden"], spec["outputs"]]


def make(spec: dict, gen: torch.Generator, device) -> dict:
    """Layers [(W [in, out], b [out])] in f32, W ~ N(0, 1/in), b ~ N(0, 0.01)."""
    dims = _dims(spec)
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        w = torch.randn((din, dout), generator=gen, device=device) / float(np.sqrt(din))
        b = torch.randn((dout,), generator=gen, device=device) * 0.1
        layers.append((w.cpu().numpy(), b.cpu().numpy()))
    return {"layers": layers}


def onnx_bytes(spec: dict, params: dict) -> bytes:
    nodes, inits, prev = [], [], "X"
    last = len(params["layers"]) - 1
    for i, (w, b) in enumerate(params["layers"]):
        inits += [ow.tensor(f"W{i}", w), ow.tensor(f"B{i}", b)]
        nodes.append(ow.node("Gemm", [prev, f"W{i}", f"B{i}"], [f"H{i}"]))
        prev = f"H{i}"
        if i < last:
            nodes.append(ow.node("Relu", [prev], [f"A{i}"]))
            prev = f"A{i}"
    nodes.append(ow.node("Softmax", [prev], ["Y"], axis=-1) if spec["softmax"]
                 else ow.node("Identity", [prev], ["Y"]))
    return ow.model("MlpClassifier", nodes, inits,
                    [ow.value_info("X", ow.FLOAT, [-1, spec["features"]])],
                    [ow.value_info("Y", ow.FLOAT, [-1, spec["outputs"]])], [("", 13)])


def reference(spec: dict, params: dict, x: torch.Tensor, output: int | None) -> tuple:
    """(value, err) over the rows of ``x`` [n, features] f32: the
    ``output``-th (1-based) softmax output in f64. ``err`` is None: no
    bound on an f32 evaluation's rounding is derived, so no template may
    filter on this prediction."""
    h = x.double()
    last = len(params["layers"]) - 1
    for i, (w, b) in enumerate(params["layers"]):
        h = h @ torch.as_tensor(w, device=x.device).double() + torch.as_tensor(b, device=x.device)
        if i < last:
            h = torch.relu(h)
    if spec["softmax"]:
        h = torch.softmax(h, dim=1)
    return h[:, (output or 1) - 1], None


def ops_per_row(spec: dict) -> int:
    """Multiply-adds of the layers, two operations each; the bias, Relu and
    Softmax are left out, so the count is a floor."""
    dims = _dims(spec)
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
