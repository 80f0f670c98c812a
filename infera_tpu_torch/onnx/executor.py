"""ONNX graph executor in eager PyTorch.

Counterpart of ``infera_tpu/onnx/executor.py``. The graph runs node by node
on tensors of the model's device; there is no per-shape compile cache,
because PyTorch runs eagerly. Initializers move to the device once, when the
model is loaded. A graph that matches the fused-MLP pattern carries an
``mlp_plan`` and runs through kernel K6 (``fusion.maybe_run_fused``).

Not in this slice: ``run_data_parallel``, the int8 policy and its static
calibration (``calibrate_int8``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device
from ..errors import OnnxError
from . import proto
from .ops import get_impl

VALID_PRECISIONS = ("f32", "bf16", "int8")


class _Ctx:
    """Per-run context handed to op impls: the model's matmul precision
    policy (f32 parity / bf16)."""

    def __init__(self, matmul_precision: str = "f32"):
        self.matmul_precision = matmul_precision


def _toposort(graph: proto.Graph) -> list:
    """Topologically order nodes (ONNX graphs are usually ordered, but not
    guaranteed)."""
    produced = set(graph.initializers)
    produced.update(v.name for v in graph.inputs)
    produced.add("")  # optional inputs
    remaining = list(graph.nodes)
    ordered = []
    while remaining:
        progressed = False
        next_remaining = []
        for n in remaining:
            if all(i in produced for i in n.inputs):
                ordered.append(n)
                produced.update(n.outputs)
                progressed = True
            else:
                next_remaining.append(n)
        remaining = next_remaining
        if not progressed:
            missing = {i for n in remaining for i in n.inputs if i not in produced}
            raise OnnxError(f"graph has unresolvable inputs: {sorted(missing)[:5]}")
    return ordered


def _run_nodes(ordered: list, values: dict, ctx: _Ctx) -> None:
    """Execute the ordered nodes against ``values`` (mutated in place)."""
    for node in ordered:
        impl = get_impl(node.domain, node.op_type)
        inputs = [values[i] if i else None for i in node.inputs]
        outputs = impl(node, inputs, ctx)
        for out_name, out_val in zip(node.outputs, outputs):
            if out_name:
                values[out_name] = out_val


def _to_tensor(value, device: torch.device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    if not arr.flags.writeable:  # torch refuses to alias a read-only buffer
        arr = arr.copy()
    return torch.as_tensor(arr, device=device)


class CompiledOnnxModel:
    """A loaded ONNX model with shape metadata, its initializers on the
    device, and the fused-MLP plan.

    Shape metadata mirrors engine.rs:64-73: dims are ints with -1 for
    dynamic/symbolic dims; input_shape/output_shape are the first graph
    input/output (the reference only reads fact 0).
    """

    def __init__(self, model: proto.Model, name: str, precision: str = "f32",
                 device: torch.device | None = None):
        if precision not in VALID_PRECISIONS:
            raise OnnxError(
                f"unsupported precision '{precision}' "
                f"(expected one of {', '.join(VALID_PRECISIONS)})")
        if precision == "int8":
            raise OnnxError("precision 'int8' is not supported by the torch backend yet")
        self.precision = precision
        self.name = name
        self.model = model
        self.graph = model.graph
        self.device = torch.device(device) if device is not None else get_device()
        self.nodes = _toposort(model.graph)
        # Graph inputs that are NOT initializers are runtime inputs.
        self.runtime_inputs = [
            v for v in self.graph.inputs if v.name not in self.graph.initializers
        ]
        if not self.runtime_inputs:
            raise OnnxError(f"model '{name}' has no runtime inputs")
        self.input_shape: list[int] = [
            int(d) if d is not None and d > 0 else -1
            for d in self.runtime_inputs[0].shape
        ]
        self._initializers = {
            name: _to_tensor(t.array, self.device)
            for name, t in self.graph.initializers.items()
        }
        out0 = self.graph.outputs[0] if self.graph.outputs else None
        if out0 is not None and out0.has_shape and out0.shape:
            self.output_shape = [int(d) if d and d > 0 else -1 for d in out0.shape]
        else:
            self.output_shape = self._infer_output_shape()
        # MLP pattern plan for the fused kernel K6 (None if no match); K6
        # is the f32 path, so a bf16 model keeps no weights for it
        from .fusion import detect_mlp, mlp_weights_for

        try:
            self.mlp_plan = detect_mlp(model.graph)
        except Exception:  # detection is best-effort
            self.mlp_plan = None
        self.mlp_weights = (mlp_weights_for(self.mlp_plan, self.device)
                            if precision == "f32" else None)

    def _run_graph(self, *args) -> list:
        """Execute the graph given positional runtime inputs (tensors)."""
        values: dict = dict(self._initializers)
        for vi, arr in zip(self.runtime_inputs, args):
            values[vi.name] = arr
        _run_nodes(self.nodes, values, _Ctx(self.precision))
        outs = []
        for v in self.graph.outputs:
            if v.name not in values:
                raise OnnxError(f"model '{self.name}' missing output '{v.name}'")
            outs.append(values[v.name])
        return outs

    def _infer_output_shape(self) -> list[int]:
        """Run one row (dynamic dims -> 1) through the graph to learn the
        output's rank and shape."""
        shapes = []
        for vi in self.runtime_inputs:
            shapes.append([int(d) if d and d > 0 else 1 for d in (vi.shape or [1])])
        try:
            out = self._run_graph(*[torch.zeros(s, dtype=torch.float32, device=self.device)
                                    for s in shapes])
            return [int(d) for d in out[0].shape]
        except Exception as e:  # pragma: no cover - surfaced as OnnxError
            raise OnnxError(f"shape inference failed for '{self.name}': {e}")

    def run(self, *arrays) -> list:
        """Run the model on tensors or numpy arrays; returns tensors on the
        model's device."""
        tensors = [_to_tensor(a, self.device) for a in arrays]
        if len(tensors) == 1 and self.mlp_weights is not None:
            from .fusion import maybe_run_fused

            fused = maybe_run_fused(self, tensors[0])
            if fused is not None:
                return [fused]
        try:
            return self._run_graph(*tensors)
        except OnnxError:
            raise
        except Exception as e:
            raise OnnxError(str(e))


def compile_model_file(path, name: str, precision: str = "f32",
                       device: torch.device | None = None) -> CompiledOnnxModel:
    try:
        model = proto.load_model_file(path)
    except FileNotFoundError as e:
        raise OnnxError(str(e))
    except (proto.WireError, OSError, ValueError) as e:
        raise OnnxError(str(e))
    return CompiledOnnxModel(model, name, precision, device)


def compile_model_bytes(data: bytes, name: str, precision: str = "f32",
                        device: torch.device | None = None) -> CompiledOnnxModel:
    try:
        model = proto.load_model_bytes(data)
    except (proto.WireError, ValueError) as e:
        raise OnnxError(str(e))
    return CompiledOnnxModel(model, name, precision, device)


def shape_rows_cols(shape) -> tuple[int, int]:
    """Flatten a tensor shape to (rows, cols) — parity with
    engine.rs:19-29: scalar→(1,1), 1-D→(n,1), N-D→(d0, prod(d1..))."""
    shape = list(shape)
    if len(shape) == 0:
        return (1, 1)
    if len(shape) == 1:
        return (shape[0], 1)
    cols = 1
    for d in shape[1:]:
        cols *= d
    return (shape[0], max(cols, 1))
