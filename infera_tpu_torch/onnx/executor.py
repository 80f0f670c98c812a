"""ONNX graph executor in eager PyTorch.

Counterpart of ``infera_tpu/onnx/executor.py``. The graph runs node by node
on tensors of the model's device; there is no per-shape compile cache,
because PyTorch runs eagerly. Initializers move to the device once, when the
model is loaded. A graph that matches the fused-MLP pattern carries an
``mlp_plan`` and runs through kernel K6 (``fusion.maybe_run_fused``) at f32,
or through the fused int8 chain (``fusion.maybe_run_int8_fused``) at int8
once the first call has calibrated the activation scales.

Not in this slice: ``run_data_parallel``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import get_device
from ..errors import OnnxError
from . import proto
from .ops import get_impl

VALID_PRECISIONS = ("f32", "bf16", "int8")


class _Ctx:
    """Per-run context handed to op impls: the model's matmul precision
    policy (f32 parity / bf16 / int8), its static initializers as numpy
    arrays, and whether this run is the int8 calibrating pass."""

    def __init__(self, matmul_precision: str = "f32", static: dict | None = None,
                 calibrating: bool = False):
        self.matmul_precision = matmul_precision
        self._static = static or {}
        self.calibrating = calibrating

    def static(self, name: str):
        """The initializer ``name`` as numpy, or None for a computed value."""
        return self._static.get(name)


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
        # the int8 policy quantizes static weights on the host, as infera_tpu
        self._static = ({name: np.asarray(t.array) for name, t in self.graph.initializers.items()}
                        if precision == "int8" else {})
        self._lock = threading.Lock()
        self._calibrating = False
        self._int8_calibrated = False
        self._int8_fused_cache: dict = {}
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
        _run_nodes(self.nodes, values, _Ctx(self.precision, self._static, self._calibrating))
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

    def calibrate_int8(self, sample_arrays) -> None:
        """Record static per-tensor activation scales from a calibration
        sample: one f32 pass through the graph stores max|activation| / 127
        on each int8 matmul node, after which int8 inference quantizes with
        those constants (``infera_tpu``'s ``calibrate_int8``). At most the
        first 4,096 rows calibrate. A sample the graph refuses leaves the
        scales unset (the dynamic per-row path stays in use); the call that
        follows raises the graph's error."""
        if self.precision != "int8" or self._int8_calibrated:
            return
        with self._lock:
            if self._int8_calibrated:
                return
            sample = []
            for a in sample_arrays:
                t = _to_tensor(a, self.device)
                if t.dim() and t.shape[0] > 4096:
                    t = t[:4096]  # a slice calibrates as well as the batch
                sample.append(t)
            self._calibrating = True
            try:
                self._run_graph(*sample)
            except (OnnxError, RuntimeError, ValueError, IndexError):
                pass
            finally:
                self._calibrating = False
            self._int8_calibrated = True

    def run(self, *arrays) -> list:
        """Run the model on tensors or numpy arrays; returns tensors on the
        model's device. An int8 model calibrates on its first call, then runs
        the fused int8 chain when the graph matched the MLP pattern."""
        tensors = [_to_tensor(a, self.device) for a in arrays]
        if self.precision == "int8":
            if not self._int8_calibrated:
                self.calibrate_int8(tensors)
            if len(tensors) == 1 and self.mlp_plan is not None:
                from .fusion import maybe_run_int8_fused

                fused = maybe_run_int8_fused(self, tensors[0])
                if fused is not None:
                    return [fused]
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
