"""ONNX graph executor in eager PyTorch.

Counterpart of ``infera_tpu/onnx/executor.py``. The graph runs node by node
on tensors of the model's device; there is no per-shape compile cache,
because PyTorch runs eagerly. Initializers move to the device once, when the
model is loaded, those of If/Loop/Scan subgraphs included. A graph that
matches the fused-MLP pattern carries an ``mlp_plan`` and runs through
kernel K6 (``fusion.maybe_run_fused``) at f32, or through the fused int8
chain (``fusion.maybe_run_int8_fused``) at int8 once the first call has
calibrated the activation scales.

Static values follow ``infera_tpu``: a value is statically known when it is
host numpy. Initializers are (their host copy stands in the value table and
their device copy is found by identity), and so are the outputs of
Shape/Size/Constant/Range, and of the ops that apply numpy to a numpy input
(Identity, Reciprocal, Cast, Sum, Mean, Slice, Dropout). Shape-carrying
inputs (Reshape targets, Slice bounds, axes, ...) are read from there and
never from a device tensor. Any other op gets its numpy inputs as device
tensors, moved once and cached on the node (``_Ctx.tensor``).

Sequence values (Python tuples, ``sequence_ops.py``) pass between the ops
that take them; a sequence as a graph output is refused with
``infera_tpu``'s message. Not in this slice: ``run_data_parallel``.
"""

from __future__ import annotations

import threading
from collections import ChainMap

import numpy as np
import torch

from ..device import get_device
from ..errors import OnnxError
from . import proto
from .ops import device_dtype, get_impl

VALID_PRECISIONS = ("f32", "bf16", "int8")

def _to_tensor(value, device: torch.device) -> torch.Tensor:
    """``value`` on ``device``, in the dtype it takes there (``device_dtype``)."""
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.float64:
            value = value.float()
        return value.to(device)
    arr = np.asarray(value)
    dtype = device_dtype(arr.dtype)
    if dtype != arr.dtype:
        arr = arr.astype(dtype)
    if not arr.flags.writeable:  # torch refuses to alias a read-only buffer
        arr = arr.copy()
    return torch.as_tensor(arr, device=device)


def _cuda_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _subgraphs(graph: proto.Graph):
    """Every subgraph of ``graph``'s nodes (If branches, Loop/Scan bodies),
    at any depth."""
    for node in graph.nodes:
        for a in node.attributes.values():
            for g in ([a.g] if a.type == proto.AttrType.GRAPH else
                      a.graphs if a.type == proto.AttrType.GRAPHS else []):
                if g is not None:
                    yield g
                    yield from _subgraphs(g)


class _Ctx:
    """Per-run context handed to op impls: static-value lookup, numpy to
    device tensors, subgraph execution, the model's matmul precision policy
    (f32 parity / bf16 / int8) and whether this run is the int8
    calibrating pass."""

    def __init__(self, model: "CompiledOnnxModel", values, calibrating: bool = False):
        self.model = model
        self._values = values
        self.device = model.device
        self.matmul_precision = model.precision
        self.calibrating = calibrating

    def as_static(self, value):
        """Return a numpy array if the value (or the value named so) is
        statically known, else None."""
        if isinstance(value, str):
            value = self._values.get(value)
        if isinstance(value, np.ndarray):
            return value
        if np.isscalar(value):
            return np.asarray(value)
        return None

    def tensor(self, node, slot, value):
        """``value`` as a tensor on the model's device. An initializer's is
        the one moved at load; any other numpy value moves once and is
        cached on ``node`` under ``slot``, reused while the value is the
        same (a Shape output is a new array of equal values on each call)."""
        if value is None or isinstance(value, torch.Tensor):
            return value
        hit = self.model._device_copies.get(id(value))
        if hit is not None and hit[0] is value:
            return hit[1]
        arr = np.asarray(value)
        cache = node.__dict__.setdefault("_infera_dev", {})
        key = (slot, str(self.device))
        entry = cache.get(key)
        if entry is not None and (entry[0] is value or (
                entry[0].shape == arr.shape and entry[0].dtype == arr.dtype
                and np.array_equal(entry[0], arr))):
            return entry[1]
        t = _to_tensor(arr, self.device)
        cache[key] = (arr, t)
        return t

    def run_subgraph(self, graph: proto.Graph, inputs: list) -> list:
        """Execute a nested graph (If branch, Loop/Scan body) with ONNX
        outer-scope capture: names not bound by the subgraph resolve against
        this context's values. ``inputs`` bind positionally to graph.inputs.
        The returned values may be numpy (static), as the parent's are."""
        values = ChainMap(dict(self.model._host[id(graph)]), self._values)
        for vi, arr in zip(graph.inputs, inputs):
            values[vi.name] = arr
        order = graph.__dict__.get("_infera_order")
        if order is None:
            order = _toposort(graph, extra_available=set(self._values))
            graph._infera_order = order
        _run_nodes(order, values, _Ctx(self.model, values, self.calibrating))
        outs = []
        for v in graph.outputs:
            if v.name not in values:
                raise OnnxError(f"subgraph '{graph.name}' missing output '{v.name}'")
            outs.append(values[v.name])
        return outs


def _toposort(graph: proto.Graph, extra_available: set | None = None) -> list:
    """Topologically order nodes (ONNX graphs are usually ordered, but not
    guaranteed). ``extra_available`` marks names resolvable from an outer
    scope (subgraph execution)."""
    produced = set(graph.initializers)
    produced.update(v.name for v in graph.inputs)
    produced.add("")  # optional inputs
    if extra_available:
        produced.update(extra_available)
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


def _run_nodes(ordered: list, values, ctx: _Ctx) -> None:
    """Execute the ordered nodes against ``values`` (mutated in place). An
    op registered with ``host=True`` takes its inputs as they are (numpy
    stays numpy); any other op takes device tensors, but for the inputs it
    reads statically (its ``static`` positions), which it resolves by name."""
    for node in ordered:
        impl = get_impl(node.domain, node.op_type)
        inputs = [values[i] if i else None for i in node.inputs]
        if not impl.host:
            inputs = [v if k in impl.static else ctx.tensor(node, k, v)
                      for k, v in enumerate(inputs)]
        outputs = impl(node, inputs, ctx)
        for out_name, out_val in zip(node.outputs, outputs):
            if out_name:
                values[out_name] = out_val


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
        # every initializer, subgraphs' included, keeps a host copy (the
        # static value ops read, and the int8 policy quantizes) and moves to
        # the device once, here; _Ctx.tensor finds the device copy by identity
        graphs = [self.graph, *_subgraphs(self.graph)]
        self._host = {id(g): {n: np.asarray(t.array) for n, t in g.initializers.items()}
                      for g in graphs}
        self._device_copies = {id(a): (a, _to_tensor(a, self.device))
                               for host in self._host.values() for a in host.values()}
        self._initializers = {n: self._device_copies[id(a)][1]
                              for n, a in self._host[id(self.graph)].items()}
        from .control_flow import check_branches

        for g in graphs:
            for node in g.nodes:
                if node.op_type == "If":
                    check_branches(node)
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
        """Execute the graph given positional runtime inputs (tensors).
        Outputs that are static values come back as tensors too."""
        values: dict = dict(self._host[id(self.graph)])
        for vi, arr in zip(self.runtime_inputs, args):
            values[vi.name] = arr
        ctx = _Ctx(self, values, self._calibrating)
        _run_nodes(self.nodes, values, ctx)
        outs = []
        for v in self.graph.outputs:
            if v.name not in values:
                raise OnnxError(f"model '{self.name}' missing output '{v.name}'")
            if isinstance(values[v.name], tuple):
                # a sequence has no tensor shape to hand back
                raise OnnxError(
                    f"model '{self.name}' output '{v.name}' is a sequence; "
                    f"concat it (ConcatFromSequence) to a tensor output")
            outs.append(ctx.tensor(self.graph, v.name, values[v.name]))
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
            except (OnnxError, RuntimeError, ValueError, IndexError, TypeError):
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


    def run_data_parallel(self, mesh, *arrays) -> list:
        """Run with the batch dimension sharded over the mesh's dp axis
        (``parallel/mesh.py``): each local shard's rows run the graph
        (``_run_graph``, as ``infera_tpu`` jits it) on the shard's device,
        the weights replicated there, and the outputs come back concatenated
        in row order (gathered over the process group, if any). The row
        count must divide by dp, as ``infera_tpu``'s sharding requires."""
        from ..parallel import mesh as M

        dp = mesh.shape["dp"]
        for a in arrays:
            if a.shape[0] % dp:
                raise OnnxError(f"data-parallel run of '{self.name}': {a.shape[0]} rows do not "
                                f"split evenly over the mesh's {dp} shards")
        per = arrays[0].shape[0] // dp
        outs = []
        for s, dev in zip(mesh.local, mesh.local_devices):
            model = self._replica(dev)
            part = [_to_tensor(a[s * per:(s + 1) * per], dev) for a in arrays]
            try:
                outs.append(model._run_graph(*part))
            except OnnxError:
                raise
            except Exception as e:
                raise OnnxError(str(e))
        return [M.all_gather(mesh, [o[i] for o in outs])[0] for i in range(len(outs[0]))]

    def _replica(self, device: torch.device) -> "CompiledOnnxModel":
        """This model with its weights on ``device`` (itself on its own)."""
        device = torch.device(device)
        if device.type == self.device.type and (
                device.type != "cuda" or _cuda_index(device) == _cuda_index(self.device)):
            return self
        with self._lock:
            replicas = self.__dict__.setdefault("_replicas", {})
            key = str(device)
            if key not in replicas:
                replicas[key] = CompiledOnnxModel(self.model, self.name, self.precision, device)
            return replicas[key]


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
