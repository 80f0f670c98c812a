"""Inference engine: load / batched predict / blob predict / metadata.

Counterpart of ``infera_tpu/engine.py``, the parity surface of
upstream infera/src/engine.rs:

- ``load_model``      ← load_model_impl (engine.rs:48-82)
- ``run_inference``   ← run_inference_impl (engine.rs:112-164)
- ``run_inference_blob`` ← run_inference_blob_impl (engine.rs:200-263)
- ``get_model_metadata`` ← get_model_metadata_impl (engine.rs:293-305)

Error strings and validation order match the reference exactly. The JAX
engine pads rows to power-of-two buckets only to bound XLA recompiles;
PyTorch runs eagerly and K6 masks its ragged last tile, so the port runs the
true row count. Fixed-batch-1 models accept any batch, as in ``infera_tpu``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from . import log
from .device import get_device
from .errors import (
    BlobShapeMismatch,
    InvalidBlobSize,
    InvalidInputShape,
    ModelNotFound,
)
from .onnx.executor import CompiledOnnxModel, compile_model_file, shape_rows_cols
from .registry import MODELS


@dataclass
class InferenceResult:
    """Parity analog of InferaInferenceResult (ffi_utils.rs:10-22): flat f32
    output plus the (rows, cols) flattening of the output tensor shape."""

    data: np.ndarray  # flat float32
    rows: int
    cols: int


def load_model(name: str, path: str, precision: str = "f32") -> None:
    """Parse an ONNX file, move its weights to the device and register it
    (engine.rs:48-82). ``precision``: "f32" (reference-parity default),
    "bf16", or "int8" (static per-channel weights, activation scales
    calibrated on the first predict's first 4,096 rows; an MLP runs the fused
    int8 chain)."""
    compiled = compile_model_file(path, name, precision, get_device())
    MODELS.insert(name, compiled)
    log.info(f"loaded model '{name}' from {path} "
             f"input={compiled.input_shape} output={compiled.output_shape} "
             f"precision={precision} device={compiled.device}")


def _lookup(model_name: str) -> CompiledOnnxModel:
    model = MODELS.get(model_name)
    if model is None:
        raise ModelNotFound(model_name)
    return model


# batches beyond this run in fixed chunks, which bounds the device memory a
# single call takes (the reference's unimplemented "automatic batch
# splitting" ROADMAP item, at the large end)
SPLIT_CHUNK_ROWS = 1 << 20


def _run_chunked(model: CompiledOnnxModel, arr: np.ndarray) -> np.ndarray:
    """Run ``arr`` (batch on axis 0) in chunks of SPLIT_CHUNK_ROWS rows and
    concatenate the outputs on the host."""
    rows = arr.shape[0]
    if rows > SPLIT_CHUNK_ROWS:
        outs = [_run_chunked(model, arr[start:start + SPLIT_CHUNK_ROWS])
                for start in range(0, rows, SPLIT_CHUNK_ROWS)]
        return np.concatenate(outs, axis=0)
    return model.run(arr)[0].cpu().numpy()


def run_inference(model_name: str, data: np.ndarray, rows: int, cols: int) -> InferenceResult:
    """Batched inference on a [rows, cols] f32 tensor (engine.rs:112-164)."""
    model = _lookup(model_name)

    # Inner-dim validation (engine.rs:126-137): if all inner dims are known,
    # cols must equal their product. Error strings match Rust's
    # `format!("batch x {:?}", inner_dims)` / `format!("{} x {}", rows, cols)`.
    ishape = model.input_shape
    if ishape:
        inner = ishape[1:]
        if all(d > 0 for d in inner):
            expected_inner = 1
            for d in inner:
                expected_inner *= d
            if cols != expected_inner:
                raise InvalidInputShape(
                    expected=f"batch x [{', '.join(str(d) for d in inner)}]",
                    actual=f"{rows} x {cols}",
                )

    arr = np.ascontiguousarray(data, dtype=np.float32).reshape(rows, cols)
    # Feed the model at its declared rank with the batch on dim 0.
    if len(ishape) > 2:
        inner_dims = [d if d > 0 else 1 for d in ishape[1:]]
        arr = arr.reshape((rows, *inner_dims))
    out = _run_chunked(model, arr)
    orows, ocols = shape_rows_cols(out.shape)
    return InferenceResult(
        data=np.ascontiguousarray(out, dtype=np.float32).reshape(-1),
        rows=orows,
        cols=ocols,
    )


def _blob_decode_f32(blob: bytes) -> np.ndarray | None:
    """Little-endian f32 bytes to an array; None if len % 4 != 0, through
    the native host runtime (``runtime.blob_decode_f32``, with its numpy
    fallback), as ``infera_tpu``'s engine decodes."""
    from .runtime import blob_decode_f32

    return blob_decode_f32(blob)


def run_inference_blob(model_name: str, blob: bytes) -> InferenceResult:
    """Inference on raw little-endian f32 bytes (engine.rs:200-263).

    Validation order matches the reference: model lookup, then size % 4,
    then element-count divisibility against the product of known dims; the
    batch replaces every -1 dim."""
    model = _lookup(model_name)
    floats = _blob_decode_f32(blob)
    if floats is None:
        raise InvalidBlobSize()

    expected = 1
    any_known = False
    for d in model.input_shape:
        if d > 0:
            expected *= d
            any_known = True
    if not any_known:
        expected = 0
    if expected == 0 or len(floats) % expected != 0:
        raise BlobShapeMismatch(expected=expected, actual=len(floats))
    batch = len(floats) // expected

    final_shape = [batch if d == -1 else d for d in model.input_shape]
    if batch > 1 and -1 not in model.input_shape:
        # a fixed-batch model still accepts larger blobs by treating dim 0
        # as the batch axis (the reference's tract plan would reject this;
        # ROADMAP §1 unchecked item)
        if len(final_shape) >= 1:
            final_shape = [batch * final_shape[0]] + final_shape[1:]
    arr = floats.reshape(final_shape)
    if arr.ndim == 0:
        arr = arr.reshape(1)
    out = model.run(arr)[0].cpu().numpy()
    orows, ocols = shape_rows_cols(out.shape)
    return InferenceResult(
        data=np.ascontiguousarray(out, dtype=np.float32).reshape(-1),
        rows=orows,
        cols=ocols,
    )


def get_model_metadata(model_name: str) -> str:
    """JSON metadata {"name","input_shape","output_shape","loaded":true}
    (engine.rs:293-305); compact encoding to match serde_json."""
    model = _lookup(model_name)
    info = {
        "name": model.name,
        "input_shape": model.input_shape,
        "output_shape": model.output_shape,
        "loaded": True,
    }
    # keep the reference-exact 4-key envelope for default loads; announce
    # reduced precision (an extension) only when active
    if model.precision != "f32":
        info["precision"] = model.precision
    try:
        return json.dumps(info, separators=(",", ":"))
    except (TypeError, ValueError) as e:  # pragma: no cover
        from .errors import JsonError

        raise JsonError(str(e))
