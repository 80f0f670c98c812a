"""The 13-function public API (counterpart of ``infera_tpu/api.py``).

One Python function per C-ABI entry point of the reference
(upstream infera/src/lib.rs; whitelist in infera/cbindgen.toml).
Same names (minus the ``infera_`` prefix), same semantics, same JSON envelope
shapes; errors surface as exceptions (str(exc) == the reference's error
string) instead of return codes + thread-local last-error.

| This module            | Reference entry point      | lib.rs |
|------------------------|----------------------------|--------|
| load_model             | infera_load_model          | :39    |
| unload_model           | infera_unload_model        | :82    |
| predict                | infera_predict             | :128   |
| predict_from_blob      | infera_predict_from_blob   | :175   |
| get_model_info         | infera_get_model_info      | :216   |
| get_loaded_models      | infera_get_loaded_models   | :246   |
| get_version            | infera_get_version         | :276   |
| clear_cache            | infera_clear_cache         | :300   |
| get_cache_info         | infera_get_cache_info      | :327   |
| set_autoload_dir       | infera_set_autoload_dir    | :389   |
| is_model_loaded        | (C++ binding IsModelLoaded, infera_extension.cpp:350) |
| last_error             | infera_last_error          | error.rs:97 |
| free / free_result     | not needed (GC)            | ffi_utils.rs |
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from . import cache, engine
from .config import get_config
from .engine import InferenceResult
from .errors import InferaError, IoError
from .registry import MODELS
from .version import ONNX_BACKEND, VERSION


def load_model(name: str, path_or_url: str, precision: str = "f32") -> None:
    """Load an ONNX model from a local path or http(s) URL (lib.rs:39-64).

    URLs are detected by the same 'starts with "http"' rule (lib.rs:47) and
    resolved through the disk cache. Raises InferaError on failure.
    ``precision``: "f32" (default, reference parity), "bf16", or "int8"
    (static calibration on the first predict); ``get_model_info`` names a
    precision other than "f32".
    """
    if path_or_url.startswith("http"):
        local_path = str(cache.handle_remote_model(path_or_url))
    else:
        local_path = path_or_url
    engine.load_model(name, local_path, precision)


def unload_model(name: str) -> bool:
    """Remove a model. Returns False (not an exception) when absent; the SQL
    surface turns both outcomes into TRUE (idempotent unload,
    infera_extension.cpp:180-187)."""
    return MODELS.remove(name)


def predict(name: str, data, rows: int | None = None, cols: int | None = None) -> InferenceResult:
    """Batched inference on a [rows, cols] f32 tensor (lib.rs:128-169)."""
    arr = np.asarray(data, dtype=np.float32)
    if rows is None or cols is None:
        if arr.ndim != 2:
            arr = arr.reshape(arr.shape[0], -1) if arr.ndim > 2 else arr.reshape(1, -1)
        rows, cols = arr.shape
    return engine.run_inference(name, arr, rows, cols)


def predict_from_blob(name: str, blob: bytes) -> InferenceResult:
    """Inference on raw native-endian f32 bytes (lib.rs:175-210)."""
    return engine.run_inference_blob(name, blob)


def get_model_info(name: str) -> str:
    """JSON metadata; on error returns {"error": "..."} JSON like
    lib.rs:216-233 (the SQL layer converts that to an exception)."""
    try:
        return engine.get_model_metadata(name)
    except InferaError as e:
        return json.dumps({"error": str(e)}, separators=(",", ":"))


def get_loaded_models() -> str:
    """JSON array of loaded model names (lib.rs:246-260)."""
    return json.dumps(MODELS.names(), separators=(",", ":"))


def is_model_loaded(name: str) -> bool:
    """True iff the quoted name appears in the loaded-models JSON — kept as
    the same substring probe the C++ binding uses (infera_extension.cpp:364-365)."""
    return f'"{name}"' in get_loaded_models()


def get_version() -> str:
    """JSON {"version","onnx_backend","model_cache_dir"} (lib.rs:276-286)."""
    info = {
        "version": VERSION,
        "onnx_backend": ONNX_BACKEND,
        "model_cache_dir": str(get_config().cache_dir),
    }
    return json.dumps(info, separators=(",", ":"))


def clear_cache() -> None:
    cache.clear_cache()


def get_cache_info() -> str:
    return cache.get_cache_info()


def set_autoload_dir(path: str) -> str:
    """Scan `path` for *.onnx; load each by file stem (lib.rs:389-425).

    Returns {"loaded":[...],"errors":[{"file","error"}...]} JSON; a missing
    directory returns {"error": ...} JSON (not an exception), matching the
    reference's envelope the SQL tests assert on
    (test/sql/test_autoload_and_json.test)."""
    loaded = []
    errors = []
    try:
        try:
            entries = sorted(os.listdir(path))
        except OSError as e:
            raise IoError(str(e))
        for fname in entries:
            fpath = Path(path) / fname
            if fpath.is_file() and fpath.suffix == ".onnx":
                stem = fpath.stem
                try:
                    engine.load_model(stem, str(fpath))
                    loaded.append(stem)
                except InferaError as e:
                    errors.append({"file": str(fpath), "error": str(e)})
        return json.dumps({"loaded": loaded, "errors": errors}, separators=(",", ":"))
    except InferaError as e:
        return json.dumps({"error": str(e)}, separators=(",", ":"))


def unload_all_models() -> None:
    """Test-support helper (the reference's concurrency test asserts an empty
    registry at exit, test/concurrency/test_concurrency.py:25-26)."""
    MODELS.clear()
