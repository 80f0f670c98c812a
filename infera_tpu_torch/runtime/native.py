"""ctypes binding to the native host library (``libinfera_host.so``).

Counterpart of ``infera_tpu/runtime/native.py``, with its API and its numpy
fallback. ``src/infera_host.cpp`` is built at first use with
``g++ -O3 -march=native -std=c++17 -shared -fPIC`` into
``infera_tpu_torch/_build/host/`` (again when the source is newer than the
library), never under the source tree. Where no toolchain is present every
function runs its numpy version, with the same results, so callers never
branch. This is host code: device work stays in torch and the CUDA kernels.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .. import log

_SRC = Path(__file__).resolve().parent / "src" / "infera_host.cpp"
_LIB_DIR = Path(__file__).resolve().parent.parent / "_build" / "host"
_LIB = _LIB_DIR / "libinfera_host.so"

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    """Compile the library; another process never sees half a file."""
    try:
        _LIB_DIR.mkdir(parents=True, exist_ok=True)
        tmp = _LIB_DIR / f"libinfera_host.{os.getpid()}.so"
        cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
               str(_SRC), "-o", str(tmp), "-pthread"]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            log.warn(f"native build failed: {res.stderr[:500]}")
            return False
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.warn(f"native build unavailable: {e}")
        return False


def get_lib():
    """The loaded native library, or None (numpy fallback)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        stale = not _LIB.exists() or _SRC.stat().st_mtime > _LIB.stat().st_mtime
        if stale and not _build() and not _LIB.exists():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError as e:
            log.warn(f"failed to load native lib: {e}")
            return None
        lib.infera_host_abi_version.restype = ctypes.c_int
        if lib.infera_host_abi_version() != 2:
            log.warn("native lib ABI mismatch; using numpy fallback")
            return None
        lib.infera_blob_decode_f32.restype = ctypes.c_int
        lib.infera_blob_decode_f32.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p]
        lib.infera_extract_features_f32.restype = ctypes.c_int64
        lib.infera_radix_partition.restype = None
        lib.infera_hash64_i64.restype = None
        lib.infera_csv_parse_numeric.restype = ctypes.c_int64
        lib.infera_csv_parse_numeric.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# public API (native with numpy fallback)
# ---------------------------------------------------------------------------

def blob_decode_f32(blob: bytes) -> np.ndarray | None:
    """Decode little-endian f32 bytes; None if length % 4 != 0."""
    if len(blob) % 4 != 0:
        return None
    lib = get_lib()
    if lib is None:
        return np.frombuffer(blob, dtype="<f4").astype(np.float32)
    out = np.empty(len(blob) // 4, dtype=np.float32)
    if lib.infera_blob_decode_f32(blob, len(blob), out.ctypes.data_as(ctypes.c_void_p)) != 0:
        return None
    return out


_TYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.uint8): 4,
    np.dtype(np.bool_): 4,
}


def extract_features_f32(columns: list, validities: list) -> tuple:
    """Stack typed columns into a row-major f32 matrix.

    Returns (matrix, first_null), where first_null is None or the (row, col)
    of the first NULL cell in row-major order (callers raise "Feature values
    cannot be NULL")."""
    rows = len(columns[0]) if columns else 0
    ncols = len(columns)
    lib = get_lib()
    if lib is None:
        for c, v in enumerate(validities):
            if v is not None and not v.all():
                return None, (int(np.argmin(v)), c)
        out = np.empty((rows, ncols), dtype=np.float32)
        for c, col in enumerate(columns):
            out[:, c] = col.astype(np.float32)
        return out, None

    col_ptrs = (ctypes.c_void_p * ncols)()
    type_codes = np.empty(ncols, dtype=np.int32)
    val_ptrs = (ctypes.c_void_p * ncols)()
    holds = []
    for c, col in enumerate(columns):
        code = _TYPE_CODES.get(col.dtype)
        if code is None:
            col = col.astype(np.float64)
            code = 1
        col = np.ascontiguousarray(col)
        holds.append(col)
        col_ptrs[c] = col.ctypes.data_as(ctypes.c_void_p)
        type_codes[c] = code
        v = validities[c]
        if v is None:
            val_ptrs[c] = None
        else:
            v = np.ascontiguousarray(v.astype(np.uint8))
            holds.append(v)
            val_ptrs[c] = v.ctypes.data_as(ctypes.c_void_p)
    out = np.empty((rows, ncols), dtype=np.float32)
    rc = lib.infera_extract_features_f32(
        col_ptrs, type_codes.ctypes.data_as(ctypes.c_void_p), val_ptrs,
        ctypes.c_int64(rows), ctypes.c_int64(ncols), out.ctypes.data_as(ctypes.c_void_p))
    if rc > 0:
        flat = int(rc) - 1
        return None, (flat // ncols, flat % ncols)
    if rc < 0:
        raise ValueError("unsupported column type in native extract")
    return out, None


def hash64_i64(keys: np.ndarray) -> np.ndarray:
    """splitmix64 of each int64 key, as uint64."""
    lib = get_lib()
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if lib is None:
        from ..ops.hashing import _mix64_np

        return _mix64_np(keys.view(np.uint64))
    out = np.empty(len(keys), dtype=np.uint64)
    lib.infera_hash64_i64(keys.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(len(keys)),
                          out.ctypes.data_as(ctypes.c_void_p))
    return out


def radix_partition(hashes: np.ndarray, parts: int) -> tuple:
    """(counts [parts], indices [n]): row indices grouped by
    ``hash % parts``, stable within a partition."""
    hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
    lib = get_lib()
    if lib is None:
        p = (hashes % np.uint64(parts)).astype(np.int64)
        counts = np.bincount(p, minlength=parts).astype(np.int64)
        indices = np.argsort(p, kind="stable").astype(np.int64)
        return counts, indices
    counts = np.empty(parts, dtype=np.int64)
    indices = np.empty(len(hashes), dtype=np.int64)
    lib.infera_radix_partition(
        hashes.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(len(hashes)),
        ctypes.c_int32(parts), counts.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p))
    return counts, indices


def csv_parse_numeric(body: bytes, ncols: int, delimiter: str = ","):
    """Native parse of an unquoted all-numeric CSV body (the bytes after the
    header) into (values [ncols, n_rows] f64, valid [ncols, n_rows] bool,
    is_float [ncols] bool; False where every field was integer syntax).
    None when the library is absent or the body needs the general reader
    (quotes, ragged rows, fields that are not numbers, integers past
    2^53)."""
    lib = get_lib()
    if lib is None:
        return None
    n_rows_cap = body.count(b"\n") + 1
    out = np.empty((ncols, n_rows_cap), np.float64)
    nulls = np.empty((ncols, n_rows_cap), np.uint8)
    float_flags = np.zeros(ncols, np.uint8)
    n = lib.infera_csv_parse_numeric(
        body, len(body), delimiter.encode()[:1], ncols,
        out.ctypes.data_as(ctypes.c_void_p), nulls.ctypes.data_as(ctypes.c_void_p),
        float_flags.ctypes.data_as(ctypes.c_void_p), n_rows_cap)
    if n < 0:
        return None
    return out[:, :n].copy(), nulls[:, :n].astype(bool), float_flags.astype(bool)
