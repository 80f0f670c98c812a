"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``infera_tpu_torch/_build/`` (or the
directory given to ``set_build_dir``) and loaded with ``ctypes``. A library is
built at its first use, or again when a source is newer than it;
``build_all`` starts one ``nvcc`` per source, all at once.
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
SOURCES = ("fused_mlp", "fused_query", "fused_sql", "profile_query")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# argtypes of every C entry: a pointer or the stream is c_void_p, so that
# ctypes never cuts a 64-bit address to an int
_SIGNATURES = {
    "fused_mlp": {
        "infera_fused_mlp": [_P, _LL, _P, _LL, _P, _I, _I, _I, _P, _I, _I, _P],
    },
    "fused_query": {
        "infera_fused_query_f32": [_P, _I, _I, _LL, _P, _LL, _P, _I, _I, _P, _P, _P, _P,
                                   _I, _I, _P],
        "infera_fused_query_rows": [_P, _I, _I, _LL, _P, _LL, _P, _I, _I, _P, _P, _P, _P,
                                    _I, _I, _P],
        "infera_fused_query_int8_shift": [_P, _LL, _P, _LL, _P, _I, _I, _I, _P, _P, _P, _P,
                                          _I, _I, _P],
        "infera_fused_query_int8_static": [_P, _LL, _P, _LL, _P, _I, _I, _P, _P, _P, _P,
                                           _I, _I, _P],
    },
    "fused_sql": {
        "infera_fused_sql": [_P, _LL, _LL, _P, _P, _LL, _P, _P, _P, _P, _LL, _P, _P, _P, _P,
                             _P, _P, _P, _P, _I, _I, _P],
        "infera_fused_sql_fold": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "profile_query": {
        "infera_profile_stage": [_I, _P, _LL, _P, _LL, _P, _I, _I, _P, _P, _I, _I, _P],
    },
}

_lock = threading.Lock()
_libs: dict = {}


def set_build_dir(path) -> Path:
    """Build and load the libraries under ``path`` from now on (libraries
    already loaded stay loaded); returns it."""
    global BUILD
    with _lock:
        BUILD = Path(path)
    return BUILD


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return any(p.stat().st_mtime > built for p in deps)


def _start(name: str) -> tuple:
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f"lib{name}.{os.getpid()}.so"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: Path) -> None:
    log, _ = proc.communicate()
    (BUILD / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, _lib_path(name))  # atomic: another process never sees half a file


def build_all() -> float:
    """Build every stale kernel library, one nvcc per source in parallel.
    Returns the seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        started = [(n, *_start(n)) for n in SOURCES if _stale(n)]
        errors = []
        for name, proc, tmp in started:
            try:
                _finish(name, proc, tmp)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers, shared memory, spills) of the last build."""
    p = BUILD / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                _finish(name, *_start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.infera_error_string.argtypes = [ctypes.c_int]
            lib.infera_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused or failed launch)."""
    if code != 0:
        msg = lib.infera_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def int_array(values) -> ctypes.Array:
    vals = [int(v) for v in values]
    return (ctypes.c_int * len(vals))(*vals)


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


_SM_COUNT: dict = {}


def grid_blocks(device: torch.device, n_tiles: int, smem_bytes: int) -> int:
    """Blocks of a persistent grid: as many as fit on the card at once, at
    most one per tile."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    sms = _SM_COUNT.get(idx)
    if sms is None:
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        _SM_COUNT[idx] = sms
    # 228 KB of shared memory per SM, 1 KB of it reserved per block; 2048
    # threads per SM at 256 a block
    per_sm = max(1, min(8, 233472 // (smem_bytes + 1024)))
    return max(1, min(n_tiles, sms * per_sm))
