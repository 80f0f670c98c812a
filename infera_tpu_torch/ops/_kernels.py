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
import re
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
        "infera_fused_mlp": [_P, _LL, _P, _LL, _P, _I, _I, _I, _P, _I, _I, _I, _P],
        "infera_fused_mlp_occupancy": [_I, _I, _P],
    },
    "fused_query": {
        "infera_fused_query_f32": [_P, _I, _LL, _P, _LL, _P, _I, _I, _P, _P, _P, _P, _I, _I,
                                   _I, _P],
        "infera_fused_query_rows": [_P, _I, _LL, _P, _LL, _P, _I, _I, _I, _P, _P, _P, _P, _I,
                                    _I, _I, _P],
        "infera_fused_query_f32_occupancy": [_I, _I, _I, _I, _P],
        "infera_fused_query_bf16": [_P, _I, _I, _LL, _P, _LL, _P, _I, _I, _P, _P, _P, _P, _I,
                                    _I, _P],
        "infera_fused_query_bf16_occupancy": [_I, _I, _I, _P],
        "infera_fused_query_int8_shift": [_P, _LL, _P, _LL, _P, _I, _I, _I, _P, _P, _P, _P,
                                          _I, _I, _P],
        "infera_fused_query_int8_static": [_P, _LL, _P, _LL, _P, _I, _I, _P, _P, _P, _P,
                                           _I, _I, _P],
        "infera_fused_query_int8_occupancy": [_I, _I, _P],
    },
    "fused_sql": {
        "infera_fused_sql_launch": [_P, _I, _P],
        "infera_fused_sql_occupancy": [_I, _I, _P],
    },
    "profile_query": {
        "infera_profile_stage": [_I, _P, _LL, _P, _LL, _P, _I, _I, _P, _P, _I, _I, _P],
        "infera_profile_stage_occupancy": [_I, _P],
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


def _cuda_tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / name)


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
    cmd = [_cuda_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
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


def ptxas_usage(name: str, kernel: str) -> tuple:
    """(registers, stack bytes, spill-store bytes) ptxas gave the kernel
    whose mangled name holds ``kernel`` in the last build of
    ``csrc/<name>.cu`` (the first such kernel); None for what the log does
    not name."""
    cur = regs = stack = spill = None
    for line in build_log(name).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            cur = m.group(1)
            continue
        if cur is None or kernel not in cur:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and stack is None:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and regs is None:
            regs = int(m.group(1))
    return regs, stack, spill


def count_sass(sass: str, opcode: str) -> dict:
    """{kernel's mangled name: instructions whose opcode starts with
    ``opcode``} in ``cuobjdump --dump-sass`` output, one entry a kernel."""
    counts: dict = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts.setdefault(cur, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if cur is not None and m and m.group(1).startswith(opcode):
            counts[cur] += 1
    return counts


def sass_opcodes(name: str, opcode: str) -> dict:
    """``count_sass`` over the built library of ``csrc/<name>.cu`` (built
    first if needed), read with ``cuobjdump --dump-sass``."""
    load(name)
    sass = subprocess.run([_cuda_tool("cuobjdump"), "--dump-sass", str(_lib_path(name))],
                          check=True, capture_output=True, text=True).stdout
    return count_sass(sass, opcode)


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


_RESIDENT: dict = {}


def resident_blocks(device: torch.device, name: str, entry: str, *args) -> int:
    """Blocks of a kernel resident on one SM, from the occupancy entry
    ``entry`` of ``csrc/<name>.cu`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``:
    registers, shared memory and threads all count), which takes ``args``
    and then the int it writes; asked once per device, entry and args.
    Raises where not one block fits."""
    key = (device.index, name, entry, *args)
    got = _RESIDENT.get(key)
    if got is None:
        lib = load(name)
        blocks = ctypes.c_int(0)
        check(lib, getattr(lib, entry)(*args, ctypes.byref(blocks)), entry)
        if blocks.value < 1:
            raise RuntimeError(f"{entry}{args}: not one block fits an SM")
        got = _RESIDENT[key] = blocks.value
    return got


_SM_COUNT: dict = {}


def sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    sms = _SM_COUNT.get(idx)
    if sms is None:
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        _SM_COUNT[idx] = sms
    return sms


def smem_blocks_per_sm(smem_bytes: int) -> int:
    """Blocks of 256 threads that one SM's shared memory holds: 228 KB, 1 KB
    of it reserved per block, at most 8 (2,048 threads)."""
    return max(1, min(8, 233472 // (smem_bytes + 1024)))


def grid_blocks(device: torch.device, n_tiles: int, smem_bytes: int,
                per_sm: int | None = None) -> int:
    """Blocks of a persistent grid: as many as are resident on the card at
    once, at most one per tile. ``per_sm`` is the kernel's resident blocks
    per SM (its occupancy, counting registers too); without it, what shared
    memory alone allows."""
    if per_sm is None:
        per_sm = smem_blocks_per_sm(smem_bytes)
    return max(1, min(n_tiles, sm_count(device) * max(1, per_sm)))
