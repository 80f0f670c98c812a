"""Blockwise streaming execution: billion-row partitions through a fixed
device footprint.

Counterpart of ``infera_tpu/ops/streaming.py``. SURVEY.md §5 names
"blockwise streaming of billion-row partitions through the inference
operator" as the engine's scale axis (rows, not sequence length). The
loop below runs a step over fixed-size row chunks and folds the partials.
``infera_tpu`` leaves the overlap to JAX's async dispatch; here, on CUDA,
two pinned host staging slots, a copy stream and events do it: chunk k+1 is
copied into its pinned slot on the host and sent over the copy stream while
chunk k's step runs on the compute stream. The partials stay on the device
and fold there; the caller reads the accumulator back once. On the CPU each
chunk becomes a tensor of its own and the steps run in order.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable

import numpy as np
import torch

from ..device import get_device


class _Slot:
    """One staging slot: a pinned host buffer and a device buffer per
    array, the event that marks its copy done and the one that marks the
    step that read it done."""

    def __init__(self):
        self.pinned: list = []   # pinned host tensors
        self.host: list = []     # numpy views of them
        self.dev: list = []
        self.copied = None
        self.consumed = None

    def fit(self, chunk: tuple, device) -> bool:
        """Size the buffers for ``chunk`` (a tail chunk uses the front of
        the larger buffers it finds); True when it allocated them."""
        if len(self.host) == len(chunk) and all(
                h.shape[0] >= len(a) and h.shape[1:] == a.shape[1:] and h.dtype == a.dtype
                for h, a in zip(self.host, chunk)):
            return False
        dtypes = [torch.from_numpy(np.empty(0, a.dtype)).dtype for a in chunk]
        self.pinned = [torch.empty(a.shape, dtype=dt, pin_memory=True)
                       for a, dt in zip(chunk, dtypes)]
        self.host = [p.numpy() for p in self.pinned]
        self.dev = [torch.empty(a.shape, dtype=dt, device=device) for a, dt in zip(chunk, dtypes)]
        return True


def stream_query(chunks: Iterable, step_fn: Callable, combine_fn: Callable, init,
                 device=None, stats: dict | None = None):
    """Run ``step_fn(*chunk_tensors) -> partial`` over every chunk and fold
    the partials with ``combine_fn(acc, partial)``, starting from ``init``.

    - chunks: iterable of tuples of host numpy arrays (row blocks; memmap
      slices are fine: each is copied once, into the staging slot)
    - step_fn: the device computation for one chunk; it must not return its
      input tensors, whose buffers the chunk after next reuses
    - device: where the steps run (default ``get_device()``)
    - stats: if given, filled with ``chunks``, ``stage_ms`` (host copies
      into the staging slots, host clock), ``upload_ms`` (the copies to the
      device, CUDA events) and ``compute_ms`` (the steps, CUDA events on
      the card, the host clock on the CPU)

    Returns the accumulator, on the device, after the last step finished.
    """
    device = torch.device(device) if device is not None else get_device()
    acc = init
    st = {"chunks": 0, "stage_ms": 0.0, "upload_ms": 0.0, "compute_ms": 0.0}
    if device.type != "cuda":
        for chunk in chunks:
            t = time.perf_counter()
            tensors = [torch.from_numpy(np.array(a)).to(device) for a in chunk]
            st["stage_ms"] += (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            acc = combine_fn(acc, step_fn(*tensors))
            st["compute_ms"] += (time.perf_counter() - t) * 1e3
            st["chunks"] += 1
        if stats is not None:
            stats.update(st)
        return acc

    compute = torch.cuda.current_stream(device)
    copy = torch.cuda.Stream(device)
    slots = [_Slot(), _Slot()]
    timings = []   # (upload start, upload end, step start, step end) events
    for k, chunk in enumerate(chunks):
        slot = slots[k % 2]
        if slot.copied is not None:
            slot.copied.synchronize()   # the pinned buffer's last copy is done
        fresh = slot.fit(chunk, device)
        t = time.perf_counter()
        for h, a in zip(slot.host, chunk):
            np.copyto(h[:len(a)], a, casting="no")
        st["stage_ms"] += (time.perf_counter() - t) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with torch.cuda.stream(copy):
            if fresh:
                # the allocator may hand the compute stream's freed memory to
                # a new buffer while that stream's queued work still uses it
                copy.wait_stream(compute)
            elif slot.consumed is not None:
                copy.wait_event(slot.consumed)   # the step that read the buffer is done
            ev[0].record(copy)
            views = []
            for p, d, a in zip(slot.pinned, slot.dev, chunk):
                dv = d[:len(a)]
                dv.copy_(p[:len(a)], non_blocking=True)
                views.append(dv)
            ev[1].record(copy)
        slot.copied = ev[1]
        compute.wait_event(slot.copied)
        ev[2].record(compute)
        acc = combine_fn(acc, step_fn(*views))
        ev[3].record(compute)
        slot.consumed = ev[3]
        timings.append(ev)
        st["chunks"] += 1
    compute.synchronize()
    for e in timings:
        st["upload_ms"] += e[0].elapsed_time(e[1])
        st["compute_ms"] += e[2].elapsed_time(e[3])
    if stats is not None:
        stats.update(st)
    return acc


def chunked(arrays: tuple, chunk_rows: int):
    """Split equal-length host arrays into row chunks of ``chunk_rows``
    views; the tail chunk is shorter. (``infera_tpu`` pads the tail with
    zeros, as one XLA executable serves every chunk; eager torch ops take
    any length.)"""
    n = len(arrays[0])
    for start in range(0, n, chunk_rows):
        yield tuple(a[start:start + chunk_rows] for a in arrays)
