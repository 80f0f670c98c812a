"""Multi-process control plane: process-group init, replicated model
registry, failure recovery.

Counterpart of ``infera_tpu/parallel/distributed.py``:

- ``initialize()``: ``torch.distributed`` process-group bring-up with the
  gloo backend (a no-op for one process). The caller gives the address
  (``tcp://host:port``), the world size and the rank; nothing is read from
  a cluster.
- ``ReplicatedModelOps``: the registry control plane. Queries execute on
  every process (the same statement stream), so load/unload/autoload apply
  on every process; rank 0's op is broadcast and every rank checks its own
  against it before applying.
- ``Heartbeat``: worker liveness by deadline.
- ``run_partitions_with_retry``: stateless query restart — inference is
  pure, so a lost worker's partition is re-run; a fault-injection hook
  serves the kill-a-worker test tier.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import api, log
from ..errors import InferaError


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """``torch.distributed.init_process_group("gloo", ...)`` when
    ``num_processes > 1`` (``coordinator_address`` as ``host:port`` or a
    ``tcp://`` URL); returns True if a multi-process group is live."""
    import torch.distributed as dist

    if num_processes is not None and num_processes > 1:
        addr = coordinator_address or ""
        if "://" not in addr:
            addr = f"tcp://{addr}"
        dist.init_process_group("gloo", init_method=addr, world_size=num_processes,
                                rank=process_id)
        return True
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


_BCAST_BUF = 1 << 16


def _broadcast_ops(ops: list) -> list:
    """Replication consistency guard. Every process runs the same statement
    stream, so each reaches this point with the same op. Rank 0's op is
    broadcast (JSON in a fixed uint8 buffer) and every rank checks that its
    own op matches before applying, catching divergent registries early."""
    if _world() <= 1:
        return ops
    import torch.distributed as dist

    payload = json.dumps(ops).encode("utf-8")
    if len(payload) > _BCAST_BUF - 4:
        raise ValueError("control-plane op too large to broadcast")
    buf = np.zeros(_BCAST_BUF, np.uint8)
    buf[:4] = np.frombuffer(np.int32(len(payload)).tobytes(), np.uint8)
    buf[4:4 + len(payload)] = np.frombuffer(payload, np.uint8)
    t = torch.from_numpy(buf)
    dist.broadcast(t, src=0)
    out = t.numpy()
    n = int(np.frombuffer(out[:4].tobytes(), np.int32)[0])
    canonical = [tuple(op) for op in json.loads(out[4:4 + n].tobytes().decode("utf-8"))]
    if canonical != [tuple(op) for op in ops]:
        raise RuntimeError(f"registry op divergence across processes: rank0={canonical} "
                           f"local={ops}")
    return ops


@dataclass
class ReplicatedModelOps:
    """Apply registry mutations locally and (with a process group) through
    the rank-0 broadcast, so every process stays in sync."""

    applied: list = field(default_factory=list)

    def load(self, name: str, path_or_url: str) -> None:
        for op in _broadcast_ops([("load", name, path_or_url)]):
            self._apply(op)

    def unload(self, name: str) -> None:
        for op in _broadcast_ops([("unload", name, "")]):
            self._apply(op)

    def autoload(self, path: str) -> str:
        result = None
        for op in _broadcast_ops([("autoload", path, "")]):
            result = self._apply(op)
        return result

    def _apply(self, op):
        kind, a, b = op
        self.applied.append(tuple(op))
        if kind == "load":
            api.load_model(a, b)
        elif kind == "unload":
            api.unload_model(a)
        elif kind == "autoload":
            return api.set_autoload_dir(a)
        return None


class Heartbeat:
    """Worker liveness monitor: each worker calls ``beat(worker_id)``; a
    thread flags workers whose last beat is older than the deadline and
    calls ``on_dead`` once per transition, for the stateless partition
    restart (``run_partitions_with_retry``)."""

    def __init__(self, deadline_s: float = 5.0, interval_s: float = 1.0, on_dead=None):
        self.deadline_s = deadline_s
        self.interval_s = interval_s
        self.on_dead = on_dead
        self._last: dict = {}
        self._dead: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    def beat(self, worker_id) -> None:
        with self._lock:
            self._last[worker_id] = time.monotonic()
            self._dead.discard(worker_id)   # recovered

    def dead_workers(self) -> set:
        with self._lock:
            return set(self._dead)

    def _scan(self) -> None:
        now = time.monotonic()
        newly_dead = []
        with self._lock:
            for worker_id, last in self._last.items():
                if worker_id not in self._dead and now - last > self.deadline_s:
                    self._dead.add(worker_id)
                    newly_dead.append(worker_id)
        for worker_id in newly_dead:
            log.warn(f"worker {worker_id} missed heartbeat deadline ({self.deadline_s}s)")
            if self.on_dead is not None:
                self.on_dead(worker_id)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._scan()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class PartitionFailure(Exception):
    def __init__(self, partition: int, cause: Exception):
        self.partition = partition
        self.cause = cause
        super().__init__(f"partition {partition} failed: {cause}")


def run_partitions_with_retry(partition_fn, n_partitions: int, max_attempts: int = 3,
                              retry_delay_s: float = 0.0, fault_hook=None) -> list:
    """Run ``partition_fn(p)`` for every partition with per-partition retry:
    inference carries no state, so a lost worker's partition is re-run.
    ``fault_hook(p, attempt)`` (test injection) may raise to simulate a lost
    worker. An engine error (``InferaError``) is deterministic and raises at
    once; any other exception is retried, and a partition that exhausts its
    attempts raises ``PartitionFailure``. Returns the results in partition
    order."""
    results = [None] * n_partitions
    for p in range(n_partitions):
        last = None
        for attempt in range(1, max_attempts + 1):
            try:
                if fault_hook is not None:
                    fault_hook(p, attempt)
                results[p] = partition_fn(p)
                last = None
                break
            except InferaError:
                raise   # engine errors are deterministic; retrying cannot help
            except Exception as e:  # noqa: BLE001 - a lost worker raises anything
                last = e
                log.warn(f"partition {p} attempt {attempt}/{max_attempts} failed: {e}")
                if attempt < max_attempts and retry_delay_s:
                    time.sleep(retry_delay_s)
        if last is not None:
            raise PartitionFailure(p, last)
    return results
