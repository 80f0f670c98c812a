"""Multi-process control plane: process-group init, replicated model
registry, failure recovery.

Counterpart of ``infera_tpu/parallel/distributed.py``:

- ``initialize()``: ``torch.distributed`` process-group bring-up (a no-op
  for one process). The caller gives the address (``tcp://host:port``), the
  world size and the rank; nothing is read from a cluster. It picks the
  transport a CUDA mesh's collectives cross processes by
  (``choose_transport``): NCCL where every process of the host owns a card,
  else gloo through pinned host buffers (two processes on one card), and
  gloo on the CPU.
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
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import api, log
from ..errors import InferaError


# each transport and the process group it runs in: NCCL moves the mesh's
# CUDA tensors and gloo the control plane's CPU tensors (``_broadcast_ops``),
# so an NCCL group is torch's two-backend group, never NCCL alone
PG_BACKEND = {"gloo": "gloo", "gloo-pinned": "gloo", "nccl": "cpu:gloo,cuda:nccl"}

_GROUP: tuple | None = None   # (processes of the host, transport) of initialize's group


def choose_transport(device_type: str, local_world: int, n_cards: int) -> str:
    """The transport of a process group's collectives (a key of
    ``PG_BACKEND``): ``"gloo"`` on the CPU; on CUDA ``"nccl"`` when each of
    the host's ``local_world`` processes can own one of its ``n_cards``
    cards, else ``"gloo-pinned"`` (gloo over pinned host copies of the
    card's tensors). CUDA without a card raises; nothing falls back."""
    if device_type != "cuda":
        return "gloo"
    if n_cards < 1:
        raise RuntimeError("a process group on CUDA needs a CUDA card; torch sees none")
    return "nccl" if local_world <= n_cards else "gloo-pinned"


def card_of(local_rank: int, local_world: int, n_cards: int) -> int:
    """The card of the host's process ``local_rank``: its own where every
    process has one, else a share of one, neighbouring ranks together."""
    if local_world <= n_cards:
        return local_rank
    return local_rank * n_cards // local_world


def local_world(world: int) -> int:
    """The processes of this host: ``LOCAL_WORLD_SIZE``, else all ``world``
    (one host). A host's ranks are consecutive, as torchrun numbers them,
    so process ``rank``'s local rank is ``rank % local_world``."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def group_layout() -> tuple:
    """(processes of the host, transport) of the group ``initialize``
    brought up; raises where it brought up none."""
    if _GROUP is None:
        raise RuntimeError("a CUDA mesh across processes needs the process group that "
                           "parallel.distributed.initialize() brings up")
    return _GROUP


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """``torch.distributed.init_process_group`` when ``num_processes > 1``
    (``coordinator_address`` as ``host:port`` or a ``tcp://`` URL), on the
    transport ``choose_transport`` picks for the port's device
    (``get_device()``), the processes of this host (``local_world``) and
    its cards, recorded for ``make_mesh`` (``group_layout``). On CUDA the
    process's current card becomes its own (``card_of``). Returns True if a
    multi-process group is live."""
    import torch.distributed as dist

    global _GROUP
    if num_processes is not None and num_processes > 1:
        from ..device import get_device

        device = get_device()
        per_host = local_world(num_processes)
        n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
        transport = choose_transport(device.type, per_host, n_cards)
        if device.type == "cuda":
            torch.cuda.set_device(card_of(process_id % per_host, per_host, n_cards))
        addr = coordinator_address or ""
        if "://" not in addr:
            addr = f"tcp://{addr}"
        dist.init_process_group(PG_BACKEND[transport], init_method=addr,
                                world_size=num_processes, rank=process_id)
        _GROUP = per_host, transport
        log.info(f"process {process_id} of {num_processes} ({per_host} on this host): transport "
                 f"{transport}, process group {PG_BACKEND[transport]}")
        return True
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


_BCAST_BUF = 1 << 16


def _broadcast_ops(ops: list) -> list:
    """Replication consistency guard. Every process runs the same statement
    stream, so each reaches this point with the same op. Rank 0's op is
    broadcast (JSON in a fixed uint8 buffer, a CPU tensor: gloo moves it,
    in an NCCL group too) and every rank checks that its own op matches
    before applying, catching divergent registries early."""
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
