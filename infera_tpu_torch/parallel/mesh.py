"""The device mesh and its collectives, driven by one controller.

Counterpart of ``infera_tpu/parallel/mesh.py`` and of the ``jax.lax``
collectives its ``shard_map`` programs call. A JAX mesh on one host is
driven by one process, and so is this one: a ``Mesh`` is a ``(dp, mp)``
grid of ``torch.device``s, a "sharded" value is a list of tensors, one a
shard this process holds, and the collectives below take and return such
lists. Axes:

- ``dp``: the data-parallel axis. Tables are row-partitioned over it.
- ``mp``: the model-parallel axis, reserved (tensor-, pipeline- and
  expert-parallel forms are ROADMAP P13b).

``make_mesh(n)`` places shard ``i`` on ``cuda:(i % torch.cuda.device_count())``
on CUDA, so on one card every shard shares ``cuda:0``: logical shards, as
``infera_tpu``'s tests run 8 virtual CPU devices on one host. On the CPU
every shard is ``cpu``. A CUDA mesh never falls back to the CPU.

Between shards of one process a collective is index operations (and
``.to(dst, non_blocking=True)`` copies between cards). Where
``parallel/distributed.initialize`` built a process group, each process holds
``n / world`` consecutive shards: a collective first reduces or stacks over
its local shards, then runs once across processes through
``torch.distributed`` (gloo, on CPU tensors): ``all_reduce`` with SUM, MIN or
MAX, ``all_gather``, ``all_to_all_single``. A process group over CUDA
tensors needs NCCL and one card a process, which is ROADMAP P13b: it raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device

AXES = ("dp", "mp")


def _process_group():
    """(world size, rank) of the default process group, or (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _no_cuda_group(device: torch.device) -> None:
    if device.type == "cuda":
        raise NotImplementedError(
            "a mesh across processes runs gloo collectives on CPU tensors; a CUDA mesh "
            "across processes needs NCCL and one card a process (ROADMAP P13b)")


class Mesh:
    """A ``(dp, mp)`` grid of devices with ``axis_names`` and a ``shape``
    mapping (``mesh.shape["dp"]``), as ``jax.sharding.Mesh``.

    ``local`` lists the dp indices this process holds (all of them without
    a process group), ``local_devices`` their devices and ``n_physical``
    the distinct devices the whole mesh spans."""

    def __init__(self, devices: np.ndarray, world: int = 1, rank: int = 0):
        self.devices = devices
        self.axis_names = AXES
        dp, mp = devices.shape
        self.shape = {"dp": dp, "mp": mp}
        self.world, self.rank = world, rank
        per = dp // world
        self.local = list(range(rank * per, (rank + 1) * per))
        self.local_devices = [devices[i, 0] for i in self.local]
        self.n_physical = len({str(d) for d in devices.flat}) * world

    @property
    def distributed(self) -> bool:
        return self.world > 1

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, mp={self.shape['mp']}, "
                f"devices={self.n_physical} physical, processes={self.world})")


def make_mesh(n_devices: int | None = None, mp: int = 1, device=None) -> Mesh:
    """A ``(dp, mp)`` mesh of ``n_devices`` shards on ``device`` (default
    ``get_device()``): on CUDA shard ``i`` on ``cuda:(i % device_count)``,
    on the CPU every shard on ``cpu``. Under a process group the mesh is
    global: ``n_devices`` shards over all processes, ``n_devices / world``
    of them here (gloo, so the CPU only). ``n_devices`` defaults to the
    physical devices of all processes."""
    device = torch.device(device) if device is not None else get_device()
    world, rank = _process_group()
    if world > 1:
        _no_cuda_group(device)
    phys = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_devices is None:
        n_devices = phys * world
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n_devices}")
    if n_devices % mp != 0:
        raise ValueError(f"n_devices {n_devices} not divisible by mp {mp}")
    dp = n_devices // mp
    if dp % world != 0:
        raise ValueError(f"dp {dp} not divisible by the {world} processes of the group")
    if device.type == "cuda":
        devs = [torch.device("cuda", i % phys) for i in range(n_devices)]
    else:
        devs = [torch.device("cpu")] * n_devices
    grid = np.empty((dp, mp), dtype=object)
    for i, d in enumerate(devs):
        grid[i // mp, i % mp] = d
    return Mesh(grid, world, rank)


def local_rows(n: int, dp: int) -> int:
    """Rows a shard holds when ``n`` rows split over ``dp`` shards (the last
    shards zero-padded)."""
    return -(-n // dp)


def shard_rows(mesh: Mesh, x) -> tuple:
    """(shards, valid): ``x`` (a host array or a tensor, rows on axis 0)
    split into ``dp`` row shards of ``ceil(n / dp)`` rows, zero-padded, one
    for each local shard on its device, and each shard's validity mask
    (False on padding rows), as ``infera_tpu``'s ``row_sharding`` with the
    mask of its mesh plan."""
    n = x.shape[0]
    local_n = local_rows(n, mesh.shape["dp"])
    shards, valid = [], []
    for s, dev in zip(mesh.local, mesh.local_devices):
        lo, hi = min(s * local_n, n), min((s + 1) * local_n, n)
        part = x[lo:hi]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        part = part.to(dev, non_blocking=True)
        if hi - lo < local_n:
            pad = torch.zeros((local_n - (hi - lo),) + tuple(part.shape[1:]), dtype=part.dtype,
                              device=dev)
            part = torch.cat([part, pad])
        shards.append(part)
        v = torch.zeros(local_n, dtype=torch.bool, device=dev)
        v[:hi - lo] = True
        valid.append(v)
    return shards, valid


def replicate(mesh: Mesh, x) -> list:
    """``x`` (a host array or a tensor) on each local shard's device, as
    ``infera_tpu``'s ``replicated`` sharding."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return [x.to(d, non_blocking=True) for d in mesh.local_devices]


def _cross(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A tensor ready for a gloo collective: on the CPU, contiguous."""
    _no_cuda_group(t.device)
    return t.contiguous()


def _all_reduce(mesh: Mesh, xs: list, local_op, dist_op: str) -> list:
    acc = xs[0]
    for x in xs[1:]:
        acc = local_op(acc, x.to(acc.device, non_blocking=True))
    if mesh.distributed:
        import torch.distributed as dist

        is_bool = acc.dtype == torch.bool
        t = _cross(mesh, acc.to(torch.uint8) if is_bool else acc.clone())
        dist.all_reduce(t, op=getattr(dist.ReduceOp, dist_op))
        acc = t.bool() if is_bool else t
    return [acc.to(d, non_blocking=True) for d in mesh.local_devices]


def psum(mesh: Mesh, xs: list) -> list:
    """The sum over every shard of the mesh, on each local shard (a bool
    sums as int64)."""
    xs = [x.long() if x.dtype == torch.bool else x for x in xs]
    return _all_reduce(mesh, xs, torch.add, "SUM")


def pmin(mesh: Mesh, xs: list) -> list:
    """The elementwise minimum over every shard (NaN wins, as XLA's)."""
    return _all_reduce(mesh, xs, torch.minimum, "MIN")


def pmax(mesh: Mesh, xs: list) -> list:
    """The elementwise maximum over every shard (NaN wins, as XLA's)."""
    return _all_reduce(mesh, xs, torch.maximum, "MAX")


def all_gather(mesh: Mesh, xs: list) -> list:
    """Every shard's tensor concatenated along axis 0 in dp order
    (``jax.lax.all_gather(..., tiled=True)``), on each local shard."""
    dev0 = xs[0].device
    acc = torch.cat([x.to(dev0, non_blocking=True) for x in xs])
    if mesh.distributed:
        import torch.distributed as dist

        t = _cross(mesh, acc.to(torch.uint8) if acc.dtype == torch.bool else acc)
        parts = [torch.empty_like(t) for _ in range(mesh.world)]
        dist.all_gather(parts, t)
        acc = torch.cat(parts).to(acc.dtype)
    return [acc.to(d, non_blocking=True) for d in mesh.local_devices]


def all_to_all(mesh: Mesh, xs: list) -> list:
    """``jax.lax.all_to_all(x, "dp", 0, 0)``: each local shard's ``[dp, ...]``
    tensor sends its row ``d`` to shard ``d``; shard ``d`` gets ``[dp, ...]``
    whose row ``s`` came from shard ``s``."""
    dp = mesh.shape["dp"]
    for x in xs:
        if x.shape[0] != dp:
            raise ValueError(f"all_to_all needs [{dp}, ...] tensors, got {tuple(x.shape)}")
    if not mesh.distributed:
        dev0 = xs[0].device
        if all(d == dev0 for d in mesh.local_devices):
            stacked = torch.stack(xs)   # [src, dst, ...]
            return [stacked[:, j] for j in range(dp)]
        return [torch.stack([x[j].to(dst, non_blocking=True) for x in xs])
                for j, dst in enumerate(mesh.local_devices)]
    import torch.distributed as dist

    L, P = len(xs), mesh.world
    tail = tuple(xs[0].shape[1:])
    dtype = xs[0].dtype
    stacked = torch.stack(xs).reshape((L, P, L) + tail)   # [local src, process, local dst]
    if dtype == torch.bool:
        stacked = stacked.to(torch.uint8)                  # gloo moves no bool
    send = _cross(mesh, stacked.transpose(0, 1))
    recv = torch.empty_like(send)                          # [process src, local src, local dst]
    dist.all_to_all_single(recv, send)
    recv = recv.reshape((P * L, L) + tail).to(dtype)
    return [recv[:, j].to(d, non_blocking=True) for j, d in enumerate(mesh.local_devices)]


def synchronize(mesh: Mesh) -> None:
    """Wait for the work queued on every local CUDA device of the mesh."""
    for d in {str(d): d for d in mesh.local_devices}.values():
        if d.type == "cuda":
            torch.cuda.synchronize(d)
