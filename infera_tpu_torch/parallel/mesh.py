"""The device mesh and its collectives, driven by one controller.

Counterpart of ``infera_tpu/parallel/mesh.py`` and of the ``jax.lax``
collectives its ``shard_map`` programs call. A JAX mesh on one host is
driven by one process, and so is this one: a ``Mesh`` is a ``(dp, mp)``
grid of ``torch.device``s, a "sharded" value is a list of tensors, one a
shard this process holds, and the collectives below take and return such
lists. Axes:

- ``dp``: the data-parallel axis. Tables are row-partitioned over it. A
  value sharded on ``dp`` alone is a list with one tensor a local dp row.
- ``mp``: the model-parallel axis. It carries the tensor-, pipeline-,
  expert- and sequence-parallel forms (``parallel/pipeline.py``,
  ``parallel/ring_attention.py``). A value sharded over ``(dp, mp)`` is a
  list of the local grid's shards in the grid's row-major order
  (``Mesh.local_grid``); ``shard`` and ``gather`` move a global tensor in
  and out of that form.

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
tensors needs NCCL and one card a process (ROADMAP P13c,
blocked on a one-card machine): it raises.

``psum``, ``all_gather``, ``all_to_all`` and ``ppermute`` take ``axis``:
``"dp"`` (over a dp list; the default but for ``ppermute``, as the mesh plan,
the shuffle and the query step call them) or ``"mp"`` (over a grid list,
within each dp row). A process holds whole dp rows, so an ``mp``
collective never crosses processes and needs no ``torch.distributed``, on a
gloo mesh too.
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
            "across processes needs NCCL and one card a process (ROADMAP P13c, "
            "blocked on a one-card machine)")


class Mesh:
    """A ``(dp, mp)`` grid of devices with ``axis_names`` and a ``shape``
    mapping (``mesh.shape["dp"]``), as ``jax.sharding.Mesh``.

    ``local`` lists the dp indices this process holds (all of them without
    a process group), ``local_devices`` the devices of their ``mp`` column
    0 (where a dp list lives), ``local_grid`` the devices of every local
    ``(dp, mp)`` shard in row-major order (where a grid list lives) and
    ``n_physical`` the distinct devices the whole mesh spans."""

    def __init__(self, devices: np.ndarray, world: int = 1, rank: int = 0):
        self.devices = devices
        self.axis_names = AXES
        dp, mp = devices.shape
        self.shape = {"dp": dp, "mp": mp}
        self.world, self.rank = world, rank
        per = dp // world
        self.local = list(range(rank * per, (rank + 1) * per))
        self.local_devices = [devices[i, 0] for i in self.local]
        self.local_grid = [devices[i, j] for i in self.local for j in range(mp)]
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


def shard(mesh: Mesh, x, spec: tuple = ()) -> list:
    """``x`` (a host array or a tensor) as a grid list, as
    ``jax.device_put(x, NamedSharding(mesh, P(*spec)))``: local grid shard
    ``(i, j)`` takes, along each axis of ``x`` that ``spec`` names ``"dp"``
    or ``"mp"``, its ``i``-th or ``j``-th equal part, and the whole of every
    other axis. A list or tuple is taken as a grid list already."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(mesh.local_grid):
            raise ValueError(f"a grid list holds {len(mesh.local_grid)} shards, got {len(x)}")
        return list(x)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    mp = mesh.shape["mp"]
    out = []
    for k, dev in enumerate(mesh.local_grid):
        at = {"dp": mesh.local[k // mp], "mp": k % mp}
        part = x
        for ax, name in enumerate(spec):
            if name is None:
                continue
            n = mesh.shape[name]
            if part.shape[ax] % n:
                raise ValueError(f"axis {ax} of {tuple(x.shape)} does not split evenly over "
                                 f"{n} {name} shards")
            c = part.shape[ax] // n
            part = part.narrow(ax, at[name] * c, c)
        out.append(part.to(dev, non_blocking=True))
    return out


def gather(mesh: Mesh, xs: list, spec: tuple = ()) -> torch.Tensor:
    """The global tensor of a grid list sharded as ``spec`` (the inverse of
    ``shard``; a ``"dp"`` axis must be axis 0), on the first local device:
    the ``mp`` parts of each dp row concatenated, then the dp rows (across
    processes too)."""
    mp = mesh.shape["mp"]
    rows = [xs[r * mp:(r + 1) * mp] for r in range(len(mesh.local))]
    if "mp" in spec:
        ax = spec.index("mp")
        rows = [[torch.cat([t.to(row[0].device, non_blocking=True) for t in row], ax)]
                for row in rows]
    col = [row[0] for row in rows]
    if "dp" in spec:
        if spec.index("dp") != 0:
            raise ValueError(f"gather needs the dp axis first, got {spec}")
        return all_gather(mesh, col)[0]
    return col[0]


def _groups(mesh: Mesh, xs: list, axis: str) -> list:
    """(shards, devices) of each group a collective over ``axis`` runs
    within: the whole dp list for ``"dp"``, each local dp row of a grid list
    for ``"mp"``."""
    if axis == "dp":
        return [(list(xs), mesh.local_devices)]
    if axis != "mp":
        raise ValueError(f"no mesh axis {axis!r}; the axes are {AXES}")
    if len(xs) != len(mesh.local_grid):
        raise ValueError(f"an mp collective takes a grid list of {len(mesh.local_grid)} "
                         f"shards, got {len(xs)}")
    mp = mesh.shape["mp"]
    return [(xs[r * mp:(r + 1) * mp], mesh.local_grid[r * mp:(r + 1) * mp])
            for r in range(len(mesh.local))]


def _cross(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A tensor ready for a gloo collective: on the CPU, contiguous."""
    _no_cuda_group(t.device)
    return t.contiguous()


def _all_reduce(mesh: Mesh, xs: list, local_op, dist_op: str, axis: str) -> list:
    out = []
    for group, devs in _groups(mesh, xs, axis):
        acc = group[0]
        for x in group[1:]:
            acc = local_op(acc, x.to(acc.device, non_blocking=True))
        if axis == "dp" and mesh.distributed:
            import torch.distributed as dist

            is_bool = acc.dtype == torch.bool
            t = _cross(mesh, acc.to(torch.uint8) if is_bool else acc.clone())
            dist.all_reduce(t, op=getattr(dist.ReduceOp, dist_op))
            acc = t.bool() if is_bool else t
        out += [acc.to(d, non_blocking=True) for d in devs]
    return out


def psum(mesh: Mesh, xs: list, axis: str = "dp") -> list:
    """The sum over every shard of ``axis`` (``jax.lax.psum``), on each
    shard (a bool sums as int64)."""
    xs = [x.long() if x.dtype == torch.bool else x for x in xs]
    return _all_reduce(mesh, xs, torch.add, "SUM", axis)


def pmin(mesh: Mesh, xs: list) -> list:
    """The elementwise minimum over every shard of the mesh (NaN wins, as
    XLA's)."""
    return _all_reduce(mesh, xs, torch.minimum, "MIN", "dp")


def pmax(mesh: Mesh, xs: list) -> list:
    """The elementwise maximum over every shard of the mesh (NaN wins, as
    XLA's)."""
    return _all_reduce(mesh, xs, torch.maximum, "MAX", "dp")


def all_gather(mesh: Mesh, xs: list, axis: str = "dp") -> list:
    """Every shard's tensor of ``axis`` concatenated along axis 0 in axis
    order (``jax.lax.all_gather(..., tiled=True)``), on each shard."""
    out = []
    for group, devs in _groups(mesh, xs, axis):
        dev0 = group[0].device
        acc = torch.cat([x.to(dev0, non_blocking=True) for x in group])
        if axis == "dp" and mesh.distributed:
            import torch.distributed as dist

            t = _cross(mesh, acc.to(torch.uint8) if acc.dtype == torch.bool else acc)
            parts = [torch.empty_like(t) for _ in range(mesh.world)]
            dist.all_gather(parts, t)
            acc = torch.cat(parts).to(acc.dtype)
        out += [acc.to(d, non_blocking=True) for d in devs]
    return out


def all_to_all(mesh: Mesh, xs: list, axis: str = "dp") -> list:
    """``jax.lax.all_to_all(x, axis, 0, 0)``: over the ``n`` shards of
    ``axis``, each shard's ``[n, ...]`` tensor sends its row ``d`` to shard
    ``d``; shard ``d`` gets ``[n, ...]`` whose row ``s`` came from shard
    ``s``."""
    groups = _groups(mesh, xs, axis)
    n = mesh.shape[axis]
    for x in xs:
        if x.shape[0] != n:
            raise ValueError(f"all_to_all needs [{n}, ...] tensors over {axis}, "
                             f"got {tuple(x.shape)}")
    if axis == "mp" or not mesh.distributed:
        out = []
        for group, devs in groups:
            dev0 = group[0].device
            if all(d == dev0 for d in devs):
                stacked = torch.stack(group)   # [src, dst, ...]
                out += [stacked[:, j] for j in range(n)]
            else:
                out += [torch.stack([x[j].to(dst, non_blocking=True) for x in group])
                        for j, dst in enumerate(devs)]
        return out
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


def ppermute(mesh: Mesh, xs: list, perm, axis: str = "mp") -> list:
    """``jax.lax.ppermute(x, axis, perm)``: for each ``(src, dst)`` pair of
    ``perm`` (indices along ``axis``), shard ``dst`` receives shard
    ``src``'s tensor; a shard that no pair names as a destination receives
    zeros (the pipeline's first stage relies on it). Over ``"mp"`` only,
    which never crosses processes."""
    if axis != "mp":
        raise ValueError(f"ppermute runs over mp only, not {axis!r}")
    groups = _groups(mesh, xs, axis)
    perm = [(int(s), int(d)) for s, d in perm]
    n = mesh.shape[axis]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) < len(srcs) or len(set(dsts)) < len(dsts) or not all(
            0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute over {axis} of {n} shards needs distinct sources and "
                         f"destinations in range, got {perm}")
    came_from = {d: s for s, d in perm}
    out = []
    for group, devs in groups:
        for j, (x, dev) in enumerate(zip(group, devs)):
            if j in came_from:
                out.append(group[came_from[j]].to(dev, non_blocking=True))
            else:
                out.append(torch.zeros_like(x, device=dev))
    return out


def synchronize(mesh: Mesh) -> None:
    """Wait for the work queued on every local CUDA device of the mesh."""
    for d in {str(d): d for d in mesh.local_grid}.values():
        if d.type == "cuda":
            torch.cuda.synchronize(d)
