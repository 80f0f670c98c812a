"""Distributed shuffle: hash-repartition rows across the dp axis.

Counterpart of ``infera_tpu/parallel/shuffle.py``. Each shard sorts its
local rows by target partition (stable, so rows keep their order inside a
partition), packs a fixed-capacity ``[dp, cap, ...]`` send buffer, and one
``all_to_all`` (``parallel/mesh.py``) delivers every bucket to its owner.
A validity mask travels with the payload and marks the padding slots, so
downstream operators mask them out. ``cap`` equal to the local row count
is exact under any skew; a caller that knows the largest bucket passes it.
"""

from __future__ import annotations

import torch

from . import mesh as M


def _pack_buckets(part: torch.Tensor, payload: list, ndev: int, cap: int):
    """Sort local rows by target partition and pack ``[ndev, cap]`` buckets:
    (packed payload arrays ``[ndev, cap, ...]``, send validity
    ``[ndev, cap]``). A row past ``cap`` in its partition is dropped (its
    validity stays False)."""
    n = part.shape[0]
    dev = part.device
    part = part.long()
    order = torch.sort(part, stable=True).indices
    part_sorted = part[order]
    # position of each row within its partition segment
    ranks = torch.arange(n, device=dev) - torch.searchsorted(part_sorted, part_sorted)
    keep = ranks < cap
    slot = (part_sorted * cap + ranks)[keep]
    send_valid = torch.zeros(ndev * cap, dtype=torch.bool, device=dev)
    send_valid[slot] = True
    packed = []
    src = order[keep]
    for arr in payload:
        buf = torch.zeros((ndev * cap,) + tuple(arr.shape[1:]), dtype=arr.dtype, device=dev)
        buf[slot] = arr[src]
        packed.append(buf.view((ndev, cap) + tuple(arr.shape[1:])))
    return packed, send_valid.view(ndev, cap)


def bucket_cap(mesh, parts: list) -> int:
    """The largest number of rows any local shard sends to one partition,
    over the whole mesh (at least 1): the exact ``cap`` for
    ``_pack_buckets``."""
    ndev = mesh.shape["dp"]
    tops = [torch.bincount(p.long(), minlength=ndev).max().reshape(1) for p in parts]
    return max(int(M.pmax(mesh, tops)[0][0]), 1)


def skew_split_partitions(mesh, parts: list, hot_factor: float = 4.0) -> list:
    """Histogram-based skew mitigation: partitions whose GLOBAL row count
    exceeds ``hot_factor ×`` the mean partition load are spread round-robin
    over all shards instead of hashing to one owner. Correct for
    decomposable aggregates (the final psum merges a split partition's
    partials). ``parts`` holds each local shard's target partitions."""
    ndev = mesh.shape["dp"]
    counts = [torch.bincount(p.long(), minlength=ndev) for p in parts]
    global_counts = M.psum(mesh, counts)
    out = []
    for p, g in zip(parts, global_counts):
        mean_load = g.sum().double() / ndev
        hot = g.double() > hot_factor * mean_load
        spread = (p.long() + torch.arange(p.shape[0], device=p.device)) % ndev
        out.append(torch.where(hot[p.long()], spread, p.long()))
    return out


def make_shuffle(mesh, num_payload: int, cap: int):
    """fn(parts, *payload) -> (valid, *payload_shuffled): each argument a
    list over the local shards; ``parts`` are target shard indices in
    ``[0, dp)``; each output shard holds ``[dp * cap]`` rows (those received
    from every source shard), valid False on padding."""
    ndev = mesh.shape["dp"]

    def fn(parts, *payload):
        if len(payload) != num_payload:
            raise ValueError(f"shuffle built for {num_payload} payload arrays, got {len(payload)}")
        sends, valids = [], []
        for i, part in enumerate(parts):
            packed, send_valid = _pack_buckets(part.long() % ndev, [p[i] for p in payload],
                                               ndev, cap)
            sends.append(packed)
            valids.append(send_valid)
        recv_valid = [v.reshape(ndev * cap) for v in M.all_to_all(mesh, valids)]
        out = []
        for j in range(num_payload):
            recv = M.all_to_all(mesh, [s[j] for s in sends])
            out.append([r.reshape((ndev * cap,) + tuple(r.shape[2:])) for r in recv])
        return (recv_valid, *out)

    return fn


def shuffle_by_hash(mesh, key_hash, payload: list, cap: int | None = None):
    """Repartition ``payload`` arrays (global, rows a multiple of dp) by
    ``key_hash % dp``; returns (valid, *payload) each the concatenation of
    the local shards' ``[dp * cap]`` received rows, in shard order."""
    ndev = mesh.shape["dp"]
    n = key_hash.shape[0]
    if n % ndev:
        raise ValueError(f"{n} rows do not split evenly over {ndev} shards")
    if cap is None:
        cap = n // ndev   # exact under any skew
    key_hash = torch.as_tensor(key_hash)
    part = (key_hash.long() % ndev)
    parts, _ = M.shard_rows(mesh, part)
    shards = [M.shard_rows(mesh, torch.as_tensor(a))[0] for a in payload]
    valid, *outs = make_shuffle(mesh, len(payload), cap)(parts, *shards)
    return (torch.cat(valid), *(torch.cat(o) for o in outs))
