"""The distributed query step: the data-parallel execution path.

Counterpart of the ``dp`` part of ``infera_tpu/parallel/pipeline.py`` (its
tensor-, pipeline- and expert-parallel steps are ROADMAP P13b). One step
covers BASELINE.json's north-star shape over a mesh: scan → batched
inference → filter → distributed shuffle → grouped aggregate.

- the table arrives row-sharded on the dp axis;
- the MLP runs on each shard with the weights replicated (``torch.matmul``
  in f32; ``infera_tpu`` computes it outside any Pallas kernel too);
- the shuffle moves each selected row's (key, score, selected) to the
  shard ``key % dp`` (``shuffle._pack_buckets`` + ``all_to_all``), with an
  optional hot-partition split, so each shard owns a disjoint key range;
- each shard sums its rows by group, and a ``psum`` gives the global sums.

A sharded value is a list with one tensor a local shard
(``parallel/mesh.py``); the step's outputs are the psum'd tensors on the
first local shard's device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mesh as M
from . import shuffle as S


def mlp_apply(params: list, x: torch.Tensor) -> torch.Tensor:
    """The replicated-weight MLP forward: ``x @ w + b`` a layer in f32,
    ReLU between layers."""
    h = x
    for i, (w, b) in enumerate(params):
        h = torch.matmul(h, w) + b
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def _bucket_slots(part: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Slot index of each row within its destination bucket (stable order),
    the placement of ``shuffle._pack_buckets``."""
    part = part.long()
    onehot = (part[:, None] == torch.arange(n_buckets, device=part.device)[None, :]).long()
    pos = torch.cumsum(onehot, dim=0) - onehot
    return torch.gather(pos, 1, part[:, None])[:, 0]


def _as_shards(mesh, x) -> list:
    """A sharded value as a list of local shards: a list passes through, a
    global array or tensor is split into dp row shards (rows a multiple of
    dp, as the reference's sharding requires)."""
    if isinstance(x, (list, tuple)):
        return list(x)
    if x.shape[0] % mesh.shape["dp"]:
        raise ValueError(f"{x.shape[0]} rows do not split evenly over {mesh.shape['dp']} shards")
    return M.shard_rows(mesh, x)[0]


def make_distributed_query_step(mesh, n_groups: int, cap: int, skew_split: bool = False,
                                hot_factor: float = 4.0):
    """fn(params, x, keys) -> (group_sums [n_groups], group_counts
    [n_groups], total_selected) where ``x`` are the feature rows and
    ``keys`` the int group keys, both row-sharded (lists of local shards,
    or global arrays split here), ``params`` the replicated weights (one
    list of (w, b) a local shard, or one list for all). The filter keeps
    rows whose class-0 score is positive; the shuffle moves them to the
    owner of ``key % dp``; sums and counts are f32, as the reference's."""
    ndev = mesh.shape["dp"]

    def step(params, x, keys):
        xs, ks = _as_shards(mesh, x), _as_shards(mesh, keys)
        if params and isinstance(params[0], tuple):
            params = [params] * len(xs)
        # 1-2. batched inference on each shard, then the filter as a mask
        parts, payloads, sels = [], [], []
        for p, xi, ki in zip(params, xs, ks):
            scores = mlp_apply(p, xi)
            score0 = scores[:, 0]
            sel = score0 > 0.0
            ki = ki.long()
            parts.append(ki % ndev)
            payloads.append([ki, torch.where(sel, score0, 0.0), sel.float()])
            sels.append(sel)
        # 3. shuffle rows to the owner of their key, hot partitions split
        if skew_split:
            parts = S.skew_split_partitions(mesh, parts, hot_factor)
        sends, valids = [], []
        for part, pay in zip(parts, payloads):
            packed, send_valid = S._pack_buckets(part, pay, ndev, cap)
            sends.append(packed)
            valids.append(send_valid)
        rvalid = M.all_to_all(mesh, valids)
        recv = [M.all_to_all(mesh, [s[j] for s in sends]) for j in range(3)]
        # 4. local grouped aggregate over the owned keys (masked segment sums)
        sums, counts = [], []
        for i, v in enumerate(rvalid):
            v = v.reshape(-1)
            rkeys, rscore, rsel = (r[i].reshape(-1) for r in recv)
            w = torch.where(v, rsel, 0.0)
            group = torch.where(v, rkeys % n_groups, 0)
            sums.append(torch.zeros(n_groups, device=w.device).index_add_(0, group, rscore * w))
            counts.append(torch.zeros(n_groups, device=w.device).index_add_(0, group, w))
        # 5. global reduction: each shard owns disjoint keys, psum gathers
        total = M.psum(mesh, [s.float().sum().reshape(()) for s in sels])[0]
        return M.psum(mesh, sums)[0], M.psum(mesh, counts)[0], total

    return step


def example_inputs(mesh, n_rows: int, in_dim: int, out_dim: int, n_groups: int, seed: int = 0,
                   generator: torch.Generator | None = None):
    """Sharded example inputs for the distributed step: (params, x, keys),
    each a list over the local shards. The values come from numpy's
    ``default_rng`` of ``seed`` (or of ``generator``'s initial seed), the
    reference's draws, so both packages see the same inputs."""
    if generator is not None:
        seed = generator.initial_seed()
    rng = np.random.default_rng(seed)
    hidden = 32
    w1 = rng.standard_normal((in_dim, hidden)).astype(np.float32) * np.float32(0.3)
    w2 = rng.standard_normal((hidden, out_dim)).astype(np.float32) * np.float32(0.3)
    x = rng.standard_normal((n_rows, in_dim)).astype(np.float32)
    keys = rng.integers(0, n_groups, n_rows).astype(np.int64)
    host = [(w1, np.zeros(hidden, np.float32)), (w2, np.zeros(out_dim, np.float32))]
    params = [[(torch.from_numpy(w).to(d), torch.from_numpy(b).to(d)) for w, b in host]
              for d in mesh.local_devices]
    return params, _as_shards(mesh, x), _as_shards(mesh, keys)
