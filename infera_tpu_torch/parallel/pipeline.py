"""The distributed query step and the model-parallel inference forms.

Counterpart of ``infera_tpu/parallel/pipeline.py``. The data-parallel step
covers BASELINE.json's north-star shape over a mesh: scan → batched
inference → filter → distributed shuffle → grouped aggregate. The tensor-,
pipeline- and expert-parallel steps (``make_tp_inference_step``,
``make_pp_inference_step``, ``make_ep_inference_step``) run over the mesh's
``mp`` axis on grid lists (``parallel/mesh.py``), each shard's work the body
of the reference's ``shard_map``, one shard after another; their products
are ``torch.matmul`` in f32, where the reference calls ``jnp.dot`` outside
any Pallas kernel.

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


def mlp_apply_tp(mesh, params, xs: list, axis: str = "mp") -> list:
    """The tensor-parallel 2-layer MLP block (Megatron layout) on a grid
    list: ``params`` = ``((w1, b1), (w2, b2))``, each a grid list, ``w1``
    column-sharded on ``axis`` (each shard computes a slice of the hidden
    layer, no exchange), ``w2`` row-sharded with one ``psum`` to assemble
    the output, ``b2`` replicated and added after it."""
    (w1, b1), (w2, b2) = params
    partials = [torch.matmul(torch.relu(torch.matmul(x, a) + c), w)
                for x, a, c, w in zip(xs, w1, b1, w2)]
    return [p + b for p, b in zip(M.psum(mesh, partials, axis), b2)]


def make_tp_inference_step(mesh):
    """fn(((w1, b1), (w2, b2)), x) -> y [N, d_out]: ``x`` row-sharded on dp
    and replicated on mp, the weights sharded on mp as ``mlp_apply_tp``
    takes them. Each argument is a global array or tensor (sharded here) or
    a grid list; ``y`` is the dp shards concatenated on the first local
    device."""

    def step(params, x):
        (w1, b1), (w2, b2) = params
        sharded = ((M.shard(mesh, w1, (None, "mp")), M.shard(mesh, b1, ("mp",))),
                   (M.shard(mesh, w2, ("mp", None)), M.shard(mesh, b2, ())))
        ys = mlp_apply_tp(mesh, sharded, M.shard(mesh, x, ("dp", None)))
        return M.gather(mesh, ys, ("dp", None))

    return step


def make_pp_inference_step(mesh, n_stages: int, n_micro: int):
    """GPipe pipeline-parallel inference over the ``mp`` axis, one stage a
    shard (a ``[d, d]`` layer + ReLU). In ``n_micro + n_stages - 1`` ticks
    stage 0 takes microbatch ``x[clip(t, 0, n_micro - 1)]``, every other
    stage what ``ppermute`` sent it (zeros where nothing was sent), and the
    last stage writes microbatch ``t - (n_stages - 1)``. Only the last stage
    keeps outputs, and the step returns the first dp row's copy (the
    reference's ``psum`` over ``mp`` only broadcasts it).

    fn((W [n_stages, d, d], B [n_stages, d]), x [n_micro, mb, d]) ->
    y [n_micro, mb, d] on the first local device; ``W`` and ``B`` sharded
    on mp, ``x`` replicated (global arrays or grid lists)."""
    if mesh.shape["mp"] != n_stages:
        raise ValueError(f"{n_stages} stages need a mesh with mp={n_stages}, "
                         f"not {mesh.shape['mp']}")
    fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]
    last = n_stages - 1

    def step(stage_params, x):
        W, B = stage_params
        ws = [w[0] for w in M.shard(mesh, W, ("mp", None, None))]
        bs = [b[0] for b in M.shard(mesh, B, ("mp", None))]
        xs = M.shard(mesh, x, ())
        stage = [k % n_stages for k in range(len(xs))]
        mb, d = xs[0].shape[1], xs[0].shape[2]
        recv = [torch.zeros((mb, d), dtype=torch.float32, device=xk.device) for xk in xs]
        ys = {k: torch.zeros((n_micro, mb, d), dtype=torch.float32, device=xs[k].device)
              for k, s in enumerate(stage) if s == last}
        for t in range(n_micro + n_stages - 1):
            inject = min(max(t, 0), n_micro - 1)
            outs = [torch.relu(torch.matmul(xk[inject] if s == 0 else r, w) + b)
                    for s, xk, r, w, b in zip(stage, xs, recv, ws, bs)]
            recv = M.ppermute(mesh, outs, fwd_perm)
            done = t - last
            if done >= 0:
                for k, y in ys.items():
                    y[done] = outs[k]
        return ys[last].to(mesh.local_grid[0])

    return step


def make_ep_inference_step(mesh, n_experts: int, cap: int):
    """Expert-parallel (MoE-style) inference over the ``mp`` axis, one
    expert a shard. Each shard packs its rows by expert
    (``part = expert_id % n_experts``, ``shuffle._pack_buckets`` at
    ``cap``), an ``all_to_all`` brings each expert its rows, the expert
    applies ``relu(x @ w + b)`` (invalid slots masked to 0) and a reverse
    ``all_to_all`` returns the results to the rows' slots, which
    ``_bucket_slots`` finds again. A row past ``cap`` in its (source,
    expert) bucket gives 0 and is not counted.

    fn(expert_w [n_experts, d, d], expert_b [n_experts, d], x [N, d],
    expert_id [N]) -> (y [N, d], routed): the weights sharded on mp, ``x``
    and ``expert_id`` row-sharded on mp (global arrays or grid lists);
    ``y`` on the first local device, ``routed`` the number of rows an expert
    computed (a ``psum`` over mp)."""
    if mesh.shape["mp"] != n_experts:
        raise ValueError(f"{n_experts} experts need a mesh with mp={n_experts}, "
                         f"not {mesh.shape['mp']}")

    def step(expert_w, expert_b, x, expert_id):
        ews = [w[0] for w in M.shard(mesh, expert_w, ("mp", None, None))]
        ebs = [b[0] for b in M.shard(mesh, expert_b, ("mp", None))]
        xs = M.shard(mesh, x, ("mp", None))
        parts = [e.long() % n_experts for e in M.shard(mesh, expert_id, ("mp",))]
        packed, send_valid = [], []
        for part, xk in zip(parts, xs):
            (buf,), valid = S._pack_buckets(part, [xk], n_experts, cap)
            packed.append(buf)
            send_valid.append(valid)
        recv_valid = M.all_to_all(mesh, send_valid, "mp")
        recv_x = M.all_to_all(mesh, packed, "mp")
        ys = []
        for rx, rv, w, b in zip(recv_x, recv_valid, ews, ebs):
            y = torch.relu(torch.matmul(rx.reshape(-1, rx.shape[-1]), w) + b)
            ys.append(torch.where(rv.reshape(-1)[:, None], y, 0.0).reshape(rx.shape))
        # the results go back to the source shard in the same bucket slots
        back = M.all_to_all(mesh, ys, "mp")
        back_valid = M.all_to_all(mesh, recv_valid, "mp")
        outs, counts = [], []
        for part, bk, bv in zip(parts, back, back_valid):
            rank = _bucket_slots(part, n_experts)
            slot = torch.clamp(rank, max=cap - 1)
            valid = bv[part, slot] & (rank < cap)
            outs.append(torch.where(valid[:, None], bk[part, slot], 0.0))
            counts.append(valid.sum())
        routed = M.psum(mesh, counts, "mp")[0]
        return M.gather(mesh, outs, ("mp", None)), routed

    return step


def _bucket_slots(part: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Slot index of each row within its destination bucket (stable order),
    the placement of ``shuffle._pack_buckets``."""
    part = part.long()
    # [buckets, rows]: the scan runs along the contiguous last axis (a scan
    # along axis 0 of [rows, buckets] walks each bucket's column serially)
    onehot = (part[None, :] == torch.arange(n_buckets, device=part.device)[:, None]).long()
    pos = torch.cumsum(onehot, dim=1) - onehot
    return torch.gather(pos, 0, part[None, :])[0]


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
