"""Ring attention: sequence-parallel exact attention over the ``mp`` axis.

Counterpart of ``infera_tpu/parallel/ring_attention.py``, with its
arithmetic. The sequence shards over ``mp`` (each shard holds one
contiguous chunk of Q, K and V); K and V blocks rotate around the ring by
``ppermute`` while each shard folds every block into an online softmax
(running max, correction, denominator and numerator). After ``mp`` steps
every query chunk has attended to the whole sequence, and no shard held
more than one K/V chunk at a time.

Both products are ``torch.matmul`` in f32 (TF32 off), where the reference
calls ``jnp.dot`` at ``Precision.HIGHEST`` outside any Pallas kernel. A
causal mask writes ``_NEG`` (-1e30, not ``-inf``) on global positions that
each block's ring offset gives; the output is ``acc / where(l == 0, 1, l)``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mesh as M

_NEG = -1e30


def _ring_attention_local(mesh, qs: list, ks: list, vs: list, *, causal: bool) -> list:
    """The per-shard bodies over grid lists of ``[chunk, d]`` shards."""
    n_dev = mesh.shape["mp"]
    chunk, d = qs[0].shape
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    shard = [k % n_dev for k in range(len(qs))]
    ar = [torch.arange(chunk, device=q.device) for q in qs]
    q_pos = [s * chunk + a for s, a in zip(shard, ar)]
    m = [torch.full((chunk,), _NEG, dtype=torch.float32, device=q.device) for q in qs]
    l = [torch.zeros(chunk, dtype=torch.float32, device=q.device) for q in qs]
    acc = [torch.zeros((chunk, d), dtype=torch.float32, device=q.device) for q in qs]
    k_cur, v_cur = list(ks), list(vs)
    for t in range(n_dev):
        for i, (s, q) in enumerate(zip(shard, qs)):
            scores = torch.matmul(q, k_cur[i].T) * scale
            if causal:
                # the K/V block now held arrived from shard (s - t) mod n_dev
                k_pos = ((s - t) % n_dev) * chunk + ar[i]
                scores = torch.where(k_pos[None, :] > q_pos[i][:, None], _NEG, scores)
            m_new = torch.maximum(m[i], scores.max(dim=1).values)
            corr = torch.exp(m[i] - m_new)
            p = torch.exp(scores - m_new[:, None])
            l[i] = l[i] * corr + p.sum(dim=1)
            acc[i] = acc[i] * corr[:, None] + torch.matmul(p, v_cur[i])
            m[i] = m_new
        k_cur = M.ppermute(mesh, k_cur, perm)
        v_cur = M.ppermute(mesh, v_cur, perm)
    return [a / torch.where(li == 0, 1.0, li)[:, None] for a, li in zip(acc, l)]


def make_ring_attention_step(mesh, causal: bool = False):
    """fn(q, k, v) -> out, each ``[seq, d]`` f32 sharded over ``mp`` on the
    sequence axis (``seq`` divisible by ``mesh.shape["mp"]``; global arrays
    or grid lists); ``out`` on the first local device."""

    def step(q, k, v):
        qs, ks, vs = (M.shard(mesh, a, ("mp", None)) for a in (q, k, v))
        outs = _ring_attention_local(mesh, qs, ks, vs, causal=causal)
        return M.gather(mesh, outs, ("mp", None))

    return step
