"""K7a of two checkouts on one card: a change against its parent.

Run as a script (not with ``-m``, which would import this checkout's package
first), one process a side, in turns, in one call on the card::

    python infera_tpu_torch/testing/ab_k7a.py run ROOT TAG OUT_DIR
    python infera_tpu_torch/testing/ab_k7a.py compare OUT_DIR TAG...

``run`` imports ``infera_tpu_torch`` from ROOT (a checkout, or a ``git
archive`` of one), times 200 queued calls of K7a in bf16 (over a bf16 table)
and in f32 by CUDA events after three warm-up calls, over the bench's table
(1,048,576 rows from ``default_rng(1)``, ``build_params(seed=0)``), prints a
line per mode and saves the counts and sums to OUT_DIR/k7a_TAG.npz.
``compare`` says whether every TAG's outputs equal the first's bit for bit.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def run(root: str, tag: str, out_dir: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import infera_tpu_torch
    from infera_tpu_torch.bench import build_params
    from infera_tpu_torch.ops import fused_query as fq

    want = os.path.join(os.path.abspath(root), "infera_tpu_torch", "__init__.py")
    if infera_tpu_torch.__file__ != want:
        raise RuntimeError(f"imported {infera_tpu_torch.__file__}, not {want}")
    dev = torch.device("cuda")
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((1 << 20, 32))
                        .astype(np.float32), device=dev)
    out = {}
    for mode, dtype, table in (("bf16", torch.bfloat16, x.to(torch.bfloat16)),
                               ("f32", torch.float32, x)):
        w = fq.params_from_numpy(build_params(seed=0), dev, dtype)
        for _ in range(3):
            counts, sums = fq.fused_mlp_query(w, table)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            fq.fused_mlp_query(w, table)
        end.record()
        end.synchronize()
        out[f"{mode}_counts"], out[f"{mode}_sums"] = counts.cpu().numpy(), sums.cpu().numpy()
        print(f"{tag} K7a {mode}: {start.elapsed_time(end) / 200:.4f} ms "
              f"(mean of 200 queued calls, {torch.cuda.get_device_name(0)})")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, f"k7a_{tag}.npz"), **out)


def compare(out_dir: str, tags) -> bool:
    runs = [np.load(os.path.join(out_dir, f"k7a_{tag}.npz")) for tag in tags]
    same = all(np.array_equal(runs[0][k], r[k]) for r in runs[1:] for k in runs[0].files)
    print(f"K7a outputs of {', '.join(tags)}: {'bit-equal' if same else 'DIFFER'}")
    return same


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["run"] and len(argv) == 4:
        run(*argv[1:])
        return 0
    if argv[:1] == ["compare"] and len(argv) >= 3:
        return 0 if compare(argv[1], argv[2:]) else 1
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
