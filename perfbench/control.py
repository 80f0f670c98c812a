"""The control of a cell: its configuration's lower precision switched on
(``control`` in the configuration's file), run at the cell's own size and
load over several seeds in one process, each run's compared numbers
printed as one JSON line. It has to come out not correct on every seed.
The benchmark's own runs never run it.

    python3 perfbench/control.py --workload <name> --seeds 11 12 13 --seconds 10
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    sys.path[:] = [str(CHECKOUT)] + [p for p in sys.path if Path(p or ".").resolve() != HERE]

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from perfbench import harness

    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    wl = next(w for w in bench["workloads"] if w["name"] == args.workload)
    control = harness.load("configs", wl["config"])["control"]
    tmpdir = Path(tempfile.mkdtemp(prefix="perfbench-control-"))
    try:
        harness.scrub_environment(HERE / ".cache", tmpdir)
        from infera_tpu_torch import observability

        observability.enable_persistent_compilation_cache(str(HERE / ".cache" / "cuda_kernels"))
        for seed in args.seeds:
            r = harness.run(bench, args.workload, seed, args.seconds, False, time.perf_counter(),
                            control=control, tmpdir=tmpdir)
            print(json.dumps({"control": control, "seed": seed, "correct": r["correct"],
                              "attempted": r["attempted"], "failed": r["failed"],
                              "checks": r["checks"]}), flush=True)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
