"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared beside its limit, also printed as the last lines of standard
error). Without a CUDA card, or with fewer than the cell asks for, it exits
with code 2 and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
CACHE = HERE / ".cache"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # the checkout's root, never this folder, leads the import path
    sys.path[:] = [str(CHECKOUT)] + [p for p in sys.path if Path(p or ".").resolve() != HERE]
    with open(CHECKOUT / "BENCHMARK.json") as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"needs {wl['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    tmpdir = Path(tempfile.mkdtemp(prefix="perfbench-"))
    try:
        from perfbench import harness

        harness.scrub_environment(CACHE, tmpdir)
        import infera_tpu_torch
        from infera_tpu_torch import observability

        if not Path(infera_tpu_torch.__file__).resolve().is_relative_to(CHECKOUT):
            print(f"infera_tpu_torch comes from {infera_tpu_torch.__file__}, not this checkout",
                  file=sys.stderr)
            return 2
        observability.enable_persistent_compilation_cache(str(CACHE / "cuda_kernels"))
        result = harness.run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                             T_PROCESS, tmpdir=tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
