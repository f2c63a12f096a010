"""Run one cell of the benchmark and print its result line.

  python3 bench/run.py --workload granite-3-8b.batch-sampled \
      --seed 12345 --seconds 30 --trace 0

From the root of a checkout on a machine with the card(s) the cell asks
for.  A cell on more than one card runs one process a card
(``harness.run_on_ranks``); this process prints rank 0's line.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared beside its limit, which also
close standard error).  Exits non-zero with no result when the card is
missing, the program is missing, or the process (or, in rank mode, any
rank) holds a module of JAX or of the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the float8 control in the program's place "
                    "(limit setting)")
    args = ap.parse_args(argv)
    bench_spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench_spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    # kernel caches inside the checkout, at fixed paths; a library that
    # would load JAX by itself is told not to
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from bench import guard, harness

    run_args = (bench_spec, args.workload, args.seed, args.seconds,
                bool(args.trace))
    if need == 1:
        result = harness.run(*run_args, t_start=T_START, device="cuda",
                             control=args.control)
        bad = guard.offenders(sys.modules)
    else:
        try:
            result, bad = harness.run_on_ranks(
                *run_args, t_start=T_START, device="cuda", backend="nccl",
                control=args.control)
        except ValueError as e:
            print(e, file=sys.stderr)
            return 2
        bad = sorted(set(bad) | set(guard.offenders(sys.modules)))
    if bad:
        print(f"the run loaded {bad}: no module of JAX or of the JAX "
              "package may run", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
