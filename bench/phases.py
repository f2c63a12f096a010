"""One traced run of a cell, with its idle time put down to the engine's
phases.

  python3 bench/phases.py --workload granite-3-8b.batch-sampled \
      --seed 12345 --seconds 50

Runs the cell as ``bench/run.py --trace 1`` does and prints one JSON
line: the run's per-layer metrics, then, for the profiled slice, its
idle seconds in all, inside ``engine.run``, outside every
``device.wait`` (the engine's idle) and by innermost engine span
(:meth:`bench.spans.Laid.idle_by_phase`); the gap between the two ways
of aligning the program's spans with the slice (µs); the program's
host-gap counter over the whole window (ms a gap, gaps a second and
their product, the share of the window); and the span log's cost: spans
recorded a second of the slice, and host ns a span with the log off and
on.  Needs the card, as ``bench/run.py`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent


def span_cost_ns(n: int = 200_000) -> dict:
    """Host ns of one span's enter and exit, with the log off and on."""
    from repro_torch.serving import spans

    out = {}
    for on in (False, True):
        t = spans.Tracer({})
        t.recording = on
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with t.span("engine.commit"):
                pass
        out["on" if on else "off"] = (time.perf_counter_ns() - t0) / n
    spans.clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness, spans
    from bench.trace import Slice

    seen = {}
    plain = Slice.from_profiler.__func__

    def keep(cls, prof):
        sl = plain(cls, prof)
        seen["slice"] = sl
        seen["trace_start_ns"] = prof.profiler.kineto_results.trace_start_ns()
        return sl

    harness.Slice.from_profiler = classmethod(keep)
    bench_spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    result = harness.run(bench_spec, args.workload, args.seed, args.seconds,
                         True, t_start=T_START, device="cuda")
    sl = seen["slice"]
    log = spans.program_spans()
    by_trace = spans.base_from_trace_start(seen["trace_start_ns"])
    by_pairs = spans.base_from_pairs(sl, log)
    laid = spans.lay(sl, log, by_trace)
    in_run = laid.run_idle_us() / 1e6
    phases = {k: v / 1e6 for k, v in laid.idle_by_phase().items()}
    wrappers = ("engine.run", "engine.prefill", "engine.decode",
                "engine.mixed_round", "engine.block")
    wc = result["window_counters"]
    window_s = args.seconds
    gaps = wc.get("host_gaps", 0)
    out = {
        "workload": args.workload, "seed": args.seed,
        "correct": result["correct"], "metrics": result["metrics"],
        "slice_s": sl.window_s, "idle_s": sl.window_s - sl.busy_s,
        "idle_in_run_s": in_run,
        "engine_idle_s": laid.engine_idle_us() / 1e6,
        "idle_in_named_child_share": (
            1.0 - phases.get("engine.run", 0.0) / in_run if in_run else None),
        "idle_in_leaf_phase_share": (
            1.0 - sum(phases.get(k, 0.0) for k in wrappers) / in_run
            if in_run else None),
        "idle_by_phase_s": phases,
        "align_pairs_minus_trace_us": (
            (by_pairs - by_trace) / 1e3 if by_pairs is not None else None),
        "host_gap_ms": (1e3 * wc.get("host_gap_seconds", 0.0) / gaps
                        if gaps else None),
        "host_gaps_per_s": gaps / window_s,
        "host_gap_share": wc.get("host_gap_seconds", 0.0) / window_s,
        "spans_per_slice_s": len(laid.rows) / sl.window_s,
        "span_cost_ns": span_cost_ns(),
        "breakdown": result.get("breakdown"),
        "device": result["device"],
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
