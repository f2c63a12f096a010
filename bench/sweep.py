"""Find an open mix's knee: the highest offered rate at which the
backlog does not grow over the window.

  python3 bench/sweep.py --workload granite-3-8b-prefix.chat-shared \
      --rates 4,6,8,10,12 --seconds 20 --seed 1

Runs the cell's open loop at each rate in turn (one process, a fresh
engine a rate), and prints one JSON line a rate: the backlog (requests
due and still without their first token) averaged over the window's
first and last thirds, whether it grew, requests due and finished, and
the time to first token and gap between tokens at their 50th and 95th
percentiles.  The cell's traffic file then takes four fifths of the
knee as its ``rate_rps`` (PERF.md records the sweep).
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# past the knee the backlog never drains: stop waiting soon
DRAIN_SECONDS = 5.0


def backlog_trend(lives, t0: float, t1: float, samples: int = 60):
    """Mean backlog over the first and the last third of ``[t0, t1]``
    (ms), sampled at ``samples`` points."""
    pts = [t0 + (t1 - t0) * (i + 0.5) / samples for i in range(samples)]

    def backlog(t):
        return sum(1 for lv in lives if lv.due_ms <= t and (
            lv.stream is None or lv.stream.first_token_ms is None
            or lv.stream.first_token_ms > t))

    vals = [backlog(t) for t in pts]
    third = samples // 3
    return (sum(vals[:third]) / third, sum(vals[-third:]) / third)


def sweep_rate(bench, cell, rate: float, seconds: float, seed: int):
    import numpy as np
    import torch

    from bench import harness, model, traffic, weights

    c = harness.load_cell(bench, cell)
    m = model.load(ROOT / "bench" / "configs" / f"{c['config']}.json")
    mix = traffic.override(traffic.load(
        ROOT / "bench" / "traffic" / f"{c['traffic']}.json"), rate_rps=rate)
    w = weights.make(m, seed, "cuda")
    r = harness.Run(m, w, mix, seed, seconds, False, "cuda", {})
    r.drain_s = DRAIN_SECONDS
    r.open()
    lives = [lv for lv in r.lives if lv.due_ms > 0]
    first, last = backlog_trend(lives, r.window_t0, r.window_t1)
    win = r.window_requests()
    ttft = [lv.stream.first_token_ms - lv.due_ms for lv in win
            if lv.stream.first_token_ms is not None]
    itl = [g for lv in win for g in lv.stream.itl_ms()]
    done = sum(lv.stream.finished_ms is not None for lv in win)
    out = {"rate_rps": rate, "due": len(win), "finished": done,
           "backlog_first_third": first, "backlog_last_third": last,
           "grew": last > first + max(2.0, 0.25 * first),
           "ttft_p50_ms": float(np.percentile(ttft, 50)) if ttft else None,
           "ttft_p95_ms": float(np.percentile(ttft, 95)) if ttft else None,
           "itl_p50_ms": float(np.percentile(itl, 50)) if itl else None,
           "itl_p95_ms": float(np.percentile(itl, 95)) if itl else None}
    del r, w, lives, win
    gc.collect()                # the engine and its recorder hold each other
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for rate in (float(x) for x in args.rates.split(",")):
        t = time.perf_counter()
        row = sweep_rate(bench, args.workload, rate, args.seconds, args.seed)
        row["run_s"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
