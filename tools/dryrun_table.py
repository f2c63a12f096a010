#!/usr/bin/env python3
"""Renders the dry run's records (``python -m repro_torch.launch.dryrun
--out DIR``) as the rows of PERF.md's sweep table.

    python3 tools/dryrun_table.py META_DIR [--card CARD_DIR] [--kind serving]

META_DIR holds the meta sweep's records (both meshes), CARD_DIR the
single-pod records traced on the card (``--device cuda``), one file a
cell.  One markdown row a cell of ``all_cells()``: the 16x16 record's
layout, rank mesh and rank batch, TFLOP, GB moved, collective GB (an
all-reduce twice, as the roofline counts it), bound and argument GB,
the JAX layout's ``analytic_memory``, the 2x16x16 record's layout and
rank batch, TFLOP, GB moved, collective GB, bound and argument GB, and
the card's peak allocated / reserved GB above the baseline and step
ms, or the allocation that ran out of memory.  ``--kind`` keeps the
serving or the train cells only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.launch.dryrun import all_cells, mesh_tag  # noqa: E402


def _g(x: float) -> str:
    return f"{x:.4g}"


def _load(d: str, arch: str, shape: str, mp: bool):
    path = os.path.join(d, f"{arch}__{shape}__{mesh_tag(mp)}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _mesh(rec) -> str:
    m = rec["rank_mesh"]
    return "×".join(str(m[a]) for a in ("pod", "data", "model") if a in m)


def _counts(rec):
    if rec is None:
        return ["(no record)"] * 5
    if "unsupported" in rec:
        return [f"unsupported: {rec['unsupported']}"] + [""] * 4
    r = rec["roofline"]
    return [_g(rec["traced"]["flops"] / 1e12),
            _g(rec["traced"]["bytes"] / 1e9),
            _g(r["collective_bytes_per_chip"] / 1e9), r["bottleneck"],
            _g(rec["memory"]["argument_bytes"] / 1e9)]


def _card(rec) -> str:
    if rec is None:
        return "not measured"
    m = rec["memory"]
    if m.get("fits_hbm_measured") is False:
        return f"OOM ({m.get('out_of_memory', '')[:60]})"
    return (f"{m['peak_bytes_per_device'] / 1e9:.3g} / "
            f"{m['peak_reserved_bytes'] / 1e9:.3g} GB, "
            f"{rec['step_ms']:.4g} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("meta")
    ap.add_argument("--card")
    ap.add_argument("--kind", choices=("serving", "train"))
    args = ap.parse_args(argv)
    for arch, shape, mp in all_cells():
        kind = "train" if SHAPES[shape].kind == "train" else "serving"
        if mp or (args.kind and kind != args.kind):
            continue
        one, pod = (_load(args.meta, arch, shape, m) for m in (False, True))
        card = _load(args.card, arch, shape, False) if args.card else None
        lay = (f"{one['layout']} {_mesh(one)}, "
               f"b={one['batch_local']['tokens'][0]}" if one else "")
        mem = one["memory"] if one else {}
        analytic = mem.get("analytic_bytes_per_device")
        fits = "yes" if mem.get("fits_hbm_analytic") else "no"
        ana = f"{analytic / 1e9:.3g} ({fits})" if analytic else ""
        play = (f"{pod['layout']} {_mesh(pod)}, "
                f"b={pod['batch_local']['tokens'][0]}" if pod else "")
        row = ([arch, shape, lay] + _counts(one) + [ana, play]
               + _counts(pod) + [_card(card)])
        print("| " + " | ".join(row) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
