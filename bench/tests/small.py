"""The cells at a size the CPU runs in seconds: the same files, with the
widths, depth, vocabulary, arena and traffic cut down, for the tests."""

from __future__ import annotations

import json
import time
from pathlib import Path

from bench import traffic

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def bench_spec(pending: bool = False):
    """BENCHMARK.json; with ``pending`` also the cells measured but not
    yet in it (``bench/pending/*.json``), which the CPU tests run too."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    if pending:
        for f in sorted((BENCH / "pending").glob("*.json")):
            for key, rows in json.loads(f.read_text()).items():
                spec[key] = spec[key] + rows
    return spec


def config(name: str) -> dict:
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    if c["model_type"] == "granite":
        c.update(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                 vocab_size=512)
    else:
        c.update(d_model=128, n_layer=2, vocab_size=512)
        c["ssm_cfg"] = dict(c["ssm_cfg"], d_state=16, headdim=16,
                            chunk_size=16)
    c["engine"] = dict(c["engine"], num_pages=256 if c["model_type"] ==
                       "granite" else 16, max_prefill_chunk=32,
                       decode_block_rounds=4)
    if c["model_type"] == "mamba2":
        c["engine"]["page_size"] = 256
    return c


def mix(name: str) -> dict:
    m = traffic.load(BENCH / "traffic" / f"{name}.json")
    small = dict(m, warmup_seconds=1.0)
    small["prompt"] = dict(m["prompt"], median=24, min=8, max=64)
    small["output"] = dict(m["output"], median=6, min=2, max=12)
    if "max_total" in m:
        small["max_total"] = 200
    if "clients" in m:
        small["clients"] = 4
    if "prefix" in m:
        small["prefix"] = dict(m["prefix"], tokens=32)
    if "rate_rps" in m:
        small["rate_rps"] = 4.0
    small["greedy_every"] = 2
    return small


def run_cell(cell: str, seed: int = 7, seconds: float = 2.0,
             trace: bool = False, limit: float = 1.0, **kw) -> dict:
    """One run of ``cell`` at the small size; ``limit`` is the greedy
    tokens' widest gap (the cell's own is for the full widths)."""
    from bench import harness

    spec = bench_spec(pending=True)
    c = harness.load_cell(spec, cell)
    # the draw statistics are free of scale: the cell's own limits hold
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    return harness.run(spec, cell, seed, seconds, trace,
                       t_start=time.perf_counter(), device="cpu",
                       model=config(c["config"]), mix=mix(c["traffic"]),
                       limits=dict(limits, served_logit_gap=limit), **kw)
