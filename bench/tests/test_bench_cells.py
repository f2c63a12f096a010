"""Every cell end to end on the CPU at a small size (the program's plain
kernel versions), and the shape of the line it prints."""

import json
import subprocess
import sys

import pytest

from bench import harness
from bench.tests.small import ROOT, bench_spec, run_cell

SPEC = bench_spec(pending=True)
CELLS = [w["name"] for w in SPEC["workloads"]]


def check_line(out, cell, trace):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"]: m["unit"] for m in
            harness.cell_metrics(SPEC, cell, trace)}
    assert set(out["metrics"]) <= set(want)
    for name, v in out["metrics"].items():
        assert v["unit"] == want[name] and isinstance(v["value"], float | int)
    assert out["device"]["count"] == 1
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end(cell):
    out = run_cell(cell, seed=2 ** 31 + 101)
    check_line(out, cell, False)
    e2e = {m["name"] for m in harness.cell_metrics(SPEC, cell, False)}
    assert set(out["metrics"]) == e2e


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[2]])
def test_traced_cell_reads_its_counters(cell):
    out = run_cell(cell, seed=9, trace=True)
    check_line(out, cell, True)
    assert "breakdown" in out and out["device"]["window_s"] > 0
    for name in ("decode_batch_mean", "graph_misses", "mfu"):
        assert any(k.startswith(name) for k in out["metrics"]), name


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_run_refuses_without_the_program(tmp_path):
    (tmp_path / "bench").symlink_to(ROOT / "bench")
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
