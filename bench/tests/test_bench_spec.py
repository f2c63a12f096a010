"""BENCHMARK.json against the contract's form, and every file it names
or the harness finds by name."""

import json
import re

import pytest

from bench.tests.small import BENCH, ROOT, bench_spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def names(spec):
    for c in spec["configs"]:
        yield c["name"]
        yield from c["reduced"]
    for w in spec["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        yield m["name"]


def test_keys():
    spec = bench_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["bench"]
    assert spec["command"] == ["python3", "bench/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024


@pytest.mark.parametrize("name", sorted(set(names(bench_spec(True)))))
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


def test_units_lines_and_metric_keys():
    spec = bench_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert LINE.match(m["layer"]) and m["moves"] in e2e
    for x in spec["configs"] + spec["workloads"]:
        assert LINE.match(x["why"])
    for c in spec["configs"]:
        assert LINE.match(c["source"]) and len(c["reduced"]) <= 16


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    spec = bench_spec()
    for w in spec["workloads"]:
        e2e = [m for m in spec["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in
                   spec["per_layer"])
        assert w["chips"] == 1


def test_every_named_file_is_there():
    spec = bench_spec(pending=True)
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in spec["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    assert not (ROOT / "bench").name.endswith("_torch")
