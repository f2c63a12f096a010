"""The program's spans over a slice (``bench/spans.py``) and the three
readers that use them or the engine's new totals, on planted slices and
span logs, then through a traced run of a cell at the small size."""

import random
import sys

import pytest
import torch

from bench import harness, spans
from bench.tests.small import bench_spec, run_cell
from bench.trace import Slice

CELLS = ("granite-3-8b.batch-sampled", "mamba2-1.3b.batch-sampled")
READERS = ("mixed_round_ms.batch", "host_gap_ms.batch",
           "engine_idle_share.batch")
BASE = 1_792_000_000_000_000_000        # a wall-clock ns


class S:
    """A planted span (the program's ``Span``'s fields)."""

    def __init__(self, name, start_us, end_us, parent=None, id=None):
        self.name = name
        self.start = BASE + int(start_us * 1e3)
        self.end = BASE + int(end_us * 1e3)
        self.parent = parent
        self.id = id


def planted():
    """A 1000-µs slice: two engine calls, device work in three stretches,
    and the program's spans of each call (calls open and close 3 µs
    outside their ``engine.run``)."""
    device = [("k", 100.0, 300.0), ("k", 500.0, 650.0), ("k", 900.0, 950.0)]
    host = [("bench.slice", 0.0, 1000.0),
            ("bench.engine_run", 47.0, 403.0),
            ("bench.engine_run", 447.0, 803.0)]
    log = []
    for off in (0.0, 400.0):
        run = S("engine.run", 50 + off, 400 + off)
        ops = S("engine.operands", 60 + off, 90 + off, run)
        launch = S("engine.launch", 90 + off, 100 + off, run)
        commit = S("engine.commit", 200 + off, 360 + off, run)
        wait = S("device.wait", 210 + off, 330 + off, commit)
        log += [ops, launch, wait, commit, run]
    return Slice(device, host, 0.0, 1000.0), log


def test_pairs_recover_the_offset_within_a_tenth_of_a_ms():
    sl, log = planted()
    base = spans.base_from_pairs(sl, log)
    assert abs(base - BASE) < 1e5
    # a call held 40 µs longer on one side moves the estimate by half
    sl.host[1] = ("bench.engine_run", 47.0, 443.0)
    assert abs(spans.base_from_pairs(sl, log) - BASE) < 1e5
    sl.host[1] = ("bench.engine_run", 47.0, 403.0)
    # older runs in the log (an earlier slice) are passed over
    old = [S("engine.run", -5000, -4000)]
    assert spans.base_from_pairs(sl, old + log) == base
    assert spans.base_from_pairs(sl, log[:5]) is None


def test_pairs_agree_with_the_trace_start_on_a_real_profile():
    from repro_torch.serving import spans as prog

    t = prog.Tracer({})
    prog.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            with torch.profiler.record_function("bench.engine_run"):
                with t.run():
                    with t.span("engine.commit"):
                        torch.ones(256).add_(1)
    sl = Slice.from_profiler(prof)
    by_trace = spans.base_from_trace_start(
        prof.profiler.kineto_results.trace_start_ns())
    by_pairs = spans.base_from_pairs(sl, prog.recorded())
    assert abs(by_pairs - by_trace) < 1e5          # ns: 0.1 ms


def test_engine_idle_and_the_idle_by_phase():
    sl, log = planted()
    laid = spans.lay(sl, log)
    # idle: [0,100) [300,500) [650,900) [950,1000)
    # inside engine.run: [50,100) [300,400) [450,500) [650,800) -> 350
    assert laid.run_idle_us() == pytest.approx(350.0, abs=0.01)
    # minus device.wait [210,330) and [610,730): 30 + 80 -> 240
    assert laid.engine_idle_us() == pytest.approx(240.0, abs=0.01)
    phases = laid.idle_by_phase()
    want = {"engine.run": 50.0 + 50,         # outside every child span
            "device.wait": 30.0 + 80, "engine.operands": 30.0 + 30,
            "engine.launch": 10.0 + 10, "engine.commit": 30.0 + 30}
    assert set(phases) == set(want)
    for k, v in want.items():
        assert phases[k] == pytest.approx(v, abs=0.01), k
    assert sum(phases.values()) == pytest.approx(laid.run_idle_us())


def test_overlap_with_a_cover_against_brute_force():
    rnd = random.Random(5)
    pts = sorted(rnd.sample(range(1000), 40))
    cover = spans.union(zip(pts[::2], pts[1::2]))
    c = spans.Cover(cover)
    for _ in range(300):
        s, e = sorted(rnd.sample(range(-10, 1010), 2))
        brute = sum(max(0, min(e, b) - max(s, a)) for a, b in cover)
        assert c.overlap(s, e) == pytest.approx(brute)
    assert spans.intersect([(0, 5), (7, 9)], [(3, 8)]) == [(3, 5), (7, 8)]


def _window(stats0, stats1, sl=None):
    call = harness.Call(0.0, 1.0, stats0, stats1, {}, {}, [], [], 0)
    return harness.Window(None, "closed", [call], [], 1.0, 0.0, 0.0, sl, [])


def test_the_counter_readers_and_an_older_program():
    mixed = harness.load_metric("mixed_round_ms.batch")
    gap = harness.load_metric("host_gap_ms.batch")
    s0 = {"mixed_seconds": 1.0, "mixed_dispatches": 10,
          "host_gap_seconds": 0.5, "host_gaps": 7}
    s1 = {"mixed_seconds": 1.6, "mixed_dispatches": 25,
          "host_gap_seconds": 0.8, "host_gaps": 27}
    w = _window(s0, s1)
    assert mixed(w) == pytest.approx(40.0)
    assert gap(w) == pytest.approx(15.0)
    assert mixed(_window(s0, dict(s1, mixed_dispatches=10))) is None
    # a program without the totals: nothing, and no error
    old = {"mixed_dispatches": 3, "decode_seconds": 1.0}
    assert mixed(_window(old, old)) is None and gap(_window(old, old)) is None


def test_the_idle_reader_and_an_older_program(monkeypatch):
    share = harness.load_metric("engine_idle_share.batch")
    sl, log = planted()
    monkeypatch.setattr(spans, "program_spans", lambda: log)
    assert share(_window({}, {}, sl)) == pytest.approx(24.0, abs=0.01)
    assert share(_window({}, {}, None)) is None
    # a slice opened just before the window closed, with no engine call
    bare = Slice([], [("bench.slice", 0.0, 2400.0)], 0.0, 2400.0)
    assert share(_window({}, {}, bare)) == 0.0
    # a log that cannot be aligned with the slice's calls
    monkeypatch.setattr(spans, "program_spans", lambda: log[:5])
    assert share(_window({}, {}, sl)) is None
    # a program without a span log: its module does not import
    monkeypatch.undo()
    import repro_torch.serving

    monkeypatch.delattr(repro_torch.serving, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.serving.spans", None)
    assert spans.program_spans() is None
    assert share(_window({}, {}, sl)) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_three(cell):
    assert all(cell in m["workloads"] for m in bench_spec()["per_layer"]
               if m["name"] in READERS)
    out = run_cell(cell, seed=2 ** 31 + 7, trace=True)
    assert out["correct"] is True, out["checks"]
    got = out["metrics"]
    for name in READERS:
        assert name in got, name
    idle = got["engine_idle_share.batch"]["value"]
    assert 0.0 <= idle <= got["device_idle_share.batch"]["value"]
    assert got["host_gap_ms.batch"]["value"] > 0
