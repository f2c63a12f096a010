"""The engine's host spans (``repro_torch.serving.spans``) on the CPU.

Every engine path records its spans, nested as the table of
``serving/spans.py`` says, only while a profiler runs; the totals in
``engine.stats`` grow always and equal the recorded spans' durations;
the spans leave token streams, launch counts and the profiler's own
events as they were; and their stamps are on the profiler's clock.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving import graphs, spans  # noqa: E402
from repro_torch.serving.engine import PagedEngine, Request  # noqa: E402

PROFILE = dict(activities=[torch.profiler.ProfilerActivity.CPU])
# the clock's tolerance: a span's stamps against the profiler's events
CLOCK_NS = 100_000
# the round-level spans, whose id is the round index
WRAPPERS = {"engine.run", "engine.prefill", "engine.decode",
            "engine.mixed_round", "engine.block"}


def _params(cfg):
    return init_params(T.model_defs(cfg), torch.Generator().manual_seed(0),
                       "cpu", torch.bfloat16)


def _granite():
    return reduced(ARCHS["granite-3-8b"], num_layers=2)


def _mamba2():
    cfg = reduced(ARCHS["mamba2-1.3b"], num_layers=2)
    return dataclasses.replace(cfg,
                               ssm=dataclasses.replace(cfg.ssm, chunk_size=4))


# path -> (config, engine arguments, prompt length, new tokens)
PATHS = {
    "mixed": (_granite, dict(max_prefill_chunk=8), 13, 6),
    "decode": (_granite, dict(), 9, 4),
    "block": (_granite, dict(decode_block_rounds=4), 9, 7),
    "chunked": (_granite, dict(max_prefill_chunk=8, mixed_rounds=False),
                13, 3),
    "ssm_free_scan": (_mamba2, dict(max_prefill_chunk=8,
                                    decode_block_rounds=4), 10, 5),
}


def _engine(path, n=3, seed=3):
    make, kw, plen, new = PATHS[path]
    cfg = make()
    eng = PagedEngine(cfg, _params(cfg), device="cpu", num_pages=64,
                      seed=seed, **kw)
    if path == "ssm_free_scan":
        eng.cache.enable_zero_scan()
    rng = np.random.default_rng(seed)
    for i in range(n):
        eng.submit(Request(100 + i, rng.integers(0, cfg.vocab_size, plen)
                           .astype(np.int32), max_new_tokens=new,
                           temperature=float(i % 2)))
    return eng


def _profiled_run(eng):
    spans.clear()
    with torch.profiler.profile(**PROFILE) as prof:
        out = eng.run()
    return out, spans.recorded(), prof


def _children(log, parent_name):
    return [s for s in log if s.parent is not None
            and s.parent.name == parent_name]


def _parents(log, name):
    return {s.parent.name for s in log if s.name == name}


# each path: the spans it must record, and (child, parents allowed)
EXPECT = {
    "mixed": ({"engine.mixed_round", "engine.schedule", "engine.admit",
               "engine.reserve", "pim.flush", "engine.operands",
               "engine.launch", "engine.choose", "engine.commit",
               "device.wait", "engine.finish", "kv.free"},
              {"engine.mixed_round": {"engine.prefill"},
               "engine.admit": {"engine.prefill"},
               "device.wait": {"engine.commit", "engine.decode"},
               "kv.free": {"engine.finish"}}),
    "decode": ({"engine.decode", "engine.launch", "device.wait",
                "engine.admit", "engine.commit"},
               {"engine.launch": {"engine.prefill", "engine.decode"},
                "engine.admit": {"engine.prefill"}}),
    "block": ({"engine.block", "engine.launch", "engine.choose",
               "engine.operands", "device.wait", "engine.reserve"},
              {"engine.block": {"engine.decode"},
               "engine.launch": {"engine.prefill", "engine.block",
                                 "engine.decode"}}),
    "chunked": ({"engine.schedule", "engine.launch", "engine.commit",
                 "engine.decode", "device.wait"},
                {"engine.launch": {"engine.prefill", "engine.decode"},
                 "engine.schedule": {"engine.prefill"}}),
    "ssm_free_scan": ({"kv.free", "device.wait", "pim.flush",
                       "engine.mixed_round", "engine.block"},
                      {"kv.free": {"engine.finish"}}),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_each_path_records_its_spans_nested(path):
    eng = _engine(path)
    out, log, _ = _profiled_run(eng)
    assert len(out) == 3
    names = {s.name for s in log}
    want, parents = EXPECT[path]
    assert want <= names, want - names
    assert names <= set(spans.NAMES)
    ids = {id(s) for s in log}
    for s in log:
        assert s.start <= s.end
        if s.name == "engine.run":
            assert s.parent is None and s.id is None
            continue
        # every parent was recorded and holds its child
        assert id(s.parent) in ids, s
        assert s.parent.start <= s.start and s.end <= s.parent.end, s
    for child, allowed in parents.items():
        assert _parents(log, child) <= allowed, (child, _parents(log, child))
    rids = {100, 101, 102}
    assert {s.id for s in log if s.name in ("engine.admit", "kv.free")} \
        == rids
    rounds = {s.id for s in log if s.name in WRAPPERS - {"engine.run"}}
    assert rounds == set(range(1, max(rounds) + 1))
    if path == "mixed":
        for mr in (s for s in log if s.name == "engine.mixed_round"):
            inner = [c for c in _children(log, "engine.mixed_round")
                     if c.parent is mr and c.name == "engine.launch"]
            assert len(inner) == 2          # the chunk half, the decode half
    if path == "block":
        # one launch a round of the block
        blocks = [s for s in log if s.name == "engine.block"]
        launches = [c for c in log if c.name == "engine.launch"
                    and c.parent.name == "engine.block"]
        assert len(launches) >= 2 * len(blocks) > 0
    if path == "ssm_free_scan":
        assert eng.cache.state.rows_in_use == 0
        assert _parents(log, "device.wait") >= {"kv.free"}
    # one decode row's drain to the next launch: a gap each
    assert eng.stats["host_gaps"] > 0 and eng.stats["host_gap_seconds"] > 0


def test_without_a_profiler_the_log_stays_empty_and_totals_grow():
    eng = _engine("mixed")
    assert all(eng.stats[spans.key(n)] == 0.0 for n in spans.NAMES)
    assert eng.stats["host_gaps"] == 0
    # the cache's own stats (held against the JAX cache's) gain no key
    assert not any(k.endswith("_seconds") for k in eng.cache.stats)
    spans.clear()
    eng.run()
    assert spans.recorded() == []
    for name in ("engine.run", "engine.prefill", "engine.mixed_round",
                 "engine.launch", "engine.choose", "device.wait",
                 "kv.free", "pim.flush"):
        assert eng.stats[spans.key(name)] > 0.0, name
    assert eng.stats["host_gaps"] > 0
    assert not eng.tracer.recording and not eng.tracer.stack


def test_totals_equal_the_recorded_spans():
    eng = _engine("block")
    eng.run(max_rounds=1)                    # totals before the profiler
    before = dict(eng.stats)
    _profiled_run(eng)
    log = spans.recorded()
    for name in spans.NAMES:
        got = sum(s.end - s.start for s in log if s.name == name) * 1e-9
        k = spans.key(name)
        assert eng.stats[k] - before[k] == pytest.approx(got, abs=1e-9), k
    for k in ("prefill_seconds", "decode_seconds", "mixed_seconds",
              "first_use_seconds", "capture_seconds"):
        assert k in eng.stats
    assert eng._steps.first_use_seconds == eng.stats["first_use_seconds"]
    assert eng._steps.capture_seconds == eng.stats["capture_seconds"]


def test_step_cache_first_use_and_capture_are_spans(monkeypatch):
    """The capture policy's first use and capture (on the card: eager
    on the side stream, then a graph), stood in for on the CPU."""

    class Graph:
        def __init__(self, step):
            self.step = step

        def replay(self):
            self.step.output = self.step.body(**self.step.inputs)

    def first_use(step):
        time.sleep(0.002)
        return step.body(**step.inputs)

    def capture(step):
        time.sleep(0.003)
        step.graph = Graph(step)
        step.arena_ptrs = step.cache.arena_ptrs()

    class Owner:
        def arenas(self):
            return []

        def body(self, x):
            return x + 1

    monkeypatch.setattr(graphs.Step, "_first_use", first_use)
    monkeypatch.setattr(graphs.Step, "_capture", capture)
    stats = {"jit_traces": 0}
    owner = Owner()
    cache = graphs.StepCache(torch.device("cpu"), capture=False,
                             tracer=spans.Tracer(stats), arenas=owner.arenas)
    cache.capture = True
    step = cache.get("jit_traces", (1,), owner.body, {})
    step.inputs = {"x": torch.zeros(2)}
    spans.clear()
    with torch.profiler.profile(**PROFILE):
        with cache.tracer.run():
            with cache.tracer.launch():
                step()                                  # first use
            for _ in range(2):
                with cache.tracer.launch():
                    out = step()                        # capture, replay
    assert torch.equal(out, torch.ones(2))
    log = spans.recorded()
    for name, attr, floor in (("graphs.first_use", "first_use_seconds",
                               0.002),
                              ("graphs.capture", "capture_seconds", 0.003)):
        (s,) = [s for s in log if s.name == name]
        assert s.parent.name == "engine.launch"
        assert getattr(cache, attr) == stats[attr] >= floor
        assert stats[attr] == pytest.approx((s.end - s.start) * 1e-9)


def test_streams_and_launches_equal_with_the_profiler_on_and_off():
    outs = []
    for on in (False, True):
        eng = _engine("ssm_free_scan", seed=11)
        before = launch_counts()
        if on:
            res, log, _ = _profiled_run(eng)
            assert log
        else:
            res = eng.run()
        delta = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
        outs.append((res, delta, eng.rng_ctr,
                     {k: eng.stats[k] for k in ("tokens_out", "decode_rounds",
                                                "mixed_dispatches",
                                                "multi_round_blocks")}))
    assert outs[0] == outs[1]


def test_spans_add_no_profiler_event():
    """No span is a ``record_function``: the profiler's events (the
    device timeline's included) carry no span's name."""
    eng = _engine("mixed")
    _, log, prof = _profiled_run(eng)
    assert log
    names = {e.name for e in prof.events()}
    assert not names & set(spans.NAMES)


def test_a_profiled_op_inside_a_span_lies_within_its_stamps():
    t = spans.Tracer({})
    x = torch.ones(64)
    spans.clear()
    with torch.profiler.profile(**PROFILE) as prof:
        with t.run():
            for _ in range(5):
                with t.span("engine.commit"):
                    x.add_(1)
    start = prof.profiler.kineto_results.trace_start_ns()
    ops = sorted((start + e.time_range.start * 1e3,
                  start + e.time_range.end * 1e3)
                 for e in prof.events() if e.name == "aten::add_")
    commits = sorted((s.start, s.end) for s in spans.recorded()
                     if s.name == "engine.commit")
    assert len(ops) == len(commits) == 5
    for (os_, oe), (ss, se) in zip(ops, commits):
        assert ss - CLOCK_NS <= os_ <= oe <= se + CLOCK_NS


def test_host_gap_counts_from_the_first_drain_to_the_next_launch():
    stats = {}
    t = spans.Tracer(stats)
    with t.run():
        with t.launch():
            pass
        with t.wait():
            pass
        time.sleep(0.002)
        with t.wait():                  # the card stayed dry since the first
            pass
        time.sleep(0.002)
        with t.launch():
            pass
        with t.launch():                # no drain before it: no gap
            pass
        with t.wait():
            pass
    assert stats["host_gaps"] == 1
    first = stats["host_gap_seconds"]
    assert 0.004 <= first < 0.5
    time.sleep(0.02)                    # between calls: not the engine's
    with t.run():
        with t.launch():
            pass
    assert stats["host_gaps"] == 2
    assert stats["host_gap_seconds"] - first < 0.01
    assert stats["wait_seconds"] > 0 and stats["launch_seconds"] > 0


def test_the_log_keeps_the_newest_spans():
    t = spans.Tracer({})
    spans.clear()
    with torch.profiler.profile(**PROFILE):
        with t.run():
            for i in range(spans.LOG_SPANS + 10):
                with t.span("engine.commit", i):
                    pass
    log = spans.recorded()
    assert len(log) == spans.LOG_SPANS
    assert log[0].id == 11 and log[-1].name == "engine.run"
    spans.clear()
    assert spans.recorded() == []
