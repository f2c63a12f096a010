"""Trace recording and model-face replay of the port against the JAX
package's (the port's counterpart of ``tests/test_pimolib.py``'s
``TestTraceReplay``).

Cache level: the same scripted ops (prompt writes through the queue, a
CoW fork, single-token appends, the zero scan, frees) on both caches
with ``record_trace=True``.  Engine level: both engines serve the same
workloads on ``reduced(granite-3-8b, num_layers=2)``, the port
teacher-forced by the JAX engine's choices (the harness of
``test_torch_prefix.py``): a radix prefix hit with the zero scan on and a
fork and free of a scripted sequence first, monolithic; the same
chunked with mixed rounds and 4-round decode blocks; and the eager
decode oracle, whose round writes through the queue.  One reduced
mamba2 run (SSD chunk 4, chunked, with a fork and free of a state row)
covers the state events.  Held equal: the traces event for event, and
``replay_on_device`` in every count, total, speedup, device statistic
and receipt (the simulated prototype's nanoseconds, exactly).

Also: ``PagedEngine(lib=TorchLib(...))`` serves as the default engine
does and shares the lib's accounting; a model-face lib, a second arena
owner and a second lib on one queue are refused, as the JAX package
refuses them.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serving.kv_cache import PagedKVCache as JCache  # noqa: E402
from repro.serving.trace import replay_on_device as jreplay  # noqa: E402
from repro_torch.core.pimolib import TorchLib  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache  # noqa: E402
from repro_torch.serving.trace import replay_on_device  # noqa: E402
from test_torch_prefix import build_model, run_both  # noqa: E402


@pytest.fixture(scope="module")
def model():
    return build_model()


def _events(trace):
    return [dataclasses.astuple(e) for e in trace.events]


def _receipt(r):
    return (r.ok, r.op, r.face, r.n_ops, r.latency_ns, r.launches)


def assert_same_trace(trace, jtrace):
    """Event for event, then the replay in every total and receipt."""
    assert _events(trace) == _events(jtrace)
    assert (trace.num_pages, trace.num_slabs, trace.page_size,
            trace.kv_itemsize, trace.num_state_rows) == \
        (jtrace.num_pages, jtrace.num_slabs, jtrace.page_size,
         jtrace.kv_itemsize, jtrace.num_state_rows)
    rep, jrep = replay_on_device(trace), jreplay(jtrace)
    for k in ("counts", "events", "device_stats", "pim_ns", "cpu_ns",
              "speedup"):
        assert rep[k] == jrep[k], k
    assert [_receipt(r) for r in rep["receipts"]] == \
        [_receipt(r) for r in jrep["receipts"]]
    return rep


def _ones(engine_or_cache, n):
    c = getattr(engine_or_cache, "cache", engine_or_cache)
    shape = (c.n_layers, n, c.cfg.num_kv_heads, c.cfg.resolved_head_dim)
    if isinstance(c, PagedKVCache):
        return torch.ones(shape)
    return jnp.ones(shape)


def test_cache_trace_matches_jax(model):
    jcfg, cfg, _, _ = model
    caches = [PagedKVCache(cfg, num_pages=16, page_size=4, num_slabs=2,
                           device="cpu", record_trace=True),
              JCache(jcfg, num_pages=16, page_size=4, num_slabs=2,
                     record_trace=True)]
    for c in caches:
        c.enable_zero_scan()
        seq = c.create(0, 10)               # 2 full pages + a partial tail
        k = _ones(c, 10)
        c.write_prompt_kv(seq, k, k)
        c.fork(0, 1)                        # 1 CoW copy
        tok = _ones(c, 1)[:, 0]
        c.append_token_kv(c.seqs[1], tok, tok)
        c.append_token_kv(c.seqs[0], tok, tok)
        c.scan_zero_pages([0, 5, 7])
        c.free(0)
        c.free(1)
    trace, jtrace = caches[0].trace, caches[1].trace
    counts = trace.counts()
    assert counts["page_copy"] == 1 and counts["kv_write"] == 12
    assert counts["page_zero_scan"] > 0 and counts["page_init"] > 0
    rep = assert_same_trace(trace, jtrace)
    assert rep["speedup"]["init"] > 5
    assert rep["cpu_ns"]["total"] > rep["pim_ns"]["total"]


def _req(rid, prompt, n):
    return lambda cls: cls(rid, prompt, max_new_tokens=n, temperature=0.0)


def _fork_free(engine):
    """Before the waves: the zero scan on, then a scripted sequence with
    prompt KV through the queue, a CoW fork of its partial tail, and the
    free of both."""
    c = engine.cache
    c.enable_zero_scan()
    seq = c.create(900, 6)
    k = _ones(c, 6)
    c.write_prompt_kv(seq, k, k)
    c.fork(900, 901)
    c.free(900)
    c.free(901)


WORKLOADS = {
    "monolithic": dict(page_size=4, num_pages=64, prefix_cache=True),
    "chunked": dict(page_size=4, num_pages=64, prefix_cache=True,
                    max_prefill_chunk=8, mixed_rounds=True,
                    decode_block_rounds=4),
    "eager": dict(page_size=4, num_pages=64, fused=False),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_engine_trace_matches_jax(model, name):
    vocab = model[1].vocab_size
    rng = np.random.default_rng(0)
    p0 = rng.integers(0, vocab, 16).astype(np.int32)
    p1 = p0.copy()
    p1[-4:] = rng.integers(0, vocab, 4)
    p2 = rng.integers(0, vocab, 7).astype(np.int32)
    waves = [[_req(0, p0, 3), _req(2, p2, 5)], [_req(1, p1, 6)]]
    kw = dict(WORKLOADS[name], record_trace=True)
    jeng, jrun, eng, run, _ = run_both(model, waves, setup=_fork_free, **kw)
    assert run["results"] == jrun["results"]
    assert run["deltas"] == jrun["deltas"]
    rep = assert_same_trace(eng.cache.trace, jeng.cache.trace)
    kinds = {e.kind for e in eng.cache.trace.events}
    assert {"page_copy", "page_init", "kv_write"} <= kinds
    if name != "eager":
        assert {"prefix_hit", "page_zero_scan"} <= kinds
        assert rep["speedup"]["prefix"] > 1
    if name == "chunked":
        assert max(e.rounds for e in eng.cache.trace.events) > 1
    # one trace event per flushed kind: every queue flush of a kind is
    # one launch per arena
    q = eng.cache.queue
    for kind in ("page_copy", "page_init"):
        n_events = sum(e.kind == kind for e in eng.cache.trace.events)
        assert q.launches_by_kind[kind] == 2 * n_events, kind


def test_mamba2_trace_records_state_events_as_jax():
    from test_torch_hybrid import model as hybrid_model
    fam_model = hybrid_model("ssm")
    vocab = fam_model[1].vocab_size
    rng = np.random.default_rng(1)
    waves = [[_req(i, rng.integers(0, vocab, n).astype(np.int32), 5)
              for i, n in enumerate((6, 11))]]

    def fork_free(engine):
        c = engine.cache
        c.create(900, 5)
        c.fork(900, 901)
        c.free(900)
        c.free(901)

    jeng, jrun, eng, run, _ = run_both(
        fam_model, waves, setup=fork_free, page_size=4, num_pages=32,
        max_prefill_chunk=8, mixed_rounds=True, decode_block_rounds=4,
        record_trace=True)
    assert run["results"] == jrun["results"]
    rep = assert_same_trace(eng.cache.trace, jeng.cache.trace)
    counts = eng.cache.trace.counts()
    assert counts["ssm_state_write"] > 0
    assert counts["state_copy"] == 1 and counts["state_init"] == 4
    assert rep["speedup"]["state_copy"] > 1


def test_engine_with_caller_lib_matches_default(model):
    from repro_torch.core.pimolib import DeviceLib
    _, cfg, _, params = model
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 9) \
        .astype(np.int32)
    outs = []
    libs = [None, TorchLib(deferred=True, device="cpu")]
    for lib in libs:
        eng = E.PagedEngine(cfg, params, page_size=4, num_pages=64,
                            device="cpu", lib=lib)
        eng.submit(E.Request(0, prompt, max_new_tokens=3, temperature=0.0))
        outs.append(tuple(eng.run()[0]))
        assert eng.cache.queue.launches_by_kind["fused_decode"] >= 1
    assert outs[0] == outs[1]
    assert eng.cache.lib is libs[1] and libs[1].queue.stats["launches"] > 0
    with pytest.raises(RuntimeError):          # a second arena owner
        PagedKVCache(cfg, num_pages=16, page_size=4, device="cpu",
                     lib=libs[1])
    with pytest.raises(ValueError):            # one queue, two libs
        TorchLib(queue=libs[1].queue)
    # a model-face lib is refused, as the JAX cache refuses one
    with pytest.raises(ValueError):
        E.PagedEngine(cfg, params, page_size=4, num_pages=64, device="cpu",
                      lib=DeviceLib.__new__(DeviceLib))


def test_serve_async_prints_replay_speedup(capsys, monkeypatch):
    """The open-loop entry point replays its recorded trace, as the JAX
    script does."""
    from repro_torch.launch import serve_async
    monkeypatch.setattr("sys.argv", [
        "serve_async", "--device", "cpu", "--rates", "64", "--requests",
        "4", "--max-new", "2"])
    serve_async.main()
    out = capsys.readouterr().out
    assert '"replay_speedup"' in out and '"end_to_end"' in out
