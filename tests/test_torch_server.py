"""The port's async front door, mirroring ``tests/test_server.py``:
stream-against-batch identity (greedy and sampled), the open-loop
Poisson smoke, incremental yields, no decode starvation under a long
arrival, shedding at admission, and the chunk auto-tuner — each held to
the rule the JAX test holds (bit-identical streams, exact counters).
One more test runs the JAX server and the port's side by side on the
same workload, the port's engine teacher-forced by the JAX choices (the
harness of ``test_torch_prefix.py``): the same streams, and the port's
own greedy choices within the margin rule.

No pytest-asyncio: each test wraps its coroutine in ``asyncio.run``
with a ``wait_for`` bound, so a wedged server loop fails instead of
hanging.
"""

import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import engine as JE  # noqa: E402
from repro.serving.server import AsyncServer as JServer  # noqa: E402
from repro_torch.launch.serve_async import poisson_open_loop  # noqa: E402
from repro_torch.serving.engine import PagedEngine, Request  # noqa: E402
from repro_torch.serving.server import (AsyncServer,  # noqa: E402
                                        ChunkAutoTuner)
from test_torch_prefix import (Forced, check_choices, model,  # noqa: E402,F401
                               recording)

TIMEOUT_S = 300


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=TIMEOUT_S))


def _engine(model, **kw):
    _, cfg, _, params = model
    kw.setdefault("page_size", 4)
    kw.setdefault("num_pages", 64)
    kw.setdefault("max_prefill_chunk", 8)
    return PagedEngine(cfg, params, device="cpu", **kw)


def _prompts(model, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, model[1].vocab_size, n).astype(np.int32)
            for n in lens]


async def _serve_all(srv, prompts, temps, n):
    """Submit every request before the loop's first round (``submit``
    never yields), then drain each stream."""
    async with srv:
        streams = [await srv.submit(p, max_new_tokens=n, temperature=t,
                                    req_id=i)
                   for i, (p, t) in enumerate(zip(prompts, temps))]
        return [await s.drain() for s in streams], srv.stats


def test_streams_bit_identical_to_batch_run(model):
    """For the same requests the server's round-at-a-time loop streams
    exactly what a closed-loop ``engine.run()`` produces, greedy and
    sampled (the backlog cap is lifted, so the dispatch schedule — and
    with it the seed stream — is the batch run's)."""
    prompts = _prompts(model, (6, 18, 11, 6), 0)
    temps = [0.0, 0.0, 0.8, 0.8]
    ref = _engine(model, prefix_cache=True)
    for i, (p, t) in enumerate(zip(prompts, temps)):
        ref.submit(Request(i, p, max_new_tokens=6, temperature=t))
    expected = ref.run()
    srv = AsyncServer(_engine(model, prefix_cache=True),
                      admit_backlog_chunks=float("inf"))
    outs, stats = _run(_serve_all(srv, prompts, temps, 6))
    assert outs == [expected[i] for i in range(len(prompts))]
    assert stats["completed"] == len(prompts) and stats["rejected"] == 0


def test_server_streams_match_jax_server(model):
    """The JAX server and the port's on one workload (a shared system
    prompt, so the second wave hits the prefix cache): the port's engine
    takes every choice from the JAX record of the same seed, and the
    streams, the prefix counters and the launches by kind must equal the
    JAX server's; the port's own greedy choices obey the margin rule."""
    jcfg, cfg, jparams, params = model
    sys_prompt = _prompts(model, (12,), 1)[0]
    tails = _prompts(model, (3, 5, 7), 2)
    prompts = [np.concatenate([sys_prompt, t]) for t in tails]
    kw = dict(page_size=4, num_pages=64, max_prefill_chunk=8,
              prefix_cache=True)

    async def wave(srv, ids):
        streams = [await srv.submit(prompts[i], max_new_tokens=5,
                                    temperature=0.0, req_id=i) for i in ids]
        return [await s.drain() for s in streams]

    async def go(engine, cls):
        # request 0 commits the system prompt before the others arrive
        async with cls(engine, admit_backlog_chunks=float("inf")) as srv:
            return await wave(srv, [0]) + await wave(srv, [1, 2])

    with recording() as calls:
        jeng = JE.PagedEngine(jcfg, jparams, use_pallas=False, **kw)
        jouts = _run(go(jeng, JServer))
    eng = Forced(cfg, params, device="cpu", ref_calls=calls, **kw)
    outs = _run(go(eng, AsyncServer))
    assert outs == jouts and len(outs) == 3
    for k in ("prefix_hits", "prefix_hit_tokens", "prefix_evictions"):
        assert eng.stats[k] == jeng.stats[k], k
    assert eng.stats["prefix_hits"] == 2
    nz = {k: v for k, v in jeng.cache.queue.launches_by_kind.items() if v}
    assert {k: v for k, v in eng.cache.queue.launches_by_kind.items()
            if v} == nz
    assert check_choices(eng, calls) >= 1


def test_poisson_open_loop_matches_batch_engine(model):
    """A short Poisson trace: whatever rounds the arrivals landed in,
    greedy streams equal the batch engine's on the same prompts, and
    every stream's timing marks are complete."""
    prompts = _prompts(model, (10,) * 6, 3)

    async def go():
        async with AsyncServer(_engine(model)) as srv:
            return await poisson_open_loop(srv, prompts, rate_rps=200.0,
                                           max_new_tokens=4)

    res = _run(go())
    assert res["completed"] == len(prompts) and res["rejected"] == 0
    ref = _engine(model)
    for i, p in enumerate(prompts):
        ref.submit(Request(i, p, max_new_tokens=4, temperature=0.0))
    expected = ref.run()
    for s in res["streams"]:
        assert s.tokens == expected[s.req_id]
        assert s.ttft_ms is not None and s.e2e_ms is not None
        assert len(s.token_ms) == len(s.tokens)
        assert all(g >= 0 for g in s.itl_ms())


def test_stream_yields_incrementally(model):
    """``async for`` sees tokens one round at a time; the stream ends
    exactly at the request's budget."""
    prompt = _prompts(model, (6,), 4)[0]

    async def go():
        async with AsyncServer(_engine(model)) as srv:
            s = await srv.submit(prompt, max_new_tokens=5)
            seen = []
            async for tok in s:
                seen.append(tok)
                assert seen == s.tokens[:len(seen)]
            return seen, s

    seen, s = _run(go())
    assert seen == s.tokens and len(seen) == 5


def test_open_loop_long_prefill_never_stalls_decode(model):
    """A decoding request is mid-stream when a 4-chunk prompt arrives:
    the chunked scheduler slices the newcomer across rounds, so the
    incumbent emits every round (``decode_stall_rounds`` 0 in the
    engine, ``max_round_gap`` 0 in the server)."""
    short_p, long_p = _prompts(model, (6, 32), 5)
    eng = _engine(model, max_prefill_chunk=8)

    async def go():
        async with AsyncServer(eng) as srv:
            short = await srv.submit(short_p, max_new_tokens=12)
            got = 0
            async for _ in short:          # wait until it is decoding
                got += 1
                if got >= 2:
                    break
            long = await srv.submit(long_p, max_new_tokens=4)
            return await short.drain(), await long.drain(), srv.stats

    short_toks, long_toks, stats = _run(go())
    assert len(short_toks) == 12 and len(long_toks) == 4
    assert eng.stats["decode_stall_rounds"] == 0
    assert stats["max_round_gap"] == 0


def test_infeasible_deadlines_shed_at_admission(model):
    """Once a round-time EWMA exists, a request whose first-token or
    completion deadline cannot be met is rejected with an empty stream;
    feasible traffic is unaffected."""
    prompt = _prompts(model, (6,), 6)[0]

    async def go():
        async with AsyncServer(_engine(model)) as srv:
            warm = await srv.submit(prompt, max_new_tokens=2)
            await warm.drain()
            assert srv.round_ms_ewma is not None
            tight = await srv.submit(prompt, max_new_tokens=2,
                                     ttft_slo_ms=0.0)
            slow = await srv.submit(prompt, max_new_tokens=512,
                                    deadline_ms=1e-3)
            ok = await srv.submit(prompt, max_new_tokens=2)
            return (await tight.drain(), tight, await slow.drain(), slow,
                    await ok.drain(), srv.stats)

    t_toks, tight, s_toks, slow, ok_toks, stats = _run(go())
    assert tight.rejected and tight.reject_reason == "ttft_slo"
    assert slow.rejected and slow.reject_reason == "deadline"
    assert t_toks == [] and s_toks == []
    assert len(ok_toks) == 2
    assert stats["rejected"] == 2 and stats["completed"] == 2


def test_tuner_requires_chunked_engine(model):
    eng = _engine(model, max_prefill_chunk=None)
    with pytest.raises(ValueError):
        ChunkAutoTuner(eng, target_p99_ms=10.0)
    with pytest.raises(ValueError):
        eng.set_prefill_chunk(16)


def test_tuner_halves_over_target_doubles_under_with_backlog(model):
    eng = _engine(model, max_prefill_chunk=64)
    tuner = ChunkAutoTuner(eng, target_p99_ms=10.0, window=4, min_chunk=8,
                           max_chunk=128)
    for _ in range(4):                    # p99 over target: halve
        tuner.observe(100.0, decoded=True, backlog_tokens=0)
    assert eng.max_prefill_chunk == 32
    for _ in range(4):
        tuner.observe(100.0, decoded=True, backlog_tokens=0)
    assert eng.max_prefill_chunk == 16
    for _ in range(4):                    # fast, no backlog: no change
        tuner.observe(1.0, decoded=True, backlog_tokens=0)
    assert eng.max_prefill_chunk == 16
    for _ in range(4):                    # fast with backlog: double
        tuner.observe(1.0, decoded=True, backlog_tokens=1000)
    assert eng.max_prefill_chunk == 32
    for _ in range(12):                   # floor at min_chunk
        tuner.observe(100.0, decoded=True, backlog_tokens=0)
    assert eng.max_prefill_chunk == 8
    before = len(tuner.history)
    for _ in range(8):                    # prefill-only rounds: ignored
        tuner.observe(100.0, decoded=False, backlog_tokens=0)
    assert len(tuner.history) == before
    assert all(h["p99_ms"] > 0 for h in tuner.history)
