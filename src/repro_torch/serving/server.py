"""Async continuous-batching front door over :class:`PagedEngine`.

The port's counterpart of the JAX package's ``serving/server.py``: host
asyncio code over the engine's ``step``, ``has_work``,
``prefill_backlog_tokens``, ``set_prefill_chunk``, ``max_prefill_chunk``
and ``stats``, the same in both packages.

``launch/serve.py`` is a closed-loop batch script: it submits everything,
calls ``run()``, and reads the results.  Production traffic is an open
system — requests arrive on their own clock, want their tokens streamed
as they are produced, and carry latency expectations.  This module is
that front door:

* **continuous batching** — one asyncio task owns the engine and calls
  :meth:`PagedEngine.step` (exactly one engine round) in a loop,
  yielding to the event loop between rounds so arrivals join the very
  next round.  The engine's own scheduler keeps its guarantees (chunked
  prefill, decode every round, fused/mixed dispatches); the server adds
  nothing to the hot path but a host-side diff of each request's token
  list;

* **streaming** — :meth:`AsyncServer.submit` returns a
  :class:`TokenStream`, an async iterator that yields each new token id
  the round it is emitted (``async for tok in stream``), with
  TTFT/inter-token timestamps recorded per token;

* **deadlines + SLO-aware admission** — each round's work is split by
  construction: the chunked scheduler caps prefill at
  ``max_prefill_chunk`` tokens and always runs the decode round, so
  admission's job is to keep the *prefill backlog* bounded
  (``admit_backlog_chunks`` × chunk budget).  Requests whose
  first-token / completion deadline cannot be met even if admitted now
  (estimated from the measured round-time EWMA and their queue
  position) are rejected immediately — shedding load early is what
  keeps goodput from collapsing past saturation;

* **chunk auto-tuning** — :class:`ChunkAutoTuner` closes the loop on
  ``max_prefill_chunk``: it watches the p99 of
  measured decode-carrying round times (the inter-token latency a
  decoding request actually experiences) and halves/doubles the chunk
  budget between pow2 bounds to hold a target, via
  :meth:`PagedEngine.set_prefill_chunk`.

Determinism: the server changes *when* work is scheduled, never *what*
a request computes — greedy (temperature-0) streams are bit-identical
to a closed-loop ``engine.run()`` of the same requests, which the tests
pin.

Each ``step`` ends in the engine's device-to-host token transfer, so a
round blocks the event loop while the card works; arrivals and
consumers run between rounds.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import AsyncIterator, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import PagedEngine, Request

_DONE = object()          # stream terminator sentinel


def _now_ms() -> float:
    return time.perf_counter() * 1e3


class TokenStream:
    """Async iterator over one request's generated tokens.

    Yields token ids as the engine emits them; iteration ends when the
    request finishes (EOS / budget) or is rejected by admission control
    (``rejected`` is set and nothing yields).  Timing marks
    (``submitted_ms`` / ``first_token_ms`` / ``finished_ms`` and the
    per-token ``token_ms`` list) are stamped server-side for SLO
    accounting; :meth:`drain` collects the remainder into ``tokens``.
    """

    def __init__(self, req: Request) -> None:
        self.req = req
        self.req_id = req.req_id
        self.tokens: List[int] = []
        self.token_ms: List[float] = []
        self.rejected = False
        self.reject_reason: Optional[str] = None
        self.submitted_ms = _now_ms()
        self.admitted_ms: Optional[float] = None
        self.first_token_ms: Optional[float] = None
        self.finished_ms: Optional[float] = None
        self._q: asyncio.Queue = asyncio.Queue()

    def __aiter__(self) -> AsyncIterator[int]:
        return self

    async def __anext__(self) -> int:
        item = await self._q.get()
        if item is _DONE:
            raise StopAsyncIteration
        return item

    async def drain(self) -> List[int]:
        """Consume the rest of the stream; returns the full token list."""
        async for _ in self:
            pass
        return self.tokens

    # -- server-side publishing ----------------------------------------- #

    def _push(self, toks: Sequence[int], now_ms: float) -> None:
        for t in toks:
            if self.first_token_ms is None:
                self.first_token_ms = now_ms
            self.tokens.append(int(t))
            self.token_ms.append(now_ms)
            self._q.put_nowait(int(t))

    def _finish(self, now_ms: float) -> None:
        self.finished_ms = now_ms
        self._q.put_nowait(_DONE)

    def _reject(self, reason: str, now_ms: float) -> None:
        self.rejected = True
        self.reject_reason = reason
        self.finished_ms = now_ms
        self._q.put_nowait(_DONE)

    # -- derived metrics ------------------------------------------------- #

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_ms is None:
            return None
        return self.first_token_ms - self.submitted_ms

    @property
    def e2e_ms(self) -> Optional[float]:
        if self.finished_ms is None:
            return None
        return self.finished_ms - self.submitted_ms

    def itl_ms(self) -> List[float]:
        """Inter-token gaps (ms) — the decode-latency samples SLO p99s
        are computed over."""
        return [b - a for a, b in zip(self.token_ms, self.token_ms[1:])]


class ChunkAutoTuner:
    """Feedback controller for ``max_prefill_chunk``.

    Every ``window`` decode-carrying rounds, compare the window's p99
    round time (≈ the inter-token latency decoding requests saw) to the
    target: over target → halve the chunk budget (less prefill per
    round, decodes tick faster); under half the target with prefill
    backlogged → double it (spare latency headroom converts to prefill
    throughput).  Moves stay inside [min_chunk, max_chunk] and on pow2
    values, so each budget the tuner visits reuses one compiled
    chunk-length bucket per chunk shape.
    """

    def __init__(self, engine: PagedEngine, target_p99_ms: float, *,
                 min_chunk: int = 8, max_chunk: int = 512,
                 window: int = 16) -> None:
        if engine.max_prefill_chunk is None:
            raise ValueError("auto-tuning needs a chunked engine "
                             "(max_prefill_chunk set at construction)")
        self.engine = engine
        self.target_p99_ms = float(target_p99_ms)
        self.min_chunk = min_chunk
        self.max_chunk = max_chunk
        self.window = window
        self._samples: List[float] = []
        self.history: List[Dict[str, float]] = []

    def observe(self, round_ms: float, *, decoded: bool,
                backlog_tokens: int) -> None:
        if not decoded:
            return
        self._samples.append(round_ms)
        if len(self._samples) < self.window:
            return
        p99 = float(np.percentile(self._samples, 99))
        self._samples.clear()
        chunk = self.engine.max_prefill_chunk
        new = chunk
        if p99 > self.target_p99_ms and chunk > self.min_chunk:
            new = max(self.min_chunk, chunk // 2)
        elif (p99 < 0.5 * self.target_p99_ms and chunk < self.max_chunk
              and backlog_tokens > chunk):
            new = min(self.max_chunk, chunk * 2)
        if new != chunk:
            self.engine.set_prefill_chunk(new)
        self.history.append({"p99_ms": p99, "chunk": float(new)})


@dataclass
class _Waiting:
    stream: TokenStream
    ttft_deadline_ms: Optional[float]      # absolute, server clock
    deadline_ms: Optional[float]           # absolute, server clock


class AsyncServer:
    """The asyncio continuous-batching loop over one ``PagedEngine``.

    Use as an async context manager::

        async with AsyncServer(engine, ttft_slo_ms=200) as srv:
            stream = await srv.submit(prompt, max_new_tokens=32)
            async for tok in stream:
                ...

    Knobs:

    * ``ttft_slo_ms`` — default first-token deadline applied to every
      request (per-request ``deadline_ms`` bounds *completion* time);
      requests that cannot make their deadline are rejected at
      admission (``stream.rejected``).  ``None`` = no shedding.
    * ``admit_backlog_chunks`` — admission stops adding prompts once
      the engine's uncommitted prefill backlog exceeds this many chunk
      budgets (the round's prefill/decode split: prefill is capped at
      one chunk per round by the engine, decode always runs; the
      backlog cap bounds how long an admitted prompt waits for its
      first token).  Ignored without chunked prefill.
    * ``itl_p99_target_ms`` — enables the :class:`ChunkAutoTuner`
      against this decode-p99 target (needs a chunked engine).
    """

    def __init__(self, engine: PagedEngine, *,
                 ttft_slo_ms: Optional[float] = None,
                 admit_backlog_chunks: float = 4.0,
                 itl_p99_target_ms: Optional[float] = None,
                 tune_window: int = 16, min_chunk: int = 8,
                 max_chunk: int = 512, round_ewma: float = 0.25) -> None:
        self.engine = engine
        self.ttft_slo_ms = ttft_slo_ms
        self.admit_backlog_chunks = admit_backlog_chunks
        self.tuner: Optional[ChunkAutoTuner] = None
        if itl_p99_target_ms is not None:
            self.tuner = ChunkAutoTuner(engine, itl_p99_target_ms,
                                        min_chunk=min_chunk,
                                        max_chunk=max_chunk,
                                        window=tune_window)
        self._alpha = round_ewma
        self.round_ms_ewma: Optional[float] = None
        self._waiting: List[_Waiting] = []
        self._live: Dict[int, TokenStream] = {}
        self._gap_rounds: Dict[int, int] = {}
        self._next_id = 0
        self._wake = asyncio.Event()
        self._closing = False
        self._task: Optional[asyncio.Task] = None
        self.stats = {"rounds": 0, "submitted": 0, "admitted": 0,
                      "rejected": 0, "completed": 0, "max_round_gap": 0}

    # ------------------------------ lifecycle -------------------------- #

    async def __aenter__(self) -> "AsyncServer":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def close(self) -> None:
        """Drain in-flight work, then stop the loop."""
        self._closing = True
        self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None

    # ------------------------------ submit ----------------------------- #

    async def submit(self, prompt, *, max_new_tokens: int = 16,
                     temperature: float = 0.0,
                     eos_token_id: Optional[int] = None,
                     deadline_ms: Optional[float] = None,
                     ttft_slo_ms: Optional[float] = None,
                     req_id: Optional[int] = None) -> TokenStream:
        """Enqueue a request; returns its :class:`TokenStream`.

        ``deadline_ms`` / ``ttft_slo_ms`` are relative to now
        (``ttft_slo_ms`` defaults to the server-wide SLO).  The request
        reaches the engine at the next admission pass; if its deadline
        is already infeasible it is rejected there instead
        (``stream.rejected``, empty stream).
        """
        if req_id is None:
            req_id = self._next_id
        self._next_id = max(self._next_id, req_id + 1)
        req = Request(req_id, np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      eos_token_id=eos_token_id)
        stream = TokenStream(req)
        now = stream.submitted_ms
        ttft = ttft_slo_ms if ttft_slo_ms is not None else self.ttft_slo_ms
        self._waiting.append(_Waiting(
            stream,
            ttft_deadline_ms=(now + ttft) if ttft is not None else None,
            deadline_ms=(now + deadline_ms) if deadline_ms is not None
            else None))
        self.stats["submitted"] += 1
        self._wake.set()
        return stream

    # ------------------------------ the loop --------------------------- #

    async def _loop(self) -> None:
        while True:
            self._admit()
            if not self.engine.has_work:
                if self._closing and not self._waiting:
                    return
                if not self._waiting:
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                # waiting but nothing admitted (backlog cap with an
                # empty engine cannot happen; deadline-infeasible were
                # rejected) — admit pass will take them next iteration
                await asyncio.sleep(0)
                continue
            t0 = _now_ms()
            before_toks = self.engine.stats["tokens_out"]
            finished = self.engine.step()
            dt = _now_ms() - t0
            self._observe_round(dt, self.engine.stats["tokens_out"]
                                - before_toks)
            self._publish(finished)
            # let arrivals (and consumers) run before the next round
            await asyncio.sleep(0)

    def _observe_round(self, dt_ms: float, decoded_tokens: int) -> None:
        self.stats["rounds"] += 1
        self.round_ms_ewma = (dt_ms if self.round_ms_ewma is None else
                              self._alpha * dt_ms
                              + (1 - self._alpha) * self.round_ms_ewma)
        if self.tuner is not None:
            self.tuner.observe(dt_ms, decoded=decoded_tokens > 0,
                               backlog_tokens=self.engine
                               .prefill_backlog_tokens())

    # ------------------------------ admission -------------------------- #

    def _est_rounds_to_first_token(self, prompt_len: int) -> float:
        """Rounds until a prompt admitted NOW emits its first token:
        the uncommitted backlog plus this prompt, paid down one chunk
        budget per round (monolithic engines prefill in the next
        round)."""
        chunk = self.engine.max_prefill_chunk
        work = self.engine.prefill_backlog_tokens() + prompt_len
        return float(-(-work // chunk)) if chunk else 1.0

    def _admit(self) -> None:
        """One admission pass over the wait queue (FIFO).

        Feasibility shed: with a measured round time, a request whose
        first-token (or completion) deadline cannot be met even from
        the front of the backlog is rejected now — it would only burn
        chunk budget other requests could meet *their* deadlines with.
        Backlog cap: admission pauses (requests stay queued, order
        kept) while the engine's uncommitted prefill backlog exceeds
        ``admit_backlog_chunks`` chunk budgets.
        """
        still: List[_Waiting] = []
        chunk = self.engine.max_prefill_chunk
        for w in self._waiting:
            now = _now_ms()
            prompt_len = len(w.stream.req.prompt)
            if self.round_ms_ewma is not None and (
                    w.ttft_deadline_ms is not None
                    or w.deadline_ms is not None):
                est = self._est_rounds_to_first_token(prompt_len)
                ttft_eta = now + est * self.round_ms_ewma
                if (w.ttft_deadline_ms is not None
                        and ttft_eta > w.ttft_deadline_ms):
                    w.stream._reject("ttft_slo", now)
                    self.stats["rejected"] += 1
                    continue
                if w.deadline_ms is not None:
                    eta = ttft_eta + ((w.stream.req.max_new_tokens - 1)
                                      * self.round_ms_ewma)
                    if eta > w.deadline_ms:
                        w.stream._reject("deadline", now)
                        self.stats["rejected"] += 1
                        continue
            if (chunk is not None
                    and self.engine.prefill_backlog_tokens() + prompt_len
                    > self.admit_backlog_chunks * chunk
                    and self.engine.has_work):
                still.append(w)          # backlog cap: wait, don't shed
                continue
            w.stream.admitted_ms = now
            self.engine.submit(w.stream.req)
            self._live[w.stream.req_id] = w.stream
            self._gap_rounds[w.stream.req_id] = 0
            self.stats["admitted"] += 1
        self._waiting = still

    # ------------------------------ streaming -------------------------- #

    def _publish(self, finished: Dict[int, List[int]]) -> None:
        """Push tokens emitted this round into their streams (diff of
        each live request's ``out_tokens``) and close finished ones.
        Tracks the longest run of rounds any started request went
        without a token (``stats["max_round_gap"]`` — the chunked
        scheduler's no-starvation guarantee makes this 1)."""
        now = _now_ms()
        for rid, stream in list(self._live.items()):
            new = stream.req.out_tokens[len(stream.tokens):]
            if new:
                stream._push(new, now)
                self._gap_rounds[rid] = 0
            elif stream.tokens and not stream.req.done:
                # a started request went a whole round without a token
                # — the starvation the chunked scheduler exists to
                # prevent (stays 0 when it holds)
                self._gap_rounds[rid] += 1
                self.stats["max_round_gap"] = max(
                    self.stats["max_round_gap"], self._gap_rounds[rid])
            if rid in finished or stream.req.done:
                stream._finish(now)
                del self._live[rid]
                del self._gap_rounds[rid]
                self.stats["completed"] += 1
