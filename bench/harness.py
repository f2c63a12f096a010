"""One run of one cell: set up, warm up, measure, drain, judge.

``run(cell, ...)`` builds the cell from its files (``bench/configs``,
``bench/traffic``, ``bench/limits``), drives the program through the
mix's loop, reads every metric the cell reports through its reader in
``bench/metrics/<name>.py``, checks the served tokens against the plain
reference, and returns the result line as a dict.

The loops:

* closed (``batch-sampled``): ``clients`` requests in flight; each
  engine call is one round, or, with nothing to admit, up to the
  engine's K-block of rounds; a client whose request finished sends its
  next one before the next call;
* open (``chat-*``): the async front door; each request is submitted at
  its due time on the event loop (late by whatever the engine's round
  holds it), and timed from that due time.

The loop runs ``warmup_seconds`` before the window opens, so every graph
key the traffic meets often is captured and the loop is at its steady
occupancy; the window then runs ``--seconds``; the window's requests are
drained (a minute at most), the prefix cache cleared, and the arenas
read back for zeros.  The reference then judges a sample of the window's
greedy requests and one of its sampled requests.  With ``--trace 1`` a
slice of the window is profiled: its last ``TRACE_SECONDS``, so that the
profiler's stop falls after the window has closed.

A cell whose ``chips`` is above 1 runs in rank mode
(:func:`run_on_ranks`): one process a card, each building the engine
tensor-parallel over a ``model`` axis of ``chips`` ranks and running the
same closed loop.  Rank 0 owns the clock: at each engine call it sends
the others the phase word (go on, the window opens, stop) for the call
after, over a CPU ``gloo`` group and without waiting (:class:`Ahead`),
so every rank submits the same requests and makes the same calls.
Rank 0 also owns the trace (its card's) and the result line, and judges
alone unless the family draws each rank's share of the weights
(``model.draws_shares``): then every rank computes the reference with
it.  The readers divide by ``chips`` cards' peaks.  An open mix is
refused there: the program's front door runs its own engine loop and
knows nothing of ranks.
"""

from __future__ import annotations

import asyncio
import gc
import hashlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bench import counts, guard, model as model_mod, reference, system
from bench import traffic, weights as weights_mod
from bench.model import SOLO, Ranks
from bench.trace import Slice

BENCH = Path(__file__).resolve().parent
DRAIN_SECONDS = 60.0
# the set-up request's id, apart from the traffic's (0, 1, 2, ...)
PREWARM_ID = 1 << 40
TRACE_SECONDS = 2.0
# the reference's samples, one of greedy and one of sampled requests:
# the longest, then others drawn from the seed until this many served
# tokens (or SAMPLE_MAX requests)
SAMPLE_TOKENS = 400
SAMPLE_MAX = 6
# the numbers compared with the reference, each against its limit in
# ``bench/limits/<cell>.json``
READINGS = ("served_logit_gap", "sampled_nll_z", "sampled_pit_ks")
# counters of the step cache's misses (first uses of a shape key)
MISS_KEYS = ("jit_traces", "block_jit_traces", "prefill_jit_traces",
             "mixed_jit_traces")
# the page, state and scan kernels of the cache and its op queue
PIM_KERNELS = ("kv_scatter", "page_copy_batched", "page_init_batched",
               "page_bitwise_batched", "page_not_batched", "page_zero_scan",
               "state_scatter")
# rank mode: the phase word rank 0 sends a call ahead, and the ranks'
# time limit (a checkout's first run builds the kernels)
GO, OPEN, STOP = 0, 1, 2
RANKS_TIMEOUT = 1150.0


def now_ms() -> float:
    return time.perf_counter() * 1e3


def span(name: str):
    """A profiler span around one of the harness's calls into the
    program (free when no profiler runs)."""
    return torch.profiler.record_function("bench." + name)


# ----------------------------- records --------------------------------- #


@dataclass
class Live:
    """One request as the harness follows it."""
    rid: int
    spec: traffic.Spec
    req: object                       # the program's Request
    due_ms: float
    submit_ms: float = 0.0
    engine_ms: Optional[float] = None  # handed to the engine
    stream: object = None             # open loop: its TokenStream
    token_ms: List[float] = field(default_factory=list)
    done_ms: Optional[float] = None
    in_window: bool = False
    pf_pos: int = 0                   # prompt tokens committed (modelled)
    hit: int = 0                      # prompt tokens from the prefix cache

    @property
    def prompt_len(self) -> int:
        return len(self.spec.prompt)


@dataclass
class Call:
    """One engine call (``PagedEngine.run``) and the work it did."""
    t0: float
    t1: float
    stats0: Dict
    stats1: Dict
    launches0: Dict
    launches1: Dict
    contexts: List[int]               # decode rows' key counts
    chunks: List[Tuple[int, int]]     # prefill chunks as (q, prefix)
    first_tokens: int

    def d(self, key: str) -> float:
        return self.stats1[key] - self.stats0[key]

    @property
    def steps(self) -> int:
        """Device steps: decode rounds (a mixed round is one) and chunk
        steps that decoded nothing."""
        return int(self.d("decode_rounds") + self.d("fused_prefill_dispatches"))

    def work(self, m) -> counts.Work:
        return counts.call(m, self.steps, self.contexts, self.chunks,
                           self.first_tokens)


class Recorder:
    """Wraps the engine's ``submit`` and ``run`` (on the instance, so the
    async front door's calls pass through too) to log each call's work:
    the decode rows' contexts from the tokens each request gained, and
    the prefill chunks from the backlog counter, assigned to the
    requests in the order they reached the engine."""

    def __init__(self, eng, on_call: Callable[["Call"], None]):
        self.eng = eng
        self.on_call = on_call
        self.live: Dict[int, Live] = {}
        self.order: List[Live] = []          # prefill FIFO
        self.new: List[Live] = []            # not yet seen by a call
        self.calls: List[Call] = []
        self._submit, self._run = eng.submit, eng.run
        eng.submit = self.submit
        eng.run = self.run

    def track(self, live: Live) -> None:
        self.live[live.rid] = live

    def submit(self, req) -> None:
        live = self.live[req.req_id]
        live.engine_ms = now_ms()
        self.order.append(live)
        self.new.append(live)
        self._submit(req)

    def run(self, max_rounds: int = 1000):
        eng = self.eng
        s0 = dict(eng.stats)
        l0 = system.launches()
        b0 = eng.prefill_backlog_tokens()
        fresh, self.new = self.new, []
        n0 = {rid: len(lv.req.out_tokens) for rid, lv in self.live.items()
              if lv.req is not None}
        t0 = now_ms()
        with span("engine_run"):
            out = self._run(max_rounds)
        t1 = now_ms()
        s1 = dict(eng.stats)
        hit = s1["prefix_hit_tokens"] - s0["prefix_hit_tokens"]
        for lv in fresh:                     # hits land at admission
            if hit <= 0:
                break
            take = min(hit, lv.spec.shared)
            lv.hit = lv.pf_pos = take
            hit -= take
        done = b0 - eng.prefill_backlog_tokens() - (
            s1["prefix_hit_tokens"] - s0["prefix_hit_tokens"])
        chunks = []
        for lv in self.order:
            if done <= 0:
                break
            q = min(done, lv.prompt_len - lv.pf_pos)
            if q > 0:
                chunks.append((q, lv.pf_pos))
                lv.pf_pos += q
                done -= q
        self.order = [lv for lv in self.order if lv.pf_pos < lv.prompt_len]
        contexts, first = [], 0
        for rid, lv in list(self.live.items()):
            if lv.req is None:
                continue
            n1 = len(lv.req.out_tokens)
            for j in range(n0.get(rid, 0) + 1, n1 + 1):
                if j == 1:
                    first += 1
                else:
                    contexts.append(lv.prompt_len + j - 1)
                lv.token_ms.append(t1)
            if lv.req.done and lv.done_ms is None:
                lv.done_ms = t1
                del self.live[rid]
        call = Call(t0, t1, s0, s1, l0, system.launches(), contexts, chunks,
                    first)
        self.calls.append(call)
        self.on_call(call)
        return out


# ------------------------------ window --------------------------------- #


class Window:
    """What the metric readers read (``bench/metrics/<name>.py``: a
    ``read(w)`` returning a number, or None where it finds nothing)."""

    def __init__(self, m, kind: str, calls: List[Call],
                 requests: List[Live], seconds: float, setup_s: float,
                 missing_ms: float, sl: Optional[Slice],
                 slice_calls: List[Call], chips: int = 1):
        self.model = m
        # the cards that share the work (the slice is rank 0's card)
        self.chips = chips
        self.kind = kind
        self.calls = calls
        self.requests = requests
        self.seconds = seconds
        self.setup_s = setup_s
        self.missing_ms = missing_ms
        self.slice = sl
        self.slice_calls = slice_calls

    def d(self, key: str) -> float:
        """A counter of ``PagedEngine.stats`` over the window's calls."""
        if not self.calls:
            return 0.0
        return self.calls[-1].stats1[key] - self.calls[0].stats0[key]

    def launches(self, key: str) -> int:
        if not self.calls:
            return 0
        return self.calls[-1].launches1[key] - self.calls[0].launches0[key]

    def tokens(self) -> int:
        """Output tokens emitted by the window's calls."""
        return sum(len(c.contexts) + c.first_tokens for c in self.calls)


def percentile(values: List[float], q: float) -> Optional[float]:
    return float(np.percentile(values, q)) if values else None


def load_metric(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a cell reports: with ``trace`` its per-layer metrics,
    else its end-to-end ones (a metric without ``workloads`` in every
    cell that reports what it moves, or every cell)."""
    e2e = [x for x in bench["end_to_end"]
           if "workloads" not in x or cell in x["workloads"]]
    if not trace:
        return e2e
    moved = {x["name"] for x in e2e}
    return [x for x in bench["per_layer"]
            if (cell in x["workloads"] if "workloads" in x
                else x["moves"] in moved)]


# ------------------------------- loops --------------------------------- #


class Run:
    """The state of one run (built by :func:`run`)."""

    def __init__(self, m, w, mix, seed: int, seconds: float, trace: bool,
                 device, engine_kw: Dict, ranks: Ranks = SOLO, mesh=None):
        self.m, self.w, self.mix = m, w, mix
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.ranks = ranks
        self.device = torch.device(device)
        self.eng = system.engine(m, w, seed, self.device, mesh=mesh,
                                 ranks=ranks, **engine_kw)
        self._prewarm()
        self.rec = Recorder(self.eng, self._on_call)
        self.stream = traffic.requests(mix, seed, m.vocab)
        self.lives: List[Live] = []
        self.window_t0: Optional[float] = None
        self.window_t1: Optional[float] = None
        self.prof = None
        self.slice_span = None
        self.slice_calls: List[Call] = []
        self.profiled = False
        self.drain_s = DRAIN_SECONDS
        if trace:
            # the profiler's first start initialises its tracer: do it in
            # set-up, not inside the window
            with self._profiler():
                torch.ones(1, device=self.device).add_(1)
                self._sync()

    def _prewarm(self) -> None:
        """One sampled request to its end before anything is timed: the
        program builds its kernels on their first use (on a checkout's
        first run), and that build belongs to set-up, not to the warm-up
        or the window."""
        rng = np.random.default_rng([self.seed, 3])
        n = min(300, self.m.engine["max_prefill_chunk"] + 44)
        self.eng.submit(system.request(
            PREWARM_ID, rng.integers(0, self.m.vocab, n, dtype=np.int32), 16,
            1.0))
        self.eng.run()
        self._sync()

    def _profiler(self):
        return torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])

    # -- profiling a slice of the window, at call boundaries ------------ #

    def _on_call(self, call: Call) -> None:
        if not self.trace or self.window_t0 is None or self.profiled:
            return
        start = self.window_t0 + max(0.0, self.seconds - TRACE_SECONDS) * 1e3
        if self.prof is None and call.t1 >= start:
            self._sync()
            self.prof = self._profiler()
            self.prof.__enter__()
            self.slice_span = span("slice")
            self.slice_span.__enter__()
            self.slice_from = len(self.rec.calls)

    def stop_trace(self) -> None:
        """End the profiled slice (at the window's close at the latest)."""
        if self.prof is None or self.profiled:
            return
        self._sync()
        self.slice_span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.slice_calls = self.rec.calls[self.slice_from:]
        self.profiled = True

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _new(self, due_ms: float) -> Live:
        spec = next(self.stream)
        lv = Live(rid=spec.index, spec=spec, req=None, due_ms=due_ms)
        self.lives.append(lv)
        return lv

    # -- closed loop ------------------------------------------------------ #

    def closed(self) -> None:
        eng, K = self.eng, self.eng.decode_block_rounds

        def send() -> None:
            lv = self._new(now_ms())
            lv.req = system.request(lv.rid, lv.spec.prompt, lv.spec.max_new,
                                    lv.spec.temperature)
            lv.submit_ms = lv.due_ms
            self.rec.track(lv)
            with span("submit"):
                eng.submit(lv.req)

        def phase(t: float) -> int:
            if self.window_t0 is None and t >= warm_end:
                return OPEN
            if (self.window_t0 is not None
                    and t >= self.window_t0 + self.seconds * 1e3):
                return STOP
            return GO

        for _ in range(self.mix["clients"]):
            send()
        warm_end = now_ms() + self.mix["warmup_seconds"] * 1e3
        ahead = Ahead(self.ranks) if self.ranks.world > 1 else None
        while True:
            t = now_ms()
            # in rank mode, rank 0's word for this call, sent a call ago
            word = phase(t) if ahead is None else ahead.take()
            if word == OPEN:
                self.window_t0 = t
            elif word == STOP:
                self.window_t1 = t
                self.stop_trace()
                break
            if ahead is not None:
                ahead.send(phase(t))
            rounds = K if eng.prefill_backlog_tokens() == 0 else 1
            finished = eng.run(max_rounds=rounds)
            for _ in finished:
                send()

    # -- open loop -------------------------------------------------------- #

    async def _open(self) -> None:
        srv = system.server(self.m, self.eng)
        srv.start()
        warm = self.mix["warmup_seconds"] * 1e3
        t_base = now_ms()
        self.window_t0 = None
        w0, w1 = t_base + warm, t_base + warm + self.seconds * 1e3
        due = t_base
        window: List[Live] = []
        while True:
            lv = self._new(0.0)
            due += lv.spec.gap_s * 1e3
            if due >= w1:
                self.lives.pop()
                break
            lv.due_ms = due
            wait = due - now_ms()
            if wait > 0:
                await asyncio.sleep(wait / 1e3)
            if self.window_t0 is None and due >= w0:
                self.window_t0 = w0
            lv.in_window = due >= w0
            self.rec.track(lv)
            with span("submit"):
                lv.stream = await srv.submit(
                    lv.spec.prompt, max_new_tokens=lv.spec.max_new,
                    temperature=lv.spec.temperature, req_id=lv.rid)
            lv.req = lv.stream.req
            lv.submit_ms = lv.stream.submitted_ms
            if lv.in_window:
                window.append(lv)
        wait = w1 - now_ms()
        if wait > 0:
            await asyncio.sleep(wait / 1e3)
        self.window_t0 = w0
        self.window_t1 = w1
        self.stop_trace()
        deadline = now_ms() + self.drain_s * 1e3
        while (any(lv.stream.finished_ms is None for lv in window)
               and now_ms() < deadline):
            await asyncio.sleep(0.005)
        try:
            await asyncio.wait_for(srv.close(),
                                   max(1.0, (deadline - now_ms()) / 1e3))
        except asyncio.TimeoutError:
            pass

    def open(self) -> None:
        asyncio.run(self._open())

    # -- after the window ------------------------------------------------- #

    def window_calls(self) -> List[Call]:
        return [c for c in self.rec.calls
                if c.t0 >= self.window_t0 and c.t1 <= self.window_t1]

    def window_requests(self) -> List[Live]:
        if self.mix["loop"] == "open":
            return [lv for lv in self.lives if lv.in_window]
        # closed: the requests that finished inside the window
        t0, t1 = self.window_t0, self.window_t1
        return [lv for lv in self.lives
                if lv.done_ms is not None and t0 <= lv.done_ms <= t1]


def finished(lv: Live) -> bool:
    if lv.stream is not None:
        return lv.stream.finished_ms is not None and not lv.stream.rejected
    return lv.done_ms is not None


def sample(lives: List[Live], seed: int, greedy: bool) -> List[Live]:
    """The greedy (or the sampled) requests the reference judges: the
    longest, then others drawn from the seed."""
    pool = [lv for lv in lives
            if (lv.spec.temperature == 0.0) == greedy and finished(lv)]
    if not pool:
        return []
    pool.sort(key=lambda lv: (-(lv.prompt_len + len(lv.req.out_tokens)),
                              lv.rid))
    out, rest = [pool[0]], pool[1:]
    rng = np.random.default_rng([seed, 2 if greedy else 4])
    served = len(pool[0].req.out_tokens)
    for i in rng.permutation(len(rest)):
        if served >= SAMPLE_TOKENS or len(out) >= SAMPLE_MAX:
            break
        out.append(rest[i])
        served += len(rest[i].req.out_tokens)
    return out


def _seqs(chosen: List[Live]):
    return [(list(lv.spec.prompt) + list(lv.req.out_tokens[:-1]),
             lv.prompt_len - 1) for lv in chosen]


def _readings(ref, greedy_tokens, drawn_tokens, seed: int) -> Dict:
    """The numbers compared, for one side's tokens: the greedy rows'
    widest gap, and the two draw statistics of the sampled rows."""
    g, d = len(greedy_tokens), len(drawn_tokens)
    out = {"served_logit_gap": None, "sampled_nll_z": None,
           "sampled_pit_ks": None}
    if g:
        out["served_logit_gap"] = max(
            reference.widest_gap(r, t) for r, t in zip(ref, greedy_tokens))
    if d:
        st = reference.draw_stats(ref[g:], drawn_tokens,
                                  torch.Generator().manual_seed(seed + 5))
        out["sampled_nll_z"] = abs(st["nll_z"])
        out["sampled_pit_ks"] = st["pit_ks"]
        out["signed_nll_z"] = st["nll_z"]
    return out


def _uniforms(rows: List[torch.Tensor], seed: int) -> List[torch.Tensor]:
    gen = torch.Generator().manual_seed(seed % (1 << 62) + 6)
    return [torch.rand(len(r), generator=gen, dtype=torch.float64)
            for r in rows]


def judge(m, w, greedy: List[Live], drawn: List[Live], seed: int,
          control: bool = False, ranks: Ranks = SOLO) -> Dict:
    """The reference over each judged request's prompt and served tokens
    (teacher-forced): the widest gap of a greedy token below the
    reference's best, and how the sampled tokens fall in the reference's
    distributions.  With ``control`` the float8 control takes the
    program's place (its first choice on the greedy rows, its own draw
    on the sampled rows) and these readings are the control's; the
    program's go under ``program``, and under ``faults`` the readings
    of faults planted in the reference's own draw: an argmax choice, a
    uniform draw over the vocabulary, each row drawn from another row's
    distribution, and the inverse-CDF draw at a stuck uniform of 0.5."""
    seqs = _seqs(greedy) + _seqs(drawn)
    served = sum(len(lv.req.out_tokens) for lv in greedy + drawn)
    if not seqs:
        return {"readings": _readings([], [], [], seed),
                "served_tokens": 0}
    ref = reference.logits(m, w, seqs, ranks=ranks)
    toks = [torch.as_tensor(lv.req.out_tokens) for lv in greedy + drawn]
    prog = _readings(ref, toks[:len(greedy)], toks[len(greedy):], seed)
    if not control:
        return {"readings": prog, "served_tokens": served}
    ctl = reference.logits(m, w, seqs, precision="fp8", ranks=ranks)
    g = len(greedy)
    rows = ref[g:]
    u = _uniforms(rows, seed)
    mine = _readings(ref, [c.argmax(-1) for c in ctl[:g]],
                     [reference.draw(c, x) for c, x in zip(ctl[g:], u)],
                     seed)
    flat = torch.cat(rows) if rows else None
    faults = {}
    if rows:
        n = len(flat)
        other = reference.draw(flat.roll(n // 2, 0), torch.cat(u))
        fault_draws = {
            "argmax": [r.argmax(-1) for r in rows],
            "uniform": [torch.randint(
                0, r.shape[-1], (len(r),),
                generator=torch.Generator().manual_seed(seed + 7))
                for r in rows],
            "wrong_row": list(other.split([len(r) for r in rows])),
            "stuck_uniform": [reference.draw(r, torch.full((len(r),), 0.5))
                              for r in rows]}
        faults = {k: _readings(rows, [], v, seed)
                  for k, v in fault_draws.items()}
    return {"readings": mine, "program": prog, "faults": faults,
            "served_tokens": served}


# -------------------------------- run ---------------------------------- #


def load_cell(bench: Dict, name: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def run(bench: Dict, name: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device="cuda", model: Optional[Dict] = None,
        mix: Optional[Dict] = None, limits: Optional[Dict] = None,
        engine_kw: Optional[Dict] = None, control: bool = False,
        ranks: Ranks = SOLO, mesh=None) -> Optional[Dict]:
    """One run of cell ``name``; returns the result line.  ``model``,
    ``mix``, ``limits`` and ``engine_kw`` replace the cell's files (the
    CPU tests run the harness at a small size with them); ``control``
    judges the float8 control in the program's place (see ``judge``).
    In rank mode (``ranks``, ``mesh``: see :func:`run_on_ranks`) every
    rank calls this, and only rank 0 returns the line (the others
    None)."""
    cell = load_cell(bench, name)
    cfg = model or json.loads(
        (BENCH / "configs" / f"{cell['config']}.json").read_text())
    m = model_mod.from_dict(cfg)
    mix = mix or traffic.load(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = limits or json.loads(
        (BENCH / "limits" / f"{name}.json").read_text())
    dev = torch.device(device)
    lead = ranks.rank == 0
    timing = {"start": now_ms() / 1e3 - t_start}
    w = weights_mod.make(m, seed, dev, ranks)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    timing["weights"] = now_ms() / 1e3 - t_start
    r = Run(m, w, mix, seed, seconds, trace and lead, dev, engine_kw or {},
            ranks, mesh)
    timing["engine"] = now_ms() / 1e3 - t_start
    if mix["loop"] == "closed":
        r.closed()
    else:
        r.open()
    timing["window_open"] = r.window_t0 / 1e3 - t_start
    timing["drained"] = now_ms() / 1e3 - t_start
    setup_s = (r.window_t0 / 1e3) - t_start
    wreqs = r.window_requests()
    calls = r.window_calls()
    missing = (now_ms() - r.window_t0) if wreqs else 0.0
    residue = system.arena_residue(r.eng)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    greedy, drawn = sample(wreqs, seed, True), sample(wreqs, seed, False)
    differ = 0
    if ranks.world > 1:
        # every rank's arena share, the fullest card, every rank's
        # token streams against rank 0's, and rank 0's sample
        residue = int(reduce(ranks, residue, "sum"))
        peak = int(reduce(ranks, peak, "max"))
        digests = gather(ranks, streams_digest(r.lives))
        differ = sum(d != digests[0] for d in digests)
        by_rid = {lv.rid: lv for lv in r.lives}
        picked = share(ranks, ([lv.rid for lv in greedy],
                               [lv.rid for lv in drawn]))
        greedy, drawn = ([by_rid[i] for i in ids] for ids in picked)
    if lead:
        sl = Slice.from_profiler(r.prof) if r.profiled else None
        win = Window(m, mix["loop"], calls, wreqs,
                     (r.window_t1 - r.window_t0) / 1e3, setup_s, missing, sl,
                     r.slice_calls, chips=ranks.world)
        metrics = {}
        for spec in cell_metrics(bench, name, trace):
            value = load_metric(spec["name"])(win)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
        unfinished = sum(not finished(lv) for lv in wreqs)
        short = sum(finished(lv) and len(lv.req.out_tokens) != lv.spec.max_new
                    for lv in wreqs)
    del r.rec, r.eng
    r.eng = None
    gc.collect()
    if not (lead or model_mod.draws_shares(m, ranks)):
        # whole weights: rank 0 judges alone
        return None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = now_ms()
    verdict = judge(m, w, greedy, drawn, seed, control=control, ranks=ranks)
    if not lead:
        return None
    timing["reference_s"] = (now_ms() - t_ref) / 1e3
    checks = {k: {"value": verdict["readings"][k], "limit": limits[k]}
              for k in READINGS}
    checks.update({
        "unfinished_requests": {"value": unfinished, "limit": 0},
        "wrong_length_outputs": {"value": short, "limit": 0},
        "arena_nonzero_after_free": {"value": residue, "limit": 0},
    })
    if ranks.world > 1:
        checks["ranks_streams_differ"] = {"value": differ, "limit": 0}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    out = {"correct": correct, "attempted": len(wreqs),
           "failed": unfinished, "metrics": metrics,
           "device": device_info(dev, peak, sl, ranks.world)}
    if sl is not None:
        out["breakdown"] = sl.breakdown()
        out["kernel_names"] = sl.kernel_names()
    out["judged"] = {"greedy_requests": len(greedy),
                     "sampled_requests": len(drawn),
                     "served_tokens": verdict["served_tokens"],
                     "signed_nll_z": verdict["readings"].get("signed_nll_z")}
    if control:
        out["judged"]["program"] = verdict["program"]
        out["judged"]["faults"] = verdict["faults"]
    out["timing"] = timing
    out["slow_calls"] = [
        [round(c.t1 - c.t0, 1), {k: c.d(k) for k in c.stats1
                                 if c.d(k) and k not in ("prefill_seconds",
                                                         "decode_seconds")}]
        for c in sorted(calls, key=lambda c: c.t0 - c.t1)[:4]]
    out["window_calls"] = len(calls)
    out["window_counters"] = {k: win.d(k) for k in (calls[0].stats1 if calls
                                                    else {}) if win.d(k)}
    out["checks"] = checks
    return out


# ------------------------------ rank mode ------------------------------ #


class Ahead:
    """Rank 0's phase word, one engine call ahead: at each call every
    rank takes the word sent at the call before and sends (rank 0) or
    receives (the others) the next call's, a broadcast that completes
    while the call runs.  So no rank waits for another's host at the
    call's start, and every rank still opens and closes the window at
    the same call, one call after rank 0's clock says."""

    def __init__(self, ranks: Ranks):
        self.ranks = ranks
        self.send(GO)

    def send(self, word: int) -> None:
        self.buf = torch.tensor([word], dtype=torch.int64)
        self.work = torch.distributed.broadcast(
            self.buf, 0, group=self.ranks.group, async_op=True)

    def take(self) -> int:
        self.work.wait()
        return int(self.buf[0])


def reduce(ranks: Ranks, value: float, op: str) -> float:
    """``value`` summed (``op`` "sum") or at its largest ("max") over the
    ranks, on every rank."""
    dist = torch.distributed
    buf = torch.tensor([value], dtype=torch.float64)
    kind = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(buf, kind, group=ranks.group)
    return float(buf[0])


def gather(ranks: Ranks, obj) -> List:
    """Every rank's ``obj``, in rank order, on every rank."""
    out = [None] * ranks.world
    torch.distributed.all_gather_object(out, obj, group=ranks.group)
    return out


def share(ranks: Ranks, obj):
    """Rank 0's ``obj``, on every rank."""
    box = [obj]
    torch.distributed.broadcast_object_list(box, 0, group=ranks.group)
    return box[0]


def streams_digest(lives: List[Live]) -> str:
    """One digest of every request's id and served tokens."""
    h = hashlib.sha256()
    for lv in lives:
        if lv.req is not None:
            h.update(np.asarray([lv.rid, *lv.req.out_tokens],
                                dtype=np.int64).tobytes())
    return h.hexdigest()


def _on_rank(rank: int, world: int, kw: Dict) -> Dict:
    """One rank of :func:`run_on_ranks`: its CPU group, its mesh, its
    card, the run; returns rank 0's line and the forbidden modules this
    process holds once its window has closed."""
    group = torch.distributed.new_group(backend="gloo")
    mesh = system.mesh(world)
    kw = dict(kw)
    if kw.pop("device") == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    out = run(**kw, device=dev, ranks=Ranks(rank, world, group), mesh=mesh)
    return {"result": out, "offenders": guard.offenders(sys.modules)}


def run_on_ranks(bench: Dict, name: str, seed: int, seconds: float,
                 trace: bool, *, t_start: float, device="cuda",
                 backend: str = "nccl", mix: Optional[Dict] = None,
                 **kw) -> Tuple[Dict, List[str]]:
    """One run of a cell whose ``chips`` is above 1: ``chips`` ranks
    (the program's ``run_ranks``, over ``backend``: ``nccl`` on the
    cards, ``gloo`` on the CPU), each running :func:`run`; returns rank
    0's line and the forbidden modules any rank held.  ``kw`` as
    :func:`run` takes it."""
    cell = load_cell(bench, name)
    mix = mix or traffic.load(BENCH / "traffic" / f"{cell['traffic']}.json")
    if mix["loop"] != "closed":
        raise ValueError(
            f"{name}: an {mix['loop']} mix on {cell['chips']} chips; the "
            "rank mode runs closed mixes only (the program's AsyncServer "
            "runs its own engine loop and knows nothing of ranks)")
    world = cell["chips"]
    args = dict(kw, bench=bench, name=name, seed=seed, seconds=seconds,
                trace=trace, t_start=t_start, device=device, mix=mix)
    threads = max(1, min(8, (os.cpu_count() or 1) // world))
    outs = system.run_ranks(_on_rank, world, backend=backend, args=(args,),
                            timeout=RANKS_TIMEOUT, threads=threads)
    bad = sorted({b for o in outs for b in o["offenders"]})
    return outs[0]["result"], bad


def device_info(dev: torch.device, peak: int, sl: Optional[Slice],
                chips: int) -> Dict:
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    if sl is not None:
        info["busy_s"] = sl.busy_s
        info["window_s"] = sl.window_s
    return info

