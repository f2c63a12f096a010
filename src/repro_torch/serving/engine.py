"""Continuous-batching serving engine over the paged PiM KV cache.

The port's counterpart of the dense path of the JAX package's
``serving/engine.py``.  Request lifecycle: queue -> prefill (KV written
into arena pages) -> decode rounds (paged attention over block tables,
one token per active sequence per round, new arrivals join between
rounds) -> finish (pages zeroed with RowClone-Init and freed).

Token choice: greedy rows (``temperature == 0``) take the first maximal
logit; sampled rows take a D-RaNGe inverse-CDF draw at their own
temperature, one uniform per row from the ``random_u32`` kernel keyed
by the engine's seed stream (``rng_seed + rng_ctr``, the counter
advancing once per dispatch exactly where the JAX engine advances it,
greedy dispatches included).  An all-greedy batch skips the draw.

A prefill batch is one fused step: queued prompts are bucketed by
length to powers of two and stacked per bucket (the batch itself padded
to a power of two, pad rows duplicating request 0); the forward runs the
length-masked flash-attention kernel; every prompt's KV is scattered
into the arenas by the KV-scatter kernel against the cache's host-side
``prefill_scatter_plan``; the batch's first tokens are chosen from its
logits.  It is accounted as one ``fused_prefill`` launch.

A decode round is one fused step too: the forward runs the
paged-attention kernel per layer with the current token's K/V merged
in-kernel, the round's KV scatter (one launch per arena for all layers)
follows, and the tokens come back in one device-to-host transfer.  The
batch is padded to a power of two with duplicates of row 0, whose
duplicate scatter writes identical values to identical slots.  It is
accounted as one ``fused_decode`` launch, as in the JAX package; the
kernels it launches are counted per kernel in
:data:`repro_torch.kernels.LAUNCHES`.  CoW copies reserved before a
round land first, in one coalesced copy flush.

Chunked prefill (``max_prefill_chunk=N``): prompts split into chunks of
at most N tokens across successive rounds, at most one chunk batch per
round (FIFO over the backlog, one chunk-length bucket, within the
round's token budget), so in-flight decodes emit a token every round.
A chunk attends causally over itself and, through the prefix-KV mode of
the flash kernel, over the sequence's committed arena KV (gathered
through its block table, masked at the committed length).  A sharer
waits until its source has committed the shared pages; a prompt fully
covered by a shared prefix runs as one no-write chunk.  With
``mixed_rounds`` (the default), a round with both a chunk batch and
decode rows is one ``fused_mixed`` launch: the chunk's scatter lands
before the decode half reads the arena, and a prompt finishing in this
chunk feeds its first token into the decode half on the device.

K-block decode (``decode_block_rounds=K``): with nothing to admit, up to
K decode rounds run as one ``fused_decode_block`` launch with one host
transfer.  Capacity for the whole block is reserved up front; the
rounds run in a Python loop with lengths, last tokens and the alive
mask kept on the device, a stopped row writing its slot's old value
back (so the arena stays bit-identical to K=1), a ``(B, K)`` token
buffer with ``-1`` after a row stopped, and the host replaying the stop
rule on the one transfer.

The layer loop is a Python loop where the JAX package used
``lax.scan``; arenas are updated in place where the JAX package donated
them.  ``fused=False`` keeps the eager decode oracle: the same forward,
with the round's KV written through the op queue's ``kv_write`` kind
instead of inside the step.

Not in this slice (the constructor raises): the radix prefix cache,
caller-supplied libs, trace recording, device meshes, the eager prefill
oracle, and the ssm/hybrid/moe families.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.drange import ops as dr_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.rowclone import ops as rc_ops
from repro_torch.models import transformer as T
from repro_torch.models.layers import (apply_rope, cast, embed, logits_out,
                                       mlp, rmsnorm, rope_sincos)
from repro_torch.models.params import tree_leaves, tree_map
from .kv_cache import PagedKVCache, _bucket_pow2

MASK32 = 0xFFFFFFFF
Seed = Tuple[int, int]


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray                    # (prompt_len,) int32
    max_new_tokens: int = 16
    temperature: float = 1.0              # 0.0 = greedy
    # stop after emitting this token (kept in out_tokens); None = budget
    eos_token_id: Optional[int] = None
    share_with: Optional[int] = None      # pairwise prefix-sharing source
    shared_len: int = 0
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class _ChunkPrefill:
    """A request mid-prefill on the chunk backlog: ``off`` tokens of its
    prompt (shared prefix included) are committed to the arena.

    ``dep``/``dep_len``: a sharer reads its source's pages, which commit
    across rounds under chunking, so it waits until the source has
    committed ``dep_len`` tokens.  ``write=False``: a prompt fully
    covered by a shared prefix runs as one 1-token chunk (its last
    position recomputed against the committed prefix) with no scatter."""
    req: Request
    off: int
    dep: Optional[int] = None
    dep_len: int = 0
    write: bool = True

    @property
    def remaining(self) -> int:
        return len(self.req.prompt) - self.off


class PagedEngine:
    """Single-device engine for dense GQA decoders (the paged path)."""

    def __init__(self, cfg: ModelConfig, params, *, page_size: int = 16,
                 num_pages: int = 256, pcfg: Optional[ParallelConfig] = None,
                 seed: int = 0, device: DeviceLike = None, fused: bool = True,
                 fused_prefill: bool = True,
                 max_prefill_chunk: Optional[int] = None,
                 decode_block_rounds: int = 1, mixed_rounds: bool = True,
                 lib=None, record_trace: bool = False, mesh=None,
                 compressed_collectives: bool = False,
                 prefix_cache: bool = False):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: only dense decoders are ported")
        for name, on in (("fused_prefill=False", not fused_prefill),
                         ("lib", lib is not None),
                         ("record_trace", record_trace),
                         ("mesh", mesh is not None),
                         ("compressed_collectives", compressed_collectives),
                         ("prefix_cache", prefix_cache)):
            if on:
                raise NotImplementedError(
                    f"PagedEngine({name}) is not ported yet")
        if max_prefill_chunk is not None and max_prefill_chunk < 1:
            raise ValueError("max_prefill_chunk must be >= 1 (or None to "
                             "disable chunked prefill)")
        if decode_block_rounds < 1:
            raise ValueError("decode_block_rounds must be >= 1")
        if decode_block_rounds > 1 and not fused:
            raise ValueError("decode_block_rounds > 1 requires fused=True "
                             "(the eager path is the round-at-a-time oracle)")
        self.device = resolve_device(device)
        for path, leaf in tree_leaves(params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"parameter {path} is on {leaf.device}, "
                                 f"the engine on {self.device}")
        self.cfg = cfg
        self.pcfg = pcfg or ParallelConfig(attention_impl="naive",
                                           remat="none")
        self.params = params
        self.cache = PagedKVCache(cfg, num_pages=num_pages,
                                  page_size=page_size, device=self.device)
        self.fused = fused
        self.max_prefill_chunk = max_prefill_chunk
        self.decode_block_rounds = decode_block_rounds
        # which multi-round paths this engine runs (the JAX engine builds
        # a compiled step for each)
        self._chunked = max_prefill_chunk is not None
        self._blocked = fused and decode_block_rounds > 1
        self._mixed = mixed_rounds and self._chunked and fused
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}
        # chunk backlog: requests mid-prefill under the chunked scheduler
        self._chunk_q: List[_ChunkPrefill] = []
        self._chunk_by_id: Dict[int, _ChunkPrefill] = {}
        # the seed stream: dispatch n draws at rng_seed + n (both words,
        # uint32 wraparound)
        self.rng_seed: Seed = (seed & MASK32, (seed ^ 0x9E3779B9) & MASK32)
        self.rng_ctr = 0
        self.stats = {"prefills": 0, "decode_rounds": 0, "tokens_out": 0,
                      "fused_dispatches": 0, "fused_prefill_dispatches": 0,
                      "prefill_chunks": 0, "decode_stall_rounds": 0,
                      "multi_round_blocks": 0, "mixed_dispatches": 0,
                      "prefix_hits": 0, "prefix_hit_tokens": 0,
                      # host seconds of the prefill steps (a mixed round
                      # counts here) and of the decode rounds and blocks;
                      # each ends in its device-to-host token transfer,
                      # so they include the device work
                      "prefill_seconds": 0.0, "decode_seconds": 0.0}
        # decode tails already reserved this round
        self._reserved_tails: set = set()

    # ----------------------------- API -------------------------------- #

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    @property
    def has_work(self) -> bool:
        """Anything queued, mid-prefill, or decoding?"""
        return bool(self.queue or self._chunk_q or self.active)

    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens admitted but not yet committed to the arena:
        the chunk backlog's remaining work plus the submit queue."""
        return (sum(st.remaining for st in self._chunk_q)
                + sum(len(r.prompt) for r in self.queue))

    def set_prefill_chunk(self, n: int) -> None:
        """Retarget the per-round prefill chunk budget (read fresh each
        round); only an engine built chunked has the chunked path."""
        if self.max_prefill_chunk is None:
            raise ValueError(
                "engine was built without chunked prefill "
                "(max_prefill_chunk=None)")
        if n < 1:
            raise ValueError("max_prefill_chunk must be >= 1")
        self.max_prefill_chunk = int(n)

    def step(self) -> Dict[int, List[int]]:
        """Run one engine round (bounded prefill + the round's decode);
        returns the requests that finished."""
        return self.run(max_rounds=1)

    def run(self, max_rounds: int = 1000) -> Dict[int, List[int]]:
        """Engine rounds until done.  Every round runs (at most) one
        prefill step and the decode round: with chunking the prefill
        step is at most one chunk batch (fused with the decode into one
        mixed round when ``mixed_rounds``), without it the whole queue
        in bucketed batches.  With nothing to admit, a K-block engine
        runs up to ``decode_block_rounds`` rounds per launch; ``rounds``
        advances by the rounds the block consumed."""
        results: Dict[int, List[int]] = {}
        rounds = 0
        while ((self.queue or self._chunk_q or self.active)
               and rounds < max_rounds):
            had_active = bool(self.active)
            decoded = False
            if self.queue or self._chunk_q:
                if self.active:
                    # reserve the decode tails now and dispatch their
                    # coalesced CoW copies ahead of the prefill host work
                    self._reserve_tails(sorted(self.active))
                    self.cache.queue.flush_overlapped(self.cache.lib.flush)
                t0 = time.perf_counter()
                if self._chunked:
                    prefill_toks, decoded = self._prefill_tick()
                else:
                    prefill_toks = self._prefill_round()
                self.stats["prefill_seconds"] += time.perf_counter() - t0
                if (had_active and self.max_prefill_chunk is not None
                        and prefill_toks > self.max_prefill_chunk):
                    # decodes waited behind an over-budget prefill (never
                    # under the chunked scheduler)
                    self.stats["decode_stall_rounds"] += 1
                # a budget of 1 is met by the prefill token alone
                self._finish_done(results)
            elif self.active and self._blocked:
                # pure decode, nothing to admit: one launch covers up to
                # K rounds (never past the caller's round budget)
                t0 = time.perf_counter()
                rounds += self._decode_block(max_rounds - rounds)
                self.stats["decode_seconds"] += time.perf_counter() - t0
                self._finish_done(results)
                continue
            if not decoded:
                t0 = time.perf_counter()
                self._decode_round()
                self.stats["decode_seconds"] += time.perf_counter() - t0
            rounds += 1
            self._finish_done(results)
        return results

    def _finish_done(self, results: Dict[int, List[int]]) -> None:
        for key in ("prefix_hits", "prefix_hit_tokens"):
            self.stats[key] = self.cache.stats[key]
        for rid in list(self.active):
            r = self.active[rid]
            hit_eos = (r.eos_token_id is not None and r.out_tokens
                       and r.out_tokens[-1] == r.eos_token_id)
            if len(r.out_tokens) >= r.max_new_tokens or hit_eos:
                r.done = True
                results[rid] = r.out_tokens
                self.cache.free(rid)
                del self.active[rid]
                self._reserved_tails.discard(rid)

    # ------------------------- token choice ---------------------------- #

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(device=self.device,
                                                 dtype=dtype)

    def _seed(self, ctr: int) -> Seed:
        """The seed of dispatch ``ctr``: ``rng_seed + ctr`` in uint32."""
        return tuple((w + ctr) & MASK32 for w in self.rng_seed)

    def _choose(self, logits: torch.Tensor, temps: np.ndarray, seed: Seed,
                rowmap: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token choice for a dispatch's logits rows (pad rows
        included), on the device; the one hook every path goes through
        (tests override it to teacher-force a reference stream)."""
        return _select_tokens(logits, temps, seed, rowmap=rowmap)

    def _sample(self, logits: torch.Tensor,
                temps: Sequence[float]) -> torch.Tensor:
        """Advance the seed stream by one dispatch and choose."""
        self.rng_ctr += 1
        return self._choose(logits, np.asarray(temps, np.float32),
                            self._seed(self.rng_ctr))

    # --------------------------- prefill ------------------------------ #

    def _prefill_round(self) -> int:
        """Drain the request queue: one fused step per length-bucket
        batch, in bucket order.  Returns the prompt tokens processed."""
        reqs, self.queue = self.queue, []
        # create every sequence in submission order first, so shared
        # prefixes resolve across bucket groups
        for r in reqs:
            self.cache.create(r.req_id, len(r.prompt),
                              share_with=r.share_with,
                              shared_len=r.shared_len)
        groups: Dict[int, List[Request]] = {}
        for r in reqs:
            groups.setdefault(_bucket_pow2(len(r.prompt)), []).append(r)
        for sp in sorted(groups):
            self._prefill_batch_fused(groups[sp], sp)
        return sum(len(r.prompt) for r in reqs)

    def _prefill_batch_fused(self, reqs: List[Request], sp: int) -> None:
        """One fused step for a same-length-bucket prefill batch."""
        B = len(reqs)
        Bp = _bucket_pow2(B)
        idx = list(range(B)) + [0] * (Bp - B)   # pad rows duplicate req 0
        toks = np.zeros((Bp, sp), np.int32)
        lens = np.zeros((Bp,), np.int32)
        for row, i in enumerate(idx):
            toks[row, :len(reqs[i].prompt)] = reqs[i].prompt
            lens[row] = len(reqs[i].prompt)
        # host-side arena plan: (page, slot) per prompt token to write,
        # and its flat (row * sp + pos) index into the forward's K/V
        plan = []
        for i, r in enumerate(reqs):
            seq = self.cache.seqs[r.req_id]
            start = seq.shared_prefix_pages * self.cache.page_size
            plan.append((i, seq, start, seq.length, 0))
        scatter = self._scatter_plan(plan, sp, Bp)
        # the step reads the arena (shared prefixes): land the backlog
        self.cache.flush_pending()
        logits = _fused_prefill_step(
            self.cfg, self.pcfg, self.params, self._tensor(toks),
            self._tensor(lens), self.cache.k_arena, self.cache.v_arena,
            scatter)
        self.cache.commit_fused_prefill()
        tokens = self._sample(logits, [reqs[i].temperature for i in idx])
        toks_np = tokens[:B].cpu().numpy()    # the batch's one transfer
        for i, r in enumerate(reqs):
            r.out_tokens.append(int(toks_np[i]))
            self.active[r.req_id] = r
            self.stats["prefills"] += 1
        self.stats["fused_prefill_dispatches"] += 1

    def _scatter_plan(self, plan, sp: int, Bp: int):
        """Device operands of a batch's KV scatter.  ``plan`` holds one
        ``(row, seq, start, stop, first)`` per writing row: prompt
        positions ``[start, stop)`` go to their (page, slot), read from
        flat index ``row * sp + pos - first`` of the forward's K/V
        (``first``: the position of the forward's first token).  Pad
        entries duplicate entry 0 (identical writes, a no-op).  Returns
        (pages, slots, src), or ``None`` when the batch writes nothing."""
        pages: List[int] = []
        slots: List[int] = []
        src: List[int] = []
        for row, seq, start, stop, first in plan:
            p_i, s_i = self.cache.prefill_scatter_plan(seq, start=start,
                                                       stop=stop)
            pages += p_i
            slots += s_i
            src += [row * sp + pos - first for pos in range(start, stop)]
        if not pages:
            return None
        pad = Bp * sp - len(pages)
        return (self._tensor(pages + [pages[0]] * pad),
                self._tensor(slots + [slots[0]] * pad),
                self._tensor(src + [src[0]] * pad, torch.long))

    # ---------------- chunked prefill (decode-interleaved) ------------- #

    def _prefill_tick(self) -> Tuple[int, bool]:
        """One round's bounded prefill under the chunked scheduler: admit
        the queue to the chunk backlog, then run at most one chunk batch
        (FIFO, one chunk-length bucket, at most ``max_prefill_chunk``
        prompt tokens).  With mixed rounds on and decode rows present
        (active sequences, or prompts finishing in this chunk) the chunk
        batch and the round's decode run as one mixed round.  Unfinished
        prompts return to the front of the backlog.  Returns
        ``(prompt_tokens_processed, decoded)``."""
        self._admit_queue()
        batch, sc = self._select_chunk_batch()
        if not batch:
            return 0, False
        toks = sum(clen for _, clen in batch)
        if self._mixed:
            fin = {st.req.req_id for st, clen in batch
                   if st.off + clen >= len(st.req.prompt)
                   and st.req.max_new_tokens > 1}
            d_rids = sorted(set(self.active) | fin)
            if d_rids:
                unfinished = self._mixed_round(batch, sc, d_rids)
                self._chunk_q = unfinished + self._chunk_q
                return toks, True
        unfinished = self._prefill_chunk_batch_fused(batch, sc)
        self._chunk_q = unfinished + self._chunk_q
        return toks, False

    def _select_chunk_batch(self):
        """This round's chunk batch off the backlog: FIFO, one
        chunk-length bucket, within the round's token budget; states
        passed over (bucket, budget, unmet share dependency) stay queued
        in order.  Returns ``(batch, sc)``: (state, chunk length) pairs
        and their length bucket."""
        if not self._chunk_q:
            return [], None
        budget = self.max_prefill_chunk
        batch: List[tuple] = []
        keep: List[_ChunkPrefill] = []
        sc = None
        for st in self._chunk_q:
            if st.dep is not None:
                if not self._source_committed(st.dep, st.dep_len):
                    keep.append(st)      # shared pages not yet committed
                    continue
                st.dep = None            # satisfied once = satisfied forever
            clen = min(self.max_prefill_chunk, st.remaining)
            cb = _bucket_pow2(clen)
            if batch and (cb != sc or clen > budget):
                keep.append(st)
                continue
            sc = cb
            batch.append((st, clen))
            budget -= clen
        self._chunk_q = keep
        return batch, sc

    def _source_committed(self, src_id: Optional[int], n: int) -> bool:
        """Has sequence ``src_id`` committed at least ``n`` prompt tokens
        (true when it is not mid-prefill)?"""
        if src_id is None:
            return True
        st = self._chunk_by_id.get(src_id)
        return st is None or st.off >= n

    def _admit_queue(self) -> None:
        """Create sequences for queued requests (submission order, so
        ``share_with`` resolves) and push them onto the chunk backlog; a
        prompt fully covered by a shared prefix becomes one no-write
        chunk, gated until its source has committed the whole prompt."""
        reqs, self.queue = self.queue, []
        for r in reqs:
            seq = self.cache.create(r.req_id, len(r.prompt),
                                    share_with=r.share_with,
                                    shared_len=r.shared_len)
            off = seq.shared_prefix_pages * self.cache.page_size
            n = len(r.prompt)
            if off >= n:
                st = _ChunkPrefill(r, n - 1, dep=r.share_with, dep_len=n,
                                   write=False)
            else:
                st = _ChunkPrefill(r, off, dep=r.share_with, dep_len=off)
            self._chunk_q.append(st)
            self._chunk_by_id[r.req_id] = st

    def _chunk_operands(self, batch: List[tuple], sc: int) -> dict:
        """A chunk batch's device operands and scatter plan (pad rows
        duplicate row 0).  The prefix block table spans each sequence's
        full page list with the committed length as its valid length."""
        B = len(batch)
        Bp = _bucket_pow2(B)
        idx = list(range(B)) + [0] * (Bp - B)   # pad rows duplicate row 0
        toks = np.zeros((Bp, sc), np.int32)
        lens = np.zeros((Bp,), np.int32)
        offs = np.zeros((Bp,), np.int32)
        temps = np.zeros((Bp,), np.float32)
        for row, i in enumerate(idx):
            st, clen = batch[i]
            toks[row, :clen] = st.req.prompt[st.off:st.off + clen]
            lens[row] = clen
            offs[row] = st.off
            temps[row] = st.req.temperature
        rids = [batch[i][0].req.req_id for i in idx]
        bt, plens = self.cache.block_table(rids,
                                           lengths=[int(o) for o in offs])
        plan = [(i, self.cache.seqs[st.req.req_id], st.off, st.off + clen,
                 st.off) for i, (st, clen) in enumerate(batch) if st.write]
        return {"toks": self._tensor(toks), "lens": self._tensor(lens),
                "offs": self._tensor(offs), "bt": bt, "plens": plens,
                "scatter": self._scatter_plan(plan, sc, Bp),
                "temps": temps}

    def _chunk_forward(self, c: dict) -> torch.Tensor:
        """The chunk half of a step: forward + chunk scatter, logits."""
        return _fused_chunk_prefill_step(
            self.cfg, self.pcfg, self.params, c["toks"], c["lens"],
            c["offs"], self.cache.k_arena, self.cache.v_arena, c["bt"],
            c["plens"], c["scatter"])

    def _finish_chunks(self, batch: List[tuple],
                       tokens: torch.Tensor) -> List[_ChunkPrefill]:
        """Advance chunk offsets; rows whose chunk completed the prompt
        take their first token (one host transfer per batch, only when
        one finished) and join the active set.  Returns the unfinished
        states."""
        toks_np = None
        unfinished: List[_ChunkPrefill] = []
        for i, (st, clen) in enumerate(batch):
            st.off += clen
            if st.remaining <= 0:
                if toks_np is None:         # the batch's one host transfer
                    toks_np = tokens.cpu().numpy()
                st.req.out_tokens.append(int(toks_np[i]))
                self.active[st.req.req_id] = st.req
                self.stats["prefills"] += 1
                del self._chunk_by_id[st.req.req_id]
            else:
                unfinished.append(st)
        return unfinished

    def _prefill_chunk_batch_fused(self, batch: List[tuple],
                                   sc: int) -> List[_ChunkPrefill]:
        """One fused step for a same-bucket batch of prefill chunks:
        prefix-KV chunk forward over the committed arena pages, chunk KV
        scatter, token choice.  Returns the unfinished chunk states."""
        # the step reads the arena (prefix gather): land the backlog
        self.cache.flush_pending()
        c = self._chunk_operands(batch, sc)
        logits = self._chunk_forward(c)
        tokens = self._sample(logits, c["temps"])
        self.cache.commit_fused_prefill()
        self.stats["prefill_chunks"] += len(batch)
        self.stats["fused_prefill_dispatches"] += 1
        return self._finish_chunks(batch, tokens)

    def _mixed_round(self, batch: List[tuple], sc: int,
                     d_rids: List[int]) -> List[_ChunkPrefill]:
        """One fused step for a whole mixed round: the chunk batch, then
        the decode round over every active sequence plus every prompt
        finishing in this chunk.  The chunk's scatter lands before the
        decode half reads the arena, and a finishing prompt's first
        token reaches the decode half on the device (``d_from``).  Both
        commits count nothing; the round is one ``fused_mixed`` launch.
        The seed stream advances twice (chunk, then decode), as two
        separate dispatches would.  A finishing row whose first token is
        its EOS drops its decode token (the KV written past its length
        dies with its pages).  Returns the unfinished chunk states."""
        fin = {st.req.req_id: st.req for st, clen in batch
               if st.off + clen >= len(st.req.prompt)}
        reqmap = dict(self.active)
        reqmap.update(fin)
        # reserve every decode row's tail before planning the chunk
        # scatter (a CoW retarget must be seen by the plan), and land the
        # copies before the step reads the arena
        self._reserve_tails(d_rids)
        self._reserved_tails.clear()
        self.cache.flush_pending()
        c = self._chunk_operands(batch, sc)
        row_of = {st.req.req_id: i for i, (st, _) in enumerate(batch)}
        B = len(d_rids)
        Bp = _bucket_pow2(B)
        prids = [d_rids[i] for i in list(range(B)) + [0] * (Bp - B)]
        seqs = [self.cache.seqs[r] for r in prids]
        d_last = np.zeros((Bp,), np.int32)
        d_from = np.full((Bp,), -1, np.int32)
        d_temps = np.zeros((Bp,), np.float32)
        for row, rid in enumerate(prids):
            r = reqmap[rid]
            d_temps[row] = r.temperature
            if rid in fin:               # the token arrives on the device
                d_from[row] = row_of[rid]
            else:
                d_last[row] = r.out_tokens[-1]
        # every decode operand is on the card before the chunk half is
        # enqueued: nothing between the halves waits for the card
        d_bt, d_lens = self.cache.block_table(prids)
        d_pages = self._tensor([s.pages[-1] for s in seqs])
        d_slots = self._tensor([s.length % self.cache.page_size
                                for s in seqs])
        d_from_t = self._tensor(d_from, torch.long)
        d_last_t = self._tensor(d_last, torch.long)
        c_logits = self._chunk_forward(c)
        c_tokens = self._sample(c_logits, c["temps"])
        last = torch.where(d_from_t >= 0, c_tokens[d_from_t.clamp(min=0)],
                           d_last_t)
        d_logits = _fused_decode_step(
            self.cfg, self.params, last[:, None], self.cache.k_arena,
            self.cache.v_arena, d_bt, d_lens, d_pages, d_slots)
        d_tokens = self._sample(d_logits, d_temps)
        self.cache.commit_fused_prefill(kind=None)
        self.cache.commit_fused_round(d_rids, kind=None)
        # the whole round, chunk scatter included, was one launch
        self.cache.queue.count_external("fused_mixed")
        self.stats["prefill_chunks"] += len(batch)
        self.stats["mixed_dispatches"] += 1
        unfinished = self._finish_chunks(batch, c_tokens)
        d_toks = d_tokens[:B].cpu().numpy()
        emitted = 0
        for i, rid in enumerate(d_rids):
            r = reqmap[rid]
            if (rid in fin and r.eos_token_id is not None
                    and r.out_tokens[-1] == r.eos_token_id):
                continue       # the first token was EOS: drop this one
            r.out_tokens.append(int(d_toks[i]))
            emitted += 1
        self.stats["decode_rounds"] += 1
        self.stats["tokens_out"] += emitted
        return unfinished

    # ---------------------------- decode ------------------------------ #

    def _reserve_tails(self, rids: List[int]) -> None:
        """Reserve the incoming token's slot on every sequence in
        ``rids`` once per round (CoW-copies shared tails, allocates
        boundary pages)."""
        for r in rids:
            if r not in self._reserved_tails:
                self.cache.ensure_writable_tail(self.cache.seqs[r])
                self._reserved_tails.add(r)

    def _decode_round(self) -> None:
        if not self.active:
            return
        rids = sorted(self.active)
        # the round's CoW copies land in ONE batched launch per arena
        # before attention reads the arena
        self._reserve_tails(rids)
        self._reserved_tails.clear()
        self.cache.flush_pending()
        if self.fused:
            toks = self._decode_round_fused(rids)
        else:
            toks = self._decode_round_eager(rids)
        for i, r in enumerate(rids):
            self.active[r].out_tokens.append(int(toks[i]))
        self.stats["decode_rounds"] += 1
        self.stats["tokens_out"] += len(rids)

    def _decode_round_fused(self, rids: List[int]) -> np.ndarray:
        """One fused step for the whole round; one host transfer."""
        B = len(rids)
        Bp = _bucket_pow2(B)
        # pad rows duplicate sequence 0: wasted attention, and a scatter
        # of the same values to the same slot
        prids = [rids[i] for i in list(range(B)) + [0] * (Bp - B)]
        seqs = [self.cache.seqs[r] for r in prids]
        last = [[self.active[r].out_tokens[-1]] for r in prids]
        pages = [s.pages[-1] for s in seqs]
        slots = [s.length % self.cache.page_size for s in seqs]
        bt, lens = self.cache.block_table(prids)
        logits = _fused_decode_step(
            self.cfg, self.params, self._tensor(last), self.cache.k_arena,
            self.cache.v_arena, bt, lens, self._tensor(pages),
            self._tensor(slots))
        tokens = self._sample(logits,
                              [self.active[r].temperature for r in prids])
        self.cache.commit_fused_round(rids)
        self.stats["fused_dispatches"] += 1
        return tokens[:B].cpu().numpy()

    def _decode_block(self, max_allowed: int) -> int:
        """Up to ``decode_block_rounds`` decode rounds in one launch,
        entered only when nothing waits for admission.  Returns the
        rounds consumed (the longest row's emitted-token count), never
        more than ``max_allowed``.

        Host side: reserve each row's whole block up front (CoW and page
        allocation, one coalesced flush), plan a (row, round) -> (page,
        slot) table over the reserved pages (a budget-short row repeats
        its last slot), run the block, read its one host transfer and
        replay the stop rule (-1 = the row had stopped; EOS stops after
        its own round).  Round ``t`` draws at the seed a round-at-a-time
        run would draw; the stream advances by K whatever the block
        consumes, as the JAX engine's does."""
        rids = sorted(self.active)
        K = self.decode_block_rounds
        steps = [min(max_allowed, K,
                     self.active[r].max_new_tokens
                     - len(self.active[r].out_tokens))
                 for r in rids]
        if max(steps) <= 1:
            self._decode_round()
            return 1
        for r, n in zip(rids, steps):
            self.cache.reserve_tokens(self.cache.seqs[r], n)
        self._reserved_tails.clear()
        self.cache.flush_pending()
        B = len(rids)
        Bp = _bucket_pow2(B)
        idx = list(range(B)) + [0] * (Bp - B)   # pad rows duplicate row 0
        ps = self.cache.page_size
        pages = np.zeros((Bp, K), np.int32)
        slots = np.zeros((Bp, K), np.int32)
        last = np.zeros((Bp,), np.int32)
        steps_arr = np.zeros((Bp,), np.int32)
        eos = np.full((Bp,), -1, np.int32)
        temps = np.zeros((Bp,), np.float32)
        for row, i in enumerate(idx):
            r = rids[i]
            req, seq, n = self.active[r], self.cache.seqs[r], steps[i]
            for t in range(K):
                pos = seq.length + min(t, n - 1)
                pages[row, t] = seq.pages[pos // ps]
                slots[row, t] = pos % ps
            last[row] = req.out_tokens[-1]
            steps_arr[row] = n
            if req.eos_token_id is not None:
                eos[row] = req.eos_token_id
            temps[row] = req.temperature
        # the table spans the reserved pages; lens stay the committed
        # lengths, carried forward round by round on the device
        bt, lens = self.cache.block_table([rids[i] for i in idx])
        self.rng_ctr += K
        seeds = [self._seed(self.rng_ctr - K + 1 + t)
                 for t in range(max(steps))]
        tokens = _fused_block_step(
            self.cfg, self.params, self._tensor(last),
            self._tensor(steps_arr), self.cache.k_arena, self.cache.v_arena,
            bt, lens, self._tensor(pages), self._tensor(slots),
            self._tensor(eos), seeds, temps, self._tensor(idx, torch.long),
            self._choose)
        toks_np = tokens[:B].cpu().numpy()    # the block's one transfer
        counts = []
        for i, r in enumerate(rids):
            req = self.active[r]
            n_i = 0
            for t in range(steps[i]):
                tok = int(toks_np[i, t])
                if tok < 0:                # the row had stopped
                    break
                req.out_tokens.append(tok)
                n_i += 1
                if req.eos_token_id is not None and tok == req.eos_token_id:
                    break
            counts.append(n_i)
        consumed = max(counts)
        self.cache.commit_fused_block(rids, counts)
        self.stats["decode_rounds"] += consumed
        self.stats["tokens_out"] += sum(counts)
        self.stats["multi_round_blocks"] += 1
        return consumed

    def _decode_round_eager(self, rids: List[int]) -> np.ndarray:
        """The oracle: the same forward, with the round's KV written
        through the op queue (one ``kv_write`` flush) instead of inside
        the step, and one paged-attention launch per layer accounted as
        the JAX package accounts it."""
        last = self._tensor([[self.active[r].out_tokens[-1]] for r in rids])
        bt, lens = self.cache.block_table(rids)
        logits, k_new, v_new = _decode_forward(
            self.cfg, self.params, last, self.cache.k_arena,
            self.cache.v_arena, bt, lens)
        self.cache.queue.count_external("eager_attn_layer",
                                        self.cache.n_layers)
        self.cache.write_token_kv_batch(rids, k_new, v_new)
        tokens = self._sample(logits,
                              [self.active[r].temperature for r in rids])
        return tokens.cpu().numpy()


# ---------------------------------------------------------------------- #
# Forward passes (module functions, shared by the fused steps and the
# eager oracle)
# ---------------------------------------------------------------------- #


def _layer(gparams, li: int):
    """Layer ``li`` of the stacked ``group0`` tree (views, no copies)."""
    return tree_map(lambda a: a[li], gparams)


def _select_tokens(logits: torch.Tensor, temps: np.ndarray, seed: Seed,
                   rowmap: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row token choice, on the logits' device: greedy rows
    (``temps == 0``) take the first maximal logit; sampled rows take the
    inverse-CDF draw ``softmax(logits / t)``, ``cumsum``, first index
    with ``cum > u`` (0 when none exceeds ``u``, as ``jnp.argmax`` of an
    all-false row gives), with one D-RaNGe uniform ``u`` per row.
    ``temps`` are host values, so an all-greedy batch skips the draw
    without a device sync.  ``rowmap`` (the K-block's pad-row fold)
    gives row ``b`` the uniform of row ``rowmap[b]``, so a pad row draws
    the token of the row it duplicates."""
    greedy = torch.argmax(logits, dim=-1)
    temps = np.asarray(temps, np.float32)
    if np.all(temps == 0.0):
        return greedy
    dev = logits.device
    u = dr_ops.pim_random_uniform(seed, logits.shape[0], 1, dev)[:, 0]
    if rowmap is not None:
        u = u[rowmap]
    t = _upload(np.where(temps > 0.0, temps, np.float32(1.0)), dev)
    probs = torch.softmax(logits.float() / t[:, None], dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    drawn = torch.argmax((cum > u[:, None]).to(torch.uint8), dim=-1)
    return torch.where(_upload(temps == 0.0, dev), greedy, drawn)


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without waiting for the card: the copy
    goes through pinned memory, so it queues behind the work already
    enqueued instead of synchronising with it (a copy from pageable
    memory would), and a K-block's rounds never stall the host."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _sublayer(cfg: ModelConfig, kind: str, sp, x: torch.Tensor,
              sin: torch.Tensor, cos: torch.Tensor, attend: Callable):
    """One pre-normed decoder sublayer.  ``attend(q, k, v)`` runs the
    attention over the (b, s, h, hd) projections (the decode callers
    attend one token against the arena, the prefill callers run the
    length-masked flash kernel).  Returns (x, (k, v) | None)."""
    h = rmsnorm(x, sp["norm"], cfg.norm_eps)
    if kind == "mlp":
        return x + mlp(sp["mlp"], h, cfg.activation), None
    if kind != "attn":
        raise NotImplementedError(f"sublayer kind {kind!r} is not ported")
    a = sp["attn"]
    q = torch.einsum("bsd,dhk->bshk", h, cast(a["wq"]))
    k = torch.einsum("bsd,dhk->bshk", h, cast(a["wk"]))
    v = torch.einsum("bsd,dhk->bshk", h, cast(a["wv"]))
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    o = attend(q, k, v)
    out = torch.einsum("bshk,hkd->bsd", o, cast(a["wo"]))
    return x + out, (k, v)


def _run_kinds(cfg: ModelConfig, p_layer, x: torch.Tensor, sin, cos,
               attend: Callable):
    """One layer's sublayer sequence (attn, mlp).  Returns (x, the attn
    sublayer's (k, v))."""
    kv_out = None
    for i, kind in enumerate(T.layer_groups(cfg)[0][1]):
        x, kv = _sublayer(cfg, kind, p_layer[f"{i}_{kind}"], x, sin, cos,
                          attend)
        if kv is not None:
            kv_out = kv
    return x, kv_out


def _prefill_forward(cfg: ModelConfig, pcfg: ParallelConfig, params,
                     toks: torch.Tensor, lens: torch.Tensor):
    """Batched prefill forward over a length-padded prompt batch, with
    causal + per-sequence-length masked flash attention.

    toks: (B, S) int32; lens: (B,) valid lengths (>= 1).  Returns
    (last-real-token logits (B, V), k_all, v_all (L, B, S, kvh, hd))."""
    hd = cfg.resolved_head_dim
    B, S = toks.shape
    x = embed(params["embed"], toks, cfg)
    positions = torch.arange(S, dtype=torch.int32,
                             device=toks.device).expand(B, S)
    sin, cos = rope_sincos(positions, hd, cfg.rope_theta)

    def attend(q, k, v):
        # (B, S, h, hd) <-> the kernel's (B, h, S, hd) layout
        o = fa_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=True,
                             sm_scale=hd ** -0.5, lengths=lens)
        return o.transpose(1, 2)

    gparams = params["group0"]
    ks, vs = [], []
    for li in range(cfg.num_layers):
        x, (k, v) = _run_kinds(cfg, _layer(gparams, li), x, sin, cos, attend)
        ks.append(k)
        vs.append(v)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    # each row's last real token (pad rows mirror row 0, lens >= 1)
    x_last = x[torch.arange(B, device=x.device), lens.long() - 1][:, None]
    logits = logits_out(params["embed"], x_last, cfg, fp32=pcfg.logits_fp32)
    return logits[:, 0], torch.stack(ks), torch.stack(vs)


def _scatter_kv(k_arena, v_arena, k_all, v_all, scatter) -> None:
    """Scatter a (chunk) prefill's K/V into the arenas, in place:
    ``scatter`` is the engine's (pages, slots, src) plan, entry ``n``
    writing the forward's K/V at flat index ``src[n]`` (over batch and
    sequence) to ``arena[:, pages[n], slots[n]]``; ``None`` writes
    nothing.  One kernel launch per arena covers every layer."""
    if scatter is None:
        return
    pages, slots, src = scatter
    L, Bp, Sp = k_all.shape[:3]
    for arena, new_all in ((k_arena, k_all), (v_arena, v_all)):
        flat = new_all.reshape((L, Bp * Sp) + new_all.shape[3:])[:, src]
        rc_ops.kv_scatter_inline(arena, pages, slots, flat)


def _fused_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig, params,
                        toks, lens, k_arena, v_arena,
                        scatter) -> torch.Tensor:
    """Masked prefill forward + KV scatter of the whole batch (see
    :func:`_scatter_kv`).  Returns the last-token logits (B, V)."""
    logits, k_all, v_all = _prefill_forward(cfg, pcfg, params, toks, lens)
    _scatter_kv(k_arena, v_arena, k_all, v_all, scatter)
    return logits


def _chunk_prefill_forward(cfg: ModelConfig, pcfg: ParallelConfig, params,
                           toks, lens, offs, k_arena, v_arena, bt, plens):
    """Batched forward over one prefill chunk per row, with prefix-KV
    flash attention: each row's queries attend causally over the chunk
    and in full over the row's committed arena KV, gathered through its
    block table and masked at ``plens[b]``.

    toks: (B, S) int32 chunk tokens; lens: (B,) valid chunk lengths
    (>= 1); offs: (B,) position of each chunk's first token (RoPE); bt:
    (B, W) block tables; plens: (B,) committed prefix lengths.  Returns
    (last-real-token logits (B, V), k_all, v_all (L, B, S, kvh, hd))."""
    hd = cfg.resolved_head_dim
    B, S = toks.shape
    ps = k_arena.shape[2]
    W = bt.shape[1]
    x = embed(params["embed"], toks, cfg)
    positions = offs[:, None] + torch.arange(S, dtype=torch.int32,
                                             device=toks.device)[None]
    sin, cos = rope_sincos(positions, hd, cfg.rope_theta)
    btl = bt.long()
    gparams = params["group0"]
    ks, vs = [], []
    for li in range(cfg.num_layers):
        k_l, v_l = k_arena[li], v_arena[li]

        def attend(q, k, v, k_l=k_l, v_l=v_l):
            # this layer's prefix, (B, kvh, W*ps, hd) views of the gather
            kp = k_l[btl].reshape(B, W * ps, *k_l.shape[2:]).transpose(1, 2)
            vp = v_l[btl].reshape(B, W * ps, *v_l.shape[2:]).transpose(1, 2)
            o = fa_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True,
                                 sm_scale=hd ** -0.5, lengths=lens,
                                 k_prefix=kp, v_prefix=vp,
                                 prefix_lengths=plens)
            return o.transpose(1, 2)

        x, (k, v) = _run_kinds(cfg, _layer(gparams, li), x, sin, cos, attend)
        ks.append(k)
        vs.append(v)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    x_last = x[torch.arange(B, device=x.device), lens.long() - 1][:, None]
    logits = logits_out(params["embed"], x_last, cfg, fp32=pcfg.logits_fp32)
    return logits[:, 0], torch.stack(ks), torch.stack(vs)


def _fused_chunk_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig,
                              params, toks, lens, offs, k_arena, v_arena,
                              bt, plens, scatter) -> torch.Tensor:
    """Chunk forward + chunk KV scatter; the scatter runs after every
    layer's prefix gather has read the arena.  Returns the logits."""
    logits, k_all, v_all = _chunk_prefill_forward(
        cfg, pcfg, params, toks, lens, offs, k_arena, v_arena, bt, plens)
    _scatter_kv(k_arena, v_arena, k_all, v_all, scatter)
    return logits


def _decode_forward(cfg: ModelConfig, params, tokens: torch.Tensor,
                    k_arena: torch.Tensor, v_arena: torch.Tensor,
                    block_tables: torch.Tensor, lengths: torch.Tensor):
    """Decoder forward for one token per sequence against the arena: the
    paged-attention kernel per layer, the current token's K/V merged
    in-kernel.  Returns (logits (B, V), k_new, v_new (L, B, kvh, hd))."""
    hd = cfg.resolved_head_dim
    x = embed(params["embed"], tokens, cfg)
    positions = lengths[:, None]            # the token's position == length
    sin, cos = rope_sincos(positions, hd, cfg.rope_theta)
    gparams = params["group0"]
    ks, vs = [], []
    for li in range(cfg.num_layers):
        k_l, v_l = k_arena[li], v_arena[li]

        def attend(q, k, v, k_l=k_l, v_l=v_l):
            o = pa_ops.paged_attention(
                q[:, 0].contiguous(), k_l, v_l, block_tables, lengths,
                sm_scale=hd ** -0.5, k_self=k[:, 0], v_self=v[:, 0])
            return o[:, None]

        x, (k, v) = _run_kinds(cfg, _layer(gparams, li), x, sin, cos, attend)
        ks.append(k[:, 0])
        vs.append(v[:, 0])
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_out(params["embed"], x, cfg)
    return logits[:, 0], torch.stack(ks), torch.stack(vs)


def _fused_decode_step(cfg: ModelConfig, params, last, k_arena, v_arena,
                       bt, lens, pages, slots) -> torch.Tensor:
    """Decode forward + the round's KV scatter (one kernel launch per
    arena covering every layer), arenas updated in place.  Returns the
    logits (B, V)."""
    logits, k_new, v_new = _decode_forward(cfg, params, last, k_arena,
                                           v_arena, bt, lens)
    rc_ops.kv_scatter_inline(k_arena, pages, slots, k_new)
    rc_ops.kv_scatter_inline(v_arena, pages, slots, v_new)
    return logits


def _fused_block_step(cfg: ModelConfig, params, last, steps, k_arena,
                      v_arena, bt, lens, pages, slots, eos, seeds, temps,
                      rowmap, choose: Callable) -> torch.Tensor:
    """Up to K decode rounds with one host transfer at the end: a Python
    loop over ``len(seeds)`` rounds (the block's longest row) whose
    carry — lengths, last tokens, the alive mask, the (B, K) token
    buffer — stays on the device, so the host never waits inside the
    block.  Round ``t``: forward at the carried lengths, a masked KV
    scatter (a stopped row writes its slot's current value back, so the
    arena stays bit-identical to round-at-a-time decoding), token choice
    at ``seeds[t]`` with ``rowmap`` folding pad rows onto row 0, then the
    stop rule (a row stops after ``steps`` tokens or its EOS).  Tokens
    after a row stopped are -1; a row that stopped early only runs
    masked.  Returns the (B, K) tokens."""
    Bp, K = pages.shape
    alive = steps > 0
    toks = torch.full((Bp, K), -1, dtype=torch.long, device=last.device)
    last = last.long()
    lens = lens.clone()
    for t, seed in enumerate(seeds):
        logits, k_new, v_new = _decode_forward(cfg, params, last[:, None],
                                               k_arena, v_arena, bt, lens)
        p_t, s_t = pages[:, t], slots[:, t]
        for arena, new in ((k_arena, k_new), (v_arena, v_new)):
            old = rc_ops.kv_gather_inline(arena, p_t, s_t)
            val = torch.where(alive[None, :, None, None],
                              new.to(arena.dtype), old)
            rc_ops.kv_scatter_inline(arena, p_t, s_t, val)
        raw = choose(logits, temps, seed, rowmap=rowmap).long()
        toks[:, t] = torch.where(alive, raw, -1)
        lens = lens + alive.to(lens.dtype)
        last = torch.where(alive, raw, last)
        hit_eos = alive & (eos >= 0) & (raw == eos)
        alive = alive & ((t + 1) < steps) & ~hit_eos
    return toks
