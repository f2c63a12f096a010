"""Continuous-batching serving engine over the paged PiM KV cache.

The port's counterpart of the dense greedy path of the JAX package's
``serving/engine.py`` (``fused=True, fused_prefill=True,
decode_block_rounds=1``).  Request lifecycle: queue -> prefill (KV
written into arena pages) -> decode rounds (paged attention over block
tables, one token per active sequence per round, new arrivals join
between rounds) -> finish (pages zeroed with RowClone-Init and freed).

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

The layer loop is a Python loop where the JAX package used
``lax.scan``; arenas are updated in place where the JAX package donated
them.  ``fused=False`` keeps the eager decode oracle: the same forward,
with the round's KV written through the op queue's ``kv_write`` kind
instead of inside the step.

Not in this slice (the constructor raises): chunked prefill, mixed
rounds, K-block decode, the radix prefix cache, caller-supplied libs,
trace recording, device meshes, the eager prefill oracle, and the
ssm/hybrid/moe families.  Sampled decoding (temperature > 0) raises
until the D-RaNGe slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.rowclone import ops as rc_ops
from repro_torch.models import transformer as T
from repro_torch.models.layers import (apply_rope, cast, embed, logits_out,
                                       mlp, rmsnorm, rope_sincos)
from repro_torch.models.params import tree_leaves, tree_map
from .kv_cache import PagedKVCache, _bucket_pow2


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray                    # (prompt_len,) int32
    max_new_tokens: int = 16
    # greedy only in this slice; the JAX package's default of 1.0
    # (sampled) would raise here
    temperature: float = 0.0
    # stop after emitting this token (kept in out_tokens); None = budget
    eos_token_id: Optional[int] = None
    share_with: Optional[int] = None      # pairwise prefix-sharing source
    shared_len: int = 0
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


class PagedEngine:
    """Single-device engine for dense GQA decoders (the paged path)."""

    def __init__(self, cfg: ModelConfig, params, *, page_size: int = 16,
                 num_pages: int = 256, pcfg: Optional[ParallelConfig] = None,
                 device: DeviceLike = None, fused: bool = True,
                 fused_prefill: bool = True,
                 max_prefill_chunk: Optional[int] = None,
                 decode_block_rounds: int = 1, lib=None,
                 record_trace: bool = False, mesh=None,
                 compressed_collectives: bool = False,
                 prefix_cache: bool = False):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: only dense decoders are ported")
        for name, on in (("fused_prefill=False", not fused_prefill),
                         ("max_prefill_chunk", max_prefill_chunk is not None),
                         ("decode_block_rounds>1", decode_block_rounds != 1),
                         ("lib", lib is not None),
                         ("record_trace", record_trace),
                         ("mesh", mesh is not None),
                         ("compressed_collectives", compressed_collectives),
                         ("prefix_cache", prefix_cache)):
            if on:
                raise NotImplementedError(
                    f"PagedEngine({name}) is not ported yet")
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
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}
        self.stats = {"prefills": 0, "decode_rounds": 0, "tokens_out": 0,
                      "fused_dispatches": 0, "fused_prefill_dispatches": 0,
                      "prefix_hits": 0, "prefix_hit_tokens": 0,
                      # host seconds in the two phases; each phase ends in
                      # its device-to-host token transfer, so they include
                      # the device work
                      "prefill_seconds": 0.0, "decode_seconds": 0.0}
        # decode tails already reserved this round
        self._reserved_tails: set = set()

    # ----------------------------- API -------------------------------- #

    def submit(self, req: Request) -> None:
        if req.temperature > 0.0:
            raise NotImplementedError(
                "sampled decoding (temperature > 0) comes with the D-RaNGe "
                "slice; this port serves greedy requests")
        self.queue.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active)

    def step(self) -> Dict[int, List[int]]:
        """Run one engine round: prefill whatever is queued, then the
        round's decode; returns the requests that finished."""
        return self.run(max_rounds=1)

    def run(self, max_rounds: int = 1000) -> Dict[int, List[int]]:
        """Engine rounds until done: each round prefills the queue (one
        fused step per length bucket) and runs one fused decode round."""
        results: Dict[int, List[int]] = {}
        rounds = 0
        while (self.queue or self.active) and rounds < max_rounds:
            if self.queue:
                if self.active:
                    # reserve the decode tails now and dispatch their
                    # coalesced CoW copies ahead of the prefill host work
                    self._reserve_tails(sorted(self.active))
                    self.cache.queue.flush_overlapped(self.cache.lib.flush)
                t0 = time.perf_counter()
                self._prefill_round()
                self.stats["prefill_seconds"] += time.perf_counter() - t0
                # a budget of 1 is met by the prefill token alone
                self._finish_done(results)
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

    # --------------------------- internals ----------------------------- #

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(device=self.device,
                                                 dtype=dtype)

    def _choose(self, rids: List[int], logits: torch.Tensor) -> np.ndarray:
        """Token choice for logits rows that belong to active requests
        ``rids`` (pad rows included) — one device-to-host transfer.  All
        requests are greedy (``submit`` refuses sampled ones)."""
        return _select_tokens(logits).cpu().numpy()

    def _prefill_round(self) -> None:
        """Drain the request queue: one fused step per length-bucket
        batch, in bucket order."""
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
        pages: List[int] = []
        slots: List[int] = []
        src: List[int] = []
        for i, r in enumerate(reqs):
            seq = self.cache.seqs[r.req_id]
            start = seq.shared_prefix_pages * self.cache.page_size
            p_i, s_i = self.cache.prefill_scatter_plan(seq, start=start)
            pages += p_i
            slots += s_i
            src += [i * sp + pos for pos in range(start, seq.length)]
        n_valid = len(pages)
        N = Bp * sp
        if n_valid:
            # pad entries duplicate entry 0: identical writes, a no-op
            pages += [pages[0]] * (N - n_valid)
            slots += [slots[0]] * (N - n_valid)
            src += [src[0]] * (N - n_valid)
        # the step reads the arena (shared prefixes): land the backlog
        self.cache.flush_pending()
        logits = _fused_prefill_step(
            self.cfg, self.pcfg, self.params, self._tensor(toks),
            self._tensor(lens), self.cache.k_arena, self.cache.v_arena,
            self._tensor(pages), self._tensor(slots),
            self._tensor(src, torch.long), has_writes=n_valid > 0)
        self.cache.commit_fused_prefill()
        for r in reqs:
            self.active[r.req_id] = r
        toks_np = self._choose([reqs[i].req_id for i in idx], logits)[:B]
        for i, r in enumerate(reqs):
            r.out_tokens.append(int(toks_np[i]))
            self.stats["prefills"] += 1
        self.stats["fused_prefill_dispatches"] += 1

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
        self.cache.commit_fused_round(rids)
        self.stats["fused_dispatches"] += 1
        return self._choose(prids, logits)[:B]

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
        return self._choose(rids, logits)


# ---------------------------------------------------------------------- #
# Forward passes (module functions, shared by the fused steps and the
# eager oracle)
# ---------------------------------------------------------------------- #


def _layer(gparams, li: int):
    """Layer ``li`` of the stacked ``group0`` tree (views, no copies)."""
    return tree_map(lambda a: a[li], gparams)


def _select_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy token choice: the first maximal logit, as ``jnp.argmax``
    picks it.  The D-RaNGe slice adds the sampled branch."""
    return torch.argmax(logits, dim=-1)


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


def _fused_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig, params,
                        toks, lens, k_arena, v_arena, pages, slots, src, *,
                        has_writes: bool) -> torch.Tensor:
    """Masked prefill forward + KV scatter of the whole batch.

    ``pages``/``slots``/``src`` are the host-side scatter plan (``B*S``
    flat entries): entry ``n`` writes the forward's K/V at flat source
    index ``src[n]`` to ``arena[:, pages[n], slots[n]]``.  The arenas
    are updated in place.  Returns the last-token logits (B, V)."""
    logits, k_all, v_all = _prefill_forward(cfg, pcfg, params, toks, lens)
    if has_writes:
        L, Bp, Sp = k_all.shape[:3]
        for arena, new_all in ((k_arena, k_all), (v_arena, v_all)):
            flat = new_all.reshape((L, Bp * Sp) + new_all.shape[3:])[:, src]
            rc_ops.kv_scatter_inline(arena, pages, slots, flat)
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
