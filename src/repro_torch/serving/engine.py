"""Continuous-batching serving engine over the paged PiM KV cache.

The port's counterpart of the dense path of the JAX package's
``serving/engine.py``.  Request lifecycle: queue -> prefill (KV written
into arena pages) -> decode rounds (paged attention over block tables,
one token per active sequence per round, new arrivals join between
rounds) -> finish (pages zeroed with RowClone-Init and freed).

Token choice: greedy rows (``temperature == 0``) take the first maximal
logit; sampled rows take a D-RaNGe inverse-CDF draw at their own
temperature, one uniform per row from the D-RaNGe generator kernel
(one launch a draw, pad rows folded in it, counted as ``random_u32``)
keyed by the engine's seed stream (``rng_seed + rng_ctr``, the counter
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

Every fused step is captured as a CUDA graph per shape bucket and
replayed (:mod:`.graphs`; ``cuda_graphs=True``, the default): the port's
counterpart of the JAX engine's one compiled step per bucket, keyed and
counted as JAX counts its retraces.  The decode round and the K-block's
round per (padded batch, block-table width) in ``stats["jit_traces"]``
and ``stats["block_jit_traces"]``; the prefill batch per (length
bucket, padded batch, writes KV) and the chunk step per (chunk bucket,
padded batch, table width, writes KV), both in
``stats["prefill_jit_traces"]``; the mixed round per (chunk operands,
decode operands) in ``stats["mixed_jit_traces"]``.  Token choice stays
outside the graphs (its seed is a host argument): a mixed round is two
replays, the chunk half and the decode half, with the chunk's choice
between them feeding the decode half's last tokens by a device copy,
and a K-block replays its round graph once per round, carrying lengths,
last tokens and the alive mask into the graph's static buffers by
device-to-device copies.  Every host-planned operand (tokens, lengths,
block tables, scatter plans, state rows) is loaded into a step's static
buffers through pinned memory.  ``cuda_graphs=False`` launches every
kernel from Python (the same keys and counts).

The layer loop is a Python loop where the JAX package used
``lax.scan``; arenas are updated in place where the JAX package donated
them.  ``fused=False`` keeps the eager decode oracle: the same forward,
with the round's KV written through the op queue's ``kv_write`` kind
instead of inside the step.

Prefix cache (``prefix_cache=True``): every prompt is created with its
tokens, so the cache's radix tree attaches the longest committed
full-page prefix; a prompt's full pages are indexed once they hold its
KV (after its prefill batch, or when its last chunk lands), and cold
prefixes evict LRU when the arena runs out.  The eviction inits are
only enqueued and land before the next step reads the arenas.

Hybrid layouts: the engine serves every single-group decoder of the
zoo without MLA: dense GQA, pure SSM (mamba2), hybrid attention + Mamba
+ MoE (jamba) and MoE (llama4-scout), with per-sublayer-kind dispatch
in one loop (:func:`_run_kinds`):

* attention sublayers keep the paged KV arenas as above (a pure-SSM
  model keeps a phantom full-depth KV pair whose pages are allocated
  and zeroed as the JAX package's are, and writes no KV);
* Mamba sublayers carry per-sequence recurrent state in the cache's
  :class:`~repro_torch.serving.kv_cache.PagedStateArena`: each gathers
  its rows of the batch, runs, and keeps its new state; after the
  forward, ONE ``state_scatter`` launch over both arenas (conv window,
  SSD state) writes the whole depth for the batch's unique real rows.  A
  mixed round scatters its chunk half's state before the decode half
  gathers, and a K-block's dead row writes its old state back;
* MoE sublayers route through the exact dense MoE (every token through
  every expert), as a host-local JAX engine does;
* the eager oracle writes its round's state through the op queue's
  ``ssm_state_write`` kind (one flush, one ``state_scatter`` launch
  over both arenas, which the queue counts as two, as JAX does).

Chunked prefill over Mamba layers splits prompts at multiples of
``cfg.ssm.chunk_size`` (the SSD chunk scan regroups exactly only
there), so ``max_prefill_chunk`` must be one.

A caller's :class:`~repro_torch.core.pimolib.TorchLib` (``lib=``) binds
the cache's arenas and shares its op queue and launch accounting; with
``record_trace=True`` the cache keeps a
:class:`~repro_torch.serving.trace.PimTrace`, which the fused steps feed
with their direct KV and state writes.

``fused_prefill=False`` keeps the eager prefill oracle (without
chunking): each request runs the dense reference forward
(:func:`repro_torch.models.transformer.forward`) into a fresh dense
cache, and its KV and Mamba state reach the arenas through the op queue
(the ``kv_scatter`` and ``state_scatter`` kernels).  The vlm family is
served as the JAX engine serves it: text-only, through the dense
layout.

Tensor-parallel serving (``mesh=``, a
:class:`~repro_torch.launch.mesh.Mesh` with a ``model`` axis): one
process per shard, every rank running the same host schedule
(allocator, block tables, op queue, chunk scheduler, token choice) and
holding only its slice of the parameters and arenas.  Parameters are
cut Megatron-style by ``models.params.param_specs`` under
``sharding_env(mesh, fsdp=False)`` (``heads`` / ``kv_heads`` / ``ff`` /
``vocab`` over ``model``), the KV arenas hold each rank's KV-head slice
of every page, and the forward runs on the local heads with the JAX
engine's collectives as ``all_reduce`` over the ``model`` subgroup:
vocab-parallel embedding and logits (each rank's rows or logit columns
placed in zeros and summed, exact), and the row-parallel attention-out
and MLP-down sums (the only float reordering against host-local
serving).  ``compressed_collectives=True`` sums the logits through
``distributed.compression.psum_compressed`` (int8 on the wire).  Each
step stays one counted dispatch, attributed to every shard's owner tag
(``kv/shard0`` ...), and token choice runs replicated from the full
logits, so every rank picks the same token.  Over NCCL the collectives
are captured inside each step's CUDA graph; gloo's run on the host and
cannot be captured, so a gloo mesh on the card needs
``cuda_graphs=False``.  Under a mesh the engine serves dense layouts
only (``ValueError`` for SSM and MoE, as the JAX engine refuses them).
The eager prefill oracle (``fused_prefill=False``), which the JAX
package runs on global arrays, runs the dense forward on the rank's
slices with the same collectives (``transformer.forward(tp=)``), its
dense cache the rank's KV-head slice.

Not served (``ValueError``, as the JAX package raises): MLA attention
and multi-group layouts.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.compression import psum_compressed
from repro_torch.kernels.drange import ops as dr_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.rowclone import ops as rc_ops
from repro_torch.kernels.rowclone.ops import upload
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as T
from repro_torch.models.layers import (apply_rope, cast, embed, logits_out,
                                       mlp, rmsnorm, rope_sincos)
from repro_torch.models.params import shard_params, tree_leaves, tree_map
from .graphs import StepCache
from .kv_cache import PagedKVCache, PagedStateArena, _bucket_pow2
from .spans import Tracer

MASK32 = 0xFFFFFFFF
Seed = Tuple[int, int]
_NP_DTYPES = {torch.int32: np.int32, torch.long: np.int64}


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
    """Paged serving engine for GQA (dense and vlm, text-only), SSM,
    hybrid and MoE decoders, on one device or, for dense layouts, one
    rank of a tensor-parallel mesh."""

    def __init__(self, cfg: ModelConfig, params, *, page_size: int = 16,
                 num_pages: int = 256, pcfg: Optional[ParallelConfig] = None,
                 seed: int = 0, device: DeviceLike = None, fused: bool = True,
                 fused_prefill: bool = True,
                 max_prefill_chunk: Optional[int] = None,
                 decode_block_rounds: int = 1, mixed_rounds: bool = True,
                 lib=None, record_trace: bool = False, mesh=None,
                 compressed_collectives: bool = False,
                 prefix_cache: bool = False, cuda_graphs: bool = True):
        if cfg.family not in ("dense", "vlm", "ssm", "hybrid", "moe"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not served (dense, vlm, ssm, "
                "hybrid and moe are, as the JAX engine serves them)")
        if cfg.mla is not None:
            raise ValueError(
                "paged engine: MLA latent-KV attention is not paged — "
                "deepseek-style archs serve through the dense path")
        if cfg.family == "hybrid" and cfg.num_layers < cfg.attn_every:
            raise ValueError(
                f"paged engine: a hybrid cut of {cfg.num_layers} layers "
                f"holds no attention layer (one in {cfg.attn_every}); cut "
                "to a whole period")
        if len(T.layer_groups(cfg)) != 1:
            raise ValueError(
                "paged engine: single-group layouts only (leading dense "
                "layers split the layer loop; set first_dense_layers=0)")
        kinds = T.layer_groups(cfg)[0][1]
        self._has_attn = "attn" in kinds
        self._has_ssm = "mamba" in kinds
        self._has_moe = "moe" in kinds
        if compressed_collectives and mesh is None:
            raise ValueError("compressed_collectives requires mesh=")
        if mesh is not None:
            self._check_mesh(cfg, mesh)
        if max_prefill_chunk is not None and max_prefill_chunk < 1:
            raise ValueError("max_prefill_chunk must be >= 1 (or None to "
                             "disable chunked prefill)")
        if max_prefill_chunk is not None:
            self._check_chunk_alignment(cfg, max_prefill_chunk)
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
        self.mesh = mesh
        self.compressed_collectives = compressed_collectives
        self._tp: Optional[_TP] = None
        if mesh is not None:
            if (cuda_graphs and self.device.type == "cuda"
                    and mesh.backend == "gloo"):
                raise ValueError(
                    "cuda_graphs=True with a gloo mesh: gloo's collectives "
                    "run on the host and cannot be captured in a CUDA "
                    "graph; pass cuda_graphs=False (or use nccl)")
            params = shard_params(params, T.model_defs(cfg), mesh)
            self._tp = _TP(mesh, compressed_collectives)
        self.params = params
        # lib: a caller's torch-face PimLib the cache binds its arenas to
        # (shared op queue and launch accounting); record_trace: keep a
        # PimTrace for model-face replay
        self.cache = PagedKVCache(cfg, num_pages=num_pages,
                                  page_size=page_size, device=self.device,
                                  lib=lib, record_trace=record_trace,
                                  mesh=mesh, prefix_cache=prefix_cache)
        self.fused = fused
        self.fused_prefill = fused_prefill
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
                      "prefix_evictions": 0,
                      "state_pages": 0, "state_forks": 0,
                      "prefix_declined_ssm": 0,
                      # step-cache misses (captures on the card), as the
                      # JAX engine counts its retraces
                      "jit_traces": 0, "block_jit_traces": 0,
                      "prefill_jit_traces": 0, "mixed_jit_traces": 0,
                      # host seconds of the prefill steps (a mixed round
                      # counts here) and of the decode rounds and blocks;
                      # each ends in its device-to-host token transfer,
                      # so they include the device work
                      "prefill_seconds": 0.0, "decode_seconds": 0.0}
        # the host spans (serving/spans.py): every span's total lands in
        # stats (prefill_seconds and decode_seconds among them)
        self.tracer = Tracer(self.stats)
        self.cache.tracer = self.tracer
        # decode tails already reserved this round
        self._reserved_tails: set = set()
        # every fused step, per shape bucket
        self._steps = StepCache(self.device, capture=cuda_graphs,
                                tracer=self.tracer, arenas=self._arenas)

    def _check_mesh(self, cfg: ModelConfig, mesh) -> None:
        """The JAX engine's refusals of a mesh it cannot serve."""
        if self._has_ssm or self._has_moe:
            raise ValueError(
                "paged engine: mesh= serving is dense-only (SSM state "
                "arenas and MoE routing are host-local)")
        if "model" not in dict(mesh.shape):
            raise ValueError("engine mesh needs a 'model' axis")
        n = mesh.shape["model"]
        bad = indivisible_dims(cfg, n)
        if bad:
            raise ValueError(f"model dims {bad} not divisible by mesh "
                             f"model axis {n}")

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
        self._check_chunk_alignment(self.cfg, n)
        self.max_prefill_chunk = int(n)

    def _check_chunk_alignment(self, cfg: ModelConfig, n: int) -> None:
        """Mamba layers need chunks at multiples of the SSD chunk size:
        the chunk scan regroups exactly only at its boundaries."""
        if self._has_ssm and n % cfg.ssm.chunk_size != 0:
            raise ValueError(
                f"max_prefill_chunk={n} must be a multiple of "
                f"cfg.ssm.chunk_size={cfg.ssm.chunk_size}: the SSD chunk "
                "scan only regroups exactly when prompts split at "
                "chunk-size boundaries")

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
        with self.tracer.run():
            return self._rounds(max_rounds)

    def _rounds(self, max_rounds: int) -> Dict[int, List[int]]:
        results: Dict[int, List[int]] = {}
        rounds = 0
        span = self.tracer.span
        while ((self.queue or self._chunk_q or self.active)
               and rounds < max_rounds):
            self.tracer.round += 1
            had_active = bool(self.active)
            decoded = False
            if self.queue or self._chunk_q:
                if self.active:
                    # reserve the decode tails now and dispatch their
                    # coalesced CoW copies ahead of the prefill host work
                    with span("engine.reserve"):
                        self._reserve_tails(sorted(self.active))
                        with span("pim.flush"):
                            self.cache.queue.flush_overlapped(
                                self.cache.lib.flush)
                with span("engine.prefill"):
                    if self._chunked:
                        prefill_toks, decoded = self._prefill_tick()
                    else:
                        prefill_toks = self._prefill_round()
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
                with span("engine.decode"):
                    rounds += self._decode_block(max_rounds - rounds)
                self._finish_done(results)
                continue
            if not decoded:
                with span("engine.decode"):
                    self._decode_round()
            rounds += 1
            self._finish_done(results)
        return results

    def _finish_done(self, results: Dict[int, List[int]]) -> None:
        with self.tracer.span("engine.finish"):
            # mirror the cache's prefix and state counters
            for key in ("prefix_hits", "prefix_hit_tokens",
                        "prefix_evictions", "state_pages", "state_forks",
                        "prefix_declined_ssm"):
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
        """Host data as ``dtype`` on the engine's device, uploaded
        without a synchronise."""
        return upload(np.asarray(a, _NP_DTYPES[dtype]), self.device)

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
        with self.tracer.span("engine.choose"):
            return self._choose(logits, np.asarray(temps, np.float32),
                                self._seed(self.rng_ctr))

    def _readback(self, tokens: torch.Tensor) -> np.ndarray:
        """The tokens on the host: the one wait for the card a step ends
        with."""
        with self.tracer.wait():
            return tokens.cpu().numpy()

    # --------------------------- prefill ------------------------------ #

    def _prefill_round(self) -> int:
        """Drain the request queue: one fused step per length-bucket
        batch, in bucket order, or the eager per-request oracle
        (:meth:`_prefill`) with ``fused_prefill=False``.  Returns the
        prompt tokens processed."""
        reqs, self.queue = self.queue, []
        if not self.fused_prefill:
            for r in reqs:
                self._prefill(r)
            return sum(len(r.prompt) for r in reqs)
        # create every sequence in submission order first, so shared
        # prefixes resolve across bucket groups; the radix cache matches
        # against prompts already committed (a batch cannot hit itself)
        for r in reqs:
            with self.tracer.span("engine.admit", r.req_id):
                self.cache.create(r.req_id, len(r.prompt),
                                  share_with=r.share_with,
                                  shared_len=r.shared_len, tokens=r.prompt)
        groups: Dict[int, List[Request]] = {}
        for r in reqs:
            groups.setdefault(_bucket_pow2(len(r.prompt)), []).append(r)
        for sp in sorted(groups):
            self._prefill_batch_fused(groups[sp], sp)
        return sum(len(r.prompt) for r in reqs)

    def _prefill(self, req: Request) -> None:
        """The eager per-request prefill, the fused path's oracle (the JAX
        engine's ``_prefill``): the dense :func:`~repro_torch.models.
        transformer.forward` over the prompt into a fresh dense cache
        (under a mesh on this rank's slices, the cache its KV-head
        slice, with the fused steps' collectives),
        then the prompt's KV past any shared prefix through the op queue
        (one ``kv_write`` flush: a ``kv_scatter`` launch), on Mamba
        layers the final state through the ``ssm_state_write`` kind
        (one flush: one ``state_scatter`` launch, accounted as one
        ``eager_ssm_layer`` launch per Mamba layer), and the first token
        through :meth:`_choose`, one draw per request."""
        with self.tracer.span("engine.admit", req.req_id):
            seq = self.cache.create(req.req_id, len(req.prompt),
                                    share_with=req.share_with,
                                    shared_len=req.shared_len,
                                    tokens=req.prompt)
        start = seq.shared_prefix_pages * self.cache.page_size
        n = len(req.prompt)
        cfg = self.cfg
        if self._tp is not None:
            # the dense cache holds this rank's KV-head slice, what its
            # arenas store
            cfg = dataclasses.replace(
                cfg, num_kv_heads=cfg.num_kv_heads // self._tp.world)
        cache = T.init_cache(cfg, 1, n, device=self.device)
        logits, dense, _ = T.forward(
            self.cfg, self.pcfg, self.params,
            {"tokens": self._tensor(np.asarray(req.prompt)[None])},
            mode="prefill", cache=cache, lengths=self._tensor([n]),
            tp=self._tp)
        g = dense["group0"]
        for key in (k for k in g if k.endswith("_attn")):
            k, v = g[key]                       # (L, 1, n, kvh, hd)
            self.cache.write_prompt_kv(seq, k[:, 0, start:n],
                                       v[:, 0, start:n], start=start)
        mamba = sorted((k for k in g if k.endswith("_mamba")),
                       key=lambda key: int(key.split("_")[0]))
        if mamba:
            st = self.cache.state
            self.cache.queue.count_external(
                "eager_ssm_layer", st.conv.shape[0] * st.conv.shape[1])
            st.write([req.req_id], torch.stack([g[k][0] for k in mamba], 1),
                     torch.stack([g[k][1] for k in mamba], 1))
        tok = self._sample(logits[:, -1], [req.temperature])
        req.out_tokens.append(int(self._readback(tok)[0]))
        self.active[req.req_id] = req
        self.stats["prefills"] += 1
        self.cache.commit_prefix(req.req_id, req.prompt)

    def _prefill_batch_fused(self, reqs: List[Request], sp: int) -> None:
        """One fused step for a same-length-bucket prefill batch."""
        span = self.tracer.span
        B = len(reqs)
        Bp = _bucket_pow2(B)
        idx = _pad_index(B, Bp)                 # pad rows duplicate req 0
        with span("engine.operands"):
            toks = np.zeros((Bp, sp), np.int32)
            lens = np.zeros((Bp,), np.int32)
            for row, i in enumerate(idx):
                toks[row, :len(reqs[i].prompt)] = reqs[i].prompt
                lens[row] = len(reqs[i].prompt)
            # host-side arena plan: (page, slot) per prompt token to
            # write, and its flat (row * sp + pos) index into the
            # forward's K/V
            plan = []
            for i, r in enumerate(reqs):
                seq = self.cache.seqs[r.req_id]
                start = seq.shared_prefix_pages * self.cache.page_size
                plan.append((i, seq, start, seq.length, 0))
            scatter, kv_plan = self._scatter_plan(plan, sp, Bp)
            # the step reads the arena (shared prefixes): land the
            # backlog, eviction inits from create-time arena pressure
            # included
            self.cache.flush_pending()
            writes = scatter is not None
            step = self._steps.get(
                "prefill_jit_traces", ("prefill", sp, Bp, writes),
                self._prefill_body,
                {"toks": ((Bp, sp), torch.int32),
                 "lens": ((Bp,), torch.int32),
                 **self._plan_specs(Bp, sp, writes)})
            step.load("toks", toks)
            step.load("lens", lens)
            self._load_plan(step, scatter, [reqs[i].req_id for i in idx], B)
        with self.tracer.launch():
            logits = step()
        with span("engine.commit"):
            self.cache.commit_fused_prefill(*kv_plan)
            if self._has_ssm:
                self.cache.state.record_fused_write([r.req_id for r in reqs])
        tokens = self._sample(logits, [reqs[i].temperature for i in idx])
        toks_np = self._readback(tokens[:B])    # the batch's one transfer
        with span("engine.commit"):
            for i, r in enumerate(reqs):
                r.out_tokens.append(int(toks_np[i]))
                self.active[r.req_id] = r
                self.stats["prefills"] += 1
                self.cache.commit_prefix(r.req_id, r.prompt)
            self.stats["fused_prefill_dispatches"] += 1

    def _scatter_plan(self, plan, sp: int, Bp: int):
        """Host operands of a batch's KV scatter.  ``plan`` holds one
        ``(row, seq, start, stop, first)`` per writing row: prompt
        positions ``[start, stop)`` go to their (page, slot), read from
        flat index ``row * sp + pos - first`` of the forward's K/V
        (``first``: the position of the forward's first token).  Pad
        entries duplicate entry 0 (identical writes, a no-op).  Returns
        ``(scatter, (pages, slots))``: the step's operands (pages, slots,
        src as int32, int32, int64 arrays), ``None`` when the batch
        writes nothing (every position shared, or no attention sublayer:
        a pure-SSM model writes no KV), and the host lists of the
        positions written, for the trace."""
        if not self._has_attn:
            return None, ([], [])
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
            return None, ([], [])
        pad = Bp * sp - len(pages)
        return ((np.asarray(pages + [pages[0]] * pad, np.int32),
                 np.asarray(slots + [slots[0]] * pad, np.int32),
                 np.asarray(src + [src[0]] * pad, np.int64)),
                (pages, slots))

    def _plan_specs(self, Bp: int, S: int, writes: bool) -> dict:
        """The static inputs of a step's scatter plan (``S`` tokens a
        row) and state rows."""
        specs = {}
        if writes:
            specs.update(pages=((Bp * S,), torch.int32),
                         slots=((Bp * S,), torch.int32),
                         src=((Bp * S,), torch.long))
        if self._has_ssm:
            specs.update(srows=((Bp,), torch.int32),
                         rowmap=((Bp,), torch.long))
        return specs

    def _load_plan(self, step, scatter, rids_padded: List[int],
                   n: int) -> None:
        """Load a step's scatter plan (``None``: it writes no KV) and the
        state rows of ``rids_padded``, whose first ``n`` rows are its
        unique real rows."""
        if scatter is not None:
            for name, a in zip(("pages", "slots", "src"), scatter):
                step.load(name, a)
        if self._has_ssm:
            step.load("srows", np.asarray(
                self.cache.state.rows_for(rids_padded), np.int32))
            step.load("rowmap", np.asarray(
                _pad_index(n, len(rids_padded)), np.int64))

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
        with self.tracer.span("engine.schedule"):
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
                with self.tracer.span("engine.mixed_round"):
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
            with self.tracer.span("engine.admit", r.req_id):
                seq = self.cache.create(r.req_id, len(r.prompt),
                                        share_with=r.share_with,
                                        shared_len=r.shared_len,
                                        tokens=r.prompt)
                off = seq.shared_prefix_pages * self.cache.page_size
                n = len(r.prompt)
                if off >= n:
                    st = _ChunkPrefill(r, n - 1, dep=r.share_with,
                                       dep_len=n, write=False)
                else:
                    st = _ChunkPrefill(r, off, dep=r.share_with,
                                       dep_len=off)
                self._chunk_q.append(st)
                self._chunk_by_id[r.req_id] = st

    def _chunk_operands(self, batch: List[tuple], sc: int) -> dict:
        """A chunk batch's host operands and scatter plan (pad rows
        duplicate row 0), and its step key (chunk bucket, ``Bp``, table
        width, writes KV).  The prefix block table spans each sequence's
        full page list with the committed length as its valid length."""
        B = len(batch)
        Bp = _bucket_pow2(B)
        idx = _pad_index(B, Bp)                 # pad rows duplicate row 0
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
        bt, plens = self.cache.block_table_host(
            rids, lengths=[int(o) for o in offs])
        plan = [(i, self.cache.seqs[st.req.req_id], st.off, st.off + clen,
                 st.off) for i, (st, clen) in enumerate(batch) if st.write]
        scatter, kv_plan = self._scatter_plan(plan, sc, Bp)
        writes = scatter is not None
        i32 = torch.int32
        specs = {"toks": ((Bp, sc), i32), "lens": ((Bp,), i32),
                 "offs": ((Bp,), i32), "bt": ((Bp, bt.shape[1]), i32),
                 "plens": ((Bp,), i32), **self._plan_specs(Bp, sc, writes)}
        return {"toks": toks, "lens": lens, "offs": offs, "bt": bt,
                "plens": plens, "scatter": scatter, "kv_plan": kv_plan,
                "temps": temps, "rids": rids, "n": B,
                "key": (sc, Bp, bt.shape[1], writes), "specs": specs}

    def _load_chunk(self, step, c: dict) -> None:
        for name in ("toks", "lens", "offs", "bt", "plens"):
            step.load(name, c[name])
        self._load_plan(step, c["scatter"], c["rids"], c["n"])

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
                    toks_np = self._readback(tokens)
                st.req.out_tokens.append(int(toks_np[i]))
                self.active[st.req.req_id] = st.req
                self.stats["prefills"] += 1
                del self._chunk_by_id[st.req.req_id]
                # the prompt's full pages now hold its KV: index them
                self.cache.commit_prefix(st.req.req_id, st.req.prompt)
            else:
                unfinished.append(st)
        return unfinished

    def _prefill_chunk_batch_fused(self, batch: List[tuple],
                                   sc: int) -> List[_ChunkPrefill]:
        """One fused step for a same-bucket batch of prefill chunks:
        prefix-KV chunk forward over the committed arena pages, chunk KV
        scatter, token choice.  Returns the unfinished chunk states."""
        span = self.tracer.span
        with span("engine.operands"):
            # the step reads the arena (prefix gather): land the backlog
            self.cache.flush_pending()
            c = self._chunk_operands(batch, sc)
            step = self._steps.get("prefill_jit_traces",
                                   ("chunk",) + c["key"], self._chunk_body,
                                   c["specs"])
            self._load_chunk(step, c)
        with self.tracer.launch():
            logits = step()
        tokens = self._sample(logits, c["temps"])
        with span("engine.commit"):
            self.cache.commit_fused_prefill(*c["kv_plan"])
            if self._has_ssm:
                self.cache.state.record_fused_write(
                    [st.req.req_id for st, _ in batch])
            self.stats["prefill_chunks"] += len(batch)
            self.stats["fused_prefill_dispatches"] += 1
            return self._finish_chunks(batch, tokens)

    def _mixed_round(self, batch: List[tuple], sc: int,
                     d_rids: List[int]) -> List[_ChunkPrefill]:
        """One fused step for a whole mixed round: the chunk batch, then
        the decode round over every active sequence plus every prompt
        finishing in this chunk, one step-cache key (two captured halves
        on the card, the chunk's token choice between them).  The
        chunk's scatter lands before the decode half reads the arena,
        and a finishing prompt's first token reaches the decode half on
        the device (``d_from``).  Both commits count nothing; the round
        is one ``fused_mixed`` launch.
        The seed stream advances twice (chunk, then decode), as two
        separate dispatches would.  A finishing row whose first token is
        its EOS drops its decode token (the KV written past its length
        dies with its pages).  Returns the unfinished chunk states."""
        span = self.tracer.span
        fin = {st.req.req_id: st.req for st, clen in batch
               if st.off + clen >= len(st.req.prompt)}
        reqmap = dict(self.active)
        reqmap.update(fin)
        # reserve every decode row's tail before planning the chunk
        # scatter (a CoW retarget must be seen by the plan), and land the
        # copies before the step reads the arena
        with span("engine.reserve"):
            self._reserve_tails(d_rids)
            self._reserved_tails.clear()
            self.cache.flush_pending()
        with span("engine.operands"):
            c = self._chunk_operands(batch, sc)
            row_of = {st.req.req_id: i for i, (st, _) in enumerate(batch)}
            B = len(d_rids)
            Bp = _bucket_pow2(B)
            prids = [d_rids[i] for i in _pad_index(B, Bp)]
            seqs = [self.cache.seqs[r] for r in prids]
            d_last = np.zeros((Bp,), np.int32)
            d_from = np.full((Bp,), -1, np.int32)
            d_temps = np.zeros((Bp,), np.float32)
            for row, rid in enumerate(prids):
                r = reqmap[rid]
                d_temps[row] = r.temperature
                if rid in fin:           # the token arrives on the device
                    d_from[row] = row_of[rid]
                else:
                    d_last[row] = r.out_tokens[-1]
            d_bt, d_lens = self.cache.block_table_host(prids)
            W = d_bt.shape[1]
            c_step, d_step = self._steps.get_many(
                "mixed_jit_traces", c["key"] + (Bp, W),
                [(self._chunk_body, c["specs"]),
                 (self._decode_body, self._specs(Bp, W, block=False))])
            # every decode operand is loaded before the chunk half is
            # enqueued: between the halves runs only the chunk's choice
            d_step.load("bt", d_bt)
            d_step.load("lens", d_lens)
            d_step.load("pages", np.asarray([s.pages[-1] for s in seqs],
                                            np.int32))
            d_step.load("slots", np.asarray(
                [s.length % self.cache.page_size for s in seqs], np.int32))
            self._load_plan(d_step, None, prids, B)
            d_from_t = self._tensor(d_from, torch.long)
            d_last_t = self._tensor(d_last, torch.long)
            self._load_chunk(c_step, c)
        with self.tracer.launch():
            c_logits = c_step()
        c_tokens = self._sample(c_logits, c["temps"])
        with span("engine.choose"):
            last = torch.where(d_from_t >= 0,
                               c_tokens[d_from_t.clamp(min=0)], d_last_t)
            d_step.load("last", last[:, None])
        # the chunk half's state scatter is enqueued before the decode
        # half gathers: a prompt finishing in this chunk decodes from its
        # own new state
        with self.tracer.launch():
            d_logits = d_step()
        d_tokens = self._sample(d_logits, d_temps)
        with span("engine.commit"):
            self.cache.commit_fused_prefill(*c["kv_plan"], kind=None)
            self.cache.commit_fused_round(d_rids, kind=None,
                                          wrote_kv=self._has_attn)
            if self._has_ssm:
                # both halves' state writes: the chunk rows' prefill
                # state and the decode rows' round state (one fused
                # launch)
                self.cache.state.record_fused_write(
                    [st.req.req_id for st, _ in batch])
                self.cache.state.record_fused_write(d_rids)
            # the whole round, chunk scatter included, was one launch
            self.cache.queue.count_external("fused_mixed")
            self.stats["prefill_chunks"] += len(batch)
            self.stats["mixed_dispatches"] += 1
            unfinished = self._finish_chunks(batch, c_tokens)
            d_toks = self._readback(d_tokens[:B])
            emitted = 0
            for i, rid in enumerate(d_rids):
                r = reqmap[rid]
                if (rid in fin and r.eos_token_id is not None
                        and r.out_tokens[-1] == r.eos_token_id):
                    continue   # the first token was EOS: drop this one
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

    def _state_round(self, rids_padded: List[int], n: int,
                     ) -> Optional["_StateRound"]:
        """The Mamba state operands of a forward over a (padded) row
        list whose first ``n`` rows are its unique real rows (the pad
        rows duplicate row 0); ``None`` without a state arena."""
        if not self._has_ssm:
            return None
        return self._state_of(
            self._tensor(self.cache.state.rows_for(rids_padded)),
            self._tensor(_pad_index(n, len(rids_padded)), torch.long))

    def _state_of(self, srows: Optional[torch.Tensor],
                  rowmap: Optional[torch.Tensor],
                  alive: Optional[torch.Tensor] = None,
                  ) -> Optional["_StateRound"]:
        """The state operands of a forward over state rows ``srows``
        (``rowmap``: see :class:`_StateRound`); a captured step makes
        them inside its body, so their new-state buffers come from the
        graphs' pool."""
        if not self._has_ssm:
            return None
        return _StateRound(self.cache.state, srows, rowmap, alive)

    def _arenas(self) -> List[torch.Tensor]:
        """Every buffer a captured step writes in place."""
        out = [self.cache.k_arena, self.cache.v_arena]
        if self.cache.state is not None:
            out += [self.cache.state.conv, self.cache.state.ssm]
        return out

    def _specs(self, Bp: int, W: int, block: bool) -> dict:
        """The static inputs of a decode (or K-block round) step."""
        i32 = torch.int32
        specs = {"last": ((Bp,), torch.long) if block else ((Bp, 1), i32),
                 "bt": ((Bp, W), i32), "lens": ((Bp,), i32),
                 "pages": ((Bp,), i32), "slots": ((Bp,), i32),
                 **self._plan_specs(Bp, 1, False)}
        if block:
            specs["alive"] = ((Bp,), torch.bool)
        return specs

    def _prefill_body(self, toks, lens, pages=None, slots=None, src=None,
                      srows=None, rowmap=None) -> torch.Tensor:
        return _fused_prefill_step(
            self.cfg, self.pcfg, self.params, toks, lens, self.cache.k_arena,
            self.cache.v_arena, _plan(pages, slots, src),
            self._state_of(srows, rowmap), tp=self._tp)

    def _chunk_body(self, toks, lens, offs, bt, plens, pages=None,
                    slots=None, src=None, srows=None,
                    rowmap=None) -> torch.Tensor:
        return _fused_chunk_prefill_step(
            self.cfg, self.pcfg, self.params, toks, lens, offs,
            self.cache.k_arena, self.cache.v_arena, bt, plens,
            _plan(pages, slots, src), self._state_of(srows, rowmap),
            tp=self._tp)

    def _decode_body(self, last, bt, lens, pages, slots, srows=None,
                     rowmap=None) -> torch.Tensor:
        return _fused_decode_step(
            self.cfg, self.pcfg, self.params, last, self.cache.k_arena,
            self.cache.v_arena, bt, lens, pages, slots,
            self._state_of(srows, rowmap), tp=self._tp)

    def _block_body(self, last, bt, lens, pages, slots, alive, srows=None,
                    rowmap=None) -> torch.Tensor:
        return _fused_block_round(
            self.cfg, self.pcfg, self.params, last, self.cache.k_arena,
            self.cache.v_arena, bt, lens, pages, slots, alive,
            self._state_of(srows, rowmap, alive), tp=self._tp)

    def _decode_round(self) -> None:
        if not self.active:
            return
        rids = sorted(self.active)
        # the round's CoW copies land in ONE batched launch per arena
        # before attention reads the arena
        with self.tracer.span("engine.reserve"):
            self._reserve_tails(rids)
            self._reserved_tails.clear()
            self.cache.flush_pending()
        if self.fused:
            toks = self._decode_round_fused(rids)
        else:
            toks = self._decode_round_eager(rids)
        with self.tracer.span("engine.commit"):
            for i, r in enumerate(rids):
                self.active[r].out_tokens.append(int(toks[i]))
            self.stats["decode_rounds"] += 1
            self.stats["tokens_out"] += len(rids)

    def _decode_round_fused(self, rids: List[int]) -> np.ndarray:
        """One fused step for the whole round (a replayed graph on the
        card); one host transfer."""
        span = self.tracer.span
        with span("engine.operands"):
            B = len(rids)
            Bp = _bucket_pow2(B)
            # pad rows duplicate sequence 0: wasted attention, and a
            # scatter of the same values to the same slot
            idx = _pad_index(B, Bp)
            prids = [rids[i] for i in idx]
            seqs = [self.cache.seqs[r] for r in prids]
            bt, lens = self.cache.block_table_host(prids)
            step = self._steps.get("jit_traces", (Bp, bt.shape[1]),
                                   self._decode_body,
                                   self._specs(Bp, bt.shape[1], block=False))
            step.load("last", np.asarray(
                [[self.active[r].out_tokens[-1]] for r in prids], np.int32))
            step.load("bt", bt)
            step.load("lens", lens)
            step.load("pages", np.asarray([s.pages[-1] for s in seqs],
                                          np.int32))
            step.load("slots", np.asarray(
                [s.length % self.cache.page_size for s in seqs], np.int32))
            self._load_plan(step, None, prids, B)
        with self.tracer.launch():
            logits = step()
        tokens = self._sample(logits,
                              [self.active[r].temperature for r in prids])
        with span("engine.commit"):
            self.cache.commit_fused_round(rids, wrote_kv=self._has_attn)
            if self._has_ssm:
                self.cache.state.record_fused_write(rids)
            self.stats["fused_dispatches"] += 1
        return self._readback(tokens[:B])

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
        with self.tracer.span("engine.block"):
            return self._block(rids, steps)

    def _block(self, rids: List[int], steps: List[int]) -> int:
        """The K-block of :meth:`_decode_block` over ``rids``, row ``i``
        running up to ``steps[i]`` rounds; returns the rounds consumed."""
        span = self.tracer.span
        K = self.decode_block_rounds
        with span("engine.reserve"):
            for r, n in zip(rids, steps):
                self.cache.reserve_tokens(self.cache.seqs[r], n)
            self._reserved_tails.clear()
            self.cache.flush_pending()
        with span("engine.operands"):
            B = len(rids)
            Bp = _bucket_pow2(B)
            idx = _pad_index(B, Bp)             # pad rows duplicate row 0
            prids = [rids[i] for i in idx]
            ps = self.cache.page_size
            # (round, row): each round's page and slot list is one
            # contiguous row, copied into the round step's inputs
            pages = np.zeros((K, Bp), np.int32)
            slots = np.zeros((K, Bp), np.int32)
            last = np.zeros((Bp,), np.int64)
            steps_arr = np.zeros((Bp,), np.int32)
            eos = np.full((Bp,), -1, np.int32)
            temps = np.zeros((Bp,), np.float32)
            for row, i in enumerate(idx):
                r = rids[i]
                req, seq, n = self.active[r], self.cache.seqs[r], steps[i]
                for t in range(K):
                    pos = seq.length + min(t, n - 1)
                    pages[t, row] = seq.pages[pos // ps]
                    slots[t, row] = pos % ps
                last[row] = req.out_tokens[-1]
                steps_arr[row] = n
                if req.eos_token_id is not None:
                    eos[row] = req.eos_token_id
                temps[row] = req.temperature
            # the table spans the reserved pages; lens stay the committed
            # lengths, carried forward round by round on the device
            bt, lens = self.cache.block_table_host(prids)
            self.rng_ctr += K
            seeds = [self._seed(self.rng_ctr - K + 1 + t)
                     for t in range(max(steps))]
            step = self._steps.get("block_jit_traces", (Bp, bt.shape[1]),
                                   self._block_body,
                                   self._specs(Bp, bt.shape[1], block=True))
            step.load("bt", bt)
            rowmap = self._tensor(idx, torch.long)
            if self._has_ssm:
                step.load("srows", np.asarray(
                    self.cache.state.rows_for(prids), np.int32))
                step.load("rowmap", rowmap)
            carry = [self._tensor(last, torch.long),
                     self._tensor(steps_arr), self._tensor(lens),
                     self._tensor(pages), self._tensor(slots),
                     self._tensor(eos)]
        tokens = _run_block(step, *carry, seeds, temps, rowmap,
                            self._choose, self.tracer)
        toks_np = self._readback(tokens[:B])    # the block's one transfer
        with span("engine.commit"):
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
                    if (req.eos_token_id is not None
                            and tok == req.eos_token_id):
                        break
                counts.append(n_i)
            consumed = max(counts)
            self.cache.commit_fused_block(rids, counts, rounds=consumed,
                                          wrote_kv=self._has_attn)
            if self._has_ssm:
                self.cache.state.record_fused_write(rids, rounds=consumed)
            self.stats["decode_rounds"] += consumed
            self.stats["tokens_out"] += sum(counts)
            self.stats["multi_round_blocks"] += 1
        return consumed

    def _decode_round_eager(self, rids: List[int]) -> np.ndarray:
        """The oracle: the same forward, with the round's KV written
        through the op queue (one ``kv_write`` flush) and its state
        through the ``ssm_state_write`` kind (one flush) instead of
        inside the step, and one launch per attention and per Mamba
        layer accounted as the JAX package accounts them."""
        last = self._tensor([[self.active[r].out_tokens[-1]] for r in rids])
        bt, lens = self.cache.block_table(rids)
        state = self._state_round(rids, len(rids))
        logits, k_new, v_new = _decode_forward(
            self.cfg, self.pcfg, self.params, last, self.cache.k_arena,
            self.cache.v_arena, bt, lens, state, tp=self._tp)
        if self._has_attn:
            self.cache.queue.count_external("eager_attn_layer",
                                            self.cache.n_layers)
            self.cache.write_token_kv_batch(rids, k_new, v_new)
        else:
            # a pure-SSM round writes no KV; the lengths still advance
            for r in rids:
                self.cache.seqs[r].length += 1
        if self._has_ssm:
            G, M = state.new_conv.shape[:2]
            self.cache.queue.count_external("eager_ssm_layer", G * M)
            self.cache.state.write(rids, state.new_conv, state.new_ssm)
        tokens = self._sample(logits,
                              [self.active[r].temperature for r in rids])
        return self._readback(tokens)


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
    # one launch: the (B, 1) draw, pad rows folded by ``rowmap``
    u = dr_ops.pim_random_uniform(seed, logits.shape[0], 1, dev,
                                  rowmap=rowmap).view(-1)
    t = upload(np.where(temps > 0.0, temps, np.float32(1.0)), dev)
    probs = torch.softmax(logits.float() / t[:, None], dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    drawn = torch.argmax((cum > u[:, None]).to(torch.uint8), dim=-1)
    return torch.where(upload(temps == 0.0, dev), greedy, drawn)


def indivisible_dims(cfg: ModelConfig, n: int) -> Dict[str, int]:
    """The model dims a tensor-parallel step over a model axis of ``n``
    ranks cannot split (empty: the engine serves ``cfg`` over it).  The
    spec would replicate a non-divisible dim, and the steps' sums would
    then count that path ``n`` times."""
    if n <= 1:
        return {}
    return {name: dim for name, dim in
            (("num_heads", cfg.num_heads), ("num_kv_heads", cfg.num_kv_heads),
             ("d_ff", cfg.d_ff), ("vocab_size", cfg.vocab_size))
            if dim % n != 0}


class _TP:
    """A tensor-parallel step's collectives over the mesh's ``model``
    axis (the JAX engine's ``psum``s inside its ``shard_map``)."""

    def __init__(self, mesh, compressed: bool) -> None:
        self.mesh = mesh
        self.compressed = compressed
        self.index = mesh.index("model")
        self.world = mesh.shape["model"]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(x, "model")

    def psum_logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.compressed:
            return psum_compressed(x, self.mesh, "model")
        return self.psum(x)

    # the vocab-parallel ends of the dense forward (``transformer.forward
    # (tp=)``, the eager prefill oracle under a mesh)
    def embed(self, p, tokens: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
        return _embed_tokens(p, tokens, cfg, self)

    def logits(self, p, x: torch.Tensor, cfg: ModelConfig,
               fp32: bool = True) -> torch.Tensor:
        return _logits_reduce(p, x, cfg, self, fp32)


def _embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig,
                  tp: Optional[_TP] = None) -> torch.Tensor:
    """Token embedding, host-local or vocab-parallel.  A rank holds
    vocab rows ``[index * V_local, (index + 1) * V_local)``: the rank
    owning a token contributes its (cast) row, every other rank exact
    zeros, so the sum is bit-identical to the host-local lookup."""
    if tp is None:
        return embed(p, tokens, cfg)
    vloc = p["tok"].shape[0]
    local = tokens.long() - tp.index * vloc
    ok = (local >= 0) & (local < vloc)
    x = cast(p["tok"][local.clamp(0, vloc - 1)])
    x = tp.psum(torch.where(ok[..., None], x, torch.zeros_like(x)))
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _logits_reduce(p, x: torch.Tensor, cfg: ModelConfig,
                   tp: Optional[_TP] = None, fp32: bool = True
                   ) -> torch.Tensor:
    """Output logits, host-local or vocab-parallel: each rank computes
    its (B, S, V_local) columns (the contraction over d_model is not
    split, so each is the host-local multiply-accumulate), places them
    at ``index * V_local`` in zeros and sums over the axis (exact), or
    through :func:`psum_compressed` (int8 on the wire, logits at
    quantization tolerance) when the engine compresses."""
    if tp is None:
        return logits_out(p, x, cfg, fp32=fp32)
    table = p.get("out", p["tok"])
    out = x @ cast(table).t()
    if fp32:
        out = out.float()
    vloc = table.shape[0]
    full = out.new_zeros(out.shape[:-1] + (vloc * tp.world,))
    full[..., tp.index * vloc:(tp.index + 1) * vloc] = out
    return tp.psum_logits(full)


def _sublayer(cfg: ModelConfig, kind: str, sp, x: torch.Tensor,
              sin: torch.Tensor, cos: torch.Tensor, attend: Callable,
              tp: Optional[_TP] = None):
    """One pre-normed decoder sublayer.  ``attend(q, k, v)`` runs the
    attention over the (b, s, h, hd) projections (the decode callers
    attend one token against the arena, the prefill callers run the
    length-masked flash kernel).  Returns (x, (k, v) | None).

    With ``tp`` the weights are this rank's slices (wq/wk/wv over its
    heads, wo and the MLP down projection row-parallel), so a layer's
    only collectives are the two residual-branch sums, and the k/v
    returned are the rank's KV-head slice, what its arenas store."""
    h = rmsnorm(x, sp["norm"], cfg.norm_eps)
    if kind == "mlp":
        y = mlp(sp["mlp"], h, cfg.activation)
        return x + (y if tp is None else tp.psum(y)), None
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
    if tp is not None:
        out = tp.psum(out)
    return x + out, (k, v)


class _StateRound:
    """One forward's Mamba state traffic.  Each Mamba sublayer gathers
    its rows of the batch (``rows``: the padded batch's state rows, on
    the device) from the arenas, runs, and keeps the new state of every
    row in (G, M, Bp, ...) buffers, row ``b`` holding the new state of
    row ``rowmap[b]`` (pad rows duplicate row 0, so they carry row 0's
    state bit for bit).  :meth:`scatter` then writes the whole depth
    with ONE ``state_scatter`` launch over both arenas, the pad rows'
    duplicate writes carrying identical payloads.  That is the JAX
    package's in-scan row set: each sublayer reads its rows once, before
    anything writes them.  ``alive`` (a K-block's row mask) makes a dead
    row keep its old state, as its KV slot does.  Nothing here depends
    on the count of real rows, so a captured step serves its whole
    bucket."""

    def __init__(self, arena: PagedStateArena, rows: torch.Tensor,
                 rowmap: torch.Tensor,
                 alive: Optional[torch.Tensor] = None) -> None:
        self.conv, self.ssm = arena.conv, arena.ssm
        self.rows = rows
        self.idx = rows.long()
        self.rowmap = rowmap
        self.alive = alive
        G, M = self.conv.shape[:2]
        Bp = rows.shape[0]
        dev = self.conv.device
        self.new_conv = torch.empty((G, M, Bp) + tuple(self.conv.shape[3:]),
                                    dtype=self.conv.dtype, device=dev)
        self.new_ssm = torch.empty((G, M, Bp) + tuple(self.ssm.shape[3:]),
                                   dtype=self.ssm.dtype, device=dev)

    def run(self, cfg: ModelConfig, pcfg: ParallelConfig, li: int, j: int,
            p, h: torch.Tensor, lens: Optional[torch.Tensor]):
        """Mamba sublayer ``j`` of layer ``li`` on the normed input
        ``h``: decode one token (``lens`` None) or the length-masked
        prefill from the rows' state.  Returns the sublayer's output.
        A decode's SSD step reads its rows in the arena and writes the
        new-state buffer itself (one ``ssd_step`` launch)."""
        conv_j = self.conv[li, j][self.idx]
        if lens is None:
            out, nc = ssm_mod.ssm_decode_rows(
                cfg, p, h, conv_state=conv_j, arena=self.ssm[li, j],
                rows=self.rows, rowmap=self.rowmap, alive=self.alive,
                out=self.new_ssm[li, j])
        else:
            ssm_j = self.ssm[li, j][self.idx]
            out, (nc, ns) = ssm_mod.ssm_layer_paged(
                cfg, pcfg, p, h, lengths=lens, conv_state=conv_j,
                ssm_state=ssm_j)
            ns = ns.to(self.ssm.dtype)
            if self.alive is not None:
                ns = torch.where(self.alive[:, None, None, None], ns, ssm_j)
            torch.index_select(ns, 0, self.rowmap, out=self.new_ssm[li, j])
        nc = nc.to(self.conv.dtype)
        if self.alive is not None:
            nc = torch.where(self.alive[:, None, None], nc, conv_j)
        torch.index_select(nc, 0, self.rowmap, out=self.new_conv[li, j])
        return out

    def scatter(self) -> None:
        """Write the whole depth's new rows of both arenas: one
        launch."""
        ssm_ops.state_scatter_pair_inline(self.conv, self.ssm, self.rows,
                                          self.new_conv, self.new_ssm)


def _plan(pages, slots, src):
    """A step's scatter plan from its inputs (``None``: no writes)."""
    return None if pages is None else (pages, slots, src)


def _pad_index(n: int, Bp: int) -> List[int]:
    """Rows of a batch of ``n`` padded to ``Bp``: pad rows repeat row 0."""
    return list(range(n)) + [0] * (Bp - n)


def _depth(cfg: ModelConfig) -> int:
    """Length of the layer loop (the stacked ``group0`` dim)."""
    return T.layer_groups(cfg)[0][0]


def _run_kinds(cfg: ModelConfig, p_layer, x: torch.Tensor, sin, cos,
               attend: Callable, state: Optional[_StateRound] = None,
               li: int = 0, lens: Optional[torch.Tensor] = None,
               pcfg: Optional[ParallelConfig] = None,
               tp: Optional[_TP] = None):
    """Layer ``li``'s sublayer sequence: the per-kind dispatch every
    forward follows.  ``attn``/``mlp`` run :func:`_sublayer`; ``mamba``
    runs through ``state`` (decode when ``lens`` is None, else the
    length-masked prefill); ``moe`` through the dense MoE (its router
    aux loss is a training term and is dropped).  Returns (x, the attn
    sublayer's (k, v) | None)."""
    kv_out = None
    j = 0
    for i, kind in enumerate(T.layer_groups(cfg)[0][1]):
        sp = p_layer[f"{i}_{kind}"]
        if kind == "mamba":
            h = rmsnorm(x, sp["norm"], cfg.norm_eps)
            x = x + state.run(cfg, pcfg, li, j, sp["ssm"], h, lens)
            j += 1
        elif kind == "moe":
            h = rmsnorm(x, sp["norm"], cfg.norm_eps)
            out, _aux = moe_mod.moe_layer(cfg, pcfg, sp["moe"], h)
            x = x + out
        else:
            x, kv = _sublayer(cfg, kind, sp, x, sin, cos, attend, tp)
            if kv is not None:
                kv_out = kv
    return x, kv_out


def _stack(ts: List[torch.Tensor]) -> Optional[torch.Tensor]:
    return torch.stack(ts) if ts else None


def _prefill_forward(cfg: ModelConfig, pcfg: ParallelConfig, params,
                     toks: torch.Tensor, lens: torch.Tensor,
                     state: Optional[_StateRound] = None,
                     tp: Optional[_TP] = None):
    """Batched prefill forward over a length-padded prompt batch, with
    causal + per-sequence-length masked flash attention; Mamba
    sublayers run the length-masked scan from the rows' state (zero for
    a fresh sequence).

    toks: (B, S) int32; lens: (B,) valid lengths (>= 1).  Returns
    (last-real-token logits (B, V), k_all, v_all (L, B, S, kvh, hd), or
    ``None`` without attention)."""
    hd = cfg.resolved_head_dim
    B, S = toks.shape
    x = _embed_tokens(params["embed"], toks, cfg, tp)
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
    for li in range(_depth(cfg)):
        x, kv = _run_kinds(cfg, _layer(gparams, li), x, sin, cos, attend,
                           state, li, lens, pcfg, tp)
        if kv is not None:
            ks.append(kv[0])
            vs.append(kv[1])
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    # each row's last real token (pad rows mirror row 0, lens >= 1)
    x_last = x[torch.arange(B, device=x.device), lens.long() - 1][:, None]
    logits = _logits_reduce(params["embed"], x_last, cfg, tp,
                            fp32=pcfg.logits_fp32)
    return logits[:, 0], _stack(ks), _stack(vs)


def _scatter_kv(k_arena, v_arena, k_all, v_all, scatter) -> None:
    """Scatter a (chunk) prefill's K/V into the arenas, in place:
    ``scatter`` is the engine's (pages, slots, src) plan, entry ``n``
    writing the forward's K/V at flat index ``src[n]`` (over batch and
    sequence) to ``arena[:, pages[n], slots[n]]``; ``None`` writes
    nothing.  One kernel launch covers both arenas and every layer."""
    if scatter is None:
        return
    pages, slots, src = scatter
    L, Bp, Sp = k_all.shape[:3]
    k, v = (new_all.reshape((L, Bp * Sp) + new_all.shape[3:])[:, src]
            .to(k_arena.dtype) for new_all in (k_all, v_all))
    rc_ops.kv_scatter_pair_inline(k_arena, v_arena, pages, slots, k, v)


def _fused_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig, params,
                        toks, lens, k_arena, v_arena, scatter,
                        state: Optional[_StateRound] = None,
                        tp: Optional[_TP] = None) -> torch.Tensor:
    """Masked prefill forward, then the batch's KV scatter (see
    :func:`_scatter_kv`) and its state scatter.  Returns the last-token
    logits (B, V)."""
    logits, k_all, v_all = _prefill_forward(cfg, pcfg, params, toks, lens,
                                            state, tp)
    _scatter_kv(k_arena, v_arena, k_all, v_all, scatter)
    if state is not None:
        state.scatter()
    return logits


def _chunk_prefill_forward(cfg: ModelConfig, pcfg: ParallelConfig, params,
                           toks, lens, offs, k_arena, v_arena, bt, plens,
                           state: Optional[_StateRound] = None,
                           tp: Optional[_TP] = None):
    """Batched forward over one prefill chunk per row, with prefix-KV
    flash attention: each row's queries attend causally over the chunk
    and in full over the row's committed arena KV, gathered through its
    block table and masked at ``plens[b]``.  Mamba sublayers continue
    from the rows' committed state.

    toks: (B, S) int32 chunk tokens; lens: (B,) valid chunk lengths
    (>= 1); offs: (B,) position of each chunk's first token (RoPE); bt:
    (B, W) block tables; plens: (B,) committed prefix lengths.  Returns
    (last-real-token logits (B, V), k_all, v_all (L, B, S, kvh, hd) or
    ``None``)."""
    hd = cfg.resolved_head_dim
    B, S = toks.shape
    ps = k_arena.shape[2]
    W = bt.shape[1]
    x = _embed_tokens(params["embed"], toks, cfg, tp)
    positions = offs[:, None] + torch.arange(S, dtype=torch.int32,
                                             device=toks.device)[None]
    sin, cos = rope_sincos(positions, hd, cfg.rope_theta)
    btl = bt.long()
    gparams = params["group0"]
    ks, vs = [], []
    for li in range(_depth(cfg)):
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

        x, kv = _run_kinds(cfg, _layer(gparams, li), x, sin, cos, attend,
                           state, li, lens, pcfg, tp)
        if kv is not None:
            ks.append(kv[0])
            vs.append(kv[1])
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    x_last = x[torch.arange(B, device=x.device), lens.long() - 1][:, None]
    logits = _logits_reduce(params["embed"], x_last, cfg, tp,
                            fp32=pcfg.logits_fp32)
    return logits[:, 0], _stack(ks), _stack(vs)


def _fused_chunk_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig,
                              params, toks, lens, offs, k_arena, v_arena,
                              bt, plens, scatter,
                              state: Optional[_StateRound] = None,
                              tp: Optional[_TP] = None) -> torch.Tensor:
    """Chunk forward, then the chunk's KV and state scatters (after
    every layer's prefix gather has read the arena).  Returns the
    logits."""
    logits, k_all, v_all = _chunk_prefill_forward(
        cfg, pcfg, params, toks, lens, offs, k_arena, v_arena, bt, plens,
        state, tp)
    _scatter_kv(k_arena, v_arena, k_all, v_all, scatter)
    if state is not None:
        state.scatter()
    return logits


def _decode_forward(cfg: ModelConfig, pcfg: ParallelConfig, params,
                    tokens: torch.Tensor, k_arena: torch.Tensor,
                    v_arena: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor,
                    state: Optional[_StateRound] = None,
                    tp: Optional[_TP] = None):
    """Decoder forward for one token per sequence against the arenas:
    the paged-attention kernel per attention sublayer, the current
    token's K/V merged in-kernel; Mamba sublayers step their rows'
    state (kept in ``state`` until its scatter).  Returns (logits (B,
    V), k_new, v_new (L, B, kvh, hd) or ``None`` without attention)."""
    hd = cfg.resolved_head_dim
    x = _embed_tokens(params["embed"], tokens, cfg, tp)
    positions = lengths[:, None]            # the token's position == length
    sin, cos = rope_sincos(positions, hd, cfg.rope_theta)
    gparams = params["group0"]
    ks, vs = [], []
    for li in range(_depth(cfg)):
        k_l, v_l = k_arena[li], v_arena[li]

        def attend(q, k, v, k_l=k_l, v_l=v_l):
            o = pa_ops.paged_attention(
                q[:, 0].contiguous(), k_l, v_l, block_tables, lengths,
                sm_scale=hd ** -0.5, k_self=k[:, 0], v_self=v[:, 0])
            return o[:, None]

        x, kv = _run_kinds(cfg, _layer(gparams, li), x, sin, cos, attend,
                           state, li, pcfg=pcfg, tp=tp)
        if kv is not None:
            ks.append(kv[0][:, 0])
            vs.append(kv[1][:, 0])
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits_reduce(params["embed"], x, cfg, tp)
    return logits[:, 0], _stack(ks), _stack(vs)


def _fused_decode_step(cfg: ModelConfig, pcfg: ParallelConfig, params, last,
                       k_arena, v_arena, bt, lens, pages, slots,
                       state: Optional[_StateRound] = None,
                       tp: Optional[_TP] = None) -> torch.Tensor:
    """Decode forward, then the round's KV scatter (one launch for both
    arenas) and state scatter (one per arena), each covering every
    layer, arenas updated in place.  A pure-SSM round writes no KV.
    Returns the logits (B, V)."""
    logits, k_new, v_new = _decode_forward(cfg, pcfg, params, last, k_arena,
                                           v_arena, bt, lens, state, tp)
    if k_new is not None:
        rc_ops.kv_scatter_pair_inline(k_arena, v_arena, pages, slots,
                                      k_new.to(k_arena.dtype),
                                      v_new.to(v_arena.dtype))
    if state is not None:
        state.scatter()
    return logits


def _fused_block_round(cfg: ModelConfig, pcfg: ParallelConfig, params,
                       last, k_arena, v_arena, bt, lens, pages, slots, alive,
                       state: Optional[_StateRound] = None,
                       tp: Optional[_TP] = None) -> torch.Tensor:
    """One round of a K-block: forward at the carried lengths, a masked
    KV scatter (a stopped row writes its slot's current value back, so
    the arena stays bit-identical to round-at-a-time decoding) and the
    round's state scatter (``state`` carries ``alive``: a stopped row
    keeps its state).  last, lens, pages, slots, alive: (Bp,).  Returns
    the logits (Bp, V)."""
    logits, k_new, v_new = _decode_forward(cfg, pcfg, params, last[:, None],
                                           k_arena, v_arena, bt, lens, state,
                                           tp)
    if k_new is not None:
        keep = alive[None, :, None, None]
        k_val, v_val = (torch.where(keep, new.to(arena.dtype),
                                    rc_ops.kv_gather_inline(arena, pages,
                                                            slots))
                        for arena, new in ((k_arena, k_new),
                                           (v_arena, v_new)))
        rc_ops.kv_scatter_pair_inline(k_arena, v_arena, pages, slots, k_val,
                                      v_val)
    if state is not None:
        state.scatter()
    return logits


def _run_block(step, last, steps, lens, pages, slots, eos, seeds, temps,
               rowmap, choose: Callable, tracer: Tracer) -> torch.Tensor:
    """Up to K decode rounds with one host transfer at the end: a Python
    loop over ``len(seeds)`` rounds (the block's longest row), each one
    call of ``step`` (:func:`_fused_block_round` on the round's inputs,
    a replayed graph on the card), whose carry — lengths, last tokens,
    the alive mask, the (B, K) token buffer — stays on the device and is
    loaded into the step by device copies, so the host never waits
    inside the block.  After round ``t``: token choice at ``seeds[t]``
    with ``rowmap`` folding pad rows onto row 0, then the stop rule (a
    row stops after ``steps`` tokens or its EOS).  pages, slots: (K,
    Bp).  Tokens after a row stopped are -1; a row that stopped early
    only runs masked.  ``tracer`` records each round's loads, replay and
    choice (with the carry's update) as spans.  Returns the (B, K)
    tokens."""
    K, Bp = pages.shape
    alive = steps > 0
    toks = torch.full((Bp, K), -1, dtype=torch.long, device=last.device)
    for t, seed in enumerate(seeds):
        with tracer.span("engine.operands"):
            for name, value in (("last", last), ("lens", lens),
                                ("pages", pages[t]), ("slots", slots[t]),
                                ("alive", alive)):
                step.load(name, value)
        with tracer.launch():
            logits = step()
        with tracer.span("engine.choose"):
            raw = choose(logits, temps, seed, rowmap=rowmap).long()
            toks[:, t] = torch.where(alive, raw, -1)
            lens = lens + alive.to(lens.dtype)
            last = torch.where(alive, raw, last)
            hit_eos = alive & (eos >= 0) & (raw == eos)
            alive = alive & ((t + 1) < steps) & ~hit_eos
    return toks
