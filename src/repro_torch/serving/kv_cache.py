"""Paged KV cache on the PiM arena — where PiDRAM's memory management
meets serving.  The port's counterpart of the dense part of the JAX
package's ``serving/kv_cache.py``.

Pages (the DRAM-row analogue) come from a :class:`SubarrayAllocator`
over the KV arena:

* **allocation constraints** — a sequence's pages prefer one slab
  (subarray), and copy-on-write forks allocate the destination page in
  the source's slab, so the copy is a RowClone page copy;
* **init-on-free** — freed pages are zeroed with a RowClone-Init page
  init, so no request can read another's KV;
* **prefix sharing** — refcounted pages let requests share a prompt
  prefix: automatically through the radix prefix cache
  (``prefix_cache=True``, ``create(..., tokens=)``, ``commit_prefix``,
  LRU eviction of cold prefixes under arena pressure, ``clear_prefix``),
  or pairwise by naming a live source (``share_with``/``shared_len``);
  CoW forking copies only the partial tail;
* **Ambit zero-compare** (``zero_scan=True`` or
  :meth:`PagedKVCache.enable_zero_scan`) — ``free()`` scans a dying
  sequence's exclusive pages and skips the init of pages already zero,
  and ``clear_prefix()`` audits that every page it freed holds zero
  bits.

* **paged recurrent state** (ssm and hybrid families) — a
  :class:`PagedStateArena` beside the KV pair holds one constant-size
  row per sequence (its full-depth conv window and SSD state); a prefix
  hit is declined, since recurrent state depends on every position.

The arenas are (layers, pages, page_size, kvh, hd) tensors on one
device; "layers" is the engine's layer loop (a hybrid superblock has
one attention sublayer, and a pure-SSM model keeps a phantom
full-depth pair, as the JAX package does).  Every mutation routes through a :class:`TorchLib` and its
batched op queue, one coalesced launch per op kind; the engine's fused
decode round, K-round decode block and fused prefill or chunk batch
scatter their KV themselves and report it with
:meth:`PagedKVCache.commit_fused_round`,
:meth:`PagedKVCache.commit_fused_block` and
:meth:`PagedKVCache.commit_fused_prefill`.

With ``record_trace=True`` the cache keeps a
:class:`repro_torch.serving.trace.PimTrace` of every coalesced mutation
batch (the queue's flush hook) and of the fused steps' direct writes,
prefix hits and zero scans, which
:func:`repro_torch.serving.trace.replay_on_device` prices on the
simulated DDR3 prototype.

Tensor-parallel serving (``mesh=``, one process per shard): each
rank's K/V arenas hold its ``num_kv_heads / N`` KV heads of every page
(dim 3), N the mesh's ``model`` extent, while page ids, block tables,
the prefix tree and the op queue are mesh-wide and identical on every
rank (each rank runs the same host schedule).  The lib is tagged
``kv`` and, at N > 1, attributes each launch to ``kv/shard0`` ...
``kv/shard{N-1}``.  The zero-compare scan reduces its per-rank flags
over the mesh (a page is zero when every rank's slice is).  A
``num_kv_heads`` that N does not divide is refused.
"""

from __future__ import annotations

import warnings
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocator import (PimAllocError, SubarrayAllocator,
                                        arena_groups)
from repro_torch.core.op_registry import (StateWriteBatch,
                                          group_inits_by_value)
from repro_torch.core.pimolib import TorchLib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ambit import ops as amb_ops
from repro_torch.kernels.rowclone.ops import upload, upload_index
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models import transformer as T
from .prefix_cache import RadixPrefixCache
from .spans import Tracer
from .trace import PimTrace


@dataclass
class Sequence:
    seq_id: int
    pages: List[int] = field(default_factory=list)
    length: int = 0
    shared_prefix_pages: int = 0


def _weakly(method):
    """``method`` (bound) as a callback that holds its object weakly: a
    queue or prefix tree the object owns keeps no cycle back to it, so a
    dropped cache frees its arenas at once, not at a cyclic collection."""
    ref = weakref.WeakMethod(method)

    def call(*args):
        return ref()(*args)
    return call


class PagedStateArena:
    """Paged recurrent state for SSM and hybrid layouts: the KV arena's
    constant-size sibling.

    A sequence's Mamba state never grows: one arena row (slot) holds its
    full-depth conv window and SSD state for its whole life.  So there
    is no growth (one slot at ``create``), no prefix sharing (the owning
    cache declines prefix hits), and a fork copies the whole row at
    once (copy-on-fork, a RowClone copy).

    Mutations route through the owning cache's op queue under three
    kinds, each flushed as one launch per arena whatever the depth or
    batch (``state_copy`` and ``ssm_state_write`` as one launch over
    both, accounted as two): ``ssm_state_write`` (the eager round's
    state write, through the ``state_scatter`` kernel), ``state_copy`` (copy-on-fork) and
    ``state_init`` (init-on-free, so a fresh slot is zero and no request
    sees another's state).  Hazard rows are ``("state", slot)`` tuples,
    which never collide with KV page ids: a fork's ``state_copy`` that
    reads a slot with a pending ``ssm_state_write`` flushes it first.

    The arenas are ``(groups, mamba_sublayers, slots, ...)``: the conv
    window in the cache dtype, the SSD state in float32 (the recurrence
    accumulates).  The engine's fused steps write their rows in place
    themselves; only the eager oracle writes through the queue."""

    def __init__(self, cfg: ModelConfig, *, num_slots: int, queue, lib,
                 device: torch.device, trace: Optional[PimTrace] = None,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        G, M = _mamba_layout(cfg)
        if M == 0:
            raise ValueError("a state arena needs a mamba sublayer")
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        nheads = d_in // s.head_dim
        ch = d_in + 2 * s.state_dim
        self.num_slots = num_slots
        self.conv = torch.zeros((G, M, num_slots, s.conv_width - 1, ch),
                                dtype=dtype, device=device)
        self.ssm = torch.zeros((G, M, num_slots, nheads, s.head_dim,
                                s.state_dim), dtype=torch.float32,
                               device=device)
        self.queue = queue
        self.lib = lib
        self.trace = trace
        if trace is not None:
            trace.num_state_rows = num_slots
        self.rows: Dict[int, int] = {}         # seq_id -> slot
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        queue.register_kind("ssm_state_write", _weakly(self._flush_write))
        queue.register_kind("state_copy", _weakly(self._flush_copy))
        queue.register_kind("state_init", _weakly(self._flush_init))

    # -- queue flush executors (arena-bound; the KV arenas pass through)

    def _flush_write(self, q, arenas, ops: List[StateWriteBatch]):
        # host rows: they travel in the launch's parameters
        rows = [r for o in ops for r in o.rows]
        if len(ops) == 1:
            conv, ssm = ops[0].conv, ops[0].ssm
        else:
            conv = torch.cat([o.conv for o in ops], dim=2)
            ssm = torch.cat([o.ssm for o in ops], dim=2)
        # one launch over both arenas; accounted as two, one per arena,
        # as the JAX package counts them
        ssm_ops.state_scatter_pair_inline(self.conv, self.ssm, rows, conv,
                                          ssm)
        q._count_launch("ssm_state_write", 2)
        return arenas

    def _flush_copy(self, q, arenas, ops):
        src = [s for s, _ in ops]
        dst = [d for _, d in ops]
        # one launch over both arenas; accounted as two, one per arena,
        # as the JAX package counts them
        ssm_ops.pim_state_copy_pair(self.conv, self.ssm, src, dst)
        q._count_launch("state_copy", 2)
        return arenas

    def _flush_init(self, q, arenas, ops):
        for value, rows in group_inits_by_value(ops).items():
            ssm_ops.pim_state_init(self.conv, rows, value)
            ssm_ops.pim_state_init(self.ssm, rows, value)
            q._count_launch("state_init", 2)
        return arenas

    # -- slot ledger ----------------------------------------------------- #

    def alloc(self, seq_id: int) -> int:
        """One slot per sequence; it is already zero (init-on-free ran
        when its last owner died), so allocation launches nothing."""
        if not self._free:
            raise PimAllocError("state arena out of slots")
        slot = self._free.pop()
        self.rows[seq_id] = slot
        return slot

    def fork(self, src_id: int, dst_id: int) -> int:
        """Copy-on-fork: duplicate the parent's whole row.  The copy is
        only enqueued (the owning cache's fork flush coalesces it with
        the KV tail copy); ``admit`` first flushes a pending write to the
        source slot."""
        src = self.rows[src_id]
        dst = self.alloc(dst_id)
        self.queue.admit("state_copy", (("state", dst),), self.lib.flush,
                         reads=(("state", src),))
        self.queue.enqueue("state_copy", (src, dst))
        return dst

    def free(self, seq_id: int) -> None:
        """Release a slot; it zeroes through the queue at the caller's
        flush (one RowClone-Init launch per arena)."""
        slot = self.rows.pop(seq_id)
        self.queue.admit("state_init", (("state", slot),), self.lib.flush)
        self.queue.enqueue("state_init", (slot, 0.0))
        self._free.append(slot)

    def rows_for(self, seq_ids: Seq[int]) -> List[int]:
        return [self.rows[sid] for sid in seq_ids]

    @property
    def rows_in_use(self) -> int:
        return len(self.rows)

    def _row_bytes(self) -> int:
        """Bytes of one slot across the whole depth (conv + SSD state)."""
        G, M = self.conv.shape[:2]
        conv_elems = int(np.prod(self.conv.shape[3:]))
        ssm_elems = int(np.prod(self.ssm.shape[3:]))
        return G * M * (conv_elems * self.conv.element_size()
                        + ssm_elems * self.ssm.element_size())

    def record_fused_write(self, seq_ids: Seq[int], *,
                           rounds: int = 1) -> None:
        """A fused step wrote these sequences' rows itself: give the
        trace its state-write event."""
        if self.trace is not None and seq_ids:
            rows = self.rows_for(seq_ids)
            self.trace.record_state_write(
                rows, nbytes=len(rows) * self._row_bytes(), rounds=rounds)

    # -- mutation and read entry points ---------------------------------- #

    def write(self, seq_ids: Seq[int], conv: torch.Tensor,
              ssm: torch.Tensor, *, flush: bool = True) -> None:
        """The eager round's write: conv/ssm are (groups, sublayers,
        batch, ...) fresh states, one batch entry per sequence, enqueued
        as one stacked record and flushed unless the caller defers."""
        rows = self.rows_for(seq_ids)
        self.queue.admit("ssm_state_write", [("state", r) for r in rows],
                         self.lib.flush)
        batch = StateWriteBatch(rows, conv.to(self.conv.dtype),
                                ssm.to(self.ssm.dtype))
        self.queue.enqueue("ssm_state_write", batch, n_ops=batch.n)
        if flush:
            self.lib.flush()

    def gather(self, seq_ids: Seq[int]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(conv, ssm) rows of ``seq_ids``, stacked (groups, sublayers,
        batch, ...), after the pending mutations land."""
        self.lib.flush()
        rows = upload_index(self.rows_for(seq_ids), self.num_slots,
                            "state row", self.ssm.device)
        return (ssm_ops.state_gather_inline(self.conv, rows),
                ssm_ops.state_gather_inline(self.ssm, rows))


class PagedKVCache:
    def __init__(self, cfg: ModelConfig, *, num_pages: int = 128,
                 page_size: int = 16, num_slabs: int = 4,
                 dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, lib: Optional[TorchLib] = None,
                 record_trace: bool = False, mesh=None,
                 prefix_cache: bool = False, zero_scan: bool = False,
                 state_slots: Optional[int] = None):
        if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid") \
                or cfg.mla is not None:
            raise NotImplementedError(
                f"family {cfg.family!r} (mla={cfg.mla is not None}): the "
                "port's KV cache serves dense, vlm, moe, ssm and hybrid "
                "layouts without MLA")
        if num_pages % num_slabs:
            raise ValueError("num_pages must be a multiple of num_slabs")
        self.cfg = cfg
        self.page_size = page_size
        self.dtype = dtype
        self.device = resolve_device(device)
        self.n_layers = _num_attn_layers(cfg)
        kvh = cfg.num_kv_heads
        # sharded serving: this rank's arenas hold its KV-head slice of
        # every page (see the module docstring)
        self.mesh = mesh
        n_shard = mesh.shape["model"] if mesh is not None else 1
        if n_shard > 1 and kvh % n_shard != 0:
            raise ValueError(f"num_kv_heads={kvh} not divisible by mesh "
                             f"model axis {n_shard}")
        shape = (self.n_layers, num_pages, page_size, kvh // n_shard,
                 cfg.resolved_head_dim)
        k0 = torch.zeros(shape, dtype=dtype, device=self.device)
        v0 = torch.zeros(shape, dtype=dtype, device=self.device)
        self.allocator = SubarrayAllocator(
            arena_groups(num_slabs, num_pages // num_slabs))
        shard_kw = dict(shard_axis=3, mesh=mesh) if n_shard > 1 else {}
        if lib is None:
            lib = TorchLib(buffers=[k0, v0], layered=True,
                           allocator=self.allocator, deferred=True,
                           tag="kv", **shard_kw)
        else:
            if lib.face != "torch":
                raise ValueError(
                    f"PagedKVCache needs a torch-face PimLib, got "
                    f"{lib.face!r} (replay a recorded trace for model-face "
                    "accounting)")
            lib.adopt_buffers([k0, v0], layered=True,
                              allocator=self.allocator, **shard_kw)
        self.lib = lib
        self.queue = lib.queue
        self.refcount: Dict[int, int] = {}
        self.page_alloc: Dict[int, object] = {}
        self.seqs: Dict[int, Sequence] = {}
        self.stats = {"cow_copies": 0, "pages_zeroed": 0, "prefix_hits": 0,
                      "prefix_hit_tokens": 0, "prefix_evictions": 0,
                      "init_skips_zero": 0, "zero_audit_pages": 0,
                      "zero_audit_failures": 0,
                      "state_pages": 0, "state_forks": 0,
                      "prefix_declined_ssm": 0}
        # the Ambit zero-compare paths (off by default: the scans add
        # read-only launches); _known_zero holds pages a scan found
        # all-zero, whose init-on-free is skipped
        self.zero_scan = zero_scan
        self._known_zero: set = set()
        # the radix prefix cache holds its own reference on every page
        # it indexes; eviction releases it through init-on-free
        self.prefix: Optional[RadixPrefixCache] = None
        if prefix_cache:
            self.prefix = RadixPrefixCache(
                page_size, retain=_weakly(self._retain_page),
                release=_weakly(self._release_evicted_prefix_page))
        # host spans (serving/spans.py): an engine binds its own tracer,
        # whose totals land in the engine's stats; a cache on its own
        # keeps them apart from ``stats``
        self.tracer = Tracer({})
        self.trace: Optional[PimTrace] = None
        if record_trace:
            self.trace = PimTrace(num_pages=num_pages, num_slabs=num_slabs,
                                  page_size=page_size,
                                  kv_itemsize=k0.element_size())
        # always (re)bind, so a lib reused from an earlier cache does not
        # keep recording into that cache's trace
        self.queue.trace = self.trace
        # ssm and hybrid layouts: one state row per sequence, beside the
        # KV pair (not among the lib's buffers: the kv_write flush is a
        # (k, v) contract); the arena binds its own queue kinds
        self.state: Optional[PagedStateArena] = None
        if _mamba_layout(cfg)[1] > 0:
            self.state = PagedStateArena(
                cfg, num_slots=state_slots or num_pages, queue=self.queue,
                lib=self.lib, device=self.device, trace=self.trace,
                dtype=dtype)

    # the arenas live on the lib (a shared lib sees every mutation)
    @property
    def k_arena(self) -> torch.Tensor:
        return self.lib.buffers[0]

    @property
    def v_arena(self) -> torch.Tensor:
        return self.lib.buffers[1]

    # ------------------------- page management ------------------------ #

    def _try_alloc(self, near: Optional[int] = None):
        if near is not None and near in self.page_alloc:
            try:
                return self.allocator.alloc(
                    1, group=self.page_alloc[near].group)
            except PimAllocError:
                pass
        return self.allocator.alloc(1)

    def _alloc_page(self, near: Optional[int] = None) -> int:
        try:
            a = self._try_alloc(near)
        except PimAllocError:
            # arena full: evict cold prefix-cache leaves (LRU) until a
            # page frees up.  Evicting a node whose page a live sequence
            # still shares only drops the tree's reference, so keep
            # evicting until the allocator yields or the tree runs dry.
            if self.prefix is None:
                raise
            while True:
                if self.prefix.evict_lru(1) == 0:
                    raise
                try:
                    a = self._try_alloc(near)
                    break
                except PimAllocError:
                    continue
        page = a.rows[0]
        self.page_alloc[page] = a
        self.refcount[page] = 1
        return page

    def _retain_page(self, page: int) -> None:
        """Prefix-tree retain hook: the tree takes its own reference."""
        self.refcount[page] += 1

    def _release_evicted_prefix_page(self, page: int) -> None:
        """Prefix-tree release hook (a node evicted): drop the tree's
        reference; an unshared page zeroes and frees through the batched
        init-on-free path.  The init is only enqueued: the next flush
        point (every step flushes before it reads the arenas) coalesces a
        whole eviction sweep into one launch."""
        self.stats["prefix_evictions"] += 1
        self._release_page(page)

    def _release_page(self, page: int) -> None:
        """Drop a reference; on the last one, enqueue a batched
        RowClone-Init (zero without reading) and return the page to the
        allocator.  The caller flushes.  A page the zero-compare scan
        just found all-zero skips its init, booked as saved work."""
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            if page in self._known_zero:
                self._known_zero.discard(page)
                self.queue.record_saved("page_init", 1)
                self.stats["init_skips_zero"] += 1
            else:
                self.queue.admit("page_init", (page,), self.lib.flush)
                self.queue.enqueue_init(page)
            self.stats["pages_zeroed"] += 1
            self.allocator.free(self.page_alloc.pop(page))
            del self.refcount[page]

    def flush_pending(self) -> None:
        """Drain the op queue: one coalesced launch per pending op kind."""
        with self.tracer.span("pim.flush"):
            self.lib.flush()

    # --------------------- Ambit zero-compare scan --------------------- #

    def enable_zero_scan(self) -> None:
        """Turn on the Ambit zero-compare paths: ``free()`` scans a
        dying sequence's exclusive pages (pages already zero skip their
        init-on-free) and ``clear_prefix()`` audits that every page it
        freed holds zero bits."""
        self.zero_scan = True

    def scan_zero_pages(self, pages) -> np.ndarray:
        """Batched zero-compare over ``pages``: one read-only launch over
        the (k, v) pair whatever the batch, after the pending mutations
        land, counted as the JAX cache counts it (one launch per arena).
        Returns bool (n,) on the host, True where the page holds
        all-zero bits in both arenas; reading it waits once for the
        card."""
        idx = np.asarray(list(pages), np.int32)
        if idx.size == 0:
            return np.zeros((0,), bool)
        self.flush_pending()
        k, v = self.lib.buffers
        # the scan's one launch, then its wait for the card
        with self.tracer.wait():
            flags = amb_ops.pim_page_zero_scan_pair(k, v, idx)
            if self.mesh is not None:
                # a page is zero when every rank's head slice is
                t = torch.from_numpy(flags.astype(np.uint8)).to(k.device)
                self.mesh.all_reduce(t, "model", op="min")
                flags = t.cpu().numpy().astype(bool)
        self.queue.count_external("page_zero_scan", len(self.lib.buffers))
        if self.trace is not None:
            self.trace.record_zero_scan(idx)
        return flags

    # ------------------------- sequence API ---------------------------- #

    def create(self, seq_id: int, prompt_len: int,
               share_with: Optional[int] = None,
               shared_len: int = 0,
               tokens: Optional[Seq[int]] = None) -> Sequence:
        """Create a sequence, attaching any shareable prompt prefix
        (refcount++ per page, no compute, no writes).

        ``tokens`` (the prompt's token ids) is the automatic path: the
        radix prefix cache matches the prompt's longest committed
        full-page prefix.  ``share_with``/``shared_len`` is the pairwise
        path (the first ``shared_len // page_size`` pages of a live
        sequence); with a prefix cache on it warns
        ``DeprecationWarning``, since mixing both splits the hit
        accounting.  A cache with a state arena declines every prefix
        hit (counted in ``prefix_declined_ssm``): the pages could be
        shared, but not the recurrent state the prefix built up."""
        seq = Sequence(seq_id)
        shared_pages: List[int] = []
        if self.state is not None and (tokens is not None
                                       or (share_with is not None
                                           and shared_len)):
            self.stats["prefix_declined_ssm"] += 1
            share_with, shared_len, tokens = None, 0, None
        if share_with is not None and shared_len:
            if self.prefix is not None:
                warnings.warn(
                    "share_with=/shared_len= is the legacy pairwise "
                    "prefix API; pass tokens= and let the radix prefix "
                    "cache match automatically", DeprecationWarning,
                    stacklevel=2)
            src = self.seqs[share_with]
            shared_pages = list(src.pages[:shared_len // self.page_size])
        elif tokens is not None and self.prefix is not None:
            shared_pages = self.prefix.match(list(tokens)[:prompt_len])
        if shared_pages:
            for p in shared_pages:
                self.refcount[p] += 1
                seq.pages.append(p)
            seq.length = len(shared_pages) * self.page_size
            seq.shared_prefix_pages = len(shared_pages)
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += seq.length
            self.queue.record_saved("kv_write", seq.length)
            if self.trace is not None:
                # the bulk page copy the hit stands in for
                self.trace.record_prefix_hit(
                    shared_pages, nbytes=seq.length * self._kv_tok_bytes())
        while seq.length < prompt_len:
            seq.pages.append(self._alloc_page(
                near=seq.pages[-1] if seq.pages else None))
            seq.length = min(seq.length + self.page_size, prompt_len)
        seq.length = prompt_len
        self.seqs[seq_id] = seq
        if self.state is not None:
            self.state.alloc(seq_id)
            self.stats["state_pages"] = self.state.rows_in_use
        return seq

    def commit_prefix(self, seq_id: int, tokens: Seq[int]) -> int:
        """Index a sequence's committed prompt KV in the radix prefix
        cache (a no-op without one), once its full pages hold real KV:
        after a prefill batch, or when the last chunk lands.  Only full
        pages index; the tree retains each new one, so the prefix
        outlives the sequence.  Returns the number of pages newly
        indexed; a cache with a state arena never indexes."""
        if self.prefix is None or self.state is not None:
            return 0
        seq = self.seqs[seq_id]
        n_full = min(len(seq.pages), len(tokens) // self.page_size)
        if n_full == 0:
            return 0
        return self.prefix.insert(
            [int(t) for t in list(tokens)[:n_full * self.page_size]],
            seq.pages[:n_full])

    def fork(self, src_id: int, dst_id: int) -> Sequence:
        """Beam/CoW fork: share full pages, RowClone-copy the partial tail."""
        src = self.seqs[src_id]
        dst = Sequence(dst_id)
        full = src.length // self.page_size
        for p in src.pages[:full]:
            self.refcount[p] += 1
            dst.pages.append(p)
        if full < len(src.pages):  # partial tail page -> CoW copy now
            tail = src.pages[full]
            new = self._alloc_page(near=tail)
            self._copy_page(tail, new)
            dst.pages.append(new)
            self.stats["cow_copies"] += 1
        dst.length = src.length
        dst.shared_prefix_pages = full
        self.seqs[dst_id] = dst
        if self.state is not None:
            # the whole state row, now; coalesces into this fork's flush
            self.state.fork(src_id, dst_id)
            self.stats["state_forks"] += 1
            self.stats["state_pages"] = self.state.rows_in_use
        self.flush_pending()   # one batched copy launch per arena
        return dst

    def _copy_page(self, src: int, dst: int) -> None:
        """Enqueue a full-depth page copy; callers flush."""
        self.queue.admit("page_copy", (dst,), self.lib.flush, reads=(src,))
        self.queue.enqueue_copy(src, dst)

    def ensure_writable_tail(self, seq: Sequence) -> None:
        """Before appending one token: CoW a shared tail page, allocate
        a fresh page on a page boundary.  Copies are only enqueued; the
        engine flushes once for the whole round."""
        self.reserve_tokens(seq, 1)

    def reserve_tokens(self, seq: Sequence, n: int) -> None:
        """Reserve arena capacity for the sequence's next ``n`` tokens:
        CoW the partial tail page if it is shared, then allocate pages to
        cover positions ``[length, length + n)``.  Idempotent; never
        launches by itself."""
        if n <= 0:
            return
        if seq.length % self.page_size != 0:
            tail = seq.pages[-1]
            if self.refcount[tail] > 1:
                new = self._alloc_page(near=tail)
                self._copy_page(tail, new)
                self.refcount[tail] -= 1
                seq.pages[-1] = new
                self.stats["cow_copies"] += 1
        need = -(-(seq.length + n) // self.page_size)   # ceil div
        while len(seq.pages) < need:
            seq.pages.append(self._alloc_page(
                near=seq.pages[-1] if seq.pages else None))

    def append_token_kv(self, seq: Sequence, k: torch.Tensor,
                        v: torch.Tensor) -> None:
        """One token through the queue: k, v (layers, kvh, hd) at
        ``seq.length``.  A shared partial tail is CoW-copied first; the
        flush lands the copy before the write."""
        self.ensure_writable_tail(seq)
        page = seq.pages[-1]
        slot = seq.length % self.page_size
        self.queue.admit("kv_write", (page,), self.lib.flush)
        self.queue.enqueue_kv_write(page, slot, k, v)
        self.flush_pending()
        seq.length += 1

    def write_token_kv_batch(self, seq_ids: List[int], k: torch.Tensor,
                             v: torch.Tensor) -> None:
        """Decode-round bulk append through the queue: k, v (layers,
        batch, kvh, hd), written at each sequence's current length (the
        eager oracle's path; tails must already be reserved)."""
        pages, slots = [], []
        for sid in seq_ids:
            seq = self.seqs[sid]
            pages.append(seq.pages[-1])
            slots.append(seq.length % self.page_size)
        self.queue.admit("kv_write", pages, self.lib.flush)
        self.queue.enqueue_kv_writes(pages, slots, k, v)
        self.flush_pending()
        for sid in seq_ids:
            self.seqs[sid].length += 1

    def write_prompt_kv(self, seq: Sequence, k: torch.Tensor,
                        v: torch.Tensor, start: int = 0) -> None:
        """Bulk write of prompt KV through the queue: k, v (layers, n,
        kvh, hd) at positions ``[start, start + n)``, one coalesced
        scatter launch per arena."""
        n = k.shape[1]
        pages = [seq.pages[(start + i) // self.page_size] for i in range(n)]
        slots = [(start + i) % self.page_size for i in range(n)]
        self.queue.admit("kv_write", pages, self.lib.flush)
        self.queue.enqueue_kv_writes(pages, slots, k, v)
        self.flush_pending()

    def prefill_scatter_plan(self, seq: Sequence, start: int = 0,
                             stop: Optional[int] = None,
                             ) -> Tuple[List[int], List[int]]:
        """The (page, slot) destination of each prompt position in
        ``[start, stop)`` (``stop`` defaults to ``seq.length``)."""
        if stop is None:
            stop = seq.length
        pages = [seq.pages[s // self.page_size] for s in range(start, stop)]
        slots = [s % self.page_size for s in range(start, stop)]
        return pages, slots

    def free(self, seq_id: int) -> None:
        """Release a sequence; its dead pages zero in one batched
        RowClone-Init launch per arena.  With the zero scan on, the
        sequence's exclusive pages are zero-compared first (one launch
        per arena) and those already zero skip their init."""
        with self.tracer.span("kv.free", seq_id):
            seq = self.seqs.pop(seq_id)
            if self.zero_scan:
                excl = [p for p in seq.pages if self.refcount[p] == 1]
                if excl:
                    flags = self.scan_zero_pages(excl)
                    self._known_zero.update(
                        p for p, z in zip(excl, flags) if z)
            for p in seq.pages:
                self._release_page(p)
            if self.state is not None and seq_id in self.state.rows:
                self.state.free(seq_id)  # init-on-free rides the same flush
                self.stats["state_pages"] = self.state.rows_in_use
            self.flush_pending()

    def clear_prefix(self) -> int:
        """Drop the whole radix prefix cache (shutdown, leak audit): every
        tree-held reference releases and unshared pages zero in one
        coalesced init launch.  With the zero scan on, every page the
        teardown freed is then audited for zero bits in both arenas
        (failures count in ``zero_audit_failures``).  Returns the number
        of nodes evicted."""
        if self.prefix is None:
            return 0
        before = set(self.refcount)
        n = self.prefix.evict_all()
        self.flush_pending()
        if self.zero_scan:
            freed = sorted(before - set(self.refcount))
            if freed:
                flags = self.scan_zero_pages(freed)
                self.stats["zero_audit_pages"] += len(freed)
                self.stats["zero_audit_failures"] += int(
                    len(freed) - int(np.count_nonzero(flags)))
        return n

    def _kv_tok_bytes(self) -> int:
        """Bytes of one token's KV across the whole depth (k and v)."""
        return (2 * self.n_layers * self.cfg.num_kv_heads
                * self.cfg.resolved_head_dim * self.k_arena.element_size())

    def commit_fused_round(self, seq_ids: List[int], *,
                           kind: Optional[str] = "fused_decode",
                           wrote_kv: bool = True) -> None:
        """The engine's fused decode round scattered each sequence's new
        token KV into the arenas itself: record the writes in the trace,
        advance the lengths and count the round's one launch under
        ``kind`` (``None``: the mixed round, which the engine counts once
        as ``fused_mixed``).  ``wrote_kv=False`` (a pure-SSM model: no
        attention sublayer touched the arenas) records no KV traffic."""
        if self.trace is not None and wrote_kv:
            pages = [self.seqs[sid].pages[-1] for sid in seq_ids]
            slots = [self.seqs[sid].length % self.page_size
                     for sid in seq_ids]
            self.trace.record_kv_write(pages, slots,
                                       len(seq_ids) * self._kv_tok_bytes())
        for sid in seq_ids:
            self.seqs[sid].length += 1
        if kind is not None:
            self.queue.count_external(kind)

    def commit_fused_block(self, seq_ids: List[int], counts: List[int], *,
                           rounds: int = 1,
                           kind: Optional[str] = "fused_decode_block",
                           wrote_kv: bool = True) -> None:
        """The engine's K-round decode block scattered its KV itself:
        advance each sequence by the ``counts[i]`` tokens it emitted
        before its in-block stop (EOS or budget) and count the block's
        one launch.  Capacity for the whole block was reserved with
        :meth:`reserve_tokens`; slots past a row's count hold what they
        held before the block (the masked write-back), so only the real
        writes reach the trace, as one event stamped with the block's
        ``rounds``."""
        if self.trace is not None and wrote_kv:
            pages: List[int] = []
            slots: List[int] = []
            for sid, n in zip(seq_ids, counts):
                seq = self.seqs[sid]
                for pos in range(seq.length, seq.length + n):
                    pages.append(seq.pages[pos // self.page_size])
                    slots.append(pos % self.page_size)
            self.trace.record_kv_write(pages, slots,
                                       len(pages) * self._kv_tok_bytes(),
                                       rounds=rounds)
        for sid, n in zip(seq_ids, counts):
            self.seqs[sid].length += n
        if kind is not None:
            self.queue.count_external(kind)

    def commit_fused_prefill(self, pages: Seq[int] = (),
                             slots: Seq[int] = (), *,
                             kind: Optional[str] = "fused_prefill") -> None:
        """The engine's fused prefill or chunk batch scattered its prompt
        KV itself (lengths were set at ``create``): record the positions
        it wrote (``pages``/``slots``, shared-prefix positions excluded)
        in the trace and count the batch's one launch under ``kind``
        (``None``: the chunk half of a mixed round)."""
        if self.trace is not None and len(pages):
            self.trace.record_kv_write(pages, slots,
                                       len(pages) * self._kv_tok_bytes())
        if kind is not None:
            self.queue.count_external(kind)

    def block_table(self, seq_ids: List[int],
                    lengths: Optional[List[int]] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Block tables (B, width) and lengths (B,) as int32 tensors on
        the cache's device (uploaded without a synchronise; see
        :meth:`block_table_host`)."""
        bt, lens = self.block_table_host(seq_ids, lengths)
        return upload(bt, self.device), upload(lens, self.device)

    def block_table_host(self, seq_ids: List[int],
                         lengths: Optional[List[int]] = None,
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Block tables (B, width) and lengths (B,) as int32 host arrays.
        The width is the widest sequence's page count rounded up to a
        power of two; padding columns point at page 0 and are never
        attended.  ``lengths`` overrides each sequence's valid length:
        chunked prefill exposes only the committed prefix of a sequence
        mid-prefill, over a table that still spans its full page
        list."""
        width = _bucket_pow2(max(len(self.seqs[sid].pages)
                                 for sid in seq_ids))
        bt = np.zeros((len(seq_ids), width), np.int32)
        lens = np.zeros((len(seq_ids),), np.int32)
        for i, sid in enumerate(seq_ids):
            seq = self.seqs[sid]
            bt[i, :len(seq.pages)] = seq.pages
            lens[i] = seq.length if lengths is None else lengths[i]
        return bt, lens

    @property
    def pages_in_use(self) -> int:
        return len(self.refcount)


def _bucket_pow2(n: int) -> int:
    """Round up to the next power of two (min 1)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _num_attn_layers(cfg: ModelConfig) -> int:
    """Leading (layers) dim of the KV arenas: the engine's layer loop
    length, not the count of attention sublayers.  A hybrid superblock
    carries one attention sublayer per step (num_layers // attn_every
    steps); the pure-ssm family loops num_layers steps and keeps a
    phantom full-depth KV arena, as the JAX package does (its pages are
    allocated, reserved and zeroed like any other, so every page op and
    launch count matches)."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


def _mamba_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, mamba sublayers per group): the state arenas' leading
    (G, M) dims; (0, 0) for a layout without recurrent state (no mamba
    kinds, or a multi-group layout the engine refuses anyway)."""
    if cfg.family not in ("ssm", "hybrid"):
        return (0, 0)
    groups = T.layer_groups(cfg)
    if len(groups) != 1:
        return (0, 0)
    count, kinds = groups[0]
    m = sum(1 for k in kinds if k == "mamba")
    return (count, m) if m else (0, 0)
