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

The arenas are (layers, pages, page_size, kvh, hd) tensors on one
device.  Every mutation routes through a :class:`TorchLib` and its
batched op queue, one coalesced launch per op kind; the engine's fused
decode round, K-round decode block and fused prefill or chunk batch
scatter their KV themselves and report it with
:meth:`PagedKVCache.commit_fused_round`,
:meth:`PagedKVCache.commit_fused_block` and
:meth:`PagedKVCache.commit_fused_prefill`.

Not in this slice (the constructor raises for them): trace recording,
the SSM state arena and device meshes.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence as Seq, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocator import (PimAllocError, SubarrayAllocator,
                                        arena_groups)
from repro_torch.core.pimolib import TorchLib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ambit import ops as amb_ops
from .prefix_cache import RadixPrefixCache


@dataclass
class Sequence:
    seq_id: int
    pages: List[int] = field(default_factory=list)
    length: int = 0
    shared_prefix_pages: int = 0


class PagedKVCache:
    def __init__(self, cfg: ModelConfig, *, num_pages: int = 128,
                 page_size: int = 16, num_slabs: int = 4,
                 dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, lib: Optional[TorchLib] = None,
                 record_trace: bool = False, mesh=None,
                 prefix_cache: bool = False, zero_scan: bool = False,
                 state_slots: Optional[int] = None):
        for name, on in (("record_trace", record_trace),
                         ("mesh", mesh is not None),
                         ("state_slots", state_slots is not None)):
            if on:
                raise NotImplementedError(
                    f"PagedKVCache({name}=...) is not ported yet")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: only dense KV caches are ported")
        if num_pages % num_slabs:
            raise ValueError("num_pages must be a multiple of num_slabs")
        self.cfg = cfg
        self.page_size = page_size
        self.dtype = dtype
        self.device = resolve_device(device)
        self.n_layers = cfg.num_layers
        shape = (self.n_layers, num_pages, page_size, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        k0 = torch.zeros(shape, dtype=dtype, device=self.device)
        v0 = torch.zeros(shape, dtype=dtype, device=self.device)
        self.allocator = SubarrayAllocator(
            arena_groups(num_slabs, num_pages // num_slabs))
        if lib is None:
            lib = TorchLib(buffers=[k0, v0], layered=True,
                           allocator=self.allocator, deferred=True)
        else:
            lib.adopt_buffers([k0, v0], layered=True,
                              allocator=self.allocator)
        self.lib = lib
        self.queue = lib.queue
        self.refcount: Dict[int, int] = {}
        self.page_alloc: Dict[int, object] = {}
        self.seqs: Dict[int, Sequence] = {}
        self.stats = {"cow_copies": 0, "pages_zeroed": 0, "prefix_hits": 0,
                      "prefix_hit_tokens": 0, "prefix_evictions": 0,
                      "init_skips_zero": 0, "zero_audit_pages": 0,
                      "zero_audit_failures": 0}
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
                page_size, retain=self._retain_page,
                release=self._release_evicted_prefix_page)

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
        self.lib.flush()

    # --------------------- Ambit zero-compare scan --------------------- #

    def enable_zero_scan(self) -> None:
        """Turn on the Ambit zero-compare paths: ``free()`` scans a
        dying sequence's exclusive pages (pages already zero skip their
        init-on-free) and ``clear_prefix()`` audits that every page it
        freed holds zero bits."""
        self.zero_scan = True

    def scan_zero_pages(self, pages) -> np.ndarray:
        """Batched zero-compare over ``pages``: one read-only launch per
        arena (k, v) whatever the batch, after the pending mutations
        land.  Returns bool (n,) on the host, True where the page holds
        all-zero bits in both arenas; reading it waits for the card."""
        idx = np.asarray(list(pages), np.int32)
        if idx.size == 0:
            return np.zeros((0,), bool)
        self.flush_pending()
        flags = None
        for buf in self.lib.buffers:
            z = amb_ops.pim_page_zero_scan(buf, idx)
            flags = z if flags is None else (flags & z)
        self.queue.count_external("page_zero_scan", len(self.lib.buffers))
        return flags.cpu().numpy()

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
        accounting."""
        seq = Sequence(seq_id)
        shared_pages: List[int] = []
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
        while seq.length < prompt_len:
            seq.pages.append(self._alloc_page(
                near=seq.pages[-1] if seq.pages else None))
            seq.length = min(seq.length + self.page_size, prompt_len)
        seq.length = prompt_len
        self.seqs[seq_id] = seq
        return seq

    def commit_prefix(self, seq_id: int, tokens: Seq[int]) -> int:
        """Index a sequence's committed prompt KV in the radix prefix
        cache (a no-op without one), once its full pages hold real KV:
        after a prefill batch, or when the last chunk lands.  Only full
        pages index; the tree retains each new one, so the prefix
        outlives the sequence.  Returns the number of pages newly
        indexed."""
        if self.prefix is None:
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
        seq = self.seqs.pop(seq_id)
        if self.zero_scan:
            excl = [p for p in seq.pages if self.refcount[p] == 1]
            if excl:
                flags = self.scan_zero_pages(excl)
                self._known_zero.update(
                    p for p, z in zip(excl, flags) if z)
        for p in seq.pages:
            self._release_page(p)
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

    def commit_fused_round(self, seq_ids: List[int], *,
                           kind: Optional[str] = "fused_decode") -> None:
        """The engine's fused decode round scattered each sequence's new
        token KV into the arenas itself: advance the lengths and count
        the round's one launch under ``kind`` (``None``: the mixed
        round, which the engine counts once as ``fused_mixed``)."""
        for sid in seq_ids:
            self.seqs[sid].length += 1
        if kind is not None:
            self.queue.count_external(kind)

    def commit_fused_block(self, seq_ids: List[int], counts: List[int], *,
                           kind: Optional[str] = "fused_decode_block",
                           ) -> None:
        """The engine's K-round decode block scattered its KV itself:
        advance each sequence by the ``counts[i]`` tokens it emitted
        before its in-block stop (EOS or budget) and count the block's
        one launch.  Capacity for the whole block was reserved with
        :meth:`reserve_tokens`; slots past a row's count hold what they
        held before the block (the masked write-back)."""
        for sid, n in zip(seq_ids, counts):
            self.seqs[sid].length += n
        if kind is not None:
            self.queue.count_external(kind)

    def commit_fused_prefill(self, *,
                             kind: Optional[str] = "fused_prefill") -> None:
        """The engine's fused prefill or chunk batch scattered its prompt
        KV itself (lengths were set at ``create``): count the batch's
        one launch under ``kind`` (``None``: the chunk half of a mixed
        round)."""
        if kind is not None:
            self.queue.count_external(kind)

    def block_table(self, seq_ids: List[int],
                    lengths: Optional[List[int]] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Block tables (B, width) and lengths (B,) as int32 tensors on
        the cache's device.  The width is the widest sequence's page
        count rounded up to a power of two; padding columns point at
        page 0 and are never attended.  ``lengths`` overrides each
        sequence's valid length: chunked prefill exposes only the
        committed prefix of a sequence mid-prefill, over a table that
        still spans its full page list."""
        width = _bucket_pow2(max(len(self.seqs[sid].pages)
                                 for sid in seq_ids))
        bt = np.zeros((len(seq_ids), width), np.int32)
        lens = np.zeros((len(seq_ids),), np.int32)
        for i, sid in enumerate(seq_ids):
            seq = self.seqs[sid]
            bt[i, :len(seq.pages)] = seq.pages
            lens[i] = seq.length if lengths is None else lengths[i]
        return (torch.from_numpy(bt).to(self.device),
                torch.from_numpy(lens).to(self.device))

    @property
    def pages_in_use(self) -> int:
        return len(self.refcount)


def _bucket_pow2(n: int) -> int:
    """Round up to the next power of two (min 1)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()
