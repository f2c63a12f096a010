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
* **pairwise prefix sharing** — refcounted pages let a request share
  another's page-aligned prompt prefix (``share_with``/``shared_len``);
  CoW forking copies only the partial tail.

The arenas are (layers, pages, page_size, kvh, hd) tensors on one
device.  Every mutation routes through a :class:`TorchLib` and its
batched op queue, one coalesced launch per op kind; the engine's fused
decode round, K-round decode block and fused prefill or chunk batch
scatter their KV themselves and report it with
:meth:`PagedKVCache.commit_fused_round`,
:meth:`PagedKVCache.commit_fused_block` and
:meth:`PagedKVCache.commit_fused_prefill`.

Not in this slice (the constructor raises for them): the radix prefix
cache, trace recording, the SSM state arena, the Ambit zero scan and
device meshes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocator import (PimAllocError, SubarrayAllocator,
                                        arena_groups)
from repro_torch.core.pimolib import TorchLib
from repro_torch.device import DeviceLike, resolve_device


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
                         ("prefix_cache", prefix_cache),
                         ("zero_scan", zero_scan),
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
                      "prefix_hit_tokens": 0}

    # the arenas live on the lib (a shared lib sees every mutation)
    @property
    def k_arena(self) -> torch.Tensor:
        return self.lib.buffers[0]

    @property
    def v_arena(self) -> torch.Tensor:
        return self.lib.buffers[1]

    # ------------------------- page management ------------------------ #

    def _alloc_page(self, near: Optional[int] = None) -> int:
        a = None
        if near is not None and near in self.page_alloc:
            try:
                a = self.allocator.alloc(1, group=self.page_alloc[near].group)
            except PimAllocError:
                pass
        if a is None:
            a = self.allocator.alloc(1)
        page = a.rows[0]
        self.page_alloc[page] = a
        self.refcount[page] = 1
        return page

    def _release_page(self, page: int) -> None:
        """Drop a reference; on the last one, enqueue a batched
        RowClone-Init (zero without reading) and return the page to the
        allocator.  The caller flushes."""
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self.queue.admit("page_init", (page,), self.lib.flush)
            self.queue.enqueue_init(page)
            self.stats["pages_zeroed"] += 1
            self.allocator.free(self.page_alloc.pop(page))
            del self.refcount[page]

    def flush_pending(self) -> None:
        """Drain the op queue: one coalesced launch per pending op kind."""
        self.lib.flush()

    # ------------------------- sequence API ---------------------------- #

    def create(self, seq_id: int, prompt_len: int,
               share_with: Optional[int] = None,
               shared_len: int = 0) -> Sequence:
        """Create a sequence, attaching the first ``shared_len //
        page_size`` pages of live sequence ``share_with`` (refcount++,
        no compute, no writes)."""
        seq = Sequence(seq_id)
        shared_pages: List[int] = []
        if share_with is not None and shared_len:
            src = self.seqs[share_with]
            shared_pages = list(src.pages[:shared_len // self.page_size])
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
        RowClone-Init launch per arena."""
        seq = self.seqs.pop(seq_id)
        for p in seq.pages:
            self._release_page(p)
        self.flush_pending()

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
