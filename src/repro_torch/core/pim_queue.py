"""Batched PiM operation scheduler: the deferred op queue.

The port's counterpart of the JAX package's ``core/pim_queue.py``.
PiDRAM's end-to-end lesson is that in-DRAM ops only win when the
dispatch path is amortised: one POC handshake per *batch* of row
operations, not per row.  This queue collects arena mutations (CoW page
copies, init-on-free page inits, Ambit bitwise ops, token KV writes) as
light records and flushes them as ONE coalesced launch per op kind per
arena — a constant number of launches whatever the layer count or batch
size.

Op kinds come from the opcode-keyed registry
(:mod:`repro_torch.core.op_registry`): every spec with a torch face
contributes its ``(torch_kind, torch_flush)`` pair when a queue is
built; :meth:`PimOpQueue.register_kind` adds kinds to one queue.  A
queue with a ``trace`` (a :class:`repro_torch.serving.trace.PimTrace`)
records each kind's flushed batch as one event.

Flush order is fixed: ``page_copy`` first (CoW sources are duplicated
before anything overwrites them), then ``page_init``, the Ambit kinds
``page_and``, ``page_or`` and ``page_not``, then ``kv_write``, then
kinds registered later (the SSM state arena's ``ssm_state_write``,
``state_copy`` and ``state_init``) in registration order.  Within a
kind, ops keep enqueue order, and duplicate destinations resolve to the
last op enqueued.

:meth:`PimOpQueue.admit` keeps program order for deferred clients:
enqueueing an op whose kind differs from the backlog's, or that touches
a row a pending op wrote or will write, flushes the backlog first.
Rows are any hashable id: KV pages are ints, and the state arena's rows
are ``("state", slot)`` tuples, which never collide with a page id.  A
batch of copies reads the pre-flush arena (the copy kernel stages its
sources when a destination is also a source), so several copies from
one source still coalesce.

Launch accounting is the same as the JAX package's, key for key:
``stats``, ``launches_by_kind``, ``saved_by_kind``,
``launches_by_owner`` and the ``snapshot``/``delta`` pair that
per-round dispatch checks use.  Work launched outside the queue but
belonging to the same accounting (the engine's fused decode round and
fused prefill batch) is recorded with :meth:`count_external`.

Per-owner attribution: each launch also counts once for every owner tag
it served, the tags the kind's ops were enqueued with, else the owning
lib's :meth:`~repro_torch.core.pimolib.TorchLib.owner_tags`.  A sharded
lib's tags name every shard (``kv/shard0`` ...): one SPMD dispatch
spans them all, so each rank's queue attributes it to all N tags, and
every rank's ``snapshot(by_owner=True)`` is the JAX package's
single-controller breakdown.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Iterable, Optional, Set, Tuple

import torch

from . import op_registry
from .op_registry import KVWriteBatch

# A flush executor: (queue, arenas, ops) -> arenas (same length tuple).
FlushFn = Callable[["PimOpQueue", Tuple[torch.Tensor, ...], list],
                   Tuple[torch.Tensor, ...]]


class PimOpQueue:
    """Deferred queue of arena mutations, flushed as coalesced launches."""

    KIND_ORDER = ("page_copy", "page_init",
                  "page_and", "page_or", "page_not", "kv_write")

    def __init__(self) -> None:
        self._kinds: Dict[str, FlushFn] = {}
        self._pending: Dict[str, list] = {}
        self.stats = {
            "launches": 0,            # kernel dispatches issued (total)
            "flushes": 0,             # flush() calls that launched anything
            "ops_enqueued": 0,        # logical ops collected
            "ops_coalesced": 0,       # logical ops folded into launches
            "hazard_flushes": 0,      # admit() flushes forced by hazards
            "overlap_flushes": 0,     # backlogs dispatched early
            "ops_saved": 0,           # logical ops sharing made unnecessary
        }
        self.launches_by_kind: Dict[str, int] = {}
        # logical ops that never had to run because pages were shared
        # instead of rewritten: kind -> count
        self.saved_by_kind: Dict[str, int] = {}
        # owner tag -> {kind: launches}; a launch spanning several owners
        # counts once in launches_by_kind and once per owner here
        self.launches_by_owner: Dict[str, Dict[str, int]] = {}
        self._pending_owner: Dict[str, Set[str]] = {}
        # optional PimTrace sink (duck-typed: record_from_queue(kind, ops))
        self.trace = None
        # at most one lib drives a queue (TorchLib claims it: a weak
        # reference to the lib)
        self.owner = None
        # hazard tracking for deferred clients (see admit())
        self._hazard_rows: Set[Hashable] = set()
        self._hazard_kind: Optional[str] = None
        for kind, fn in op_registry.queue_kinds():
            self.register_kind(kind, fn)

    def register_kind(self, kind: str, fn: FlushFn) -> None:
        self._kinds[kind] = fn
        self._pending.setdefault(kind, [])
        self._pending_owner.setdefault(kind, set())
        self.launches_by_kind.setdefault(kind, 0)

    def has_kind(self, kind: str) -> bool:
        return kind in self._kinds

    # -- enqueue -------------------------------------------------------- #

    def enqueue(self, kind: str, op, n_ops: int = 1,
                owner: Optional[str] = None) -> None:
        """Collect one op record; ``owner`` optionally tags it with the
        lib or arena it belongs to (its kind's launch is then attributed
        to every distinct tag seen)."""
        if kind not in self._kinds:
            raise KeyError(f"unknown PiM op kind {kind!r}")
        self._pending[kind].append(op)
        if owner is not None:
            self._pending_owner[kind].add(owner)
        self.stats["ops_enqueued"] += n_ops

    def enqueue_copy(self, src_page: int, dst_page: int) -> None:
        self.enqueue("page_copy", (src_page, dst_page))

    def enqueue_init(self, page: int, value: float = 0.0) -> None:
        self.enqueue("page_init", (page, float(value)))

    def enqueue_kv_write(self, page: int, slot: int, k: torch.Tensor,
                         v: torch.Tensor) -> None:
        """Single token: k/v (layers, ...)."""
        self.enqueue_kv_writes([page], [slot], k[:, None], v[:, None])

    def enqueue_kv_writes(self, pages, slots, k: torch.Tensor,
                          v: torch.Tensor) -> None:
        """Bulk form: pages/slots length-B, k/v (layers, B, ...).  An
        empty batch enqueues nothing, so the counters only count real
        launches."""
        if len(pages) == 0:
            return
        batch = KVWriteBatch([int(p) for p in pages],
                             [int(s) for s in slots], k, v)
        self.enqueue("kv_write", batch, n_ops=batch.n)

    # -- hazard-aware deferred admission --------------------------------- #

    def admit(self, kind: str, rows: Iterable[Hashable],
              flush: Callable[[], None], *,
              reads: Iterable[Hashable] = ()) -> bool:
        """Admit ops of ``kind`` writing ``rows`` (and reading ``reads``)
        for deferred enqueue: call ``flush`` first exactly when the
        backlog holds another kind or a pending op wrote one of these
        rows; returns whether it flushed."""
        rows = list(rows)
        flushed = False
        if self.pending_ops and (
                self._hazard_kind != kind
                or not self._hazard_rows.isdisjoint(rows)
                or not self._hazard_rows.isdisjoint(reads)):
            flush()
            flushed = True
            self.stats["hazard_flushes"] += 1
        self._hazard_kind = kind
        self._hazard_rows.update(rows)
        return flushed

    # -- accounting ----------------------------------------------------- #

    @property
    def pending_ops(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def _default_owners(self) -> Tuple[str, ...]:
        """The tags a launch whose ops carried none is attributed to: the
        owning lib's per-shard tags, else nothing (an ownerless queue
        keeps only the global counters)."""
        lib = self.owner() if self.owner is not None else None
        tags = getattr(lib, "owner_tags", None)
        return tuple(tags()) if callable(tags) else ()

    def _count_launch(self, kind: str, n: int = 1,
                      owners: Optional[Iterable[str]] = None) -> None:
        self.stats["launches"] += n
        self.launches_by_kind[kind] += n
        if owners is None:
            owners = self._pending_owner.get(kind) or self._default_owners()
        for o in sorted(owners):
            per = self.launches_by_owner.setdefault(o, {})
            per[kind] = per.get(kind, 0) + n

    def record_saved(self, kind: str, n: int = 1) -> None:
        """Account ``n`` logical ops of ``kind`` that sharing made
        unnecessary (a shared prompt prefix saves its token writes)."""
        self.saved_by_kind[kind] = self.saved_by_kind.get(kind, 0) + n
        self.stats["ops_saved"] += n

    def count_external(self, kind: str, n: int = 1, owner=None) -> None:
        """Account launches issued outside the queue (the engine's fused
        decode round and fused prefill batch) so the launch counters
        stay the one source of truth for per-round dispatch checks.
        ``owner`` (a tag or an iterable of tags) attributes them; by
        default they land on the owning lib's tags, for a sharded lib
        every shard the dispatch spanned."""
        self.launches_by_kind.setdefault(kind, 0)
        if owner is None:
            owners = None
        elif isinstance(owner, str):
            owners = (owner,)
        else:
            owners = tuple(owner)
        self._count_launch(kind, n, owners=owners)

    def snapshot(self, by_owner: bool = False) -> Dict:
        """A copy of ``launches_by_kind`` (with ``by_owner``, of the
        per-owner breakdown ``{owner: {kind: n}}``); diff it with
        :meth:`delta`."""
        if by_owner:
            return {o: dict(k) for o, k in self.launches_by_owner.items()}
        return dict(self.launches_by_kind)

    def delta(self, before: Dict, by_owner: bool = False) -> Dict:
        """Per-kind launches since ``before`` (a :meth:`snapshot` taken
        with the same ``by_owner``), zero counts omitted."""
        if by_owner:
            out: Dict[str, Dict[str, int]] = {}
            for o, kinds in self.launches_by_owner.items():
                prev = before.get(o, {})
                d = {k: v - prev.get(k, 0) for k, v in kinds.items()
                     if v - prev.get(k, 0)}
                if d:
                    out[o] = d
            return out
        return {k: v - before.get(k, 0)
                for k, v in self.launches_by_kind.items()
                if v - before.get(k, 0)}

    # -- flush ---------------------------------------------------------- #

    def flush_overlapped(self, flush: Callable[[], None]) -> bool:
        """Dispatch the pending backlog now, ahead of host work that
        follows (CUDA launches are asynchronous).  Returns whether
        anything was dispatched."""
        if self.pending_ops == 0:
            return False
        flush()
        self.stats["overlap_flushes"] += 1
        return True

    def flush(self, *arenas: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Drain the queue: one coalesced launch per op kind per arena,
        in :attr:`KIND_ORDER`.  Updates the arenas in place (the JAX
        package donated them) and returns them."""
        self._hazard_rows.clear()
        self._hazard_kind = None
        if self.pending_ops == 0:
            return arenas
        any_launch = False
        order = [k for k in self.KIND_ORDER if k in self._kinds]
        order += [k for k in self._kinds if k not in order]
        for kind in order:
            ops = self._pending[kind]
            if not ops:
                continue
            self._pending[kind] = []
            if self.trace is not None:
                self.trace.record_from_queue(kind, ops)
            arenas = self._kinds[kind](self, arenas, ops)
            self._pending_owner[kind] = set()
            self.stats["ops_coalesced"] += sum(getattr(o, "n", 1)
                                               for o in ops)
            any_launch = True
        if any_launch:
            self.stats["flushes"] += 1
        return arenas
