"""Serving-trace capture + model-face replay: paper-style end-to-end
latency accounting for real engine workloads.

The port's copy of the JAX package's ``serving/trace.py``.  Every
latency it returns is the simulated DDR3 prototype's (the model face),
never a time of the card.

The paged KV cache records its arena mutations as a :class:`PimTrace`
— one event per op kind per queue flush, so the trace preserves the
batching the serving path actually achieved (a CoW fork's N page copies
are ONE event, exactly as they were one coalesced launch).  The engine's
fused steps, whose KV and state scatters bypass the queue, record their
writes explicitly.

:func:`replay_on_device` then drives the same trace through the
:class:`repro_torch.core.pimolib.DeviceLib` face of the ``PimLib`` protocol:
each KV page maps to a DRAM row of the simulated DDR3 prototype
(same slab → same discovered subarray, so CoW copies are legal
RowClones), each event becomes one batched pimolib call (one POC
handshake, mirroring the serving coalescing), and the returned
:class:`OpReceipt` latencies accumulate into RowClone-vs-CPU totals —
the paper's copy/init tables, measured on a *serving* workload instead
of a microbenchmark.  Capability flags drive graceful fallback:
``KV_WRITE`` has no DDR3 sequence (``lib.supports`` is False), so token
writes are accounted as CPU writes; a copy whose operands land in
different subarrays falls back to ``cpu_copy`` the same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.allocator import (Allocation,
                                        allocator_from_subarray_map)
from repro_torch.core.coherence import CoherencePolicy
from repro_torch.core.dram_model import DRAMGeometry, SimulatedDRAM
from repro_torch.core.memctrl import EndToEndCosts, MemoryController
from repro_torch.core.op_registry import group_inits_by_value
from repro_torch.core.pimolib import Blocking, DeviceLib, OpReceipt
from repro_torch.core.poc import PimOpsController
from repro_torch.core.subarray import discover_subarrays


def _nbytes(t, itemsize: Optional[int] = None) -> int:
    """Bytes of tensor ``t``, at ``itemsize`` bytes an element if given
    (the arena dtype a wider source is cast to at flush)."""
    return t.numel() * (itemsize or t.element_size())


@dataclass(frozen=True)
class TraceEvent:
    """One coalesced batch of same-kind ops (one flush-side launch)."""

    kind: str                        # "page_copy" | "page_init" |
                                     # "page_and" | "page_or" | "page_not" |
                                     # "page_zero_scan" | "kv_write" |
                                     # "prefix_hit" | "ssm_state_write" |
                                     # "state_copy" | "state_init"
                                     # (state_* dst/src are state-arena
                                     # rows, a namespace disjoint from
                                     # KV page ids)
    src: Tuple[int, ...] = ()        # source pages (page_copy, bitwise)
    dst: Tuple[int, ...] = ()        # destination pages (all kinds)
    slots: Tuple[int, ...] = ()      # in-page slots (kv_write)
    value: float = 0.0               # fill value (page_init)
    nbytes: int = 0                  # payload bytes (kv_write)
    rounds: int = 1                  # engine rounds this event spans
                                     # (>1: a K-blocked decode loop's
                                     # writes landed as one host commit)

    @property
    def n(self) -> int:
        return len(self.dst)


class PimTrace:
    """Recorded arena-mutation schedule of a serving run."""

    def __init__(self, *, num_pages: int, num_slabs: int,
                 page_size: int, kv_itemsize: Optional[int] = None) -> None:
        self.num_pages = num_pages
        self.num_slabs = num_slabs
        self.page_size = page_size
        # bytes per stored KV element (the ARENA dtype — enqueued source
        # arrays may be wider and only cast at flush)
        self.kv_itemsize = kv_itemsize
        # state-arena slot count (set by the owning cache when an SSM
        # state arena exists) — sizes the replay twin so state rows get
        # their own DRAM rows next to the KV pages
        self.num_state_rows = 0
        self.events: List[TraceEvent] = []

    def __len__(self) -> int:
        return len(self.events)

    def counts(self) -> Dict[str, int]:
        """Logical op counts per kind (not event counts)."""
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + e.n
        return out

    # -- recording hooks ------------------------------------------------- #

    def record_from_queue(self, kind: str, ops: list) -> None:
        """PimOpQueue flush hook: summarize one kind's pending ops into
        one event (mirrors the one-coalesced-launch-per-kind contract).
        Unknown kinds are ignored (ad-hoc per-queue registrations)."""
        if kind in ("page_copy", "page_and", "page_or", "page_not"):
            # pairwise (src, dst) kinds: RowClone copies and the Ambit
            # bitwise family share the op-record shape
            self.events.append(TraceEvent(
                kind, src=tuple(s for s, _ in ops),
                dst=tuple(d for _, d in ops)))
        elif kind == "page_init":
            # same value-grouping as the flush executor: one event per
            # actual launch group
            for value, pages in group_inits_by_value(ops).items():
                self.events.append(TraceEvent(kind, dst=tuple(pages),
                                              value=value))
        elif kind == "kv_write":
            pages = tuple(p for o in ops for p in o.pages)
            slots = tuple(s for o in ops for s in o.slots)
            nbytes = sum(_nbytes(o.k, self.kv_itemsize)
                         + _nbytes(o.v, self.kv_itemsize) for o in ops)
            self.events.append(TraceEvent(kind, dst=pages, slots=slots,
                                          nbytes=nbytes))
        elif kind == "state_copy":
            # copy-on-fork of whole state rows — RowClone on replay
            self.events.append(TraceEvent(
                kind, src=tuple(s for s, _ in ops),
                dst=tuple(d for _, d in ops)))
        elif kind == "state_init":
            for value, rows in group_inits_by_value(ops).items():
                self.events.append(TraceEvent(kind, dst=tuple(rows),
                                              value=value))
        elif kind == "ssm_state_write":
            # StateWriteBatch records (already cast to the arena dtypes)
            rows = tuple(r for o in ops for r in o.rows)
            nbytes = sum(_nbytes(o.conv) + _nbytes(o.ssm) for o in ops)
            self.events.append(TraceEvent(kind, dst=rows, nbytes=nbytes))

    def record_kv_write(self, pages, slots, nbytes: int, *,
                        rounds: int = 1) -> None:
        """Explicit hook for writes that bypass the queue (the fused
        steps' own scatters).  ``rounds > 1`` stamps a
        K-blocked decode loop's whole block — replay still sees one
        ``kv_write`` batch (the coalescing the engine actually
        achieved), and analyses can recover rounds-per-host-commit."""
        self.events.append(TraceEvent("kv_write", dst=tuple(pages),
                                      slots=tuple(slots), nbytes=int(nbytes),
                                      rounds=int(rounds)))

    def record_state_write(self, rows, nbytes: int, *,
                           rounds: int = 1) -> None:
        """Explicit hook for state writes that bypass the queue (the
        fused steps scatter recurrent state themselves, mirroring the KV
        path's :meth:`record_kv_write`)."""
        self.events.append(TraceEvent("ssm_state_write",
                                      dst=tuple(rows), nbytes=int(nbytes),
                                      rounds=int(rounds)))

    def record_zero_scan(self, pages) -> None:
        """The KV cache's zero-compare page scan (eviction candidates /
        clear_prefix audit) bypasses the queue — it is a read-only
        kernel, counted via ``count_external`` — so it records its page
        batch explicitly.  Replay prices it as the Ambit OR-reduce-and-
        test sequence vs a CPU word scan."""
        if len(pages):
            self.events.append(TraceEvent("page_zero_scan",
                                          dst=tuple(int(p) for p in pages)))

    def record_prefix_hit(self, pages, nbytes: int = 0) -> None:
        """A radix prefix-cache hit attached ``pages`` to a new sequence
        instead of recomputing + rewriting them.  On the torch face the
        hit is free (refcount++); what it *stands in for* is the bulk
        page materialization a CoW-less server would pay per request —
        RowClone on the model face (one batched in-DRAM copy), memcpy on
        the CPU baseline.  Replay accounts it exactly that way, which is
        how shared-system-prompt traffic turns into the paper's
        copy-table savings."""
        if pages:
            self.events.append(TraceEvent("prefix_hit", dst=tuple(pages),
                                          nbytes=int(nbytes)))


# ---------------------------------------------------------------------- #
# Model-face replay
# ---------------------------------------------------------------------- #


def replay_on_device(trace: PimTrace, *, lib: Optional[DeviceLib] = None,
                     row_bytes: int = 64,
                     coherence: CoherencePolicy = CoherencePolicy.PRECISE,
                     ) -> Dict[str, object]:
    """Replay a serving trace on the simulated-prototype face.

    Builds (unless ``lib`` is supplied) a DDR3 twin sized so each arena
    slab maps onto one subarray, then replays every event as one batched
    ``PimLib`` call, collecting :class:`OpReceipt` objects.  Returns the
    receipts plus latency totals: the PiM account (RowClone copies/inits
    + CPU-fallback paths) against the all-CPU baseline (memcpy/calloc),
    per kind and end-to-end.
    """
    pages_per_slab = trace.num_pages // trace.num_slabs
    if lib is None:
        # +2 rows of slack per subarray: the reserved zero row, plus the
        # discovery probe's scratch tolerance.  State-arena rows (SSM
        # serving) all map into the first subarray — copy-on-fork src
        # and dst share it, so forks replay as legal RowClones — which
        # therefore needs room for every state slot on top of its pages.
        geo = DRAMGeometry(num_subarrays=trace.num_slabs,
                           rows_per_subarray=(pages_per_slab + 2
                                              + trace.num_state_rows),
                           row_bytes=row_bytes)
        mc = MemoryController(SimulatedDRAM(geo))
        smap = discover_subarrays(mc, max_rows=geo.num_rows)
        lib = DeviceLib(PimOpsController(mc), allocator_from_subarray_map(smap),
                        coherence=coherence)
    mc = lib.poc.mc
    costs = EndToEndCosts(mc)

    # arena page -> device row, same slab -> same discovered group
    groups = lib.allocator.group_ids()
    page_row: Dict[int, Allocation] = {}

    def row_of(page: int) -> Allocation:
        if page not in page_row:
            gid = groups[(page // pages_per_slab) % len(groups)]
            page_row[page] = lib.allocator.alloc(1, group=gid,
                                                 tag=f"page{page}")
        return page_row[page]

    # state-arena rows live in their own id namespace (slot ids overlap
    # page ids); one subarray holds them all so fork copies are
    # same-group RowClones
    state_row: Dict[int, Allocation] = {}

    def srow_of(slot: int) -> Allocation:
        if slot not in state_row:
            state_row[slot] = lib.allocator.alloc(1, group=groups[0],
                                                  tag=f"srow{slot}")
        return state_row[slot]

    def grouped(pages) -> Dict[int, Allocation]:
        """Batch same-group rows into one Allocation (one pimolib call
        -> one POC handshake, mirroring the serving-side coalescing)."""
        rows_by_group: Dict[int, List[int]] = {}
        for p in pages:
            a = row_of(p)
            rows_by_group.setdefault(a.group, []).append(a.rows[0])
        return {g: Allocation(rows=tuple(rows), group=g)
                for g, rows in rows_by_group.items()}

    receipts: List[OpReceipt] = []
    pim = {"rowclone_copy": 0.0, "rowclone_init": 0.0,
           "ambit_bitwise": 0.0, "zero_scan_ambit": 0.0,
           "cpu_fallback_copy": 0.0, "cpu_fallback_init": 0.0,
           "cpu_fallback_bitwise": 0.0,
           "kv_write_cpu": 0.0, "prefix_hit_rowclone": 0.0,
           "state_rowclone_copy": 0.0, "state_rowclone_init": 0.0,
           "state_write_cpu": 0.0}
    cpu = {"memcpy": 0.0, "calloc": 0.0, "bitwise": 0.0, "zero_scan": 0.0,
           "kv_write_cpu": 0.0, "prefix_hit_memcpy": 0.0,
           "state_memcpy": 0.0, "state_calloc": 0.0, "state_write_cpu": 0.0}
    _BITWISE_OP = {"page_and": "and", "page_or": "or", "page_not": "not"}

    for ev in trace.events:
        if ev.kind == "page_copy":
            cpu["memcpy"] += ev.n * costs.cpu_copy_ns()
            # pair up; RowClone where src/dst share a subarray, CPU else
            pim_pairs: Dict[int, List[Tuple[int, int]]] = {}
            for s, d in zip(ev.src, ev.dst):
                sa, da = row_of(s), row_of(d)
                if sa.group == da.group:
                    pim_pairs.setdefault(sa.group, []).append(
                        (sa.rows[0], da.rows[0]))
                else:   # graceful fallback: cross-subarray copy
                    rec = lib.cpu_copy(sa, da)
                    receipts.append(rec)
                    pim["cpu_fallback_copy"] += rec.latency_ns
            for g, pairs in pim_pairs.items():
                src = Allocation(rows=tuple(p[0] for p in pairs), group=g)
                dst = Allocation(rows=tuple(p[1] for p in pairs), group=g)
                rec = lib.copy(src, dst, blocking=Blocking.FIN)
                receipts.append(rec)
                pim["rowclone_copy"] += rec.latency_ns
        elif ev.kind in _BITWISE_OP:
            # Ambit bitwise: TRA sequences where operands share a
            # subarray, CPU read-modify-write fallback across subarrays
            # — same shape as the page_copy pairing above.
            op = _BITWISE_OP[ev.kind]
            cpu["bitwise"] += ev.n * costs.cpu_bitwise_ns()
            bw_pairs: Dict[int, List[Tuple[int, int]]] = {}
            for s, d in zip(ev.src, ev.dst):
                sa, da = row_of(s), row_of(d)
                if sa.group == da.group:
                    bw_pairs.setdefault(sa.group, []).append(
                        (sa.rows[0], da.rows[0]))
                else:
                    rec = lib.cpu_bitwise(op, sa, da)
                    receipts.append(rec)
                    pim["cpu_fallback_bitwise"] += rec.latency_ns
            for g, pairs in bw_pairs.items():
                src = Allocation(rows=tuple(p[0] for p in pairs), group=g)
                dst = Allocation(rows=tuple(p[1] for p in pairs), group=g)
                rec = lib.bitwise(op, src, dst, blocking=Blocking.FIN)
                receipts.append(rec)
                pim["ambit_bitwise"] += rec.latency_ns
        elif ev.kind == "page_zero_scan":
            # Read-only scan: CPU pays a word-compare pass per page; the
            # Ambit account OR-reduces the candidate rows into B-group
            # scratch (one TRA sequence per page) and word-scans only the
            # one result row.  Accounted analytically — the scan never
            # mutates the arena, so there is no device state to replay.
            cpu["zero_scan"] += ev.n * costs.cpu_scan_ns()
            ns = costs.zero_scan_batched_ns(ev.n)
            receipts.append(OpReceipt(True, "ambit_zero_scan", face=lib.face,
                                      n_ops=ev.n, latency_ns=ns))
            pim["zero_scan_ambit"] += ns
        elif ev.kind == "page_init":
            cpu["calloc"] += ev.n * costs.cpu_init_ns()
            byte_fill = (float(ev.value).is_integer()
                         and 0 <= ev.value <= 255)
            for g, alloc in grouped(ev.dst).items():
                # non-byte fills (legal on the torch face) have no device
                # representation: account them as CPU memsets instead of
                # aborting the replay
                rec = (lib.init(alloc, ev.value, blocking=Blocking.FIN)
                       if byte_fill else lib.cpu_init(alloc))
                receipts.append(rec)
                key = ("rowclone_init" if rec.op == "rowclone_init"
                       else "cpu_fallback_init")
                pim[key] += rec.latency_ns
        elif ev.kind == "kv_write":
            # Slot-granular KV writes replay as CPU writes on both
            # accounts (speedup 1x): the PimLib protocol has no
            # slot-granular op, so even a future model-face KV_WRITE
            # sequence (lib.supports(Opcode.KV_WRITE)) would need a
            # protocol extension before replay could dispatch it.
            ns = mc.memcpy_ns(max(ev.nbytes, 1))
            rec = OpReceipt(True, "cpu_write", face=lib.face, n_ops=ev.n,
                            latency_ns=ns)
            receipts.append(rec)
            pim["kv_write_cpu"] += ns
            cpu["kv_write_cpu"] += ns
        elif ev.kind == "state_copy":
            # copy-on-fork of whole state rows: all state rows share one
            # subarray by construction, so these are always legal
            # same-group RowClones; the CPU baseline memcpys each row
            cpu["state_memcpy"] += ev.n * costs.cpu_copy_ns()
            src = Allocation(rows=tuple(srow_of(s).rows[0] for s in ev.src),
                             group=groups[0])
            dst = Allocation(rows=tuple(srow_of(d).rows[0] for d in ev.dst),
                             group=groups[0])
            rec = lib.copy(src, dst, blocking=Blocking.FIN)
            receipts.append(rec)
            pim["state_rowclone_copy"] += rec.latency_ns
        elif ev.kind == "state_init":
            cpu["state_calloc"] += ev.n * costs.cpu_init_ns()
            alloc = Allocation(rows=tuple(srow_of(d).rows[0] for d in ev.dst),
                               group=groups[0])
            byte_fill = (float(ev.value).is_integer()
                         and 0 <= ev.value <= 255)
            rec = (lib.init(alloc, ev.value, blocking=Blocking.FIN)
                   if byte_fill else lib.cpu_init(alloc))
            receipts.append(rec)
            pim["state_rowclone_init"] += rec.latency_ns
        elif ev.kind == "ssm_state_write":
            # slot-granular recurrent-state scatter: like KV_WRITE, the
            # SSM_STATE_WRITE opcode has no DDR3 sequence — the model
            # face reports it unsupported, so replay prices it as CPU
            # traffic on both accounts (graceful capability fallback)
            ns = mc.memcpy_ns(max(ev.nbytes, 1))
            rec = OpReceipt(True, "cpu_write", face=lib.face, n_ops=ev.n,
                            latency_ns=ns)
            receipts.append(rec)
            pim["state_write_cpu"] += ns
            cpu["state_write_cpu"] += ns
        elif ev.kind == "prefix_hit":
            # A radix prefix-cache hit: on the torch face the attach was
            # free (refcount++), but it displaced the per-request bulk
            # materialization of n prefix pages that a cache-less server
            # would pay.  Account that displaced work analytically —
            # one batched RowClone (one POC handshake + n sequences) vs
            # n CPU row memcpys — without consuming device scratch rows
            # (the twin's subarrays have pages_per_slab + 2 rows; a
            # popular prefix is re-hit far more often than that).
            cpu["prefix_hit_memcpy"] += ev.n * costs.cpu_copy_ns()
            ns = costs.rowclone_copy_batched_ns(ev.n)
            receipts.append(OpReceipt(True, "rowclone_copy", face=lib.face,
                                      n_ops=ev.n, latency_ns=ns))
            pim["prefix_hit_rowclone"] += ns
        else:
            raise ValueError(f"unknown trace event kind {ev.kind!r}")

    pim_total = sum(pim.values())
    cpu_total = sum(cpu.values())
    # fallback latencies stay in the denominators: the per-kind speedup
    # reflects what the workload actually achieved, fallbacks included
    copy_pim = pim["rowclone_copy"] + pim["cpu_fallback_copy"]
    init_pim = pim["rowclone_init"] + pim["cpu_fallback_init"]
    bitwise_pim = pim["ambit_bitwise"] + pim["cpu_fallback_bitwise"]
    return {
        "counts": trace.counts(),
        "events": len(trace),
        # the twin controller's own account: PiM sequences dispatched,
        # refreshes the bank-state clock folded in (tREFI/tRFC), and the
        # device-time the replay consumed — evidence the PiM totals ride
        # the cycle-accurate face, not an analytic shortcut
        "device_stats": dict(mc.stats, now_ns=mc.now_ns),
        "pim_ns": dict(pim, total=pim_total),
        "cpu_ns": dict(cpu, total=cpu_total),
        "speedup": {
            "copy": (cpu["memcpy"] / copy_pim) if copy_pim else None,
            "init": (cpu["calloc"] / init_pim) if init_pim else None,
            "state_copy": ((cpu["state_memcpy"]
                            / pim["state_rowclone_copy"])
                           if pim["state_rowclone_copy"] else None),
            "state_init": ((cpu["state_calloc"]
                            / pim["state_rowclone_init"])
                           if pim["state_rowclone_init"] else None),
            "bitwise": (cpu["bitwise"] / bitwise_pim) if bitwise_pim else None,
            "zero_scan": ((cpu["zero_scan"] / pim["zero_scan_ambit"])
                          if pim["zero_scan_ambit"] else None),
            "prefix": ((cpu["prefix_hit_memcpy"] / pim["prefix_hit_rowclone"])
                       if pim["prefix_hit_rowclone"] else None),
            "end_to_end": (cpu_total / pim_total) if pim_total else None,
        },
        "receipts": receipts,
    }
