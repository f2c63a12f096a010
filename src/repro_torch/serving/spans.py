"""Host spans at the serving engine's layer boundaries, on the profiler's
clock.

A span brackets one phase of the engine's host work (admission, the
chunk schedule, operand uploads, a step's launch, the token choice, the
commits, the frees, the op queue's flushes, every wait for the card).
Each span does two jobs:

* always, it adds its host seconds to a total in the owning engine's
  ``stats`` dict, under :func:`key` of its name (``engine.prefill`` ->
  ``prefill_seconds``);
* while a ``torch.profiler`` records (checked once, when ``engine.run``
  is entered), it also appends a :class:`Span` to a bounded in-memory
  log, read with :func:`recorded`; the log keeps the newest
  :data:`LOG_SPANS` spans.

The stamps are ``time.time_ns()``: the wall clock in ns, which is the
clock the profiler stamps its host events with (an event's start is
``trace_start_ns`` plus its offset), so a recorded span can be laid over
a profiled slice.  A span records nothing on the device: no profiler
annotation (which would appear on the device timeline as work), no
synchronise, no device allocation.

One counter lives here too: a *drain* is a ``device.wait`` (a blocking
readback or stream wait, so the stream is empty when it returns); at the
next ``engine.launch`` of a fused step, the host seconds since the first
drain after the previous launch go to ``stats["host_gap_seconds"]`` and
one to ``stats["host_gaps"]``: the host time in which the card had no
step of the engine's to run.  The gap's clock runs inside ``engine.run``
only (a drain before a call counts from the call's entry).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional

import torch

#: the most spans the log keeps (the oldest are dropped first)
LOG_SPANS = 1 << 16

#: every span the engine records, outermost first
NAMES = ("engine.run", "engine.prefill", "engine.decode",
         "engine.mixed_round", "engine.block", "engine.admit",
         "engine.schedule", "engine.reserve", "pim.flush",
         "engine.operands", "engine.launch", "graphs.first_use",
         "graphs.capture", "engine.choose", "engine.commit", "device.wait",
         "engine.finish", "kv.free")

_KEYS = {"engine.mixed_round": "mixed_seconds"}

_LOG: Deque["Span"] = deque(maxlen=LOG_SPANS)


def key(name: str) -> str:
    """The ``stats`` key of a span's total: the part after the dot, then
    ``_seconds`` (``engine.mixed_round`` -> ``mixed_seconds``)."""
    return _KEYS.get(name) or name.split(".", 1)[1] + "_seconds"


_KEY_OF = {name: key(name) for name in NAMES}


def recorded() -> List["Span"]:
    """The spans recorded while a profiler ran, in the order they ended."""
    return list(_LOG)


def clear() -> None:
    """Empty the log."""
    _LOG.clear()


class Span:
    """One recorded span: ``start`` and ``end`` in ns on the profiler's
    clock, the enclosing span (``parent``, None at the top) and ``id``:
    the engine's round index, or the request id of a per-request span."""

    __slots__ = ("name", "start", "end", "parent", "id")

    def __init__(self, name: str, parent: Optional["Span"],
                 id: Optional[int]) -> None:
        self.name = name
        self.start = self.end = 0
        self.parent = parent
        self.id = id

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start}, {self.end}, id={self.id}, "
                f"parent={self.parent.name if self.parent else None!r})")


class Tracer:
    """One engine's spans: the totals in ``stats`` (each key present from
    the start, so a caller's deltas always find it), the open spans while
    recording, the round index, and the host-gap counter."""

    def __init__(self, stats: Dict[str, float]) -> None:
        self.stats = stats
        for name in NAMES:
            stats.setdefault(key(name), 0.0)
        stats.setdefault("host_gap_seconds", 0.0)
        stats.setdefault("host_gaps", 0)
        #: the id a round span takes (the engine advances it)
        self.round = 0
        self.recording = False
        self.stack: List[Span] = []
        self._runs = 0
        self._drained: Optional[int] = None

    def span(self, name: str, id: Optional[int] = None) -> "_Scope":
        """A span of ``name``; ``id`` defaults to the round index."""
        return _Scope(self, name, self.round if id is None else id)

    def run(self) -> "_Run":
        """The ``engine.run`` span, which decides whether spans record."""
        return _Run(self, "engine.run", None)

    def launch(self) -> "_Launch":
        """An ``engine.launch`` span: one fused step's call."""
        return _Launch(self, "engine.launch", self.round)

    def wait(self) -> "_Wait":
        """A ``device.wait`` span: the host waits for the card."""
        return _Wait(self, "device.wait", self.round)


class _Scope:
    __slots__ = ("tracer", "name", "key", "id", "start", "rec")

    def __init__(self, tracer: Tracer, name: str, id: Optional[int]) -> None:
        self.tracer = tracer
        self.name = name
        self.key = _KEY_OF[name]
        self.id = id
        self.rec: Optional[Span] = None

    def __enter__(self) -> "_Scope":
        t = self.tracer
        if t.recording:
            self.rec = Span(self.name, t.stack[-1] if t.stack else None,
                            self.id)
            t.stack.append(self.rec)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self._close(end)

    def _close(self, end: int) -> None:
        t = self.tracer
        t.stats[self.key] += (end - self.start) * 1e-9
        rec = self.rec
        if rec is not None:
            rec.start, rec.end = self.start, end
            if t.stack and t.stack[-1] is rec:
                t.stack.pop()
            _LOG.append(rec)


class _Run(_Scope):
    __slots__ = ()

    def __enter__(self) -> "_Scope":
        t = self.tracer
        outer = t._runs == 0
        if outer:
            # is a torch.profiler recording?
            t.recording = torch._C._autograd._profiler_enabled()
            t.stack.clear()
        t._runs += 1
        super().__enter__()
        if outer and t._drained is not None:
            t._drained = self.start
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self._close(end)
        t = self.tracer
        t._runs -= 1
        if t._runs == 0:
            t.recording = False


class _Launch(_Scope):
    __slots__ = ()

    def __enter__(self) -> "_Scope":
        super().__enter__()
        t = self.tracer
        if t._drained is not None:
            t.stats["host_gap_seconds"] += (self.start - t._drained) * 1e-9
            t.stats["host_gaps"] += 1
            t._drained = None
        return self


class _Wait(_Scope):
    __slots__ = ()

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self._close(end)
        t = self.tracer
        if t._drained is None:
            t._drained = end
