"""The program's host spans laid over a profiled slice.

The program records a span at each of its engine's layer boundaries
(``repro_torch.serving.spans``): name, start and end in ns on the wall
clock, which is the clock the profiler stamps its host events with, the
enclosing span and an id.  It records them only while a profiler runs,
and it adds no profiler annotation of its own: an annotation would sit
on the device timeline, where ``Slice.from_profiler`` counts every event
not named ``bench.*`` as device work.

A slice (:class:`bench.trace.Slice`) holds events in µs from the trace's
start.  ``base_ns`` maps one onto the other: a span's time in the slice
is ``(ns - base_ns) / 1e3``.  It comes either from the trace's start
(``trace_start_ns`` of the profiler's results) or, where the reader has
only the slice, from the pairs of the harness's ``bench.engine_run``
event and the program's ``engine.run`` span inside it: the median of
the differences of their midpoints.

Where the program records no spans (an older program), :func:`lay`
returns None and the readers report nothing.  A slice that holds no
engine call (the harness can open it just before the window closes)
holds no span either: the engine's idle there is 0.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from bench.trace import Slice, gaps

Interval = Tuple[float, float]
# the harness's span around each engine call, and the program's inside it
CALL = "bench.engine_run"
RUN = "engine.run"
WAIT = "device.wait"


def program_spans() -> Optional[list]:
    """The program's recorded spans, or None where it has no span log."""
    try:
        from repro_torch.serving import spans
    except ImportError:
        return None
    return spans.recorded()


def base_from_trace_start(trace_start_ns: int) -> int:
    return int(trace_start_ns)


def base_from_pairs(sl: Slice, spans: Sequence) -> Optional[int]:
    """``base_ns`` from the slice's engine calls and the newest as many
    ``engine.run`` spans (the ones recorded while this slice ran), or
    None when the log holds fewer."""
    calls = sorted((s, e) for n, s, e in sl.host if n == CALL)
    runs = sorted((sp.start, sp.end) for sp in spans if sp.name == RUN)
    if not calls or len(runs) < len(calls):
        return None
    runs = runs[len(runs) - len(calls):]
    # in whole ns: a wall-clock ns is past float64's integers
    diffs = sorted((rs + re) // 2 - round((cs + ce) / 2 * 1e3)
                   for (cs, ce), (rs, re) in zip(calls, runs))
    return diffs[len(diffs) // 2]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def intersect(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """The points in both of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def total(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in intervals)


class Cover:
    """Sorted, disjoint intervals with prefix sums: the length of their
    overlap with any interval in O(log n)."""

    def __init__(self, intervals: Sequence[Interval]) -> None:
        self.starts = [s for s, _ in intervals]
        self.ends = [e for _, e in intervals]
        self.cum = [0.0]
        for s, e in intervals:
            self.cum.append(self.cum[-1] + e - s)

    def overlap(self, s: float, e: float) -> float:
        if e <= s:
            return 0.0
        i = bisect.bisect_right(self.ends, s)      # first ending after s
        j = bisect.bisect_left(self.starts, e)     # first starting at/after e
        if i >= j:
            return 0.0
        out = self.cum[j] - self.cum[i]
        out -= max(0.0, s - self.starts[i])
        out -= max(0.0, self.ends[j - 1] - e)
        return out


class Laid:
    """The program's spans on a slice's clock (µs from the trace's start,
    clipped to the slice), with the slice's idle stretches."""

    def __init__(self, sl: Slice, spans: Sequence, base_ns: int) -> None:
        self.slice = sl
        lo, hi = sl.start_us, sl.end_us
        self.rows = []                  # (name, start_us, end_us, span)
        for sp in spans:
            s = max((sp.start - base_ns) / 1e3, lo)
            e = min((sp.end - base_ns) / 1e3, hi)
            if s < e:
                self.rows.append((sp.name, s, e, sp))
        self.idle = gaps([(s, e) for _, s, e in sl.device], lo, hi)
        self._idle = Cover(self.idle)

    def of(self, name: str) -> List[Interval]:
        return union((s, e) for n, s, e, _ in self.rows if n == name)

    def run_idle_us(self) -> float:
        """Idle µs of the slice inside ``engine.run``."""
        return total(intersect(self.idle, self.of(RUN)))

    def engine_idle_us(self) -> float:
        """Idle µs of the slice inside ``engine.run`` and outside every
        ``device.wait``: the idle the program's host work causes."""
        inside = intersect(self.idle, self.of(RUN))
        return total(inside) - total(intersect(inside, self.of(WAIT)))

    def idle_by_phase(self) -> Dict[str, float]:
        """Idle µs inside ``engine.run``, each put down to the innermost
        span around it (an enclosing span's own share is its idle outside
        every span it holds), by span name, largest first."""
        kids: Dict[int, List[Tuple[float, float]]] = {}
        keep = {id(sp) for _, _, _, sp in self.rows}
        for _, s, e, sp in self.rows:
            p = sp.parent
            if p is not None and id(p) in keep:
                kids.setdefault(id(p), []).append((s, e))
        out: Dict[str, float] = {}
        for name, s, e, sp in self.rows:
            own = self._idle.overlap(s, e) - sum(
                self._idle.overlap(a, b) for a, b in kids.get(id(sp), ()))
            if own > 0:
                out[name] = out.get(name, 0.0) + own
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def lay(sl: Optional[Slice], spans: Optional[Sequence] = None,
        base_ns: Optional[int] = None) -> Optional[Laid]:
    """The program's spans (by default its log) over slice ``sl``, aligned
    by ``base_ns`` or else by the engine-call pairs; None when there is
    no slice, no span log, or nothing to align."""
    if sl is None:
        return None
    if spans is None:
        spans = program_spans()
    if spans is None:
        return None
    if not any(n == CALL for n, _, _ in sl.host):
        return Laid(sl, [], 0)
    if base_ns is None:
        base_ns = base_from_pairs(sl, spans)
    if base_ns is None:
        return None
    return Laid(sl, spans, base_ns)
