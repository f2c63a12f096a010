"""Reading a ``torch.profiler`` slice: device busy time, kernel time by
group, and the longest idle gaps by what the host was doing.

Kernel names map to groups through one data file a group,
``bench/kernels/<group>.json``: ``{"group": name, "order": n,
"patterns": [regex, ...]}``.  Files are tried in ``order`` and the
first group with a pattern found in the name wins; a name no group
claims is ``unmatched``.  A later change that adds a kernel adds a
file.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

KERNELS = Path(__file__).resolve().parent / "kernels"
UNMATCHED = "unmatched"
# the harness's own spans around its calls into the program
SPAN_PREFIX = "bench."


def load_groups(folder: Path = KERNELS) -> List[Tuple[str, List[re.Pattern]]]:
    """(group, compiled patterns) in matching order."""
    rows = []
    for f in sorted(folder.glob("*.json")):
        d = json.loads(f.read_text())
        if d["group"] != f.stem:
            raise ValueError(f"{f}: group {d['group']!r} is not its name")
        rows.append((d["order"], d["group"],
                     [re.compile(p) for p in d["patterns"]]))
    rows.sort()
    return [(g, ps) for _, g, ps in rows]


def group_of(name: str, groups) -> str:
    for g, patterns in groups:
        if any(p.search(name) for p in patterns):
            return g
    return UNMATCHED


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals (any unit)."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Sequence[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The idle stretches of ``[start, end]`` that no interval covers."""
    out = []
    at = start
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if end > at:
        out.append((at, end))
    return out


class Slice:
    """What one profiled slice says: ``device`` events as ``(name,
    start_us, end_us)``, ``host`` events likewise (the harness's spans
    and the CPU operators), and the slice's bounds in the profiler's
    clock."""

    def __init__(self, device, host, start_us: float, end_us: float):
        self.device = device
        self.host = host
        self.start_us = start_us
        self.end_us = end_us
        self.groups = load_groups()

    @classmethod
    def from_profiler(cls, prof) -> "Slice":
        from torch.autograd import DeviceType

        device, host = [], []
        for e in prof.events():
            tr = e.time_range
            row = (e.name, float(tr.start), float(tr.end))
            if e.device_type == DeviceType.CUDA:
                # the device timeline also carries user annotations (the
                # harness's spans; ``nccl:all_reduce`` around each NCCL
                # kernel), which are not device work of their own
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith(SPAN_PREFIX)):
                    device.append(row)
            elif e.device_type == DeviceType.CPU:
                host.append(row)
        spans = [h for h in host if h[0].startswith(SPAN_PREFIX)]
        start = min((s for _, s, _ in spans), default=min(
            (s for _, s, _ in device + host), default=0.0))
        end = max((e for _, _, e in spans), default=max(
            (e for _, _, e in device + host), default=0.0))
        return cls(device, host, start, end)

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    @property
    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.device]) / 1e6

    def group_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.device:
            g = group_of(name, self.groups)
            out[g] = out.get(g, 0.0) + (e - s) / 1e6
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def kernel_names(self) -> List[str]:
        return sorted({n for n, _, _ in self.device})

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The ``top`` longest stretches with nothing on the device, each
        named by the innermost host event running at its middle
        (nested under the harness span around it)."""
        idle = gaps([(s, e) for _, s, e in self.device], self.start_us,
                    self.end_us)
        idle.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in idle[:top]:
            out.append([self._host_at((s + e) / 2), (e - s) / 1e6])
        return out

    def _host_at(self, t: float) -> str:
        around = [h for h in self.host if h[1] <= t <= h[2]]
        if not around:
            return "host: no recorded event"
        inner = min(around, key=lambda h: h[2] - h[1])
        span = [h for h in around if h[0].startswith(SPAN_PREFIX)]
        outer = min(span, key=lambda h: h[2] - h[1])[0] if span else ""
        if outer and outer != inner[0]:
            return f"{outer} > {inner[0]}"
        return inner[0]

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        ops = list(self.group_seconds().items())[:top]
        return {"device_ops": [[g, s] for g, s in ops],
                "idle_gaps": self.idle_gaps(top)}


def group_time(sl: Optional[Slice], group: str) -> Optional[float]:
    """Seconds the device spent in ``group``'s kernels in the slice, or
    None (no slice, or the group never ran)."""
    if sl is None:
        return None
    t = sl.group_seconds().get(group)
    return t if t else None
