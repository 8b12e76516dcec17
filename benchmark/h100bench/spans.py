"""The port's host spans beside a profiled stretch's device spans.

Under ``WJAV_TRACE_BATCHES=1``, which the harness sets for the profiled
file, the port's engine and decode loop record host spans
(``whisperjav_tpu_torch/utils/tracer.py``): a name, a start and an end
on ``time.perf_counter_ns()``, a parent, a batch id and counters, with
an anchor that maps them onto Unix-epoch nanoseconds, the clock of the
profiler's activity records. This module takes the spans of the
latest recorder the port made in this process (or the stretch's own
``program_spans``, where a stretch carries them), maps them onto that
clock, and measures the device's idle time inside them. A port without
the recorder gives no spans: the readers built on these return None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

OUTSIDE = "outside spans"


@dataclass
class HostSpan:
    """One program span on the profiler's clock: ``depth`` counts its
    ancestors."""
    start_ns: int
    end_ns: int
    name: str
    depth: int = 0
    batch: object = None
    counters: Dict[str, object] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def program_spans(stretch) -> List[HostSpan]:
    """The stretch's ``program_spans``, or the closed spans of the port's
    latest recorder mapped onto the profiler's clock; [] where there are
    none."""
    given = getattr(stretch, "program_spans", None)
    if given is not None:
        return list(given)
    try:
        from whisperjav_tpu_torch.utils.tracer import latest
    except ImportError:
        return []
    rec = latest()
    if rec is None:
        return []
    depth: Dict[int, int] = {}
    out = []
    for s in rec.spans:       # a parent opens before its children
        depth[id(s)] = 0 if s.parent is None else depth[id(s.parent)] + 1
        if s.end_ns is not None:
            out.append(HostSpan(rec.epoch_ns(s.start_ns),
                                rec.epoch_ns(s.end_ns), s.name,
                                depth[id(s)], s.batch, dict(s.counters)))
    return out


class Busy:
    """The union of the device's activity intervals, for the busy
    nanoseconds inside any host interval."""

    def __init__(self, spans: Iterable):
        self.starts: List[int] = []
        self.ends: List[int] = []
        for s in sorted(spans, key=lambda s: s.start_ns):
            if self.ends and s.start_ns <= self.ends[-1]:
                self.ends[-1] = max(self.ends[-1], s.end_ns)
            else:
                self.starts.append(s.start_ns)
                self.ends.append(s.end_ns)
        self.before_start = [0]     # busy ns before each interval
        for a, b in zip(self.starts, self.ends):
            self.before_start.append(self.before_start[-1] + b - a)

    @property
    def total(self) -> int:
        return self.before_start[-1]

    def until(self, t: int) -> int:
        """Busy nanoseconds before ``t``."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0:
            return 0
        return self.before_start[i] + min(t, self.ends[i]) - self.starts[i]

    def within(self, a: int, b: int) -> int:
        return self.until(b) - self.until(a)


def _union(intervals: Iterable[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def idle_within(busy: Busy, spans: Iterable[HostSpan]) -> float:
    """Seconds of the union of ``spans`` in which the device ran
    nothing."""
    return sum((b - a) - busy.within(a, b)
               for a, b in _union((s.start_ns, s.end_ns)
                                  for s in spans)) / 1e9


def innermost_at(spans: Iterable[HostSpan], t: int) -> Optional[HostSpan]:
    """The deepest span open at ``t`` (the later opened of two as deep),
    None outside every span."""
    best = None
    for s in spans:
        if s.start_ns <= t < s.end_ns and (
                best is None
                or (s.depth, s.start_ns) > (best.depth, best.start_ns)):
            best = s
    return best


def idle_by_span(stretch, n: int = 10) -> List[list]:
    """The device's idle seconds in the stretch summed by the innermost
    program span open over them, the idle time no span covers under
    ``outside spans``; the ``n`` longest, [] without program or device
    spans."""
    spans = program_spans(stretch)
    if not spans or not stretch.spans:
        return []
    busy = Busy(stretch.spans)
    edges = sorted({t for s in spans for t in (s.start_ns, s.end_ns)})
    opening: Dict[int, list] = defaultdict(list)
    closing: Dict[int, list] = defaultdict(list)
    for s in spans:
        opening[s.start_ns].append(s)
        closing[s.end_ns].append(s)
    by: Dict[str, float] = defaultdict(float)
    active: Dict[int, HostSpan] = {}
    for a, b in zip(edges, edges[1:]):
        for s in closing[a]:
            active.pop(id(s), None)
        for s in opening[a]:
            if s.end_ns > a:
                active[id(s)] = s
        inner = innermost_at(active.values(), a)
        if inner is not None:
            by[inner.name] += ((b - a) - busy.within(a, b)) / 1e9
    by[OUTSIDE] = stretch.wall_s - busy.total / 1e9 - sum(by.values())
    return [[k, v] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:n]]
