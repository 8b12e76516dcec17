"""What a CUDA-only ``torch.profiler`` run of one steady stretch says.

Reads the raw activity records (a stretch holds ~10^5 kernels, too many
for the profiler's event tree) into one :class:`Stretch`: every device
interval with its name and stream, the stretch's host wall, and the
work the stretch did as the benchmark counted it. The per-layer metric
readers under ``benchmark/metrics/`` take their numbers from it; only
these summaries are kept, never the trace.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

_KERNEL = re.compile(r"(\w+_kernel)(<[\w, ]*>)?")
_NATIVE = re.compile(r"at::native::(?:\w+::)*?"
                     r"(\w+(?:Functor|_kernel_cuda|_impl)\w*)")


def short_name(name: str) -> str:
    """A kernel's name without its arguments and long template
    parameters: ``void qgemv_kernel<2, 4>(Gemv)`` -> ``qgemv_kernel<2,
    4>``; PyTorch's elementwise kernels keep the functor they apply
    (``unrolled_elementwise_kernel[direct_copy_kernel_cuda]``); other
    names are cut to 60 characters."""
    m = _KERNEL.search(name)
    if not m:
        return name[:60]
    native = _NATIVE.findall(name)
    return m.group(0) + (f"[{native[-1]}]" if native else "")


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy"))


@dataclass
class Span:
    start_ns: int
    end_ns: int
    name: str
    stream: int


@dataclass
class Stretch:
    """One profiled stretch: the device spans and the host wall
    (seconds), which the harness takes, and what the driver counted of
    the stretch's work: the model's operations for it (``model_flops``)
    and the rows it served (``rows``, windows for Whisper), and the
    driver's own numbers (Whisper's: the batches it ran as (bucket,
    rows, steps), the configuration's and traffic's numbers (``model``,
    ``decode``), and each ``decode_encoded`` call's span on the decoding
    stream (seconds, steps))."""
    spans: List[Span]
    wall_s: float
    batches: List[dict] = field(default_factory=list)
    model: dict = field(default_factory=dict)
    decode: dict = field(default_factory=dict)
    decode_spans: List[Tuple[float, int]] = field(default_factory=list)
    model_flops: float = 0.0
    rows: int = 0

    # -- device time -----------------------------------------------------
    def kernel_s(self, patterns: Iterable[str]) -> float:
        """Summed device seconds of the kernels whose names hold any of
        ``patterns``."""
        pats = tuple(patterns)
        return sum(s.end_ns - s.start_ns for s in self.spans
                   if any(p in s.name for p in pats)) / 1e9

    def busy_s(self) -> float:
        """The union of the device's activity intervals, in seconds."""
        return _union(self.spans) / 1e9

    def stream_of(self, pattern: str) -> Optional[int]:
        """The stream that ran the kernels named ``pattern`` (None where
        none ran)."""
        for s in self.spans:
            if pattern in s.name:
                return s.stream
        return None

    def stream_kernel_s(self, stream: int) -> float:
        return sum(s.end_ns - s.start_ns for s in self.spans
                   if s.stream == stream and is_kernel(s.name)) / 1e9

    def concurrent_s(self) -> float:
        """Device seconds in which kernels of two or more streams run at
        once."""
        events = []
        for s in self.spans:
            if not is_kernel(s.name):
                continue
            events.append((s.start_ns, 1, s.stream))
            events.append((s.end_ns, -1, s.stream))
        events.sort(key=lambda e: (e[0], e[1]))
        active: Dict[int, int] = defaultdict(int)
        busy_streams, t_prev, total = 0, None, 0
        for t, delta, stream in events:
            if busy_streams >= 2 and t_prev is not None:
                total += t - t_prev
            before = active[stream] > 0
            active[stream] += delta
            busy_streams += int(active[stream] > 0) - int(before)
            t_prev = t
        return total / 1e9

    # -- breakdown -------------------------------------------------------
    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, int] = defaultdict(int)
        for s in self.spans:
            by[short_name(s.name)] += s.end_ns - s.start_ns
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time between activities, summed by the
        device operation that ran before each gap (the host's work after
        that operation is what the device waited for)."""
        by: Dict[str, int] = defaultdict(int)
        end, last = None, None
        for s in sorted(self.spans, key=lambda s: s.start_ns):
            if end is not None and s.start_ns > end:
                by[f"after {short_name(last)}"] += s.start_ns - end
            if end is None or s.end_ns > end:
                end, last = s.end_ns, s.name
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _union(spans: List[Span]) -> int:
    total, end = 0, None
    for s in sorted(spans, key=lambda s: s.start_ns):
        if end is None or s.start_ns >= end:
            total += s.end_ns - s.start_ns
            end = s.end_ns
        elif s.end_ns > end:
            total += s.end_ns - end
            end = s.end_ns
    return total


def device_spans(prof) -> List[Span]:
    """The CUDA activity records of a finished profiler run."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start = e.start_ns()
            out.append(Span(start, start + e.duration_ns(), e.name(),
                            e.device_resource_id()))
    return out
