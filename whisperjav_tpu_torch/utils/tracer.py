"""Parameter tracing and the engine's span recorder.

Parameter tracing (``--trace-params``): the port's copy of
``whisperjav_tpu/utils/tracer.py``, a streaming JSONL event log with the
same records (``t``, ``ts``, ``event``, ``data``), so a trace either
package wrote reads the same. Events: ``config``, ``file_start``,
``segmentation``, ``file_complete``; :class:`NullTracer` is the no-op
with the same interface.

Spans (``WJAV_TRACE_BATCHES=1``): a :class:`SpanRecorder` keeps, in
memory, timed stretches of host work (:class:`Span`) with their parent,
batch id, shard and counters, on ``time.perf_counter_ns()``'s clock; its
``anchor`` maps them onto Unix-epoch nanoseconds, the clock of
``torch.profiler``'s activity records. The engine opens spans with
:func:`span` and :func:`child`, which do nothing without a recorder;
code below the engine (the decode loops) opens its own under the
innermost span the engine entered (:func:`current`), so with tracing
off it reads one context variable a call and nothing more. A stage
whose device work should lie inside its own span closes it with
:meth:`Span.close_synced`, which waits for the device first.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Union


class ParameterTracer:
    def __init__(self, path: Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._t0 = time.time()

    def event(self, kind: str, data: Optional[Dict[str, Any]] = None) -> None:
        rec = {
            "t": round(time.time() - self._t0, 4),
            "ts": time.time(),
            "event": kind,
            "data": _jsonable(data or {}),
        }
        self._fh.write(json.dumps(rec, ensure_ascii=False) + "\n")
        self._fh.flush()

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NullTracer:
    """No-op tracer; same interface."""

    def event(self, kind: str, data: Optional[Dict[str, Any]] = None) -> None:
        pass

    def close(self) -> None:
        pass


def create_tracer(path: Optional[Path]) -> Any:
    return ParameterTracer(path) if path else NullTracer()


def _jsonable(obj):
    """Numpy-safe JSON conversion (reference keeps the same guard in its
    metadata manager)."""
    import numpy as np
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

# the innermost span entered in this context (None: not traced), and the
# mesh shard the context works for
_OPEN: contextvars.ContextVar = contextvars.ContextVar(
    "whisperjav_tpu_torch_span", default=None)
_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "whisperjav_tpu_torch_shard", default=0)
_LATEST: Optional["SpanRecorder"] = None


class Span:
    """One stretch of host work: ``name``, ``start_ns`` and ``end_ns``
    (``time.perf_counter_ns()``; None while open), ``parent`` (None at the
    top), ``batch`` (the batch index; ``retry`` for the deferred retry,
    ``retry:<rung>`` for its batches), ``shard`` and ``counters``.

    A child takes its parent's batch unless given one. :meth:`lap`
    records a child that ran from where the last child ended (or from
    this span's start) to now: one clock read a phase."""

    __slots__ = ("recorder", "name", "start_ns", "end_ns", "parent",
                 "batch", "shard", "counters", "_mark")

    def __init__(self, recorder: "SpanRecorder", name: str,
                 parent: Optional["Span"], batch, start_ns: int,
                 end_ns: Optional[int] = None):
        self.recorder = recorder
        self.name = name
        self.parent = parent
        self.batch = batch if batch is not None or parent is None \
            else parent.batch
        self.shard = _SHARD.get()
        self.start_ns = self._mark = start_ns
        self.end_ns = end_ns
        self.counters: Dict[str, Any] = {}
        recorder.spans.append(self)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def child(self, name: str, batch=None) -> "Span":
        """A child opened now; close it with :meth:`close`."""
        return Span(self.recorder, name, self, batch, time.perf_counter_ns())

    def span(self, name: str, batch=None):
        """A child opened now, entered (code below finds it with
        :func:`current`) and closed when the block ends."""
        return _entered(self.child(name, batch))

    def lap(self, name: str) -> None:
        now = time.perf_counter_ns()
        Span(self.recorder, name, self, None, self._mark, now)
        self._mark = now

    def close(self, **counters) -> None:
        self.end_ns = time.perf_counter_ns()
        self.counters.update(counters)
        if self.parent is not None:
            self.parent._mark = self.end_ns

    def close_synced(self, device, **counters) -> None:
        """:meth:`close` once ``device`` has run the work queued so far
        (a CUDA device; elsewhere at once): on the device trace's clock
        the stage's device work then lies inside the span, for readers
        that take the device's busy time within it. Traced runs only:
        the wait holds the host back from queueing the next stage."""
        import torch
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        self.close(**counters)


class SpanRecorder:
    """The spans of one traced call, in the order they opened, and the
    anchor ``(time.time_ns(), time.perf_counter_ns())`` taken together
    when the recorder started. The latest recorder made in the process
    stays readable through :func:`latest` after its owner is gone."""

    def __init__(self):
        global _LATEST
        self.spans: List[Span] = []
        self.anchor = (time.time_ns(), time.perf_counter_ns())
        _LATEST = self

    def child(self, name: str, batch=None) -> Span:
        """A top-level span opened now."""
        return Span(self, name, None, batch, time.perf_counter_ns())

    def span(self, name: str, batch=None):
        return _entered(self.child(name, batch))

    def epoch_ns(self, t_ns: int) -> int:
        """A ``perf_counter_ns`` time on the Unix-epoch clock."""
        return self.anchor[0] + (t_ns - self.anchor[1])

    def self_seconds(self) -> Dict[str, float]:
        """Host seconds by span name, each instant put down to the
        innermost span open then (the deepest; of two as deep, the later
        opened): where spans nest, a span's length less its children's."""
        depth: Dict[int, int] = {}
        edges = []
        for s in self.spans:      # a parent opens before its children
            depth[id(s)] = 0 if s.parent is None else depth[id(s.parent)] + 1
            if s.end_ns is not None and s.end_ns > s.start_ns:
                edges += [(s.start_ns, 1, s), (s.end_ns, 0, s)]
        edges.sort(key=lambda e: e[:2])
        out: Dict[str, float] = defaultdict(float)
        active: Dict[int, Span] = {}
        prev = 0
        for t, opens, s in edges:
            if active and t > prev:
                inner = max(active.values(),
                            key=lambda x: (depth[id(x)], x.start_ns))
                out[inner.name] += (t - prev) / 1e9
            if opens:
                active[id(s)] = s
            else:
                del active[id(s)]
            prev = t
        return dict(out)


Under = Union[Span, SpanRecorder, None]


@contextlib.contextmanager
def _entered(span: Span) -> Iterator[Span]:
    token = _OPEN.set(span)
    try:
        yield span
    finally:
        _OPEN.reset(token)
        span.close()


def span(under: Under, name: str, batch=None):
    """``under.span(name, batch)``: a span entered for the block under a
    span (or at the top of a recorder); a null context when ``under`` is
    None."""
    return contextlib.nullcontext() if under is None \
        else under.span(name, batch)


def child(under: Under, name: str, batch=None) -> Optional[Span]:
    """``under.child(name, batch)``, or None when ``under`` is None."""
    return None if under is None else under.child(name, batch)


@contextlib.contextmanager
def within(span: Optional[Span]) -> Iterator[None]:
    """``span`` as the innermost span for the block, left open (code below
    opens its spans under it); nothing when ``span`` is None."""
    if span is None:
        yield
        return
    token = _OPEN.set(span)
    try:
        yield
    finally:
        _OPEN.reset(token)


def current() -> Optional[Span]:
    """The innermost span entered in this context (None when not
    traced)."""
    return _OPEN.get()


def set_shard(index: int) -> None:
    """Mark the spans this context opens from now on as shard
    ``index``'s (a mesh's host thread, in a context of its own)."""
    _SHARD.set(index)


def latest() -> Optional[SpanRecorder]:
    """The recorder made last in this process (None before the first)."""
    return _LATEST
