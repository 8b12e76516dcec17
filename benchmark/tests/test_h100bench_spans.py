"""The span readers on hand-built stretches: the device's idle time
inside the port's host spans, the host milliseconds a decode step, the
idle time by innermost span, and nothing to read from a port that
records no spans."""

import sys
import types

import pytest

from h100bench import spec, spans as sp, trace as tr

MS = 1_000_000      # ns


def _stretch(program=None) -> tr.Stretch:
    """Device busy over [0, 10], [30, 40] and [70, 100] ms of a 120 ms
    wall; one batch whose decode loop ran two steps."""
    stretch = tr.Stretch(
        spans=[tr.Span(a * MS, b * MS, "k", 7)
               for a, b in ((0, 10), (30, 40), (70, 85), (80, 100))],
        wall_s=0.120, batches=[], model={}, decode={})
    if program is not None:
        stretch.program_spans = program
    return stretch


PROGRAM = [
    sp.HostSpan(0, 100 * MS, "engine.batch", 0, 0,
                {"bucket": 1500, "rows": 2, "rungs": 1, "tokens": 4}),
    sp.HostSpan(20 * MS, 90 * MS, "engine.decode", 1, 0),
    sp.HostSpan(20 * MS, 90 * MS, "decode.loop", 2, 0,
                {"steps": 2, "rows": 4}),
    sp.HostSpan(25 * MS, 50 * MS, "decode.step", 3, 0),
    sp.HostSpan(50 * MS, 80 * MS, "decode.step", 3, 0),
    sp.HostSpan(90 * MS, 100 * MS, "engine.drain", 1, 0),
]


@pytest.mark.parametrize("name,want", [
    ("decode.host_ms_per_step", 27.5),            # (25 + 30) ms / 2
    ("decode.idle_pct", 100 * 40 / 120),          # [20,30] [40,70]
    ("engine.idle_pct", 100 * 10 / 120),          # [10,20]
])
def test_reader(name, want):
    assert spec.metric(name).read(_stretch(PROGRAM)) == pytest.approx(
        want, rel=1e-12)


def test_idle_by_span():
    got = sp.idle_by_span(_stretch(PROGRAM))
    want = [["decode.step", 0.035], ["outside spans", 0.020],
            ["engine.batch", 0.010], ["decode.loop", 0.005],
            ["engine.drain", 0.0]]
    assert [k for k, _ in got] == [k for k, _ in want]
    assert [v for _, v in got] == pytest.approx([v for _, v in want],
                                                abs=1e-15)
    # the idle seconds it names add up to the device's idle time
    stretch = _stretch(PROGRAM)
    assert sum(v for _, v in got) == pytest.approx(
        stretch.wall_s - stretch.busy_s(), abs=1e-15)


def test_innermost_and_idle_within():
    assert sp.innermost_at(PROGRAM, 30 * MS).name == "decode.step"
    assert sp.innermost_at(PROGRAM, 85 * MS).name == "decode.loop"
    assert sp.innermost_at(PROGRAM, 100 * MS) is None
    busy = sp.Busy(_stretch().spans)
    assert busy.total == 50 * MS
    assert busy.within(5 * MS, 75 * MS) == 20 * MS
    assert sp.idle_within(busy, PROGRAM[3:5]) == pytest.approx(0.035)


def test_spans_of_the_ports_recorder(monkeypatch):
    """A recorder's spans mapped by its anchor onto the epoch clock,
    with their depth, batch and counters; open spans left out."""
    from whisperjav_tpu_torch.utils import tracer
    rec = tracer.SpanRecorder()
    rec.anchor = (1_000 * MS, 10 * MS)
    root = rec.child("engine.batch", 3)
    loop = root.child("decode.loop")
    rec.child("engine.retry", "retry")            # never closed
    for span, (a, b) in ((root, (10, 30)), (loop, (12, 20))):
        span.start_ns, span.end_ns = a * MS, b * MS
    loop.counters["steps"] = 5
    got = sp.program_spans(_stretch())
    assert got == [
        sp.HostSpan(1_000 * MS, 1_020 * MS, "engine.batch", 0, 3, {}),
        sp.HostSpan(1_002 * MS, 1_010 * MS, "decode.loop", 1, 3,
                    {"steps": 5})]


def test_nothing_to_read_without_spans(monkeypatch):
    """A port whose tracer has no recorder (the parent of the spans), or
    a stretch with no device spans: every reader None, no breakdown."""
    bare = types.ModuleType("whisperjav_tpu_torch.utils.tracer")
    monkeypatch.setitem(sys.modules, "whisperjav_tpu_torch.utils.tracer",
                        bare)
    names = ("decode.host_ms_per_step", "decode.idle_pct",
             "engine.idle_pct")
    assert sp.program_spans(_stretch()) == []
    assert all(spec.metric(n).read(_stretch()) is None for n in names)
    assert sp.idle_by_span(_stretch()) == []
    no_device = _stretch(PROGRAM)
    no_device.spans = []
    assert spec.metric("decode.idle_pct").read(no_device) is None
    assert spec.metric("engine.idle_pct").read(no_device) is None
    assert sp.idle_by_span(no_device) == []
