"""The reader of ``decode.graph_step_pct`` on hand-built stretches: the
replayed steps over the steps run, summed over the file's decode loops;
nothing to read from a port whose loops count no ``graph_steps``, or
that records no spans."""

import sys
import types

import pytest

from h100bench import spec, spans as sp, trace as tr

MS = 1_000_000      # ns
READ = spec.metric("decode.graph_step_pct").read


def _stretch(program=None) -> tr.Stretch:
    stretch = tr.Stretch(spans=[tr.Span(0, 10 * MS, "k", 7)], wall_s=0.040,
                         batches=[], model={}, decode={})
    if program is not None:
        stretch.program_spans = program
    return stretch


def _loop(start_ms, batch, counters):
    return sp.HostSpan(start_ms * MS, (start_ms + 10) * MS, "decode.loop",
                       2, batch, counters)


def test_graph_step_share():
    loops = [_loop(0, 0, {"steps": 128, "rows": 64, "graph_steps": 126,
                          "captures": 2}),
             _loop(20, 1, {"steps": 24, "rows": 64, "graph_steps": 24,
                           "captures": 0})]
    assert READ(_stretch(loops)) == pytest.approx(100 * 150 / 152,
                                                  rel=1e-12)


@pytest.mark.parametrize("program", [
    [_loop(0, 0, {"steps": 2, "rows": 4})],           # no graph counters
    [_loop(0, 0, {"steps": 0, "rows": 4, "graph_steps": 0,
                  "captures": 0})],                   # no steps run
    [],                                               # no loops
])
def test_nothing_to_read(program):
    assert READ(_stretch(program)) is None


def test_nothing_to_read_without_a_tracer(monkeypatch):
    """A port whose tracer has no recorder (the parent of the spans)."""
    bare = types.ModuleType("whisperjav_tpu_torch.utils.tracer")
    monkeypatch.setitem(sys.modules, "whisperjav_tpu_torch.utils.tracer",
                        bare)
    assert READ(_stretch()) is None
