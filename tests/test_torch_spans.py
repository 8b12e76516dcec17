"""The engine's and the decode loop's host spans (``WJAV_TRACE_BATCHES=1``,
``utils/tracer.py``): how they nest, their batch ids and counters, the
``batch_trace`` rows read off them, nothing recorded with tracing off,
and their clock against ``torch.profiler``'s (tiny model, real
vocabulary, f32 on the CPU; the clock once more on a card)."""

import time

import numpy as np
import pytest
import torch

from whisperjav_tpu_torch.models.whisper import decode as td
from whisperjav_tpu_torch.models.whisper.config import WhisperConfig
from whisperjav_tpu_torch.models.whisper.weights import init_params
from whisperjav_tpu_torch.parallel.batching import Window
from whisperjav_tpu_torch.parallel.mesh import make_mesh
from whisperjav_tpu_torch.pipelines.engine import (
    QualityThresholds, TranscriptionEngine,
)
from whisperjav_tpu_torch.utils import tracer

CFG = WhisperConfig(name="span-tiny", n_audio_state=64, n_audio_head=4,
                    n_audio_layer=2, n_text_state=64, n_text_head=4,
                    n_text_layer=2)
STEP_CHILDREN = ["decode.rules", "decode.select", "decode.forward",
                 "decode.stop_check"]
# each span's parent names (None: at the top)
PARENTS = {
    "engine.batch": {None}, "engine.retry": {None},
    "engine.upload": {None, "engine.batch"},
    "engine.encode": {"engine.batch", "engine.retry"},
    "engine.decode": {"engine.batch", "engine.ladder", "engine.retry"},
    "engine.drain": {"engine.batch", "engine.ladder", "engine.retry"},
    "engine.ladder": {"engine.batch"},
    "engine.extract": {"engine.batch", "engine.retry"},
    "engine.align": {"engine.batch", "engine.retry"},
    "decode.loop": {"engine.decode"},
    "decode.prefill": {"decode.loop"}, "decode.step": {"decode.loop"},
    "decode.finalize": {"decode.loop"},
    **{name: {"decode.step"} for name in STEP_CHILDREN},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_knobs(monkeypatch):
    for knob in ("WJAV_TRACE_BATCHES", "WJAV_ENCODE_AHEAD",
                 "WJAV_DECODE_AHEAD", "WJAV_DEFER_RETRY"):
        monkeypatch.delenv(knob, raising=False)


def _engine(max_new=12, beams=2, temps=(0.0, 0.4), batch_size=2,
            mesh=None):
    """Random weights; every row fails the logprob gate (threshold 1)."""
    model = init_params(CFG, torch.Generator().manual_seed(0))
    opts = td.DecodeOptions(
        max_new_tokens=max_new, beam_size=beams,
        suppress_tokens=td.DecodeOptions().suppress_tokens + (CFG.eot,))
    return TranscriptionEngine(
        CFG, model, options=opts,
        thresholds=QualityThresholds(logprob_threshold=1.0,
                                     temperatures=temps),
        batch_size=batch_size, device="cpu", compute_dtype=torch.float32,
        mesh=mesh)


def _windows(durations=(3.0, 8.0, 12.0, 3.0, 25.0)):
    rng = np.random.default_rng(7)
    return [Window((0.2 * rng.standard_normal(int(16000 * d))).astype(
        np.float32), 0.0, d, 0, i) for i, d in enumerate(durations)]


def _traced(engine, monkeypatch, wins=None, **knobs):
    monkeypatch.setenv("WJAV_TRACE_BATCHES", "1")
    for knob, value in knobs.items():
        monkeypatch.setenv(knob, value)
    engine.transcribe_windows(wins or _windows(), seed=3)
    assert tracer.latest() is engine.recorder
    return engine.recorder.spans


def _name(span):
    return None if span is None else span.name


@pytest.mark.parametrize("decode_ahead", ["0", "1"])
def test_spans_nest_as_listed(monkeypatch, decode_ahead):
    """Every span's parent is one the contract names, it lies inside its
    parent in time, carries a batch id, and each step's children come in
    order; every batch has its root, and the deferred retry runs."""
    spans = _traced(_engine(), monkeypatch, WJAV_DECODE_AHEAD=decode_ahead)
    names = {s.name for s in spans}
    assert names == set(PARENTS) - {"engine.align"}
    for s in spans:
        assert _name(s.parent) in PARENTS[s.name], (s.name, _name(s.parent))
        assert s.batch is not None and s.shard == 0
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns
            assert s.end_ns <= s.parent.end_ns
    roots = [s for s in spans if s.name == "engine.batch"]
    assert [s.batch for s in roots] == [0, 1, 2]
    assert [s.batch for s in spans if s.name == "engine.upload"] == [0, 1, 2]
    for step in (s for s in spans if s.name == "decode.step"):
        kids = [s for s in spans if s.parent is step]
        assert [s.name for s in kids] == STEP_CHILDREN
        assert kids[0].start_ns == step.start_ns
        assert all(a.end_ns == b.start_ns for a, b in zip(kids, kids[1:]))
    retry = [s for s in spans if s.name == "engine.retry"]
    assert len(retry) == 1 and retry[0].batch == "retry"
    rungs = {s.batch for s in spans if s.parent is retry[0]
             and s.name == "engine.decode"}
    assert rungs == {"retry:1"}


def test_steps_are_the_budget_with_eot_suppressed(monkeypatch):
    """With EOT suppressed the beam pool never fills: ``steps`` is the
    engine's budget min(max_new_tokens, bucket // 4 + 32), and as many
    ``decode.step`` spans ran; ``rows`` is B x beams; the batch's
    counters are its bucket, rows, rungs and drained tokens."""
    spans = _traced(_engine(max_new=150, temps=(0.0,)), monkeypatch,
                    wins=_windows((3.0, 2.0)))
    (loop,) = [s for s in spans if s.name == "decode.loop"]
    (root,) = [s for s in spans if s.name == "engine.batch"]
    budget = min(150, 448 // 4 + 32)
    assert loop.counters == {"steps": budget, "rows": 2 * 2,
                             "graph_steps": 0, "captures": 0}
    assert sum(s.parent is loop and s.name == "decode.step"
               for s in spans) == budget
    assert root.counters == {"bucket": 448, "rows": 2, "rungs": 1,
                             "tokens": 2 * budget}


@pytest.mark.parametrize("defer", ["1", "0"])
def test_greedy_rungs_and_the_retry_are_traced(monkeypatch, defer):
    """The sampled rungs decode greedily: their loops (``rows`` B, the
    budget's steps) lie under ``engine.retry`` with its ``retry_rows``
    and ``rungs``, or under the batch's ``engine.ladder`` inline."""
    engine = _engine()
    spans = _traced(engine, monkeypatch, WJAV_DEFER_RETRY=defer)
    under = "engine.retry" if defer == "1" else "engine.ladder"
    greedy = [s for s in spans if s.name == "decode.loop"
              and s.parent.parent.name == under]
    assert greedy and all(s.counters["rows"] == 2 for s in greedy)
    assert all(s.counters["steps"] == 12 for s in greedy)
    retry = [s for s in spans if s.name == "engine.retry"]
    if defer == "1":
        (retry,) = retry
        assert retry.counters == {"retry_rows": 5, "rungs": 2}
        assert engine.batch_trace[-1] == {
            "retry_rows": 5, "rungs": 2, "ladder_s": retry.seconds,
            "batch_s": retry.seconds}
    else:
        assert not retry
        assert all(r["rungs"] == 2 for r in engine.batch_trace)


def test_loops_count_graph_steps_and_captures(monkeypatch):
    """Every loop, beam and greedy alike, carries ``graph_steps`` and
    ``captures``: on the CPU each step's forward runs eagerly, so both
    read 0 beside the steps run."""
    spans = _traced(_engine(), monkeypatch)
    loops = [s for s in spans if s.name == "decode.loop"]
    assert {s.counters["rows"] for s in loops} == {2, 2 * 2}
    for loop in loops:
        assert set(loop.counters) == {"steps", "rows", "graph_steps",
                                      "captures"}
        assert loop.counters["steps"] > 0
        assert loop.counters["graph_steps"] == 0
        assert loop.counters["captures"] == 0


@pytest.mark.parametrize("decode_ahead", ["0", "1"])
def test_batch_trace_walls_are_span_lengths(monkeypatch, decode_ahead):
    """Each wall of a ``batch_trace`` row is the length of its spans:
    ``batch_s`` the root's, the phases its children's, ``upload_s`` the
    batch's own upload and ``ahead_s`` the next batch's encode."""
    engine = _engine()
    spans = _traced(engine, monkeypatch, WJAV_DECODE_AHEAD=decode_ahead)
    roots = [s for s in spans if s.name == "engine.batch"]
    assert len(engine.batch_trace) == len(roots) + 1
    for row, root in zip(engine.batch_trace, roots):
        def wall(name, batch=root.batch, parent=root):
            return sum(s.seconds for s in spans if s.name == name
                       and s.batch == batch
                       and (parent is None or s.parent is parent))
        assert row["batch_s"] == root.seconds
        assert row["upload_s"] == wall("engine.upload", parent=None) > 0
        assert row["encode_s"] == wall("engine.encode")
        assert row["ahead_s"] == wall("engine.encode", root.batch + 1)
        assert row["dispatch_s"] == wall("engine.decode") > 0
        assert row["drain_s"] == wall("engine.drain") > 0
        assert row["ladder_s"] == wall("engine.ladder") > 0
        assert row["extract_s"] == wall("engine.extract") > 0
    encoded_ahead = [r["ahead_s"] > 0 for r in engine.batch_trace[:3]]
    assert encoded_ahead == ([False] * 3 if decode_ahead == "1"
                             else [True, True, False])


class _Refuse:
    def __init__(self, *a, **kw):
        raise AssertionError("a span was opened with tracing off")


def test_untraced_loop_calls_no_recorder(monkeypatch):
    """With tracing off the engine holds no recorder and neither it nor
    the decode loops open a span, even where the loop runs under a
    context that holds none."""
    monkeypatch.setattr(tracer, "Span", _Refuse)
    monkeypatch.setattr(tracer, "SpanRecorder", _Refuse)
    engine = _engine()
    out = engine.transcribe_windows(_windows(), seed=3)
    assert len(out) == 5
    assert engine.recorder is None and engine.batch_trace == []
    assert tracer.current() is None


def test_mesh_shards_record_their_loops(monkeypatch):
    """Over two replicas each shard's loop opens in its own host thread
    under the caller's ``engine.decode``, marked with its shard."""
    spans = _traced(_engine(temps=(0.0,),
                            mesh=make_mesh(devices=["cpu", "cpu"])),
                    monkeypatch, wins=_windows((3.0, 2.0)))
    (decode,) = [s for s in spans if s.name == "engine.decode"]
    loops = [s for s in spans if s.name == "decode.loop"]
    assert sorted(s.shard for s in loops) == [0, 1]
    assert all(s.parent is decode and s.batch == 0 for s in loops)
    assert all(s.counters["rows"] == 2 for s in loops)


def test_self_seconds_put_each_instant_down_once():
    """Host seconds by span name from hand-set times: nested spans give
    their length less their children's, overlapping roots (decode-ahead's
    batches) are not counted twice."""
    rec = tracer.SpanRecorder()
    a = rec.child("engine.batch", 0)
    b = rec.child("engine.batch", 1)
    c = a.child("engine.drain")
    d = b.child("engine.decode")
    for span, (start, end) in zip((a, b, c, d), ((0, 100), (40, 160),
                                                 (60, 80), (50, 55))):
        span.start_ns, span.end_ns = start * 1000, end * 1000
    want = {"engine.batch": 135e-6, "engine.drain": 20e-6,
            "engine.decode": 5e-6}
    got = rec.self_seconds()
    assert set(got) == set(want)
    assert all(abs(got[k] - want[k]) < 1e-12 for k in want)


def test_lap_chains_children_from_the_last_end():
    rec = tracer.SpanRecorder()
    with tracer.span(rec, "engine.decode", 4) as outer:
        assert tracer.current() is outer
        loop = tracer.child(tracer.current(), "decode.loop")
        loop.lap("decode.prefill")
        step = loop.child("decode.step")
        step.close()
        loop.lap("decode.finalize")
        loop.close(steps=1, rows=2)
    assert tracer.current() is None
    prefill, fin = (s for s in rec.spans if s.name in
                    ("decode.prefill", "decode.finalize"))
    assert prefill.start_ns == loop.start_ns and fin.start_ns == step.end_ns
    assert {s.batch for s in rec.spans} == {4}
    assert tracer.span(None, "x").__enter__() is None
    assert tracer.child(None, "x") is None


def _inside(rec, span, event, slack_ns):
    start, end = event.start_ns(), event.start_ns() + event.duration_ns()
    return (rec.epoch_ns(span.start_ns) - slack_ns <= start
            and end <= rec.epoch_ns(span.end_ns) + slack_ns)


def test_profiled_op_lies_inside_its_mapped_span():
    """A CPU-activity profile: each ``aten::mm`` lies inside the span
    around it, mapped onto the profiler's clock by the recorder's
    anchor (50 us of slack at each end)."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(300, 300)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = tracer.SpanRecorder()
        for _ in range(4):
            with rec.span("mm"):
                x @ x
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(ops) == 4
    assert all(_inside(rec, s, e, 50_000) for s, e in zip(rec.spans, ops))


@pytest.mark.cuda
def test_kernel_lies_inside_its_mapped_span_on_the_card():
    """A CUDA-only profile: the kernels of a product between two
    synchronisations lie inside the span around them, mapped by the
    recorder's anchor (50 us of slack at each end): the profiler's device
    clock is the host's Unix-epoch clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the device trace's clock")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(4096, 4096, device="cuda")
    x @ x
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rec = tracer.SpanRecorder()
        for _ in range(5):
            time.sleep(0.002)
            with rec.span("mm"):
                x @ x
                torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    held = [[e for e in kernels if _inside(rec, s, e, 50_000)]
            for s in rec.spans]
    assert all(held) and sum(map(len, held)) == len(kernels)
