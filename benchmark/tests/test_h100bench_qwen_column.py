"""The Qwen3 column attention's two metrics on a synthetic traced file at
Qwen3-ASR-1.7B's widths: ``qwen.column_kernel_pct`` from the loops'
``kernel_layers`` and ``steps``, ``qwen_column_attention_roofline`` from
the loops' ``rows``, ``start`` and ``steps`` over the kernel's device
seconds; nothing read where the spans, their counters or the kernel are
absent."""

import pytest

from h100bench import spec
from h100bench.spans import HostSpan
from h100bench.trace import Span, Stretch

MS = 1_000_000      # ns
KERNEL = ("void (anonymous namespace)::qwen_column_attention_kernel<float, "
          "128, 2>((anonymous namespace)::Args)")
NAMES = ("qwen.column_kernel_pct", "qwen_column_attention_roofline")


def _stretch(loops, kernel_ms, kv_itemsize=4):
    """A file of two batches whose loops carry ``loops`` (counters), and
    one kernel span a loop of ``kernel_ms`` each."""
    m = spec.config("qwen3-asr-1.7b")["model"]
    spans, device = [], [Span(-5 * MS, -1 * MS, "before", 7)]
    for i, counters in enumerate(loops):
        t0 = i * 100_000 * MS
        batch = HostSpan(t0, t0 + 90_000 * MS, "qwen.batch",
                         counters={"rows": counters.get("rows", 0)})
        loop = HostSpan(t0 + 10 * MS, t0 + 80_000 * MS, "decode.loop",
                        counters=dict(counters))
        for s in (batch, loop):
            s.batch = i
        spans += [batch, loop]
        device.append(Span(t0 + 20 * MS,
                           t0 + 20 * MS + round(kernel_ms * MS), KERNEL, 7))
    stretch = Stretch(spans=device, wall_s=200.0, model=m,
                      decode={"kv_itemsize": kv_itemsize})
    stretch.program_spans = spans
    return stretch


def _read(stretch):
    return {name: spec.metric(name).read(stretch) for name in NAMES}


def _least_s(rows, start, steps, itemsize):
    """The loop's bytes at 3.35 TB/s, written out at 1.7B's widths: 28
    layers, K/V rows of 8 x 128, 16 query heads of 128."""
    kvd, qd = 8 * 128, 16 * 128
    total = 0
    for t in range(steps):
        pos = start + t
        total += 28 * itemsize * rows * (2 * pos * kvd + 4 * kvd + 2 * qd)
    return total / 3.35e12


def test_every_layer_step_on_the_kernel():
    loops = [{"steps": 576, "rows": 32, "start": 625,
              "kernel_layers": 576 * 28},
             {"steps": 96, "rows": 7, "start": 105, "kernel_layers": 96 * 28}]
    least = _least_s(32, 625, 576, 4) + _least_s(7, 105, 96, 4)
    # the kernel at 80% of its bound in both loops, in two spans
    stretch = _stretch(loops, 1e3 * least / 0.8 / 2)
    read = _read(stretch)
    assert read["qwen.column_kernel_pct"] == pytest.approx(100.0)
    assert read["qwen_column_attention_roofline"] == pytest.approx(
        80.0, rel=1e-6)


def test_half_the_steps_on_the_kernel_and_bf16():
    loops = [{"steps": 100, "rows": 32, "start": 625,
              "kernel_layers": 50 * 28}]
    least = _least_s(32, 625, 100, 2)
    read = _read(_stretch(loops, 1e3 * least / 0.5, kv_itemsize=2))
    assert read["qwen.column_kernel_pct"] == pytest.approx(50.0)
    assert read["qwen_column_attention_roofline"] == pytest.approx(
        50.0, rel=1e-6)


def test_least_bytes_of_the_cell():
    """576 steps from position 625 at B=32, f32: 6.73 GB a step over the
    28 layers, 2.01 ms at 3.35 TB/s."""
    least = _least_s(32, 625, 576, 4)
    assert least * 3.35e12 / 576 == pytest.approx(6.727e9, rel=1e-3)
    assert least / 576 == pytest.approx(2.008e-3, rel=1e-3)
    mod = spec.metric("qwen_column_attention_roofline")
    m = spec.config("qwen3-asr-1.7b")["model"]
    flop, nbytes = mod.layer_step(m, 32, 913, 4)
    assert nbytes == 4 * 32 * (2 * 913 * 1024 + 4 * 1024 + 2 * 2048)
    assert flop == 4 * 32 * 2048 * 914


@pytest.mark.parametrize("what", ["no_kernel_layers", "no_start",
                                  "no_kernel", "no_qwen_batch", "no_spans"])
def test_nothing_to_read(what):
    counters = {"steps": 576, "rows": 32, "start": 625,
                "kernel_layers": 576 * 28}
    if what == "no_kernel_layers":    # the port before the kernel
        del counters["kernel_layers"], counters["start"]
    if what == "no_start":
        del counters["start"]
    stretch = _stretch([counters], 0.0 if what == "no_kernel" else 50.0)
    if what == "no_qwen_batch":       # Whisper's loops
        stretch.program_spans = [s for s in stretch.program_spans
                                 if s.name != "qwen.batch"]
    if what == "no_spans":
        stretch.program_spans = []
    read = _read(stretch)
    expect_pct = what in ("no_start", "no_kernel")
    assert (read["qwen.column_kernel_pct"] is not None) == expect_pct
    assert read["qwen_column_attention_roofline"] is None
