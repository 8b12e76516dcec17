"""Qwen3-ASR's driver through the harness on the CPU, at the port's test
widths (``data/qwen``: ``qwen3-asr-test``, two batches of two 1-6 s
scenes a file) with the cell's limits: sound runs are correct; a step
that writes its cache column one slot late is not, nor one that chooses
its token without the repetition penalty, nor the program's bf16 path
or a bf16 cache alone (their departures); the driver counts the model's
operations as ``roofline/qwen3_asr`` does. The configuration holds the
port's published sizes, and the cell's metrics read the device's busy
time inside the port's spans."""

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from h100bench import spec
from h100bench.harness import run_cell
from h100bench.spans import HostSpan
from h100bench.trace import Span, Stretch
from roofline import qwen3_asr as counts
from roofline.counts import HBM_BYTES_S

DATA = Path(__file__).resolve().parent / "data" / "qwen"
SEED = 2 ** 31 + 99
QWEN_METRICS = ("qwen.encode_ms_per_row", "qwen.prefill_ms_per_row",
                "qwen.decode_step_ms", "qwen.decode_hbm_pct")


def tiny_cell() -> dict:
    cell = dict(spec.workload("qwen3-asr-balanced"))
    cell.update(name="qwen-tiny",
                config=json.loads((DATA / "config.json").read_text()),
                traffic=json.loads((DATA / "traffic.json").read_text()))
    return cell


class _Keep:
    UNIT = ""
    stretch = None

    @classmethod
    def read(cls, stretch):
        cls.stretch = stretch


@pytest.fixture(scope="module")
def traced():
    out = run_cell(tiny_cell(), SEED, 0.0, True, device="cpu",
                   per_layer={**spec.metrics(), "_keep": _Keep})
    return out, _Keep.stretch


def test_sound_traced_run(traced):
    out, stretch = traced
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == 4 and out["failed"] == 0
    # the host-span and FLOP readers read the Qwen cell; the device's
    # and the qwen.* readers need a card
    assert {"decode.host_ms_per_step", "step_mfu"} <= set(out["metrics"])
    assert not set(QWEN_METRICS) & set(out["metrics"])
    m = tiny_cell()["config"]["model"]
    assert stretch.rows == 4 == sum(b["rows"] for b in stretch.batches)
    budget = 96               # 12 tokens a second of 8 s padded
    assert all(s == budget for b in stretch.batches for s in b["steps"])
    assert stretch.model_flops == pytest.approx(sum(
        counts.row_flops(m, samples, budget)
        for samples in _clip_samples(SEED, 1)))


def _clip_samples(seed, index):
    from h100bench.traffic import Pool
    pool = Pool(tiny_cell()["traffic"], seed)
    return [len(audio) for _, audio in pool.file(index)]


def test_sound_run_reads_below_the_controls():
    out = run_cell(tiny_cell(), SEED + 2, 0.0, False, device="cpu",
                   reference_control="bf16")
    assert out["correct"] is True, out["checks"]
    low = out["control"]
    assert low["correct"] is False
    for name in ("audio_err", "decoder_gap", "logprob_gap"):
        assert max(out["readings"][name]) * 10 < max(low["readings"][name])
    # at these widths the lower reference's choices are the same
    assert max(out["readings"]["select_lead"]) \
        <= max(low["readings"]["select_lead"])


def _late_column(monkeypatch):
    """Each decode step writes its new K/V column one slot late."""
    import whisperjav_tpu_torch.models.qwen.model as qm
    inner = qm.lm_step

    def step(model, x, pos, cache):
        logits, cache = inner(model, x, pos, cache)
        if x.shape[1] == 1 and pos + 1 < cache.k.shape[2]:
            for c in cache:
                c[:, :, pos + 1] = c[:, :, pos]
                c[:, :, pos] = 0.0
        return logits, cache
    monkeypatch.setattr(qm, "lm_step", step)


def _unpenalised_choice(monkeypatch):
    """Each step chooses the largest logit before the repetition penalty
    (the log-probability still taken after it): the port's own decode
    loop with that one line changed."""
    import inspect
    import whisperjav_tpu_torch.models.qwen.model as qm
    sound = "tok = torch.argmax(lg, dim=-1)"
    src = inspect.getsource(qm._decode)
    assert src.count(sound) == 1
    scope = dict(vars(qm))
    exec(src.replace(sound, "tok = torch.argmax(cur, dim=-1)"), scope)
    monkeypatch.setattr(qm, "_decode", scope["_decode"])


@pytest.mark.parametrize("fault,number", [
    (_late_column, "decoder_gap"), (_unpenalised_choice, "select_lead")],
    ids=["late_column", "unpenalised_choice"])
def test_fault_is_not_correct(monkeypatch, fault, number):
    fault(monkeypatch)
    out = run_cell(tiny_cell(), SEED, 0.0, False, device="cpu")
    assert out["correct"] is False
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]




@pytest.mark.cuda
@pytest.mark.parametrize("fault,number", [
    (_late_column, "decoder_gap"), (_unpenalised_choice, "select_lead")],
    ids=["late_column", "unpenalised_choice"])
def test_fault_is_not_correct_on_the_card(monkeypatch, fault, number):
    """The cell itself, at its published widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fault(monkeypatch)
    out = run_cell(spec.workload("qwen3-asr-balanced"), SEED, 0.0, False,
                   device="cuda")
    print(out["checks"])
    assert out["correct"] is False, out["checks"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_bf16_path_departs():
    out = run_cell(tiny_cell(), SEED, 0.0, False, device="cpu",
                   program_control="bf16_weights")
    assert out["correct"] is False
    assert out["readings"]["departures"] == [3.0]


def test_bf16_cache_alone_departs(monkeypatch):
    """The cache the generator makes is read, not inferred from the
    embedding's type."""
    import whisperjav_tpu_torch.models.qwen.model as qm
    inner = qm.LMCache.zeros

    def zeros(cfg, b, t_max, dtype, device):
        return inner(cfg, b, t_max, torch.bfloat16, device)
    monkeypatch.setattr(qm.LMCache, "zeros", staticmethod(zeros))
    out = run_cell(tiny_cell(), SEED, 0.0, False, device="cpu")
    assert out["correct"] is False
    assert out["readings"]["departures"] == [1.0]


def test_config_holds_the_ports_published_sizes():
    from whisperjav_tpu_torch.models.qwen.convert import config_from_hf
    from whisperjav_tpu_torch.models.qwen.model import QWEN_SIZES
    cfg = spec.config("qwen3-asr-1.7b")
    src = cfg["source_config"]
    hf = SimpleNamespace(
        name_or_path=cfg["model"]["name"],
        text_config=SimpleNamespace(**src["text_config"]),
        audio_config=SimpleNamespace(**src["audio_config"]))
    assert config_from_hf(hf) == QWEN_SIZES["qwen3-asr-1.7b"]
    assert cfg["model"] == dataclasses.asdict(QWEN_SIZES["qwen3-asr-1.7b"])
    assert cfg["reduced"] == []
    m = cfg["model"]
    # 48 s: 624 audio tokens and 576 decode steps
    assert counts.audio_tokens(m, 48 * 16000) == 624 \
        == QWEN_SIZES["qwen3-asr-1.7b"].audio_tokens_for(4800)
    assert counts.audio_tokens(m, 44 * 16000 + 1) == 624


def _span(name, start, end, **counters):
    return HostSpan(start, end, name, counters=counters)


MS = 1_000_000      # ns


def test_the_metrics_read_the_device_inside_the_spans():
    """Device busy [2, 8] ms in the mel and the tower, [12, 18] in the
    prefill, and 576 steps of 30 ms busy, 10 ms idle each in the loop;
    a kernel before the batch is read by none."""
    m = spec.config("qwen3-asr-1.7b")["model"]
    prefix, steps = [417, 625], [576, 576]
    loop0 = 20 * MS
    spans = [_span("qwen.batch", 0, 30_000 * MS, rows=2, audio_tokens=624,
                   budget=576),
             _span("qwen.mel", 0, 1 * MS),
             _span("qwen.encode", 1 * MS, 10 * MS),
             _span("qwen.prefill", 10 * MS, 20 * MS),
             _span("decode.loop", loop0, loop0 + 576 * 40 * MS, steps=576,
                   rows=32)]
    for s in spans:
        s.batch = 0
    device = [Span(-5 * MS, -1 * MS, "before", 7), Span(2 * MS, 8 * MS, "k", 7),
              Span(12 * MS, 18 * MS, "k", 7)]
    device += [Span(loop0 + (40 * t + 5) * MS, loop0 + (40 * t + 35) * MS,
                    "k", 7) for t in range(576)]
    stretch = Stretch(spans=device, wall_s=30.0, model=m,
                      decode={"kv_itemsize": 4},
                      batches=[{"rows": 2, "prefix": prefix,
                                "steps": steps}])
    stretch.program_spans = spans
    read = {name: spec.metric(name).read(stretch) for name in QWEN_METRICS}
    assert read["qwen.encode_ms_per_row"] == pytest.approx(3.0)
    assert read["qwen.prefill_ms_per_row"] == pytest.approx(3.0)
    assert read["qwen.decode_step_ms"] == pytest.approx(30.0)
    least = sum(counts.step_bytes(m, [p + t for p in prefix], 4)
                for t in range(576))
    assert read["qwen.decode_hbm_pct"] == pytest.approx(
        100 * least / HBM_BYTES_S / (576 * 0.030))
    assert 0 < read["qwen.decode_hbm_pct"] < 100
    # no device trace, or Whisper's loops (no qwen.batch): nothing
    stretch.spans = []
    assert all(spec.metric(n).read(stretch) is None for n in QWEN_METRICS)
    stretch.spans = device
    stretch.program_spans = [_span("decode.loop", 0, 10, steps=5, rows=4)]
    assert all(spec.metric(n).read(stretch) is None for n in QWEN_METRICS)


def test_least_bytes_and_flops():
    m = spec.config("qwen3-asr-1.7b")["model"]
    # the int8 LM (50.3 M codes a layer) and head, and f32 K/V of 28
    # layers x 1024
    assert counts.weight_bytes(m) == pytest.approx(1.72e9, rel=0.01)
    assert counts.kv_position_bytes(m, 4) == 2 * 28 * 1024 * 4
    # 48 s: the tower 1.01 TFLOP (convolutions 0.21, 32 layers over 624
    # tokens 0.79), the prefill 1.81 (625 positions at 2.82 GFLOP, the
    # head once), 576 steps 2.10 (with the head, 0.62 GFLOP each)
    assert counts.row_flops(m, 48 * 16000, 576) == pytest.approx(
        4.92e12, rel=0.005)
