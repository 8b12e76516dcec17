"""The port's Qwen generator under ``WJAV_TRACE_BATCHES=1``: the spans and
counters ``generate_batch``, ``generate`` and the decode loop record
(``decode.loop``'s ``steps`` is the budget; the tower, the prefill and
the loop close their spans after the device's work), nothing without
the variable, and the same tokens, lengths and log-probabilities either
way with the same reads of the device. And the
generator's post-load step (``prepare_params``): a drawn or loaded tree
takes it, given ``params`` are used as given."""

from collections import Counter

import numpy as np
import pytest
import torch

from whisperjav_tpu_torch.models.qwen import model as qm
from whisperjav_tpu_torch.models.qwen.weights import init_params
from whisperjav_tpu_torch.models.layers import Int8Weight
from whisperjav_tpu_torch.modules.subtitle_pipeline import components as tc
from whisperjav_tpu_torch.utils import tracer

SR = 16000
BUDGET = 20
STEPS = ("decode.stop_check", "decode.select", "decode.forward")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return tc.prepare_params(init_params(
        qm.QWEN_SIZES["qwen3-asr-test"], torch.Generator().manual_seed(3)))


def _clips():
    rng = np.random.default_rng(4)
    return [(0.1 * rng.standard_normal(int(SR * s))).astype(np.float32)
            for s in (1.5, 3.0, 2.2)]


def _serve(params, monkeypatch, traced, ahead="1"):
    if traced:
        monkeypatch.setenv("WJAV_TRACE_BATCHES", "1")
    else:
        monkeypatch.delenv("WJAV_TRACE_BATCHES", raising=False)
    monkeypatch.setenv("WJAV_GENERATE_AHEAD", ahead)
    gen = tc.QwenGenerator("qwen3-asr-test", params=params, batch_size=2,
                           max_tokens=BUDGET, device="cpu")
    gen.load()
    return gen, gen.generate_batch(_clips(), SR)


@pytest.mark.parametrize("ahead", ["1", "0"])
def test_spans_and_counters(params, monkeypatch, ahead):
    gen, out = _serve(params, monkeypatch, True, ahead)
    rec = gen.recorder
    assert rec is tracer.latest() and len(out) == 3
    names = Counter(s.name for s in rec.spans)
    assert names["qwen.batch"] == 2
    for name in ("qwen.mel", "qwen.encode", "qwen.prefill", "decode.loop",
                 "qwen.drain"):
        assert names[name] == 2, name
    assert names["decode.step"] == names["decode.select"] \
        == names["decode.forward"] == 2 * BUDGET
    # a flag read every 8 steps: at steps 8 and 16 of 20
    assert names["decode.stop_check"] == 2 * 2
    roots = [s for s in rec.spans if s.name == "qwen.batch"]
    assert [r.counters for r in roots] == [
        {"rows": 2, "audio_tokens": 50, "budget": BUDGET},
        {"rows": 1, "audio_tokens": 50, "budget": BUDGET}]
    for s in rec.spans:
        assert s.end_ns is not None and s.end_ns >= s.start_ns, s.name
        if s.name in ("qwen.mel", "qwen.encode", "qwen.prefill",
                      "decode.loop", "qwen.drain"):
            assert s.parent in roots
        if s.name == "decode.loop":
            # the first generated token after 50 audio tokens and BOS;
            # no kernel and no CUDA graph on the CPU
            assert s.counters == {"steps": BUDGET, "rows": 2, "start": 51,
                                  "kernel_layers": 0, "graph_steps": 0,
                                  "captures": 0}
        if s.name in STEPS:
            assert s.parent.name == "decode.step"
        if s.name == "decode.step":
            assert s.parent.name == "decode.loop"
    loop = next(s for s in rec.spans if s.name == "decode.loop")
    prefill = next(s for s in rec.spans if s.name == "qwen.prefill")
    assert prefill.end_ns <= loop.start_ns     # the prefill stays outside


def test_untraced_records_nothing(params, monkeypatch):
    before = tracer.latest()
    gen, _ = _serve(params, monkeypatch, False)
    assert gen.recorder is None and tracer.latest() is before


def test_same_results_and_reads_traced_or_not(params, monkeypatch):
    """Tokens, lengths and ``avg_logprob`` equal, and ``_decode`` reads
    the device (``Tensor.__bool__``) as often, traced or not."""
    reads = []
    inner = torch.Tensor.__bool__

    def counted(t):
        reads.append(1)
        return inner(t)
    mel = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 128, 400)).astype(np.float32))
    monkeypatch.setattr(torch.Tensor, "__bool__", counted)
    plain = qm.generate(params, mel, max_new=BUDGET, audio_len=50)
    n_plain = len(reads)
    rec = tracer.SpanRecorder()
    with tracer.within(rec.child("qwen.batch")):
        traced = qm.generate(params, mel, max_new=BUDGET, audio_len=50)
    monkeypatch.setattr(torch.Tensor, "__bool__", inner)
    assert n_plain == len(reads) - n_plain == (BUDGET - 1) // 8
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    assert {s.name for s in rec.spans} >= {"qwen.encode", "qwen.prefill",
                                           "decode.loop"}
    _, off = _serve(params, monkeypatch, False)
    _, on = _serve(params, monkeypatch, True)
    assert [(r.frame_index, r.text, r.avg_logprob) for r in off] \
        == [(r.frame_index, r.text, r.avg_logprob) for r in on]


def test_stages_close_after_the_device(params, monkeypatch):
    """The tower, the prefill and the decode loop wait for the device
    before they close, so the device trace puts their work inside their
    spans; nothing else waits."""
    synced = []
    inner = tracer.Span.close_synced

    def close_synced(span, device, **counters):
        synced.append(span.name)
        inner(span, device, **counters)
    monkeypatch.setattr(tracer.Span, "close_synced", close_synced)
    gen, _ = _serve(params, monkeypatch, True)
    assert Counter(synced) == {"qwen.encode": 2, "qwen.prefill": 2,
                               "decode.loop": 2}


def _raw():
    return init_params(qm.QWEN_SIZES["qwen3-asr-test"],
                       torch.Generator().manual_seed(5))


def test_prepare_params_fuses_and_quantises_once():
    p = tc.prepare_params(_raw())
    blocks = p.blocks
    assert "wqkv" in blocks and "wq" not in blocks
    assert all(isinstance(blocks[n], Int8Weight)
               for n in ("wqkv", "wo", "w_gate", "w_up", "w_down"))
    assert "lm_head_q" in p and "lm_head" not in p
    codes = blocks["wqkv"].q.clone()
    assert tc.prepare_params(p) is p
    assert torch.equal(p.blocks["wqkv"].q, codes)


@pytest.mark.parametrize("fuse,int8", [("0", "1"), ("1", "0"), ("0", "0")])
def test_prepare_params_switches(monkeypatch, fuse, int8):
    monkeypatch.setenv("WJAV_FUSE_QKV", fuse)
    monkeypatch.setenv("WJAV_QWEN_INT8", int8)
    p = tc.prepare_params(_raw())
    assert ("wqkv" in p.blocks) == (fuse != "0")
    assert ("lm_head_q" in p) == (int8 != "0")
    assert isinstance(p.blocks["wo"], Int8Weight) == (int8 != "0")


def test_given_params_are_used_as_given():
    """As the JAX generator's ``load``: a tree handed in is not fused or
    quantised (callers pass prepared trees, or the driver runs
    ``prepare_params`` itself); a drawn one is."""
    raw = _raw()
    gen = tc.QwenGenerator("qwen3-asr-test", params=raw, device="cpu")
    gen.load()
    assert "wq" in gen._params.blocks and "lm_head" in gen._params
    drawn = tc.QwenGenerator("qwen3-asr-test", device="cpu")
    drawn.load()
    assert "wqkv" in drawn._params.blocks and "lm_head_q" in drawn._params
