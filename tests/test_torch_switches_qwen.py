"""The Qwen stack's environment switches in the port, against the JAX
package on the CPU (``qwen3-asr-test`` widths and the default aligner,
from the JAX inits carried across with ``params_from_jax``):

- ``WJAV_FUSE_QKV`` and ``WJAV_QWEN_INT8`` in the Qwen generator's
  ``load``: the same texts as the JAX generator's from the same random
  init, q/k/v fused and apart, the LM int8 and bf16 (f32 here);
- ``WJAV_FUSE_QKV`` in the on-device translator: the same answer fused
  and apart;
- ``WJAV_ALIGN_DEVICE``: the aligner adapter's device path and its host
  path (log-mel drained to the host, then ``align_batch``) give the JAX
  adapter's spans, and the same spans as each other.

Texts and spans exactly; log-probabilities within 1e-4 (sums in other
orders). Each switch is off only for "0"."""

import numpy as np
import pytest
import torch

import jax

from whisperjav_tpu.models.qwen import model as jqm
from whisperjav_tpu.models.qwen.aligner import ForcedAligner as JaxAligner
from whisperjav_tpu.modules.subtitle_pipeline import components as jc
from whisperjav_tpu_torch.models.qwen import aligner as ta
from whisperjav_tpu_torch.models.qwen import weights as tw
from whisperjav_tpu_torch.models.layers import Int8Weight
from whisperjav_tpu_torch.models.qwen.model import QWEN_SIZES
from whisperjav_tpu_torch.modules.subtitle_pipeline import components as tc

SR = 16000
SIZE = "qwen3-asr-test"
OFF_ON = [None, "0"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _set(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


def speech_like(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = 0.3 * np.sin(2 * np.pi * (160 + 15 * seed) * t) \
        * (1 + 0.5 * np.sin(2 * np.pi * 4 * t))
    return (x + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def raw_tree():
    """The JAX generator's random init (``PRNGKey(0)``, what its ``load``
    draws with no checkpoint), as numpy arrays."""
    return jax.tree.map(np.asarray, jqm.init_params(
        jqm.QWEN_SIZES[SIZE], jax.random.PRNGKey(0)))


@pytest.mark.parametrize("int8", OFF_ON, ids=["int8", "qwen-int8-0"])
@pytest.mark.parametrize("fuse", OFF_ON, ids=["fused", "fuse-qkv-0"])
def test_generator_load_switches(raw_tree, monkeypatch, fuse, int8):
    """Both generators draw their random init in ``load`` and prepare it
    under the switches; the port's init is the JAX one's (patched in)."""
    _set(monkeypatch, "WJAV_FUSE_QKV", fuse)
    _set(monkeypatch, "WJAV_QWEN_INT8", int8)
    monkeypatch.setattr(
        tw, "init_params",
        lambda cfg, gen, device="cpu": tw.params_from_jax(raw_tree, cfg,
                                                          device=device))
    kw = dict(model_size=SIZE, batch_size=4, max_tokens=12)
    jgen = jc.QwenGenerator(**kw)
    tgen = tc.QwenGenerator(device="cpu", **kw)
    jgen.load()
    tgen.load()
    blocks = tgen._params.blocks
    assert ("wqkv" in blocks) == (fuse is None) \
        == ("wqkv" in jgen._params["blocks"])
    head_q = "lm_head_q" in tgen._params
    assert head_q == (int8 is None) == ("lm_head_q" in jgen._params)
    assert isinstance(blocks["wo"], Int8Weight) == (int8 is None)
    clips = [speech_like(5.0, 1), speech_like(2.5, 2), speech_like(3.5, 3),
             speech_like(4.0, 4), speech_like(1.5, 5)]
    got, want = tgen.generate_batch(clips, SR), jgen.generate_batch(clips, SR)
    assert [(r.frame_index, r.text) for r in got] \
        == [(r.frame_index, r.text) for r in want]
    assert all(r.text for r in got)
    np.testing.assert_allclose([r.avg_logprob for r in got],
                               [r.avg_logprob for r in want], atol=1e-4)


def test_generator_int8_switch_changes_the_weights_read(raw_tree,
                                                         monkeypatch):
    """``WJAV_QWEN_INT8=0`` keeps every LM matmul and the head in floating
    point; the default halves them to int8 codes."""
    monkeypatch.setattr(
        tw, "init_params",
        lambda cfg, gen, device="cpu": tw.params_from_jax(raw_tree, cfg,
                                                          device=device))

    def lm_bytes():
        gen = tc.QwenGenerator(model_size=SIZE, device="cpu")
        gen.load()
        p = gen._params
        return sum(t.numel() * t.element_size()
                   for n, t in p.named_parameters()
                   if n.startswith("blocks.w") or n.startswith("lm_head")) \
            + sum(t.numel() * t.element_size()
                  for n, t in p.named_buffers()
                  if n.startswith("blocks.w") or n.startswith("lm_head"))

    monkeypatch.delenv("WJAV_QWEN_INT8", raising=False)
    int8 = lm_bytes()
    monkeypatch.setenv("WJAV_QWEN_INT8", "0")
    full = lm_bytes()
    assert 0 < int8 < full


def test_translator_fuse_qkv(raw_tree, monkeypatch):
    """The tpu-local backends on the unfused LM tree: the same answer with
    q/k/v fused (the default) and apart, in both packages."""
    from whisperjav_tpu.models.qwen.tokenizer import QwenTokenizer as JTok
    from whisperjav_tpu.translate.local_backend import TpuLocalBackend
    from whisperjav_tpu_torch.models.qwen.tokenizer import (
        QwenTokenizer as TTok,
    )
    from whisperjav_tpu_torch.translate.local_backend import LocalLMBackend
    lm = {k: v for k, v in raw_tree.items() if k != "audio"}
    prompt = "Translate:\n---\n1: こんにちは\n2: ありがとう"
    answers = []
    for value in OFF_ON:
        _set(monkeypatch, "WJAV_FUSE_QKV", value)
        ref = TpuLocalBackend(params=lm, cfg=jqm.QWEN_SIZES[SIZE],
                              tokenizer=JTok(), max_new_tokens=8)
        out = LocalLMBackend(params=lm, cfg=QWEN_SIZES[SIZE],
                             tokenizer=TTok(), max_new_tokens=8,
                             device="cpu")
        assert ("wqkv" in out.model.blocks) == (value is None) \
            == ("wqkv" in ref.params["blocks"])
        answers += [ref(prompt), out(prompt)]
    assert answers[0] and len(set(answers)) == 1


# ---------------------------------------------------------------------------
# WJAV_ALIGN_DEVICE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def aligners():
    jal = JaxAligner()
    params = ta.params_from_jax(jax.tree.map(np.asarray, jal.params),
                                ta.AlignerConfig())
    return jal, ta.ForcedAligner(params=params, device="cpu")


def _spans(results):
    return [[(w.word, w.start, w.end) for w in r.words] for r in results]


def test_align_device_switch(aligners, monkeypatch):
    """Clips in two audio buckets (one of them with a row of no text):
    the port's adapter gives the JAX adapter's spans on its device path
    and on its host path, and the two paths agree on each package."""
    jal, tal = aligners
    clips = [speech_like(3.2, 1), speech_like(1.4, 2), speech_like(5.5, 3),
             speech_like(2.2, 4)]
    texts = ["あいうえおかき", "こんにちは", "", "ありがとうございます"]
    spans = {}
    for value in OFF_ON:
        _set(monkeypatch, "WJAV_ALIGN_DEVICE", value)
        jad = jc.QwenAlignerAdapter(aligner=jal)
        tad = tc.QwenAlignerAdapter(aligner=tal, device="cpu")
        want = _spans(jad.align_batch(clips, SR, texts))
        got = _spans(tad.align_batch(clips, SR, texts))
        assert got == want
        spans[value] = got
    assert spans[None] == spans["0"]
    assert sum(len(r) for r in spans[None]) == 7 + 5 + 10
    assert spans[None][2] == []
