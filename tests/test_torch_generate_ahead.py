"""Generate-ahead in the port's Qwen generator (counterparts of
``tests/test_generate_ahead.py``): ``QwenGenerator.generate_batch`` runs
batch i+1's ``generate`` before draining batch i, which changes the
order of work only: the results, and their order, are the serial path's
and the JAX generator's on the same weights. The guard: two batches' LM
caches above ``WJAV_GENERATE_AHEAD_GB`` turn it off with the JAX
package's warning and numbers (test widths, int8 LM, f32 on the CPU)."""

import logging

import numpy as np
import pytest
import torch

import jax

from whisperjav_tpu.modules.subtitle_pipeline import components as jc
from whisperjav_tpu_torch.models.qwen import model as tqm
from whisperjav_tpu_torch.models.qwen.model import QWEN_SIZES
from whisperjav_tpu_torch.models.qwen.weights import params_from_jax
from whisperjav_tpu_torch.modules.subtitle_pipeline import components as tc

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """The JAX generator's loaded weights (random init, fused, int8) and
    the port's copy."""
    jgen = jc.QwenGenerator(model_size="qwen3-asr-test", batch_size=2)
    jgen.load()
    return jgen._params, params_from_jax(
        jax.tree.map(np.asarray, jgen._params), QWEN_SIZES["qwen3-asr-test"])


def _clips(n):
    rng = np.random.default_rng(3)
    return [
        (0.2 * np.sin(2 * np.pi * (150 + 40 * i)
                      * np.arange(int((0.8 + 0.3 * i) * SR)) / SR)
         + 0.02 * rng.standard_normal(int((0.8 + 0.3 * i) * SR))
         ).astype(np.float32)
        for i in range(n)
    ]


def _run(monkeypatch, weights, ahead: str, clips, **env):
    monkeypatch.setenv("WJAV_GENERATE_AHEAD", ahead)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    gen = tc.QwenGenerator(model_size="qwen3-asr-test", batch_size=2,
                           params=weights[1], device="cpu")
    gen.load()
    return gen.generate_batch(clips, SR)


def _same(a, b, atol=1e-6):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.frame_index == y.frame_index
        assert x.text == y.text
        np.testing.assert_allclose(x.avg_logprob, y.avg_logprob, rtol=atol,
                                   atol=atol)


def test_generate_ahead_identical_results(monkeypatch, weights):
    """An odd clip count (a padded last batch) over three batches: the
    same frames, texts and logprobs in the same order as the serial
    path, and as the JAX generator's (logprobs within 1e-4: f32 sums in
    other orders)."""
    clips = _clips(5)
    ahead = _run(monkeypatch, weights, "1", clips)
    serial = _run(monkeypatch, weights, "0", clips)
    _same(ahead, serial)
    assert [r.frame_index for r in ahead] == list(range(5))
    monkeypatch.setenv("WJAV_GENERATE_AHEAD", "1")
    jgen = jc.QwenGenerator(model_size="qwen3-asr-test", batch_size=2,
                            params=weights[0])
    _same(ahead, jgen.generate_batch(clips, SR), atol=1e-4)


def test_generate_ahead_single_batch(monkeypatch, weights):
    """One batch: the pending slot drains after the loop."""
    clips = _clips(2)
    ahead = _run(monkeypatch, weights, "1", clips)
    serial = _run(monkeypatch, weights, "0", clips)
    assert [r.text for r in ahead] == [r.text for r in serial]
    assert [r.frame_index for r in ahead] == [0, 1]


def _order(monkeypatch, weights, ahead: str, **env):
    """The sequence of generates and drains (one ``_decode_text`` a row)
    over five clips in batches of two."""
    events = []
    orig_gen = tqm.generate
    orig_text = tc.QwenGenerator._decode_text

    def gen(*a, **k):
        events.append("generate")
        return orig_gen(*a, **k)

    def text(self, ids, length):
        events.append("drain")
        return orig_text(self, ids, length)
    monkeypatch.setattr(tqm, "generate", gen)
    monkeypatch.setattr(tc.QwenGenerator, "_decode_text", text)
    _run(monkeypatch, weights, ahead, _clips(5), **env)
    return events


def test_generate_ahead_order(monkeypatch, weights):
    """Batch i+1's generate comes before batch i's drain with ahead on;
    each batch drains before the next generate with it off."""
    g, d = "generate", "drain"
    assert _order(monkeypatch, weights, "1") == [g, g, d, d, g, d, d, d]
    assert _order(monkeypatch, weights, "0") == [g, d, d, g, d, d, g, d]


class _Warnings(logging.Handler):
    """The guard's warnings on a package's logger."""

    def __init__(self, logger):
        super().__init__(logging.WARNING)
        self.logger, self.messages = logger, []

    def emit(self, record):
        if "generate-ahead disabled" in record.getMessage():
            self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self.messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def test_generate_ahead_guard(monkeypatch, weights):
    """Two LM caches above ``WJAV_GENERATE_AHEAD_GB``: the JAX package's
    warning, with its numbers, and serial drains."""
    g, d = "generate", "drain"
    tiny = {"WJAV_GENERATE_AHEAD_GB": "0.0000001"}
    with _Warnings(tc.logger) as port:
        events = _order(monkeypatch, weights, "1", **tiny)
    with _Warnings(jc.logger) as want:
        jc.QwenGenerator(model_size="qwen3-asr-test", batch_size=2,
                         params=weights[0]).generate_batch(_clips(5), SR)
    assert events == [g, d, d, g, d, d, g, d]
    assert len(port) == 1 and port == want
    # the default budget (6 GB, the JAX package's) leaves it on here
    monkeypatch.delenv("WJAV_GENERATE_AHEAD_GB")
    with _Warnings(tc.logger) as port:
        assert _order(monkeypatch, weights, "1")[:3] == [g, g, d]
    assert port == []
