"""The engine's batch pipelining in the port against the JAX engine's
(counterparts of ``tests/test_encode_ahead.py``; the JAX file's
``test_gate_fail_injection`` has none: the port does not read
``WJAV_GATE_FAIL_PCT``).

Encode-ahead (``WJAV_ENCODE_AHEAD``) enqueues batch i+1's encode right
after batch i's first-rung decode; decode-ahead (``WJAV_DECODE_AHEAD``)
orders encode and decode i, upload i+1, finish i-1. Both reorder work
only: the outputs are the same with every combination of the two and of
``WJAV_DEFER_RETRY``, and each equals the JAX engine's on the same
windows (tiny model, real vocabulary, f32 on the CPU; the sampled rungs
fed the JAX noise through ``engine.gumbel_source``; the cross-K/V in the
compute dtype, both engines' default)."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.whisper import decode as jd
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.models.whisper.model import init_params
from whisperjav_tpu.parallel.batching import Window as JWindow
from whisperjav_tpu.pipelines import engine as je
from whisperjav_tpu_torch.models.whisper import decode as td
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax
from whisperjav_tpu_torch.parallel.batching import Window
from whisperjav_tpu_torch.parallel.mesh import make_mesh
from whisperjav_tpu_torch.pipelines import engine as te
from whisperjav_tpu_torch.pipelines.engine import (
    CROSS_KV_BUCKETS, QualityThresholds, TranscriptionEngine,
)
from test_torch_mesh import _jax_gumbel_source

_DIMS = dict(name="ea-tiny", n_audio_state=64, n_audio_head=4,
             n_audio_layer=2, n_text_state=64, n_text_head=4,
             n_text_layer=2)
CFG = WhisperConfig(**_DIMS)          # the JAX package's
TCFG = TorchWhisperConfig(**_DIMS)    # the port's
KNOBS = ("WJAV_ENCODE_AHEAD", "WJAV_DECODE_AHEAD", "WJAV_DEFER_RETRY")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors, many ops: one intra-op thread avoids oversubscribing
    the CPU when the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_knobs(monkeypatch):
    for knob in KNOBS + ("WJAV_TRACE_BATCHES",):
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, jax.random.PRNGKey(0))


def _engine(params, mesh=None, batch_size=2, **kw):
    return TranscriptionEngine(
        TCFG, params_from_jax(jax.tree.map(np.asarray, params), TCFG),
        options=td.DecodeOptions(max_new_tokens=12),
        thresholds=QualityThresholds(temperatures=(0.0, 0.4)),
        batch_size=batch_size, device="cpu", compute_dtype=torch.float32,
        mesh=mesh, **kw)


def _jax_engine(params):
    return je.TranscriptionEngine(
        CFG, params, options=jd.DecodeOptions(max_new_tokens=12),
        thresholds=je.QualityThresholds(temperatures=(0.0, 0.4)),
        batch_size=2, mesh=None, compute_dtype=jnp.float32)


def _windows(n=5, cls=Window):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        dur = [3.0, 8.0, 12.0, 3.0, 25.0][i % 5]
        x = (0.2 * rng.standard_normal(int(16000 * dur))).astype(np.float32)
        out.append(cls(x, 0.0, dur, 0, i))
    return out


def _flatten(results):
    return [(w.group_idx,
             [(tuple(s.tokens), round(s.start, 4), round(s.end, 4), s.text)
              for s in segs])
            for w, segs in results]


@pytest.fixture(scope="module")
def jax_results(params):
    """The JAX engine's results with its defaults, and with
    ``WJAV_DEFER_RETRY=0``."""
    engine, wins = _jax_engine(params), _windows(cls=JWindow)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for defer in ("1", "0"):
            mp.setenv("WJAV_DEFER_RETRY", defer)
            out[defer] = _flatten(engine.transcribe_windows(wins, seed=3))
    return out


@pytest.mark.parametrize("encode_ahead,decode_ahead,defer", list(
    itertools.product("01", "01", "01")))
def test_every_knob_combination_is_the_jax_engines(
        params, jax_results, monkeypatch, encode_ahead, decode_ahead,
        defer):
    """Each combination of the three knobs: the JAX engine's tokens,
    bounds and text (its own pipelining on, its ladder as the knob
    says)."""
    monkeypatch.setattr(te, "gumbel_source", _jax_gumbel_source)
    for knob, value in zip(KNOBS, (encode_ahead, decode_ahead, defer)):
        monkeypatch.setenv(knob, value)
    got = _flatten(_engine(params).transcribe_windows(_windows(), seed=3))
    assert got == jax_results[defer]
    assert any(segs for _, segs in got)     # a non-degenerate comparison


def test_encode_ahead_outputs_identical(params, monkeypatch):
    eng = _engine(params)
    wins = _windows()
    monkeypatch.setenv("WJAV_ENCODE_AHEAD", "0")
    base = _flatten(eng.transcribe_windows(wins, seed=3))
    monkeypatch.setenv("WJAV_ENCODE_AHEAD", "1")
    ahead = _flatten(eng.transcribe_windows(wins, seed=3))
    assert ahead == base
    assert any(segs for _, segs in base)


def test_encode_ahead_passes_pre_encoded_batches(params, monkeypatch):
    """Every batch after the first reaches ``transcribe_batch`` encoded,
    and each ahead encode comes after the current batch's decode."""
    eng = _engine(params)
    monkeypatch.setenv("WJAV_ENCODE_AHEAD", "1")
    monkeypatch.setenv("WJAV_DECODE_AHEAD", "0")
    events = []
    orig_tb = TranscriptionEngine.transcribe_batch
    orig_de = TranscriptionEngine.decode_encoded
    orig_eb = TranscriptionEngine.encode_batch

    def spy_tb(self, batch, seed=0, device_audio=None, device_xa=None,
               on_decode_dispatched=None, trace=None, **kw):
        events.append(("batch", device_xa is not None))
        return orig_tb(self, batch, seed=seed, device_audio=device_audio,
                       device_xa=device_xa,
                       on_decode_dispatched=on_decode_dispatched,
                       trace=trace, **kw)

    def spy_de(self, xa, temperature=0.0, seed=0):
        events.append(("decode",))
        return orig_de(self, xa, temperature, seed)

    def spy_eb(self, audio=None, device_audio=None, max_duration=None):
        events.append(("encode", max_duration))
        return orig_eb(self, audio=audio, device_audio=device_audio,
                       max_duration=max_duration)

    monkeypatch.setattr(TranscriptionEngine, "transcribe_batch", spy_tb)
    monkeypatch.setattr(TranscriptionEngine, "decode_encoded", spy_de)
    monkeypatch.setattr(TranscriptionEngine, "encode_batch", spy_eb)
    eng.transcribe_windows(_windows(), seed=3)

    pre_encoded = [ok for kind, *rest in events if kind == "batch"
                   for ok in rest]
    assert pre_encoded == [False, True, True]
    first_decode = next(i for i, e in enumerate(events) if e[0] == "decode")
    # batches sort by duration: (3, 3), (8, 12), (25,); batch 0 encodes
    # inline, the others ahead, each for its own longest window
    encodes = [(i, e[1]) for i, e in enumerate(events) if e[0] == "encode"]
    assert [d for _, d in encodes[:3]] == [3.0, 12.0, 25.0]
    assert all(i > first_decode for i, _ in encodes[1:3])


def test_decode_ahead_outputs_identical(params, monkeypatch):
    eng = _engine(params)
    wins = _windows()
    monkeypatch.setenv("WJAV_ENCODE_AHEAD", "0")
    monkeypatch.setenv("WJAV_DECODE_AHEAD", "0")
    base = _flatten(eng.transcribe_windows(wins, seed=3))
    monkeypatch.setenv("WJAV_ENCODE_AHEAD", "1")
    monkeypatch.setenv("WJAV_DECODE_AHEAD", "1")
    ahead = _flatten(eng.transcribe_windows(wins, seed=3))
    assert ahead == base
    assert any(segs for _, segs in base)


def _dispatch_order(engine_cls, engine, wins, monkeypatch):
    """The sequence of first-rung and ladder decodes and finishes."""
    events = []
    orig_fb = engine_cls.finish_batch
    orig_de = engine_cls.decode_encoded

    def spy_fb(self, batch, xa, result, seed=0, trace=None, **kw):
        events.append("finish")
        return orig_fb(self, batch, xa, result, seed=seed, trace=trace,
                       **kw)

    def spy_de(self, xa, temperature=0.0, seed=0):
        events.append("decode")
        return orig_de(self, xa, temperature, seed)

    monkeypatch.setattr(engine_cls, "finish_batch", spy_fb)
    monkeypatch.setattr(engine_cls, "decode_encoded", spy_de)
    assert len(engine.transcribe_windows(wins, seed=3)) == len(wins)
    return events


@pytest.mark.parametrize("defer", ["1", "0"])
def test_decode_ahead_dispatch_order(params, monkeypatch, defer):
    """Batch i+1's first-rung decode comes before batch i's finish: the
    order the JAX test pins (decode, decode, finish first), and the JAX
    engine's whole sequence, ladder rungs included."""
    monkeypatch.setenv("WJAV_ENCODE_AHEAD", "1")
    monkeypatch.setenv("WJAV_DECODE_AHEAD", "1")
    monkeypatch.setenv("WJAV_DEFER_RETRY", defer)
    got = _dispatch_order(TranscriptionEngine, _engine(params), _windows(),
                          monkeypatch)
    want = _dispatch_order(je.TranscriptionEngine, _jax_engine(params),
                           _windows(cls=JWindow), monkeypatch)
    assert got[:2] == ["decode", "decode"]
    assert got.count("finish") == 3 and got.index("finish") == 2
    assert got == want


@pytest.mark.parametrize("int8", [False, True])
def test_decode_ahead_memory_gate(params, monkeypatch, int8):
    """The gate's bytes are the JAX engine's (cross-K/V at 1 byte for
    int8, 2 otherwise); auto turns decode-ahead off without headroom and
    ``1`` overrides."""
    eng = TranscriptionEngine(
        TCFG, params_from_jax(jax.tree.map(np.asarray, params), TCFG),
        options=td.DecodeOptions(max_new_tokens=12, cross_kv_int8=int8,
                                 beam_size=2),
        batch_size=4, device="cpu", compute_dtype=torch.float32)
    jeng = je.TranscriptionEngine(
        CFG, params, options=jd.DecodeOptions(max_new_tokens=12,
                                              cross_kv_int8=int8,
                                              beam_size=2),
        batch_size=4, mesh=None, compute_dtype=jnp.float32)
    assert eng._decode_ahead_bytes() == jeng._decode_ahead_bytes()
    assert (TranscriptionEngine.DECODE_AHEAD_BUDGET_BYTES
            == je.TranscriptionEngine.DECODE_AHEAD_BUDGET_BYTES)
    monkeypatch.setenv("WJAV_DECODE_AHEAD", "auto")
    assert eng._decode_ahead_enabled()          # tiny config: fits
    monkeypatch.setattr(TranscriptionEngine, "DECODE_AHEAD_BUDGET_BYTES", 1)
    assert not eng._decode_ahead_enabled()      # no headroom: sequential
    monkeypatch.setenv("WJAV_DECODE_AHEAD", "1")
    assert eng._decode_ahead_enabled()          # explicit override wins
    monkeypatch.setenv("WJAV_DECODE_AHEAD", "0")
    monkeypatch.setattr(TranscriptionEngine, "DECODE_AHEAD_BUDGET_BYTES",
                        1 << 60)
    assert not eng._decode_ahead_enabled()


def test_encode_batch_bucket_slice(params):
    eng = _engine(params)
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.standard_normal((2, 16000 * 30))).astype(np.float32)
    xa = eng.encode_batch(audio, max_duration=6.0)
    assert xa.shape[1] == CROSS_KV_BUCKETS[0]          # 448 bucket
    xa = eng.encode_batch(audio, max_duration=29.0)
    assert xa.shape[1] == min(CROSS_KV_BUCKETS[-1], CFG.n_audio_ctx)
    # no max_duration: untouched full context
    xa = eng.encode_batch(audio)
    assert xa.shape[1] == CFG.n_audio_ctx
    # from an upload, the same states
    up = eng.upload_audio(audio)
    np.testing.assert_array_equal(
        eng.encode_batch(device_audio=up)[0].numpy(), xa[0].numpy())


def test_upload_is_the_jax_int16(params):
    """The upload's int16 samples are the JAX engine's, and an upload
    passes through as it is."""
    eng = _engine(params)
    rng = np.random.default_rng(1)
    audio = (0.7 * rng.standard_normal((2, 16000 * 30))).astype(np.float32)
    up = eng.upload_audio(audio)
    assert isinstance(up, te.ShardedStates) and up[0].dtype == torch.int16
    want = np.asarray(je.TranscriptionEngine.upload_audio(_UploadOnly(),
                                                          audio))
    np.testing.assert_array_equal(up[0].numpy(), want)
    assert eng.upload_audio(up) is up


class _UploadOnly:
    """What the JAX ``upload_audio`` reads of its engine: no mesh."""
    mesh = None


@pytest.mark.parametrize("decode_ahead", ["0", "1"])
def test_trace_fields_are_the_jax_engines(params, monkeypatch,
                                          decode_ahead):
    """``WJAV_TRACE_BATCHES=1``: one row a batch with the JAX engine's
    keys on either pipelined path, the rungs and rows of the JAX rows,
    and the deferred-retry row."""
    monkeypatch.setenv("WJAV_TRACE_BATCHES", "1")
    monkeypatch.setenv("WJAV_DECODE_AHEAD", decode_ahead)
    eng, jeng = _engine(params), _jax_engine(params)
    eng.transcribe_windows(_windows(), seed=3)
    jeng.transcribe_windows(_windows(cls=JWindow), seed=3)
    got, want = eng.batch_trace, jeng.batch_trace
    assert len(got) == len(want) == 4
    for row, ref in zip(got, want):
        assert set(row) == set(ref)
        for key in ("rungs", "bucket", "rows", "audio_s", "retry_rows"):
            assert row.get(key) == ref.get(key), key
    keys = {"upload_s", "encode_s", "dispatch_s", "ahead_s", "drain_s",
            "ladder_s", "extract_s", "batch_s", "audio_s", "rungs",
            "bucket", "rows"}
    assert all(set(row) == keys for row in got[:3])
    assert all(row[k] >= 0.0 for row in got[:3] for k in keys
               if k.endswith("_s"))


@pytest.mark.parametrize("ahead", ["0", "1"])
def test_two_shard_mesh_pipelined(params, monkeypatch, ahead):
    """Two CPU replicas at batch 4, each shard encoding ahead on its own:
    one replica's results, and the JAX engine's at batch 4."""
    monkeypatch.setattr(te, "gumbel_source", _jax_gumbel_source)
    monkeypatch.setenv("WJAV_ENCODE_AHEAD", ahead)
    monkeypatch.setenv("WJAV_DECODE_AHEAD", ahead)
    wins = _windows(7)
    two = _flatten(_engine(params, mesh=make_mesh(devices=["cpu", "cpu"]),
                           batch_size=4).transcribe_windows(wins, seed=3))
    one = _flatten(_engine(params, batch_size=4).transcribe_windows(
        wins, seed=3))
    jeng = _jax_engine(params)
    jeng.batch_size = 4
    ref = _flatten(jeng.transcribe_windows(_windows(7, cls=JWindow),
                                           seed=3))
    assert two == one == ref
    assert any(segs for _, segs in two)
