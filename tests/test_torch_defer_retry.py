"""Deferred row-level retries of the temperature ladder in the port
(counterparts of ``tests/test_defer_retry.py``), and
``WJAV_DEFER_RETRY=0``, the inline ladder, against the JAX engine.

The JAX file forces gate failures with ``WJAV_GATE_FAIL_PCT``, which the
port does not read (ROADMAP §3); here random weights fail every gate by
themselves, and every other row is failed through a patched
``_row_needs_fallback`` (the same patch on both engines where they are
compared). Tiny model, real vocabulary, f32 on the CPU; the sampled rungs
are fed the JAX noise through ``engine.gumbel_source``."""

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
from whisperjav_tpu_torch.pipelines import engine as te
from whisperjav_tpu_torch.pipelines.engine import (
    QualityThresholds, TranscriptionEngine,
)
from test_torch_mesh import _jax_gumbel_source

_DIMS = dict(name="dr-tiny", n_audio_state=64, n_audio_head=4,
             n_audio_layer=2, n_text_state=64, n_text_head=4,
             n_text_layer=2)
CFG = WhisperConfig(**_DIMS)          # the JAX package's
TCFG = TorchWhisperConfig(**_DIMS)    # the port's


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_knobs(monkeypatch):
    for knob in ("WJAV_DEFER_RETRY", "WJAV_ENCODE_AHEAD",
                 "WJAV_DECODE_AHEAD", "WJAV_TRACE_BATCHES"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setattr(te, "gumbel_source", _jax_gumbel_source)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, jax.random.PRNGKey(0))


def _engine(params, temps=(0.0, 0.4)):
    return TranscriptionEngine(
        TCFG, params_from_jax(jax.tree.map(np.asarray, params), TCFG),
        options=td.DecodeOptions(max_new_tokens=12),
        thresholds=QualityThresholds(temperatures=temps),
        batch_size=2, device="cpu", compute_dtype=torch.float32)


def _jax_engine(params, temps=(0.0, 0.4)):
    return je.TranscriptionEngine(
        CFG, params, options=jd.DecodeOptions(max_new_tokens=12),
        thresholds=je.QualityThresholds(temperatures=temps),
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
             [(tuple(s.tokens), round(s.start, 4), round(s.end, 4))
              for s in segs])
            for w, segs in results]


def _every_other():
    """A gate that fails every other row it is asked about, from the
    first (row 0 of each two-row batch at the first rung): a failure in
    every batch, in the same rows in either package and on every path."""
    calls = []

    def needs_fallback(self, tokens, avg_lp, no_speech=0.0):
        calls.append(None)
        return len(calls) % 2 == 1
    return needs_fallback


def test_no_failures_paths_identical(params, monkeypatch):
    """With every row passing the first rung's gates, deferred and
    inline modes give the same output (the pool stays empty)."""
    eng = _engine(params)
    monkeypatch.setattr(TranscriptionEngine, "_row_needs_fallback",
                        lambda self, *a, **k: False)
    wins = _windows()
    monkeypatch.setenv("WJAV_DEFER_RETRY", "0")
    base = _flatten(eng.transcribe_windows(wins, seed=3))
    monkeypatch.setenv("WJAV_DEFER_RETRY", "1")
    defer = _flatten(eng.transcribe_windows(wins, seed=3))
    assert base == defer
    assert any(segs for _, segs in base)


@pytest.mark.parametrize("some", [True, False], ids=["some", "all"])
def test_all_windows_covered(params, monkeypatch, some):
    """Every window comes back exactly once when some rows (every other
    one) or all of them (random weights, the gates as they are) detour
    through the deferred pool; the JAX engine's results."""
    if some:
        for cls in (TranscriptionEngine, je.TranscriptionEngine):
            monkeypatch.setattr(cls, "_row_needs_fallback", _every_other())
    monkeypatch.setenv("WJAV_DEFER_RETRY", "1")
    results = _engine(params).transcribe_windows(_windows(7), seed=3)
    assert sorted(w.group_idx for w, _ in results) == list(range(7))
    assert all(isinstance(segs, list) for _, segs in results)
    ref = _jax_engine(params).transcribe_windows(_windows(7, JWindow),
                                                 seed=3)
    assert _flatten(results) == _flatten(ref)


def test_deferred_runs_fewer_decodes(params, monkeypatch):
    """At a failure rate that touches most batches, deferred mode runs
    fewer ladder decodes than inline whole-batch retries."""
    wins = _windows(8)     # 4 batches at B=2
    calls = {"n": 0}
    orig = TranscriptionEngine.decode_encoded

    def counting(self, xa, temperature=0.0, seed=0):
        if temperature > 0.0:
            calls["n"] += 1
        return orig(self, xa, temperature, seed)

    monkeypatch.setattr(TranscriptionEngine, "decode_encoded", counting)
    monkeypatch.setattr(TranscriptionEngine, "_row_needs_fallback",
                        _every_other())
    eng = _engine(params)
    monkeypatch.setenv("WJAV_DEFER_RETRY", "0")
    eng.transcribe_windows(wins, seed=3)
    inline_calls = calls["n"]
    calls["n"] = 0
    monkeypatch.setenv("WJAV_DEFER_RETRY", "1")
    eng.transcribe_windows(wins, seed=3)
    deferred_calls = calls["n"]
    assert 1 <= deferred_calls < inline_calls


def test_adopt_iff_improved(params, monkeypatch):
    """A deferred row keeps its first-rung tokens when the retry's avg
    logprob is not better, and adopts the retry when it is."""
    eng = _engine(params)
    monkeypatch.setenv("WJAV_DEFER_RETRY", "1")
    monkeypatch.setattr(TranscriptionEngine, "_row_needs_fallback",
                        lambda self, *a, **k: True)
    orig = TranscriptionEngine.decode_encoded
    mode = {"better": False}

    def rigged(self, xa, temperature=0.0, seed=0):
        res = te.to_host(orig(self, xa, 0.0, 0))   # deterministic payload
        if temperature > 0.0:
            tok = res.tokens.copy()
            tok[:, -1] = 42                        # visible marker
            avg = res.avg_logprob + (1.0 if mode["better"] else -1.0)
            return td.DecodeResult(tok, res.length, res.sum_logprob, avg,
                                   res.no_speech_prob)
        return res

    monkeypatch.setattr(TranscriptionEngine, "decode_encoded", rigged)
    wins = _windows(2)
    keep = _flatten(eng.transcribe_windows(wins, seed=3))
    mode["better"] = True
    adopt = _flatten(eng.transcribe_windows(wins, seed=3))

    def any_marker(flat):
        return any(42 in toks for _, segs in flat for toks, _, _ in segs)

    assert not any_marker(keep)
    assert any_marker(adopt)


def test_single_temperature_disables_pool(params, monkeypatch):
    """A one-rung ladder never defers (nothing to retry with)."""
    eng = _engine(params, temps=(0.0,))
    monkeypatch.setenv("WJAV_DEFER_RETRY", "1")
    pools = []
    orig = TranscriptionEngine.finish_batch

    def spy(self, *a, defer_pool=None, **k):
        pools.append(defer_pool)
        return orig(self, *a, defer_pool=defer_pool, **k)

    monkeypatch.setattr(TranscriptionEngine, "finish_batch", spy)
    results = eng.transcribe_windows(_windows(3), seed=3)
    assert sorted(w.group_idx for w, _ in results) == [0, 1, 2]
    assert pools == [None, None]


@pytest.mark.parametrize("defer", ["0", "1"])
def test_defer_knob_routes_the_ladder(params, monkeypatch, defer):
    """``WJAV_DEFER_RETRY=0`` retries inside each batch (no pass over a
    pool at the end of the file); the default settles the failed rows
    in one pass at the end. Either way the JAX engine's rung seeds,
    temperatures and results."""
    monkeypatch.setenv("WJAV_DEFER_RETRY", defer)
    seen = {"port": [], "jax": []}
    for key, cls in (("port", TranscriptionEngine),
                     ("jax", je.TranscriptionEngine)):
        orig_de, orig_rd = cls.decode_encoded, cls._retry_deferred

        def de(self, xa, temperature=0.0, seed=0, _o=orig_de, _k=key):
            seen[_k].append((float(temperature), seed))
            return _o(self, xa, temperature, seed)

        def rd(self, pool, seed, *a, _o=orig_rd, _k=key, **k):
            seen[_k].append(("deferred", len(pool)))
            return _o(self, pool, seed, *a, **k)
        monkeypatch.setattr(cls, "decode_encoded", de)
        monkeypatch.setattr(cls, "_retry_deferred", rd)
    got = _engine(params).transcribe_windows(_windows(), seed=3)
    want = _jax_engine(params).transcribe_windows(_windows(cls=JWindow),
                                                  seed=3)
    assert seen["port"] == seen["jax"]
    assert any(e[0] != "deferred" and e[0] > 0.0 for e in seen["port"])
    assert any(e[0] == "deferred" for e in seen["port"]) == (defer == "1")
    assert _flatten(got) == _flatten(want)
