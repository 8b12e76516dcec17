"""The JAX package's environment switches in the port, against the JAX
package on the CPU (tiny Whisper, f32, seeded weights carried across
with ``params_from_jax``):

- every ``WJAV_*`` name that ``whisperjav_tpu/`` reads is read by
  ``whisperjav_tpu_torch/`` too, or stands in :data:`NOT_PORTED` with its
  reason;
- ``WJAV_VOCAB_SLICE`` with no ``--vocab-slice``: both factories build
  the same subset and decode the same tokens;
- ``WJAV_FUSE_QKV`` in the engine: tokens equal fused and apart, on float
  and int8 decoder weights, in both packages;
- ``WJAV_BEAM_SHARED_CROSS``: beam tokens, lengths and log-probabilities
  of the shared and the repeated cross-K/V layout equal the JAX
  package's, on int8, unquantised and int4 cross-K/V;
- ``tools/e2e_bench``'s provenance keys.

The Qwen switches (``WJAV_FUSE_QKV`` in the generator and the
translator, ``WJAV_QWEN_INT8``, ``WJAV_ALIGN_DEVICE``) are in
``test_torch_switches_qwen.py``, ``WJAV_POOL_SCENES`` in
``test_torch_qwen_pipeline.py``. Each switch is off only for "0"."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.config.presets import resolve_pipeline_config
from whisperjav_tpu.models.whisper import decode as jd
from whisperjav_tpu.models.whisper import model as jm
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.pipelines import engine as je
from whisperjav_tpu.pipelines import factory as jfactory
from whisperjav_tpu_torch.config.presets import (
    resolve_pipeline_config as t_resolve,
)
from whisperjav_tpu_torch.models.whisper import decode as td
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax
from whisperjav_tpu_torch.pipelines import engine as te
from whisperjav_tpu_torch.pipelines import factory as tfactory

ROOT = Path(__file__).resolve().parents[1]

# the JAX package's switches the port does not read, each with its reason
NOT_PORTED = {
    "WJAV_COMPILE_CACHE": "XLA's persistent compile cache",
    "WJAV_CARRY_CACHE": "XLA's scan-carry aliasing of the decode cache",
    "WJAV_SCAN_UNROLL": "the unroll of lax.scan",
    "WJAV_COLUMN_CACHE": "the XLA decode program's cache-update layout "
                         "(the port's step always runs column mode)",
    "WJAV_QWEN_COLUMN_CACHE": "the XLA Qwen program's cache-update layout",
    "WJAV_USE_PALLAS": "the Pallas encoder kernel's opt-in (on the card "
                       "the port's kernel always runs)",
    "WJAV_PALLAS_DECODE": "the Pallas decode kernels' opt-in",
    "WJAV_PALLAS_FUSE": "the Pallas fused decode blocks' opt-in",
    "WJAV_GATE_FAIL_PCT": "bench-only gate-outcome injection, a tested "
                          "departure of the port",
}

# a read of the environment: os.environ.get / [] / setdefault / pop,
# os.getenv, with the name as a literal
_READ = re.compile(r"(?:environ\.get|environ\.setdefault|environ\.pop|"
                   r"getenv|environ\[)\(?\s*[\"'](WJAV_[A-Z0-9_]+)")


def _reads(package: str) -> dict:
    out = {}
    for path in sorted((ROOT / package).rglob("*.py")):
        for m in _READ.finditer(path.read_text(encoding="utf-8")):
            out.setdefault(m.group(1), []).append(
                str(path.relative_to(ROOT)))
    return out


def test_every_jax_switch_is_read_or_listed():
    jax_reads = _reads("whisperjav_tpu")
    port_reads = _reads("whisperjav_tpu_torch")
    # the scan sees the readers it should
    assert {"WJAV_FUSE_QKV", "WJAV_VOCAB_SLICE", "WJAV_COMPILE_CACHE"} \
        <= set(jax_reads)
    missing = sorted(set(jax_reads) - set(port_reads) - set(NOT_PORTED))
    assert not missing, {n: jax_reads[n] for n in missing}
    # the list holds only names the JAX package reads and the port does not
    assert set(NOT_PORTED) <= set(jax_reads)
    assert not set(NOT_PORTED) & set(port_reads)
    assert all(reason for reason in NOT_PORTED.values())


@pytest.mark.parametrize("name,readers", [
    ("WJAV_FUSE_QKV", ("pipelines/engine.py",
                       "modules/subtitle_pipeline/components.py",
                       "translate/local_backend.py")),
    ("WJAV_QWEN_INT8", ("modules/subtitle_pipeline/components.py",)),
    ("WJAV_ALIGN_DEVICE", ("modules/subtitle_pipeline/components.py",)),
    ("WJAV_POOL_SCENES", ("modules/subtitle_pipeline/orchestrator.py",)),
    ("WJAV_BEAM_SHARED_CROSS", ("models/whisper/decode.py",)),
    ("WJAV_VOCAB_SLICE", ("pipelines/factory.py",)),
])
def test_each_switch_is_read_where_the_jax_package_reads_it(name, readers):
    jax_files = {f.split("/", 1)[1] for f in _reads("whisperjav_tpu")[name]}
    port_files = {f.split("/", 1)[1]
                  for f in _reads("whisperjav_tpu_torch")[name]}
    assert set(readers) <= jax_files
    assert set(readers) == port_files


def test_e2e_bench_provenance_keys(monkeypatch):
    from whisperjav_tpu_torch.tools import e2e_bench
    jax_src = (ROOT / "whisperjav_tpu/tools/e2e_bench.py").read_text()
    jax_keys = set(re.findall(
        r"\"(WJAV_[A-Z0-9_]+)\"",
        jax_src[jax_src.index("prov = {"):jax_src.index("if k in os.environ")]))
    assert {"WJAV_ALIGN_DEVICE", "WJAV_QWEN_INT8"} <= jax_keys
    assert jax_keys - set(NOT_PORTED) <= set(e2e_bench.PROVENANCE_KEYS)
    assert set(e2e_bench.PROVENANCE_KEYS) - jax_keys == {
        "WJAV_TRACE_BATCHES"}
    for key in e2e_bench.PROVENANCE_KEYS:
        monkeypatch.delenv(key, raising=False)
    assert e2e_bench.provenance([]) == {}
    monkeypatch.setenv("WJAV_ALIGN_DEVICE", "0")
    monkeypatch.setenv("WJAV_QWEN_INT8", "0")
    monkeypatch.setenv("WJAV_GATE_FAIL_PCT", "5")
    assert e2e_bench.provenance(["--daemon"]) == {
        "WJAV_ALIGN_DEVICE": "0", "WJAV_QWEN_INT8": "0", "path": "daemon"}


# ---------------------------------------------------------------------------
# the Whisper switches
# ---------------------------------------------------------------------------

_DIMS = dict(name="torch-switch-tiny", n_mels=80, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51865)
CFG = WhisperConfig(**_DIMS)          # the JAX package's
TCFG = TorchWhisperConfig(**_DIMS)    # the port's
BALANCED = dict(max_new_tokens=12, repetition_penalty=1.5,
                no_repeat_ngram_size=3, patience=1.2, best_of=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jm.init_params(CFG, jax.random.PRNGKey(13))


def _model(params):
    return params_from_jax(jax.tree.map(np.asarray, params), TCFG)


def _audio(batch=3, seed=0):
    rng = np.random.default_rng(seed)
    out = np.zeros((batch, 480000), np.float32)
    for i in range(batch):
        n = int((4.0 + 3 * i) * 16000)
        t = np.arange(n) / 16000.0
        out[i, :n] = (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t)
                      + 0.05 * rng.standard_normal(n))
    return out


def _engines(params, beam, int8_weights=False, **opts):
    """The JAX engine and the port's, built under the environment as it
    stands (each reads its switches when it is built or first traced)."""
    th = dict(temperatures=(0.0,))
    kw = dict(BALANCED, beam_size=beam, **opts)
    ref = je.TranscriptionEngine(
        CFG, params, options=jd.DecodeOptions(**kw),
        thresholds=je.QualityThresholds(**th), batch_size=3,
        compute_dtype=jnp.float32, int8_weights=int8_weights)
    out = te.TranscriptionEngine(
        TCFG, _model(params), options=td.DecodeOptions(**kw),
        thresholds=te.QualityThresholds(**th), batch_size=3, device="cpu",
        compute_dtype=torch.float32, int8_weights=int8_weights)
    return ref, out


def _decode(ref, out, audio):
    want = ref.decode_batch(audio, 0.0, 0)
    got = out.decode_encoded(out.encode_batch(audio), 0.0, 0)
    return got, want


def _assert_same(got, want):
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.length, np.asarray(want.length))
    np.testing.assert_allclose(got.avg_logprob,
                               np.asarray(want.avg_logprob), atol=1e-4)


def _set(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("int8_weights", [False, True],
                         ids=["float", "int8"])
def test_fuse_qkv_engine(params, monkeypatch, int8_weights):
    """Unset and "0": the port's engine fuses q/k/v exactly when the JAX
    engine does; beam-2 tokens on int8 cross-K/V equal the JAX engine's
    and each other's. Apart on int8 weights, a step does not take the
    fused blocks (their gate wants ``wqkv``)."""
    audio = _audio()
    results = {}
    for value in (None, "0"):
        _set(monkeypatch, "WJAV_FUSE_QKV", value)
        ref, out = _engines(params, 2, int8_weights, cross_kv_int8=True)
        blocks = out.model.decoder.blocks
        fused = value is None
        assert ("wqkv" in ref.params["decoder"]["blocks"]) == fused
        assert ("wqkv" in blocks) == fused
        assert ("wq" in blocks) == (not fused)
        if int8_weights:
            assert type(blocks["wq" if not fused else "wqkv"]).__name__ \
                == "Int8Weight"
        got, want = _decode(ref, out, audio)
        _assert_same(got, want)
        results[value] = got
    np.testing.assert_array_equal(results[None].tokens, results["0"].tokens)


@pytest.mark.parametrize("cross", ["int8", "bf16", "int4"])
def test_beam_shared_cross(params, monkeypatch, cross):
    """Beam 2: the shared layout (B cross-K/V rows, the beams folded) and
    the repeat layout (B x k rows) against the JAX package's under the
    same switch. "bf16" is the unquantised cross-K/V (f32 here)."""
    opts = {"int8": dict(cross_kv_int8=True), "bf16": {},
            "int4": dict(cross_kv_int4=True)}[cross]
    rows = []
    real = td.precompute_cross_kv

    def spy(model, xa, **kw):
        rows.append(xa.shape[0])
        return real(model, xa, **kw)

    monkeypatch.setattr(td, "precompute_cross_kv", spy)
    audio = _audio()
    results = {}
    for value in (None, "0"):
        _set(monkeypatch, "WJAV_BEAM_SHARED_CROSS", value)
        rows.clear()
        ref, out = _engines(params, 2, **opts)
        got, want = _decode(ref, out, audio)
        assert rows == [3 if value is None else 6]
        _assert_same(got, want)
        results[value] = got
    _assert_same(results["0"], results[None])


def test_beam_shared_cross_is_read_on_each_call(params, monkeypatch):
    """The port reads the switch on each ``decode_beam`` call: one engine
    under both settings gives the same tokens."""
    _, out = _engines(params, 2, cross_kv_int8=True)
    xa = out.encode_batch(_audio(batch=3, seed=2))
    got = {}
    for value in (None, "0"):
        _set(monkeypatch, "WJAV_BEAM_SHARED_CROSS", value)
        got[value] = out.decode_encoded(xa, 0.0, 0)
    np.testing.assert_array_equal(got[None].tokens, got["0"].tokens)
    np.testing.assert_allclose(got[None].avg_logprob, got["0"].avg_logprob,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# WJAV_VOCAB_SLICE in the factories
# ---------------------------------------------------------------------------

def _f32_engine(module, dtype):
    """``module.TranscriptionEngine`` computing in ``dtype``."""
    return functools.partial(module.TranscriptionEngine, compute_dtype=dtype)


@pytest.mark.parametrize("flag,env,want", [
    (None, "6000", 6000), ("3000", "6000", 3000), (None, None, None),
    (None, "0", None)], ids=["env", "flag-wins", "unset", "zero"])
def test_vocab_slice_env_in_both_factories(params, monkeypatch, flag, env,
                                           want):
    """``WJAV_VOCAB_SLICE=<n>`` with no ``--vocab-slice``: both factories
    slice the head to the same synthetic subset, and their engines decode
    the same tokens (f32, the factories' balanced beam-2 options); the
    flag wins over the variable, and unset or 0 keeps the full head."""
    _set(monkeypatch, "WJAV_VOCAB_SLICE", env)
    monkeypatch.setattr(jfactory, "TranscriptionEngine",
                        _f32_engine(je, jnp.float32))
    monkeypatch.setattr(tfactory, "TranscriptionEngine",
                        _f32_engine(te, torch.float32))
    monkeypatch.setattr(tfactory, "load_model",
                        lambda *a, **k: (TCFG, _model(params)))
    kw = dict(mode="balanced", sensitivity="balanced", batch_size=3)
    cfg = resolve_pipeline_config(**kw)
    tcfg = t_resolve(**kw)
    cfg.vocab_slice = tcfg.vocab_slice = flag
    ref = jfactory.build_pipeline(cfg, model_config=CFG, params=params,
                                  devices=1).engine
    out = tfactory.build_pipeline(tcfg, device="cpu").engine
    if want is None:
        assert ref._vocab is None and out._vocab is None
        assert out.model.decoder.tok_emb.shape[0] == CFG.n_vocab
        return
    n_sub = want + CFG.n_vocab - CFG.eot
    assert len(ref._vocab.sub_ids) == len(out._vocab.sub_ids) == n_sub
    np.testing.assert_array_equal(out._vocab.sub_ids, ref._vocab.sub_ids)
    assert out.model.decoder.tok_emb.shape[0] == n_sub
    audio = _audio(seed=3)
    got, want_res = _decode(ref, out, audio)
    _assert_same(got, want_res)
