"""The port's decode tools against the JAX package's on the CPU:
``decode_greedy(stop_at=)`` (the same tokens and step counts), the
``decode_profile`` table and summary, and ``decode_diagnostic``'s
artifacts, on the same seeded tiny Whisper weights in f32."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.whisper import decode as jd
from whisperjav_tpu.models.whisper import model as jm
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.modules.audio_io import write_wav
from whisperjav_tpu_torch.models.whisper import decode as td
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax

_DIMS = dict(name="tools-tiny", n_mels=80, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51865)
CFG, TCFG = WhisperConfig(**_DIMS), TWhisperConfig(**_DIMS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    params = jm.init_params(CFG, jax.random.PRNGKey(1))
    model = params_from_jax(jax.tree.map(np.asarray, params), TCFG)
    mel = np.random.default_rng(2).standard_normal(
        (3, CFG.n_mels, 3000)).astype(np.float32)
    xa = np.array(jm.encode(params, CFG, jnp.asarray(mel))[:, :448])
    return params, model, xa


def _jax_steps(length, stop):
    """The JAX loop's step count, from its result: it runs until every
    row has emitted EOT (a row of ``length`` text tokens emits it at step
    ``length``) or ``stop`` steps."""
    length = np.asarray(length)
    return int(length.max()) + 1 if (length < stop).all() else stop


# ---------------------------------------------------------------------------
# decode_greedy(stop_at=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("noise", [False, True], ids=["greedy", "gumbel"])
@pytest.mark.parametrize("ban_eot", [False, True], ids=["eot", "no-eot"])
@pytest.mark.parametrize("stop_at", [3, 7, None])
def test_stop_at_matches_jax(tiny, monkeypatch, stop_at, ban_eot, noise):
    """The tests/test_decode.py protocol on both packages: the same
    tokens, lengths and number of steps; the cache keeps its
    max_new_tokens size."""
    params, model, xa = tiny
    kw = dict(max_new_tokens=16, cross_kv_int8=True)
    if ban_eot:
        kw["suppress_tokens"] = (CFG.eot,)
    jo, to = jd.DecodeOptions(**kw), td.DecodeOptions(**kw)
    seed, temperature = 5, (0.6 if noise else 0.0)
    extra = {}
    if noise:
        key, draws = jax.random.PRNGKey(seed), []
        for _ in range(jo.max_new_tokens):
            key, sub = jax.random.split(key)
            draws.append(torch.from_numpy(np.array(jax.random.gumbel(
                sub, (xa.shape[0], CFG.n_vocab), jnp.float32))))
        extra = dict(temperature=temperature, gumbel=lambda i: draws[i])
    ref = jd.decode_greedy(params, CFG, jnp.asarray(xa), jo,
                           temperature=temperature,
                           rng=jax.random.PRNGKey(seed), stop_at=stop_at)

    steps, caches = [], []
    step_fn = td.decode_step

    def counting(model_, tokens, pos, cache, cross):
        steps.append(tokens.shape[1])
        caches.append(cache.k.shape[2])
        return step_fn(model_, tokens, pos, cache, cross)

    monkeypatch.setattr(td, "decode_step", counting)
    out = td.decode_greedy(model, torch.from_numpy(xa), to,
                           stop_at=stop_at, **extra)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.length.numpy(), np.asarray(ref.length))
    np.testing.assert_allclose(out.avg_logprob.numpy(),
                               np.asarray(ref.avg_logprob), atol=1e-4)
    stop = 16 if stop_at is None else stop_at
    assert len(steps) - 1 == _jax_steps(ref.length, stop)   # less prefill
    assert set(caches) == {len(jd.initial_tokens(CFG, jo)) + 16}
    if ban_eot:
        assert (out.length.numpy() == stop).all()


# ---------------------------------------------------------------------------
# decode_profile
# ---------------------------------------------------------------------------

# deeper than 16 decoder layers, so the layer ablations run; hd = 64
PROFILE_DIMS = dict(name="profile-test", n_mels=80, n_audio_state=64,
                    n_audio_head=1, n_audio_layer=1, n_text_state=64,
                    n_text_head=1, n_text_layer=17, n_vocab=51865)


def _json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_decode_profile_emits_the_jax_table(monkeypatch, capsys):
    """Every variant of the JAX tool's table gets rows (int4_cross_kv as
    the port's error row), and the summary has the JAX summary's keys."""
    from whisperjav_tpu.tools import decode_profile as jprof
    from whisperjav_tpu_torch.models.whisper import config as tconfig
    from whisperjav_tpu_torch.tools import decode_profile as tprof

    assert jprof.main(["--model", "tiny", "--batch", "2", "--iters", "1",
                       "--budgets", "4", "8", "--mid-budget", "6",
                       "--group", "5", "--skip-bf16"]) == 0
    jsummary = _json_lines(capsys.readouterr().out)[-1]
    variants = {v for g in jsummary["groups"] for v in g} - {"__mid__"}

    monkeypatch.setitem(tconfig.WHISPER_SIZES, "profile-test",
                        TWhisperConfig(**PROFILE_DIMS))
    assert tprof.main(["--model", "profile-test", "--batch", "2",
                       "--iters", "1", "--budgets", "4", "8",
                       "--mid-budget", "6", "--device", "cpu"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    rows, summary = lines[:-1], lines[-1]
    by_variant = {}
    for r in rows:
        by_variant.setdefault(r["variant"].split("@")[0], []).append(r)
    assert set(by_variant) == variants | {"base", "bf16_weights"}
    for name, rs in by_variant.items():
        if name == "int4_cross_kv":
            assert len(rs) == 2 and all(
                "only int8 cross-K/V is ported" in r["error"] for r in rs)
        else:
            assert all(r["seconds"] > 0 and isinstance(r["launches"], dict)
                       for r in rs), rs
    assert set(jsummary) <= set(summary)
    assert set(summary["attribution_ms"]) == set(jsummary["attribution_ms"])
    assert summary["groups"] == jsummary["groups"]
    assert summary["layer_decomposition"]["points"].keys() == {"17", "16",
                                                                "8"}
    assert set(summary["launches_per_step"]) >= {"base", "fused_qkv",
                                                 "bf16_weights"}


def test_decode_profile_refuses_a_missing_card():
    from whisperjav_tpu_torch.tools import decode_profile as tprof
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tprof.main(["--model", "tiny", "--batch", "1"])


# ---------------------------------------------------------------------------
# decode_diagnostic
# ---------------------------------------------------------------------------

def _diag_clip(path):
    rng = np.random.default_rng(0)
    sr, parts = 16000, []
    for i in range(3):
        t = np.arange(int(1.5 * sr)) / sr
        tone = (0.3 * np.sin(2 * np.pi * (200 + 60 * i) * t)
                * (1 + 0.5 * np.sin(2 * np.pi * 4 * t)))
        parts += [tone + 0.03 * rng.standard_normal(len(t)),
                  np.zeros(int(1.0 * sr))]
    write_wav(str(path), np.concatenate(parts).astype(np.float32), sr)


def test_decode_diagnostic_matches_jax(tmp_path, monkeypatch):
    """The same VAD groups, per-group rows and summary on the same f32
    weights (the deterministic variants: sampled ladder rungs draw from
    each package's own generator)."""
    from whisperjav_tpu.models.whisper import config as jconfig
    from whisperjav_tpu.pipelines import engine as je
    from whisperjav_tpu.tools import decode_diagnostic as jdiag
    from whisperjav_tpu_torch.pipelines import engine as te
    from whisperjav_tpu_torch.pipelines import factory as tf
    from whisperjav_tpu_torch.tools import decode_diagnostic as tdiag

    params = jm.init_params(CFG, jax.random.PRNGKey(3))
    monkeypatch.setitem(jconfig.WHISPER_SIZES, CFG.name, CFG)
    monkeypatch.setattr(jm, "init_params", lambda *a, **k: params)
    jengine = je.TranscriptionEngine
    monkeypatch.setattr(je, "TranscriptionEngine", lambda *a, **k: jengine(
        *a, **k, compute_dtype=jnp.float32))
    model = params_from_jax(jax.tree.map(np.asarray, params), TCFG)
    monkeypatch.setattr(tf, "load_model", lambda *a, **k: (TCFG, model))
    tengine = te.TranscriptionEngine
    monkeypatch.setattr(te, "TranscriptionEngine", lambda *a, **k: tengine(
        *a, **k, compute_dtype=torch.float32))

    wav = tmp_path / "in.wav"
    _diag_clip(wav)
    variants = "base,gates_off,no_ts,beam"
    for main, out, extra in ((jdiag.main, tmp_path / "j", []),
                             (tdiag.main, tmp_path / "t",
                              ["--device", "cpu"])):
        assert main([str(wav), "--model", CFG.name, "--outdir", str(out),
                     "--variants", variants, "--batch", "4", *extra]) == 0
    for name in ("vad_groups.json", "groups.csv", "summary.json"):
        assert (tmp_path / "t" / name).read_text() \
            == (tmp_path / "j" / name).read_text(), name
    rows = (tmp_path / "t" / "groups.csv").read_text().splitlines()
    groups = json.loads((tmp_path / "t" / "vad_groups.json").read_text())
    assert len(rows) == 1 + 4 * len(groups) and groups

    # every variant, the sampled ladder included, runs in the port
    assert tdiag.main([str(wav), "--model", CFG.name, "--outdir",
                       str(tmp_path / "all"), "--batch", "4",
                       "--device", "cpu"]) == 0
    summary = json.loads((tmp_path / "all" / "summary.json").read_text())
    assert set(summary) == {"base", "gates_off", "no_ts", "ladder", "beam",
                            "gate_attribution"}
