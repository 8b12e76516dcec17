"""The legacy band-split network and the heavy enhancement backends
(``bs-roformer``, ``clearvoice`` with MossFormer2, FRCRN or a legacy
band-split file) in the port against the JAX package, f32 on the CPU:

- the band partition, the rotary transformer block and the whole
  network on the same weights, and its ``__tree__`` ``.npz`` both ways;
- each backend's ``enhance`` on a 16 kHz clip (resample, chunks with
  crossfade, resample back) against the JAX backend's on one weights
  file, within 1e-5 of clips of magnitude ~0.5;
- the graceful paths: no weights, an unreadable file, the legacy
  fallback; a failure moving the model to the device raises;
- ``whisperjav-torch --enhancer clearvoice`` writes the JAX CLI's SRT and
  ``enhanced_scenes`` on the same Whisper weights;
- a fault of the reference the port keeps: ``--qwen-enhancer-model``
  never reaches the qwen-mode enhancer, in either package."""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.enhancement import bandsplit as jbs
from whisperjav_tpu.modules.audio_io import write_wav
from whisperjav_tpu.modules.enhancement import create_enhancer as j_enh
from whisperjav_tpu_torch.models.enhancement import bandsplit as tbs
from whisperjav_tpu_torch.models.enhancement import (
    bs_roformer as tb, frcrn as tf, mossformer2 as tm,
)
from whisperjav_tpu_torch.modules.enhancement import create_enhancer
from whisperjav_tpu_torch.modules.enhancement import (
    bandsplit_backends as heavy,
)
from test_torch_logging import keep_package_logger  # noqa: F401 (autouse)

# the factory defaults to the card; these tests run its backends on the CPU
t_enh = functools.partial(create_enhancer, device="cpu")

SR = 16000
TOL = 1e-5
SMALL = dict(sample_rate=16_000, n_fft=512, hop=128, n_bands=8, d_model=32,
             n_heads=2, n_layers=1)
# the configuration ClearVoice's backend reads a legacy file with
LEGACY = dict(sample_rate=48_000, target="noise", n_bands=20, n_layers=3)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed, scale=0.2):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def speech_like(duration_s, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(duration_s * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * 180 * t)
         * (1 + 0.5 * np.sin(2 * np.pi * 4 * t)))
    x += 0.05 * rng.standard_normal(t.size)
    return x.astype(np.float32)


# --------------------------------------------------------------- bandsplit

@pytest.mark.parametrize("n_freqs,n_bands", [(257, 8), (1025, 20),
                                             (1025, 24), (33, 30)])
def test_band_edges_match_jax(n_freqs, n_bands):
    assert tbs.band_edges(n_freqs, n_bands) == jbs.band_edges(n_freqs,
                                                              n_bands)


def _bandsplit_pair(tmp_path, seed, **cfg):
    """The JAX network's seeded params, written by the JAX package and
    read by the port."""
    jcfg = jbs.BandSplitConfig(**cfg)
    params = jbs.init_params(jcfg, jax.random.PRNGKey(seed))
    path = str(tmp_path / "jax_bs.npz")
    jbs.save_params(path, params)
    return jcfg, params, tbs.load_params(path, tbs.BandSplitConfig(**cfg))


def test_attn_block_matches_jax(tmp_path):
    jcfg, params, model = _bandsplit_pair(tmp_path, 0, **SMALL)
    x = _x((3, 11, 32), 1, 1.0)
    _close(tbs._attn_block(torch.from_numpy(x), model.time_blocks[0], 2),
           jbs._attn_block(jnp.asarray(x), params["time_blocks"][0], 2))


@pytest.mark.parametrize("cfg", [SMALL, LEGACY])
def test_apply_and_files_match_jax(tmp_path, cfg):
    jcfg, params, model = _bandsplit_pair(tmp_path, 2, **cfg)
    assert tbs.param_count(model) == jbs.param_count(params)
    n = 4096
    audio = _x((2, n), 3)
    want = jbs.apply(params, jcfg, jnp.asarray(audio), n)
    _close(tbs.apply(model, torch.from_numpy(audio), n), want)
    path = str(tmp_path / "torch_bs.npz")
    tbs.save_params(path, model)
    back = jbs.load_params(path)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bandsplit_init_draws_the_jax_distribution():
    cfg = tbs.BandSplitConfig(**SMALL)
    model = tbs.init_params(cfg, torch.Generator().manual_seed(4))
    params = jbs.init_params(jbs.BandSplitConfig(**SMALL),
                             jax.random.PRNGKey(4))
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            flat[prefix[:-1]] = np.asarray(node).shape

    walk(params, "")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == flat
    w = model.time_blocks[0].w1
    assert abs(w.std().item() - 32 ** -0.5) < 0.02


# ---------------------------------------------------------------- backends

@pytest.mark.parametrize("name", ["bs-roformer", "vocals", "clearvoice",
                                  "mossformer"])
def test_backends_pass_through_without_weights(name):
    audio = _x(1000, 5)
    got, want = t_enh(name).enhance(audio, SR), j_enh(name).enhance(audio, SR)
    assert (got.success, got.backend, got.stats) == \
        (want.success, want.backend, want.stats)
    assert not got.success and got.audio is audio
    assert not t_enh(name).is_lightweight
    assert t_enh(name).get_preferred_sample_rate() == \
        j_enh(name).get_preferred_sample_rate()
    frcrn = t_enh(name, model="FRCRN_SE_16K")
    assert frcrn.get_preferred_sample_rate() == j_enh(
        name, model="FRCRN_SE_16K").get_preferred_sample_rate()


def test_an_unreadable_file_passes_through(tmp_path):
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not an archive")
    for name in ("bs-roformer", "clearvoice"):
        for path in (bad, tmp_path / "missing.npz"):
            res = t_enh(name, weights=str(path)).enhance(_x(800, 6), SR)
            assert not res.success
            assert res.stats == {"reason": "no weights loaded"}


def test_a_device_failure_raises(tmp_path, monkeypatch):
    """The file loads into host tensors inside the guard; moving the
    model to the device is outside it, so its failure raises."""
    path = str(tmp_path / "mf2.npz")
    tm.save_params(path, tm.init_params(tm.MF2_TEST))
    to = tm.MossFormer2.to

    def lost(self, device, *a, **k):
        if torch.device(device).type != "cpu":
            raise RuntimeError("CUDA error: device lost")
        return to(self, device, *a, **k)

    monkeypatch.setattr(tm.MossFormer2, "to", lost)
    assert t_enh("clearvoice", weights=path)._engine == "mossformer2"
    with pytest.raises(RuntimeError, match="device lost"):
        t_enh("clearvoice", weights=path, device="meta")


def _files(tmp_path):
    """One weights file per engine, written by the port, read by both."""
    g = torch.Generator().manual_seed(7)
    files = {}
    for key, module, cfg in (("bs_roformer", tb, tb.BSR_TEST),
                             ("mossformer2", tm, tm.MF2_TEST),
                             ("frcrn", tf, tf.FRCRN_TEST)):
        files[key] = str(tmp_path / f"{key}.npz")
        module.save_params(files[key], module.init_params(cfg, g))
    files["bandsplit"] = str(tmp_path / "legacy.npz")
    tbs.save_params(files["bandsplit"], tbs.init_params(
        tbs.BandSplitConfig(**LEGACY), g))
    return files


@pytest.mark.parametrize("backend,engine,kwargs", [
    ("bs-roformer", "bs_roformer", {}),
    ("clearvoice", "mossformer2", {}),
    ("clearvoice", "frcrn", {"model": "FRCRN_SE_16K"}),
    ("clearvoice", "bandsplit", {}),
])
def test_backend_enhance_matches_jax(tmp_path, backend, engine, kwargs):
    """On a 16 kHz clip with three chunks (resampled to the engine's
    rate where it differs), as the JAX backend on the same file."""
    weights = _files(tmp_path)[engine]
    kw = dict(weights=weights, chunk_s=0.3, crossfade_s=0.05, **kwargs)
    audio = np.concatenate([np.zeros(800, np.float32),
                            speech_like(0.6, 8)])
    got = t_enh(backend, **kw)
    want = j_enh(backend, **kw)
    assert got.get_preferred_sample_rate() == \
        want.get_preferred_sample_rate()
    rg, rw = got.enhance(audio, SR), want.enhance(audio, SR)
    assert rg.success and rw.success
    assert rg.stats == rw.stats == {"engine": engine}
    _close(rg.audio, rw.audio)


def test_clearvoice_model_picks_the_engine(tmp_path):
    files = _files(tmp_path)
    assert t_enh("clearvoice", weights=files["frcrn"],
                 model="FRCRN_SE_16K")._engine == "frcrn"
    assert t_enh("clearvoice", weights=files["mossformer2"])._engine == \
        "mossformer2"
    legacy = t_enh("mossformer", weights=files["bandsplit"])
    assert legacy._engine == "bandsplit"
    assert isinstance(legacy, heavy.ClearVoiceBackend)
    assert isinstance(legacy._model, tbs.BandSplitNet)
    # the legacy network keeps the class's 48 kHz
    assert legacy.get_preferred_sample_rate() == 48_000


# ------------------------------------------------------------------- CLI

_DIMS = dict(name="torch-heavy-tiny", n_mels=80, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51865)


def test_cli_clearvoice_writes_the_jax_srt(tmp_path, monkeypatch):
    """``--enhancer clearvoice`` with MF2_TEST weights from the port's
    save_params, the same tiny Whisper weights in both CLIs (f32): the
    same SRT and the same enhanced scenes."""
    from whisperjav_tpu import cli as jcli
    from whisperjav_tpu.models.whisper.config import WhisperConfig
    from whisperjav_tpu.models.whisper.model import init_params
    from whisperjav_tpu.pipelines import engine as je
    from whisperjav_tpu.pipelines import factory as jfac
    from whisperjav_tpu_torch import cli as tcli
    from whisperjav_tpu_torch.models.whisper.config import (
        WhisperConfig as TorchWhisperConfig,
    )
    from whisperjav_tpu_torch.models.whisper.weights import params_from_jax
    from whisperjav_tpu_torch.pipelines import engine as te
    from whisperjav_tpu_torch.pipelines import factory as tfac

    jcfg, tcfg = WhisperConfig(**_DIMS), TorchWhisperConfig(**_DIMS)
    params = init_params(jcfg, jax.random.PRNGKey(7))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    monkeypatch.setattr(jfac, "load_model", lambda *a, **k: (jcfg, params))
    monkeypatch.setattr(tfac, "load_model", lambda *a, **k: (tcfg, model))
    monkeypatch.setattr(jfac, "TranscriptionEngine", functools.partial(
        je.TranscriptionEngine, compute_dtype=jnp.float32))
    monkeypatch.setattr(tfac, "TranscriptionEngine", functools.partial(
        te.TranscriptionEngine, compute_dtype=torch.float32))
    weights = str(tmp_path / "mf2.npz")
    tm.save_params(weights, tm.init_params(
        tm.MF2_TEST, torch.Generator().manual_seed(9)))
    gap = np.zeros(SR, np.float32)
    wav = tmp_path / "clip.wav"
    write_wav(wav, np.concatenate([gap, speech_like(5, 3), gap]), SR)
    flags = ["--batch-size", "1", "--logprob-threshold", "-100",
             "--devices", "1", "--enhancer", "clearvoice",
             "--enhancer-weights", weights]
    assert jcli.main([str(wav), "--output-dir", str(tmp_path / "jax"),
                      *flags]) == 0
    assert tcli.main([str(wav), "--output-dir", str(tmp_path / "torch"),
                      "--device", "cpu", *flags]) == 0
    meta = {side: json.loads((tmp_path / side / "clip.whisperjav.json")
                             .read_text())["stats"]
            for side in ("jax", "torch")}
    assert meta["torch"]["enhanced_scenes"] == \
        meta["jax"]["enhanced_scenes"] == meta["jax"]["scenes"] >= 1
    assert meta["torch"]["enhancer"] == {"backend": "clearvoice",
                                         "engines": ["mossformer2"]}
    srt = "clip.ja.whisperjav.srt"
    assert (tmp_path / "torch" / srt).read_text(encoding="utf-8") == \
        (tmp_path / "jax" / srt).read_text(encoding="utf-8")


def test_qwen_enhancer_model_never_reaches_the_enhancer(tmp_path):
    """A fault of the reference, kept in the port: in qwen mode the
    pipeline builds its enhancer from the backend name alone, so the
    weights of --qwen-enhancer-model (``enhancer_kwargs``) never load and
    the enhancer passes the audio through, in both packages."""
    from whisperjav_tpu.config.presets import (
        resolve_pipeline_config as j_resolve,
    )
    from whisperjav_tpu.pipelines.qwen_factory import (
        build_qwen_pipeline as j_build,
    )
    from whisperjav_tpu_torch.config.presets import (
        resolve_pipeline_config as t_resolve,
    )
    from whisperjav_tpu_torch.pipelines.qwen_factory import (
        build_qwen_pipeline as t_build,
    )
    weights = str(tmp_path / "mf2.npz")
    tm.save_params(weights, tm.init_params(tm.MF2_TEST))
    overrides = dict(mode="qwen", model="qwen3-asr-test",
                     enhancer_backend="clearvoice",
                     enhancer_kwargs={"weights": weights})
    audio = speech_like(1, 4)
    for pipe in (j_build(j_resolve(**overrides)),
                 t_build(t_resolve(**overrides), device="cpu")):
        assert pipe.enhancer.name == "clearvoice"
        assert pipe.enhancer.config.weights is None
        res = pipe.enhancer.enhance(audio, SR)
        assert not res.success and res.audio is audio
    # the weights themselves load
    assert t_enh("clearvoice", weights=weights).enhance(audio, SR).success
