"""whisperjav-torch-finetune against the JAX package's whisperjav-finetune:
the same examples, batches and mel from the same WAV and SRT, and the
CLI end to end on the CPU (tiny config, real vocab)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu import finetune as jft
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.models.whisper.model import init_params
from whisperjav_tpu.models.whisper.tokenizer import WhisperTokenizer
from whisperjav_tpu.modules.audio_io import write_wav
from whisperjav_tpu.modules.srt import Subtitle, save_srt
from whisperjav_tpu_torch import finetune as tft
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper.tokenizer import (
    WhisperTokenizer as TorchWhisperTokenizer,
)
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax

_DIMS = dict(name="ft-tiny", n_audio_state=64, n_audio_head=4,
             n_audio_layer=2, n_text_state=64, n_text_head=4,
             n_text_layer=2)
TINY = WhisperConfig(**_DIMS)
TTINY = TorchWhisperConfig(**_DIMS)
# the mel as tests/test_torch_mel.py holds it: f32 STFTs summed in other
# orders, a few near-null bins magnified by log10
MEL_ATOL = 2e-4
MEL_MEAN_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_pair(tmp_path, name="clip", seconds=35.0, cues=None):
    sr = 16000
    t = np.arange(int(seconds * sr)) / sr
    x = (0.3 * np.sin(2 * np.pi * 220 * t)
         * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    wav = tmp_path / f"{name}.wav"
    write_wav(wav, x, sr)
    srt = tmp_path / f"{name}.srt"
    cues = cues or [(1.0, 3.0, "こんにちは"),
                    (5.0, 8.0, "ありがとうございます"),
                    (31.0, 33.0, "さようなら")]
    save_srt(srt, [Subtitle(i + 1, a, b, text)
                   for i, (a, b, text) in enumerate(cues)])
    return wav, srt


def test_discover_pairs_matches_jax(tmp_path):
    _make_pair(tmp_path, "a")
    _make_pair(tmp_path, "b")
    (tmp_path / "b.srt").rename(tmp_path / "b.ja.whisperjav.srt")
    (tmp_path / "lonely.wav").write_bytes((tmp_path / "a.wav").read_bytes())
    assert tft.discover_pairs(tmp_path) == jft.discover_pairs(tmp_path)
    assert len(tft.discover_pairs(tmp_path)) == 2


@pytest.mark.parametrize("max_tokens", [64, 12])
def test_build_examples_match_jax(tmp_path, max_tokens):
    """The same windows, tokens and loss masks; at 12 tokens the second
    cue of window 0 overflows and ends that window's cues."""
    wav, srt = _make_pair(tmp_path)
    ref = list(jft.build_examples(wav, srt, WhisperTokenizer(TINY), TINY,
                                  max_tokens=max_tokens))
    out = list(tft.build_examples(wav, srt, TorchWhisperTokenizer(TTINY),
                                  TTINY, max_tokens=max_tokens))
    assert len(out) == len(ref) == 2
    for (a, t, m), (ra, rt, rm) in zip(out, ref):
        np.testing.assert_array_equal(a, ra)
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(m, rm)
        assert t.dtype == rt.dtype and m.dtype == rm.dtype


def test_batch_examples_match_jax(tmp_path):
    """Batches of 2 from three windows: the tail pads by repeating its
    first example, as the JAX package does; the mel within mel
    tolerance."""
    wav, srt = _make_pair(tmp_path, seconds=75.0,
                          cues=[(1.0, 3.0, "あ"), (31.0, 33.0, "い"),
                                (61.0, 63.0, "う")])
    tok, ttok = WhisperTokenizer(TINY), TorchWhisperTokenizer(TTINY)
    ref = list(jft.batch_examples(
        jft.build_examples(wav, srt, tok, TINY, 32), 2, TINY.n_mels))
    out = list(tft.batch_examples(
        tft.build_examples(wav, srt, ttok, TTINY, 32), 2, TTINY.n_mels))
    assert len(out) == len(ref) == 2
    for (mel, tokens, mask), (rmel, rtokens, rmask) in zip(out, ref):
        assert mel.shape == rmel.shape == (2, TINY.n_mels, 3000)
        err = np.abs(mel.numpy() - rmel)
        assert err.max() < MEL_ATOL and err.mean() < MEL_MEAN_ATOL
        np.testing.assert_array_equal(tokens, rtokens)
        np.testing.assert_array_equal(mask, rmask)
    # the tail batch: window 2 twice
    np.testing.assert_array_equal(out[1][1][1], out[1][1][0])
    assert not np.array_equal(out[1][1][0], out[0][1][0])


@pytest.fixture
def tiny_model(monkeypatch):
    """factory.load_model gives the tiny config's seeded weights (f32, on
    the CPU); returns the host copy of the tree."""
    import whisperjav_tpu_torch.pipelines.factory as factory
    tree = jax.tree.map(lambda x: np.asarray(x).copy(),
                        init_params(TINY, jax.random.PRNGKey(0)))
    calls = []

    def load(name, checkpoint=None, device="cuda", dtype=None):
        calls.append((name, str(device), dtype))
        return TTINY, params_from_jax(tree, TTINY, dtype=dtype,
                                      device=device)
    monkeypatch.setattr(factory, "load_model", load)
    return tree, calls


def test_finetune_cli_end_to_end(tmp_path, tiny_model):
    """2 steps on the CPU: a finite loss, a checkpoint each --save-every
    and at the end, the weights changed, and the checkpoint reloadable by
    the port and by the JAX package."""
    from whisperjav_tpu.utils.checkpoint import (
        load_checkpoint as jax_load,
    )
    from whisperjav_tpu_torch.utils.checkpoint import (
        checkpoint_metadata, load_checkpoint,
    )
    tree, calls = tiny_model
    data = tmp_path / "data"
    data.mkdir()
    _make_pair(data)
    out = tmp_path / "ft"
    rc = tft.main(["--data", str(data), "--model", "tiny", "--steps", "2",
                   "--batch-size", "2", "--max-tokens", "64",
                   "--save-every", "1", "--device", "cpu",
                   "--output-dir", str(out)])
    assert rc == 0
    assert calls == [("tiny", "cpu", torch.float32)]
    assert sorted(p.name for p in out.glob("step_*")) == \
        ["step_000001", "step_000002"]
    meta = checkpoint_metadata(out / "step_000002")
    assert meta["backend"] == "npz" and meta["step"] == 2
    assert meta["model"] == "ft-tiny"
    assert all(np.isfinite(meta["loss_history_tail"]))
    restored = load_checkpoint(out / "step_000002", tree)
    leaves = jax.tree.leaves(restored)
    assert all(np.isfinite(leaf).all() for leaf in leaves)
    assert any(not np.allclose(a, b)
               for a, b in zip(jax.tree.leaves(tree), leaves))
    via_jax = jax_load(out / "step_000002",
                       jax.tree.map(jnp.asarray, tree))
    for a, b in zip(jax.tree.leaves(via_jax), leaves):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_finetune_no_data_errors(tmp_path):
    assert tft.main(["--data", str(tmp_path), "--steps", "1"]) == 1


def test_finetune_without_a_gpu_raises(tmp_path, tiny_model):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    _make_pair(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tft.main(["--data", str(tmp_path), "--steps", "1"])


class _Parsed(Exception):
    pass


def test_flags_and_defaults_match_jax(monkeypatch):
    """Every flag of the JAX CLI with its default, and --device."""
    import argparse
    parsed = []
    parse = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        parsed.append(vars(parse(self, args, namespace)))
        raise _Parsed
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    for main in (jft.main, tft.main):
        with pytest.raises(_Parsed):
            main(["--data", "d"])
    theirs, ours = parsed
    assert ours.pop("device") == "cuda"
    assert ours == theirs
