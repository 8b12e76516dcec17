"""The port's checkpoint tools against the JAX package's on the CPU:
``verify_checkpoint`` on synthetic vendor-named checkpoints of all nine
families (the same family, format, counts, errors and warnings, and
converted leaves equal to the JAX converter's, exactly), the forward
smokes of silero, ten and zipenhancer (within 1e-5 of the JAX outputs),
``first_weights`` stages 0-2 (stage 2's texts token-identical to the JAX
stage 2 on the same f32 weights) and ``parity_check``'s summary (walls
aside).

The vendor dicts are those of ``tests/test_verify_checkpoint.py``
(silero, whisper, whisperseg, ten) and the port modules' own state
dicts, which carry the vendor names (the enhancers; a Qwen3-ASR thinker
dict served through a stand-in for ``transformers.AutoModel``)."""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_ensemble import short_wavs, tiny_builders
from test_torch_qwen_model import CFG as QCFG
from test_torch_qwen_model import _hf_state_dict as qwen_state_dict
from test_verify_checkpoint import _silero_vendor_dict
from whisperjav_tpu.tools import first_weights as jfw
from whisperjav_tpu.tools import parity_check as jpc
from whisperjav_tpu.tools import verify_checkpoint as jvc
from whisperjav_tpu_torch.tools import first_weights as tfw
from whisperjav_tpu_torch.tools import parity_check as tpc
from whisperjav_tpu_torch.tools import verify_checkpoint as tvc

transformers = pytest.importorskip("transformers")

REPORT_KEYS = ("family", "fmt", "ok", "n_source_keys", "n_leaves",
               "errors", "warnings", "forward")
SMOKE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_whisper(path, vocab=51865, d=64, heads=2, ffn=128):
    cfg = transformers.WhisperConfig(
        vocab_size=vocab, num_mel_bins=80, d_model=d, encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=heads,
        decoder_attention_heads=heads, encoder_ffn_dim=ffn,
        decoder_ffn_dim=ffn, max_source_positions=1500,
        max_target_positions=448, pad_token_id=0, bos_token_id=1,
        eos_token_id=2, decoder_start_token_id=3)
    torch.manual_seed(0)
    model = transformers.WhisperForConditionalGeneration(cfg).eval()
    model.save_pretrained(path)
    return model


@pytest.fixture(scope="module")
def hf_whisper(tmp_path_factory):
    path = tmp_path_factory.mktemp("hfw") / "tiny-whisper"
    return path, _hf_whisper(path)


# ---------------------------------------------------------------- families

def _torch_file(path, sd):
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
               path)
    return path


def _silero(tmp_path, _):
    return _torch_file(tmp_path / "silero_vad.pt", _silero_vendor_dict())


def _whisper(tmp_path, hf):
    return hf[0]


def _whisperseg(tmp_path, hf):
    sd = {f"model.{k}": v for k, v in hf[1].model.state_dict().items()}
    sd["head.weight"] = torch.zeros(1, 64) + 0.1
    sd["head.bias"] = torch.zeros(1)
    return _torch_file(tmp_path / "whisperseg.bin", sd)


def _ten(tmp_path, _):
    from whisperjav_tpu.models.vad import ten
    from whisperjav_tpu.utils import onnx_io
    params = ten.init_params(jax.random.PRNGKey(3))
    names = {"conv1.weight": "conv1_w", "conv1.bias": "conv1_b",
             "conv2.weight": "conv2_w", "conv2.bias": "conv2_b",
             "lstm.weight_ih_l0": "lstm_wi", "lstm.weight_hh_l0": "lstm_wh",
             "lstm.bias_ih_l0": "lstm_bi", "lstm.bias_hh_l0": "lstm_bh",
             "out.weight": "out_w", "out.bias": "out_b"}
    path = tmp_path / "ten_vad.onnx"
    onnx_io.write_onnx(str(path), onnx_io.OnnxGraph(initializers={
        k: np.asarray(params[v]) for k, v in names.items()}))
    return path


def _zipenhancer(tmp_path, _):
    from whisperjav_tpu_torch.models.enhancement import zipenhancer as tz
    model = tz.init_params(tz.ZIP_BASE, torch.Generator().manual_seed(2))
    return _torch_file(tmp_path / "zipenhancer.bin", {
        f"generator.{k}": v for k, v in model.state_dict().items()})


def _frcrn(tmp_path, _):
    from whisperjav_tpu_torch.models.enhancement import frcrn as tf
    model = tf.init_params(tf.FRCRN_TEST, torch.Generator().manual_seed(3))
    return _torch_file(tmp_path / "frcrn.pt", {
        f"model.{k}": v for k, v in model.state_dict().items()})


def _mossformer2(tmp_path, _):
    from whisperjav_tpu_torch.models.enhancement import mossformer2 as tm
    model = tm.init_params(tm.MF2_TEST, torch.Generator().manual_seed(4))
    return _torch_file(tmp_path / "mossformer2.pt", {
        f"model.mossformer.{k}": v for k, v in model.state_dict().items()})


def _bs_roformer(tmp_path, _):
    """The published layout (viperx bands, depth 12, stereo, one stem) at
    a narrow width: the JAX converter reads it with its default config."""
    from whisperjav_tpu_torch.models.enhancement import bs_roformer as tb
    cfg = tb.BSRoformerConfig(dim=8, heads=1, dim_head=8, ff_mult=1,
                              mlp_expansion_factor=1)
    model = tb.init_params(cfg, torch.Generator().manual_seed(5))
    return _torch_file(tmp_path / "bs_roformer.ckpt", model.state_dict())


def _qwen(tmp_path, _, monkeypatch):
    """An HF directory whose model load is served from a seeded
    Qwen3-ASR thinker state dict at the test widths."""
    path = tmp_path / "qwen3-asr"
    path.mkdir()
    (path / "config.json").write_text(json.dumps(
        {"model_type": "qwen3_asr", "architectures": ["Qwen3ASR"]}))
    sd = qwen_state_dict(np.random.default_rng(6), QCFG, tied=False)
    text = SimpleNamespace(
        vocab_size=QCFG.vocab_size, hidden_size=QCFG.d_model,
        num_hidden_layers=QCFG.n_layers,
        num_attention_heads=QCFG.n_heads,
        num_key_value_heads=QCFG.n_kv_heads,
        intermediate_size=QCFG.d_ff, head_dim=QCFG.head_dim,
        rope_theta=QCFG.rope_theta, rms_norm_eps=QCFG.rms_eps,
        eos_token_id=2, bos_token_id=1)
    audio = SimpleNamespace(
        num_mel_bins=QCFG.n_mels, d_model=QCFG.d_audio,
        encoder_layers=QCFG.audio_layers,
        encoder_attention_heads=QCFG.audio_heads,
        encoder_ffn_dim=QCFG.audio_ffn,
        downsample_hidden_size=QCFG.audio_downsample_hidden,
        n_window=QCFG.n_window, n_window_infer=QCFG.n_window_infer)
    hf = SimpleNamespace(
        config=SimpleNamespace(text_config=text, audio_config=audio,
                               name_or_path=str(path)),
        state_dict=lambda: {k: torch.from_numpy(v) for k, v in sd.items()})
    monkeypatch.setattr(transformers.AutoModel, "from_pretrained",
                        lambda *a, **k: hf)
    return path


FAMILIES = {"silero": _silero, "whisper": _whisper,
            "whisperseg": _whisperseg, "ten": _ten,
            "zipenhancer": _zipenhancer, "frcrn": _frcrn,
            "mossformer2": _mossformer2, "bs_roformer": _bs_roformer,
            "qwen": _qwen}


def test_every_family_is_covered():
    assert set(FAMILIES) == set(tvc.FAMILIES) == set(jvc.FAMILIES)


def _leaf(x):
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                      else x)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_verify_matches_jax(family, tmp_path, hf_whisper, monkeypatch):
    make = FAMILIES[family]
    path = (make(tmp_path, hf_whisper, monkeypatch) if family == "qwen"
            else make(tmp_path, hf_whisper))
    forward = family in ("silero", "ten", "zipenhancer")
    want = jvc.verify(str(path), forward=forward).to_dict()
    got = tvc.verify(str(path), forward=forward, device="cpu").to_dict()
    assert {k: got[k] for k in REPORT_KEYS} \
        == {k: want[k] for k in REPORT_KEYS}
    assert got["family"] == family and got["ok"], got

    # the converted leaves, exactly
    sd = None
    if path.is_file() and path.suffix != ".onnx":
        sd = tvc._load_state_dict(path)[0]
    jtree = jvc._convert(family, sd, path)[0]
    ttree = tvc._convert(family, sd, path)[0]
    jleaves = jax.tree.leaves(jtree)
    tleaves = tvc.tree_leaves(ttree)
    assert len(tleaves) == len(jleaves) == got["n_leaves"]
    for a, b in zip(tleaves, jleaves):
        a, b = _leaf(a), _leaf(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    if forward:
        audio = tvc.smoke_input(family)
        if family == "silero":
            from whisperjav_tpu.models.vad import silero
            ref = silero.apply(jtree, jnp.asarray(audio))
        elif family == "ten":
            from whisperjav_tpu.models.vad import ten
            ref = ten.apply(jtree, jnp.asarray(audio))
        else:
            # the reference's first STFT frame of a chunk is symmetric
            # under reflect padding, so its phase input (+-pi) is rounding
            # noise where the chunk starts inside sound (ROADMAP §3): the
            # comparison's input starts with 200 silent samples
            from whisperjav_tpu.models.enhancement import zipenhancer as z
            audio = audio.copy()
            audio[:, :200] = 0.0
            ref = z.denoise(jtree, jnp.asarray(audio), 1600)
        out = tvc.forward_outputs(family, ttree, "cpu", audio)
        np.testing.assert_allclose(out, np.asarray(ref), rtol=0,
                                   atol=SMOKE_TOL)


def test_failures_match_jax(tmp_path):
    junk = _torch_file(tmp_path / "junk.pt",
                       {"foo.weight": torch.zeros(3, 3)})
    sd = _silero_vendor_dict()
    sd["_model.decoder.rnn.weight_ih"] = torch.full_like(
        sd["_model.decoder.rnn.weight_ih"], float("nan"))
    nan = _torch_file(tmp_path / "silero_nan.pt", sd)
    for path in (junk, nan, tmp_path / "missing.pt"):
        want = jvc.verify(str(path)).to_dict()
        got = tvc.verify(str(path)).to_dict()
        assert {k: got[k] for k in REPORT_KEYS if k != "errors"} \
            == {k: want[k] for k in REPORT_KEYS if k != "errors"}
        assert not got["ok"] and len(got["errors"]) == len(want["errors"])
    # the same first words of each error (the last converter's message
    # names the port's own modules)
    assert tvc.verify(str(nan)).errors == jvc.verify(str(nan)).errors
    assert "no converter accepted" in tvc.verify(str(junk)).errors[0]


def test_verify_command_line(tmp_path, capsys):
    path = _silero(tmp_path, None)
    assert jvc.main([str(path), "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert tvc.main([str(path), "--json", "--forward",
                     "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["forward"].startswith("ok") and got["ok"]
    got.pop("forward"), want.pop("forward")
    assert got == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tvc.main([str(path), "--forward"])


# ---------------------------------------------------------------- first weights

@pytest.fixture(scope="module")
def fw_checkpoint(tmp_path_factory):
    """tests/test_first_weights.py's checkpoint (d=64, 4 heads of 16,
    2 + 2 layers) with the real vocabulary: the special tokens decoding
    starts from lie past a 1000-id table, which the JAX gather clamps and
    the port's indexing refuses."""
    path = tmp_path_factory.mktemp("fw") / "whisper-tiny-test"
    _hf_whisper(path, vocab=51865, d=64, heads=4, ffn=256)
    return path


def _f32_one_rung(monkeypatch):
    """Both factories build f32 engines with a one-rung ladder, and the
    port loads the checkpoint in f32 as the JAX package does: the two
    arms decode the same tokens in both packages (sampled rungs draw from
    each package's own generator)."""
    from whisperjav_tpu.pipelines import factory as jf
    from whisperjav_tpu_torch.pipelines import factory as tf

    def patch(mod, dtype):
        cls = mod.TranscriptionEngine

        def make(*a, **k):
            k["thresholds"] = dataclasses.replace(k["thresholds"],
                                                  temperatures=(0.0,))
            return cls(*a, **k, compute_dtype=dtype)
        monkeypatch.setattr(mod, "TranscriptionEngine", make)
    patch(jf, jnp.float32)
    patch(tf, torch.float32)
    load = tf.load_model
    monkeypatch.setattr(tf, "load_model", lambda *a, **k: load(
        *a, **{**k, "dtype": torch.float32}))


def test_first_weights_matches_jax(fw_checkpoint, tmp_path, monkeypatch):
    from whisperjav_tpu.tools.e2e_bench import synth_long_wav
    _f32_one_rung(monkeypatch)
    wav = tmp_path / "gate.wav"
    synth_long_wav(wav, minutes=6 / 60.0, seed=3)
    texts = {}
    for name, mod in (("jax", jfw), ("torch", tfw)):
        seen = []
        run = mod._transcribe_text

        def spy(*a, _run=run, _seen=seen, **k):
            out = _run(*a, **k)
            _seen.append(out)
            return out
        monkeypatch.setattr(mod, "_transcribe_text", spy)
        report_path = tmp_path / f"{name}.json"
        argv = ["--checkpoint", str(fw_checkpoint), "--wavs", str(wav),
                "--mode", "fast", "--batch-size", "4",
                "--report", str(report_path)]
        if name == "torch":
            argv += ["--device", "cpu"]
        rc = mod.main(argv)
        report = json.loads(report_path.read_text())
        texts[name] = (rc, report, seen)
    (jrc, jrep, jseen), (trc, trep, tseen) = texts["jax"], texts["torch"]
    assert trep["stage0_structural"]["ok"] and trep["stage0_structural"][
        "forward"] is None
    assert trep["stage1_oracle"]["status"] == "pass"
    assert trep["stage1_oracle"]["encoder_max_err"] < tfw.ENC_MAX_ERR
    assert trep["stage1_oracle"]["logit_argmax_agreement"] \
        >= tfw.ARGMAX_AGREE
    # stage 2: the bf16 and int8 arms' texts, token for token
    assert tseen == jseen and len(tseen) == 2
    assert trep["stage2_int8_gate"] == jrep["stage2_int8_gate"]
    assert trc == jrc and trep["ok"] == jrep["ok"]
    for key in ("family", "fmt", "n_source_keys", "n_leaves", "errors",
                "warnings"):
        assert trep["stage0_structural"][key] \
            == jrep["stage0_structural"][key]


def test_first_weights_refuses_a_missing_card(fw_checkpoint, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tfw.main(["--checkpoint", str(fw_checkpoint), "--report",
                  str(tmp_path / "r.json")])


# ---------------------------------------------------------------- parity check

def test_parity_check_matches_jax(tmp_path, monkeypatch):
    from whisperjav_tpu.modules.srt import Subtitle, save_srt
    tiny_builders(monkeypatch)
    wavs = short_wavs(tmp_path, 2)
    pairs = []
    for i, wav in enumerate(wavs):
        gt = tmp_path / f"gt{i}.srt"
        save_srt(gt, [Subtitle(1, 1.0, 6.0, "テスト音声です")])
        pairs.append(f"{wav}:{gt}")
    summaries = []
    for main, tag, extra in ((jpc.main, "j", []),
                             (tpc.main, "t", ["--device", "cpu"])):
        report = tmp_path / f"{tag}.json"
        assert main(["--pairs", *pairs, "--mode", "fast", "--batch-size",
                     "2", "--report", str(report), "--output-dir",
                     str(tmp_path / f"out-{tag}"), *extra]) == 0
        summaries.append(json.loads(report.read_text()))
    for s in summaries:
        s.pop("aggregate_rtf_x")
        for r in s["results"].values():
            r.pop("wall_s"), r.pop("rtf_x")
    assert summaries[1] == summaries[0]
    assert set(summaries[0]["results"]) == {str(w) for w in wavs}
