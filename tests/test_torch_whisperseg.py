"""The port's WhisperSeg network and whisper-vad backend against the JAX
package's, on a narrow config with the published 1500 query positions.

The port keeps the decoder's cross K/V in int8 (Kernel B's operand), the
JAX module in f32. So the port's frame logits are held to the JAX model
composed with ``precompute_cross_kv(int8=True)`` within INT8_TOL (f32 on
both sides), and to the JAX ``frame_logits`` within KV_TOL (the int8
rounding of K/V, per (layer, batch, head), ~1/254 of each head's largest
value). The segmenters' segments and groups are identical; whisper-vad's
speech probabilities (1 - no_speech_prob of one decode step through
``decode_batch``) agree within INT8_TOL with the JAX engine on int8 cross
K/V, and, where each segmenter builds its own default engine (bf16, cross
K/V in the compute dtype, as the JAX segmenter's options), within
VAD_BF16_TOL."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.vad import whisperseg as jws
from whisperjav_tpu.models.whisper import model as jm
from whisperjav_tpu.models.whisper.model import sinusoid_positions
from whisperjav_tpu.ops.mel import log_mel_spectrogram as j_mel
from whisperjav_tpu_torch.models.vad import whisperseg as tws

SR = 16000
INT8_TOL = 1e-4      # logits / probabilities, int8 cross K/V on both sides
KV_TOL = 5e-3        # logits, port int8 K/V against JAX f32 K/V
NARROW = dataclasses.replace(jws.SEG_CONFIG, n_audio_state=64,
                             n_text_state=64, n_audio_layer=1, n_vocab=512)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def speech(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = (np.sin(2 * np.pi * t / 3.7 + seed) > -0.2).astype(np.float64)
    x = 0.3 * np.sin(2 * np.pi * 190 * t) * env
    return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def tree():
    """A narrow seeded tree whose frames differ: sinusoid decoder
    positions (the init's zero positions make every query, and every
    frame's logit, the same) and a head bias at minus the median logit
    of a probe window."""
    params = jws.init_params(jax.random.PRNGKey(0), config=NARROW)
    params = jax.tree.map(np.asarray, params)
    params["decoder"]["pos_emb"] = sinusoid_positions(1500, 64)
    probe = np.asarray(jws.frame_logits(params, speech(30.0, 1)[None],
                                        NARROW))
    params["head"]["b"] = (params["head"]["b"]
                           - np.median(probe)).astype(np.float32)
    return params


def _jax_int8_logits(params, audio):
    """The JAX WhisperSeg forward with int8 cross K/V."""
    mel = j_mel(jnp.asarray(audio), n_mels=NARROW.n_mels)
    xa = jm.encode(params, NARROW, mel)
    cross = jm.precompute_cross_kv(params, NARROW, xa, int8=True)
    b = audio.shape[0]
    cache = jm.KVCache.zeros(NARROW, b, NARROW.n_text_ctx, jnp.float32)
    tokens = jnp.full((b, NARROW.n_text_ctx), jws.QUERY_TOKEN_ID, jnp.int32)
    hidden, _ = jm.decode_hidden(params, NARROW, tokens, 0, cache, cross)
    return np.asarray(hidden @ params["head"]["w"] + params["head"]["b"]
                      )[..., 0]


def test_frame_logits_match_jax(tree):
    audio = np.stack([speech(30.0, 2), speech(30.0, 3) * 0.5])
    model = tws.params_from_jax(tree, tws.config_from_tree(tree))
    got = tws.frame_logits(model, torch.from_numpy(audio)).numpy()
    assert got.shape == (2, 1500) and got.dtype == np.float32
    np.testing.assert_allclose(got, _jax_int8_logits(tree, audio),
                               atol=INT8_TOL, rtol=0)
    f32_kv = np.asarray(jws.frame_logits(tree, audio, NARROW))
    np.testing.assert_allclose(got, f32_kv, atol=KV_TOL, rtol=0)
    # the frames differ, on both sides of 0 (the segmenter's threshold)
    assert (got > 0).any() and (got < 0).any()


def test_config_and_npz_round_trip(tmp_path, tree):
    jws.save_params(str(tmp_path / "j.npz"), tree)
    model = tws.load_params(str(tmp_path / "j.npz"))
    assert dataclasses.asdict(model.config) == dataclasses.asdict(NARROW)
    tws.save_params(str(tmp_path / "t.npz"), model)
    back = jws.load_params(str(tmp_path / "t.npz"))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(np.asarray(node), leaf,
                                      err_msg=str(path))
    init = tws.init_params(torch.Generator().manual_seed(0), NARROW)
    assert jax.tree.map(np.shape, tws._tree(init)) == \
        jax.tree.map(np.shape, tree)


# (tree leaf, HF name, transposed) of one layer, as convert._stack_blocks
_HF_LAYER = (
    ("ln1_s", "self_attn_layer_norm.weight", False),
    ("ln1_b", "self_attn_layer_norm.bias", False),
    ("wq", "self_attn.q_proj.weight", True),
    ("bq", "self_attn.q_proj.bias", False),
    ("wk", "self_attn.k_proj.weight", True),
    ("wv", "self_attn.v_proj.weight", True),
    ("bv", "self_attn.v_proj.bias", False),
    ("wo", "self_attn.out_proj.weight", True),
    ("bo", "self_attn.out_proj.bias", False),
    ("ln2_s", "final_layer_norm.weight", False),
    ("ln2_b", "final_layer_norm.bias", False),
    ("w1", "fc1.weight", True), ("b1", "fc1.bias", False),
    ("w2", "fc2.weight", True), ("b2", "fc2.bias", False),
    ("lnx_s", "encoder_attn_layer_norm.weight", False),
    ("lnx_b", "encoder_attn_layer_norm.bias", False),
    ("cwq", "encoder_attn.q_proj.weight", True),
    ("cbq", "encoder_attn.q_proj.bias", False),
    ("cwk", "encoder_attn.k_proj.weight", True),
    ("cwv", "encoder_attn.v_proj.weight", True),
    ("cbv", "encoder_attn.v_proj.bias", False),
    ("cwo", "encoder_attn.out_proj.weight", True),
    ("cbo", "encoder_attn.out_proj.bias", False),
)


def _hf_state_dict(tree) -> dict:
    """An HF-Whisper-named state dict (torch Linear (out, in) weights)
    holding ``tree``, with the frame head as ``classifier.*``."""
    sd = {}
    for part in ("encoder", "decoder"):
        blocks = tree[part]["blocks"]
        for i in range(blocks["wq"].shape[0]):
            for leaf, name, transposed in _HF_LAYER:
                if leaf in blocks:
                    x = blocks[leaf][i]
                    sd[f"model.{part}.layers.{i}.{name}"] = torch.tensor(
                        x.T if transposed else x)
        sd[f"model.{part}.layer_norm.weight"] = tree[part]["ln_s"]
        sd[f"model.{part}.layer_norm.bias"] = tree[part]["ln_b"]
    enc, dec = tree["encoder"], tree["decoder"]
    sd.update({"model.encoder.conv1.weight": enc["conv1_w"],
               "model.encoder.conv1.bias": enc["conv1_b"],
               "model.encoder.conv2.weight": enc["conv2_w"],
               "model.encoder.conv2.bias": enc["conv2_b"],
               "model.encoder.embed_positions.weight": enc["pos"],
               "model.decoder.embed_tokens.weight": dec["tok_emb"],
               "model.decoder.embed_positions.weight": dec["pos_emb"],
               "classifier.weight": tree["head"]["w"].T,
               "classifier.bias": tree["head"]["b"]})
    return sd


def test_params_from_hf_state_dict_matches_jax(tree):
    """An HF-named state dict through both converters: the same tree, the
    tree it was made from; without a (1, d) head it raises."""
    sd = _hf_state_dict(tree)
    want = jws.params_from_hf_state_dict(sd, NARROW)
    got = tws.params_from_hf_state_dict(sd, NARROW)
    assert jax.tree.structure(got) == jax.tree.structure(want) == \
        jax.tree.structure(tree)
    for g, w, t in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(tree)):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, t)
    sd.pop("classifier.weight")
    with pytest.raises(KeyError, match="frame-head"):
        tws.params_from_hf_state_dict(sd, NARROW)


def test_segmenter_matches_jax(tmp_path, tree, monkeypatch):
    """The same npz through both WhisperSeg segmenters (the JAX one on
    int8 cross K/V and the narrow config): identical segments, groups
    and stats, over a 70 s clip (three windows, a padded batch)."""
    from whisperjav_tpu.modules.segmentation import whisperseg as jseg
    from whisperjav_tpu_torch.modules.segmentation import create_segmenter
    npz = str(tmp_path / "ws.npz")
    jws.save_params(npz, tree)
    monkeypatch.setattr(jws, "apply", lambda params, audio: jax.nn.sigmoid(
        _jax_int8_logits(params, np.asarray(audio))))
    audio = speech(70.0, 4)
    want = jseg.WhisperSegSegmenter(weights=npz, batch_size=2).segment(
        audio, SR)
    got = create_segmenter("whisperseg", weights=npz, batch_size=2,
                           device="cpu").segment(audio, SR)
    assert got.stats["model"] == "network" and want.stats["model"] == "jax"
    assert len(want.segments) >= 2
    assert [(s.start, s.end) for s in got.segments] == \
        [(s.start, s.end) for s in want.segments]
    assert [(g.start, g.end, len(g.segments)) for g in got.groups] == \
        [(g.start, g.end, len(g.segments)) for g in want.groups]


def test_whisper_vad_matches_jax():
    """whisper-vad over 5 s windows every 2.5 s: the port's engine
    (``decode_batch``, one SOT step) gives the JAX engine's speech
    probabilities, and the same segments."""
    from whisperjav_tpu.models.whisper.config import WhisperConfig
    from whisperjav_tpu.models.whisper.decode import DecodeOptions as JOpts
    from whisperjav_tpu.modules.segmentation.whisper_vad import (
        WhisperVadSegmenter as JVad,
    )
    from whisperjav_tpu.pipelines.engine import (
        QualityThresholds as JQ, TranscriptionEngine as JEngine,
    )
    from whisperjav_tpu_torch.models.whisper.config import (
        WhisperConfig as TConfig,
    )
    from whisperjav_tpu_torch.models.whisper.decode import (
        DecodeOptions as TOpts,
    )
    from whisperjav_tpu_torch.models.whisper.weights import params_from_jax
    from whisperjav_tpu_torch.modules.segmentation import create_segmenter
    from whisperjav_tpu_torch.pipelines.engine import (
        QualityThresholds as TQ, TranscriptionEngine as TEngine,
    )
    dims = dict(name="vad-tiny", n_mels=80, n_audio_state=64,
                n_audio_head=4, n_audio_layer=1, n_text_state=64,
                n_text_head=4, n_text_layer=1)
    params = jax.tree.map(np.asarray, jm.init_params(
        WhisperConfig(**dims), jax.random.PRNGKey(1)))
    jeng = JEngine(WhisperConfig(**dims), params,
                   options=JOpts(max_new_tokens=1, with_timestamps=False,
                                 cross_kv_int8=True),
                   thresholds=JQ(temperatures=(0.0,)), batch_size=4,
                   mesh=None, compute_dtype=jnp.float32)
    teng = TEngine(TConfig(**dims), params_from_jax(params, TConfig(**dims)),
                   options=TOpts(max_new_tokens=1, with_timestamps=False,
                                 cross_kv_int8=True),
                   thresholds=TQ(temperatures=(0.0,)), batch_size=4,
                   device="cpu", compute_dtype=torch.float32)
    audio = speech(12.0, 5)
    kw = dict(batch_size=4, threshold=0.5)
    jvad = JVad(engine=jeng, **kw)
    tvad = create_segmenter("whisper-vad", engine=teng, device="cpu", **kw)
    want = jvad.window_speech_probs(audio, SR)
    got = tvad.window_speech_probs(audio, SR)
    assert got.shape == want.shape == (5,)
    np.testing.assert_allclose(got, want, atol=INT8_TOL, rtol=0)
    # the thresholds on either side of the probabilities: the same
    # hysteresis decisions on both
    for threshold in (float(np.median(want)), 0.5):
        jvad.config.threshold = tvad.config.threshold = threshold
        a, b = jvad.segment(audio, SR), tvad.segment(audio, SR)
        assert [(s.start, s.end) for s in b.segments] == \
            [(s.start, s.end) for s in a.segments]
        assert b.stats == a.stats


# whisper-vad on both segmenters' own default engines (bf16 on both sides,
# cross K/V in the compute dtype): bf16 roundings in other places and
# orders move a probability by up to this much
VAD_BF16_TOL = 0.02


def test_whisper_vad_default_engines_match_jax(monkeypatch):
    """whisper-vad as ``create_segmenter("whisper-vad")`` builds it: each
    segmenter builds its own default engine (the JAX segmenter's
    options, bf16, unquantised cross K/V), ``load_model`` patched in
    both packages to the same tiny seeded weights. The speech
    probabilities agree within VAD_BF16_TOL and the segments are the
    same at thresholds in the widest gaps between the probabilities."""
    from whisperjav_tpu.models.whisper.config import WhisperConfig
    from whisperjav_tpu.modules.segmentation.whisper_vad import (
        WhisperVadSegmenter as JVad,
    )
    from whisperjav_tpu.pipelines import factory as jfactory
    from whisperjav_tpu_torch.models.whisper.config import (
        WhisperConfig as TConfig,
    )
    from whisperjav_tpu_torch.models.whisper.weights import params_from_jax
    from whisperjav_tpu_torch.modules.segmentation import create_segmenter
    from whisperjav_tpu_torch.pipelines import factory as tfactory
    dims = dict(name="vad-tiny", n_mels=80, n_audio_state=64,
                n_audio_head=4, n_audio_layer=1, n_text_state=64,
                n_text_head=4, n_text_layer=1)
    params = jax.tree.map(np.array, jm.init_params(
        WhisperConfig(**dims), jax.random.PRNGKey(1)))
    # random weights give P(no_speech) ~ 1/vocab everywhere: the
    # no-speech row of the tied embedding (never an input here), turned
    # round and scaled, puts the speech probabilities at 0.74-0.91
    params["decoder"]["tok_emb"][WhisperConfig(**dims).no_speech] *= -10.0
    asked = []

    def j_load(name, checkpoint=None):
        asked.append(("jax", name, checkpoint))
        return WhisperConfig(**dims), params

    def t_load(name, checkpoint=None, device="cuda"):
        asked.append(("torch", name, checkpoint))
        return TConfig(**dims), params_from_jax(params, TConfig(**dims))
    monkeypatch.setattr(jfactory, "load_model", j_load)
    monkeypatch.setattr(tfactory, "load_model", t_load)
    audio = speech(12.0, 5)
    kw = dict(batch_size=4)
    jvad = JVad(**kw)
    tvad = create_segmenter("whisper-vad", device="cpu", **kw)
    want = jvad.window_speech_probs(audio, SR)
    got = tvad.window_speech_probs(audio, SR)
    assert asked == [("jax", "tiny", None), ("torch", "tiny", None)]
    for vad in (jvad, tvad):
        opts = vad._engine.options
        assert (opts.max_new_tokens, opts.with_timestamps) == (1, False)
        assert not (opts.cross_kv_int8 or opts.cross_kv_int4)
    assert tvad._engine.compute_dtype == torch.bfloat16
    assert got.shape == want.shape == (5,)
    np.testing.assert_allclose(got, want, atol=VAD_BF16_TOL, rtol=0)
    # thresholds (and releases) in the widest gaps between the
    # probabilities: the same decisions on both sides
    marks = np.sort(np.concatenate([want, [0.0, 1.0]]))
    gaps = sorted(zip(np.diff(marks), marks[:-1]), reverse=True)
    for width, low in gaps[:2]:
        assert width > 2 * VAD_BF16_TOL
        jvad.config.threshold = tvad.config.threshold = low + width / 2
        jvad.config.hysteresis_offset = tvad.config.hysteresis_offset = 0.0
        a, b = jvad.segment(audio, SR), tvad.segment(audio, SR)
        assert [(s.start, s.end) for s in b.segments] == \
            [(s.start, s.end) for s in a.segments]
        assert b.stats == a.stats
