"""The port's Qwen3-ASR model vs the JAX package on the CPU, at the test
widths (``qwen3-asr-test``: LM d=256, 4 layers, 8 query / 4 KV heads,
vocab 4096; AuT d=256, 4 layers), from the same weights (the JAX init,
carried across with ``params_from_jax``) and seeded numpy inputs.

Tolerances: f32 on both sides, sums in other orders -> activations and
logits within 1e-4 relative to their largest magnitude; int8 codes and
scales bit for bit; tokens and lengths identical, ``avg_logprob`` within
1e-4."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.qwen import model as jm
from whisperjav_tpu_torch.models.qwen import model as tm
from whisperjav_tpu_torch.models.qwen import weights as tw
from whisperjav_tpu_torch.models import layers
from whisperjav_tpu_torch.models.layers import Int8Weight

CFG = jm.QWEN_SIZES["qwen3-asr-test"]
TCFG = tm.QWEN_SIZES["qwen3-asr-test"]
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    return jm.init_params(CFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def int8_params(params):
    """The eager JAX quantiser's tree (fused q/k/v, int8 LM and head)."""
    return jm.quantize_lm_weights(jm.fuse_lm_qkv(params))


def _close(out, ref, rel=REL):
    ref = np.asarray(ref)
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _mel(b=2, t=800, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, CFG.n_mels, t)).astype(np.float32)


def test_configs_mirror_jax():
    assert ([f.name for f in dataclasses.fields(tm.QwenASRConfig)]
            == [f.name for f in dataclasses.fields(jm.QwenASRConfig)])
    for name, cfg in jm.QWEN_SIZES.items():
        assert dataclasses.asdict(tm.QWEN_SIZES[name]) \
            == dataclasses.asdict(cfg)
        t = tm.QWEN_SIZES[name]
        assert (t.head_dim, t.chunk_tokens, t.window_tokens,
                t.mel_multiple) == (cfg.head_dim, cfg.chunk_tokens,
                                    cfg.window_tokens, cfg.mel_multiple)
    assert tm.token_budget(TCFG, 10.0) == jm.token_budget(CFG, 10.0)
    assert tm.token_budget(TCFG, 1.0) == jm.token_budget(CFG, 1.0)
    assert tm.mel_frames_for(TCFG, 401) == jm.mel_frames_for(CFG, 401)


def test_primitives(params):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    _close(tm.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
           jm.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    pos = np.arange(7, 12)
    cos, sin = tm.rope_angles(torch.from_numpy(pos), 32, 1_000_000.0)
    _close(tm.rope(torch.from_numpy(x), cos, sin),
           jm.rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0))
    b = rng.standard_normal(32).astype(np.float32)
    _close(layers.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(b)),
           jm.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(b)))


def test_encode_audio(params):
    model = tw.params_from_jax(_np(params), TCFG)
    mel = _mel()
    ref = jm.encode_audio(params, CFG, jnp.asarray(mel))
    with torch.inference_mode():
        out = tm.encode_audio(model, torch.from_numpy(mel))
    assert out.shape == (2, TCFG.audio_tokens_for(800), TCFG.d_model)
    _close(out, ref)


def test_fuse_and_quantize_bit_for_bit(params, int8_params):
    model = tm.quantize_lm_weights(tm.fuse_lm_qkv(
        tw.params_from_jax(_np(params), TCFG)))
    fused = jm.fuse_lm_qkv(params)["blocks"]["wqkv"]
    ref = int8_params
    for name in ("wqkv", "wo", "w_gate", "w_up", "w_down"):
        w = model.blocks[name]
        assert isinstance(w, Int8Weight)
        np.testing.assert_array_equal(w.q.numpy(),
                                      np.asarray(ref["blocks"][name]["q"]))
        np.testing.assert_array_equal(w.s.numpy(),
                                      np.asarray(ref["blocks"][name]["s"]))
    assert "wq" not in model.blocks and "lm_head" not in model
    np.testing.assert_array_equal(model.lm_head_q.q.numpy(),
                                  np.asarray(ref["lm_head_q"]["q"]))
    np.testing.assert_array_equal(model.lm_head_q.s.numpy(),
                                  np.asarray(ref["lm_head_q"]["s"]))
    # the fused float weight, before quantisation
    f = tm.fuse_lm_qkv(tw.params_from_jax(_np(params), TCFG))
    np.testing.assert_array_equal(f.blocks["wqkv"].detach().numpy(),
                                  np.asarray(fused))
    # both are idempotent
    assert tm.quantize_lm_weights(model) is model
    assert isinstance(model.blocks["wqkv"], Int8Weight)


def test_params_from_jax_int8_tree(int8_params):
    model = tw.params_from_jax(_np(int8_params), TCFG)
    assert isinstance(model.blocks["wqkv"], Int8Weight)
    assert model.blocks["wqkv"].q.dtype == torch.int8
    sd = model.state_dict()
    assert "blocks.wqkv.q" in sd and "lm_head_q.s" in sd
    assert "audio.blocks.wq" in sd


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f32", "int8"])
def test_lm_step_prefill_and_column(params, int8_params, quantized):
    """A 6-token prefill into a 10-slot cache, then two single steps
    (column form): logits and caches."""
    tree = int8_params if quantized else params
    model = tw.params_from_jax(_np(tree), TCFG)
    rng = np.random.default_rng(4)
    emb = (rng.standard_normal((2, 8, CFG.d_model)) * 0.5).astype(np.float32)
    jcache = jm.LMCache.zeros(CFG, 2, 10, jnp.float32)
    tcache = tm.LMCache.zeros(TCFG, 2, 10, torch.float32, "cpu")
    steps = ((0, 6), (6, 7), (7, 8))
    with torch.inference_mode():
        for a, b in steps:
            ref, jcache = jm.lm_step(tree, CFG, jnp.asarray(emb[:, a:b]), a,
                                     jcache)
            out, tcache = tm.lm_step(model, torch.from_numpy(emb[:, a:b]), a,
                                     tcache)
            _close(out, ref)
            _close(tcache.k, jcache.k)
            _close(tcache.v, jcache.v)


def _generate_both(tree, mel, **kw):
    model = tw.params_from_jax(_np(tree), TCFG)
    gumbel = kw.pop("gumbel", None)
    ref = jm.generate(tree, CFG, jnp.asarray(mel), **kw)
    if "rng" in kw:
        kw.pop("rng")
    ctx = kw.pop("ctx_ids", None)
    out = tm.generate(model, torch.from_numpy(mel), gumbel=gumbel,
                      ctx_ids=None if ctx is None else torch.from_numpy(
                          np.asarray(ctx)), **kw)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.length.numpy(), np.asarray(ref.length))
    np.testing.assert_allclose(out.avg_logprob.numpy(),
                               np.asarray(ref.avg_logprob), atol=1e-4)
    return out


def test_generate_greedy_repetition_penalty(int8_params):
    out = _generate_both(int8_params, _mel(3, 400, 5), max_new=16,
                         audio_len=50, repetition_penalty=1.1)
    assert out.tokens.shape == (3, 16)


def test_generate_greedy_with_context(int8_params):
    ctx = np.asarray([[7, 99, 1234]], np.int32)
    _generate_both(int8_params, _mel(2, 400, 6), max_new=12, audio_len=40,
                   repetition_penalty=1.1, ctx_ids=ctx)


def test_generate_sampled_with_jax_noise(int8_params):
    """The port is fed the gumbel noise JAX's loop draws from its key:
    split once per step, gumbel from the subkey."""
    mel = _mel(2, 400, 7)
    seed, temperature, max_new = 3, 0.8, 14
    key = jax.random.PRNGKey(seed)
    noise = []
    for _ in range(max_new):
        key, sub = jax.random.split(key)
        noise.append(torch.from_numpy(np.array(jax.random.gumbel(
            sub, (2, CFG.vocab_size), jnp.float32))))
    _generate_both(int8_params, mel, max_new=max_new, audio_len=50,
                   repetition_penalty=1.1, temperature=temperature,
                   rng=jax.random.PRNGKey(seed),
                   gumbel=lambda step: noise[step])


def test_generate_finished_rows_emit_eos(int8_params):
    """A row that emits EOS stops counting: with EOS's logit raised in
    the lm head, every row finishes at the first step, and the loop ends
    at its first check."""
    tree = dict(int8_params)
    head = dict(tree["lm_head_q"])
    s = np.asarray(head["s"]).copy()
    s[..., CFG.eos_id] *= 1e4
    head["s"] = jnp.asarray(s)
    tree["lm_head_q"] = head
    out = _generate_both(tree, _mel(2, 400, 8), max_new=20, audio_len=50,
                         repetition_penalty=1.1)
    assert (out.tokens.numpy() == CFG.eos_id).all()
    assert (out.length.numpy() == 0).all()


def test_sampling_needs_a_noise_source(int8_params):
    model = tw.params_from_jax(_np(int8_params), TCFG)
    with pytest.raises(ValueError):
        tm.generate(model, torch.from_numpy(_mel(1, 400)), max_new=4,
                    audio_len=50, temperature=0.5)


def test_init_params_shapes_and_scales():
    model = tw.init_params(TCFG, torch.Generator().manual_seed(0))
    ref = jax.eval_shape(lambda: jm.init_params(CFG, jax.random.PRNGKey(0)))
    flat_ref = {jax.tree_util.keystr(k): v.shape for k, v in
                jax.tree_util.tree_flatten_with_path(ref)[0]}
    sd = model.state_dict()
    names = {"".join(f"['{p}']" for p in k.split(".")): tuple(v.shape)
             for k, v in sd.items()}
    assert names == {k: tuple(v) for k, v in flat_ref.items()}
    w = model.blocks["wq"]
    assert abs(float(w.std()) - TCFG.d_model ** -0.5) < 0.01
    assert float(model.audio["conv2d1_w"].std()) == pytest.approx(0.1,
                                                                  rel=0.3)
    assert (model.blocks["ln1"] == 1).all()
    assert (model.audio["blocks"]["bq"] == 0).all()


def test_params_from_jax_bf16_tree():
    tree = jm.init_params(CFG, jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    model = tw.params_from_jax(_np(tree), TCFG)
    assert model.blocks["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.blocks["wq"].float().numpy(),
        np.asarray(tree["blocks"]["wq"].astype(jnp.float32)))
    np.testing.assert_array_equal(
        model.audio["conv2d1_w"].float().numpy(),
        np.asarray(tree["audio"]["conv2d1_w"].astype(jnp.float32)))


def _hf_state_dict(rng, cfg, tied):
    """A random Hugging Face Qwen3-ASR thinker state dict at ``cfg``'s
    widths (torch (out, in) layouts), as numpy arrays."""
    d, hd, da = cfg.d_model, cfg.head_dim, cfg.d_audio
    qd, kvd, h = cfg.n_heads * hd, cfg.n_kv_heads * hd, \
        cfg.audio_downsample_hidden
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd = {"thinker.model.embed_tokens.weight": f(cfg.vocab_size, d),
          "thinker.model.norm.weight": f(d)}
    if not tied:
        sd["thinker.lm_head.weight"] = f(cfg.vocab_size, d)
    for i in range(cfg.n_layers):
        p = f"thinker.model.layers.{i}."
        sd.update({p + "input_layernorm.weight": f(d),
                   p + "self_attn.q_proj.weight": f(qd, d),
                   p + "self_attn.k_proj.weight": f(kvd, d),
                   p + "self_attn.v_proj.weight": f(kvd, d),
                   p + "self_attn.o_proj.weight": f(d, qd),
                   p + "self_attn.q_norm.weight": f(hd),
                   p + "self_attn.k_norm.weight": f(hd),
                   p + "post_attention_layernorm.weight": f(d),
                   p + "mlp.gate_proj.weight": f(cfg.d_ff, d),
                   p + "mlp.up_proj.weight": f(cfg.d_ff, d),
                   p + "mlp.down_proj.weight": f(d, cfg.d_ff)})
    a = "thinker.audio_tower."
    fo = 16   # 128 mels after three stride-2 convolutions
    sd.update({a + "conv2d1.weight": f(h, 1, 3, 3), a + "conv2d1.bias": f(h),
               a + "conv2d2.weight": f(h, h, 3, 3), a + "conv2d2.bias": f(h),
               a + "conv2d3.weight": f(h, h, 3, 3), a + "conv2d3.bias": f(h),
               a + "conv_out.weight": f(da, h * fo),
               a + "ln_post.weight": f(da), a + "ln_post.bias": f(da),
               a + "proj1.weight": f(da, da), a + "proj1.bias": f(da),
               a + "proj2.weight": f(d, da), a + "proj2.bias": f(d)})
    for i in range(cfg.audio_layers):
        p = f"{a}layers.{i}."
        for n in ("self_attn_layer_norm", "final_layer_norm"):
            sd.update({p + n + ".weight": f(da), p + n + ".bias": f(da)})
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.update({p + f"self_attn.{n}.weight": f(da, da),
                       p + f"self_attn.{n}.bias": f(da)})
        sd.update({p + "fc1.weight": f(cfg.audio_ffn, da),
                   p + "fc1.bias": f(cfg.audio_ffn),
                   p + "fc2.weight": f(da, cfg.audio_ffn),
                   p + "fc2.bias": f(da)})
    return sd


@pytest.mark.parametrize("tied", [False, True], ids=["lm-head", "tied"])
def test_convert_hf_state_dict_matches_jax(tied):
    from types import SimpleNamespace
    from whisperjav_tpu.models.qwen import convert as jconv
    from whisperjav_tpu_torch.models.qwen import convert as tconv
    sd = _hf_state_dict(np.random.default_rng(9), CFG, tied)
    got = tconv.params_from_hf_state_dict(sd, TCFG)
    want = jconv.params_from_hf_state_dict(sd, CFG)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in flat_got] == [k for k, _ in flat_want]
    for (_, g), (_, w) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, w)
    model = tw.params_from_jax(got, TCFG)
    assert model.blocks["wq"].shape == (CFG.n_layers, CFG.d_model,
                                        CFG.n_heads * CFG.head_dim)
    text = SimpleNamespace(vocab_size=151936, hidden_size=2048,
                           num_hidden_layers=28, num_attention_heads=16,
                           num_key_value_heads=8, intermediate_size=6144,
                           head_dim=128, rope_theta=1e6, rms_norm_eps=1e-6,
                           eos_token_id=151645, bos_token_id=151643)
    audio = SimpleNamespace(num_mel_bins=128, d_model=1280,
                            encoder_layers=32, encoder_attention_heads=20,
                            encoder_ffn_dim=5120, downsample_hidden_size=480,
                            n_window=50, n_window_infer=400)
    hf = SimpleNamespace(text_config=text, audio_config=audio,
                         name_or_path="local/qwen3-asr")
    assert dataclasses.asdict(tconv.config_from_hf(hf)) \
        == dataclasses.asdict(jconv.config_from_hf(hf))


def test_load_pretrained_without_transformers_raises(monkeypatch):
    import sys
    from whisperjav_tpu_torch.models.qwen import convert as tconv
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        tconv.load_pretrained("/nonexistent/qwen3-asr")


def test_tokenizer_fallback_matches_jax():
    from whisperjav_tpu.models.qwen.tokenizer import QwenTokenizer as JTok
    from whisperjav_tpu_torch.models.qwen.tokenizer import (
        QwenTokenizer, find_tokenizer_files,
    )
    t, j = QwenTokenizer(), JTok()
    assert not t.is_real
    ids = [5, 151_645, 77, 1234, 3]
    assert t.decode(ids) == j.decode(ids)
    assert t.encode("字幕です。") == j.encode("字幕です。")
    assert find_tokenizer_files(None) is None
