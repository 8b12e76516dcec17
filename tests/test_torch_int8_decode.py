"""Int8 decoder weights in the port vs the JAX package: the same codes and
scales from quantize_decoder_weights, a converted quantised tree, and
greedy, sampled and beam-2 decoding that give the same tokens (f32 on the
CPU; single steps run the fused blocks' plain versions)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.whisper import decode as jd
from whisperjav_tpu.models.whisper import model as jm
from whisperjav_tpu.models.whisper import quant as jq
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch.models import layers
from whisperjav_tpu_torch.models.whisper import decode as td
from whisperjav_tpu_torch.models.whisper import model as tm
from whisperjav_tpu_torch.models.whisper import quant as tq
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax

_DIMS = dict(name="torch-int8-tiny", n_mels=80, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51865)
CFG = WhisperConfig(**_DIMS)          # the JAX package's
TCFG = TorchWhisperConfig(**_DIMS)    # the port's
# the balanced sensitivity's decoding options, with a short budget
BALANCED = dict(max_new_tokens=16, cross_kv_int8=True,
                repetition_penalty=1.5, no_repeat_ngram_size=3,
                patience=1.2, best_of=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors, many ops: one intra-op thread avoids oversubscribing
    the CPU when the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    params = jm.init_params(CFG, jax.random.PRNGKey(4))
    params_q = jq.quantize_decoder_weights(jq.fuse_qkv_weights(params))
    tree_q = jax.tree.map(np.asarray, params_q)
    mel = np.random.default_rng(5).standard_normal(
        (3, CFG.n_mels, 3000)).astype(np.float32)
    xa = np.array(jm.encode(params, CFG, jnp.asarray(mel))[:, :448])
    return params, params_q, tree_q, xa


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _opts(**kw):
    return (jd.DecodeOptions(**BALANCED, **kw),
            td.DecodeOptions(**BALANCED, **kw))


def _same(ref, out):
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.length.numpy(), np.asarray(ref.length))
    # f32 logits differ in the last bits; tokens do not
    np.testing.assert_allclose(out.avg_logprob.numpy(),
                               np.asarray(ref.avg_logprob), atol=1e-4)
    np.testing.assert_allclose(out.no_speech_prob.numpy(),
                               np.asarray(ref.no_speech_prob), atol=1e-6)


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX package's decode with its three Pallas fused blocks on
    (interpret mode on the CPU); module flags are not part of the jit key,
    so the caches are cleared on the way in and out."""
    monkeypatch.setattr(jm, "_PALLAS_FUSE", jm._parse_fuse("all"))
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_quantize_matches_jax_bit_for_bit(setup):
    params, _, tree_q, _ = setup
    model = tq.quantize_decoder_weights(tq.fuse_qkv_weights(
        params_from_jax(jax.tree.map(np.asarray, params), TCFG)))
    got = {name: t.numpy() for name, t in model.state_dict().items()}
    want = dict(_flat(tree_q))
    assert set(got) == set(want)
    for name in ("wqkv", "wo", "cwq", "cwo", "w1", "w2"):
        assert f"decoder.blocks.{name}.q" in got
        assert f"decoder.blocks.{name}.s" in got
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


def test_params_from_jax_takes_the_quantised_tree(setup):
    _, _, tree_q, _ = setup
    model = params_from_jax(tree_q, TCFG, dtype=torch.bfloat16)
    dec = model.decoder
    assert isinstance(dec.lm_head_q, layers.Int8Weight)
    assert dec.lm_head_q.q.dtype == torch.int8
    assert dec.lm_head_q.s.dtype == torch.float32
    assert dec.blocks["w1"].q.shape == (2, 64, 256)
    assert dec.blocks["ln1_s"].dtype == torch.bfloat16
    layer = dec.blocks["wqkv"][1]
    assert isinstance(layer, layers.Int8)
    np.testing.assert_array_equal(layer.q.numpy(),
                                  tree_q["decoder"]["blocks"]["wqkv"]["q"][1])


def test_int8_dense_matches_jax(setup):
    _, _, tree_q, _ = setup
    w = tree_q["decoder"]["blocks"]["w1"]
    b = tree_q["decoder"]["blocks"]["b1"]
    x = np.random.default_rng(6).standard_normal((2, 3, 64)).astype(
        np.float32)
    ref = jm.dense(jnp.asarray(x), jax.tree.map(lambda a: a[0], w), b[0])
    out = tm.dense(torch.from_numpy(x),
                   layers.Int8(torch.from_numpy(np.array(w["q"][0])),
                               torch.from_numpy(np.array(w["s"][0]))),
                   torch.from_numpy(np.array(b[0])))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_greedy_tokens_identical(setup, jax_fused):
    _, params_q, tree_q, xa = setup
    jo, to = _opts()
    ref = jd.decode_greedy(params_q, CFG, jnp.asarray(xa), jo)
    out = td.decode_greedy(params_from_jax(tree_q, TCFG), torch.from_numpy(xa),
                           to)
    _same(ref, out)


def test_sampled_rung_identical_with_jax_noise(setup, jax_fused):
    """The port is fed the gumbel noise that decode.py's loop draws from
    its key: split once per step, gumbel from the subkey."""
    _, params_q, tree_q, xa = setup
    jo, to = _opts()
    seed, temperature = 3, 0.8
    key = jax.random.PRNGKey(seed)
    noise = []
    for _ in range(jo.max_new_tokens):
        key, sub = jax.random.split(key)
        noise.append(torch.from_numpy(np.array(jax.random.gumbel(
            sub, (xa.shape[0], CFG.n_vocab), jnp.float32))))
    ref = jd.decode_greedy(params_q, CFG, jnp.asarray(xa), jo,
                           temperature=temperature,
                           rng=jax.random.PRNGKey(seed))
    out = td.decode_greedy(params_from_jax(tree_q, TCFG), torch.from_numpy(xa),
                           to, temperature=temperature,
                           gumbel=lambda step: noise[step])
    _same(ref, out)


def test_beam2_tokens_identical(setup):
    """Beam 2 on int8 weights: the port's steps run the fused blocks
    under the fold (g = 2); the JAX package's unfused int8 path."""
    _, params_q, tree_q, xa = setup
    jo, to = _opts(beam_size=2)
    ref = jd.decode_beam(params_q, CFG, jnp.asarray(xa), jo)
    out = td.decode_beam(params_from_jax(tree_q, TCFG), torch.from_numpy(xa),
                         to)
    _same(ref, out)


@pytest.mark.parametrize("beam", [1, 2])
def test_decode_steps_take_the_fused_blocks(setup, monkeypatch, beam):
    """Prefill (q_len 3) stays unfused; every single step, greedy or beam
    (fold g = 2), calls each fused block once per layer."""
    _, _, tree_q, xa = setup
    calls = {"self": 0, "cross": 0, "mlp": 0, "steps": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name in ("self", "cross", "mlp"):
        monkeypatch.setattr(tm, f"{name}_block",
                            counting(name, getattr(tm, f"{name}_block")))
    step = td.decode_step

    def counting_step(model, tokens, *a):
        calls["steps"] += tokens.shape[1] == 1
        return step(model, tokens, *a)

    monkeypatch.setattr(td, "decode_step", counting_step)
    opts = td.DecodeOptions(max_new_tokens=4, cross_kv_int8=True,
                            beam_size=beam)
    td.decode_beam(params_from_jax(tree_q, TCFG), torch.from_numpy(xa), opts)
    assert calls["steps"] >= 1
    for name in ("self", "cross", "mlp"):
        assert calls[name] == CFG.n_text_layer * calls["steps"], name
