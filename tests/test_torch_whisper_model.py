"""The port's Whisper model vs the JAX package on the same weights (tiny
config, real vocab, f32 on the CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.whisper import model as jm
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper import model as tm
from whisperjav_tpu_torch.models.whisper.quant import fuse_qkv_weights
from whisperjav_tpu_torch.models.whisper.weights import (
    init_params, params_from_jax,
)

_DIMS = dict(name="torch-tiny", n_mels=128, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51866)
CFG = WhisperConfig(**_DIMS)          # the JAX package's
TCFG = TorchWhisperConfig(**_DIMS)    # the port's


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors, many ops: one intra-op thread avoids oversubscribing
    the CPU when the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    params = jm.init_params(CFG, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, params)
    return params, tree


@pytest.fixture(scope="module")
def encoded(weights):
    params, _ = weights
    mel = np.random.default_rng(0).standard_normal(
        (2, CFG.n_mels, 3000)).astype(np.float32)
    return np.array(jm.encode(params, CFG, jnp.asarray(mel))), mel


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_params_from_jax_round_trip(weights):
    _, tree = weights
    model = params_from_jax(tree, TCFG)
    got = {name: t.numpy() for name, t in model.state_dict().items()}
    want = dict(_flat(tree))
    assert set(got) == set(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


def test_init_params_has_the_jax_tree_layout(weights):
    _, tree = weights
    model = init_params(TCFG, torch.Generator().manual_seed(0))
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert shapes == {n: a.shape for n, a in _flat(tree)}


def test_encode_matches_jax(weights, encoded):
    _, tree = weights
    ref, mel = encoded
    out = tm.encode(params_from_jax(tree, TCFG),
                    torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (2, 1500, 64)
    # f32 through two convs and two blocks; sums in different orders
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_int8_cross_kv_matches_jax(weights, encoded):
    params, tree = weights
    xa, _ = encoded
    ref = jm.precompute_cross_kv(params, CFG, jnp.asarray(xa), int8=True)
    out = tm.precompute_cross_kv(params_from_jax(tree, TCFG),
                                 torch.from_numpy(xa), int8=True)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6)
    for name in ("k", "v"):
        a = getattr(out, name).numpy().astype(np.int32)
        b = np.asarray(getattr(ref, name)).astype(np.int32)
        assert a.shape == b.shape == (2, 2, 4, 16, 1500)
        # the projections differ in the last float bits, so a value at an
        # exact rounding tie may land one step apart; nothing more
        assert np.mean(a == b) >= 0.999
        assert np.abs(a - b).max() <= 1


def test_int4_nibbles_match_jax():
    """Packing, unpacking and each nibble: the JAX functions' codes,
    exactly, over every +-7 level at both positions of a byte."""
    levels = np.arange(-7, 8, dtype=np.float32)
    x = np.stack(np.meshgrid(levels, levels), -1).reshape(3, 5, 30)
    packed = tm.pack_nibbles(torch.from_numpy(x))
    ref = np.asarray(jm._pack_nibbles(jnp.asarray(x)))
    assert packed.dtype == torch.uint8 and packed.shape == (3, 5, 15)
    np.testing.assert_array_equal(packed.numpy(), ref)
    for ours, theirs in ((tm.unpack_nibbles, jm._unpack_nibbles),
                         (tm.nib_lo, jm._nib_lo), (tm.nib_hi, jm._nib_hi)):
        got = ours(packed)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(theirs(jnp.asarray(ref))))
    np.testing.assert_array_equal(tm.unpack_nibbles(packed).numpy(), x)
    with pytest.raises(ValueError, match="even T"):
        tm.pack_nibbles(torch.zeros(2, 3))


def test_int4_cross_kv_matches_jax(weights, encoded):
    params, tree = weights
    xa, _ = encoded
    ref = jm.precompute_cross_kv(params, CFG, jnp.asarray(xa), int4=True)
    out = tm.precompute_cross_kv(params_from_jax(tree, TCFG),
                                 torch.from_numpy(xa), int4=True)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6)
    for name in ("k", "v"):
        got = getattr(out, name)
        assert got.dtype == torch.uint8 and got.shape == (2, 2, 4, 16, 750)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(ref, name)))


@pytest.mark.parametrize("g", [1, 2])
def test_int4_cross_attention_matches_jax(weights, encoded, g):
    """The even/odd attention over packed K/V, beams folded (g query rows
    a K/V row), on the JAX codes and scales: f32 within 1e-5 of the
    output's largest magnitude (the sums run in different orders)."""
    params, _ = weights
    xa, _ = encoded
    cross = jm.precompute_cross_kv(params, CFG, jnp.asarray(xa[:, :448]),
                                   int4=True)
    q = np.random.default_rng(5).standard_normal(
        (2 * g, 1, 4, 16)).astype(np.float32)
    ref = np.asarray(jm.cross_attention(
        jnp.asarray(q), cross.k[1], cross.v[1], cross.k_scale[1],
        cross.v_scale[1]))
    out = tm.cross_attention(
        torch.from_numpy(q),
        tm.CrossKV(*(torch.from_numpy(np.array(x)) for x in cross)), 1)
    assert out.shape == ref.shape == (2 * g, 1, 4, 16)
    np.testing.assert_allclose(out.numpy(), ref,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("fused", [False, True])
def test_decode_step_matches_jax(weights, encoded, fused):
    """Prefill of the SOT sequence, then single steps in column mode, on
    the same int8 cross-K/V (the JAX one) for both."""
    params, tree = weights
    xa, _ = encoded
    xa = jnp.asarray(xa[:, :448])
    cross_j = jm.precompute_cross_kv(params, CFG, xa, int8=True)
    cross_t = tm.CrossKV(*(torch.from_numpy(np.array(x)) for x in cross_j))
    model = params_from_jax(tree, TCFG)
    if fused:
        fuse_qkv_weights(model)
    t_max = 12
    cache_j = jm.KVCache.zeros(CFG, 2, t_max, jnp.float32)
    cache_t = tm.KVCache.zeros(TCFG, 2, t_max, torch.float32, "cpu")
    sot = np.array([[CFG.sot, CFG.sot + 8, CFG.transcribe]] * 2)
    steps = [(sot, 0)] + [
        (np.array([[tok], [tok + 7]]), 3 + i)
        for i, tok in enumerate([50400, 1000, 2000, 51000, 300])]
    for tokens, pos in steps:
        lj, cache_j = jm.decode_step(params, CFG, jnp.asarray(tokens), pos,
                                     cache_j, cross_j)
        lt, cache_t = tm.decode_step(model, torch.from_numpy(tokens), pos,
                                     cache_t, cross_t)
        assert lt.dtype == torch.float32 and lt.shape == lj.shape
        # f32; the int8 cross-K/V is shared, so only sum order differs
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(cache_t.k.numpy(), np.asarray(cache_j.k),
                                   atol=1e-4, rtol=1e-4)
