"""MossFormer2_SE_48K in the port against the JAX package (MF2_TEST, f32
on the CPU): the hamming STFT and its WOLA inverse, the kaldi-style
fbank, the FLASH and gated-FSMN blocks, the mask net (with and without
group padding) and the whole enhance on the same weights; the vendor
names (the torch twin of ``tests/test_mossformer2_parity.py``), the JAX
converter on the port's state dict under ``model.mossformer.``,
``params_from_jax``, ``.npz`` files both ways and torch files.

Tolerance: 1e-5 absolute on outputs of magnitude ~1, 5e-4 on the log-mel
features (f32 on both sides, sums in other orders; the log of small
energies magnifies them); the converters and files are exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_mossformer2_parity import MossFormer_MaskNet
from whisperjav_tpu.models.enhancement import mossformer2 as jm
from whisperjav_tpu_torch.models.enhancement import mossformer2 as tm

TOL = 1e-5
CFG = tm.MF2_TEST


def _model(seed):
    """Seeded weights with the norms and scales moved off 1 and 0, so the
    tests see every parameter."""
    model = tm.init_params(CFG, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def _jax(model, prefix="model.mossformer."):
    params, cfg = jm.params_from_torch_state_dict(
        {f"{prefix}{k}": v for k, v in model.state_dict().items()}, CFG)
    return params


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def test_state_dict_names_are_the_vendors():
    torch.manual_seed(0)
    twin = MossFormer_MaskNet(jm.MF2_TEST).eval()
    want = {k: tuple(v.shape) for k, v in twin.state_dict().items()
            if k != "pos_enc.inv_freq"}      # a buffer the port computes
    assert {k: tuple(v.shape) for k, v in _model(0).state_dict().items()} \
        == want
    # the geometry the tensors give (group size and STFT hop are not in
    # them), as the JAX converter infers it
    sd = {f"model.mossformer.{k}": v for k, v in twin.state_dict().items()}
    _, cfg = tm.params_from_torch_state_dict(sd)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jm.params_from_torch_state_dict(sd)[1])
    model, cfg = tm.params_from_torch_state_dict(sd, CFG)
    assert cfg == CFG
    feats = _x((2, CFG.n_mels, 20), 1)
    with torch.no_grad():
        want = twin(torch.from_numpy(feats)).numpy()
    got = tm.forward_mask(model, torch.from_numpy(feats).transpose(1, 2))
    _close(got.transpose(1, 2), want)


@pytest.mark.parametrize("n", [1000, 997])
def test_stft_and_istft_match_jax(n):
    audio = _x((2, n), 2, 0.3)
    for g, w in zip(tm.stft_hamming(torch.from_numpy(audio), 64, 16),
                    jm.stft_hamming(jnp.asarray(audio), 64, 16)):
        _close(g, w)
    r, i = _x((2, 33, 60), 3), _x((2, 33, 60), 4)
    _close(tm.istft_hamming(*map(torch.from_numpy, (r, i)), 900, 64, 16),
           jm.istft_hamming(jnp.asarray(r), jnp.asarray(i), 900, 64, 16))
    rt = tm.istft_hamming(*tm.stft_hamming(torch.from_numpy(audio), 64, 16),
                          n, 64, 16)
    _close(rt, audio, 1e-4)


def test_fbank_matches_jax():
    """Log-mel energies: an energy ~1e-4 of its frame's largest carries
    the rFFT's f32 rounding (pocketfft against XLA's) as ~1e-4 in the
    log; held within 5e-4 of features up to ~10."""
    for cfg in (CFG, dataclasses.replace(CFG, n_mels=40, n_fft=256, hop=64)):
        audio = _x((2, 4000), 5, 0.3)
        _close(tm.fbank(torch.from_numpy(audio), cfg),
               jm.fbank(jnp.asarray(audio), cfg), 5e-4)


def test_blocks_match_jax():
    model = _model(1)
    params = _jax(model)
    blocks = model.mdl.intra_mdl.mossformerM
    x = _x((2, 19, CFG.d_model), 6)
    layer0 = jax.tree.map(lambda a: a[0], params["blocks"])
    with torch.no_grad():
        _close(blocks.layers[0](torch.from_numpy(x)),
               jm._flash_attention(jnp.asarray(x), layer0["flash"], CFG))
        _close(blocks.fsmn[0](torch.from_numpy(x)),
               jm._gated_fsmn_block(jnp.asarray(x), layer0["fsmn_block"]))


@pytest.mark.parametrize("s", [CFG.group_size * 2, CFG.group_size + 3, 5])
def test_mask_matches_jax(s):
    """Sequences on and off a group multiple (the padded path)."""
    model = _model(2)
    params = _jax(model)
    feats = _x((2, s, CFG.n_mels), 7)
    _close(tm.forward_mask(model, torch.from_numpy(feats)),
           jm.forward_mask(params, CFG, jnp.asarray(feats)))


def test_enhance_matches_jax():
    model = _model(3)
    params = _jax(model)
    audio = _x((2, 1600), 8, 0.3)
    _close(tm.enhance(model, torch.from_numpy(audio), 1600),
           jm.enhance(params, CFG, jnp.asarray(audio), 1600))


def test_params_from_jax_and_back():
    params = jm.init_params(CFG, jax.random.PRNGKey(4))
    model = tm.params_from_jax(jax.tree.map(np.asarray, params), CFG)
    audio = _x((1, 1200), 9, 0.3)
    _close(tm.enhance(model, torch.from_numpy(audio), 1200),
           jm.enhance(params, CFG, jnp.asarray(audio), 1200))
    tree = tm.tree_from_module(model)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_npz_and_torch_files_cross(tmp_path):
    params = jm.init_params(CFG, jax.random.PRNGKey(5))
    jm.save_params(str(tmp_path / "jax.npz"), params, CFG)
    model, cfg = tm.load_checkpoint(str(tmp_path / "jax.npz"))
    assert cfg == CFG
    audio = _x((1, 1200), 10, 0.3)
    _close(tm.enhance(model, torch.from_numpy(audio), 1200),
           jm.enhance(params, CFG, jnp.asarray(audio), 1200))
    tm.save_params(str(tmp_path / "torch.npz"), model)
    back, jcfg = jm.load_checkpoint(str(tmp_path / "torch.npz"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(CFG)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    torch.save({"state_dict": {f"model.mossformer.{k}": v for k, v in
                               model.state_dict().items()}},
               tmp_path / "mf2.pt")
    got, cfg = tm.load_checkpoint(str(tmp_path / "mf2.pt"))
    _, jcfg = jm.load_checkpoint(str(tmp_path / "mf2.pt"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)


def test_converter_rejects_an_unknown_dict():
    with pytest.raises(ValueError):
        tm.params_from_torch_state_dict({"foo.bar": np.zeros(3)})


def test_published_geometry():
    cfg = tm.MOSSFORMER2_SE_48K
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jm.MOSSFORMER2_SE_48K)
    assert (cfg.n_mels, cfg.d_model, cfg.n_freqs, cfg.num_blocks,
            cfg.group_size, cfg.qk_dim, cfg.rope_dim) == (180, 512, 961, 24,
                                                          256, 128, 32)
    assert (cfg.n_fft, cfg.hop, cfg.sample_rate) == (1920, 384, 48_000)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: compares the module on the card "
                    "with the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_enhance_on_the_card_matches_the_cpu(cuda_device):
    """The same weights on the card and the CPU, f32 on both (the module
    turns TF32 off; the rFFT is cuFFT's): waveforms within 1e-4 x max
    |x|."""
    model = _model(6)
    audio = torch.from_numpy(_x((2, 8000), 11, 0.3))
    want = tm.enhance(model, audio, 8000)
    got = tm.enhance(model.to(cuda_device), audio.to(cuda_device),
                     8000).cpu()
    assert (got - want).abs().max().item() <= 1e-4 * audio.abs().max()
