"""FRCRN (ClearVoice FRCRN_SE_16K) in the port against the JAX package
(FRCRN_TEST, f32 on the CPU): the complex convolution and transposed
convolution, the whitening complex batch norm from running statistics,
the frequency FSMN, the cascade's mask and the whole denoise on the same
weights; the vendor names (the torch twin of
``tests/test_frcrn_parity.py``), the JAX converter on the port's state
dict, ``params_from_jax``, ``.npz`` files both ways, ONNX files written
by the JAX ``write_onnx`` and the vendor prefixes.

Tolerance: 1e-5 absolute on outputs of magnitude ~1 (f32 on both sides,
sums in other orders); the converters and files are exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_frcrn_parity import TorchFRCRN
from whisperjav_tpu.models.enhancement import frcrn as jf
from whisperjav_tpu.utils.onnx_io import OnnxGraph, write_onnx
from whisperjav_tpu_torch.models.enhancement import frcrn as tf

TOL = 1e-5


def _stats(model, seed):
    """Nonzero running statistics so the whitening path is not the
    identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.add_(0.05 * torch.randn(buf.shape, generator=g))
            if name.endswith("running_covar"):
                buf[:, :2] *= 1 + 0.2 * torch.rand(buf[:, :2].shape,
                                                   generator=g)
                buf[:, 2] = 0.1 * torch.randn(buf[:, 2].shape, generator=g)
    return model


def _model(seed, cfg=tf.FRCRN_TEST):
    return _stats(tf.init_params(cfg, torch.Generator().manual_seed(seed)),
                  seed + 100)


def _jax(model):
    params, cfg = jf.params_from_torch_state_dict(model.state_dict())
    return params, cfg


def _geometry(cfg):
    """What a converter infers from the tensors (the STFT size is not in
    them: the published 640/320)."""
    return (cfg.encoders, cfg.decoders, cfg.lorder)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_state_dict_names_are_the_vendors():
    torch.manual_seed(11)
    twin = TorchFRCRN(jf.FRCRN_TEST)
    want = {k: tuple(v.shape) for k, v in twin.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in _model(0).state_dict().items()} \
        == want
    model = tf.FRCRN(tf.FRCRN_TEST)
    model.load_state_dict(_stats(twin, 1).state_dict())
    sr, si = _x((2, 33, 12), 2), _x((2, 33, 12), 3)
    with torch.no_grad():
        want = twin(*_t(sr, si))
    for g, w in zip(tf.forward_spec(model, *_t(sr, si)), want):
        _close(g, w)


@pytest.mark.parametrize("stage", ["encoders", "decoders"])
def test_complex_conv_matches_jax(stage):
    """The encoder's complex conv and the decoder's transposed one (torch
    conv_transpose2d, output padding (1, 0)) on the same weights."""
    model = _model(1)
    params, cfg = _jax(model)
    conv = getattr(model.unet, stage)[0].conv
    jconv = params["unet"][stage][0]["conv"]
    geom = conv.geom
    xr, xi = _x((2, geom.c_in, 17, 9), 4), _x((2, geom.c_in, 17, 9), 5)
    op = jf._conv_t2d if stage == "decoders" else jf._conv2d
    want = jf._complex_op(op, jnp.asarray(xr), jnp.asarray(xi), jconv,
                          geom.stride, geom.padding)
    got = conv(*_t(xr, xi))
    for g, w in zip(got, want):
        _close(g, w)


def test_complex_bn_and_fsmn_match_jax():
    model = _model(2)
    params, cfg = _jax(model)
    stage, jstage = model.unet.encoders[1], params["unet"]["encoders"][1]
    c = stage.conv.geom.c_out
    xr, xi = _x((2, c, 9, 7), 6), _x((2, c, 9, 7), 7)
    for g, w in zip(stage.bn(*_t(xr, xi)),
                    jf._complex_bn(jnp.asarray(xr), jnp.asarray(xi),
                                   jstage["bn"])):
        _close(g, w)
    for g, w in zip(stage.fsmn(*_t(xr, xi)),
                    jf._complex_fsmn(jnp.asarray(xr), jnp.asarray(xi),
                                     jstage["fsmn"], cfg.lorder)):
        _close(g, w)


def test_mask_and_denoise_match_jax():
    model = _model(3)
    params, cfg = _jax(model)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jf.FRCRNConfig(encoders=jf.FRCRN_TEST.encoders,
                       decoders=jf.FRCRN_TEST.decoders, lorder=3))
    sr, si = _x((2, 33, 15), 8), _x((2, 33, 15), 9)
    for g, w in zip(tf.forward_spec(model, *_t(sr, si)),
                    jf.forward_spec(params, jf.FRCRN_TEST, jnp.asarray(sr),
                                    jnp.asarray(si))):
        _close(g, w)
    audio = _x((2, 1600), 10, 0.1)
    _close(tf.denoise(model, torch.from_numpy(audio)),
           jf.denoise(params, jnp.asarray(audio), jf.FRCRN_TEST))


def test_params_from_jax_and_back():
    params = jf.init_params(jf.FRCRN_TEST, jax.random.PRNGKey(4))
    model = tf.params_from_jax(jax.tree.map(np.asarray, params),
                               tf.FRCRN_TEST)
    audio = _x((1, 1200), 11, 0.1)
    _close(tf.denoise(model, torch.from_numpy(audio)),
           jf.denoise(params, jnp.asarray(audio), jf.FRCRN_TEST))
    tree = tf.tree_from_module(model)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_converter_infers_the_jax_geometry_and_strips_prefixes():
    model = _model(5)
    for pre in ("", "model.", "module.", "frcrn."):
        sd = {f"{pre}{k}": v for k, v in model.state_dict().items()}
        got, cfg = tf.params_from_torch_state_dict(sd)
        _, jcfg = jf.params_from_torch_state_dict(sd)
        assert cfg == tf.config_from_state_dict(
            tf._strip_prefix(sd))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert _geometry(cfg) == _geometry(tf.FRCRN_TEST)
        for k, v in model.state_dict().items():
            torch.testing.assert_close(got.state_dict()[k], v, rtol=0,
                                       atol=0)


def test_npz_and_onnx_files_cross(tmp_path):
    params = jf.init_params(jf.FRCRN_TEST, jax.random.PRNGKey(6))
    jf.save_params(str(tmp_path / "jax.npz"), params, jf.FRCRN_TEST)
    model, cfg = tf.load_checkpoint(str(tmp_path / "jax.npz"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jf.FRCRN_TEST)
    audio = _x((1, 1200), 12, 0.1)
    _close(tf.denoise(model, torch.from_numpy(audio)),
           jf.denoise(params, jnp.asarray(audio), jf.FRCRN_TEST))
    tf.save_params(str(tmp_path / "torch.npz"), model)
    back, jcfg = jf.load_checkpoint(str(tmp_path / "torch.npz"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(jf.FRCRN_TEST)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    write_onnx(str(tmp_path / "frcrn.onnx"), OnnxGraph(initializers=sd))
    got, cfg = tf.load_checkpoint(str(tmp_path / "frcrn.onnx"))
    _, jcfg = jf.load_checkpoint(str(tmp_path / "frcrn.onnx"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert _geometry(cfg) == _geometry(tf.FRCRN_TEST)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)


def test_published_geometry():
    cfg = tf.FRCRN_SE_16K
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jf.FRCRN_SE_16K)
    assert (cfg.n_fft, cfg.hop, cfg.lorder, cfg.n_freqs) == (640, 320, 20,
                                                            321)
    assert [g.c_out for g in cfg.encoders] == [45, 45, 90, 90, 90, 90, 128]
    assert all(g.kernel == (5, 2) and g.stride == (2, 1)
               for g in cfg.encoders + cfg.decoders)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: compares the module on the card "
                    "with the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_denoise_on_the_card_matches_the_cpu(cuda_device):
    """The same weights on the card and the CPU, f32 on both (the module
    turns TF32 off): waveforms within 1e-4 x max |x|."""
    model = _model(7)
    audio = torch.from_numpy(_x((2, 16000), 13, 0.1))
    want = tf.denoise(model, audio)
    got = tf.denoise(model.to(cuda_device), audio.to(cuda_device)).cpu()
    assert (got - want).abs().max().item() <= 1e-4 * audio.abs().max()
