"""BS-RoFormer in the port against the JAX package (BSR_TEST and a stereo
two-stem config, f32 on the CPU): the layers, the mask forward, the
separation and vocal isolation on the same weights; the vendor names
(the lucidrains twin of ``tests/test_bs_roformer_parity.py``), the JAX
converter on the port's state dict, ``params_from_jax``, ``.npz`` files
both ways, ONNX files written by the JAX ``write_onnx``, torch files with
the ``model.`` prefix, and ``config_from_state_dict``.

Tolerance: 1e-5 absolute on outputs of magnitude ~1 (f32 on both sides,
sums in other orders); the converters and files are exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_bs_roformer_parity import BSRoformerTwin
from whisperjav_tpu.models.enhancement import bs_roformer as jb
from whisperjav_tpu.utils.onnx_io import OnnxGraph, write_onnx
from whisperjav_tpu_torch.models.enhancement import bs_roformer as tb

TOL = 1e-5
STEREO = dict(dim=16, depth=1, stereo=True, num_stems=2, heads=2, dim_head=8,
              ff_mult=2, freqs_per_bands=(2, 2, 4, 9), n_fft=32, hop=8,
              mask_estimator_depth=1, mlp_expansion_factor=2,
              sample_rate=16_000)
CFGS = {"test": (jb.BSR_TEST, tb.BSR_TEST),
        "stereo": (jb.BSRoformerConfig(**STEREO),
                   tb.BSRoformerConfig(**STEREO))}


def _model(name, seed):
    return tb.init_params(CFGS[name][1], torch.Generator().manual_seed(seed))


def _audio(shape, seed, scale=0.4):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def twin():
    torch.manual_seed(11)
    return BSRoformerTwin(jb.BSR_TEST).eval()


def test_state_dict_names_are_the_vendors(twin):
    """The port's module holds exactly the twin's tensors, by name and
    shape, so a lucidrains state dict loads with load_state_dict."""
    want = {k: tuple(v.shape) for k, v in twin.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in _model("test", 0)
           .state_dict().items()}
    assert got == want
    model = tb.BSRoformer(tb.BSR_TEST)
    model.load_state_dict(twin.state_dict())
    audio = _audio((2, 1, 320), 3)
    with torch.no_grad():
        want = twin(torch.from_numpy(audio))
    _close(tb.separate(model, torch.from_numpy(audio)), want)


def test_layers_match_jax():
    model = _model("test", 1)
    attn = model.layers[0][0].layers[0][0]
    x = _audio((3, 7, 16), 2, 1.0)
    freqs = model.time_rotary_embed.freqs
    _close(attn.norm(torch.from_numpy(x)),
           jb._rms_norm(x, attn.norm.gamma.numpy()))
    q = _audio((3, 2, 7, 8), 3, 1.0)
    _close(tb._apply_rotary(torch.from_numpy(q), freqs),
           jb._apply_rotary(q, freqs.numpy()))
    p = {"norm_gamma": attn.norm.gamma.numpy(),
         "qkv_w": attn.to_qkv.weight.numpy().T,
         "gates_w": attn.to_gates.weight.numpy().T,
         "gates_b": attn.to_gates.bias.numpy(),
         "out_w": attn.to_out[0].weight.numpy().T}
    with torch.no_grad():
        _close(attn(torch.from_numpy(x), freqs),
               jb._attention(x, p, 2, 8, freqs.numpy()))


@pytest.mark.parametrize("name,seed", [("test", 2), ("stereo", 3)])
def test_forward_and_separate_match_jax(name, seed):
    """The JAX converter on the port's state dict (the vendor names) and
    the JAX forward on the same weights: masks and stems agree."""
    jcfg, tcfg = CFGS[name]
    model = _model(name, seed)
    params = jb.params_from_torch_state_dict(model.state_dict(), jcfg)
    spec = _audio((2, tcfg.n_freqs * tcfg.channels, 9, 2), seed + 10, 1.0)
    _close(tb.forward_spec(model, torch.from_numpy(spec)),
           jb.forward_spec(params, jcfg, jnp.asarray(spec)))
    audio = _audio((2, tcfg.channels, 400), seed + 20)
    _close(tb.separate(model, torch.from_numpy(audio)),
           jb.separate(params, jcfg, jnp.asarray(audio)))


@pytest.mark.parametrize("name", ["test", "stereo"])
def test_isolate_vocals_matches_jax(name):
    """Mono in: duplicated to the model's channels, the first stem
    averaged back."""
    jcfg, tcfg = CFGS[name]
    model = _model(name, 4)
    params = jb.params_from_torch_state_dict(model.state_dict(), jcfg)
    audio = _audio((2, 480), 5)
    out = tb.isolate_vocals(model, torch.from_numpy(audio))
    assert out.shape == (2, 480)
    _close(out, jb.isolate_vocals(params, jcfg, jnp.asarray(audio)))


def test_params_from_jax_and_back():
    jcfg, tcfg = CFGS["stereo"]
    params = jb.init_params(jcfg, jax.random.PRNGKey(6))
    model = tb.params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    audio = _audio((1, 2, 320), 7)
    _close(tb.separate(model, torch.from_numpy(audio)),
           jb.separate(params, jcfg, jnp.asarray(audio)))
    tree = tb.tree_from_module(model)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_npz_files_cross_both_ways(tmp_path):
    jcfg, tcfg = CFGS["test"]
    params = jb.init_params(jcfg, jax.random.PRNGKey(8))
    jb.save_params(str(tmp_path / "jax.npz"), params, jcfg)
    model, cfg = tb.load_checkpoint(str(tmp_path / "jax.npz"))
    assert cfg == tcfg
    audio = _audio((1, 1, 320), 9)
    _close(tb.separate(model, torch.from_numpy(audio)),
           jb.separate(params, jcfg, jnp.asarray(audio)))
    tb.save_params(str(tmp_path / "torch.npz"), model)
    back, jcfg2 = jb.load_checkpoint(str(tmp_path / "torch.npz"))
    assert dataclasses.asdict(jcfg2) == dataclasses.asdict(jcfg)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_onnx_and_torch_files_load(tmp_path):
    """An ONNX file of the vendor names written by the JAX write_onnx,
    and a torch file under ``model.``, load through load_checkpoint with
    the config inferred, as the JAX loader infers it."""
    model = _model("stereo", 10)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    write_onnx(str(tmp_path / "bsr.onnx"), OnnxGraph(initializers=sd))
    torch.save({"state_dict": {f"model.{k}": v for k, v in
                               model.state_dict().items()}},
               tmp_path / "bsr.ckpt")
    for name in ("bsr.onnx", "bsr.ckpt"):
        got, cfg = tb.load_checkpoint(str(tmp_path / name))
        _, jcfg = jb.load_checkpoint(str(tmp_path / name))
        assert _inferred(cfg) == _inferred(jcfg)
        # the STFT hop and the rate are not in the tensors: the defaults
        assert cfg == dataclasses.replace(CFGS["stereo"][1], hop=441,
                                          sample_rate=44_100)
        for k, v in model.state_dict().items():
            torch.testing.assert_close(got.state_dict()[k], v, rtol=0,
                                       atol=0)


def _inferred(cfg):
    """The fields both loaders infer (the JAX one keeps the default mask
    head width and reads the tensors' shapes; the port infers it)."""
    d = dataclasses.asdict(cfg)
    d.pop("mlp_expansion_factor")
    return d


def test_config_from_state_dict_matches_jax(twin):
    for name, sd in (("test", twin.state_dict()),
                     ("stereo", _model("stereo", 12).state_dict())):
        got = tb.config_from_state_dict(sd)
        assert _inferred(got) == _inferred(jb.config_from_state_dict(sd))
        assert got.mlp_expansion_factor == \
            CFGS[name][1].mlp_expansion_factor


def test_viperx_geometry():
    """The default is the viperx vocal model: 62 bands over 1025 bins,
    stereo, ~4.2e8 parameters (3.4e8 in the mask heads)."""
    cfg = tb.BSRoformerConfig()
    assert (cfg.dim, cfg.depth, cfg.heads, cfg.dim_head) == (512, 12, 8, 64)
    assert len(cfg.freqs_per_bands) == 62
    assert sum(cfg.freqs_per_bands) == cfg.n_freqs == 1025
    assert (cfg.n_fft, cfg.hop, cfg.sample_rate) == (2048, 441, 44_100)
    with torch.device("meta"):
        model = tb.BSRoformer(cfg)
    heads = sum(p.numel() for p in model.mask_estimators.parameters())
    assert 4.1e8 < sum(p.numel() for p in model.parameters()) < 4.3e8
    assert 3.3e8 < heads < 3.5e8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: compares the module on the card "
                    "with the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["test", "stereo"])
def test_separate_on_the_card_matches_the_cpu(cuda_device, name):
    """The same weights on the card and the CPU, f32 on both (the module
    turns TF32 off): stems within 1e-4 x max |x|."""
    tcfg = CFGS[name][1]
    model = _model(name, 13)
    audio = torch.from_numpy(_audio((2, tcfg.channels, 4000), 14))
    want = tb.separate(model, audio)
    got = tb.separate(model.to(cuda_device), audio.to(cuda_device)).cpu()
    assert (got - want).abs().max().item() <= 1e-4 * audio.abs().max()
