"""The port's ZipEnhancer (dual-path network and legacy U-Net) and its
backend against the JAX package's on the same weights and numpy-seeded
audio, f32 on the CPU; ``cuda``-marked cases hold the module on the card
to the same module on the CPU.

Tolerances: magnitudes within 2e-4 abs / 1e-3 rel; phases compared on
the unit circle (atan2 near its branch cut and in null bins) within
2e-3; waveforms within 1e-3 x max |x|.

Under reflect padding the first STFT frame of a chunk is symmetric about
its centre, so its imaginary parts are rounding noise, and the phase the
network takes there (+pi or -pi where the real part is negative) depends
on the order of the convolution's sums. The time-path attention spreads
that frame over the whole chunk, in the JAX package as in the port. The
audio of the waveform tests is therefore silent over the first half
window of every chunk, where both packages see exact zeros."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.enhancement import zipenhancer as jzz
from whisperjav_tpu.models.enhancement import zipnet as jzn
from whisperjav_tpu.modules.enhancement.zip_jax import ZipJaxEnhancer
from whisperjav_tpu_torch.models.enhancement import zipenhancer as tzz
from whisperjav_tpu_torch.models.enhancement import zipnet as tzn
from whisperjav_tpu_torch.modules.enhancement import create_enhancer
from whisperjav_tpu_torch.modules.enhancement.zipenhancer import ZipEnhancer

# the JAX package's configs, by the port's names
CFGS = {"test": (jzz.ZIP_TEST, tzz.ZIP_TEST), "base": (jzz.ZIP_BASE,
                                                       tzz.ZIP_BASE)}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: compares the module on the card "
                    "with the CPU")
    return torch.device("cuda")


def _pair(name, seed):
    jcfg, tcfg = CFGS[name]
    params = jzz.init_params(jax.random.PRNGKey(seed), jcfg)
    return params, jcfg, tzz.params_from_jax(jax.tree.map(np.asarray, params),
                                             tcfg)


def _audio(n, seed, scale=0.2, chunk_starts=(0,)):
    """Gaussian audio (1, n), zero over the first half window (200
    samples) after each of ``chunk_starts``."""
    x = (np.random.default_rng(seed).standard_normal((1, n)) * scale
         ).astype(np.float32)
    for s in chunk_starts:
        x[:, s:s + tzz.N_FFT // 2] = 0.0
    return x


def _spectra(frames, seed):
    rng = np.random.default_rng(seed)
    mag = (np.abs(rng.standard_normal((1, jzz.N_FREQS, frames))) * 0.5
           ).astype(np.float32)
    pha = rng.uniform(-np.pi, np.pi, (1, jzz.N_FREQS, frames)).astype(
        np.float32)
    return mag, pha


def _same_spectra(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=2e-4, rtol=1e-3)
    for fn in (np.cos, np.sin):
        np.testing.assert_allclose(fn(got[1]), fn(want[1]), atol=2e-3)


@pytest.mark.parametrize("name,frames", [("test", 21), ("test", 40),
                                         ("base", 41)])
def test_forward_matches_jax(name, frames):
    params, jcfg, model = _pair(name, 0)
    mag, pha = _spectra(frames, 1)
    want = [np.asarray(a) for a in jzz.forward(params, jcfg, jnp.asarray(mag),
                                               jnp.asarray(pha))]
    got = [a.numpy() for a in tzz.forward(model, torch.from_numpy(mag),
                                          torch.from_numpy(pha))]
    assert got[0].shape == want[0].shape == mag.shape
    _same_spectra(got, want)


@pytest.mark.parametrize("name,n", [("test", 8000), ("test", 7777),
                                    ("base", 8000)])
def test_denoise_matches_jax(name, n):
    """At most 0.5 s, so ZIP_BASE's time-path attention stays small."""
    params, jcfg, model = _pair(name, 2)
    audio = _audio(n, 3)
    want = np.asarray(jzz.denoise(params, jnp.asarray(audio), n, jcfg))
    got = tzz.denoise(model, torch.from_numpy(audio), n).numpy()
    assert got.shape == want.shape == audio.shape
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(audio).max())


def test_attention_pieces_change_nothing(monkeypatch):
    """The time path's attention split into pieces of N gives the result
    of one piece, bit for bit."""
    _, _, model = _pair("test", 4)
    mag, pha = _spectra(30, 5)
    whole = tzz.forward(model, torch.from_numpy(mag), torch.from_numpy(pha))
    monkeypatch.setattr(tzz, "ATTN_PIECE_BYTES", 1)   # one row a piece
    pieces = tzz.forward(model, torch.from_numpy(mag), torch.from_numpy(pha))
    for a, b in zip(whole, pieces):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_npz_written_by_jax_loads_in_the_port(tmp_path):
    params, jcfg, _ = _pair("test", 6)
    path = str(tmp_path / "jax.npz")
    jzz.save_params(path, params, jcfg)
    model, cfg = tzz.load_params(path)
    assert cfg == tzz.ZIP_TEST
    mag, pha = _spectra(11, 7)
    want = [np.asarray(a) for a in jzz.forward(params, jcfg, jnp.asarray(mag),
                                               jnp.asarray(pha))]
    got = [a.numpy() for a in tzz.forward(model, torch.from_numpy(mag),
                                          torch.from_numpy(pha))]
    _same_spectra(got, want)


def test_npz_written_by_the_port_loads_in_jax(tmp_path):
    model = tzz.init_params(tzz.ZIP_TEST, torch.Generator().manual_seed(8))
    path = str(tmp_path / "torch.npz")
    tzz.save_params(path, model)
    data = np.load(path)
    assert list(data["__cfg__"]) == [8, 1, 2, 2, 2, 201]
    params, cfg = jzz.load_params(path)
    assert cfg == jzz.ZIP_TEST
    # the same keys as the JAX package writes for its own tree
    jzz.save_params(str(tmp_path / "jax.npz"), params, cfg)
    assert sorted(np.load(str(tmp_path / "jax.npz")).files) == \
        sorted(data.files)
    mag, pha = _spectra(11, 9)
    want = [np.asarray(a) for a in jzz.forward(params, cfg, jnp.asarray(mag),
                                               jnp.asarray(pha))]
    got = [a.numpy() for a in tzz.forward(model, torch.from_numpy(mag),
                                          torch.from_numpy(pha))]
    _same_spectra(got, want)


def test_state_dict_names_are_the_canonical_torch_names():
    """The JAX package's torch converter takes the port's state dict as
    it is (canonical names), and a vendor prefix strips in the port."""
    _, _, model = _pair("test", 10)
    sd = model.state_dict()
    params = jzz.params_from_torch_state_dict(sd, jzz.ZIP_TEST)
    again = tzz.params_from_vendor({"generator." + k: v for k, v in
                                    sd.items()}, tzz.ZIP_TEST)
    mag, pha = _spectra(9, 11)
    want = [np.asarray(a) for a in jzz.forward(params, jzz.ZIP_TEST,
                                               jnp.asarray(mag),
                                               jnp.asarray(pha))]
    for m in (model, again):
        got = [a.numpy() for a in tzz.forward(m, torch.from_numpy(mag),
                                              torch.from_numpy(pha))]
        _same_spectra(got, want)


def test_onnx_file_written_by_jax_loads_in_the_port(tmp_path):
    """An ONNX file of the vendor names under the ``generator.`` prefix,
    written by the JAX package's ``write_onnx``: the port's
    params_from_onnx reads the same tensors the JAX one does."""
    from whisperjav_tpu.utils.onnx_io import OnnxGraph, write_onnx
    _, _, model = _pair("test", 12)
    sd = {f"generator.{k}": v.numpy() for k, v in model.state_dict().items()}
    path = str(tmp_path / "zip.onnx")
    write_onnx(path, OnnxGraph(initializers=sd))
    got = tzz.params_from_onnx(path, tzz.ZIP_TEST)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)
    params = jzz.params_from_onnx(path, jzz.ZIP_TEST)
    mag, pha = _spectra(9, 13)
    want = [np.asarray(a) for a in jzz.forward(params, jzz.ZIP_TEST,
                                               jnp.asarray(mag),
                                               jnp.asarray(pha))]
    _same_spectra([a.numpy() for a in tzz.forward(
        got, torch.from_numpy(mag), torch.from_numpy(pha))], want)


def test_init_draws_the_jax_distribution():
    """He-normal convolutions and FFN matrices, N(0, 1/d) attention, the
    constant leaves as in the JAX init."""
    model = tzz.init_params(tzz.ZIP_BASE, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert torch.all(sd["mask_decoder.beta"] == 2.0)
    assert torch.all(sd["dense_encoder.prelu1.weight"] == 0.25)
    assert torch.all(sd["blocks.0.time.ln1.weight"] == 1.0)
    assert torch.all(sd["blocks.0.time.attn.in_proj_bias"] == 0.0)
    for name, want in (("dense_encoder.dense.3.conv.weight",
                        (2.0 / (256 * 9)) ** 0.5),
                       ("blocks.1.freq.fc1.weight", (2.0 / 64) ** 0.5),
                       ("blocks.1.freq.fc2.weight", (2.0 / 256) ** 0.5),
                       ("blocks.2.time.attn.in_proj_weight", 64 ** -0.5)):
        assert abs(sd[name].std().item() / want - 1) < 0.1, name


@pytest.mark.parametrize("n,width", [(4000, 16), (4100, 16), (4000, 48)])
def test_zipnet_denoise_matches_jax(n, width):
    """4000 samples give 41 frames, 4100 give 42: odd and even frame
    counts through the dilated transposed convolutions."""
    params = jzn.init_params(jax.random.PRNGKey(n), width=width)
    net = tzn.params_from_jax(jax.tree.map(np.asarray, params))
    assert tzn.param_count(net) == jzn.param_count(params)
    audio = _audio(n, 12)
    want = np.asarray(jzn.denoise(params, jnp.asarray(audio), n))
    got = tzn.denoise(net, torch.from_numpy(audio), n).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(audio).max())


@pytest.mark.parametrize("f,t", [(5, 4), (6, 7), (51, 9)])
def test_zipnet_transposed_conv_is_jax_conv_transpose(f, t):
    """The SAME-padded, unflipped transposed convolution on odd and even
    sizes: the output is (2F, T)."""
    rng = np.random.default_rng(f * t)
    x = rng.standard_normal((2, 3, f, t)).astype(np.float32)
    w = rng.standard_normal((4, 3, 5, 3)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jzn._convT2d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b)))
    got = tzn._convT2d(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (2, 4, 2 * f, t)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_zipnet_npz_round_trip(tmp_path):
    params = jzn.init_params(jax.random.PRNGKey(1), width=8)
    path = str(tmp_path / "unet.npz")
    jzn.save_params(path, params)
    net = tzn.load_params(path)
    path2 = str(tmp_path / "unet2.npz")
    tzn.save_params(path2, net)
    back = jzn.load_params(path2)
    assert set(back) == set(params)
    for k in params:
        np.testing.assert_array_equal(np.asarray(back[k]),
                                      np.asarray(params[k]))


@pytest.mark.parametrize("tree", ["dual-path", "unet"])
def test_backend_matches_zip_jax(tmp_path, tree):
    """0.5 s chunks with a 0.1 s crossfade over 1.3 s of audio (three
    chunks, the last zero-padded)."""
    path = str(tmp_path / "w.npz")
    if tree == "dual-path":
        jzz.save_params(path, jzz.init_params(jax.random.PRNGKey(13),
                                              jzz.ZIP_TEST), jzz.ZIP_TEST)
    else:
        jzn.save_params(path, jzn.init_params(jax.random.PRNGKey(13),
                                              width=8))
    kw = dict(weights=path, chunk_s=0.5, crossfade_s=0.1)
    # chunks start every 0.4 s
    audio = _audio(20800, 14, scale=0.1,
                   chunk_starts=(0, 6400, 12800, 19200))[0]
    want = ZipJaxEnhancer(**kw).enhance(audio, 16000)
    enh = create_enhancer("zipenhancer", device="cpu", **kw)
    assert isinstance(enh, ZipEnhancer)
    assert enh._legacy == (tree == "unet")
    got = enh.enhance(audio, 16000)
    assert got.success and want.success
    assert got.stats == want.stats == {"chunks": 4}
    assert got.audio.shape == audio.shape
    np.testing.assert_allclose(got.audio, want.audio,
                               atol=1e-3 * np.abs(audio).max())


def test_backend_without_weights_passes_audio_through():
    audio = _audio(1600, 15)[0]
    res = create_enhancer("zip").enhance(audio, 16000)
    assert not res.success
    assert res.stats == {"reason": "no weights loaded"}
    assert res.audio is audio


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", [("test", 160000), ("base", 16000)])
def test_denoise_on_the_card_matches_the_cpu(cuda_device, name, n):
    """The same weights on the card and on the CPU, f32 on both (the
    module turns TF32 off itself): waveforms within 1e-3 x max |x|."""
    model = tzz.init_params(CFGS[name][1], torch.Generator().manual_seed(16))
    audio = torch.from_numpy(_audio(n, 17))
    want = tzz.denoise(model, audio, n)
    got = tzz.denoise(model.to(cuda_device), audio.to(cuda_device), n).cpu()
    assert torch.isfinite(got).all()
    tol = 1e-3 * audio.abs().max().item()
    assert (got - want).abs().max().item() <= tol
