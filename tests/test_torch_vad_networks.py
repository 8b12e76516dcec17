"""The port's small VAD networks against the JAX package's: Silero v5/v6
(``models/vad/silero.py``), the silero-class GRU model (``silero_like``)
and TEN (``ten``) give probabilities within 1e-5 of the JAX ``apply`` on
the same weights (f32 on the CPU, sums in other orders), their ``.npz``
files load in either package, the segmenters built on them give the same
segments and groups, the silero scene detector the same scenes, and TEN's
``params_from_onnx`` binds the vendor layouts the JAX tests synthesise."""

import numpy as np
import pytest
import torch

import jax

from whisperjav_tpu.models.vad import silero as j_silero
from whisperjav_tpu.models.vad import silero_like as j_like
from whisperjav_tpu.models.vad import ten as j_ten
from whisperjav_tpu_torch.models.vad import silero as t_silero
from whisperjav_tpu_torch.models.vad import silero_like as t_like
from whisperjav_tpu_torch.models.vad import ten as t_ten

SR = 16000
TOL_P = 1e-5          # probabilities, f32 on both sides
NETS = {"silero": (j_silero, t_silero, 512),
        "silero_like": (j_like, t_like, 640),
        "ten": (j_ten, t_ten, 256)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bursts(seconds: float, seed: int) -> np.ndarray:
    """Speech-like bursts between silences, made from ``seed``."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    env = np.zeros(n)
    pos = 0
    while pos < n:
        speech = int(rng.uniform(0.5, 2.5) * SR)
        env[pos:pos + speech] = 1.0
        pos += speech + int(rng.uniform(0.3, 1.2) * SR)
    x = 0.3 * np.sin(2 * np.pi * 180 * t) * (1 + 0.5 * np.sin(8 * t)) * env
    return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _jax_tree(name, seed=0):
    jmod = NETS[name][0]
    return jax.tree.map(np.asarray, jmod.init_params(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("name", sorted(NETS))
@pytest.mark.parametrize("frames", [1, 97])
def test_probabilities_match_jax(name, frames):
    jmod, tmod, hop = NETS[name]
    tree = _jax_tree(name)
    audio = np.stack([bursts(frames * hop / SR + 1, 1)[:frames * hop],
                      bursts(frames * hop / SR + 1, 2)[:frames * hop]])
    want = np.asarray(jmod.apply(tree, audio))
    got = tmod.probs(tmod.params_from_jax(tree), torch.from_numpy(audio))
    assert got.shape == want.shape == (2, frames)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_P, rtol=0)


@pytest.mark.parametrize("name", sorted(NETS))
def test_recurrent_layer_in_pieces(monkeypatch, name):
    """Long clips go through the recurrent layer in pieces with the state
    carried across (cuDNN refuses an hour at once): pieces of 7 steps give
    the one-call probabilities."""
    from whisperjav_tpu_torch.models.vad import _flat
    _, tmod, hop = NETS[name]
    model = tmod.params_from_jax(_jax_tree(name, seed=2))
    x = torch.from_numpy(bursts(60 * hop / SR + 1, 3)[None, :60 * hop])
    whole = tmod.probs(model, x)
    monkeypatch.setattr(_flat, "RNN_PIECE", 7)
    np.testing.assert_allclose(tmod.probs(model, x).numpy(), whole.numpy(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", sorted(NETS))
def test_npz_round_trip_both_ways(tmp_path, name):
    jmod, tmod, _ = NETS[name]
    tree = _jax_tree(name, seed=4)
    jmod.save_params(str(tmp_path / "j.npz"), tree)
    model = tmod.load_params(str(tmp_path / "j.npz"))
    got = model.tree()
    assert sorted(got) == sorted(tree)
    for k in tree:
        np.testing.assert_array_equal(got[k], tree[k], err_msg=k)
    tmod.save_params(str(tmp_path / "t.npz"), model)
    back = jmod.load_params(str(tmp_path / "t.npz"))
    for k in tree:
        np.testing.assert_array_equal(np.asarray(back[k]), tree[k],
                                      err_msg=k)


@pytest.mark.parametrize("name", sorted(NETS))
def test_port_init_has_the_jax_layout(name):
    jmod, tmod, _ = NETS[name]
    want = _jax_tree(name)
    got = tmod.init_params(torch.Generator().manual_seed(0)).tree()
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(v.dtype == np.float32 for v in got.values())


def test_silero_state_dict_names():
    """The published JIT export's names (``_model.``-prefixed and not,
    reparam or plain convs, decoder.2 or decoder.1 head) map to the tree
    as in the JAX package."""
    tree = _jax_tree("silero", seed=5)
    sd = {"_model.stft.forward_basis_buffer": tree["stft_basis"][:, 0],
          "_model.decoder.rnn.weight_ih": tree["lstm_wi"],
          "_model.decoder.rnn.weight_hh": tree["lstm_wh"],
          "_model.decoder.rnn.bias_ih": tree["lstm_bi"],
          "_model.decoder.rnn.bias_hh": tree["lstm_bh"],
          "decoder.decoder.2.weight": tree["head_w"],
          "decoder.decoder.2.bias": tree["head_b"]}
    for i in range(4):
        kind = "reparam_conv." if i % 2 else ""
        sd[f"_model.encoder.{i}.{kind}weight"] = torch.tensor(
            tree[f"enc{i}_w"])
        sd[f"_model.encoder.{i}.{kind}bias"] = tree[f"enc{i}_b"]
    want = j_silero.params_from_torch_state_dict(sd)
    got = t_silero.params_from_torch_state_dict(sd)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    with pytest.raises(KeyError):
        t_silero.params_from_torch_state_dict({})


def _segments(res):
    return ([(s.start, s.end) for s in res.segments],
            [(g.start, g.end, len(g.segments)) for g in res.groups])


@pytest.mark.parametrize("backend,name", [("silero", "silero"),
                                          ("silero", "silero_like"),
                                          ("ten", "ten")])
def test_segmenters_match_jax(tmp_path, backend, name):
    """The same npz through each package's segmenter: identical segments
    and groups (the hysteresis and post-chains see probabilities within
    1e-5 of each other), network path taken on both sides."""
    from whisperjav_tpu.modules.segmentation import (
        create_segmenter as j_create,
    )
    from whisperjav_tpu_torch.modules.segmentation import (
        create_segmenter as t_create,
    )
    jmod, _, _ = NETS[name]
    tree = _jax_tree(name, seed=6)
    # a head bias that puts the seeded network's frames on both sides of
    # the thresholds, so segments exist
    head = "head_b" if name == "silero" else "out_b"
    audio = bursts(40.0, 7)
    probe_p = np.asarray(jmod.apply(tree, audio[None, :len(audio) // 640
                                                * 640]))
    logit = np.log(probe_p / (1 - probe_p))
    tree[head] = (tree[head] - np.median(logit)).astype(np.float32)
    npz = str(tmp_path / f"{name}.npz")
    jmod.save_params(npz, tree)
    want = j_create(backend, weights=npz).segment(audio, SR)
    got = t_create(backend, weights=npz, device="cpu").segment(audio, SR)
    assert want.stats["model"] == "jax" and got.stats["model"] == "network"
    assert len(want.segments) >= 2
    assert _segments(got) == _segments(want)


def test_silero_scene_matches_jax(tmp_path):
    """Energy chapters refined by silero VAD groups: the same scenes with
    the calibrated probability and with a network."""
    from whisperjav_tpu.modules.scene_detection import (
        create_scene_detector as j_create,
    )
    from whisperjav_tpu_torch.modules.scene_detection import (
        create_scene_detector as t_create,
    )
    npz = str(tmp_path / "silero.npz")
    j_silero.save_params(npz, _jax_tree("silero", seed=8))
    audio = bursts(150.0, 9)
    for kw in ({}, {"vad_weights": npz}):
        want = j_create("silero", **kw).detect(audio, SR)
        got = t_create("silero", device="cpu", **kw).detect(audio, SR)
        assert got.stats == want.stats and want.stats["scenes"] >= 2
        assert [(s.start, s.end) for s in got.scenes] == \
            [(s.start, s.end) for s in want.scenes]


def test_network_backends_raise_rather_than_fall_back(tmp_path):
    """A VAD backend that fails to build raises; the port never turns a
    requested network into the energy probability."""
    from whisperjav_tpu_torch.modules.segmentation import create_segmenter
    missing = str(tmp_path / "missing.npz")
    for backend in ("silero", "ten", "whisperseg"):
        with pytest.raises(FileNotFoundError):
            create_segmenter(backend, weights=missing, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        create_segmenter("silero", weights=missing, device="cuda")


# ---------------------------------------------------------------------------
# TEN params_from_onnx on the vendor layouts of tests/test_onnx_io.py
# ---------------------------------------------------------------------------

def _to_iofc(w, h):
    i, f, g, o = [np.asarray(w)[j * h:(j + 1) * h] for j in range(4)]
    return np.concatenate([i, o, f, g], axis=0)


def _ten_files(tmp_path, tree):
    """The torch-export layout and the native-ops layout (LSTM W/R/B in
    iofc order, two Convs, a Gemm head), written by the port's writer."""
    from whisperjav_tpu_torch.utils.onnx_io import (
        OnnxGraph, OnnxNode, write_onnx,
    )
    names = {"conv1.weight": "conv1_w", "conv1.bias": "conv1_b",
             "conv2.weight": "conv2_w", "conv2.bias": "conv2_b",
             "lstm.weight_ih_l0": "lstm_wi", "lstm.weight_hh_l0": "lstm_wh",
             "lstm.bias_ih_l0": "lstm_bi", "lstm.bias_hh_l0": "lstm_bh",
             "out.weight": "out_w", "out.bias": "out_b"}
    torch_path = str(tmp_path / "ten_torch.onnx")
    write_onnx(torch_path, OnnxGraph(initializers={
        onnx: tree[ours] for onnx, ours in names.items()}))
    h = j_ten.HIDDEN
    init = {"c1w": tree["conv1_w"], "c1b": tree["conv1_b"],
            "c2w": tree["conv2_w"], "c2b": tree["conv2_b"],
            "W": _to_iofc(tree["lstm_wi"], h)[None],
            "R": _to_iofc(tree["lstm_wh"], h)[None],
            "B": np.concatenate([_to_iofc(tree["lstm_bi"], h),
                                 _to_iofc(tree["lstm_bh"], h)])[None],
            "ow": tree["out_w"], "ob": tree["out_b"]}
    nodes = [
        OnnxNode(op_type="Conv", inputs=["feat", "c1w", "c1b"],
                 outputs=["h1"], attrs={"kernel_shape": [3], "pads": [1, 1]}),
        OnnxNode(op_type="Relu", inputs=["h1"], outputs=["h1r"]),
        OnnxNode(op_type="Conv", inputs=["h1r", "c2w", "c2b"],
                 outputs=["h2"], attrs={"kernel_shape": [3], "pads": [1, 1]}),
        OnnxNode(op_type="Relu", inputs=["h2"], outputs=["h2r"]),
        OnnxNode(op_type="LSTM", inputs=["h2r", "W", "R", "B"],
                 outputs=["hs", "hn", "cn"], attrs={"hidden_size": h}),
        OnnxNode(op_type="Gemm", inputs=["hs", "ow", "ob"],
                 outputs=["logit"], attrs={"transB": 1}),
        OnnxNode(op_type="Sigmoid", inputs=["logit"], outputs=["prob"]),
    ]
    native_path = str(tmp_path / "ten_native.onnx")
    write_onnx(native_path, OnnxGraph(nodes=nodes, initializers=init,
                                      inputs=["feat"], outputs=["prob"]))
    return torch_path, native_path


def test_ten_params_from_onnx(tmp_path):
    tree = _jax_tree("ten", seed=3)
    audio = np.random.default_rng(0).standard_normal(
        (1, j_ten.HOP * 20)).astype(np.float32) * 0.1
    want_p = np.asarray(j_ten.apply(tree, audio))
    for path in _ten_files(tmp_path, tree):
        got = t_ten.params_from_onnx(path)
        ref = j_ten.params_from_onnx(path)
        assert sorted(got) == sorted(tree)
        for k in tree:
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]),
                                          err_msg=k)
        p = t_ten.probs(t_ten.params_from_jax(got), torch.from_numpy(audio))
        np.testing.assert_allclose(p.numpy(), want_p, atol=TOL_P, rtol=0)


def test_ten_onnx_rejects_foreign_graph(tmp_path):
    from whisperjav_tpu_torch.utils.onnx_io import OnnxGraph, write_onnx
    path = str(tmp_path / "foreign.onnx")
    write_onnx(path, OnnxGraph(initializers={"w": np.zeros(3, np.float32)}))
    with pytest.raises(ValueError, match="neither torch-export names"):
        t_ten.params_from_onnx(path)
