"""The port's checkpoints against the JAX package's: each reads the
other's npz format (tiny config, exact leaves)."""

import json
import sys

import numpy as np
import pytest

import jax

from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.models.whisper.model import init_params
from whisperjav_tpu.utils import checkpoint as jck
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper.weights import (
    params_from_jax, params_to_jax,
)
from whisperjav_tpu_torch.utils import checkpoint as tck

_DIMS = dict(name="ckpt-tiny", n_audio_state=64, n_audio_head=4,
             n_audio_layer=2, n_text_state=64, n_text_head=4,
             n_text_layer=2, n_audio_ctx=50)
TINY = WhisperConfig(**_DIMS)


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(lambda x: np.asarray(x).copy(),
                        init_params(TINY, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def other():
    """A template with the same structure and other values."""
    return init_params(TINY, jax.random.PRNGKey(99))


def _assert_same(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_port_checkpoint_loads_in_jax(tmp_path, tree, other):
    """Written from the port's model (params_to_jax), read by the JAX
    package's load_checkpoint."""
    model = params_from_jax(tree, TorchWhisperConfig(**_DIMS))
    path = tck.save_checkpoint(tmp_path / "ck", params_to_jax(model),
                               metadata={"model": "ckpt-tiny", "step": 7})
    meta = jck.checkpoint_metadata(path)
    assert meta["backend"] == "npz"
    assert meta["model"] == "ckpt-tiny" and meta["step"] == 7
    assert "saved" in meta
    _assert_same(jck.load_checkpoint(path, other), tree)


def test_jax_npz_fallback_loads_in_port(tmp_path, monkeypatch, tree, other):
    """The JAX package's fallback (orbax away) read by the port, with and
    without a template."""
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    path = jck.save_checkpoint(tmp_path / "ck", tree, metadata={"step": 3})
    assert tck.checkpoint_metadata(path)["backend"] == "npz"
    _assert_same(tck.load_checkpoint(path, jax.tree.map(np.asarray, other)),
                 tree)
    loose = tck.load_checkpoint(path)
    _assert_same(loose, tree)
    assert jax.tree.structure(loose) == jax.tree.structure(tree)
    model = params_from_jax(loose, TorchWhisperConfig(**_DIMS))
    _assert_same(params_to_jax(model), tree)


def test_port_round_trip_takes_tensors(tmp_path, tree):
    model = params_from_jax(tree, TorchWhisperConfig(**_DIMS))
    tensors = {"encoder": {"pos": model.encoder.pos},
               "decoder": {"tok_emb": model.decoder.tok_emb}}
    path = tck.save_checkpoint(tmp_path / "ck", tensors)
    back = tck.load_checkpoint(path)
    np.testing.assert_array_equal(back["encoder"]["pos"],
                                  tree["encoder"]["pos"])
    np.testing.assert_array_equal(back["decoder"]["tok_emb"],
                                  tree["decoder"]["tok_emb"])


def test_orbax_checkpoint_raises(tmp_path):
    (tmp_path / "params").mkdir()
    (tmp_path / "metadata.json").write_text(json.dumps({"backend": "orbax"}))
    with pytest.raises(ValueError, match="orbax"):
        tck.load_checkpoint(tmp_path)


@pytest.mark.parametrize("edit,error", [
    (lambda t: t["decoder"].pop("tok_emb"), KeyError),
    (lambda t: t["encoder"].__setitem__("pos", np.zeros((3, 64))),
     ValueError),
], ids=["missing-leaf", "wrong-shape"])
def test_template_mismatch_raises(tmp_path, tree, edit, error):
    stored = jax.tree.map(lambda x: x, tree)
    edit(stored)
    path = tck.save_checkpoint(tmp_path / "ck", stored)
    with pytest.raises(error):
        tck.load_checkpoint(path, tree)
