"""The parameter tree both model families share (``models/layers.py``):
a JAX tree carried across gives one state-dict name per JAX leaf, in a
fixed order (``parallel/train.py`` and ``whisper/weights.nest`` read the
names; ``step_graph`` keys a captured forward on the order)."""

import numpy as np
import pytest

import jax

from whisperjav_tpu.models.qwen import model as jqm
from whisperjav_tpu.models.whisper import model as jwm
from whisperjav_tpu.models.whisper import quant as jwq
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu_torch.models.layers import Int8Weight
from whisperjav_tpu_torch.models.qwen import model as tqm
from whisperjav_tpu_torch.models.qwen import weights as tqw
from whisperjav_tpu_torch.models.whisper import weights as twm
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)

_DIMS = dict(name="torch-layers-tiny", n_mels=80, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51865)
QWEN = "qwen3-asr-test"

# state-dict names in order, as (path, leaves) runs, for the trees below:
# a level's tensors before its child trees, Whisper's blocks last
_ENCODER = [
    ("encoder", "conv1_b conv1_w conv2_b conv2_w ln_b ln_s pos"),
    ("encoder.blocks", "b1 b2 bo bq bv ln1_b ln1_s ln2_b ln2_s w1 w2 wk wo "
                       "wq wv")]
_AUDIO = [
    ("audio", "conv2d1_b conv2d1_w conv2d2_b conv2d2_w conv2d3_b conv2d3_w "
              "conv_out_w ln_post_b ln_post_s proj1_b proj1_w proj2_b "
              "proj2_w"),
    ("audio.blocks", "b1 b2 bk bo bq bv ln1_b ln1_s ln2_b ln2_s w1 w2 wk wo "
                     "wq wv")]
ORDERS = {
    ("whisper", False): _ENCODER + [
        ("decoder", "ln_b ln_s pos_emb tok_emb"),
        ("decoder.blocks", "b1 b2 bo bq bv cbo cbq cbv cwk cwo cwq cwv ln1_b "
                           "ln1_s ln2_b ln2_s lnx_b lnx_s w1 w2 wk wo wq wv")],
    ("whisper", True): _ENCODER + [
        ("decoder", "ln_b ln_s pos_emb tok_emb lm_head_q.q lm_head_q.s"),
        ("decoder.blocks", "b1 b2 bo bqkv cbo cbq cbv cwk cwv ln1_b ln1_s "
                           "ln2_b ln2_s lnx_b lnx_s cwo.q cwo.s cwq.q cwq.s "
                           "w1.q w1.s w2.q w2.s wo.q wo.s wqkv.q wqkv.s")],
    ("qwen", False): [("", "lm_head ln_f tok_emb")] + _AUDIO + [
        ("blocks", "k_norm ln1 ln2 q_norm w_down w_gate w_up wk wo wq wv")],
    ("qwen", True): [("", "ln_f tok_emb")] + _AUDIO + [
        ("blocks", "k_norm ln1 ln2 q_norm w_down.q w_down.s w_gate.q "
                   "w_gate.s w_up.q w_up.s wo.q wo.s wqkv.q wqkv.s"),
        ("", "lm_head_q.q lm_head_q.s")],
}


def _names(runs):
    return [f"{path}.{leaf}" if path else leaf
            for path, leaves in runs for leaf in leaves.split()]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}"


def _jax_tree(family, int8):
    if family == "whisper":
        tree = jwm.init_params(WhisperConfig(**_DIMS), jax.random.PRNGKey(4))
        if int8:
            tree = jwq.quantize_decoder_weights(jwq.fuse_qkv_weights(tree))
    else:
        tree = jqm.init_params(jqm.QWEN_SIZES[QWEN], jax.random.PRNGKey(0))
        if int8:
            tree = jqm.quantize_lm_weights(jqm.fuse_lm_qkv(tree))
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("family,int8", list(ORDERS),
                         ids=[f"{f}-{'int8' if q else 'float'}"
                              for f, q in ORDERS])
def test_state_dict_names_are_the_jax_leaves(family, int8):
    tree = _jax_tree(family, int8)
    if family == "whisper":
        model = twm.params_from_jax(tree, TorchWhisperConfig(**_DIMS))
    else:
        model = tqw.params_from_jax(tree, tqm.QWEN_SIZES[QWEN])
    names = list(model.state_dict())
    assert sorted(names) == sorted(_leaves(tree))
    assert names == _names(ORDERS[family, int8])
    quantised = {n[:-2] for n in names if n.endswith((".q", ".s"))}
    assert bool(quantised) == int8
    modules = dict(model.named_modules())
    assert all(isinstance(modules[n], Int8Weight) for n in quantised)
