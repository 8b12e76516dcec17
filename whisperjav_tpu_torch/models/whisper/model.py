"""Whisper encoder-decoder in PyTorch.

Counterpart of ``whisperjav_tpu/models/whisper/model.py`` on the path a
flagless run takes. Parameters keep the JAX tree's names and stacked
layouts: per-layer weights stack on a leading layer axis and matrices are
(in, out), so :mod:`weights` maps a JAX tree one to one. The public
layouts are the JAX package's: attention operands (B, T, H, hd), the
self-attention cache ``KVCache`` (L, B, T, d) and the int8 cross-attention
``CrossKV`` (L, B, H, hd, T).

Int8 decoder weights (``quant.quantize_decoder_weights``) are the JAX
tree's ``{"q": int8, "s": f32}`` leaves, held as :class:`Int8Weight`;
:func:`dense` takes them, and the lm head is ``decoder.lm_head_q``.

Kernels sit behind :func:`encoder_attention` (every encoder layer),
:func:`cross_attention` (every decoder layer of a step on bf16 weights,
and of every prefill) and, on int8 weights at q_len == 1, the three
fused blocks of ``ops/cuda/fused_decode.py`` (every decoder layer of
every step, beam rungs included); all run their plain PyTorch versions
on CPU tensors.

Fine-tuning differentiates :func:`forward` (the JAX package's
``forward`` and ``decode_train``): plain attention, unquantised cross
K/V and no cache, in f32 on a :meth:`Whisper.trainable` model, with
hooks for tensor parallelism (``parallel/train.py``). It reaches no
kernel, as the JAX train step reaches no Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from whisperjav_tpu_torch.models.whisper.config import WhisperConfig
from whisperjav_tpu_torch.ops.cuda.decode_attention import (
    decode_cross_attention, decode_cross_attention_bf16,
)
from whisperjav_tpu_torch.ops.cuda.encoder_attention import (
    attention, encoder_attention,
)
from whisperjav_tpu_torch.ops.cuda.fused_decode import (
    cross_block, mlp_block, self_block,
)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32, result in x's dtype."""
    out = F.layer_norm(x.float(), (x.shape[-1],), scale.float(),
                       bias.float(), eps)
    return out.to(x.dtype)


class Int8(NamedTuple):
    """One int8 weight: codes (in, out) and f32 scales (1, out)."""
    q: torch.Tensor
    s: torch.Tensor


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """x (..., in) @ w (in, out) [+ b], rounded once to x's dtype.

    ``w`` is a tensor, whose product the bias joins in the f32
    accumulation, or an :class:`Int8`: then the product of x and the int8
    codes is taken in f32 (a bf16 product would round first), times the
    f32 scale, plus the bias, as the JAX package's ``dense``.
    """
    if isinstance(w, torch.Tensor):
        x2 = x.reshape(-1, x.shape[-1])
        out = torch.mm(x2, w) if b is None else torch.addmm(b, x2, w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    out = torch.matmul(x.float(), w.q.float()) * w.s.float()
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head)


def sinusoid_positions(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions."""
    if channels % 2:
        raise ValueError(f"channels must be even, got {channels}")
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _param(x) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(x), requires_grad=False)


class Int8Weight(nn.Module):
    """A ``{"q": int8 (..., in, out), "s": f32 (..., 1, out)}`` leaf of the
    JAX tree: symmetric int8 codes with per-output-channel scales, as
    parameters ``q`` and ``s`` (state-dict names ``<leaf>.q``,
    ``<leaf>.s``). ``w[i]`` is layer i of a stacked one, as an
    :class:`Int8` of views. Casting the module casts ``s``: quantise
    after the cast to the compute dtype, as the engine does."""

    def __init__(self, q, s):
        super().__init__()
        self.q = _param(q)
        self.s = _param(s)

    def __getitem__(self, i: int) -> Int8:
        return Int8(self.q[i], self.s[i])


def _leaf(value):
    if isinstance(value, dict):
        return Int8Weight(value["q"], value["s"])
    return _param(value)


class _Part(nn.Module):
    """One of encoder/decoder: named tensors plus a ``blocks`` dict of
    layer-stacked tensors, as in the JAX parameter tree; int8 leaves are
    :class:`Int8Weight` submodules."""

    def __init__(self, tree: Dict[str, object]):
        super().__init__()
        for name, value in tree.items():
            if name != "blocks":
                setattr(self, name, _leaf(value))
        self.blocks = nn.ParameterDict(
            {name: _leaf(value) for name, value in tree["blocks"].items()})


class Whisper(nn.Module):
    """Whisper weights: ``encoder`` and ``decoder`` parts of named tensors.

    Built from a tree of tensors with the JAX package's keys and layouts
    (see :func:`whisperjav_tpu_torch.models.whisper.weights.params_from_jax`
    and ``init_params``).
    """

    def __init__(self, config: WhisperConfig, tree: Dict[str, Dict]):
        super().__init__()
        self.config = config
        self.encoder = _Part(tree["encoder"])
        self.decoder = _Part(tree["decoder"])

    def trainable(self) -> "Whisper":
        """This model, in place, in f32 with every parameter requiring
        gradients: the form :func:`forward` trains
        (``parallel/train.py``). Int8 weights do not train."""
        if any(isinstance(m, Int8Weight) for m in self.modules()):
            raise ValueError("int8 weights do not train: load the float "
                             "weights")
        self.float()
        self.requires_grad_(True)
        return self


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _encoder_block(x: torch.Tensor, p: nn.ParameterDict, i: int,
                   n_head: int) -> torch.Tensor:
    h = layer_norm(x, p["ln1_s"][i], p["ln1_b"][i])
    q = _split_heads(dense(h, p["wq"][i], p["bq"][i]), n_head)
    k = _split_heads(dense(h, p["wk"][i]), n_head)
    v = _split_heads(dense(h, p["wv"][i], p["bv"][i]), n_head)
    a = encoder_attention(q, k, v)
    b_, t, _, _ = a.shape
    x = x + dense(a.reshape(b_, t, -1), p["wo"][i], p["bo"][i])
    h = layer_norm(x, p["ln2_s"][i], p["ln2_b"][i])
    return x + dense(F.gelu(dense(h, p["w1"][i], p["b1"][i])),
                     p["w2"][i], p["b2"][i])


def _encoder_stem(enc: _Part, mel: torch.Tensor) -> torch.Tensor:
    """The two convolutions and the positions: mel (B, n_mels, 3000) ->
    (B, 1500, d)."""
    x = F.gelu(F.conv1d(mel, enc.conv1_w, enc.conv1_b, padding=1))
    x = F.gelu(F.conv1d(x, enc.conv2_w, enc.conv2_b, stride=2, padding=1))
    return (x.transpose(1, 2) + enc.pos).contiguous()       # (B, T, d)


def encode(model: Whisper, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, n_mels, 3000) -> encoder states (B, 1500, d)."""
    enc = model.encoder
    x = _encoder_stem(enc, mel)
    for i in range(enc.blocks["wq"].shape[0]):
        x = _encoder_block(x, enc.blocks, i, model.config.n_audio_head)
    return layer_norm(x, enc.ln_s, enc.ln_b)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Self-attention cache, (L, B, T_max, d) each, heads merged."""
    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def zeros(config: WhisperConfig, batch: int, max_len: int, dtype,
              device) -> "KVCache":
        shape = (config.n_text_layer, batch, max_len, config.n_text_state)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


class CrossKV(NamedTuple):
    """Per-segment cross-attention K/V, (L, B, H, hd, T) int8, with
    per-(layer, batch, head) scales (L, B, H, 1, 1) f32."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor


def precompute_cross_kv(model: Whisper, xa: torch.Tensor) -> CrossKV:
    """Project encoder states once per segment and quantise them to int8
    per (layer, batch, head), rounding half to even as ``jnp.round``
    (the JAX package's ``int8=True``; the decode kernel reads int8)."""
    cfg = model.config
    blocks = model.decoder.blocks
    n_layer = blocks["cwk"].shape[0]
    b, t, _ = xa.shape
    h, hd = cfg.n_text_head, cfg.n_text_state // cfg.n_text_head
    ck = torch.empty((n_layer, b, h, hd, t), dtype=torch.int8,
                     device=xa.device)
    cv = torch.empty_like(ck)
    ks = torch.empty((n_layer, b, h, 1, 1), dtype=torch.float32,
                     device=xa.device)
    vs = torch.empty_like(ks)
    for i in range(n_layer):
        for out, scale, proj in (
                (ck, ks, dense(xa, blocks["cwk"][i])),
                (cv, vs, dense(xa, blocks["cwv"][i], blocks["cbv"][i]))):
            x = _split_heads(proj, h).permute(0, 2, 3, 1).float()  # (B,H,hd,T)
            s = x.abs().amax(dim=(2, 3), keepdim=True) / 127.0 + 1e-9
            out[i] = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
            scale[i] = s
    return CrossKV(ck, cv, ks, vs)


def cross_attention(q: torch.Tensor, cross: CrossKV,
                    layer: int) -> torch.Tensor:
    """q (B*g, Tq, H, hd) x layer ``layer`` of the int8 cross K/V
    (B, H, hd, T) -> (B*g, Tq, H, hd).

    Beam folding: when q has g times the K/V's rows (beam search: all
    beams of a row attend the same audio), the g beams fold into the
    query axis, q (B*g, Tq) -> (B, g*Tq), so one cross-K/V row serves all
    of them. The attention scale and k_scale are folded into q in f32;
    v_scale multiplies the kernel's f32 output, before the one rounding to
    q's dtype (in the kernel's epilogue for bf16).
    """
    bq, tq, h, hd = q.shape
    b = cross.k.shape[1]
    g, rem = divmod(bq, b)
    if rem:
        raise ValueError(f"query batch {bq} not a multiple of cross-KV "
                         f"batch {b}")
    scale = (hd ** -0.25) * (hd ** -0.25)
    qf = (q.reshape(b, g * tq, h, hd).float() * scale
          * cross.k_scale[layer].reshape(b, 1, h, 1)).contiguous()
    if q.dtype == torch.bfloat16:
        a = decode_cross_attention_bf16(qf, cross.k, cross.v, layer,
                                        cross.v_scale)
    else:
        a = decode_cross_attention(qf, cross.k, cross.v, layer)
        a = (a * cross.v_scale[layer].reshape(b, 1, h, 1)).to(q.dtype)
    return a.reshape(bq, tq, h, hd)


def _self_attention_column(q, k_new, v_new, cache_k, cache_v, col_bias,
                           n_head):
    """Decode-step self-attention (q_len == 1) over the cache without
    writing it: the cache slots at and after ``pos`` are masked by
    ``col_bias`` and the new key's logit is computed on its own, which is
    the same logit set and softmax as insert-then-attend."""
    b, _, d = cache_k.shape
    hd = d // n_head
    scale = hd ** -0.25
    qs = (q * scale).float()                                # (B, 1, H, hd)
    kc = (_split_heads(cache_k, n_head) * scale).float()    # (B, T, H, hd)
    kn = (_split_heads(k_new, n_head) * scale).float()      # (B, 1, H, hd)
    logits_c = torch.einsum("bqhd,bkhd->bhqk", qs, kc) + col_bias
    logit_n = torch.einsum("bqhd,bqhd->bhq", qs, kn)[..., None]
    w = torch.softmax(torch.cat([logits_c, logit_n], dim=-1), dim=-1)
    w_c = w[..., :-1].to(q.dtype)                           # (B, H, 1, T)
    w_n = w[..., -1:].to(q.dtype)                           # (B, H, 1, 1)
    vc = _split_heads(cache_v, n_head).transpose(1, 2)      # (B, H, T, hd)
    a = torch.matmul(w_c, vc).transpose(1, 2)               # (B, 1, H, hd)
    return a + w_n.transpose(1, 2) * _split_heads(v_new, n_head)


def _decoder_block(x, p, i, cross: CrossKV, cache: "KVCache", pos: int,
                   n_head: int, self_bias: torch.Tensor,
                   column_mode: bool):
    """Decoder layer ``i`` at positions [pos, pos + q_len).

    Column mode (q_len == 1) leaves the cache as it is and returns this
    layer's new K/V column for the caller to write; otherwise the new
    K/V are written into the cache in place, then attended.
    """
    b, q_len, d = x.shape
    h = layer_norm(x, p["ln1_s"][i], p["ln1_b"][i])
    if "wqkv" in p:
        qkv = dense(h, p["wqkv"][i], p["bqkv"][i])
        q_new, k_new, v_new = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    else:
        q_new = dense(h, p["wq"][i], p["bq"][i])
        k_new = dense(h, p["wk"][i])
        v_new = dense(h, p["wv"][i], p["bv"][i])
    q = _split_heads(q_new, n_head)
    if column_mode:
        a = _self_attention_column(q, k_new, v_new, cache.k[i], cache.v[i],
                                   self_bias, n_head)
    else:
        cache.k[i, :, pos:pos + q_len] = k_new
        cache.v[i, :, pos:pos + q_len] = v_new
        a = attention(q, _split_heads(cache.k[i], n_head),
                      _split_heads(cache.v[i], n_head), self_bias)
    x = x + dense(a.reshape(b, q_len, d), p["wo"][i], p["bo"][i])
    # cross-attention
    h = layer_norm(x, p["lnx_s"][i], p["lnx_b"][i])
    cq = _split_heads(dense(h, p["cwq"][i], p["cbq"][i]), n_head)
    a = cross_attention(cq, cross, i)
    x = x + dense(a.reshape(b, q_len, d), p["cwo"][i], p["cbo"][i])
    # mlp
    h = layer_norm(x, p["ln2_s"][i], p["ln2_b"][i])
    x = x + dense(F.gelu(dense(h, p["w1"][i], p["b1"][i])),
                  p["w2"][i], p["b2"][i])
    return x, k_new, v_new


# int8 decoder weights the fused blocks read (quant.quantize_decoder_weights)
_FUSED_WEIGHTS = ("wqkv", "wo", "cwq", "cwo", "w1", "w2")


def _fused_layers(x: torch.Tensor, p: nn.ParameterDict, cross: CrossKV,
                  cache: KVCache, pos: int, n_head: int) -> torch.Tensor:
    """One decode step (x (R, d)) through every decoder layer as three
    fused blocks, then one store of every layer's new K/V column at
    ``pos``. Cross K/V and scales go in the JAX kernels' flat layouts
    ((L, B, d, T) and (L, B, H): views, no copies)."""
    n_layer, b, h, hd, t = cross.k.shape
    ck = cross.k.reshape(n_layer, b, h * hd, t)
    cv = cross.v.reshape(n_layer, b, h * hd, t)
    ks = cross.k_scale.reshape(n_layer, b, h)
    vs = cross.v_scale.reshape(n_layer, b, h)
    k_cols, v_cols = [], []
    for i in range(n_layer):
        x, k_new, v_new = self_block(x, p["ln1_s"], p["ln1_b"], p["wqkv"],
                                     p["bqkv"], p["wo"], p["bo"], cache.k,
                                     cache.v, i, pos, n_head)
        x = cross_block(x, p["lnx_s"], p["lnx_b"], p["cwq"], p["cbq"],
                        p["cwo"], p["cbo"], ck, cv, ks, vs, i, n_head)
        x = mlp_block(x, p["ln2_s"], p["ln2_b"], p["w1"], p["b1"], p["w2"],
                      p["b2"], i)
        k_cols.append(k_new)
        v_cols.append(v_new)
    cache.k[:, :, pos] = torch.stack(k_cols)
    cache.v[:, :, pos] = torch.stack(v_cols)
    return x


def decode_hidden(model: Whisper, tokens: torch.Tensor, pos: int,
                  cache: KVCache, cross: CrossKV) -> torch.Tensor:
    """Decoder blocks and final LN for tokens (B, q_len) at positions
    [pos, pos + q_len), without the lm head. Writes the new K/V into
    ``cache`` in place; returns hidden states (B, q_len, d).

    On int8 decoder weights a single step (q_len == 1) runs the fused
    blocks, beam fold included (B = g x the cross-K/V rows); prefill
    keeps the unfused layers with int8 :func:`dense`, as in the JAX
    package (``model.py:605``)."""
    dec = model.decoder
    b, q_len = tokens.shape
    t_max = cache.k.shape[2]
    n_head = model.config.n_text_head
    x = dec.tok_emb[tokens] + dec.pos_emb[pos:pos + q_len]
    if q_len == 1 and all(isinstance(dec.blocks.get(n), Int8Weight)
                          for n in _FUSED_WEIGHTS):
        x = _fused_layers(x[:, 0], dec.blocks, cross, cache, pos, n_head)
        return layer_norm(x[:, None], dec.ln_s, dec.ln_b)
    column_mode = q_len == 1
    k_idx = torch.arange(t_max, device=tokens.device)
    if column_mode:
        # cache slots j < pos are visible; the new key comes separately
        visible = (k_idx < pos)[None, :]
    else:
        # key j visible to query i iff j <= pos + i
        q_idx = pos + torch.arange(q_len, device=tokens.device)
        visible = k_idx[None, :] <= q_idx[:, None]
    self_bias = torch.where(visible, 0.0, float("-inf"))[None, None]
    k_cols, v_cols = [], []
    for i in range(dec.blocks["ln1_s"].shape[0]):
        x, k_new, v_new = _decoder_block(x, dec.blocks, i, cross, cache, pos,
                                         n_head, self_bias, column_mode)
        k_cols.append(k_new)
        v_cols.append(v_new)
    if column_mode:
        cache.k[:, :, pos] = torch.stack(k_cols)[:, :, 0]
        cache.v[:, :, pos] = torch.stack(v_cols)[:, :, 0]
    return layer_norm(x, dec.ln_s, dec.ln_b)


def decode_step(model: Whisper, tokens: torch.Tensor, pos: int,
                cache: KVCache, cross: CrossKV
                ) -> Tuple[torch.Tensor, KVCache]:
    """Decoder on a chunk (prefill or one step) -> (logits (B, q_len,
    vocab) f32, cache). The lm head is the tied token embedding, or its
    int8 copy ``lm_head_q`` on int8 weights (the f32 product times the
    scale), applied in f32 so the logits keep f32 precision as in the JAX
    package."""
    x = decode_hidden(model, tokens, pos, cache, cross)
    lm = getattr(model.decoder, "lm_head_q", None)
    if lm is not None:
        return torch.matmul(x.float(), lm.q.float()) * lm.s, cache
    emb = model.decoder.tok_emb
    logits = torch.matmul(x.float(), emb.float().t())
    return logits, cache


# ---------------------------------------------------------------------------
# teacher-forced forward (fine-tuning)
# ---------------------------------------------------------------------------

class Replicated:
    """Tensor-parallel hooks of the teacher-forced forward when every
    weight is whole: each is the identity. ``parallel/train.py`` gives
    the collective ones (Megatron's f and g, and a feature all-gather)
    for weights split over ``size`` ranks.

    ``copy`` marks a replicated tensor entering split weights (backward:
    sum over ranks), ``reduce`` sums the partial outputs of a split
    contraction (backward: identity), ``gather`` concatenates split
    features on the last axis (backward: this rank's slice)."""
    rank, size = 0, 1

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, -1, hd)


def plain_cross_attention(q: torch.Tensor, ck: torch.Tensor,
                          cv: torch.Tensor) -> torch.Tensor:
    """q (B, Tq, H, hd) x unquantised cross K/V (B, H, hd, T) ->
    (B, Tq, H, hd): the JAX package's ``cross_attention`` without scales
    (``int8=False``), logits and softmax in f32."""
    hd = q.shape[-1]
    scale = (hd ** -0.25) * (hd ** -0.25)
    logits = torch.matmul((q * scale).float().transpose(1, 2), ck.float())
    weights = torch.softmax(logits, dim=-1).to(q.dtype)     # (B, H, Tq, T)
    return torch.matmul(weights, cv.transpose(2, 3)).transpose(1, 2)


def _mlp(x: torch.Tensor, p: nn.ParameterDict, i: int, tp) -> torch.Tensor:
    h = tp.copy(layer_norm(x, p["ln2_s"][i], p["ln2_b"][i]))
    out = dense(F.gelu(dense(h, p["w1"][i], p["b1"][i])), p["w2"][i])
    return x + tp.reduce(out) + p["b2"][i]


def _train_encoder_block(x, p, i, hd, tp):
    b, t, _ = x.shape
    h = tp.copy(layer_norm(x, p["ln1_s"][i], p["ln1_b"][i]))
    q = _heads(dense(h, p["wq"][i], p["bq"][i]), hd)
    k = _heads(dense(h, p["wk"][i]), hd)
    v = _heads(dense(h, p["wv"][i], p["bv"][i]), hd)
    a = attention(q, k, v).reshape(b, t, -1)
    x = x + tp.reduce(dense(a, p["wo"][i])) + p["bo"][i]
    return _mlp(x, p, i, tp)


def _train_decoder_block(x, p, i, ck, cv, causal, hd, tp):
    b, s, _ = x.shape
    h = tp.copy(layer_norm(x, p["ln1_s"][i], p["ln1_b"][i]))
    q = _heads(dense(h, p["wq"][i], p["bq"][i]), hd)
    k = _heads(dense(h, p["wk"][i]), hd)
    v = _heads(dense(h, p["wv"][i], p["bv"][i]), hd)
    a = attention(q, k, v, causal).reshape(b, s, -1)
    x = x + tp.reduce(dense(a, p["wo"][i])) + p["bo"][i]
    h = tp.copy(layer_norm(x, p["lnx_s"][i], p["lnx_b"][i]))
    cq = _heads(dense(h, p["cwq"][i], p["cbq"][i]), hd)
    a = plain_cross_attention(cq, ck, cv).reshape(b, s, -1)
    x = x + tp.reduce(dense(a, p["cwo"][i])) + p["cbo"][i]
    return _mlp(x, p, i, tp)


def decode_train(model: Whisper, tokens: torch.Tensor, xa: torch.Tensor,
                 tp=None) -> torch.Tensor:
    """Teacher-forced decoder over whole sequences (the JAX package's
    ``decode_train``): tokens (B, S), encoder states xa (B, T, d) ->
    logits (B, S, vocab) f32.

    Causal self-attention over the sequence with no cache, unquantised
    cross K/V in the (B, H, hd, T) layout with
    :func:`plain_cross_attention`, and the tied head ``x @ tok_emb.T`` in
    f32; differentiable throughout. ``tp`` holds the tensor-parallel hooks
    (:class:`Replicated` when None); under it the head count is each
    rank's share, read from the weights' widths."""
    tp = tp or Replicated()
    dec = model.decoder
    p = dec.blocks
    hd = model.config.n_text_state // model.config.n_text_head
    s = tokens.shape[1]
    x = tp.gather(dec.tok_emb[tokens]) + dec.pos_emb[:s]
    xa = tp.copy(xa)
    idx = torch.arange(s, device=tokens.device)
    causal = torch.where(idx[None, :] <= idx[:, None], 0.0,
                         float("-inf"))[None, None]
    for i in range(p["wq"].shape[0]):
        ck = _heads(dense(xa, p["cwk"][i]), hd).permute(0, 2, 3, 1)
        cv = _heads(dense(xa, p["cwv"][i], p["cbv"][i]),
                    hd).permute(0, 2, 3, 1)
        x = _train_decoder_block(x, p, i, ck, cv, causal, hd, tp)
    x = layer_norm(x, dec.ln_s, dec.ln_b)
    emb = dec.tok_emb
    lo = tp.rank * emb.shape[1]
    x = tp.copy(x.float())[..., lo:lo + emb.shape[1]]
    return tp.reduce(torch.matmul(x, emb.float().t()))


def forward(model: Whisper, mel: torch.Tensor, tokens: torch.Tensor,
            tp=None) -> torch.Tensor:
    """The teacher-forced forward the train step differentiates (the JAX
    package's ``forward``): mel (B, n_mels, 3000) and tokens (B, S) ->
    logits (B, S, vocab) f32.

    Its encoder is not :func:`encode`: every layer's attention is the
    plain :func:`attention` (the JAX train step's own; Kernel A has no
    backward and takes bf16 only), so this runs on any device and dtype,
    as the train step mirrors the JAX one. Inference keeps :func:`encode`
    and its kernel."""
    tp = tp or Replicated()
    enc = model.encoder
    hd = model.config.n_audio_state // model.config.n_audio_head
    x = _encoder_stem(enc, mel)
    for i in range(enc.blocks["wq"].shape[0]):
        x = _train_encoder_block(x, enc.blocks, i, hd, tp)
    xa = layer_norm(x, enc.ln_s, enc.ln_b)
    return decode_train(model, tokens, xa, tp)
