"""Whisper encoder-decoder in PyTorch.

Counterpart of ``whisperjav_tpu/models/whisper/model.py`` on the path a
flagless run takes. Parameters keep the JAX tree's names and stacked
layouts: per-layer weights stack on a leading layer axis and matrices are
(in, out), so :mod:`weights` maps a JAX tree one to one. The public
layouts are the JAX package's: attention operands (B, T, H, hd), the
self-attention cache ``KVCache`` (L, B, T, d) and the cross-attention
``CrossKV`` (L, B, H, hd, T), int8 or in the compute dtype.

Int8 decoder weights (``quant.quantize_decoder_weights``) are the JAX
tree's ``{"q": int8, "s": f32}`` leaves, held as :class:`Int8Weight`;
:func:`dense` takes them, and the lm head is ``decoder.lm_head_q``.

Kernels sit behind :func:`encoder_attention` (every encoder layer),
:func:`cross_attention` on int8 cross K/V (every decoder layer of a step
on bf16 weights, and of every prefill) and, on int8 weights and int8
cross K/V at q_len == 1, the three fused blocks of
``ops/cuda/fused_decode.py`` (every decoder layer of every step, beam
rungs included); all run their plain PyTorch versions on CPU tensors.
Cross K/V in the compute dtype (the JAX package's default) or int4 reach
no kernel, as in the JAX package.

Fine-tuning differentiates :func:`forward` (the JAX package's
``forward`` and ``decode_train``): plain attention, unquantised cross
K/V and no cache, in f32 on a :meth:`Whisper.trainable` model, with
hooks for tensor parallelism (``parallel/train.py``). It reaches no
kernel, as the JAX train step reaches no Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from whisperjav_tpu_torch.models.layers import (
    Int8Weight, ParamTree, int8_matmul, layer_norm,
)
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

def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """x (..., in) @ w (in, out) [+ b], rounded once to x's dtype.

    ``w`` is a tensor, whose product the bias joins in the f32
    accumulation, or an :class:`Int8`: then :func:`int8_matmul`, plus the
    bias in f32, as the JAX package's ``dense``.
    """
    if isinstance(w, torch.Tensor):
        x2 = x.reshape(-1, x.shape[-1])
        out = torch.mm(x2, w) if b is None else torch.addmm(b, x2, w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    out = int8_matmul(x, w)
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def split_heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    """(..., d) -> (..., d / hd, hd): heads of width ``hd`` (a
    tensor-parallel rank's weights give it its share of the heads)."""
    return x.reshape(*x.shape[:-1], x.shape[-1] // hd, hd)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _part(tree: Dict[str, object]) -> ParamTree:
    """One of encoder/decoder: named tensors, int8 leaves as
    :class:`Int8Weight`, and a ``blocks`` tree of layer-stacked tensors,
    kept last (its state-dict names follow every other leaf's)."""
    rest = {name: value for name, value in tree.items() if name != "blocks"}
    return ParamTree({**rest, "blocks": tree["blocks"]})


class Whisper(nn.Module):
    """Whisper weights: ``encoder`` and ``decoder`` parts of named tensors.

    Built from a tree of tensors with the JAX package's keys and layouts
    (see :func:`whisperjav_tpu_torch.models.whisper.weights.params_from_jax`
    and ``init_params``).
    """

    def __init__(self, config: WhisperConfig, tree: Dict[str, Dict]):
        super().__init__()
        self.config = config
        self.encoder = _part(tree["encoder"])
        self.decoder = _part(tree["decoder"])

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

def _encoder_block(x: torch.Tensor, p: ParamTree, i: int,
                   n_head: int) -> torch.Tensor:
    hd = x.shape[-1] // n_head
    h = layer_norm(x, p["ln1_s"][i], p["ln1_b"][i])
    q = split_heads(dense(h, p["wq"][i], p["bq"][i]), hd)
    k = split_heads(dense(h, p["wk"][i]), hd)
    v = split_heads(dense(h, p["wv"][i], p["bv"][i]), hd)
    a = encoder_attention(q, k, v)
    b_, t, _, _ = a.shape
    x = x + dense(a.reshape(b_, t, -1), p["wo"][i], p["bo"][i])
    h = layer_norm(x, p["ln2_s"][i], p["ln2_b"][i])
    return x + dense(F.gelu(dense(h, p["w1"][i], p["b1"][i])),
                     p["w2"][i], p["b2"][i])


def _encoder_stem(enc: ParamTree, mel: torch.Tensor) -> torch.Tensor:
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
    """Per-segment cross-attention K/V, (L, B, H, hd, T) int8 or in the
    compute dtype (or, for int4, (L, B, H, hd, T/2) uint8 nibble pairs),
    with per-(layer, batch, head) scales (L, B, H, 1, 1) f32 (ones for
    the compute dtype)."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor


def cross_kv_layout(model: Whisper, xa: torch.Tensor, int8: bool = False,
                    int4: bool = False) -> tuple:
    """The shapes and dtypes of :func:`precompute_cross_kv`'s buffers for
    ``xa`` (B, T, d): ((K/V shape, dtype), (scales shape, f32)). K/V are
    (L, B, H, hd, T) int8, (L, B, H, hd, T/2) uint8 for ``int4`` (which
    wins over int8), or in xa's dtype; the scales (L, B, H, 1, 1)."""
    cfg = model.config
    n_layer = model.decoder.blocks["cwk"].shape[0]
    b, t, _ = xa.shape
    h, hd = cfg.n_text_head, cfg.n_text_state // cfg.n_text_head
    if int4 and t % 2:
        raise ValueError(f"int4 cross-KV needs an even T axis, got {t} — "
                         "cross-KV buckets (448/960/1500) are all even")
    dtype = torch.uint8 if int4 else torch.int8 if int8 else xa.dtype
    return (((n_layer, b, h, hd, t // 2 if int4 else t), dtype),
            ((n_layer, b, h, 1, 1), torch.float32))


def precompute_cross_kv(model: Whisper, xa: torch.Tensor,
                        int8: bool = False, int4: bool = False,
                        out: Optional[CrossKV] = None) -> CrossKV:
    """Project encoder states once per segment into the (L, B, H, hd, T)
    cross-attention K/V, as the JAX package's ``precompute_cross_kv``.

    With ``int8`` each (layer, batch, head) is quantised symmetrically,
    rounding half to even as ``jnp.round``, to int8 (the decode kernel's
    operand); with ``int4`` (which wins over int8) to +-7 levels packed
    two to a byte along T (:func:`pack_nibbles`). With neither, K/V stay
    in xa's dtype with scales of one. Written into ``out`` when given
    (buffers of :func:`cross_kv_layout`'s shapes: those a captured decode
    step reads), else into new buffers."""
    blocks = model.decoder.blocks
    n_layer = blocks["cwk"].shape[0]
    hd = model.config.n_text_state // model.config.n_text_head
    quant = int8 or int4
    qmax = 7.0 if int4 else 127.0
    if out is None:
        (kv_shape, kv_dtype), (s_shape, s_dtype) = cross_kv_layout(
            model, xa, int8, int4)
        ck = torch.empty(kv_shape, dtype=kv_dtype, device=xa.device)
        ks = torch.ones(s_shape, dtype=s_dtype, device=xa.device)
        out = CrossKV(ck, torch.empty_like(ck), ks, torch.ones_like(ks))
    elif not quant:
        out.k_scale.fill_(1.0)
        out.v_scale.fill_(1.0)
    ck, cv, ks, vs = out
    for i in range(n_layer):
        for buf, scale, proj in (
                (ck, ks, dense(xa, blocks["cwk"][i])),
                (cv, vs, dense(xa, blocks["cwv"][i], blocks["cbv"][i]))):
            x = split_heads(proj, hd).permute(0, 2, 3, 1)       # (B,H,hd,T)
            if not quant:
                buf[i] = x
                continue
            x = x.float()
            s = x.abs().amax(dim=(2, 3), keepdim=True) / qmax + 1e-9
            codes = torch.clamp(torch.round(x / s), -qmax, qmax)
            buf[i] = pack_nibbles(codes) if int4 else codes.to(torch.int8)
            scale[i] = s
    return CrossKV(ck, cv, ks, vs)


def pack_nibbles(x: torch.Tensor) -> torch.Tensor:
    """+-7-level values -> two 4-bit two's-complement nibbles per uint8
    along the last (T) axis: byte i holds position 2i (low nibble) and
    2i + 1 (high)."""
    if x.shape[-1] % 2:
        raise ValueError(f"int4 cross-KV needs an even T axis, got "
                         f"{x.shape[-1]}")
    xi = x.to(torch.int32)
    return (((xi[..., 1::2] & 0xF) << 4) | (xi[..., 0::2] & 0xF)).to(
        torch.uint8)


def nib_lo(p: torch.Tensor) -> torch.Tensor:
    """The low nibbles of packed bytes, sign-extended to int8 (the even
    positions)."""
    return (p.view(torch.int8) << 4) >> 4


def nib_hi(p: torch.Tensor) -> torch.Tensor:
    """The high nibbles of packed bytes, sign-extended to int8 (the odd
    positions)."""
    return p.view(torch.int8) >> 4


def unpack_nibbles(p: torch.Tensor) -> torch.Tensor:
    """uint8 nibble pairs -> int8 values in position order, the inverse
    of :func:`pack_nibbles`."""
    return torch.stack([nib_lo(p), nib_hi(p)], dim=-1).reshape(
        *p.shape[:-1], 2 * p.shape[-1])


def packed_cross_attention(q: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor) -> torch.Tensor:
    """q (B, Tq, H, hd) over nibble-packed int4 K/V (B, H, hd, T/2) with
    scales (B, H, 1, 1) -> (B, Tq, H, hd), as the JAX package's
    ``_packed_cross_attention``: the even positions (low nibbles) and the
    odd ones (high nibbles) are attended as two halves of one softmax
    (softmax over T does not depend on the order of T), so the packed
    bytes are never interleaved. Products take q's dtype's values in f32,
    as the JAX einsums' f32 accumulation does; the plain PyTorch version
    runs on the card too (the JAX package computes int4 outside any
    Pallas kernel)."""
    hd = q.shape[-1]
    scale = hd ** -0.25
    qf = (q * (scale * scale)).float()
    # the nibbles' values (-8..7) are exact in any float type
    lg = [torch.einsum("bqhd,bhdt->bhqt", qf, nib(ck).float()) * k_scale
          for nib in (nib_lo, nib_hi)]
    logits = torch.cat(lg, dim=-1)                 # (B, H, Tq, T) permuted
    weights = torch.softmax(logits, dim=-1).to(q.dtype).float()
    t2 = ck.shape[-1]
    out = (torch.einsum("bhqt,bhdt->bqhd", weights[..., :t2],
                        nib_lo(cv).float())
           + torch.einsum("bhqt,bhdt->bqhd", weights[..., t2:],
                          nib_hi(cv).float()))
    out = out * v_scale.permute(0, 2, 1, 3)        # (B, 1, H, 1)
    return out.to(q.dtype)


def unquantised_cross_attention(q: torch.Tensor, ck: torch.Tensor,
                                cv: torch.Tensor) -> torch.Tensor:
    """q (B, Tq, H, hd) x K/V (B, H, hd, T) in q's dtype -> (B, Tq, H, hd),
    as the JAX package's ``cross_attention`` on unquantised K/V: q times
    hd^-0.5 rounded to q's dtype, f32 logits of the products, softmax in
    f32 with its weights cast to q's dtype, the output summed in f32 and
    cast to q's dtype. The JAX package computes this outside any Pallas
    kernel; the plain products run on the card too (bf16 values are
    exact in f32)."""
    hd = q.shape[-1]
    scale = (hd ** -0.25) * (hd ** -0.25)
    qs = (q * scale).float().transpose(1, 2)               # (B, H, Tq, hd)
    logits = torch.matmul(qs, ck.float())                  # (B, H, Tq, T)
    weights = torch.softmax(logits, dim=-1).to(q.dtype).float()
    out = torch.matmul(weights, cv.float().transpose(2, 3))
    return out.transpose(1, 2).to(q.dtype)


def cross_attention(q: torch.Tensor, cross: CrossKV,
                    layer: int) -> torch.Tensor:
    """q (B*g, Tq, H, hd) x layer ``layer`` of the cross K/V
    (B, H, hd, T) -> (B*g, Tq, H, hd).

    Beam folding: when q has g times the K/V's rows (beam search: all
    beams of a row attend the same audio), the g beams fold into the
    query axis, q (B*g, Tq) -> (B, g*Tq), so one cross-K/V row serves all
    of them. On int8 K/V the attention scale and k_scale are folded into
    q in f32; v_scale multiplies the kernel's f32 output, before the one
    rounding to q's dtype (in the kernel's epilogue for bf16).
    Nibble-packed int4 K/V (uint8) take :func:`packed_cross_attention`
    and K/V in the compute dtype :func:`unquantised_cross_attention`,
    beams folded alike; neither reaches a kernel.
    """
    bq, tq, h, hd = q.shape
    b = cross.k.shape[1]
    g, rem = divmod(bq, b)
    if rem:
        raise ValueError(f"query batch {bq} not a multiple of cross-KV "
                         f"batch {b}")
    if cross.k.dtype == torch.uint8:
        a = packed_cross_attention(
            q.reshape(b, g * tq, h, hd), cross.k[layer], cross.v[layer],
            cross.k_scale[layer], cross.v_scale[layer])
        return a.reshape(bq, tq, h, hd)
    if cross.k.dtype != torch.int8:
        a = unquantised_cross_attention(q.reshape(b, g * tq, h, hd),
                                        cross.k[layer], cross.v[layer])
        return a.reshape(bq, tq, h, hd)
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
    kc = (split_heads(cache_k, hd) * scale).float()         # (B, T, H, hd)
    kn = (split_heads(k_new, hd) * scale).float()           # (B, 1, H, hd)
    logits_c = torch.einsum("bqhd,bkhd->bhqk", qs, kc) + col_bias
    logit_n = torch.einsum("bqhd,bqhd->bhq", qs, kn)[..., None]
    w = torch.softmax(torch.cat([logits_c, logit_n], dim=-1), dim=-1)
    w_c = w[..., :-1].to(q.dtype)                           # (B, H, 1, T)
    w_n = w[..., -1:].to(q.dtype)                           # (B, H, 1, 1)
    vc = split_heads(cache_v, hd).transpose(1, 2)           # (B, H, T, hd)
    a = torch.matmul(w_c, vc).transpose(1, 2)               # (B, 1, H, hd)
    return a + w_n.transpose(1, 2) * split_heads(v_new, hd)


def _decoder_block(x, p, i, cross: CrossKV, cache: "KVCache", pos: int,
                   n_head: int, self_bias: torch.Tensor,
                   column_mode: bool):
    """Decoder layer ``i`` at positions [pos, pos + q_len).

    Column mode (q_len == 1) leaves the cache as it is and returns this
    layer's new K/V column for the caller to write; otherwise the new
    K/V are written into the cache in place, then attended.
    """
    b, q_len, d = x.shape
    hd = d // n_head
    h = layer_norm(x, p["ln1_s"][i], p["ln1_b"][i])
    if "wqkv" in p:
        qkv = dense(h, p["wqkv"][i], p["bqkv"][i])
        q_new, k_new, v_new = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    else:
        q_new = dense(h, p["wq"][i], p["bq"][i])
        k_new = dense(h, p["wk"][i])
        v_new = dense(h, p["wv"][i], p["bv"][i])
    q = split_heads(q_new, hd)
    if column_mode:
        a = _self_attention_column(q, k_new, v_new, cache.k[i], cache.v[i],
                                   self_bias, n_head)
    else:
        cache.k[i, :, pos:pos + q_len] = k_new
        cache.v[i, :, pos:pos + q_len] = v_new
        a = attention(q, split_heads(cache.k[i], hd),
                      split_heads(cache.v[i], hd), self_bias)
    x = x + dense(a.reshape(b, q_len, d), p["wo"][i], p["bo"][i])
    # cross-attention
    h = layer_norm(x, p["lnx_s"][i], p["lnx_b"][i])
    cq = split_heads(dense(h, p["cwq"][i], p["cbq"][i]), hd)
    a = cross_attention(cq, cross, i)
    x = x + dense(a.reshape(b, q_len, d), p["cwo"][i], p["cbo"][i])
    # mlp
    h = layer_norm(x, p["ln2_s"][i], p["ln2_b"][i])
    x = x + dense(F.gelu(dense(h, p["w1"][i], p["b1"][i])),
                  p["w2"][i], p["b2"][i])
    return x, k_new, v_new


# int8 decoder weights the fused blocks read (quant.quantize_decoder_weights)
_FUSED_WEIGHTS = ("wqkv", "wo", "cwq", "cwo", "w1", "w2")


def fused_step(model: Whisper, cross_dtype: torch.dtype) -> bool:
    """Whether a single decode step (q_len == 1) runs the fused blocks:
    int8 decoder weights with q/k/v fused, over int8 cross K/V (the
    dtype of ``CrossKV.k``)."""
    blocks = model.decoder.blocks
    return cross_dtype == torch.int8 and all(
        isinstance(blocks.get(n), Int8Weight) for n in _FUSED_WEIGHTS)


def _fused_layers(x: torch.Tensor, p: ParamTree, cross: CrossKV,
                  cache: KVCache, pos: torch.Tensor,
                  n_head: int) -> torch.Tensor:
    """One decode step (x (R, d)) through every decoder layer as three
    fused blocks, then one store of every layer's new K/V column at
    ``pos`` (one int32 on the device). Cross K/V and scales go in the
    JAX kernels' flat layouts ((L, B, d, T) and (L, B, H): views, no
    copies)."""
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
    cache.k[:, :, pos] = torch.stack(k_cols)[:, :, None]
    cache.v[:, :, pos] = torch.stack(v_cols)[:, :, None]
    return x


def decode_hidden(model: Whisper, tokens: torch.Tensor, pos,
                  cache: KVCache, cross: CrossKV) -> torch.Tensor:
    """Decoder blocks and final LN for tokens (B, q_len) at positions
    [pos, pos + q_len), without the lm head. Writes the new K/V into
    ``cache`` in place; returns hidden states (B, q_len, d).

    A single step (q_len == 1) takes its position as one int32 on the
    tokens' device (shape (1,); an int is copied there): the position
    row, the visibility of the cache slots, the column store and the
    fused self block all read it on the device, so one captured forward
    serves every step (``step_graph.py``). On int8 decoder weights a
    single step over int8 cross K/V runs the fused blocks, beam fold
    included (B = g x the cross-K/V rows); prefill (an int position) and
    int4 cross K/V keep the unfused layers with int8 :func:`dense`, as in
    the JAX package (``model.py:597-611``)."""
    dec = model.decoder
    b, q_len = tokens.shape
    t_max = cache.k.shape[2]
    n_head = model.config.n_text_head
    column_mode = q_len == 1
    if column_mode:
        if not isinstance(pos, torch.Tensor):
            pos = torch.tensor([pos], dtype=torch.int32,
                               device=tokens.device)
        x = dec.tok_emb[tokens] + dec.pos_emb.index_select(0, pos)
    else:
        x = dec.tok_emb[tokens] + dec.pos_emb[pos:pos + q_len]
    if column_mode and fused_step(model, cross.k.dtype):
        x = _fused_layers(x[:, 0], dec.blocks, cross, cache, pos, n_head)
        return layer_norm(x[:, None], dec.ln_s, dec.ln_b)
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
        cache.k[:, :, pos] = torch.stack(k_cols)
        cache.v[:, :, pos] = torch.stack(v_cols)
    return layer_norm(x, dec.ln_s, dec.ln_b)


def decode_step(model: Whisper, tokens: torch.Tensor, pos,
                cache: KVCache, cross: CrossKV
                ) -> Tuple[torch.Tensor, KVCache]:
    """Decoder on a chunk (prefill or one step) -> (logits (B, q_len,
    vocab) f32, cache). The lm head is the tied token embedding, or its
    int8 copy ``lm_head_q`` on int8 weights (:func:`int8_matmul`),
    applied in f32 so the logits keep f32 precision as in the JAX
    package.

    ``pos`` is an int, or at q_len == 1 one int32 on the device
    (:func:`decode_hidden`). The decode loops' single steps on CUDA run
    this function once to capture it, then replay the graph
    (``step_graph.py``): a step of ~40 (turbo) to ~260 (large-v2 int8)
    launches from Python is the host's work that held the card back.
    Prefill, and every call on the CPU, run it eagerly."""
    x = decode_hidden(model, tokens, pos, cache, cross)
    lm = getattr(model.decoder, "lm_head_q", None)
    if lm is not None:
        return int8_matmul(x, lm), cache
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


def _mlp(x: torch.Tensor, p: ParamTree, i: int, tp) -> torch.Tensor:
    h = tp.copy(layer_norm(x, p["ln2_s"][i], p["ln2_b"][i]))
    out = dense(F.gelu(dense(h, p["w1"][i], p["b1"][i])), p["w2"][i])
    return x + tp.reduce(out) + p["b2"][i]


def _train_encoder_block(x, p, i, hd, tp):
    b, t, _ = x.shape
    h = tp.copy(layer_norm(x, p["ln1_s"][i], p["ln1_b"][i]))
    q = split_heads(dense(h, p["wq"][i], p["bq"][i]), hd)
    k = split_heads(dense(h, p["wk"][i]), hd)
    v = split_heads(dense(h, p["wv"][i], p["bv"][i]), hd)
    a = attention(q, k, v).reshape(b, t, -1)
    x = x + tp.reduce(dense(a, p["wo"][i])) + p["bo"][i]
    return _mlp(x, p, i, tp)


def _train_decoder_block(x, p, i, ck, cv, causal, hd, tp):
    b, s, _ = x.shape
    h = tp.copy(layer_norm(x, p["ln1_s"][i], p["ln1_b"][i]))
    q = split_heads(dense(h, p["wq"][i], p["bq"][i]), hd)
    k = split_heads(dense(h, p["wk"][i]), hd)
    v = split_heads(dense(h, p["wv"][i], p["bv"][i]), hd)
    a = attention(q, k, v, causal).reshape(b, s, -1)
    x = x + tp.reduce(dense(a, p["wo"][i])) + p["bo"][i]
    h = tp.copy(layer_norm(x, p["lnx_s"][i], p["lnx_b"][i]))
    cq = split_heads(dense(h, p["cwq"][i], p["cbq"][i]), hd)
    a = unquantised_cross_attention(cq, ck, cv).reshape(b, s, -1)
    x = x + tp.reduce(dense(a, p["cwo"][i])) + p["cbo"][i]
    return _mlp(x, p, i, tp)


def decode_train(model: Whisper, tokens: torch.Tensor, xa: torch.Tensor,
                 tp=None) -> torch.Tensor:
    """Teacher-forced decoder over whole sequences (the JAX package's
    ``decode_train``): tokens (B, S), encoder states xa (B, T, d) ->
    logits (B, S, vocab) f32.

    Causal self-attention over the sequence with no cache, unquantised
    cross K/V in the (B, H, hd, T) layout with
    :func:`unquantised_cross_attention`, and the tied head
    ``x @ tok_emb.T`` in f32; differentiable throughout. ``tp`` holds
    the tensor-parallel hooks (:class:`Replicated` when None); under it
    the head count is each rank's share, read from the weights'
    widths."""
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
        ck = split_heads(dense(xa, p["cwk"][i]), hd).permute(0, 2, 3, 1)
        cv = split_heads(dense(xa, p["cwv"][i], p["cbv"][i]),
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
