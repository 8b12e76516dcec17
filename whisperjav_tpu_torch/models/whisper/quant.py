"""Decoder weight preparation (counterpart of
``whisperjav_tpu/models/whisper/quant.py``): q/k/v fusion, and symmetric
int8 decoder weights per output channel with an int8 lm head, the
representation the fused decode blocks read."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from whisperjav_tpu_torch.models.whisper.model import Int8Weight, Whisper

# decoder block matmuls read every step; cwk/cwv are left out: they run
# once per segment in precompute_cross_kv
_DECODE_HOT = ("wq", "wk", "wv", "wo", "cwq", "cwo", "w1", "w2")


def _quantize(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., in, out) -> (int8 codes, f32 scales (..., 1, out)): scale =
    max |w| over the input axis / 127 + 1e-12, codes rounded half to even
    (as ``jnp.round``) and clipped to +-127."""
    w32 = w.float()
    s = w32.abs().amax(dim=-2, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return q.contiguous(), s


def fuse_qkv_weights(model: Whisper) -> Whisper:
    """Concatenate each decoder layer's self-attention q/k/v projections
    into one (L, d, 3d) ``wqkv`` with bias ``bqkv`` (k's slot zeros), in
    place: one matmul per layer per decode step instead of three, with
    the same sum per output column."""
    p = model.decoder.blocks
    if "wqkv" in p:
        return model
    wq, wk, wv = p.pop("wq"), p.pop("wk"), p.pop("wv")
    bq, bv = p.pop("bq"), p.pop("bv")
    p["wqkv"] = nn.Parameter(torch.cat([wq, wk, wv], dim=-1),
                             requires_grad=False)
    p["bqkv"] = nn.Parameter(torch.cat([bq, torch.zeros_like(bq), bv],
                                       dim=-1), requires_grad=False)
    return model


def quantize_decoder_weights(model: Whisper) -> Whisper:
    """Replace the decoder block matmuls (``wqkv`` when fused, else
    wq/wk/wv, and wo, cwq, cwo, w1, w2) by :class:`Int8Weight`, dropping
    their float copies, and add ``decoder.lm_head_q``, the int8 transpose
    of the token embedding (which stays for lookups); in place. Apply
    after the cast to the compute dtype and after
    :func:`fuse_qkv_weights`, as the JAX engine does."""
    dec = model.decoder
    if hasattr(dec, "lm_head_q"):
        return model
    p = dec.blocks
    hot = (("wqkv",) + _DECODE_HOT[3:]) if "wqkv" in p else _DECODE_HOT
    for name in hot:
        p[name] = Int8Weight(*_quantize(p.pop(name)))
    dec.lm_head_q = Int8Weight(*_quantize(dec.tok_emb.t()))
    return model
