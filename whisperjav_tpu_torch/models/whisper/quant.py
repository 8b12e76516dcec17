"""Decoder weight preparation (counterpart of
``whisperjav_tpu/models/whisper/quant.py``; int8 decoder weights are not
on the flagless path and are not ported)."""

from __future__ import annotations

import torch
from torch import nn

from whisperjav_tpu_torch.models.whisper.model import Whisper


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
