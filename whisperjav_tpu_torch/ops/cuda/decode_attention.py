"""Decode-step int8 cross-attention: the Hopper kernel and its plain versions.

:func:`decode_cross_attention` computes, for each of R query rows that
share one cross-K/V row (R = g*q_len under the beam fold of
``models/whisper/model.py:cross_attention``)::

    q (B, R, H, hd) f32, attention scale and k_scale folded in
    K, V (L, B, H, hd, T) int8, one layer selected by ``layer``
    -> (B, R, H, hd) f32, before v_scale

as ``whisperjav_tpu.ops.pallas.decode_attention`` does for R = 1. The
same kernel also writes two scaled forms, y = out * v_scale[layer, b, h]
(v_scale: L*B*H f32 values, (L, B, H) or (L, B, H, 1, 1)):
:func:`decode_cross_attention_bf16` returns bf16(y), the unfused layers'
cross-attention output; :func:`decode_cross_attention_terms` returns
(hi, lo) = (bf16(y), bf16(y - hi)), the fused cross block's out-projection
input. On CUDA tensors each wrapper launches
``csrc/decode_cross_attention.cu`` or raises; on CPU tensors it runs its
plain version, built on :func:`decode_cross_attention_plain`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from whisperjav_tpu_torch.ops.cuda import _build
from whisperjav_tpu_torch.ops.cuda._build import I, P

_BF16, _TERMS = 1, 2      # the kernel's scaled forms
_F32_FORM = _build.entry("wjt_decode_cross_attention", [P] * 4 + [I] * 5 + [P])
_SCALED_FORMS = _build.entry("wjt_decode_cross_attention_scaled",
                             [P] * 6 + [I] * 6 + [P])
# the longest T the kernel takes (the fused cross block's too)
max_t = _build.entry("wjt_decode_cross_attention_max_t", [])


def decode_cross_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, layer: int) -> torch.Tensor:
    """The kernel's function in PyTorch: dequantise, f32 softmax over T."""
    kl = k[layer].float()                                  # (B, H, hd, T)
    vl = v[layer].float()
    logits = torch.matmul(q.float().transpose(1, 2), kl)   # (B, H, R, T)
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights, vl.transpose(2, 3))        # (B, H, R, hd)
    return out.transpose(1, 2).contiguous()


def _scaled_plain(q, k, v, layer, v_scale) -> torch.Tensor:
    n_layer, b, h = k.shape[:3]
    vs = v_scale.reshape(n_layer, b, h)[layer].reshape(b, 1, h, 1)
    return decode_cross_attention_plain(q, k, v, layer) * vs.float()


def decode_cross_attention_bf16_plain(q, k, v, layer: int,
                                      v_scale) -> torch.Tensor:
    """bf16(out * v_scale): the f32 product, rounded once."""
    return _scaled_plain(q, k, v, layer, v_scale).to(torch.bfloat16)


def decode_cross_attention_terms_plain(q, k, v, layer: int, v_scale
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bf16 terms of y = out * v_scale: hi = bf16(y), lo =
    bf16(y - hi); hi + lo is within 2^-16 of y, relative."""
    y = _scaled_plain(q, k, v, layer, v_scale)
    hi = y.to(torch.bfloat16)
    return hi, (y - hi.float()).to(torch.bfloat16)


def _launch(counter, what: str, form: int, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, layer: int, v_scale: Optional[torch.Tensor]):
    """Checks the operands (on one CUDA device), then launches the
    kernel in ``form`` (0 f32, 1 bf16, 2 terms), counted in ``counter``;
    returns the output tensors."""
    if k.dim() != 5 or k.shape != v.shape:
        raise ValueError(f"{what}: K and V must be one (L, B, H, hd, T) "
                         f"shape, got {tuple(k.shape)} and {tuple(v.shape)}")
    n_layer, b, h, hd, t = k.shape
    if q.dim() != 4 or q.shape[0] != b or q.shape[2:] != (h, hd):
        raise ValueError(f"{what}: q must be (B, R, H, hd) = ({b}, R, {h}, "
                         f"{hd}), got {tuple(q.shape)}")
    if hd != 64:
        raise ValueError(f"{what}: the kernel takes hd = 64, got {hd}")
    if q.dtype != torch.float32 or k.dtype != torch.int8 \
            or v.dtype != torch.int8:
        raise ValueError(f"{what}: needs f32 q and int8 K/V, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: q, K and V must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{what}: K and V must start 16-byte aligned")
    if v_scale is not None and (
            v_scale.numel() != n_layer * b * h
            or v_scale.dtype != torch.float32
            or not v_scale.is_contiguous()):
        raise ValueError(f"{what}: v_scale must be {n_layer * b * h} "
                         f"contiguous f32 values (L, B, H), got "
                         f"{tuple(v_scale.shape)} {v_scale.dtype}")
    if not 0 <= layer < n_layer:
        raise ValueError(f"{what}: layer {layer} outside [0, {n_layer})")
    longest = max_t()
    if not 0 < t <= longest:
        raise ValueError(f"{what}: T = {t} outside (0, {longest}]")
    rows = q.shape[1]
    dtype = torch.float32 if form == 0 else torch.bfloat16
    outs = [torch.empty((b, rows, h, hd), dtype=dtype, device=q.device)
            for _ in range(2 if form == _TERMS else 1)]
    if outs[0].numel() == 0:
        return outs
    if form == 0:
        _build.launch(counter, f"{what} kernel", q.device, _F32_FORM,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      outs[0].data_ptr(), int(layer), b, rows, h, t)
    else:
        _build.launch(counter, f"{what} kernel", q.device, _SCALED_FORMS,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      v_scale.data_ptr(), outs[0].data_ptr(),
                      outs[-1].data_ptr(), form, int(layer), b, rows, h, t)
    return outs


def decode_cross_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, layer: int) -> torch.Tensor:
    """One decode step of cross-attention over layer ``layer`` of int8
    K/V: f32, before v_scale."""
    if _build.on_cpu("decode_cross_attention", q, k, v):
        return decode_cross_attention_plain(q, k, v, layer)
    (out,) = _launch(decode_cross_attention, "decode_cross_attention", 0, q,
                     k, v, layer, None)
    return out


def decode_cross_attention_bf16(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, layer: int,
                                v_scale: torch.Tensor) -> torch.Tensor:
    """bf16(out * v_scale) of one decode step over layer ``layer``."""
    what = "decode_cross_attention_bf16"
    if _build.on_cpu(what, q, k, v, v_scale):
        return decode_cross_attention_bf16_plain(q, k, v, layer, v_scale)
    (out,) = _launch(decode_cross_attention_bf16, what, _BF16, q, k, v,
                     layer, v_scale)
    return out


def decode_cross_attention_terms(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, layer: int,
                                 v_scale: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 (hi, lo) terms of out * v_scale over layer ``layer``."""
    what = "decode_cross_attention_terms"
    if _build.on_cpu(what, q, k, v, v_scale):
        return decode_cross_attention_terms_plain(q, k, v, layer, v_scale)
    hi, lo = _launch(decode_cross_attention_terms, what, _TERMS, q, k, v,
                     layer, v_scale)
    return hi, lo


decode_cross_attention.launches = 0
decode_cross_attention_bf16.launches = 0
decode_cross_attention_terms.launches = 0
