"""Decode-step int8 cross-attention: the Hopper kernel and its plain version.

:func:`decode_cross_attention` computes, for each of R query rows that
share one cross-K/V row (R = g*q_len under the beam fold of
``models/whisper/model.py:cross_attention``)::

    q (B, R, H, hd) f32, attention scale and k_scale folded in
    K, V (L, B, H, hd, T) int8, one layer selected by ``layer``
    -> (B, R, H, hd) f32, before v_scale

as ``whisperjav_tpu.ops.pallas.decode_attention`` does for R = 1. On
CUDA tensors it launches ``csrc/decode_cross_attention.cu`` or raises;
on CPU tensors it runs :func:`decode_cross_attention_plain`.
"""

from __future__ import annotations

import torch

from whisperjav_tpu_torch.ops.cuda import _build


def decode_cross_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, layer: int) -> torch.Tensor:
    """The kernel's function in PyTorch: dequantise, f32 softmax over T."""
    kl = k[layer].float()                                  # (B, H, hd, T)
    vl = v[layer].float()
    logits = torch.matmul(q.float().transpose(1, 2), kl)   # (B, H, R, T)
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights, vl.transpose(2, 3))        # (B, H, R, hd)
    return out.transpose(1, 2).contiguous()


def decode_cross_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, layer: int) -> torch.Tensor:
    """One decode step of cross-attention over layer ``layer`` of int8 K/V."""
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return decode_cross_attention_plain(q, k, v, layer)
    if len(devices) != 1 or not q.is_cuda:
        raise ValueError(f"decode_cross_attention: q, k, v must share one "
                         f"CUDA device or all lie on the CPU, got {devices}")
    if k.dim() != 5 or k.shape != v.shape:
        raise ValueError(f"decode_cross_attention: K and V must be one "
                         f"(L, B, H, hd, T) shape, got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    n_layer, b, h, hd, t = k.shape
    if q.dim() != 4 or q.shape[0] != b or q.shape[2:] != (h, hd):
        raise ValueError(f"decode_cross_attention: q must be (B, R, H, hd) "
                         f"= ({b}, R, {h}, {hd}), got {tuple(q.shape)}")
    if hd != 64:
        raise ValueError(f"decode_cross_attention: the kernel takes hd = "
                         f"64, got {hd}")
    if q.dtype != torch.float32 or k.dtype != torch.int8 \
            or v.dtype != torch.int8:
        raise ValueError(f"decode_cross_attention: needs f32 q and int8 "
                         f"K/V, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_cross_attention: q, K and V must be "
                         "contiguous")
    if not 0 <= layer < n_layer:
        raise ValueError(f"decode_cross_attention: layer {layer} outside "
                         f"[0, {n_layer})")
    lib = _build.load_library()
    max_t = lib.wjt_decode_cross_attention_max_t()
    if not 0 < t <= max_t:
        raise ValueError(f"decode_cross_attention: T = {t} outside "
                         f"(0, {max_t}]")
    rows = q.shape[1]
    out = torch.empty((b, rows, h, hd), dtype=torch.float32,
                      device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.wjt_decode_cross_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(layer), b, rows, h, t, stream)
    _build.check(err, "decode_cross_attention kernel")
    decode_cross_attention.launches += 1
    return out


decode_cross_attention.launches = 0
