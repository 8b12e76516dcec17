"""Encoder self-attention: the Hopper kernel and its plain PyTorch version.

:func:`encoder_attention` takes q, k, v in the (B, T, H, hd) layout of
``whisperjav_tpu.ops.pallas.attention.encoder_attention``. On CUDA
tensors it launches ``csrc/encoder_attention.cu`` (bf16, hd = 64) or
raises; on CPU tensors it runs :func:`attention`, the plain version,
which is ``whisperjav_tpu.models.whisper.model.attention`` in PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch

from whisperjav_tpu_torch.ops.cuda import _build
from whisperjav_tpu_torch.ops.cuda._build import I, I64, P

_KERNEL = _build.entry("wjt_encoder_attention",
                       [P] * 4 + [I] * 3 + [I64] * 9 + [P])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention core. q, k, v (B, T, H, hd); bias (1|B, 1, Tq, Tk).

    q and k are each scaled by hd^-0.25 in their own dtype, the logits
    and softmax are f32, the probabilities go back to q's dtype for the
    product with v, as in the JAX reference.
    """
    scale = q.shape[-1] ** -0.25
    qs = (q * scale).float().transpose(1, 2)               # (B, H, Tq, hd)
    ks = (k * scale).float().permute(0, 2, 3, 1)           # (B, H, hd, Tk)
    logits = torch.matmul(qs, ks)
    if bias is not None:
        logits = logits + bias
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(weights, v.transpose(1, 2))         # (B, H, Tq, hd)
    return out.transpose(1, 2)


def encoder_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Bidirectional attention, (B, T, H, hd) in and out, any T."""
    if _build.on_cpu("encoder_attention", q, k, v):
        return attention(q, k, v)
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"encoder_attention: q, k, v must have one "
                         f"(B, T, H, hd) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, hd = q.shape
    if hd != 64:
        raise ValueError(f"encoder_attention: the kernel takes hd = 64, "
                         f"got {hd}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"encoder_attention: {name} must be bfloat16, "
                             f"got {x.dtype}")
        if (x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3])
                or x.data_ptr() % 16):
            raise ValueError(f"encoder_attention: {name} needs a unit "
                             f"stride on hd, the other strides a multiple "
                             f"of 8 and 16-byte alignment; got strides "
                             f"{x.stride()}")
    out = torch.empty((b, t, h, hd), dtype=torch.bfloat16, device=q.device)
    if q.numel() == 0:
        return out
    _build.launch(encoder_attention, "encoder_attention kernel", q.device,
                  _KERNEL, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, t, h, *q.stride()[:3], *k.stride()[:3],
                  *v.stride()[:3])
    return out


encoder_attention.launches = 0
