"""Qwen3 decode-step column attention: the Hopper kernel and its plain version.

:func:`column_attention` computes one decode step's grouped-query
attention of LM layer ``layer`` (``models/qwen/model.py:_lm_block`` in
column mode)::

    q (B, 1, nh, hd) after q_norm and rope, unscaled
    cache K, V (L, B, T_max, nkv * hd), positions [0, pos) filled
    k_new, v_new (B, nkv * hd), rows at any stride: this step's column,
    at position pos
    -> o (B, 1, nh, hd) = softmax(q k^T hd^-0.5) v over the pos + 1
       positions, query head h reading KV group h // (nh // nkv)

and writes the column into the cache at ``pos``, so the cache after the
step holds what the step added. ``pos`` is an int or one int32 on the
operands' device (shape (1,)); the kernel reads a tensor position when
it runs, so one launch captured in a CUDA graph serves every step
(``models/qwen/step_graph.py``), and the plain version reads it with
tensor ops, never on the host. On CUDA tensors it launches
``csrc/qwen_column_attention.cu`` or raises: the kernel reads the filled
positions of the layer in place, once, and nothing at or after ``pos``.
On CPU tensors it runs :func:`column_attention_plain`, the einsums the
model ran before the kernel, which read every slot of a copy of the
layer's cache and mask the ones at and after ``pos``. The two agree up
to the order of the sums (and, in bf16, the plain version's roundings of
the scaled q, the logits and the weights to bf16, which the kernel keeps
in f32). No TPU kernel lies on this path.
"""

from __future__ import annotations

import ctypes

import torch

from whisperjav_tpu_torch.ops.cuda import _build
from whisperjav_tpu_torch.ops.cuda._build import I, I64, P

_KERNEL = _build.entry("wjt_qwen_column_attention",
                       [P] * 6 + [I64] * 2 + [I] * 7
                       + [P, ctypes.c_float, P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (128, 32)    # every dense Qwen3; the port's test widths


def column_attention_plain(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, layer: int, pos,
                           k_new: torch.Tensor,
                           v_new: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch: the cache's logits (slots at and
    after ``pos`` masked) and the new key's through one softmax, in q's
    type; then the column written at ``pos`` (an int or a one-element
    tensor, read by tensor ops alone)."""
    b, _, nh, hd = q.shape
    t_max, kvd = cache_k.shape[2:]
    nkv = kvd // hd
    rep = nh // nkv
    bias = torch.where((torch.arange(t_max, device=q.device) < pos)[None, :],
                       0.0, float("-inf"))
    qg = (q * hd ** -0.5).reshape(b, 1, nkv, rep, hd)
    kk = cache_k[layer].to(q.dtype).reshape(b, t_max, nkv, hd)
    vv = cache_v[layer].to(q.dtype).reshape(b, t_max, nkv, hd)
    kn = k_new.reshape(b, 1, nkv, hd)
    vn = v_new.reshape(b, 1, nkv, hd)
    lg_c = torch.einsum("bqgrd,bkgd->bgrqk", qg, kk).float() + bias
    lg_n = torch.einsum("bqgrd,bkgd->bgrqk", qg, kn).float()
    a = torch.softmax(torch.cat([lg_c, lg_n], dim=-1), dim=-1).to(q.dtype)
    o = (torch.einsum("bgrqk,bkgd->bqgrd", a[..., :t_max], vv).float()
         + torch.einsum("bgrqk,bkgd->bqgrd", a[..., t_max:], vn).float())
    at = torch.as_tensor(pos, device=q.device).reshape(1).long()
    cache_k[layer, :, at] = k_new[:, None].to(cache_k.dtype)
    cache_v[layer, :, at] = v_new[:, None].to(cache_v.dtype)
    return o.to(q.dtype).reshape(b, 1, nh, hd)


def _check(q, cache_k, cache_v, layer, pos, k_new, v_new):
    """Raise on operands (on one CUDA device) the kernel does not take;
    returns (B, nkv, rep, hd, T_max)."""
    tensors = (q, cache_k, cache_v, k_new, v_new)
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"column_attention: q must be (B, 1, nh, hd), got "
                         f"{tuple(q.shape)}")
    b, _, nh, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"column_attention: the kernel takes hd in "
                         f"{HEAD_DIMS}, got {hd}")
    if cache_k.dim() != 4 or cache_k.shape != cache_v.shape \
            or cache_k.shape[1] != b or cache_k.shape[3] % hd:
        raise ValueError(f"column_attention: K and V must be one (L, {b}, "
                         f"T_max, nkv * {hd}) shape, got "
                         f"{tuple(cache_k.shape)} and {tuple(cache_v.shape)}")
    n_layer, _, t_max, kvd = cache_k.shape
    nkv = kvd // hd
    if nh % nkv:
        raise ValueError(f"column_attention: {nh} query heads do not "
                         f"split into {nkv} KV groups")
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or q.dtype not in _DTYPES:
        raise ValueError(f"column_attention: q, the cache and the column "
                         f"must share one type of {list(_DTYPES)}, got "
                         f"{dtypes}")
    if not (q.is_contiguous() and cache_k.is_contiguous()
            and cache_v.is_contiguous()):
        raise ValueError("column_attention: q, K and V must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, cache_k, cache_v)):
        raise ValueError("column_attention: q, K and V must start 16-byte "
                         "aligned")
    for name, col in (("k_new", k_new), ("v_new", v_new)):
        if col.shape != (b, kvd) or col.stride(1) != 1:
            raise ValueError(f"column_attention: {name} must be (B, nkv * "
                             f"hd) = ({b}, {kvd}) with contiguous rows, got "
                             f"{tuple(col.shape)} at {col.stride()}")
    if not 0 <= layer < n_layer:
        raise ValueError(f"column_attention: layer {layer} outside [0, "
                         f"{n_layer})")
    if isinstance(pos, torch.Tensor):
        if pos.shape != (1,) or pos.dtype != torch.int32:
            raise ValueError(f"column_attention: a tensor pos must be one "
                             f"int32 of shape (1,), got {pos.dtype} "
                             f"{tuple(pos.shape)}")
    elif not 0 <= pos < t_max:
        raise ValueError(f"column_attention: pos {pos} outside [0, "
                         f"{t_max})")
    return b, nkv, nh // nkv, hd, t_max


def column_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, layer: int, pos,
                     k_new: torch.Tensor, v_new: torch.Tensor
                     ) -> torch.Tensor:
    """One decode step's attention of layer ``layer`` at position
    ``pos``; writes the column into the cache at ``pos``. An int
    position is checked against T_max and copied to the device; a
    tensor's range is the caller's to keep (the kernel clamps it to [0,
    T_max))."""
    tensors = (q, cache_k, cache_v, k_new, v_new)
    if isinstance(pos, torch.Tensor):
        tensors += (pos,)
    if _build.on_cpu("column_attention", *tensors):
        return column_attention_plain(q, cache_k, cache_v, layer, pos,
                                      k_new, v_new)
    b, nkv, rep, hd, t_max = _check(q, cache_k, cache_v, layer, pos,
                                    k_new, v_new)
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor([int(pos)], dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    _build.launch(column_attention, "column_attention kernel", q.device,
                  _KERNEL, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                  cache_k.data_ptr(), cache_v.data_ptr(), out.data_ptr(),
                  k_new.stride(0), v_new.stride(0), _DTYPES[q.dtype],
                  int(layer), b, nkv, rep, hd, t_max, pos.data_ptr(),
                  ctypes.c_float(hd ** -0.5))
    return out


column_attention.launches = 0
