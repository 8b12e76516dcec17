"""Fused decoder-layer blocks for one decode step on int8 weights: the
Hopper kernels and their plain versions.

Counterparts of ``whisperjav_tpu/ops/pallas/fused_decode.py``
(``self_block_stacked``, ``cross_block_stacked``, ``mlp_block_stacked``)
for rows x (R, d) at q_len == 1. Each block reads the layer-stacked
(L, ...) parameters, caches and cross K/V at ``layer``, as the TPU
kernels do, so no per-layer copy is made. An int8 weight is anything
with ``.q`` (L, in, out) int8 codes and ``.s`` (L, 1, out) f32
per-output-channel scales (``models/layers.py:Int8Weight``).

The plain versions are the Pallas kernels' f32 chain: LayerNorm of x in
f32, each int8 product in f32 with the scale after the sum, softmax in
f32; only the outputs round to x's dtype (the new K/V column to the
cache's). The cross block also takes the beam fold: R = B*g query rows,
row r reading cross-K/V row r // g.

On CPU tensors each block runs its plain version; on CUDA tensors it
launches ``csrc/fused_decode.cu`` (hd = 64, bf16 activations, widths a
multiple of 128) or raises. Each wrapper counts its launches in
``<function>.launches`` (a launch captured into a CUDA graph counts at
each replay: ``_build.capturing``). The self block reads its position
from the device, so the decode loops' captured step serves every
position. The kernels inside the blocks have no entry
point of their own; ``inner`` counts their launches by name: every
entry launches the int8 GEMV once in LN mode (``qgemv_ln``: LayerNorm of
x taken inside it, for wqkv, cwq and w1) and once on precomputed terms
(``qgemv``: wo, cwo, w2), the self block its attention kernel
(``self_attention``), and the cross block Kernel B in its terms form
(``decode_cross_attention_terms``, v_scale applied in its epilogue): 3 +
3 + 2 launches a layer-step.
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import Tuple

import torch
import torch.nn.functional as F

from whisperjav_tpu_torch.ops.cuda import _build
from whisperjav_tpu_torch.ops.cuda._build import I, P
from whisperjav_tpu_torch.ops.cuda.decode_attention import (
    decode_cross_attention_plain, max_t,
)

_SELF, _CROSS, _MLP = 0, 1, 2
_WORKSPACE_BYTES = _build.entry("wjt_fused_workspace_bytes", [I] * 4,
                                ctypes.c_longlong)
_SELF_BLOCK = _build.entry("wjt_self_block_at", [P] * 16 + [I] * 5 + [P])
_CROSS_BLOCK = _build.entry("wjt_cross_block", [P] * 15 + [I] * 6 + [P])
_MLP_BLOCK = _build.entry("wjt_mlp_block", [P] * 11 + [I] * 4 + [P])
# the self-attention kernel keeps a logit a cache slot in the 48 KB of
# shared memory a block has without opting in
_MAX_SELF_T = 8192


def _ln(x32: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 LayerNorm over the last axis (``fused_decode._ln``)."""
    return F.layer_norm(x32, (x32.shape[-1],), s.float(), b.float(), 1e-5)


def _qdense(h32: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """f32 (R, in) x int8 (in, out) * scale (1, out) + bias (out), all f32
    (``fused_decode._qdense``)."""
    return torch.matmul(h32, q.float()) * s.float() + b.float()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def self_block_plain(x, ln_s, ln_b, wqkv, bqkv, wo, bo, cache_k, cache_v,
                     layer: int, pos, n_head: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (R, d) -> (x_out (R, d), k_new, v_new (R, d) in the cache dtype).
    Attends the cache slots t < pos of (L, R, T, d) and the new key;
    ``pos`` is an int or a one-element tensor (read on the host)."""
    r, d = x.shape
    pos = int(pos)
    hd = d // n_head
    x32 = x.float()
    qkv = _qdense(_ln(x32, ln_s[layer], ln_b[layer]), wqkv.q[layer],
                  wqkv.s[layer], bqkv[layer])
    q = qkv[:, :d].reshape(r, n_head, hd) * hd ** -0.5
    k_new, v_new = qkv[:, d:2 * d], qkv[:, 2 * d:]
    kc = cache_k[layer, :, :pos].float().reshape(r, pos, n_head, hd)
    vc = cache_v[layer, :, :pos].float().reshape(r, pos, n_head, hd)
    logits_c = torch.einsum("rhd,rthd->rht", q, kc)
    logit_n = (q * k_new.reshape(r, n_head, hd)).sum(-1, keepdim=True)
    w = torch.softmax(torch.cat([logits_c, logit_n], dim=-1), dim=-1)
    a = (torch.einsum("rht,rthd->rhd", w[..., :-1], vc)
         + w[..., -1:] * v_new.reshape(r, n_head, hd))
    y = _qdense(a.reshape(r, d), wo.q[layer], wo.s[layer], bo[layer])
    return ((x32 + y).to(x.dtype), k_new.to(cache_k.dtype),
            v_new.to(cache_v.dtype))


def cross_block_plain(x, ln_s, ln_b, cwq, cbq, cwo, cbo, ck, cv, k_scale,
                      v_scale, layer: int, n_head: int) -> torch.Tensor:
    """x (R, d) x int8 cross K/V (L, B, d, T) with scales (L, B, H) ->
    x_out (R, d); R = B*g."""
    r, d = x.shape
    n_layer, b, _, t = ck.shape
    g, hd = r // b, d // n_head
    x32 = x.float()
    q = _qdense(_ln(x32, ln_s[layer], ln_b[layer]), cwq.q[layer],
                cwq.s[layer], cbq[layer])
    qf = q.reshape(b, g, n_head, hd) * (
        hd ** -0.5 * k_scale[layer].reshape(b, 1, n_head, 1))
    a = decode_cross_attention_plain(
        qf, ck.reshape(n_layer, b, n_head, hd, t),
        cv.reshape(n_layer, b, n_head, hd, t), layer)
    a = a * v_scale[layer].reshape(b, 1, n_head, 1)
    y = _qdense(a.reshape(r, d), cwo.q[layer], cwo.s[layer], cbo[layer])
    return (x32 + y).to(x.dtype)


def mlp_block_plain(x, ln_s, ln_b, w1, b1, w2, b2,
                    layer: int) -> torch.Tensor:
    """x (R, d) -> x + W2(GELU(W1 LN(x) + b1)) + b2, f32 inside."""
    x32 = x.float()
    u = F.gelu(_qdense(_ln(x32, ln_s[layer], ln_b[layer]), w1.q[layer],
                       w1.s[layer], b1[layer]))
    y = _qdense(u, w2.q[layer], w2.s[layer], b2[layer])
    return (x32 + y).to(x.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _expect(what: str, name: str, t: torch.Tensor, shape,
            dtype: torch.dtype) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{what}: {name} must be {tuple(shape)} {dtype}, "
                         f"got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def _check_common(what: str, x: torch.Tensor, n_layer: int, layer: int,
                  n_head: int = 0) -> None:
    """Checks every block shares (hd = 64 when ``n_head`` is given)."""
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be (R, d), got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the kernels take bfloat16 activations, "
                         f"got {x.dtype}")
    d = x.shape[1]
    if d % 128:
        raise ValueError(f"{what}: d must be a multiple of 128, got {d}")
    if n_head and d != 64 * n_head:
        raise ValueError(f"{what}: the kernel takes hd = 64, got d = {d} "
                         f"with {n_head} heads")
    if not 0 <= layer < n_layer:
        raise ValueError(f"{what}: layer {layer} outside [0, {n_layer})")


def _expect_int8(what: str, name: str, w, n_layer: int, k: int,
                 n: int) -> None:
    _expect(what, f"{name}.q", w.q, (n_layer, k, n), torch.int8)
    _expect(what, f"{name}.s", w.s, (n_layer, 1, n), torch.float32)


@functools.lru_cache(maxsize=64)
def _workspace_bytes(kind: int, rows: int, d: int, hidden: int) -> int:
    return _WORKSPACE_BYTES(kind, rows, d, hidden)


def _workspace(kind: int, rows: int, d: int, hidden: int,
               device: torch.device) -> torch.Tensor:
    n = _workspace_bytes(kind, rows, d, hidden)
    return torch.empty((n + 15) // 16 * 16, dtype=torch.uint8, device=device)


def self_block(x, ln_s, ln_b, wqkv, bqkv, wo, bo, cache_k, cache_v,
               layer: int, pos, n_head: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Column-mode self-attention block of layer ``layer`` at position
    ``pos``: (x_out, k_new, v_new); the cache is read, not written.

    ``pos`` is one int32 on x's device (shape (1,)), which the kernel
    reads when it runs, so a captured launch serves every step; an int
    is checked against the cache's T and copied there first. A tensor's
    range is the caller's to keep: the kernel clamps it to [0, T)."""
    what = "self_block"
    if not isinstance(pos, torch.Tensor):
        t_max = cache_k.shape[2] if cache_k.dim() == 4 else 0
        if not 0 <= int(pos) < t_max:
            raise ValueError(f"{what}: pos {pos} outside [0, {t_max})")
        pos = torch.tensor([int(pos)], dtype=torch.int32, device=x.device)
    tensors = (x, ln_s, ln_b, wqkv.q, wqkv.s, bqkv, wo.q, wo.s, bo, cache_k,
               cache_v, pos)
    if _build.on_cpu(what, *tensors):
        return self_block_plain(x, ln_s, ln_b, wqkv, bqkv, wo, bo, cache_k,
                                cache_v, layer, pos, n_head)
    n_layer = ln_s.shape[0]
    _check_common(what, x, n_layer, layer, n_head)
    r, d = x.shape
    dt = x.dtype
    for name, t, n in (("ln_s", ln_s, d), ("ln_b", ln_b, d),
                       ("bqkv", bqkv, 3 * d), ("bo", bo, d)):
        _expect(what, name, t, (n_layer, n), dt)
    _expect_int8(what, "wqkv", wqkv, n_layer, d, 3 * d)
    _expect_int8(what, "wo", wo, n_layer, d, d)
    t_cache = cache_k.shape[2] if cache_k.dim() == 4 else -1
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        _expect(what, name, t, (n_layer, r, t_cache, d), dt)
    if not 0 < t_cache <= _MAX_SELF_T:
        raise ValueError(f"{what}: T = {t_cache} outside (0, {_MAX_SELF_T}]")
    _expect(what, "pos", pos, (1,), torch.int32)
    x_out = torch.empty_like(x)
    k_new, v_new = torch.empty_like(x), torch.empty_like(x)
    if r == 0:
        return x_out, k_new, v_new
    work = _workspace(_SELF, r, d, 0, x.device)
    _build.launch(self_block, "self_block kernels", x.device, _SELF_BLOCK,
                  x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
                  wqkv.q.data_ptr(), wqkv.s.data_ptr(), bqkv.data_ptr(),
                  wo.q.data_ptr(), wo.s.data_ptr(), bo.data_ptr(),
                  cache_k.data_ptr(), cache_v.data_ptr(), x_out.data_ptr(),
                  k_new.data_ptr(), v_new.data_ptr(), work.data_ptr(),
                  pos.data_ptr(), int(layer), r, d, n_head, t_cache)
    _count(qgemv_ln=1, self_attention=1, qgemv=1)
    return x_out, k_new, v_new


def cross_block(x, ln_s, ln_b, cwq, cbq, cwo, cbo, ck, cv, k_scale, v_scale,
                layer: int, n_head: int) -> torch.Tensor:
    """Cross-attention block of layer ``layer`` over the int8 cross K/V
    (L, B, d, T) with scales (L, B, H); x (R, d) with R = B*g."""
    what = "cross_block"
    tensors = (x, ln_s, ln_b, cwq.q, cwq.s, cbq, cwo.q, cwo.s, cbo, ck, cv,
               k_scale, v_scale)
    if _build.on_cpu(what, *tensors):
        return cross_block_plain(x, ln_s, ln_b, cwq, cbq, cwo, cbo, ck, cv,
                                 k_scale, v_scale, layer, n_head)
    n_layer = ln_s.shape[0]
    _check_common(what, x, n_layer, layer, n_head)
    r, d = x.shape
    dt = x.dtype
    for name, t in (("ln_s", ln_s), ("ln_b", ln_b), ("cbq", cbq),
                    ("cbo", cbo)):
        _expect(what, name, t, (n_layer, d), dt)
    _expect_int8(what, "cwq", cwq, n_layer, d, d)
    _expect_int8(what, "cwo", cwo, n_layer, d, d)
    if ck.dim() != 4:
        raise ValueError(f"{what}: cross K must be (L, B, d, T), got "
                         f"{tuple(ck.shape)}")
    b, t = ck.shape[1], ck.shape[3]
    for name, kv in (("ck", ck), ("cv", cv)):
        _expect(what, name, kv, (n_layer, b, d, t), torch.int8)
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        _expect(what, name, s, (n_layer, b, n_head), torch.float32)
    if b == 0 or r % b:
        raise ValueError(f"{what}: {r} query rows not a multiple of the "
                         f"cross-K/V batch {b}")
    longest = max_t()
    if not 0 < t <= longest:
        raise ValueError(f"{what}: T = {t} outside (0, {longest}]")
    x_out = torch.empty_like(x)
    if r == 0:
        return x_out
    work = _workspace(_CROSS, r, d, 0, x.device)
    _build.launch(cross_block, "cross_block kernels", x.device, _CROSS_BLOCK,
                  x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
                  cwq.q.data_ptr(), cwq.s.data_ptr(), cbq.data_ptr(),
                  cwo.q.data_ptr(), cwo.s.data_ptr(), cbo.data_ptr(),
                  ck.data_ptr(), cv.data_ptr(), k_scale.data_ptr(),
                  v_scale.data_ptr(), x_out.data_ptr(), work.data_ptr(),
                  int(layer), r, b, d, n_head, t)
    _count(qgemv_ln=1, decode_cross_attention_terms=1, qgemv=1)
    return x_out


def mlp_block(x, ln_s, ln_b, w1, b1, w2, b2, layer: int) -> torch.Tensor:
    """GELU MLP block of layer ``layer``: x (R, d) -> x_out (R, d)."""
    what = "mlp_block"
    tensors = (x, ln_s, ln_b, w1.q, w1.s, b1, w2.q, w2.s, b2)
    if _build.on_cpu(what, *tensors):
        return mlp_block_plain(x, ln_s, ln_b, w1, b1, w2, b2, layer)
    n_layer = ln_s.shape[0]
    _check_common(what, x, n_layer, layer)
    r, d = x.shape
    hidden = b1.shape[-1]
    if hidden % 128:
        raise ValueError(f"{what}: the hidden width must be a multiple of "
                         f"128, got {hidden}")
    dt = x.dtype
    for name, t, n in (("ln_s", ln_s, d), ("ln_b", ln_b, d),
                       ("b1", b1, hidden), ("b2", b2, d)):
        _expect(what, name, t, (n_layer, n), dt)
    _expect_int8(what, "w1", w1, n_layer, d, hidden)
    _expect_int8(what, "w2", w2, n_layer, hidden, d)
    x_out = torch.empty_like(x)
    if r == 0:
        return x_out
    work = _workspace(_MLP, r, d, hidden, x.device)
    _build.launch(mlp_block, "mlp_block kernels", x.device, _MLP_BLOCK,
                  x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
                  w1.q.data_ptr(), w1.s.data_ptr(), b1.data_ptr(),
                  w2.q.data_ptr(), w2.s.data_ptr(), b2.data_ptr(),
                  x_out.data_ptr(), work.data_ptr(), int(layer), r, d,
                  hidden)
    _count(qgemv_ln=1, qgemv=1)
    return x_out


# launches of the kernels inside the blocks, by name
inner = {name: types.SimpleNamespace(launches=0)
         for name in ("qgemv_ln", "qgemv", "self_attention",
                      "decode_cross_attention_terms")}


def _count(**launches: int) -> None:
    for name, n in launches.items():
        _build.count(inner[name], n)

self_block.launches = 0
cross_block.launches = 0
mlp_block.launches = 0
