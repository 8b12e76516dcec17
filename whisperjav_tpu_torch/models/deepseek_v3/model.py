"""The DeepSeek-V3 block in PyTorch: the translator's ``tpu-local`` LM for
Kanana-2-30B-A3B (``model_type`` ``deepseek_v3``), whole on one card.

Layer i computes ``x += MLA(rms(x))``, then ``x += FFN_i(rms(x))``; the
model ends with ``rms`` and the head (Hugging Face's
``DeepseekV3ForCausalLM``):

- latent attention (MLA) without q LoRA: ``q = h W_q`` (heads of
  ``qk_nope_dim + qk_rope_dim``), ``[c~, k_pe] = h W_kva``, ``c =
  rms_kv(c~)``, ``[k_nope, v] = c W_kvb``; rotary embeddings with
  ``theta`` on ``q_pe`` and the one shared ``k_pe`` over interleaved
  pairs (HF's ``apply_rotary_pos_emb_interleave``: the pairs
  de-interleaved into halves, then the half split); causal softmax of
  ``(q_nope k_nope + q_pe k_pe) / sqrt(qk_head_dim)``, times ``v``, then
  ``W_o``;
- the leading ``first_dense`` layers a SwiGLU of width ``d_ff``; every
  other layer ``experts_per_token`` of ``n_routed_experts`` SwiGLU
  experts of width ``moe_d_ff``, routed by ``s = sigmoid(h W_r)`` in f32:
  the ids are the top of ``s + bias`` (the correction bias, for the
  choice only, ``noaux_tc`` with one group), their weights ``s[ids] /
  (sum + 1e-20) * routed_scale``; plus the shared experts, one SwiGLU of
  width ``n_shared_experts * moe_d_ff``.

The cache (:class:`LatentCache`) holds, a layer and a position, the
normed latent ``c`` and the roped ``k_pe``: ``kv_lora_rank +
qk_rope_dim`` values (576 at Kanana's widths). The prefill
(:func:`prefill`) runs the full form, expanding its own positions into
K and V, groups its tokens by expert (a host sync a layer) and takes the
head at the last position only. A decode step (:func:`step_forward`)
runs the absorbed form and never expands a past position:
``q_lat = q_nope W_kvb,k^T``, scores ``q_lat c_t + q_pe k_pe_t`` over the
whole cache under a mask from the device-held position, ``o = (sum_t a_t
c_t) W_kvb,v``; its expert layer gathers the codes and scales of the
chosen experts alone on the device. Nothing in a step reads the device
on the host, so the shared decode loop (``models/qwen/model.py:
_decode``) replays it from a CUDA graph (``models/qwen/step_graph.py``)
as it does Qwen3's.

Serve precision: every matrix (attention, experts, shared, dense, head)
int8 per output channel (``layers.quantize``), its products taken in f32
and scaled (``layers.int8_matmul``; the absorbed products in the same
way, per head); the router, the correction bias, the norms, the
embedding and the cache in the embedding's type (f32 as loaded); TF32
off (``full_f32``). :func:`place` quantises each matrix as it moves to
the device, a layer at a time, so the model never exists in f32 whole
(30.7 B parameters at Kanana's widths: 31 GB in int8).

:func:`generate_text` prefills under ``lm.prefill`` (counters
``routed_max`` and ``routed_mean``: the most and the mean token rows
one expert received, over the prefill's expert layers, experts that
received none left out of the mean; closed after a sync) and enters the
shared loop, with its ``decode.loop`` and ``decode.step`` spans.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from whisperjav_tpu_torch.models import layers
from whisperjav_tpu_torch.models.layers import Int8, Int8Weight, ParamTree
from whisperjav_tpu_torch.models.qwen import model as qwen_model
from whisperjav_tpu_torch.models.qwen.model import (
    QwenGenResult, dense, rms_norm, rope, rope_angles,
)
from whisperjav_tpu_torch.utils import tracer
from whisperjav_tpu_torch.utils.precision import full_f32


@dataclass(frozen=True)
class DeepseekV3Config:
    name: str = "deepseek-v3-test"
    vocab_size: int = 512
    d_model: int = 64
    n_layers: int = 3
    n_heads: int = 4
    qk_nope_dim: int = 16
    qk_rope_dim: int = 8
    v_head_dim: int = 16
    kv_lora_rank: int = 32
    d_ff: int = 128                 # the leading dense layers' SwiGLU
    moe_d_ff: int = 32              # one routed expert's SwiGLU
    n_routed_experts: int = 8
    n_shared_experts: int = 2
    experts_per_token: int = 3
    first_dense: int = 1
    routed_scale: float = 2.448
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    eos_id: int = 1
    bos_id: int = 0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def latent_dim(self) -> int:
        """Cached values a layer and a position: ``c`` and ``k_pe``."""
        return self.kv_lora_rank + self.qk_rope_dim

    @property
    def n_moe(self) -> int:
        return self.n_layers - self.first_dense

    @property
    def shared_d_ff(self) -> int:
        return self.n_shared_experts * self.moe_d_ff


# Kanana-2-30B-A3B (https://huggingface.co/kakaocorp/
# kanana-2-30b-a3b-instruct-2601/blob/main/config.json); the special ids
# are not in its config.json (the Llama-3 vocabulary's, unchecked)
DSV3_SIZES = {
    "kanana-2-30b-a3b": DeepseekV3Config(
        name="kanana-2-30b-a3b", vocab_size=128_256, d_model=2048,
        n_layers=48, n_heads=32, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128, kv_lora_rank=512, d_ff=6144, moe_d_ff=768,
        n_routed_experts=128, n_shared_experts=2, experts_per_token=6,
        first_dense=1, routed_scale=2.448, eos_id=128_001, bos_id=128_000),
    "deepseek-v3-test": DeepseekV3Config(),
}

# the decode cache's length is rounded up to this many positions, so
# prompts of nearby lengths share one captured step
CACHE_MULTIPLE = 256


def cache_positions(prompt: int, max_new: int) -> int:
    """The latent cache's length for a prompt of ``prompt`` tokens and
    ``max_new`` new ones: their sum rounded up to ``CACHE_MULTIPLE``."""
    return -(-(prompt + max_new) // CACHE_MULTIPLE) * CACHE_MULTIPLE


class DeepseekV3(ParamTree):
    """The weights: ``tok_emb``, ``blocks`` (every layer's norms and
    attention, stacked over layers), ``dense`` (the leading dense
    layers' SwiGLU), ``moe`` (router, correction bias, routed experts
    stacked (layers, experts, in, out), shared experts; over the expert
    layers), ``ln_f`` and the int8 head ``lm_head_q``. Matrices are
    (in, out) :class:`Int8Weight`; gate and up projections are one
    matrix (``w_gu``, ``shared_gu``), the gate's columns first."""

    def __init__(self, config: DeepseekV3Config, tree: Dict[str, object]):
        super().__init__(tree)
        self.config = config


class LatentCache(NamedTuple):
    """The latent cache (L, B, T_max, kv_lora_rank + qk_rope_dim): the
    normed ``c``, then the roped ``k_pe``."""
    ckv: torch.Tensor

    @staticmethod
    def zeros(cfg: DeepseekV3Config, b: int, t_max: int, dtype,
              device) -> "LatentCache":
        return LatentCache(torch.zeros(
            (cfg.n_layers, b, t_max, cfg.latent_dim), dtype=dtype,
            device=device))


# ---------------------------------------------------------------------------
# placing the weights
# ---------------------------------------------------------------------------

# the leaves of a source's layer (``source.layer(i)``) that are
# attention's and norms', and the stacked leaves that hold int8 codes
_ATTN = ("ln1", "wq", "wkva", "kv_norm", "wkvb", "wo", "ln2")
_INT8 = {"wq", "wkva", "wkvb", "wo", "w_gu", "w_down", "shared_gu",
         "shared_down"}
# a gate and an up matrix go into one: (its leaf, which half)
_FUSED = {"w_gate": ("w_gu", 0), "w_up": ("w_gu", 1),
          "shared_gate": ("shared_gu", 0), "shared_up": ("shared_gu", 1)}


def _shapes(cfg: DeepseekV3Config) -> Dict[str, Dict[str, tuple]]:
    """Each stacked leaf's shape, by group (matrices (in, out))."""
    L, Ld, Lm = cfg.n_layers, cfg.first_dense, cfg.n_moe
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    E, f, fs = cfg.n_routed_experts, cfg.moe_d_ff, cfg.shared_d_ff
    return {
        "blocks": {"ln1": (L, d), "wq": (L, d, H * cfg.qk_head_dim),
                   "wkva": (L, d, cfg.latent_dim), "kv_norm": (L, r),
                   "wkvb": (L, r, H * (cfg.qk_nope_dim + cfg.v_head_dim)),
                   "wo": (L, H * cfg.v_head_dim, d), "ln2": (L, d)},
        "dense": {"w_gu": (Ld, d, 2 * cfg.d_ff), "w_down": (Ld, cfg.d_ff, d)},
        "moe": {"router": (Lm, d, E), "bias": (Lm, E),
                "w_gu": (Lm, E, d, 2 * f), "w_down": (Lm, E, f, d),
                "shared_gu": (Lm, d, 2 * fs), "shared_down": (Lm, fs, d)},
    }


def place(cfg: DeepseekV3Config, source, device) -> DeepseekV3:
    """The model on ``device`` from ``source``, a layer at a time: each
    matrix taken to f32 on the device, quantised (``layers.quantize``)
    and written into its slot of the stacked int8 codes and f32 scales,
    before the next is read. ``source.top()`` gives ``tok_emb`` (V, d),
    ``ln_f`` and ``lm_head`` (d, V); ``source.layer(i)`` layer i's
    ``ln1``, ``wq``, ``wkva``, ``kv_norm``, ``wkvb``, ``wo``, ``ln2`` and
    either ``w_gate``, ``w_up``, ``w_down`` (a dense layer) or
    ``router``, ``bias``, ``w_gate``, ``w_up``, ``w_down`` (experts
    stacked first) and ``shared_gate``, ``shared_up``, ``shared_down``.
    The leaves that are not quantised keep the type the source gives
    them (the embedding's, for the stacked ones)."""
    dev = torch.device(device)
    top = source.top()
    dtype = top["tok_emb"].dtype
    groups = {}
    for group, shapes in _shapes(cfg).items():
        groups[group] = {}
        for name, shape in shapes.items():
            if name in _INT8:
                groups[group][name] = Int8Weight(
                    torch.empty(shape, dtype=torch.int8, device=dev),
                    torch.empty(shape[:-2] + (1, shape[-1]),
                                dtype=torch.float32, device=dev))
            else:
                groups[group][name] = torch.empty(shape, dtype=dtype,
                                                  device=dev)
    for i in range(cfg.n_layers):
        moe = i >= cfg.first_dense
        j = i - cfg.first_dense if moe else i
        for name, value in source.layer(i).items():
            leaf, half = _FUSED.get(name, (name, None))
            if name in _ATTN:
                slot, at = groups["blocks"][leaf], i
            else:
                slot, at = groups["moe" if moe else "dense"][leaf], j
            if not isinstance(slot, Int8Weight):
                slot[at].copy_(value)
                continue
            q, s = layers.quantize(value.to(dev, torch.float32))
            if half is None:
                slot.q[at].copy_(q)
                slot.s[at].copy_(s)
            else:
                n = q.shape[-1]
                cols = slice(half * n, (half + 1) * n)
                slot.q[at][..., cols].copy_(q)
                slot.s[at][..., cols].copy_(s)
            del q, s
    tree = {"tok_emb": top["tok_emb"].to(dev), "ln_f": top["ln_f"].to(dev),
            "lm_head_q": Int8Weight(*layers.quantize(
                top["lm_head"].to(dev, torch.float32))),
            **groups}
    return DeepseekV3(cfg, tree)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                     ) -> torch.Tensor:
    """x (B, T, H, dr) with interleaved pairs (2i, 2i + 1), as HF's
    ``apply_rotary_pos_emb_interleave``: de-interleaved into halves
    (evens, then odds), then rotated as GPT-NeoX halves; the result stays
    in the de-interleaved order (q and k alike, so their products are
    those of the interleaved rotation)."""
    x = x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    return rope(x, cos, sin)


def _mla_prefill(h, p: ParamTree, i: int, cache: LatentCache,
                 cfg: DeepseekV3Config, cos, sin, bias) -> torch.Tensor:
    """Layer ``i``'s attention in the full form over positions [0, T):
    the latent columns written into the cache, K and V expanded for
    these positions only."""
    b, t, _ = h.shape
    H, dn, r = cfg.n_heads, cfg.qk_nope_dim, cfg.kv_lora_rank
    q = dense(h, p["wq"][i]).reshape(b, t, H, cfg.qk_head_dim)
    q_nope, q_pe = q[..., :dn], rope_interleaved(q[..., dn:], cos, sin)
    kva = dense(h, p["wkva"][i])
    c = rms_norm(kva[..., :r], p["kv_norm"][i], cfg.rms_eps)
    k_pe = rope_interleaved(kva[..., None, r:], cos, sin)[:, :, 0]
    cache.ckv[i, :, :t] = torch.cat([c, k_pe], dim=-1)
    kv = dense(c, p["wkvb"][i]).reshape(b, t, H, dn + cfg.v_head_dim)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    lg = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
          + torch.einsum("bqhd,bkd->bhqk", q_pe, k_pe)).float()
    lg = lg * cfg.qk_head_dim ** -0.5 + bias
    a = torch.softmax(lg, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v)
    return dense(o.reshape(b, t, H * cfg.v_head_dim), p["wo"][i])


def _mla_step(h, p: ParamTree, i: int, cache: LatentCache, pos,
              cfg: DeepseekV3Config, cos, sin) -> torch.Tensor:
    """Layer ``i``'s attention for one position ``pos`` (one int32 on the
    device) in the absorbed form: the new latent column written at
    ``pos``, then scores over the whole cache, positions past ``pos``
    masked, against ``q_nope`` taken into the latent space."""
    b = h.shape[0]
    H, dn, r = cfg.n_heads, cfg.qk_nope_dim, cfg.kv_lora_rank
    q = dense(h, p["wq"][i]).reshape(b, 1, H, cfg.qk_head_dim)
    q_nope = q[:, 0, :, :dn]
    q_pe = rope_interleaved(q[..., dn:], cos, sin)[:, 0]
    kva = dense(h, p["wkva"][i])[:, 0]
    c = rms_norm(kva[:, :r], p["kv_norm"][i], cfg.rms_eps)
    k_pe = rope_interleaved(kva[:, None, None, r:], cos, sin)[:, 0, 0]
    ckv = cache.ckv[i]
    ckv.index_copy_(1, pos.long(), torch.cat([c, k_pe], -1)[:, None]
                    .to(ckv.dtype))
    # W_kvb's codes (r, H, dn + dv) and scales (H, dn + dv): the scales
    # of k_nope's columns go onto q_nope, those of v's onto the output
    w = p["wkvb"][i]
    codes = w.q.view(r, H, dn + cfg.v_head_dim)
    scales = w.s.view(H, dn + cfg.v_head_dim)
    q_lat = torch.einsum("bhi,jhi->bhj", q_nope.float() * scales[:, :dn],
                         codes[..., :dn].float())
    lat = ckv.float()
    lg = torch.einsum("bhc,btc->bht", torch.cat([q_lat, q_pe.float()], -1),
                      lat) * cfg.qk_head_dim ** -0.5
    t_max = ckv.shape[1]
    lg = lg.masked_fill(torch.arange(t_max, device=lg.device) > pos,
                        float("-inf"))
    a = torch.softmax(lg, dim=-1)
    ctx = torch.einsum("bht,btj->bhj", a, lat[..., :r])
    o = torch.einsum("bhj,jhi->bhi", ctx, codes[..., dn:].float()) \
        * scales[:, dn:]
    return dense(o.reshape(b, 1, H * cfg.v_head_dim).to(h.dtype),
                 p["wo"][i])


def _swiglu(x, gu: Int8, down: Int8) -> torch.Tensor:
    """``W_down(silu(W_gate x) * W_up x)``, gate and up one matrix."""
    g = dense(x, gu)
    f = g.shape[-1] // 2
    return dense(F.silu(g[..., :f]) * g[..., f:], down)


def route(x: torch.Tensor, p: ParamTree, j: int, cfg: DeepseekV3Config
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert layer ``j``'s choice for rows x (N, d): (ids (N, k), their
    weights (N, k) f32). The correction bias moves the choice only."""
    s = torch.sigmoid(torch.matmul(x.float(), p["router"][j].float()))
    ids = torch.topk(s + p["bias"][j].float(), cfg.experts_per_token,
                     dim=-1).indices
    w = s.gather(1, ids)
    return ids, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale


def _experts_gathered(x, ids, w, p: ParamTree, j: int) -> torch.Tensor:
    """The routed experts' sum for rows x (N, d), reading the codes and
    scales of the chosen experts alone (a gather on the device)."""
    n, k = ids.shape
    flat = ids.reshape(-1)
    gu = Int8(*(t[flat] for t in p["w_gu"][j]))
    down = Int8(*(t[flat] for t in p["w_down"][j]))
    y = _swiglu(x.repeat_interleave(k, dim=0)[:, None], gu, down)[:, 0]
    return (y.view(n, k, -1).float() * w[..., None]).sum(1)


def _experts_grouped(x, ids, w, p: ParamTree, j: int, n_experts: int
                     ) -> Tuple[torch.Tensor, list]:
    """The routed experts' sum for rows x (N, d), the rows grouped by
    expert (the counts read on the host): (the sum, rows an expert)."""
    k = ids.shape[1]
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_experts).tolist()
    rows, wf = order // k, w.reshape(-1)[order]
    gu, down = p["w_gu"][j], p["w_down"][j]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        if n:
            sel = rows[start:start + n]
            y = _swiglu(x[sel], Int8(gu.q[e], gu.s[e]),
                        Int8(down.q[e], down.s[e]))
            out.index_add_(0, sel, y.float() * wf[start:start + n, None])
        start += n
    return out, counts


def _moe(h, p: ParamTree, j: int, cfg: DeepseekV3Config, grouped: bool,
         routed: list) -> torch.Tensor:
    """Expert layer ``j``: the routed experts' weighted sum plus the
    shared experts; ``grouped`` (the prefill) groups rows by expert and
    appends the counts to ``routed``."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    ids, w = route(x, p, j, cfg)
    if grouped:
        y, counts = _experts_grouped(x, ids, w, p, j, cfg.n_routed_experts)
        routed.append(counts)
    else:
        y = _experts_gathered(x, ids, w, p, j)
    y = y.to(x.dtype) + _swiglu(x, p["shared_gu"][j], p["shared_down"][j])
    return y.reshape(shape)


def _layers(model: DeepseekV3, x, cache: LatentCache, pos, cos, sin,
            bias=None, routed=None) -> torch.Tensor:
    """Every layer over x (B, T, d): the prefill's full form at [0, T)
    where ``bias`` (the causal mask) is given, else one step at ``pos``."""
    cfg = model.config
    blocks = model.blocks
    for i in range(cfg.n_layers):
        h = rms_norm(x, blocks["ln1"][i], cfg.rms_eps)
        if bias is not None:
            x = x + _mla_prefill(h, blocks, i, cache, cfg, cos, sin, bias)
        else:
            x = x + _mla_step(h, blocks, i, cache, pos, cfg, cos, sin)
        h = rms_norm(x, blocks["ln2"][i], cfg.rms_eps)
        if i < cfg.first_dense:
            d = model.dense
            x = x + _swiglu(h, d["w_gu"][i], d["w_down"][i])
        else:
            x = x + _moe(h, model.moe, i - cfg.first_dense, cfg,
                         bias is not None, routed)
    return x


def _head(model: DeepseekV3, x) -> torch.Tensor:
    x = rms_norm(x, model.ln_f, model.config.rms_eps)
    return layers.int8_matmul(x, model.lm_head_q)


def prefill(model: DeepseekV3, x_emb: torch.Tensor, cache: LatentCache
            ) -> Tuple[torch.Tensor, list]:
    """Embedded prompts (B, T, d) at [0, T) -> (f32 logits (B, vocab) of
    the last position, each expert layer's rows an expert); every
    layer's latent columns written into the cache."""
    cfg = model.config
    t, dev = x_emb.shape[1], x_emb.device
    idx = torch.arange(t, device=dev)
    bias = torch.where(idx[None, :] <= idx[:, None], 0.0, float("-inf"))
    cos, sin = rope_angles(idx, cfg.qk_rope_dim, cfg.rope_theta)
    routed: list = []
    with full_f32():
        x = _layers(model, x_emb, cache, 0, cos, sin, bias, routed)
        logits = _head(model, x[:, -1])
    return logits, routed


def step_forward(model: DeepseekV3, token: torch.Tensor, pos: torch.Tensor,
                 cache: LatentCache) -> torch.Tensor:
    """The decode loop's forward: f32 logits (B, vocab) of ``token`` (B,)
    at ``pos`` (one int32 on the device), its latent column written into
    the cache. What a CUDA graph captures (``step_graph.StepForward``)."""
    cfg = model.config
    x = model.tok_emb[token[:, None]]
    cos, sin = rope_angles(pos + torch.arange(1, device=x.device),
                           cfg.qk_rope_dim, cfg.rope_theta)
    with full_f32():
        x = _layers(model, x, cache, pos, cos, sin)
        return _head(model, x[:, 0])


def routed_counters(routed: list) -> dict:
    """``routed_max`` and ``routed_mean`` of the prefill's rows an expert
    (experts that received none left out of the mean)."""
    got = [n for counts in routed for n in counts if n]
    if not got:
        return {}
    return {"routed_max": max(got), "routed_mean": sum(got) / len(got)}


@torch.inference_mode()
def generate_text(model: DeepseekV3, prompt_ids, prompt_len, max_new: int,
                  repetition_penalty: float = 1.0, temperature: float = 0.0,
                  generator=None, gumbel=None,
                  cache_len: Optional[int] = None) -> QwenGenResult:
    """Qwen's ``generate_text`` for this family: the prompt ``prompt_ids``
    (B, L), right-padded past ``prompt_len`` (B,), which every row shares,
    prefilled (:func:`prefill`), then up to ``max_new`` steps of the
    shared loop (``models/qwen/model.py:_decode``) over a latent cache of
    ``cache_len`` positions, by default the prompt's and ``max_new``
    rounded up to ``CACHE_MULTIPLE``. A warm-up passes the length a
    longer answer will reach, to capture its step on a short budget."""
    dev = model.tok_emb.device
    ids = qwen_model.prompt_of(prompt_ids, prompt_len, dev)
    n = ids.shape[1]
    t_max = cache_len or cache_positions(n, max_new)
    if t_max < n + max_new:
        raise ValueError(f"a cache of {t_max} positions cannot hold {n} "
                         f"prompt and {max_new} new tokens")
    cache = LatentCache.zeros(model.config, ids.shape[0], t_max,
                              model.tok_emb.dtype, dev)
    span = tracer.child(tracer.current(), "lm.prefill")
    logits, routed = prefill(model, model.tok_emb[ids], cache)
    if span is not None:
        span.close_synced(dev, **routed_counters(routed))
    return qwen_model._decode(model, logits, cache, n, max_new,
                              repetition_penalty, temperature, generator,
                              gumbel, step_fn=step_forward)
