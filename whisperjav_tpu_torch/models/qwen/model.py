"""Qwen3-ASR in PyTorch: the AuT audio tower, the Qwen3 LM, generation.

Counterpart of ``whisperjav_tpu/models/qwen/model.py``. Parameters keep
the JAX tree's names and stacked layouts (per-layer leaves on a leading
axis, matrices (in, out), convolutions OIHW), so :mod:`weights` maps a
JAX tree one to one:

- audio tower (AuT): 128-mel chunks of ``chunk_frames`` frames, three
  3x3 stride-2 convolutions with GELU, ``conv_out`` into the tower width,
  sinusoid positions reset at every chunk, pre-LN blocks with
  bidirectional attention inside windows of ``window_tokens`` tokens,
  ``ln_post`` and the ``proj1``/GELU/``proj2`` adapter into the LM width;
- LM (Qwen3): RMSNorm, per-head q/k RMSNorm, NeoX half-split rotary
  embeddings, grouped-query attention (query head h reads KV group
  h // rep), SwiGLU MLP, a (L, B, T, n_kv * hd) cache;
- :func:`generate`: the audio prefix [+ context] + BOS, then greedy or
  Gumbel-max sampled steps with a repetition penalty;
  :func:`generate_text` the same steps after a text prompt alone (the
  local translation backend; a tree without ``audio`` serves it).

Int8 LM weights (:func:`quantize_lm_weights`) are the JAX tree's
``{"q": int8, "s": f32}`` leaves, held as :class:`Int8Weight`; their
products are taken in f32 and scaled, as the JAX package's ``_dense``.
The forward passes run in full f32 where the parameters are f32 (no
TF32, whatever the process-wide flags say). No Pallas kernel lies on
this path: the products are PyTorch matmuls. A decode step's attention
runs ``csrc/qwen_column_attention.cu`` on CUDA tensors
(``ops/cuda/qwen_attention.py``), a kernel the JAX package does not
need: XLA fuses the einsums that eager PyTorch would run as copies of
the whole cache. On CUDA each decode step's forward (:func:`step_forward`)
is a replay of a CUDA graph captured once a loop shape
(``step_graph.py``); the tower, the prefill and the token selection stay
eager.

Under a span the caller entered (``WJAV_TRACE_BATCHES=1``, see
``utils/tracer.py``; ``QwenGenerator.generate_batch`` enters its
``qwen.batch``), :func:`generate` records ``qwen.encode`` and
``qwen.prefill``, and :func:`_decode` records ``decode.loop`` (counters
``steps``, the forwards run, ``rows``, ``start``, the position of the
first generated token, ``kernel_layers``, the layer-steps whose
attention ran the hand-written kernel, ``graph_steps``, the steps whose
forward was a CUDA graph's replay, and ``captures``, the graphs captured
in the loop) with one ``decode.step`` a step and its children
``decode.stop_check`` (the every-8-steps wait for the flag),
``decode.select`` (penalty, token choice, log-softmax and bookkeeping)
and ``decode.forward`` (:func:`step_forward`: on CUDA a replay, and a
capture where one is made, see ``step_graph.py``; eager on the CPU). Each
of the three stages closes its span once the device has run it
(``Span.close_synced``), so the device trace puts each stage's device
work inside its span. Untraced, a phase costs one ``is None`` check.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from whisperjav_tpu_torch.models.layers import (
    Int8, Int8Weight, ParamTree, draw_gumbel, int8_matmul, layer_norm,
    quantize, sinusoid_positions,
)
from whisperjav_tpu_torch.models.qwen.step_graph import StepForward
from whisperjav_tpu_torch.ops.cuda import qwen_attention
from whisperjav_tpu_torch.utils import tracer
from whisperjav_tpu_torch.utils.precision import full_f32


@dataclass(frozen=True)
class QwenASRConfig:
    name: str = "qwen3-asr-test"
    # language model (Qwen3)
    vocab_size: int = 4096
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1024
    lm_head_dim: int = 0          # 0 -> d_model // n_heads
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    # audio tower (AuT)
    n_mels: int = 128
    d_audio: int = 256
    audio_layers: int = 4
    audio_heads: int = 8
    audio_ffn: int = 1024
    audio_downsample_hidden: int = 32
    n_window: int = 100           # mel frames per chunk = 2*n_window
    n_window_infer: int = 400     # mel frames per attention window
    # special ids
    eos_id: int = 2
    bos_id: int = 1
    # limits (reference: qwen_asr.py:215-216)
    max_audio_s_aligned: float = 180.0
    max_audio_s: float = 1200.0
    max_tokens_per_audio_second: float = 12.0
    min_token_budget: int = 48

    @property
    def head_dim(self) -> int:
        return self.lm_head_dim or self.d_model // self.n_heads

    @property
    def chunk_frames(self) -> int:
        """Mel frames per AuT chunk (2 s @ 10 ms hop)."""
        return 2 * self.n_window

    @property
    def chunk_tokens(self) -> int:
        """Audio tokens per chunk after the x8 conv downsampling."""
        t = self.chunk_frames
        for _ in range(3):
            t = (t + 1) // 2
        return t

    @property
    def window_tokens(self) -> int:
        """Tokens per attention window (block-diagonal)."""
        return self.chunk_tokens * (self.n_window_infer // self.chunk_frames)

    @property
    def mel_multiple(self) -> int:
        """Mel length must be a multiple of this (window tiling)."""
        return self.chunk_frames * (self.n_window_infer // self.chunk_frames)

    def audio_tokens_for(self, n_mel_frames: int) -> int:
        assert n_mel_frames % self.mel_multiple == 0, (
            f"mel length {n_mel_frames} not a multiple of "
            f"{self.mel_multiple}")
        return (n_mel_frames // self.chunk_frames) * self.chunk_tokens


# Published architecture shapes (Qwen3-ASR-1.7B = Qwen3-1.7B LM + AuT;
# the 0.6B row is the ForcedAligner-class LM scale); n_window=50
# (100-frame chunks -> 13 tokens), as in the JAX package.
QWEN_SIZES = {
    "qwen3-asr-0.6b": QwenASRConfig(
        name="qwen3-asr-0.6b", vocab_size=151_936, d_model=1024,
        n_layers=28, n_heads=16, n_kv_heads=8, d_ff=3072, lm_head_dim=128,
        d_audio=1280, audio_layers=32, audio_heads=20, audio_ffn=5120,
        audio_downsample_hidden=480, n_window=50),
    "qwen3-asr-1.7b": QwenASRConfig(
        name="qwen3-asr-1.7b", vocab_size=151_936, d_model=2048,
        n_layers=28, n_heads=16, n_kv_heads=8, d_ff=6144, lm_head_dim=128,
        d_audio=1280, audio_layers=32, audio_heads=20, audio_ffn=5120,
        audio_downsample_hidden=480, n_window=50),
    "qwen3-asr-test": QwenASRConfig(),
}


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


@functools.lru_cache(maxsize=16)
def rope_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """The rotary frequencies theta^(-i / half) (hd/2,) in f32 on
    ``device``, made once a width, base and device: their making copies
    theta from the host, which a captured step must not do. Never
    written."""
    half = hd // 2
    with torch.inference_mode(False):
        exps = -torch.arange(half, dtype=torch.float32, device=device) / half
        return torch.pow(torch.tensor(theta, dtype=torch.float32,
                                      device=device), exps)


def rope_angles(positions: torch.Tensor, hd: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin (T, 1, hd/2) of ``positions`` (T,), a tensor on the
    device: angles computed in f32 from :func:`rope_freqs`, as the JAX
    package."""
    freqs = rope_freqs(hd, theta, positions.device)
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """x (B, T, H, hd), GPT-NeoX half split."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """x (..., in) @ w (in, out) [+ b], accumulated in f32 and rounded
    once to x's dtype. An :class:`Int8` weight's product is
    :func:`int8_matmul`."""
    if isinstance(w, Int8):
        out = int8_matmul(x, w)
    else:
        out = torch.matmul(x, w.to(x.dtype)).float()
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class QwenASR(ParamTree):
    """Qwen3-ASR weights: ``audio`` (the AuT tower), ``tok_emb``,
    ``blocks`` (the LM layers), ``ln_f`` and ``lm_head`` (or its int8
    ``lm_head_q``), under the JAX package's names and layouts."""

    def __init__(self, config: QwenASRConfig, tree: Dict[str, object]):
        super().__init__(tree)
        self.config = config


def fuse_lm_qkv(model: QwenASR) -> QwenASR:
    """Concatenate the LM blocks' q/k/v projections into one stacked
    (L, d, q_dim + 2 kv_dim) ``wqkv``, in place (Qwen3 projections have no
    biases; each output column's sum is unchanged)."""
    blocks = model.blocks
    if "wqkv" in blocks:
        return model
    wq, wk, wv = blocks.pop("wq"), blocks.pop("wk"), blocks.pop("wv")
    blocks["wqkv"] = nn.Parameter(torch.cat([wq, wk, wv], dim=-1),
                                  requires_grad=False)
    return model


_LM_HOT = ("wqkv", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_lm_weights(model: QwenASR) -> QwenASR:
    """Symmetric per-output-channel int8 for the LM block matmuls and the
    lm head (``lm_head`` -> ``lm_head_q``), in place; codes and scales bit
    for bit those of the JAX package's eager ``quantize_lm_weights``
    (scale max|w| / 127 + 1e-12, rounding half to even). The token
    embedding, the norms and the audio tower stay as they are. Apply
    after :func:`fuse_lm_qkv`."""
    blocks = model.blocks
    for name in _LM_HOT:
        if name in blocks and not isinstance(blocks[name], Int8Weight):
            blocks[name] = Int8Weight(*quantize(blocks.pop(name)))
    if "lm_head" in model and "lm_head_q" not in model:
        model["lm_head_q"] = Int8Weight(*quantize(model.pop("lm_head")))
    return model


# ---------------------------------------------------------------------------
# audio tower (AuT)
# ---------------------------------------------------------------------------

def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v (B, T, H, hd) -> (B, T, H, hd): f32 logits of q·k / sqrt(hd)
    plus ``bias``, softmax in f32, weights cast to v's dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k).float()
    if bias is not None:
        logits = logits + bias
    a = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", a, v)


def _audio_block(x: torch.Tensor, p: ParamTree, i: int, n_heads: int
                 ) -> torch.Tensor:
    """x (N, W, d): bidirectional attention within each window row."""
    n, wlen, d = x.shape
    h = layer_norm(x, p["ln1_s"][i], p["ln1_b"][i])
    q = dense(h, p["wq"][i], p["bq"][i]).reshape(n, wlen, n_heads, -1)
    k = dense(h, p["wk"][i], p["bk"][i]).reshape(n, wlen, n_heads, -1)
    v = dense(h, p["wv"][i], p["bv"][i]).reshape(n, wlen, n_heads, -1)
    o = _attend(q, k, v).to(x.dtype)
    x = x + dense(o.reshape(n, wlen, d), p["wo"][i], p["bo"][i])
    h = layer_norm(x, p["ln2_s"][i], p["ln2_b"][i])
    return x + dense(F.gelu(dense(h, p["w1"][i], p["b1"][i])),
                     p["w2"][i], p["b2"][i])


def encode_audio(model: QwenASR, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, n_mels, T) -> audio embeddings (B, tokens, d_model).

    T must be a multiple of ``cfg.mel_multiple``; tokens = (T /
    chunk_frames) * chunk_tokens."""
    cfg = model.config
    a = model.audio
    b, m, t = mel.shape
    cf, ct = cfg.chunk_frames, cfg.chunk_tokens
    n_chunk = t // cf
    with full_f32():
        # (B, M, T) -> per-chunk images (B * n_chunk, 1, M, cf)
        x = mel.reshape(b, m, n_chunk, cf).permute(0, 2, 1, 3)
        x = x.reshape(b * n_chunk, 1, m, cf)
        for i in (1, 2, 3):
            x = F.gelu(F.conv2d(x, a[f"conv2d{i}_w"].to(x.dtype),
                                a[f"conv2d{i}_b"].to(x.dtype), stride=2,
                                padding=1))
        # (BN, C, F', ct) -> (BN, ct, C * F'), torch's permute + view
        bn, c, fq, tt = x.shape
        x = x.permute(0, 3, 1, 2).reshape(bn, tt, c * fq)
        x = dense(x, a["conv_out_w"])
        pos = torch.from_numpy(sinusoid_positions(ct, cfg.d_audio))
        x = x + pos.to(device=x.device, dtype=x.dtype)[None]
        # window rows: (B * n_windows, window_tokens, d_audio)
        wt = cfg.window_tokens
        n_win = (n_chunk * ct) // wt
        x = x.reshape(b * n_win, wt, cfg.d_audio)
        for i in range(cfg.audio_layers):
            x = _audio_block(x, a["blocks"], i, cfg.audio_heads)
        x = layer_norm(x, a["ln_post_s"], a["ln_post_b"])
        x = F.gelu(dense(x, a["proj1_w"], a["proj1_b"]))
        x = dense(x, a["proj2_w"], a["proj2_b"])
    return x.reshape(b, n_chunk * ct, cfg.d_model)


def mel_frames_for(cfg: QwenASRConfig, n_mel_frames: int) -> int:
    """Round a mel length up to the fixed-shape multiple."""
    mult = cfg.mel_multiple
    return ((n_mel_frames + mult - 1) // mult) * mult


# ---------------------------------------------------------------------------
# language model with KV cache
# ---------------------------------------------------------------------------

class LMCache(NamedTuple):
    """KV cache, (L, B, T_max, n_kv * hd) each, heads merged."""
    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def zeros(cfg: QwenASRConfig, b: int, t_max: int, dtype,
              device) -> "LMCache":
        shape = (cfg.n_layers, b, t_max, cfg.n_kv_heads * cfg.head_dim)
        return LMCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


def _lm_block(x, p: ParamTree, i: int, cache: LMCache, pos,
              cfg: QwenASRConfig, bias: Optional[torch.Tensor], cos, sin):
    """LM layer ``i`` at positions [pos, pos + q_len).

    A single position (q_len == 1; ``pos`` an int or one int32 on the
    device) goes through
    :func:`~whisperjav_tpu_torch.ops.cuda.qwen_attention.column_attention`,
    which attends over the cache's [0, pos) and the new key and writes
    the new K/V column at ``pos``. Otherwise the new K/V are written into
    the cache in place, then attended under the causal ``bias``. Query
    head h reads KV group h // rep in both forms."""
    b, q_len, d = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = nh // nkv
    h = rms_norm(x, p["ln1"][i], cfg.rms_eps)
    if "wqkv" in p:
        qd, kvd = nh * hd, nkv * hd
        qkv = dense(h, p["wqkv"][i])
        q, k, v = qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
    else:
        q, k, v = (dense(h, p[n][i]) for n in ("wq", "wk", "wv"))
    q = rope(rms_norm(q.reshape(b, q_len, nh, hd), p["q_norm"][i],
                      cfg.rms_eps), cos, sin)
    k = rope(rms_norm(k.reshape(b, q_len, nkv, hd), p["k_norm"][i],
                      cfg.rms_eps), cos, sin)
    if q_len == 1:
        o = qwen_attention.column_attention(
            q, cache.k, cache.v, i, pos, k.reshape(b, nkv * hd),
            v.reshape(b, nkv * hd))
    else:
        t_max = cache.k.shape[2]
        qg = (q * hd ** -0.5).reshape(b, q_len, nkv, rep, hd)
        cache.k[i, :, pos:pos + q_len] = k.reshape(b, q_len, nkv * hd)
        cache.v[i, :, pos:pos + q_len] = v
        kk = cache.k[i].to(q.dtype).reshape(b, t_max, nkv, hd)
        vv = cache.v[i].to(q.dtype).reshape(b, t_max, nkv, hd)
        lg = torch.einsum("bqgrd,bkgd->bgrqk", qg, kk).float() + bias
        a = torch.softmax(lg, dim=-1).to(q.dtype)
        o = torch.einsum("bgrqk,bkgd->bqgrd", a, vv).to(x.dtype)
    x = x + dense(o.reshape(b, q_len, nh * hd), p["wo"][i])
    h = rms_norm(x, p["ln2"][i], cfg.rms_eps)
    gate = F.silu(dense(h, p["w_gate"][i]))
    return x + dense(gate * dense(h, p["w_up"][i]), p["w_down"][i])


def lm_step(model: QwenASR, x_emb: torch.Tensor, pos,
            cache: LMCache) -> Tuple[torch.Tensor, LMCache]:
    """Embedded inputs (B, q_len, d) at [pos, pos + q_len) -> f32 logits
    (B, q_len, vocab); each layer writes its new K/V into the cache in
    place. ``pos`` is an int, or at q_len 1 one int32 on the device
    (shape (1,)): then nothing reads it on the host, and the step can be
    captured in a CUDA graph (:func:`step_forward`)."""
    cfg = model.config
    b, q_len, _ = x_emb.shape
    t_max = cache.k.shape[2]
    dev = x_emb.device
    bias = None
    if q_len > 1:
        k_idx = torch.arange(t_max, device=dev)
        q_idx = pos + torch.arange(q_len, device=dev)
        bias = torch.where(k_idx[None, :] <= q_idx[:, None], 0.0,
                           float("-inf"))
    cos, sin = rope_angles(pos + torch.arange(q_len, device=dev),
                           cfg.head_dim, cfg.rope_theta)
    blocks = model.blocks
    x = x_emb
    with full_f32():
        for i in range(cfg.n_layers):
            x = _lm_block(x, blocks, i, cache, pos, cfg, bias, cos, sin)
        x = rms_norm(x, model.ln_f, cfg.rms_eps)
        if "lm_head_q" in model:
            logits = int8_matmul(x, model.lm_head_q)
        else:
            logits = torch.matmul(x, model.lm_head.to(x.dtype)).float()
    return logits, cache


def step_forward(model: QwenASR, token: torch.Tensor, pos: torch.Tensor,
                 cache: LMCache) -> torch.Tensor:
    """The decode loop's forward: f32 logits (B, vocab) of ``token``
    (B,) at the position ``pos`` (one int32 on the device), its K/V
    column written into the cache. What a CUDA graph captures
    (``step_graph.StepForward``), from the embedding gather to the head."""
    logits, _ = lm_step(model, model.tok_emb[token[:, None]], pos, cache)
    return logits[:, 0]


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

class QwenGenResult(NamedTuple):
    tokens: torch.Tensor       # (B, max_new), eos-padded
    length: torch.Tensor
    avg_logprob: torch.Tensor


# steps between host checks of "every row finished": finished rows emit
# EOS and add nothing to length or sum_lp, so the extra steps after the
# last row finishes change no result; a check is a device sync
FINISHED_CHECK_EVERY = 8


def _decode(model, cur: torch.Tensor, cache: tuple, start: int,
            max_new: int, repetition_penalty: float, temperature: float,
            generator: Optional[torch.Generator],
            gumbel: Optional[Callable[[int], torch.Tensor]],
            step_fn: Callable = step_forward) -> QwenGenResult:
    """Up to ``max_new`` greedy (temperature 0) or sampled steps from the
    logits ``cur`` (B, vocab) of the prefix's last position; generated
    token i lands at cache position ``start + i``.

    The one decode loop of the port's LMs: ``step_fn(model, token, pos,
    cache)`` is the model's single-token forward (Qwen3's
    :func:`step_forward`, DeepSeek-V3's ``models/deepseek_v3/model.py:
    step_forward``) and ``cache`` its cache, a tuple of tensors (L, B,
    positions, ...) (:class:`LMCache`, or DeepSeek-V3's latent cache);
    ``model.config`` gives ``eos_id`` and ``vocab_size``.

    Sampling is ``argmax(logits + T * gumbel)`` with the noise of step i
    from ``gumbel(i)`` when given, else drawn from ``generator``. The
    repetition penalty divides positive and multiplies negative logits of
    every id emitted so far except EOS (the prefix is not "seen").
    Finished rows emit EOS; ``avg_logprob = sum_lp / (length + 1)``."""
    cfg = model.config
    sample = temperature != 0.0
    if sample and gumbel is None and generator is None:
        raise ValueError("sampling at temperature > 0 needs a generator "
                         "or a gumbel callable")
    b, dev = cur.shape[0], cur.device
    eos = cfg.eos_id
    tokens = torch.full((b, max_new), eos, dtype=torch.long, device=dev)
    sum_lp = torch.zeros((b,), device=dev)
    length = torch.zeros((b,), dtype=torch.long, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    penalize = repetition_penalty != 1.0
    # a tensor divisor: CUDA divides by a host scalar as a product with
    # its reciprocal, which can round one ulp apart from the division
    rp = torch.tensor(repetition_penalty, device=dev)
    # emitted-id membership, EOS never set
    seen = (torch.zeros((b, cfg.vocab_size), dtype=torch.bool, device=dev)
            if penalize else None)
    loop = tracer.child(tracer.current(), "decode.loop")
    launched = qwen_attention.column_attention.launches
    forward = StepForward(model, cache, step_fn)
    steps = 0
    for step in range(max_new):
        span = None if loop is None else loop.child("decode.step")
        if step and step % FINISHED_CHECK_EVERY == 0:
            done = bool(finished.all())
            if span is not None:
                span.lap("decode.stop_check")
                if done:
                    span.close()
            if done:
                break
        lg = cur
        if penalize:
            pen = torch.where(lg > 0, lg / rp, lg * rp)
            lg = torch.where(seen, pen, lg)
        if sample:
            noise = (gumbel(step) if gumbel is not None
                     else draw_gumbel(generator, lg.shape, dev))
            tok = torch.argmax(lg + temperature * noise.to(dev), dim=-1)
        else:
            tok = torch.argmax(lg, dim=-1)
        tok = torch.where(finished, eos, tok)
        lp = torch.log_softmax(lg, dim=-1)
        tok_lp = lp.gather(1, tok[:, None])[:, 0]
        is_eos = tok == eos
        sum_lp = sum_lp + torch.where(finished, 0.0, tok_lp)
        length = length + (~(finished | is_eos)).long()
        tokens[:, step] = tok
        if penalize:
            seen.scatter_(1, tok[:, None], True)
            seen[:, eos] = False
        if span is not None:
            span.lap("decode.select")
        cur = forward(tok, start + step)
        if span is not None:
            span.lap("decode.forward")
        finished = finished | is_eos
        steps += 1
        if span is not None:
            span.close()
    if loop is not None:
        loop.close_synced(dev, steps=steps, rows=b, start=start,
                          kernel_layers=qwen_attention.column_attention
                          .launches - launched,
                          graph_steps=forward.graph_steps,
                          captures=forward.captures)
    avg_lp = sum_lp / (length.float() + 1.0)
    return QwenGenResult(tokens, length, avg_lp)


@torch.inference_mode()
def generate(model: QwenASR, mel: torch.Tensor, max_new: int,
             audio_len: int, repetition_penalty: float = 1.1,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             gumbel: Optional[Callable[[int], torch.Tensor]] = None,
             ctx_ids: Optional[torch.Tensor] = None) -> QwenGenResult:
    """Transcribe mel windows: audio prefix [+ context] + BOS, then up to
    ``max_new`` greedy (temperature 0) or sampled steps (:func:`_decode`).

    audio_len: audio embedding positions kept as the LM prefix (at most
    ``cfg.audio_tokens_for(mel frames)``). ctx_ids: optional (1, L) or
    (B, L) context token ids between the audio prefix and BOS."""
    cfg = model.config
    b = mel.shape[0]
    dev = mel.device
    under = tracer.current()
    span = tracer.child(under, "qwen.encode")
    audio_emb = encode_audio(model, mel)[:, :audio_len]
    if span is not None:
        span.close_synced(dev)
        span = under.child("qwen.prefill")
    ctx_len = 0 if ctx_ids is None else ctx_ids.shape[-1]
    t_max = audio_len + ctx_len + 1 + max_new
    tok_emb = model.tok_emb
    cache = LMCache.zeros(cfg, b, t_max, tok_emb.dtype, dev)
    parts = [audio_emb]
    if ctx_ids is not None:
        ctx = torch.as_tensor(ctx_ids, device=dev).long().expand(b, ctx_len)
        parts.append(tok_emb[ctx].to(audio_emb.dtype))
    bos = torch.full((b, 1), cfg.bos_id, dtype=torch.long, device=dev)
    parts.append(tok_emb[bos].to(audio_emb.dtype))
    logits, cache = lm_step(model, torch.cat(parts, dim=1), 0, cache)
    if span is not None:
        span.close_synced(dev)
    return _decode(model, logits[:, -1], cache, audio_len + ctx_len + 1,
                   max_new, repetition_penalty, temperature, generator,
                   gumbel)


def prompt_of(prompt_ids, prompt_len, device) -> torch.Tensor:
    """The real prompt (B, n) of ``prompt_ids`` (B, L), right-padded past
    ``prompt_len`` (B,), which every row must share, on ``device``."""
    lens = torch.as_tensor(prompt_len).reshape(-1)
    n = int(lens[0])
    if not bool((lens == n).all()) or n < 1:
        raise ValueError(f"prompt lengths {lens.tolist()}: every row must "
                         "share one length of at least 1")
    return torch.as_tensor(prompt_ids, device=device).long()[:, :n]


@torch.inference_mode()
def generate_text(model: QwenASR, prompt_ids, prompt_len, max_new: int,
                  repetition_penalty: float = 1.0, temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  gumbel: Optional[Callable[[int], torch.Tensor]] = None
                  ) -> QwenGenResult:
    """LM-only generation (no audio tower): the local translation
    backend's decode loop (``models/qwen/model.py:generate_text`` of the
    JAX package).

    prompt_ids: (B, L) prompt ids, right-padded past ``prompt_len`` (B,),
    which every row shares (callers pass B=1). Only the real prompt is
    prefilled: the JAX package pads it to a bucket to bound its
    compiles, which changes no result, and eager PyTorch compiles
    nothing. Then up to ``max_new`` steps as :func:`_decode`; tokens are
    EOS-padded to ``max_new`` and ``length`` excludes the EOS."""
    tok_emb = model.tok_emb
    ids = prompt_of(prompt_ids, prompt_len, tok_emb.device)
    n = ids.shape[1]
    cache = LMCache.zeros(model.config, ids.shape[0], n + max_new,
                          tok_emb.dtype, tok_emb.device)
    logits, cache = lm_step(model, tok_emb[ids], 0, cache)
    return _decode(model, logits[:, -1], cache, n, max_new,
                   repetition_penalty, temperature, generator, gumbel)


def token_budget(cfg: QwenASRConfig, audio_seconds: float) -> int:
    """Dynamic max-token budget with floor (reference: qwen_asr.py:414,
    236-238)."""
    return max(cfg.min_token_budget,
               int(audio_seconds * cfg.max_tokens_per_audio_second))
