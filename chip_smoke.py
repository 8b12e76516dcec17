"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py                 # every phase, as below
    python3 chip_smoke.py --only kernels  # a subset: kernels, reference,
                                          # turbo, large-v2 (comma list)

Phases, in order; any failure exits non-zero before the result line:

1. card and build: the card's name and power limit (nvidia-smi), torch
   and CUDA versions, and the build of every CUDA kernel from
   ``whisperjav_tpu_torch/csrc/`` (one nvcc per source, in parallel;
   seconds and ptxas report);
2. each kernel against its plain PyTorch version at the shapes the main
   paths give it, with the error against a stated tolerance and the
   median device time per call of kernel and plain version (CUDA events
   around back-to-back calls held behind a spin kernel, so host time
   does not count; the fused blocks also print one call's wall): Kernel
   A (encoder attention), Kernel B (int8 decode cross-attention, L=32 at
   layer 31), and the three fused decode blocks at large-v2 widths
   (self, cross with the fold g = 1, 2 at T = 448/960/1500, MLP);
3. small-input references: a narrow Whisper (hd = 64, so the kernels
   run) encodes and decodes on the GPU in bf16 and on the CPU in f32 (the
   plain versions) from the same seed, once with bf16 decoder weights and
   once with int8 decoder weights (single steps through the fused
   blocks); the logits must agree;
4. the flagless path: a synthetic ~120 s clip through
   ``whisperjav_tpu_torch.cli.main`` with flagless defaults (balanced
   mode and sensitivity, turbo at full width from a seeded random init,
   batch 32, beam 2, temperature ladder, int8 cross-K/V, bf16), then a
   breakdown of one B=32 batch (encode, the beam rung, one sampled
   best-of-2 rung);
5. the int8 path: a synthetic ~60 s clip through ``cli.main`` with
   ``--model large-v2 --int8-weights`` (the same balanced defaults at
   large-v2 full width and depth), then a greedy large-v2 breakdown: one
   B=64 batch of 30 s windows, 128 new tokens.

Before each CLI run every kernel's launch count is zeroed, and read just
after it; the SRT and metadata must exist and parse, and every kernel
of that path must have launched (A and B on the flagless path; A, B and
the three fused blocks on the int8 path). The last two lines of standard
output are the kernels' JSON record and ``{"ok": true, "device":
{...}}``. Exits with an error, and prints no result, where no CUDA GPU
is visible.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch

SR = 16000
# Kernel A: bf16 output; probabilities and output round to bf16 at other
# points than in the plain version -> two bf16 steps at the largest
# output magnitude, and a small mean.
A_TOL_REL_MAX = 1.0 / 64
A_TOL_MEAN = 2e-3
# Kernel B: f32 both sides, sums over T in a different order.
B_TOL_REL_MAX = 2e-5
# Fused blocks: bf16 outputs of an f32 chain summed in other orders ->
# one bf16 step at the output's largest magnitude (k/v columns: at theirs).
FUSED_TOL_STEPS = 1.0
# Small references: GPU bf16 vs CPU f32 logits, relative to their scale.
REF_TOL_REL = 0.05
# large-v2 at full width: 80 mels, d = 1280, 20 heads x 64, 32 + 32
# layers; the self cache holds the 3-token prompt and 224 new tokens
LV2_D, LV2_H, LV2_L, SELF_T = 1280, 20, 32, 3 + 224


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int, warmup: int = 2, repeats: int = 3) -> float:
    """Device milliseconds per call of ``fn``, the median of ``repeats``
    batches: in each, the stream is held by a spin kernel while ``iters``
    calls are enqueued behind it, then they run back to back between two
    CUDA events, so host time (Python checks, launches) is not counted.
    The spin is lengthened until it outlasts the enqueueing."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles, times, host_gaps = 10_000_000, [], False
    while len(times) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t_spin = torch.cuda.Event(enable_timing=True)
        t_spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if t_spin.elapsed_time(start) > host_ms or cycles >= 4 ** 4 * 10 ** 7:
            host_gaps |= t_spin.elapsed_time(start) <= host_ms
            times.append(start.elapsed_time(end) / iters)
        else:
            cycles *= 4
    if host_gaps:
        log("  (device_ms: a spin did not outlast the enqueueing; this time "
            "includes host gaps)")
    return statistics.median(times)


def call_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median wall milliseconds of one call from enqueue to completion
    (host checks and launches included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_encoder_attention(dev, gen):
    from whisperjav_tpu_torch.ops.cuda.encoder_attention import (
        attention, encoder_attention,
    )
    shape = (32, 1500, 20, 64)            # turbo encoder, B=32
    q, k = ((torch.randn(shape, generator=gen, device=dev) * 3).bfloat16()
            for _ in range(2))
    v = torch.randn(shape, generator=gen, device=dev).bfloat16()
    out = encoder_attention(q, k, v).float()
    ref = attention(q, k, v).float()
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError("encoder_attention: non-finite output")
    err = (out - ref).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    tol = A_TOL_REL_MAX * ref.abs().max().item()
    log(f"kernel A encoder_attention {shape} bf16: max_abs_err {max_err:.6g} "
        f"(tol {tol:.6g}) mean_abs_err {mean_err:.6g} (tol {A_TOL_MEAN})")
    if max_err > tol or mean_err > A_TOL_MEAN:
        raise RuntimeError("encoder_attention disagrees with its plain "
                           "version")
    del out, ref, err
    ms = device_ms(lambda: encoder_attention(q, k, v), iters=20)
    plain_ms = device_ms(lambda: attention(q, k, v), iters=5)
    flop = 4 * 32 * 20 * 1500 * 1500 * 64
    log(f"kernel A per layer: {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s), "
        f"plain {plain_ms:.4f} ms")
    return {"name": "encoder_attention", "route": "cuda",
            "source": "whisperjav_tpu_torch/csrc/encoder_attention.cu",
            "replaces": "whisperjav_tpu/ops/pallas/attention.py:52",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def check_decode_attention(dev, gen, prompt_len: int):
    from whisperjav_tpu_torch.ops.cuda.decode_attention import (
        decode_cross_attention, decode_cross_attention_plain,
    )
    # large-v2's 32 decoder layers at B=32, read at the last layer (turbo
    # has 4 of the same width)
    n_layer, b, h, hd, layer = LV2_L, 32, 20, 64, LV2_L - 1
    worst = 0.0
    timed = {}
    for t in (448, 960, 1500):
        k8, v8 = (torch.randint(-127, 128, (n_layer, b, h, hd, t),
                                generator=gen, device=dev, dtype=torch.int8)
                  for _ in range(2))
        # sampled rung: step and prefill; beam-2 rung: step and prefill
        for rows in (1, prompt_len, 2, 2 * prompt_len):
            q = torch.randn(b, rows, h, hd, generator=gen, device=dev) * 0.01
            out = decode_cross_attention(q, k8, v8, layer)
            ref = decode_cross_attention_plain(q, k8, v8, layer)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise RuntimeError("decode_cross_attention: non-finite")
            max_err = (out - ref).abs().max().item()
            tol = B_TOL_REL_MAX * ref.abs().max().item()
            ms = device_ms(
                lambda: decode_cross_attention(q, k8, v8, layer), 50)
            plain_ms = device_ms(
                lambda: decode_cross_attention_plain(q, k8, v8, layer), 20)
            gbs = 2 * b * h * hd * t / ms / 1e6
            log(f"kernel B decode_cross_attention L={n_layer} layer={layer} "
                f"T={t} R={rows}: "
                f"max_abs_err {max_err:.6g} (tol {tol:.6g}); {ms:.4f} ms "
                f"per layer ({gbs:.0f} GB/s of int8 K/V), plain "
                f"{plain_ms:.4f} ms")
            if max_err > tol:
                raise RuntimeError("decode_cross_attention disagrees with "
                                   "its plain version")
            worst = max(worst, max_err)
            timed[(t, rows)] = (ms, plain_ms)
        del k8, v8
    ms, plain_ms = timed[(1500, 2)]       # the beam step at a 30 s bucket
    return {"name": "decode_cross_attention", "route": "cuda",
            "source": "whisperjav_tpu_torch/csrc/decode_cross_attention.cu",
            "replaces": "whisperjav_tpu/ops/pallas/decode_attention.py:57",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def _int8_stack(gen, dev, k: int, n: int):
    """(L, k, n) random weights quantised as quant._quantize does."""
    from whisperjav_tpu_torch.models.whisper.model import Int8
    w = torch.randn(LV2_L, k, n, generator=gen, device=dev) * k ** -0.5
    s = w.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    return Int8(torch.round(w / s).clamp(-127, 127).to(torch.int8), s)


def _bf16(gen, dev, *shape, scale=0.1, base=0.0):
    return (base + scale * torch.randn(*shape, generator=gen,
                                       device=dev)).bfloat16()


def _fused_case(name, fn, plain, args, label, iters=20):
    """Kernel vs plain version on one input: errors against one bf16 step
    at each output's largest magnitude, and device times of both."""
    outs = fn(**args)
    refs = plain(**args)
    torch.cuda.synchronize()
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    max_err, mean_err = 0.0, 0.0
    for o, r in zip(outs, refs):
        o, r = o.float(), r.float()
        if o.shape != r.shape or not torch.isfinite(o).all():
            raise RuntimeError(f"{name}: bad output {tuple(o.shape)}")
        err = (o - r).abs()
        tol = FUSED_TOL_STEPS * 2.0 ** (
            torch.floor(torch.log2(r.abs().max())).item() - 7)
        if err.max().item() > tol:
            raise RuntimeError(f"{name} {label}: max_abs_err "
                               f"{err.max().item():.6g} > tol {tol:.6g}")
        max_err = max(max_err, err.max().item())
        mean_err = max(mean_err, err.mean().item())
    ms = device_ms(lambda: fn(**args), iters)
    plain_ms = device_ms(lambda: plain(**args), max(iters // 4, 3))
    wall = call_ms(lambda: fn(**args), 5)
    log(f"{name} {label}: max_abs_err {max_err:.6g} mean_abs_err "
        f"{mean_err:.6g} (tol one bf16 step at max |out|); device "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms; one call {wall:.4f} ms "
        f"wall")
    return max_err, ms, plain_ms


def check_fused_blocks(dev, gen):
    """The three fused decode blocks against their plain versions at
    large-v2 widths (d=1280, H=20, L=32), layers 0 and 31."""
    from whisperjav_tpu_torch.ops.cuda import fused_decode as fd
    d, h = LV2_D, LV2_H
    ln = dict(ln_s=_bf16(gen, dev, LV2_L, d, base=1.0),
              ln_b=_bf16(gen, dev, LV2_L, d))
    src = "whisperjav_tpu_torch/csrc/fused_decode.cu"
    results = []

    # self block: R = 32 (sampled) and 64 (beam 2), pos over the cache
    wqkv, wo = _int8_stack(gen, dev, d, 3 * d), _int8_stack(gen, dev, d, d)
    bqkv, bo = _bf16(gen, dev, LV2_L, 3 * d), _bf16(gen, dev, LV2_L, d)
    worst, timed = 0.0, {}
    for rows in (32, 64):
        cache = [_bf16(gen, dev, LV2_L, rows, SELF_T, d, scale=1.0)
                 for _ in range(2)]
        x = _bf16(gen, dev, rows, d, scale=1.0)
        for layer in (0, LV2_L - 1):
            for pos in (1, 100, SELF_T - 1):
                args = dict(x=x, **ln, wqkv=wqkv, bqkv=bqkv, wo=wo, bo=bo,
                            cache_k=cache[0], cache_v=cache[1], layer=layer,
                            pos=pos, n_head=h)
                err, ms, plain_ms = _fused_case(
                    "self_block", fd.self_block, fd.self_block_plain, args,
                    f"R={rows} layer={layer} pos={pos}")
                worst = max(worst, err)
                timed[(rows, layer, pos)] = (ms, plain_ms)
        del cache
    ms, plain_ms = timed[(64, LV2_L - 1, 100)]
    results.append({"name": "self_block", "route": "cuda", "source": src,
                    "replaces": "whisperjav_tpu/ops/pallas/fused_decode.py:88",
                    "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms})
    del wqkv, wo, bqkv, bo
    torch.cuda.empty_cache()

    # cross block: B=32 cross-K/V rows, g = 1 (sampled) and 2 (beam 2)
    cwq, cwo = _int8_stack(gen, dev, d, d), _int8_stack(gen, dev, d, d)
    cbq, cbo = _bf16(gen, dev, LV2_L, d), _bf16(gen, dev, LV2_L, d)
    b, worst, timed = 32, 0.0, {}
    for t in (448, 960, 1500):
        ck, cv = (torch.randint(-127, 128, (LV2_L, b, d, t), generator=gen,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(LV2_L, b, h, generator=gen, device=dev) * 0.02
                  for _ in range(2))
        for g in (1, 2):
            x = _bf16(gen, dev, b * g, d, scale=1.0)
            for layer in (0, LV2_L - 1):
                args = dict(x=x, **ln, cwq=cwq, cbq=cbq, cwo=cwo, cbo=cbo,
                            ck=ck, cv=cv, k_scale=ks, v_scale=vs,
                            layer=layer, n_head=h)
                err, ms, plain_ms = _fused_case(
                    "cross_block", fd.cross_block, fd.cross_block_plain,
                    args, f"B={b} g={g} T={t} layer={layer}")
                worst = max(worst, err)
                timed[(t, g, layer)] = (ms, plain_ms)
        del ck, cv
    ms, plain_ms = timed[(1500, 2, LV2_L - 1)]
    results.append({"name": "cross_block", "route": "cuda", "source": src,
                    "replaces":
                        "whisperjav_tpu/ops/pallas/fused_decode.py:185",
                    "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms})
    del cwq, cwo
    torch.cuda.empty_cache()

    # MLP block: R = 32 and 64
    w1, w2 = _int8_stack(gen, dev, d, 4 * d), _int8_stack(gen, dev, 4 * d, d)
    b1, b2 = _bf16(gen, dev, LV2_L, 4 * d), _bf16(gen, dev, LV2_L, d)
    worst, timed = 0.0, {}
    for rows in (32, 64):
        x = _bf16(gen, dev, rows, d, scale=1.0)
        for layer in (0, LV2_L - 1):
            args = dict(x=x, **ln, w1=w1, b1=b1, w2=w2, b2=b2, layer=layer)
            err, ms, plain_ms = _fused_case(
                "mlp_block", fd.mlp_block, fd.mlp_block_plain, args,
                f"R={rows} layer={layer}")
            worst = max(worst, err)
            timed[(rows, layer)] = (ms, plain_ms)
    ms, plain_ms = timed[(64, LV2_L - 1)]
    results.append({"name": "mlp_block", "route": "cuda", "source": src,
                    "replaces":
                        "whisperjav_tpu/ops/pallas/fused_decode.py:265",
                    "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms})
    del w1, w2
    torch.cuda.empty_cache()
    return results


def check_small_reference(dev):
    """A narrow Whisper from one seed: GPU bf16 (kernels) vs CPU f32
    (plain versions). bf16 weights and activations keep ~3 significant
    digits, so the tolerances are relative to each output's scale."""
    from whisperjav_tpu_torch.models.whisper import model as tm
    from whisperjav_tpu_torch.models.whisper.weights import init_params
    cfg = tm.WhisperConfig(name="smoke-narrow", n_mels=128, n_audio_state=256,
                        n_audio_head=4, n_audio_layer=2, n_text_state=256,
                        n_text_head=4, n_text_layer=2, n_vocab=51866)
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    gpu = init_params(cfg, torch.Generator().manual_seed(0)).to(
        device=dev, dtype=torch.bfloat16)
    mel = torch.randn(2, 128, 3000, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        xa_c = tm.encode(cpu, mel)
        xa_g = tm.encode(gpu, mel.to(dev, torch.bfloat16)).float().cpu()
        enc_err = ((xa_g - xa_c).abs().max() / xa_c.abs().max()).item()
        cross_c = tm.precompute_cross_kv(cpu, xa_c[:, :448])
        cross_g = tm.precompute_cross_kv(gpu, xa_g[:, :448].to(
            dev, torch.bfloat16))
        cache_c = tm.KVCache.zeros(cfg, 4, 8, torch.float32, "cpu")
        cache_g = tm.KVCache.zeros(cfg, 4, 8, torch.bfloat16, dev)
        sot = torch.tensor([[cfg.sot, cfg.sot + 8, cfg.transcribe]] * 4)
        logit_err = 0.0
        for tokens, pos in ((sot, 0), (torch.full((4, 1), cfg.timestamp_begin),
                                       3)):
            lc, cache_c = tm.decode_step(cpu, tokens, pos, cache_c, cross_c)
            lg, cache_g = tm.decode_step(gpu, tokens.to(dev), pos, cache_g,
                                         cross_g)
            lg = lg.cpu()
            if lg.shape != lc.shape or not torch.isfinite(lg).all():
                raise RuntimeError("small reference: bad decoder logits")
            logit_err = max(logit_err, ((lg - lc).abs().max()
                                        / lc.abs().max()).item())
    log(f"small reference (d=256, 2+2 layers, B=2 audio, 4 beam rows): "
        f"encoder max rel err {enc_err:.4g} (tol 0.05), decoder logits max "
        f"rel err {logit_err:.4g} (tol 0.05)")
    if not (enc_err <= 0.05 and logit_err <= 0.05):
        raise RuntimeError("GPU bf16 path disagrees with the CPU f32 path")


def check_small_int8_reference(dev):
    """The narrow Whisper on int8 decoder weights: prefill and a few
    single steps (fused blocks on the GPU, their plain versions on the
    CPU), beam rows folded g = 2 onto the cross K/V; GPU bf16 vs CPU f32
    logits. Each side quantises its own weights after its cast, as the
    engine does."""
    from whisperjav_tpu_torch.models.whisper import model as tm
    from whisperjav_tpu_torch.models.whisper.quant import (
        fuse_qkv_weights, quantize_decoder_weights,
    )
    from whisperjav_tpu_torch.models.whisper.weights import init_params
    from whisperjav_tpu_torch.ops.cuda import fused_decode as fd
    cfg = tm.WhisperConfig(name="smoke-narrow-int8", n_mels=80,
                           n_audio_state=256, n_audio_head=4,
                           n_audio_layer=2, n_text_state=256, n_text_head=4,
                           n_text_layer=2, n_vocab=51865)
    cpu = quantize_decoder_weights(fuse_qkv_weights(
        init_params(cfg, torch.Generator().manual_seed(2))))
    gpu = quantize_decoder_weights(fuse_qkv_weights(
        init_params(cfg, torch.Generator().manual_seed(2)).to(
            device=dev, dtype=torch.bfloat16)))
    xa = torch.randn(2, 448, 256, generator=torch.Generator().manual_seed(3))
    before = fd.self_block.launches
    with torch.inference_mode():
        cross_c = tm.precompute_cross_kv(cpu, xa)
        cross_g = tm.precompute_cross_kv(gpu, xa.to(dev, torch.bfloat16))
        cache_c = tm.KVCache.zeros(cfg, 4, 8, torch.float32, "cpu")
        cache_g = tm.KVCache.zeros(cfg, 4, 8, torch.bfloat16, dev)
        steps = [(torch.tensor([[cfg.sot, cfg.sot + 8, cfg.transcribe]] * 4),
                  0)] + [(torch.tensor([[tok], [tok + 5], [tok + 9],
                                        [tok + 11]]), 3 + i)
                         for i, tok in enumerate((cfg.timestamp_begin, 300,
                                                  1000))]
        logit_err = 0.0
        for tokens, pos in steps:
            lc, cache_c = tm.decode_step(cpu, tokens, pos, cache_c, cross_c)
            lg, cache_g = tm.decode_step(gpu, tokens.to(dev), pos, cache_g,
                                         cross_g)
            lg = lg.cpu()
            if lg.shape != lc.shape or not torch.isfinite(lg).all():
                raise RuntimeError("small int8 reference: bad logits")
            logit_err = max(logit_err, ((lg - lc).abs().max()
                                        / lc.abs().max()).item())
    steps_fused = (fd.self_block.launches - before) // cfg.n_text_layer
    log(f"small int8 reference (d=256, 2+2 layers, int8 decoder, B=2 audio, "
        f"4 beam rows, {steps_fused} fused steps): decoder logits max rel "
        f"err {logit_err:.4g} (tol {REF_TOL_REL})")
    if steps_fused != len(steps) - 1:
        raise RuntimeError("small int8 reference: the steps did not run "
                           "the fused blocks")
    if not logit_err <= REF_TOL_REL:
        raise RuntimeError("GPU int8 path disagrees with the CPU f32 path")


def speech_like(duration_s: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(duration_s * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * 180 * t)
         * (1 + 0.5 * np.sin(2 * np.pi * 4 * t)))
    x += 0.05 * rng.standard_normal(t.size)
    return x.astype(np.float32)


def synthetic_clip(path: Path, seconds: float) -> float:
    """~``seconds`` of speech-like bursts (3-9 s) between silences
    (1-3 s), written as 16 kHz mono 16-bit PCM."""
    rng = np.random.default_rng(0)
    parts, total, seed = [], 0.0, 0
    while total < seconds:
        speech = float(rng.uniform(3.0, 9.0))
        gap = float(rng.uniform(1.0, 3.0))
        parts += [speech_like(speech, seed), np.zeros(int(gap * SR),
                                                      np.float32)]
        total += speech + gap
        seed += 1
    audio = np.concatenate(parts)
    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SR)
        f.writeframes(pcm.tobytes())
    return len(audio) / SR


_SRT_TIME = re.compile(r"^(\d+):(\d\d):(\d\d),(\d{3}) --> "
                       r"(\d+):(\d\d):(\d\d),(\d{3})$", re.M)


def srt_cues(path: Path) -> list:
    """(start, end) seconds of every cue; raises on a malformed file."""
    text = path.read_text(encoding="utf-8")
    cues = []
    for m in _SRT_TIME.finditer(text):
        h0, m0, s0, ms0, h1, m1, s1, ms1 = map(int, m.groups())
        cues.append((h0 * 3600 + m0 * 60 + s0 + ms0 / 1000,
                     h1 * 3600 + m1 * 60 + s1 + ms1 / 1000))
    if len(cues) != text.count("-->"):
        raise RuntimeError(f"{path.name}: malformed cue times")
    return cues


def kernel_counters():
    """Every kernel wrapper of the port, by name (each counts its launches
    in ``.launches``)."""
    from whisperjav_tpu_torch.ops.cuda import fused_decode as fd
    from whisperjav_tpu_torch.ops.cuda.decode_attention import (
        decode_cross_attention,
    )
    from whisperjav_tpu_torch.ops.cuda.encoder_attention import (
        encoder_attention,
    )
    return {"encoder_attention": encoder_attention,
            "decode_cross_attention": decode_cross_attention,
            "self_block": fd.self_block, "cross_block": fd.cross_block,
            "mlp_block": fd.mlp_block}


def run_cli_path(tmp: Path, label: str, seconds: float, flags: list,
                 needed: tuple):
    """One CLI run on a synthetic clip; the launch counts of every kernel
    are zeroed just before and read just after; the kernels in
    ``needed`` must have launched."""
    from whisperjav_tpu_torch import cli
    wav = tmp / "smoke.wav"
    duration = synthetic_clip(wav, seconds)
    out_dir = tmp / f"out-{label}"
    counters = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rc = cli.main([str(wav), "--output-dir", str(out_dir), *flags])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise RuntimeError(f"{label}: whisperjav-torch exited {rc}")
    srt = out_dir / "smoke.ja.whisperjav.srt"
    meta_path = out_dir / "smoke.whisperjav.json"
    cues = srt_cues(srt)
    meta = json.loads(meta_path.read_text(encoding="utf-8"))
    diag = json.loads((out_dir / "smoke.transcribe.json").read_text(
        encoding="utf-8"))["windows"]
    stats = meta["stats"]
    if stats["windows"] < 1:
        raise RuntimeError(f"{label}: no window was decoded")
    for start, end in cues:
        if not 0.0 <= start < end <= duration + 1.0:
            raise RuntimeError(f"{label}: subtitle outside the clip: "
                               f"{start}-{end}")
    lps = [w["avg_logprob"] for w in diag if w["avg_logprob"] is not None]
    if not all(np.isfinite(lps)):
        raise RuntimeError(f"{label}: non-finite avg logprob in the "
                           "diagnostics")
    missing = [name for name in needed if launches[name] < 1]
    if missing:
        raise RuntimeError(f"{label}: kernels of the path never launched: "
                           f"{missing} ({launches})")
    log(f"{label} path ({' '.join(flags) or 'flagless'}): clip "
        f"{duration:.3f} s, wall {wall:.3f} s, file RTF "
        f"{duration / wall:.3f}x (e2e_wall_s {stats['e2e_wall_s']}, asr_s "
        f"{stats['asr_s']}), windows {stats['windows']}, groups "
        f"{stats['groups']}, raw subtitles {stats['raw_subtitles']}, final "
        f"subtitles {stats['final_subtitles']}, decoded windows with text "
        f"{len(lps)}")
    log(f"{label} path stages (s): {json.dumps(stats['stage_s'])}")
    log(f"{label} path peak device memory: {peak} bytes "
        f"({peak / 2**30:.3f} GiB); launches {json.dumps(launches)}")
    return launches


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def breakdown(dev):
    """One B=32 batch through the flagless engine, each phase timed to a
    sync."""
    from whisperjav_tpu_torch.pipelines.factory import build_pipeline
    engine = build_pipeline(device=dev).engine   # flagless defaults
    audio = np.stack([speech_like(28.0, s) for s in range(32)])
    audio = np.pad(audio, ((0, 0), (0, 480000 - audio.shape[1])))
    engine.encode_batch(audio, max_duration=28.0)      # warm-up
    xa, enc_s = _timed(lambda: engine.encode_batch(audio, max_duration=28.0))
    beam, beam_s = _timed(lambda: engine.decode_encoded(xa, 0.0, 0))
    samp, samp_s = _timed(lambda: engine.decode_encoded(xa, 0.2, 1))
    steps = int(np.max(beam.length))
    per_step = beam_s / max(steps, 1) * 1e3
    log(f"breakdown B=32, bucket {xa.shape[1]}: encode {enc_s:.4f} s; beam-2 "
        f"rung {beam_s:.4f} s ({steps} steps max, {per_step:.3f} ms/step); "
        f"sampled best-of-2 rung {samp_s:.4f} s "
        f"({int(np.max(samp.length))} steps max)")
    profile_decode(engine, xa, "turbo beam-2 B=32, 16 tokens")


def breakdown_large_v2_greedy(dev):
    """The shape of bench.py's headline on the port: large-v2 with int8
    decoder weights, one B=64 batch of 30 s windows, greedy, 128 new
    tokens; each phase timed to a sync."""
    from whisperjav_tpu_torch.models.whisper.decode import DecodeOptions
    from whisperjav_tpu_torch.pipelines.engine import TranscriptionEngine
    from whisperjav_tpu_torch.pipelines.factory import load_model
    config, model = load_model("large-v2", device=dev)
    engine = TranscriptionEngine(
        config, model, options=DecodeOptions(max_new_tokens=128,
                                             cross_kv_int8=True),
        batch_size=64, device=dev, int8_weights=True)
    audio = np.stack([speech_like(30.0, s) for s in range(64)])
    counters = kernel_counters()
    engine.encode_batch(audio[:2])                      # warm-up
    for fn in counters.values():
        fn.launches = 0
    xa, enc_s = _timed(lambda: engine.encode_batch(audio))
    res, dec_s = _timed(lambda: engine.decode_encoded(xa, 0.0, 0))
    steps = int(np.max(res.length))
    fused = counters["self_block"].launches // config.n_text_layer
    log(f"breakdown large-v2 int8 greedy B=64, bucket {xa.shape[1]}: encode "
        f"{enc_s:.4f} s; greedy rung {dec_s:.4f} s ({steps} tokens max, "
        f"{fused} fused steps, {dec_s / max(fused, 1) * 1e3:.3f} ms/step "
        f"incl. prefill and the host loop)")
    profile_decode(engine, xa, "large-v2 int8 greedy B=64, 16 tokens")
    del engine, model


def profile_decode(engine, xa, label: str, tokens: int = 16) -> None:
    """A short decode under torch.profiler: the device's busy share of the
    wall and the kernels that took the most device time."""
    import dataclasses
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    opts = engine.options
    engine.options = dataclasses.replace(opts, max_new_tokens=tokens)
    try:
        engine.decode_encoded(xa, 0.0, 0)               # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = _timed(lambda: engine.decode_encoded(xa, 0.0, 0))
    finally:
        engine.options = opts
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
    busy_ms = sum(t for _, t in by_name.values()) / 1e3
    if not by_name:
        log(f"profile {label}: the profiler saw no device time")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    log(f"profile {label}: wall {wall * 1e3:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.1f}%); top: "
        + "; ".join(f"{name[:60]} x{n} {t / 1e3:.3f} ms"
                    for name, (n, t) in top))


PHASES = ("kernels", "reference", "turbo", "large-v2")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma list of phases to run: {', '.join(PHASES)}")
    only = set(ap.parse_args(argv).only.split(","))
    if only - set(PHASES):
        ap.error(f"unknown phases {sorted(only - set(PHASES))}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        return 1
    import whisperjav_tpu_torch  # noqa: F401  (fails outside a checkout)
    from whisperjav_tpu_torch.ops.cuda import _build
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s); {card}")
    path, build_s, report = _build.build()
    log(f"built {path.name} in {build_s:.3f} s from "
        f"{[p.name for p in _build.sources()]}")
    for line in report.splitlines():
        if "registers" in line or "entry function" in line \
                or "spill" in line:
            log(f"  {line.strip()}")
    _build.load_library()

    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = []
    if "kernels" in only:
        kernels = [check_encoder_attention(dev, gen),
                   check_decode_attention(dev, gen, prompt_len=3),
                   *check_fused_blocks(dev, gen)]
        torch.cuda.empty_cache()
    if "reference" in only:
        check_small_reference(dev)
        check_small_int8_reference(dev)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        if "turbo" in only:
            launches["turbo_flagless"] = run_cli_path(
                Path(tmp), "turbo flagless", 120.0, [],
                ("encoder_attention", "decode_cross_attention"))
            torch.cuda.empty_cache()
            breakdown(dev)
            torch.cuda.empty_cache()
        if "large-v2" in only:
            launches["large_v2_int8"] = run_cli_path(
                Path(tmp), "large-v2 int8", 60.0,
                ["--model", "large-v2", "--int8-weights"],
                tuple(kernel_counters()))
            torch.cuda.empty_cache()
            breakdown_large_v2_greedy(dev)
    if only != set(PHASES):
        log(f"partial run ({sorted(only)}): no result line")
        return 3

    for k in kernels:
        k["launches"] = launches["large_v2_int8"][k["name"]]
        k["launches_by_path"] = {path: counts[k["name"]]
                                 for path, counts in launches.items()}
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
