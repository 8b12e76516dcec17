"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. card and build: the card's name and power limit (nvidia-smi), torch
   and CUDA versions, and the build of both CUDA kernels from
   ``whisperjav_tpu_torch/csrc/`` (seconds and ptxas report);
2. each kernel against its plain PyTorch version at the shapes the main
   path gives it, with the error against a stated tolerance and median
   times (CUDA events) of kernel and plain version;
3. a small-input reference: a narrow Whisper (hd = 64, so the kernels
   run) encodes and decodes on the GPU in bf16 and on the CPU in f32 (the
   plain versions) from the same weights; the results must agree;
4. the main path: a synthetic ~120 s clip through
   ``whisperjav_tpu_torch.cli.main`` with flagless defaults (balanced
   mode and sensitivity, turbo at full width from a seeded random init,
   batch 32, beam 2, temperature ladder, int8 cross-K/V, bf16). The
   kernels' launch counts are zeroed just before and read just after;
   the SRT and metadata must exist and parse, and both kernels must
   have launched;
5. a breakdown of one batch through the engine at B=32: encode, the
   beam-search rung and one sampled best-of-2 rung.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Exits with an error, and prints no
result, where no CUDA GPU is visible.
"""

from __future__ import annotations

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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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
    ms = median_ms(lambda: encoder_attention(q, k, v), iters=20)
    plain_ms = median_ms(lambda: attention(q, k, v), iters=5)
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
    n_layer, b, h, hd = 4, 32, 20, 64     # turbo decoder, B=32
    worst = 0.0
    timed = {}
    for t in (448, 960, 1500):
        k8, v8 = (torch.randint(-127, 128, (n_layer, b, h, hd, t),
                                generator=gen, device=dev, dtype=torch.int8)
                  for _ in range(2))
        # sampled rung: step and prefill; beam-2 rung: step and prefill
        for rows in (1, prompt_len, 2, 2 * prompt_len):
            q = torch.randn(b, rows, h, hd, generator=gen, device=dev) * 0.01
            out = decode_cross_attention(q, k8, v8, 3)
            ref = decode_cross_attention_plain(q, k8, v8, 3)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise RuntimeError("decode_cross_attention: non-finite")
            max_err = (out - ref).abs().max().item()
            tol = B_TOL_REL_MAX * ref.abs().max().item()
            ms = median_ms(lambda: decode_cross_attention(q, k8, v8, 3), 50)
            plain_ms = median_ms(
                lambda: decode_cross_attention_plain(q, k8, v8, 3), 20)
            gbs = 2 * b * h * hd * t / ms / 1e6
            log(f"kernel B decode_cross_attention T={t} R={rows}: "
                f"max_abs_err {max_err:.6g} (tol {tol:.6g}); {ms:.4f} ms "
                f"per layer ({gbs:.0f} GB/s of int8 K/V), plain "
                f"{plain_ms:.4f} ms")
            if max_err > tol:
                raise RuntimeError("decode_cross_attention disagrees with "
                                   "its plain version")
            worst = max(worst, max_err)
            timed[(t, rows)] = (ms, plain_ms)
    ms, plain_ms = timed[(1500, 2)]       # the beam step at a 30 s bucket
    return {"name": "decode_cross_attention", "route": "cuda",
            "source": "whisperjav_tpu_torch/csrc/decode_cross_attention.cu",
            "replaces": "whisperjav_tpu/ops/pallas/decode_attention.py:57",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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


def speech_like(duration_s: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(duration_s * SR)) / SR
    x = (0.3 * np.sin(2 * np.pi * 180 * t)
         * (1 + 0.5 * np.sin(2 * np.pi * 4 * t)))
    x += 0.05 * rng.standard_normal(t.size)
    return x.astype(np.float32)


def synthetic_clip(path: Path) -> float:
    """~120 s of speech-like bursts (3-9 s) between silences (1-3 s),
    written as 16 kHz mono 16-bit PCM."""
    rng = np.random.default_rng(0)
    parts, total, seed = [], 0.0, 0
    while total < 120.0:
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


def run_main_path(tmp: Path):
    from whisperjav_tpu_torch import cli
    from whisperjav_tpu_torch.ops.cuda.decode_attention import (
        decode_cross_attention,
    )
    from whisperjav_tpu_torch.ops.cuda.encoder_attention import (
        encoder_attention,
    )
    wav = tmp / "smoke.wav"
    duration = synthetic_clip(wav)
    out_dir = tmp / "out"
    torch.cuda.reset_peak_memory_stats()
    encoder_attention.launches = 0
    decode_cross_attention.launches = 0
    t0 = time.perf_counter()
    rc = cli.main([str(wav), "--output-dir", str(out_dir)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"encoder_attention": encoder_attention.launches,
                "decode_cross_attention": decode_cross_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise RuntimeError(f"whisperjav-torch exited {rc}")
    srt = out_dir / "smoke.ja.whisperjav.srt"
    meta_path = out_dir / "smoke.whisperjav.json"
    cues = srt_cues(srt)
    meta = json.loads(meta_path.read_text(encoding="utf-8"))
    diag = json.loads((out_dir / "smoke.transcribe.json").read_text(
        encoding="utf-8"))["windows"]
    stats = meta["stats"]
    if stats["windows"] < 1:
        raise RuntimeError("no window was decoded")
    for start, end in cues:
        if not 0.0 <= start < end <= duration + 1.0:
            raise RuntimeError(f"subtitle outside the clip: {start}-{end}")
    lps = [w["avg_logprob"] for w in diag if w["avg_logprob"] is not None]
    if not all(np.isfinite(lps)):
        raise RuntimeError("non-finite avg logprob in the diagnostics")
    if min(launches.values()) < 1:
        raise RuntimeError(f"a kernel of the main path never launched: "
                           f"{launches}")
    log(f"main path: clip {duration:.3f} s, wall {wall:.3f} s, file RTF "
        f"{duration / wall:.3f}x (e2e_wall_s {stats['e2e_wall_s']}, asr_s "
        f"{stats['asr_s']}), windows {stats['windows']}, groups "
        f"{stats['groups']}, raw subtitles {stats['raw_subtitles']}, final "
        f"subtitles {stats['final_subtitles']}, decoded windows with text "
        f"{len(lps)}")
    log(f"main path stages (s): {json.dumps(stats['stage_s'])}")
    log(f"main path peak device memory: {peak} bytes "
        f"({peak / 2**30:.3f} GiB); launches {json.dumps(launches)}")
    return launches


def breakdown(dev):
    """One B=32 batch through the engine, each phase timed to a sync."""
    from whisperjav_tpu_torch.pipelines.factory import build_pipeline
    engine = build_pipeline(device=dev).engine   # flagless defaults
    audio = np.stack([speech_like(28.0, s) for s in range(32)])
    audio = np.pad(audio, ((0, 0), (0, 480000 - audio.shape[1])))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    engine.encode_batch(audio, max_duration=28.0)      # warm-up
    xa, enc_s = timed(lambda: engine.encode_batch(audio, max_duration=28.0))
    beam, beam_s = timed(lambda: engine.decode_encoded(xa, 0.0, 0))
    samp, samp_s = timed(lambda: engine.decode_encoded(xa, 0.2, 1))
    steps = int(np.max(beam.length))
    per_step = beam_s / max(steps, 1) * 1e3
    log(f"breakdown B=32, bucket {xa.shape[1]}: encode {enc_s:.4f} s; beam-2 "
        f"rung {beam_s:.4f} s ({steps} steps max, {per_step:.3f} ms/step); "
        f"sampled best-of-2 rung {samp_s:.4f} s "
        f"({int(np.max(samp.length))} steps max)")


def main() -> int:
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
        f"device(s)")
    path, build_s, report = _build.build()
    log(f"built {path.name} in {build_s:.3f} s from "
        f"{[p.name for p in _build.sources()]}")
    for line in report.splitlines():
        if "registers" in line or "entry function" in line:
            log(f"  {line.strip()}")
    _build.load_library()

    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = [check_encoder_attention(dev, gen),
               check_decode_attention(dev, gen, prompt_len=3)]
    torch.cuda.empty_cache()
    check_small_reference(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = run_main_path(Path(tmp))
    torch.cuda.empty_cache()
    breakdown(dev)

    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
