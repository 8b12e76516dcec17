"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py                 # every phase, as below
    python3 chip_smoke.py --only kernels  # a subset: kernels, reference,
                                          # turbo, large-v2, fidelity,
                                          # qwen, vad, serve, enhance,
                                          # train, multihost, ensemble,
                                          # async, translate, tools, gui,
                                          # devices, ahead, switches
                                          # (comma list)

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
   A (encoder attention), Kernel B (int8 decode cross-attention, L=32,
   in its three output forms: f32, bf16 of out * v_scale, and its hi/lo
   terms; B=32 with R = 1, 2, 3, 6 and B=64 with R = 1, at T = 448, 960,
   1500 and 37; at T = 1500 also SDPA on the K/V dequantised to f32
   beforehand), and the three fused decode blocks at large-v2 widths
   (self, cross with the fold g = 1, 2 at T = 448/960/1500, MLP, one MLP
   input with a large mean offset); then one layer-step under the
   profiler, which must launch the 8 kernels of the design (self 3, cross
   3, MLP 2);
3. small-input references: a narrow Whisper (hd = 64, so the kernels
   run) encodes and decodes on the GPU in bf16 and on the CPU in f32 (the
   plain versions) from the same seed, once with bf16 decoder weights,
   once with int8 decoder weights (single steps through the fused
   blocks) and once with bf16 weights on a synthetic vocabulary slice;
   the logits must agree;
4. the flagless path: a synthetic ~60 s clip through
   ``whisperjav_tpu_torch.cli.main`` with flagless defaults (balanced
   mode and sensitivity, turbo at full width from a seeded random init,
   batch 32, beam 2, temperature ladder, int8 cross-K/V, bf16), then a
   breakdown of one B=32 batch (encode, the beam rung, one sampled
   best-of-2 rung);
5. the int8 path: a synthetic ~30 s clip through ``cli.main`` with
   ``--model large-v2 --int8-weights`` (the same balanced defaults at
   large-v2 full width and depth), then a greedy large-v2 breakdown: one
   B=64 batch of 30 s windows, 128 new tokens;
6. the fidelity phase: the ZipEnhancer at its published width (ZIP_BASE)
   denoises one 10 s chunk on the GPU and, with the same weights, on the
   CPU (the waveforms must agree; the chunk's device time, peak memory
   and FLOP bound are printed); then ``--mode fidelity --enhancer-weights
   <seeded ZIP_BASE .npz> --word-timestamps`` on a ~25 s clip (large-v2
   on bf16 decoder weights at full width and depth, B=32, beam 2, the
   ladder; every scene must be enhanced and at least one word-alignment
   pass must run) and ``--mode transformers --int8-weights --vocab-slice
   16384`` on the same clip (overlapped 30 s chunks, the fused int8
   blocks against an int8 lm head at the subset's size);
7. the qwen phase: a narrow Qwen3-ASR (test widths, int8 LM) from one
   seed on the GPU (f32, no TF32) and the CPU: prefill logits and 8
   teacher-forced steps within QWEN_TOL_REL, identical int8 codes, and
   identical forced-aligner spans (``align_spans``); the decode step's
   column attention kernel against its plain version at QCOL_CASES (the
   qwen3-asr-balanced cell's shapes in f32 and bf16, the translator's
   B=1 with two and four query heads a KV group (Qwen3-1.7B and 4B), the
   test widths: the output within QCOL_TOL_REL or one bf16
   step, the column written into the cache), with its byte bound, the
   plain version's and SDPA's ms; then ``--mode qwen``
   on a ~60 s clip (Qwen3-ASR-1.7B at full width and depth from a seeded
   random init, int8 LM, B=32, semantic scenes, the whisperseg framer,
   the forced aligner; at least two scenes, every cue inside the clip,
   generate and align stages above 0, the generator's and aligner's
   parameters on the card, the column attention kernel launched), the
   costs of the path (one timed B=32
   generate: ms per step and the device's busy share from the profiler,
   the AuT encode, ``align_spans`` per bucket), and the same clip with
   ``--generator anime-whisper --model small`` (Kernel A and Kernel B's
   bf16 form must launch);
8. the vad phase: Silero v5 and TEN from seeded ``.npz`` files on a 60 s
   clip and a 1-hour track, GPU (f32, no TF32) against CPU within
   VAD_TOL_P, with walls; Kernel A at WhisperSeg's encoder shape (4,
   1500, 8, 64) and Kernel B at its decoder prefill (R = 1500 query rows
   per K/V row, T = 1500) against their plain versions, with bound and
   SDPA; WhisperSeg at Whisper-base widths on 4 x 30 s, GPU bf16 against
   CPU f32 within WS_TOL_P, with the frames on each side of 0.5; then
   the flagless CLI with ``--vad-arg weights=<silero npz>`` (the network
   must run) and ``--mode qwen --qwen-segmenter whisperseg --vad-arg
   weights=<whisperseg npz>`` (Kernel A and B's bf16 form must launch);
9. the serve phase: an in-process server around the flagless turbo
   service (4 concurrent requests, the same 4 serially, a WAV body; the
   serial SRTs must equal the in-process CLI's byte for byte), then
   ``--daemon`` (autostart on the card, /health naming it and the torch
   backend, both SRTs written) and ``--daemon-stop`` (the port freed);
10. the enhance phase: the heavy enhancers at their published widths from
   seeded weights, BS-RoFormer (viperx, 44.1 kHz stereo), MossFormer2_SE_48K,
   FRCRN_SE_16K and the legacy band-split (48 kHz, 20 bands, 3 layers),
   each on one 8 s chunk at its native rate on the GPU and, with the same
   weights, on the CPU (waveforms within ENH_TOL_REL of the input's
   largest magnitude; BS-RoFormer's CPU comparison on 2 s), with the
   chunk's device time, peak memory, FLOP bound and largest kernels; then
   the flagless turbo CLI on the ~23 s clip with ``--enhancer clearvoice``
   (MossFormer2), ``--enhancer clearvoice --enhancer-arg
   model=FRCRN_SE_16K`` and ``--enhancer bs-roformer``, each from an
   ``.npz`` the port's save_params wrote: every scene must be enhanced, by
   the expected network, and Kernel A and Kernel B's bf16 form launch;
11. the train phase: two f32 train steps (``parallel/train.py``) from one
   seeded tree at a test width on the GPU and on the CPU (losses,
   gradients and updated parameters within the TRAIN_TOL_* tolerances);
   then ``whisperjav-torch-finetune`` in-process on turbo at full width
   and depth from the seeded f32 init (B = TRAIN_BATCH, 448 tokens, a
   few steps on one repeated batch of synthetic pairs, the last under
   the profiler): step walls, samples and target tokens a second, peak
   memory, the step's FLOP count and bound, the device's busy share and
   largest kernels, a finite and falling loss; two steps each at the
   batch sizes of TRAIN_SCAN (wall, peak memory); the last checkpoint read
   back with the port's ``load_checkpoint`` into a TranscriptionEngine
   (bf16) that transcribes one clip, where Kernel A (32 launches an
   encoder batch) and Kernel B's bf16 form must launch; then, with two
   cards or more, the dp x tp train step over NCCL in one child process
   a card (4, or 2 on two or three cards; the rendezvous in each child's
   environment; TRAIN_NCCL_TIMEOUT_S): ``make_train_mesh``'s default mesh
   (2 x 2 on four cards, 1 x 2 on two) runs two steps at the parity
   width, whose losses and gathered parameters must match the one-card
   step within the TRAIN_TOL_* tolerances, then turbo at full width and
   depth, TRAIN_BATCH rows a data replica, TRAIN_NCCL_STEPS steps timed
   to a sync (each card's peak memory, the NCCL kernels' share of the
   last step under the profiler); on one card it logs that the run
   needs two;
12. the multihost phase: two ``whisperjav-torch --multihost --coordinator
   127.0.0.1:<free port> --num-hosts 2 --host-id {0,1} --skip-existing``
   processes (turbo, flagless, on the one card) over 4 clips of different
   lengths write disjoint SRTs covering all 4 (each process's wall and
   peak memory printed); a re-run of both writes nothing; a process
   whose partner never comes exits non-zero within its rendezvous
   timeout, having written nothing;
13. the ensemble phase: ``whisperjav-torch a.wav b.wav --ensemble
   --pass1-mode balanced --pass2-mode fidelity --merge-strategy
   smart_merge`` on 25.8 s and 34.4 s clips (turbo beam 2 bf16, then
   large-v2 bf16 at aggressive, its decoder cut to ENSEMBLE_PASS2_LAYERS
   layers; the fidelity enhancer passes audio through without weights): ``ensemble_batch.json`` ok 2, each pass's
   parameters on the card, Kernel A and Kernel B's bf16 form launched in
   each pass, the memory allocated when pass 2 is built back within
   ENSEMBLE_DROP_SLACK of where it was before pass 1; each pass's wall,
   the merge stats and the peak memory;
14. the async phase: three clips of 15.6-23.6 s through the flagless path
   (no sanitizer) as a file loop and with ``--async-processing
   --output-format both --trace-params``: identical cues, every async
   SRT signed with its VTT, the trace's events; both walls;
15. the translate phase: ``generate_text`` at the test widths on the GPU
   against the CPU (tokens identical, first-step logits within
   TRANSLATE_TOL_REL of the largest); the seeded LM-only tree at
   Qwen3-1.7B widths (f32, fused q/k/v, built on the card) translating the
   async phase's first SRT through ``translate_srt`` and the ``tpu-local``
   backend (every call returns; parameters on the card), with ms per
   generate step at B=1, tokens a second, the prefill of a 400-token
   prompt and the step's byte bound; then ``--translate identity`` end
   to end and ``whisperjav-torch --check`` (exit 0, naming the card);
16. the tools phase: ``python -m whisperjav_tpu_torch.tools.e2e_bench``
   on a 2-minute synthetic file, flagless, with ``WJAV_TRACE_BATCHES=1``
   (its JSON line: ``e2e_file_rtf_balanced`` above 0, the stage and
   batch-phase walls, the rungs, a cuda engine); ``decode_profile`` at
   large-v2 greedy B=64 (budgets 32, 48, 64, every group, the bf16
   phase; every variant timed, ``int4_cross_kv``'s nibble-packed
   cross-K/V included, its ms a step printed beside ``base``; the base
   and int4 slopes above 0; launches per step of each variant; one timed
   round);
   ``whisperjav-torch-first-weights`` on a narrow HF Whisper that
   transformers writes from a seed (hd = 64): stages 0 and 1 pass, stage
   2's bf16 and int8 arms on the card launch Kernel A and B and the
   three fused blocks (the verdict is printed: random weights set it);
   ``determinism_suite``, two flagless runs on a ~20 s clip with one SRT
   hash and byte-identical window diagnostics; ``whisperjav-torch-bench`` grading the e2e SRT against itself
   (CER 0, IoU 1);
17. the gui phase: ``python -m whisperjav_tpu_torch.gui.server --port
   <free>`` (what ``whisperjav-torch-gui`` starts) as a child with its own
   config directory: the page, ``/api/schema`` equal to ``schema()``,
   every component schema, a preset saved, listed and deleted,
   ``/api/version`` offline within GUI_VERSION_LIMIT_S; the flagless
   turbo engine hosted in this process on the daemon's port 8478 (built
   for the config the jobs' argv resolves to); two ~20 s clips queued
   through ``/api/start`` with the default ``--daemon``: both jobs done
   within GUI_JOB_DEADLINE_S, each SRT with cues, each job's result read
   from the CLI's daemon line, a trace-derived stage, Kernel A and Kernel
   B's bf16 form launched by the hosted engine; the first clip through
   ``cli.main(... --daemon)`` byte-identical to its GUI job; a third job
   (``daemon: false``) cancelled while running (child gone);
   ``whisperjav-torch-upgrade`` offline (exit 0); ``resolve_checkpoint``
   of a seeded narrow npz checkpoint onto the card with huggingface_hub
   and transformers blocked; the job walls through ``MetadataManager``.
   The GUI process and ``whisperjav-torch-upgrade`` poll for a release
   through a proxy on a closed local port, so no outside host is asked;
18. the devices phase, in a child process whose cuBLAS has no workspace
   (``BATCH_INVARIANT_ENV``: cuBLAS otherwise splits a product's K by
   the row count, so a shard's rows would not compute as one card's;
   the largest difference between 32 rows of the K=5120 MLP product
   taken with 64 rows and alone is printed with and without it):
   ``cli.main(<turbo clip> --devices 2)`` against ``--devices 1`` (on
   one card the flag is capped to it), then, after a warm-up file, the
   flagless turbo engine at full width (B=32, beam 2, the ladder) over
   one shard and over two shards of ``cuda:0`` (the engine's ``mesh``;
   two model replicas, a host thread and a stream a shard) on the turbo
   clip: SRTs and window diagnostics byte-identical, Kernel A called on
   each shard's side stream and Kernel B's bf16 form on its stream (or
   on the stream the decode step's graphs are captured on, their
   replays counted as the launches they hold), the
   walls and peak memory printed; with a second card, the same over
   ``cuda:0`` and ``cuda:1`` and every kernel checked on ``cuda:1``;
19. the ahead phase: the flagless turbo engine (``pipelines.factory``,
   B=32, beam 2, int8 cross-K/V, bf16) over 70 seeded windows of 3-30 s
   with the ladder clamped to 2 rungs (``WJAV_LADDER_RUNGS``), after a
   warm-up batch, with pipelining off, encode-ahead only and both
   (``WJAV_ENCODE_AHEAD``, ``WJAV_DECODE_AHEAD``), the last under the
   CUDA-only profiler: window results byte-identical, Kernel A's
   launches equal and on the side stream, the wall, the batch trace and
   the peak memory of each, the device's busy share of the last; Kernel A on a side
   stream while Kernel B's bf16 form runs on the main one (each output
   equal to its lone launch and within the kernels phase's tolerances of
   its plain version; the times alone and together); a turbo B=32
   beam-2 rung on bf16 cross-K/V beside the int8 one (ms a step, the
   cross-K/V bytes, the tokens' agreement; no Kernel B on bf16 K/V);
   whisper-vad as ``create_segmenter("whisper-vad")`` builds it (tiny,
   bf16 cross-K/V) on a 30 s track on the card and on the CPU from the
   same weights (probabilities within WVAD_TOL_P, the same segments);
20. the switches phase: the JAX package's environment switches, each
   against its default at full width: ``WJAV_BEAM_SHARED_CROSS=0`` (a
   turbo B=32 beam-2 rung on int8 cross-K/V, the shared and the repeat
   layout in turns; the repeat layout's cross-K/V twice the bytes,
   Kernel B in both), ``WJAV_VOCAB_SLICE`` (the flagless factory's head
   sliced with no flag; its rung against the full head's),
   ``WJAV_FUSE_QKV=0`` (the large-v2 ``--int8-weights`` engine: no fused
   block launches apart), ``WJAV_QWEN_INT8=0`` (the Qwen3-ASR-1.7B B=32
   step on the LM as loaded against int8: ms a step, LM bytes, peak
   memory), ``WJAV_ALIGN_DEVICE=0`` (the aligner's host path: spans equal
   to the device path's) and ``WJAV_POOL_SCENES=0`` (the qwen pipeline
   on its clip scene by scene against pooled: the SRTs compared); ms a
   step, walls and token agreement printed.

Every phase but devices decodes on one card, the factory's default
(the mesh is opt-in, ``--devices N``), so its launches are one engine's
on any machine. The phases of LADDER_CUT run with the ladder cut to its
first rungs (``WJAV_LADDER_RUNGS``): random weights fail every gate, and
the deferred retries would cost each file seconds of host-bound steps.
The serve, ensemble, async and tools phases keep one sampled rung (the
deferred pool across requests and files); the turbo, large-v2 and
devices phases run the whole ladder.

Before each CLI run every kernel's launch count is zeroed, and read just
after it; the SRT and metadata must exist and parse, every cue must lie
inside the clip, and every kernel of that path must have launched (A and
Kernel B's bf16 form on the flagless and fidelity paths; on the int8 and
transformers paths also the three fused blocks and the kernels inside
them: the LN-mode GEMVs, the residual GEMVs, self attention and Kernel
B's terms form, 8 launches a layer-step). The last
two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Exits with an error, and prints no
result, where no CUDA GPU is visible.

Each kernel's record also holds its bound (``bound_ms``: the larger of
its bytes over 3.35 TB/s and its operations over the peak rate of their
type, 989 TFLOP/s bf16 on the tensor cores or 67 TFLOP/s f32, from the
shapes of this run), the time of one PyTorch call computing the same
function where there is one (``library_ms``: scaled_dot_product_attention
beside Kernel A and beside the self attention inside the self block;
null elsewhere), and the launches on the large-v2 int8 path
(``launches_by_path`` holds every CLI path's, the ensemble's, the
async run's, the ahead phase's and the switches phase's included). The kernels inside the fused blocks are timed by the profiler at
the blocks' main shapes. To time an older version of the kernels beside
these, run that tree's own ``chip_smoke.py --only kernels`` from its
``git archive`` copy in the same call.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import wave
from itertools import zip_longest
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
# ZipEnhancer: f32 on both sides (no TF32), sums in other orders ->
# waveforms within 1e-3 of the chunk's largest input magnitude.
ZIP_TOL_REL = 1e-3
# large-v2 at full width: 80 mels, d = 1280, 20 heads x 64, 32 + 32
# layers; the self cache holds the 3-token prompt and 224 new tokens
LV2_D, LV2_H, LV2_L, SELF_T = 1280, 20, 32, 3 + 224
# the card's published peaks (H100 SXM, at a 700 W power limit)
HBM_BYTES_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
# the synthetic clips of the flagless and int8 CLI paths, in seconds
TURBO_CLIP_S = 60.0
INT8_CLIP_S = 30.0
# the fidelity and transformers paths' clip (bursts are added until the
# clip reaches it, so it comes out a few seconds longer)
FIDELITY_CLIP_S = 20.0
# the qwen paths' clip: over 48 s, so safe chunking gives two scenes or
# more and the pooled path runs
QWEN_CLIP_S = 56.0
# narrow Qwen, GPU f32 (no TF32) vs CPU f32 logits, relative to their
# largest magnitude
QWEN_TOL_REL = 1e-3
# Silero and TEN: f32 on both sides (no TF32), sums in other orders
VAD_TOL_P = 1e-4
# WhisperSeg: bf16 on the GPU against f32 on the CPU, as probabilities
WS_TOL_P = 0.05
# the clip of the silero-network CLI path
VAD_CLIP_S = 30.0
# the served clips (distinct seeds), in seconds
SERVE_CLIPS_S = (20.0, 14.0, 26.0, 9.0)
# the heavy enhancers: f32 on both sides (no TF32), sums in other orders
# -> waveforms within 1e-3 of the chunk's largest input magnitude
ENH_TOL_REL = 1e-3
# one chunk of the backends, in seconds; BS-RoFormer's CPU comparison
# takes a shorter one (its full chunk is ~9 TFLOP on the host)
ENHANCE_CHUNK_S = 8.0
BSR_COMPARE_S = 2.0
# what the autostarted daemon's /health must report as its device
DAEMON_DEVICE = "cuda:NVIDIA"


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


def bound(bytes_: float, flop: float, peak: float) -> tuple:
    """The least time of a function on the card, in ms, and what sets it:
    each input read once and each output written once at the memory
    rate, or its operations at the peak rate of their type."""
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    t_ops = flop / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(name, source, replaces, max_err, ms, plain_ms, bound_, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_[0],
            "bound_by": bound_[1], "library_ms": None, **extra}


def kernel_device_ms(fn, reps: int = 10) -> tuple:
    """Device ms per call of ``fn`` of each CUDA kernel it launches, and
    its launches per call, by short name (``qgemv_kernel<2, 4>``), from
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out, counts = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"(\w+_kernel)(<[^>]*>)?", e.name)
        name = m.group(0) if m else e.name[:40]
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
        if m:
            counts[name] = counts.get(name, 0) + 1 / reps
    return out, {k: round(v) for k, v in counts.items()}


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
    # the library yardstick on the same tensors, as (B, H, T, hd) views
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {"kernel": [], "library": []}
    for turn in ("kernel", "library", "library", "kernel"):
        if turn == "library":
            times[turn].append(device_ms(lambda: sdpa(qh, kh, vh), iters=20))
            continue
        times[turn].append(device_ms(lambda: encoder_attention(q, k, v),
                                     iters=20))
    ms = statistics.median(times["kernel"])
    library_ms = statistics.median(times["library"])
    plain_ms = device_ms(lambda: attention(q, k, v), iters=5)
    b, t, h, hd = shape
    flop = 4 * b * h * t * t * hd
    bnd = bound(4 * q.numel() * 2, flop, PEAK_BF16)
    log(f"kernel A per layer: {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s, "
        f"{100 * bnd[0] / ms:.1f}% of the {bnd[0]:.4f} ms bound), "
        f"scaled_dot_product_attention {library_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms; turns {json.dumps(times)}")
    rec = record("encoder_attention",
                 "whisperjav_tpu_torch/csrc/encoder_attention.cu",
                 "whisperjav_tpu/ops/pallas/attention.py:52", max_err, ms,
                 plain_ms, bnd)
    rec["library_ms"] = library_ms
    return rec


def _bf16_step(ref) -> float:
    """One bf16 step at the largest magnitude of ``ref``."""
    return 2.0 ** (torch.floor(torch.log2(ref.abs().max())).item() - 7)


# Kernel B's cases: (B, R) at each T; R = g * q_len (sampled and beam-2
# steps, the beam-1 and beam-2 prefills of the 3-token prompt); R=1 at B=64
# is the greedy headline's step
B_CASES = ((32, 1), (32, 2), (32, 3), (32, 6), (64, 1))
B_TS = (448, 960, 1500, 37)
B_SDPA_LAYERS = 4


def check_decode_attention(dev, gen):
    """Kernel B against its plain versions in all three output forms (f32;
    bf16 of out * v_scale; its hi/lo terms) at large-v2 widths (L=32, H=20),
    every case of B_CASES x B_TS; device times of each form and of the
    plain version. Timed calls
    walk the 32 layers, so K/V arrive from device memory as in a decode
    step, not from L2."""
    import itertools
    from whisperjav_tpu_torch.ops.cuda import decode_attention as da
    n_layer, h, hd, layer = LV2_L, LV2_H, 64, LV2_L - 1
    worst, cases = 0.0, []
    for b in sorted({b for b, _ in B_CASES}):
        for t in B_TS:
            k8, v8 = (torch.randint(-127, 128, (n_layer, b, h, hd, t),
                                    generator=gen, device=dev,
                                    dtype=torch.int8) for _ in range(2))
            vs = torch.rand(n_layer, b, h, generator=gen, device=dev) * 0.02
            # the library yardstick at T=1500: SDPA on K/V dequantised to
            # f32 beforehand (B_SDPA_LAYERS layers in turn, more than L2
            # holds)
            kv = ([(k8[i].float().transpose(2, 3).contiguous(),
                    v8[i].float().transpose(2, 3).contiguous())
                   for i in range(B_SDPA_LAYERS)] if t == 1500 else None)
            for rows in (r for bb, r in B_CASES if bb == b):
                q = torch.randn(b, rows, h, hd, generator=gen,
                                device=dev) * 0.01
                args = (q, k8, v8, layer)
                out = da.decode_cross_attention(*args)
                ref = da.decode_cross_attention_plain(*args)
                o16 = da.decode_cross_attention_bf16(*args, vs).float()
                r16 = da.decode_cross_attention_bf16_plain(*args, vs).float()
                hi, lo = da.decode_cross_attention_terms(*args, vs)
                rhi, rlo = da.decode_cross_attention_terms_plain(*args, vs)
                torch.cuda.synchronize()
                for o in (out, o16, hi, lo):
                    if not torch.isfinite(o.float()).all():
                        raise RuntimeError("decode_cross_attention: "
                                           "non-finite output")
                y = rhi.float() + rlo.float()
                errs = {
                    "f32": ((out - ref).abs().max().item(),
                            B_TOL_REL_MAX * ref.abs().max().item()),
                    "bf16": ((o16 - r16).abs().max().item(),
                             _bf16_step(r16)),
                    "terms hi": ((hi.float() - rhi.float()).abs().max()
                                 .item(), _bf16_step(r16)),
                    "terms hi+lo": (((hi.float() + lo.float()) - y).abs()
                                    .max().item(),
                                    (B_TOL_REL_MAX + 2.0 ** -16)
                                    * y.abs().max().item())}
                bad = {k: e for k, e in errs.items() if e[0] > e[1]}
                label = f"B={b} T={t} R={rows}"
                if bad:
                    raise RuntimeError(f"decode_cross_attention {label} "
                                       f"disagrees with its plain version: "
                                       f"{bad}")
                worst = max(worst, errs["f32"][0])
                del out, ref, o16, r16, hi, lo, rhi, rlo, y

                def walk(fn, *extra):
                    layers = itertools.cycle(range(n_layer))
                    return lambda: fn(q, k8, v8, next(layers), *extra)
                times = {"kernel": [device_ms(
                    walk(da.decode_cross_attention), 40) for _ in range(2)]}
                ms = statistics.median(times["kernel"])
                bf16_ms = device_ms(walk(da.decode_cross_attention_bf16,
                                         vs), 40)
                terms_ms = device_ms(walk(da.decode_cross_attention_terms,
                                          vs), 40)
                plain_ms = device_ms(
                    walk(da.decode_cross_attention_plain), 10)
                sdpa_ms = None
                if kv is not None:
                    qf = q.transpose(1, 2)                 # (B, H, R, hd)
                    cyc = itertools.cycle(kv)

                    def library():
                        kl, vl = next(cyc)
                        return torch.nn.functional.\
                            scaled_dot_product_attention(qf, kl, vl,
                                                         scale=1.0)
                    sdpa_ms = device_ms(library, 40)
                # int8 K and V of one layer, f32 q and out; 4 FLOP per
                # (row, key, dim)
                bnd = bound(2 * b * h * hd * t + 2 * 4 * b * rows * h * hd,
                            4 * b * rows * h * hd * t, PEAK_F32)
                gbs = 2 * b * h * hd * t / ms / 1e6
                log(f"kernel B decode_cross_attention L={n_layer} {label}: "
                    f"max_abs_err " + ", ".join(
                        f"{k} {e:.6g} (tol {tol:.6g})"
                        for k, (e, tol) in errs.items())
                    + f"; f32 {ms:.4f} ms ({gbs:.0f} GB/s of int8 K/V, "
                    f"{100 * bnd[0] / ms:.1f}% of the {bnd[0]:.4f} ms "
                    f"bound), bf16 {bf16_ms:.4f} ms, terms {terms_ms:.4f} "
                    f"ms, plain {plain_ms:.4f} ms"
                    + (f", SDPA on dequantised f32 K/V {sdpa_ms:.4f} ms"
                       if sdpa_ms is not None else "")
                    + f"; turns {json.dumps(times)}")
                cases.append({"b": b, "t": t, "r": rows, "ms": ms,
                              "bf16_ms": bf16_ms,
                              "terms_ms": terms_ms, "plain_ms": plain_ms,
                              "bound_ms": bnd[0],
                              "sdpa_dequantised_ms": sdpa_ms,
                              "max_abs_err": errs["f32"][0]})
            del k8, v8, vs, kv
            torch.cuda.empty_cache()
    main = next(c for c in cases if (c["b"], c["t"], c["r"]) == (32, 1500, 2))
    rows, t, b = 2, 1500, 32
    bnd = bound(2 * b * h * hd * t + 2 * 4 * b * rows * h * hd,
                4 * b * rows * h * hd * t, PEAK_F32)
    return record("decode_cross_attention",
                  "whisperjav_tpu_torch/csrc/decode_cross_attention.cu",
                  "whisperjav_tpu/ops/pallas/decode_attention.py:57", worst,
                  main["ms"], main["plain_ms"], bnd,
                  per="one layer, L=32, B=32, R=2, T=1500, f32 form",
                  cases=cases)


def _int8_stack(gen, dev, k: int, n: int):
    """(L, k, n) random weights quantised as ``layers.quantize`` does."""
    from whisperjav_tpu_torch.models.layers import Int8
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
    # the plain version reads a device position on the host: give it the
    # int, so that its timing waits for nothing
    plain_args = {k: int(v) if k == "pos" else v for k, v in args.items()}
    refs = plain(**plain_args)
    torch.cuda.synchronize()
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    max_err, mean_err = 0.0, 0.0
    for o, r in zip(outs, refs):
        o, r = o.float(), r.float()
        if o.shape != r.shape or not torch.isfinite(o).all():
            raise RuntimeError(f"{name}: bad output {tuple(o.shape)}")
        err = (o - r).abs()
        tol = FUSED_TOL_STEPS * _bf16_step(r)
        if err.max().item() > tol:
            raise RuntimeError(f"{name} {label}: max_abs_err "
                               f"{err.max().item():.6g} > tol {tol:.6g}")
        max_err = max(max_err, err.max().item())
        mean_err = max(mean_err, err.mean().item())
    ms = device_ms(lambda: fn(**args), iters)
    plain_ms = device_ms(lambda: plain(**plain_args), max(iters // 4, 3))
    wall = call_ms(lambda: fn(**args), 5)
    log(f"{name} {label}: max_abs_err {max_err:.6g} mean_abs_err "
        f"{mean_err:.6g} (tol one bf16 step at max |out|); device "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms; one call {wall:.4f} ms "
        f"wall")
    return max_err, ms, plain_ms


# qgemv_kernel<EPI, MT>: its epilogue, and the GEMVs of a layer-step
# that use it; all but the residual one take LayerNorm(x) inside (LN mode)
GEMV_EPILOGUES = {"0": "LN -> wqkv, store with the k/v columns",
                  "1": "LN -> w1, GELU (hi/lo terms out)",
                  "2": "wo / cwo / w2 + residual",
                  "3": "LN -> cwq, q-fold (hd^-0.5 k_scale)"}
# kernels a large-v2 int8 layer-step launches: self 3, cross 3, MLP 2
LAUNCHES_PER_LAYER_STEP = 8


def check_fused_blocks(dev, gen):
    """The three fused decode blocks against their plain versions at
    large-v2 widths (d=1280, H=20, L=32), layers 0 and 31; then, at the
    main shapes (self R=64 pos 100, cross B=32 g=2 T=1500, MLP R=64, layer
    31), the device time of every kernel inside them, their bounds and
    plain versions. (The blocks are not timed beside an older version of
    the kernels: the self block's position moved to device memory.)"""
    from whisperjav_tpu_torch.ops.cuda import fused_decode as fd
    d, h = LV2_D, LV2_H
    ln = dict(ln_s=_bf16(gen, dev, LV2_L, d, base=1.0),
              ln_b=_bf16(gen, dev, LV2_L, d))
    src = "whisperjav_tpu_torch/csrc/fused_decode.cu"
    pallas = "whisperjav_tpu/ops/pallas/fused_decode.py"
    results, main = [], {}

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
                # the position on the card, as the decode step keeps it
                args = dict(x=x, **ln, wqkv=wqkv, bqkv=bqkv, wo=wo, bo=bo,
                            cache_k=cache[0], cache_v=cache[1], layer=layer,
                            pos=torch.tensor([pos], dtype=torch.int32,
                                             device=dev), n_head=h)
                err, ms, plain_ms = _fused_case(
                    "self_block", fd.self_block, fd.self_block_plain, args,
                    f"R={rows} layer={layer} pos={pos}")
                worst = max(worst, err)
                timed[(rows, layer, pos)] = (ms, plain_ms)
                if (rows, layer, pos) == (64, LV2_L - 1, 100):
                    main["self"] = args
    rows, pos = 64, 100
    self_bytes = (2 * rows * d * 2 + 2 * d * 2 + 4 * d * d + 4 * d * 6
                  + 2 * rows * pos * d * 2 + 3 * rows * d * 2)
    results.append(record(
        "self_block", src, f"{pallas}:88", worst,
        *timed[(64, LV2_L - 1, 100)],
        bound(self_bytes, 2 * rows * 4 * d * d * 2 + 4 * rows * pos * d,
              PEAK_BF16)))
    selfw = (wqkv, wo)

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
                if (t, g, layer) == (1500, 2, LV2_L - 1):
                    main["cross"] = args
        del ck, cv
    rows, t = 64, 1500
    cross_bytes = (2 * rows * d * 2 + 2 * d * 2 + 2 * d * d + 2 * d * 6
                   + 2 * b * d * t + 2 * b * h * 4)
    results.append(record(
        "cross_block", src, f"{pallas}:185", worst,
        *timed[(1500, 2, LV2_L - 1)],
        bound(cross_bytes, 2 * rows * 2 * d * d * 2 + 4 * rows * d * t,
              PEAK_BF16)))

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
            if (rows, layer) == (64, LV2_L - 1):
                main["mlp"] = args
    # a large mean offset: the LN-mode GEMV combines the split-K ranks'
    # row statistics
    args = dict(x=_bf16(gen, dev, 64, d, scale=1.0, base=50.0), **ln, w1=w1,
                b1=b1, w2=w2, b2=b2, layer=LV2_L - 1)
    worst = max(worst, _fused_case("mlp_block", fd.mlp_block,
                                   fd.mlp_block_plain, args,
                                   "R=64 x = 50 + N(0, 1)")[0])
    rows = 64
    mlp_bytes = 2 * rows * d * 2 + 2 * d * 2 + 8 * d * d + 5 * d * 6
    results.append(record(
        "mlp_block", src, f"{pallas}:265", worst, *timed[(64, LV2_L - 1)],
        bound(mlp_bytes, 2 * rows * 8 * d * d * 2, PEAK_BF16)))
    results.extend(inner_kernels(main, selfw, (cwq, cwo), (w1, w2),
                                 max(r["max_abs_err"] for r in results)))
    del main, wqkv, wo, cwq, cwo, w1, w2
    torch.cuda.empty_cache()
    return results


def inner_kernels(main, selfw, crossw, mlpw, block_err):
    """One decode layer-step of large-v2 at R=64 (the three blocks at
    their main shapes) under the profiler: the device time of each kernel
    inside the blocks, beside its bound and its plain version. The step
    must launch exactly the
    LAUNCHES_PER_LAYER_STEP kernels of this design. The inner kernels'
    outputs are checked through the blocks' (``block_err``, the blocks'
    worst error)."""
    from whisperjav_tpu_torch.ops.cuda import fused_decode as fd
    d, h, rows, pos, layer = LV2_D, LV2_H, 64, 100, LV2_L - 1
    sa, ca, ma = main["self"], main["cross"], main["mlp"]

    def step():
        fd.self_block(**sa)
        fd.cross_block(**ca)
        fd.mlp_block(**ma)

    turns = [device_ms(step, iters=20) for _ in range(2)]
    prof, counts = kernel_device_ms(step)
    if sum(counts.values()) != LAUNCHES_PER_LAYER_STEP:
        raise RuntimeError(f"a layer-step launched {counts}, not the "
                           f"{LAUNCHES_PER_LAYER_STEP} kernels of the design")
    log(f"large-v2 layer-step (self + cross + MLP, R=64, T=1500, pos 100): "
        f"device {statistics.median(turns):.4f} ms per step, "
        f"{sum(counts.values())} launches; turns {json.dumps(turns)}")
    log("  kernels per layer-step (profiler): " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in sorted(prof.items(),
                                             key=lambda kv: -kv[1])))

    # the GEMVs' bytes: int8 weights, f32 scale and bf16 bias per column;
    # LN mode reads bf16 x and the LN parameters, the others bf16 terms
    # (and x for the residual); outputs as each epilogue writes them
    def gemv_bytes(k, n, ln, out_bytes):
        a_in = rows * k * 2 + 2 * k * 2 if ln else 2 * rows * k * 2
        return k * n + n * 6 + a_in + out_bytes
    gemvs = {
        "0": [gemv_bytes(d, 3 * d, True, rows * 3 * d * 4
                         + 2 * rows * d * 2)],
        "1": [gemv_bytes(d, 4 * d, True, 2 * rows * 4 * d * 2)],
        "3": [gemv_bytes(d, d, True, rows * d * 4)],
        "2": [gemv_bytes(k, d, False, 2 * rows * d * 2)
              for k in (d, d, 4 * d)]}
    flop = {"0": 2 * rows * d * 3 * d, "1": 2 * rows * d * 4 * d,
            "3": 2 * rows * d * d, "2": 2 * rows * 6 * d * d}
    for epi in ("0", "3", "1", "2"):
        ms = prof.get(f"qgemv_kernel<{epi}, 4>", 0.0)
        bnd = bound(sum(gemvs[epi]), 2 * flop[epi], PEAK_BF16)
        log(f"  qgemv_kernel<{epi}, 4> ({GEMV_EPILOGUES[epi]}, "
            f"{len(gemvs[epi])} a layer-step): {ms:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})")
    kb = sum(v for k, v in prof.items()
             if k.startswith("decode_cross_attention_kernel"))
    log(f"  Kernel B in the cross block (B=32, g=2, T=1500, terms form): "
        f"{kb:.4f} ms")

    # plain versions of the inner kernels, on f32 inputs of the shapes
    g = torch.Generator(device="cuda").manual_seed(5)
    f32 = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    a_d, a_h = f32(rows, d), f32(rows, 4 * d)
    ws = [(w.q[layer], w.s[layer], torch.zeros(w.q.shape[-1], device="cuda"))
          for w in (*selfw, *crossw, *mlpw)]
    x = sa["x"]

    def plain_ln_gemvs():       # wqkv, cwq, w1 on LN(x)
        a = fd._ln(x.float(), sa["ln_s"][layer], sa["ln_b"][layer])
        for q, s_, bias in (ws[0], ws[2], ws[4]):
            fd._qdense(a, q, s_, bias)

    def plain_gemvs():          # wo, cwo, w2
        for (q, s_, bias), a in zip((ws[1], ws[3], ws[5]), (a_d, a_d, a_h)):
            fd._qdense(a, q, s_, bias)

    qkv = f32(rows, 3 * d)

    def plain_self_attention():
        ck = sa["cache_k"][layer, :, :pos].float().reshape(rows, pos, h, 64)
        cv = sa["cache_v"][layer, :, :pos].float().reshape(rows, pos, h, 64)
        q = qkv[:, :d].reshape(rows, h, 64) * 0.125
        lg = torch.cat([torch.einsum("rhd,rthd->rht", q, ck),
                        (q * qkv[:, d:2 * d].reshape(rows, h, 64)).sum(
                            -1, keepdim=True)], dim=-1).softmax(-1)
        return (torch.einsum("rht,rthd->rhd", lg[..., :-1], cv)
                + lg[..., -1:] * qkv[:, 2 * d:].reshape(rows, h, 64))

    # the library call computing the self attention's function: SDPA of
    # the new query over the cache up to pos and the new key and value
    qkv_lib = qkv.to(sa["cache_k"].dtype)
    q_lib = qkv_lib[:, :d].reshape(rows, h, 1, 64)
    k_lib, v_lib = (torch.cat([
        sa[c][layer, :, :pos].reshape(rows, pos, h, 64),
        qkv_lib[:, off:off + d].reshape(rows, 1, h, 64)], 1).transpose(1, 2)
        .contiguous() for c, off in (("cache_k", d), ("cache_v", 2 * d)))

    def library_self_attention():
        torch.nn.functional.scaled_dot_product_attention(q_lib, k_lib, v_lib)

    ln_epis = ("0", "3", "1")
    recs = [
        record("qgemv_ln", "whisperjav_tpu_torch/csrc/fused_decode.cu",
               "whisperjav_tpu/ops/pallas/fused_decode.py:88,185,265",
               block_err, sum(prof.get(f"qgemv_kernel<{e}, 4>", 0.0)
                              for e in ln_epis),
               device_ms(plain_ln_gemvs, iters=10),
               bound(sum(sum(gemvs[e]) for e in ln_epis),
                     2 * sum(flop[e] for e in ln_epis), PEAK_BF16),
               per="the three LN-mode int8 GEMVs of one large-v2 "
                   "layer-step (wqkv, cwq, w1), R=64"),
        record("qgemv", "whisperjav_tpu_torch/csrc/fused_decode.cu",
               "whisperjav_tpu/ops/pallas/fused_decode.py:166,248,323",
               block_err, prof.get("qgemv_kernel<2, 4>", 0.0),
               device_ms(plain_gemvs, iters=10),
               bound(sum(gemvs["2"]), 2 * flop["2"], PEAK_BF16),
               per="the three residual int8 GEMVs of one large-v2 "
                   "layer-step (wo, cwo, w2), R=64"),
        record("self_attention", "whisperjav_tpu_torch/csrc/fused_decode.cu",
               "whisperjav_tpu/ops/pallas/fused_decode.py:88", block_err,
               prof.get("self_attention_kernel", 0.0),
               device_ms(plain_self_attention, iters=10),
               bound(2 * rows * pos * d * 2 + rows * 3 * d * 4
                     + 2 * rows * d * 2, 4 * rows * pos * d, PEAK_F32),
               library_ms=device_ms(library_self_attention, iters=10),
               library="scaled_dot_product_attention of the new query "
                       "over the cache slice up to pos and the new column "
                       "(bf16)"),
    ]
    for r in recs:
        log(f"  {r['name']}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms"
            + (f", library {r['library_ms']:.4f} ms" if r["library_ms"]
               else ""))
    return recs


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
        cross_c = tm.precompute_cross_kv(cpu, xa_c[:, :448], int8=True)
        cross_g = tm.precompute_cross_kv(gpu, xa_g[:, :448].to(
            dev, torch.bfloat16), int8=True)
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
        cross_c = tm.precompute_cross_kv(cpu, xa, int8=True)
        cross_g = tm.precompute_cross_kv(gpu, xa.to(dev, torch.bfloat16),
                                         int8=True)
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


def check_small_vocab_reference(dev):
    """The narrow Whisper on bf16 decoder weights and a synthetic 4000-id
    vocabulary slice, each side's engine slicing its own embedding (GPU
    bf16, CPU f32 plain versions): prefill and two steps must give the
    same logits over the subset within REF_TOL_REL; then one greedy
    decode on the GPU, whose tokens must come back as full-vocab ids of
    the subset."""
    from whisperjav_tpu_torch.models.whisper import model as tm
    from whisperjav_tpu_torch.models.whisper.decode import DecodeOptions
    from whisperjav_tpu_torch.models.whisper.vocab_subset import (
        synthetic_text_ids,
    )
    from whisperjav_tpu_torch.models.whisper.weights import init_params
    from whisperjav_tpu_torch.pipelines.engine import (
        TranscriptionEngine, to_host,
    )
    cfg = tm.WhisperConfig(name="smoke-narrow-vocab", n_mels=80,
                           n_audio_state=256, n_audio_head=4,
                           n_audio_layer=2, n_text_state=256, n_text_head=4,
                           n_text_layer=2, n_vocab=51865)
    keep = synthetic_text_ids(cfg, 4000)
    opts = DecodeOptions(max_new_tokens=24, cross_kv_int8=True)
    engines = {
        side: TranscriptionEngine(
            cfg, init_params(cfg, torch.Generator().manual_seed(4)),
            options=opts, batch_size=2, device=device, compute_dtype=dtype,
            vocab_subset=keep)
        for side, device, dtype in (("cpu", "cpu", torch.float32),
                                    ("gpu", dev, torch.bfloat16))}
    xa = torch.randn(2, 448, 256, generator=torch.Generator().manual_seed(5))
    sub = engines["gpu"].model.config
    with torch.inference_mode():
        logits = {}
        for side, eng in engines.items():
            m = eng.model
            x = xa.to(eng.device, eng.compute_dtype)
            cross = tm.precompute_cross_kv(m, x, int8=True)
            cache = tm.KVCache.zeros(sub, 4, 8, eng.compute_dtype,
                                     eng.device)
            steps = [(torch.tensor([[sub.sot, sub.sot + 8,
                                     sub.transcribe]] * 4), 0),
                     (torch.full((4, 1), sub.timestamp_begin), 3),
                     (torch.tensor([[5], [77], [300], [3999]]), 4)]
            out = []
            for tokens, pos in steps:
                lg, cache = tm.decode_step(m, tokens.to(eng.device), pos,
                                           cache, cross)
                out.append(lg.float().cpu())
            logits[side] = out
        err = 0.0
        for lg, lc in zip(logits["gpu"], logits["cpu"]):
            if lg.shape != lc.shape or lg.shape[-1] != sub.n_vocab \
                    or not torch.isfinite(lg).all():
                raise RuntimeError("small vocab reference: bad logits "
                                   f"{tuple(lg.shape)}")
            err = max(err, ((lg - lc).abs().max() / lc.abs().max()).item())
        eng = engines["gpu"]
        res = to_host(eng.decode_encoded(xa.to(dev, torch.bfloat16), 0.0,
                                         0))
    kept = set(keep.tolist()) | set(range(cfg.eot, cfg.n_vocab))
    bad = set(res.tokens.ravel().tolist()) - kept
    log(f"small vocab-slice reference (d=256, 2+2 layers, bf16 decoder, "
        f"{len(keep)} text ids + {cfg.n_vocab - cfg.eot} specials = "
        f"{sub.n_vocab} logits): max rel err {err:.4g} (tol {REF_TOL_REL}); "
        f"GPU greedy decode {int(res.length.max())} tokens, all in the "
        f"subset: {not bad}")
    if bad or not np.isfinite(res.avg_logprob).all():
        raise RuntimeError(f"small vocab reference: tokens outside the "
                           f"subset {sorted(bad)[:5]}")
    if not err <= REF_TOL_REL:
        raise RuntimeError("GPU vocab-sliced path disagrees with the CPU "
                           "f32 path")


def zip_flops(cfg, frames: int) -> float:
    """Operations of one ZipEnhancer forward pass over ``frames`` STFT
    frames: the convolutions (dense blocks, 1x1 and frequency convs), the
    attention (projections, logits, weighted sums) and the FFNs of every
    dual-path block; 2 per multiply-add. Norms and activations are left
    out (a few operations per element)."""
    c, f, fd, t = cfg.width, cfg.n_freqs, cfg.down_freqs, frames
    dense = sum(2 * c * (i + 1) * 9 * c for i in range(cfg.dense_depth))
    ops = 2 * 2 * c * t * f + dense * t * f            # encoder
    ops += 2 * c * c * 3 * t * fd
    for n, seq in ((fd, t), (t, fd)):                  # time, freq paths
        ops += cfg.n_blocks * (8 * n * seq * c * c + 4 * n * seq * seq * c
                               + 4 * n * seq * c * c * cfg.ffn_mult)
    ops += 2 * (dense * t * fd + 2 * c * c * 3 * t * fd)   # two decoders
    ops += 3 * 2 * c * t * f                           # 1x1 heads
    return float(ops)


def check_zipenhancer(dev) -> dict:
    """ZIP_BASE denoise of one 10 s chunk of synthetic speech (its first
    0.25 s silent, so the chunk's first STFT frame is exact zeros and the
    network's phase input there does not hang on rounding) on the GPU and,
    with the same weights, on the CPU; waveforms within ZIP_TOL_REL of the
    input's largest magnitude. The chunk's device time (CUDA events, the
    median of three), its peak memory and its FLOP bound."""
    import copy
    from whisperjav_tpu_torch.models.enhancement import zipenhancer as zz
    n = 160000
    cpu_model = zz.init_params(zz.ZIP_BASE, torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    audio = np.concatenate([np.zeros(n // 40, np.float32),
                            speech_like(10.0, 7)[:n - n // 40]])[None]
    x = torch.from_numpy(audio)
    t0 = time.perf_counter()
    want = zz.denoise(cpu_model, x, n)
    cpu_s = time.perf_counter() - t0
    xg = x.to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = zz.denoise(gpu_model, xg, n)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    got = got.cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise RuntimeError("zipenhancer: bad output on the GPU")
    err = (got - want).abs().max().item()
    tol = ZIP_TOL_REL * x.abs().max().item()
    # the network's inputs on both sides: phase flips are atan2 rounding
    mag_c, pha_c = zz.mag_pha_stft(x)
    mag_g, pha_g = zz.mag_pha_stft(xg)
    flips = int(((pha_g.cpu() - pha_c).abs() > 1.0).sum())
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        zz.denoise(gpu_model, xg, n)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    frames = n // zz.HOP + 1
    flop = zip_flops(zz.ZIP_BASE, frames)
    bnd = bound(2 * 4 * n, flop, PEAK_F32)
    log(f"zipenhancer ZIP_BASE denoise, one 10 s chunk ({frames} frames): "
        f"max_abs_err GPU vs CPU {err:.6g} (tol {tol:.6g}), phase-input "
        f"flips {flips}; device {ms:.3f} ms (median of "
        f"{[round(t, 3) for t in times]}), bound {bnd[0]:.3f} ms "
        f"({flop / 1e12:.4f} TFLOP at {PEAK_F32 / 1e12:.0f} TFLOP/s f32, "
        f"{100 * bnd[0] / ms:.1f}% of it), peak memory {peak} bytes "
        f"({peak / 2**30:.3f} GiB) over {base} resident; CPU {cpu_s:.3f} s")
    if err > tol:
        raise RuntimeError("zipenhancer on the GPU disagrees with the CPU")
    del gpu_model, xg
    torch.cuda.empty_cache()
    return {"ms": ms, "bound_ms": bnd[0], "peak_bytes": peak,
            "max_abs_err": err}


def speech_like(duration_s: float, seed: int, rate: int = SR) -> np.ndarray:
    """A 180 Hz carrier under a 4 Hz envelope, with noise, at ``rate``."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(duration_s * rate)) / rate
    x = (0.3 * np.sin(2 * np.pi * 180 * t)
         * (1 + 0.5 * np.sin(2 * np.pi * 4 * t)))
    x += 0.05 * rng.standard_normal(t.size)
    return x.astype(np.float32)


def synthetic_clip(path: Path, seconds: float) -> float:
    """~``seconds`` of speech-like bursts (3-9 s) between silences
    (1-3 s), written as 16 kHz mono 16-bit PCM."""
    return synthetic_clip_seeded(path, seconds, 0)


def wave_seconds(path: Path) -> float:
    with wave.open(str(path), "rb") as f:
        return f.getnframes() / f.getframerate()


def synthetic_clip_seeded(path: Path, seconds: float, seed: int) -> float:
    """:func:`synthetic_clip` drawn from ``seed`` (burst lengths, gaps and
    noise)."""
    rng = np.random.default_rng(seed)
    parts, total = [], 0.0
    seed = 100 * seed
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


def srt_text_cues(text: str) -> list:
    """(time line, text) of every cue of an SRT document; raises where a
    block is not an index, a time line and text."""
    cues = []
    for block in filter(None, text.strip().split("\n\n")):
        lines = block.split("\n")
        if not (len(lines) >= 3 and lines[0].strip().isdigit()
                and _SRT_TIME.match(lines[1])):
            raise RuntimeError(f"malformed SRT block: {block[:80]!r}")
        cues.append((lines[1], "\n".join(lines[2:])))
    return cues


def srt_cues(path: Path) -> list:
    """(start, end) seconds of every cue; raises on a malformed file."""
    cues = []
    for time_line, _ in srt_text_cues(path.read_text(encoding="utf-8")):
        h0, m0, s0, ms0, h1, m1, s1, ms1 = map(
            int, _SRT_TIME.match(time_line).groups())
        cues.append((h0 * 3600 + m0 * 60 + s0 + ms0 / 1000,
                     h1 * 3600 + m1 * 60 + s1 + ms1 / 1000))
    return cues


def kernel_counters():
    """Every kernel wrapper of the port, by name (each counts its launches
    in ``.launches``), the kernels inside the fused blocks
    (``<name>_in_block``), and the word-alignment pass (plain PyTorch,
    counted alike)."""
    from whisperjav_tpu_torch.ops.cuda import decode_attention as da
    from whisperjav_tpu_torch.ops.cuda import fused_decode as fd
    from whisperjav_tpu_torch.ops.cuda import qwen_attention as qa
    from whisperjav_tpu_torch.models.whisper.word_align import (
        cross_attention_maps,
    )
    from whisperjav_tpu_torch.ops.cuda.encoder_attention import (
        encoder_attention,
    )
    counters = {"encoder_attention": encoder_attention,
                "word_alignment_pass": cross_attention_maps,
                "decode_cross_attention": da.decode_cross_attention,
                "decode_cross_attention_bf16": da.decode_cross_attention_bf16,
                "decode_cross_attention_terms":
                    da.decode_cross_attention_terms,
                "self_block": fd.self_block, "cross_block": fd.cross_block,
                "mlp_block": fd.mlp_block,
                "qwen_column_attention": qa.column_attention}
    counters.update({f"{k}_in_block": v for k, v in fd.inner.items()})
    return counters


# the counters of each kernel of the JSON record (Kernel B in every form,
# called alone or inside the cross block)
RECORD_COUNTERS = {
    "decode_cross_attention": ("decode_cross_attention",
                               "decode_cross_attention_bf16",
                               "decode_cross_attention_terms",
                               "decode_cross_attention_terms_in_block"),
    "qgemv_ln": ("qgemv_ln_in_block",), "qgemv": ("qgemv_in_block",),
    "self_attention": ("self_attention_in_block",)}
# the kernels each CLI path must launch: the flagless path's unfused
# decoder takes Kernel B's bf16 form; the int8 path prefills the same way
# and runs every single step through the fused blocks
TURBO_NEEDS = ("encoder_attention", "decode_cross_attention_bf16")
INT8_NEEDS = TURBO_NEEDS + ("self_block", "cross_block", "mlp_block",
                            "qgemv_ln_in_block", "qgemv_in_block",
                            "self_attention_in_block",
                            "decode_cross_attention_terms_in_block")
# the fidelity path's bf16 decoder takes the unfused layers, and
# --word-timestamps runs at least one alignment pass
FIDELITY_NEEDS = TURBO_NEEDS + ("word_alignment_pass",)


def run_cli_path(tmp: Path, label: str, seconds: float, flags: list,
                 needed: tuple):
    """One CLI run on a synthetic clip; the launch counts of every kernel
    are zeroed just before and read just after; the kernels in
    ``needed`` must have launched. Returns the launches and the
    metadata's stats."""
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
    steps = launches["self_block"]       # fused layer-steps
    inner = sum(n for k, n in launches.items() if k.endswith("_in_block"))
    if inner != LAUNCHES_PER_LAYER_STEP * steps \
            or launches["qgemv_ln_in_block"] != 3 * steps:
        raise RuntimeError(f"{label}: {inner} kernels in {steps} fused "
                           f"layer-steps, not {LAUNCHES_PER_LAYER_STEP} "
                           f"each with 3 in LN mode ({launches})")
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
    return launches, stats


def run_fidelity_paths(tmp: Path) -> dict:
    """The fidelity CLI path (seeded ZIP_BASE weights written with the
    port's save_params, word timestamps) and the transformers path (int8
    weights, a 16384-id vocabulary slice) on one ~25 s clip."""
    from whisperjav_tpu_torch.models.enhancement import zipenhancer as zz
    npz = tmp / "zip_base.npz"
    zz.save_params(str(npz), zz.init_params(
        zz.ZIP_BASE, torch.Generator().manual_seed(1)))
    launches = {}
    launches["fidelity"], stats = run_cli_path(
        tmp, "fidelity", FIDELITY_CLIP_S,
        ["--mode", "fidelity", "--enhancer-weights", str(npz),
         "--word-timestamps"], FIDELITY_NEEDS)
    log(f"fidelity path: {stats['enhanced_scenes']} of {stats['scenes']} "
        f"scenes enhanced, {launches['fidelity']['word_alignment_pass']} "
        f"word-alignment passes")
    if not stats["enhanced_scenes"] == stats["scenes"] > 0:
        raise RuntimeError(f"fidelity: {stats['enhanced_scenes']} of "
                           f"{stats['scenes']} scenes enhanced")
    torch.cuda.empty_cache()
    launches["transformers_int8"], stats = run_cli_path(
        tmp, "transformers int8", FIDELITY_CLIP_S,
        ["--mode", "transformers", "--int8-weights", "--vocab-slice",
         "16384"], INT8_NEEDS)
    if stats["scene_backend"] != "chunked":
        raise RuntimeError(f"transformers: scene backend "
                           f"{stats['scene_backend']!r}, not chunked")
    torch.cuda.empty_cache()
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
    from whisperjav_tpu_torch.pipelines.engine import to_host
    from whisperjav_tpu_torch.pipelines.factory import build_pipeline
    engine = build_pipeline(device=dev).engine   # flagless
    audio = np.stack([speech_like(28.0, s) for s in range(32)])
    audio = np.pad(audio, ((0, 0), (0, 480000 - audio.shape[1])))
    engine.encode_batch(audio, max_duration=28.0)      # warm-up
    xa, enc_s = _timed(lambda: engine.encode_batch(audio, max_duration=28.0))
    beam, beam_s = _timed(lambda: to_host(engine.decode_encoded(xa, 0.0,
                                                                0)))
    samp, samp_s = _timed(lambda: to_host(engine.decode_encoded(xa, 0.2,
                                                                1)))
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
    from whisperjav_tpu_torch.pipelines.engine import (
        TranscriptionEngine, to_host,
    )
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
    res, dec_s = _timed(lambda: to_host(engine.decode_encoded(xa, 0.0, 0)))
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
    log_profile(prof, wall, label)


def log_profile(prof, wall: float, label: str) -> None:
    """The device's busy share of ``wall`` and the kernels that took the
    most device time, from a finished ``torch.profiler`` run."""
    from torch.autograd import DeviceType
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


def check_small_qwen_reference(dev):
    """A narrow Qwen3-ASR (``qwen3-asr-test``: LM d=256, 4 layers, GQA 8/4
    heads, vocab 4096; AuT d=256, 4 layers) from one seed, fused and
    quantised to int8 on the CPU and copied to the card; the card's own
    quantiser must give the same codes. The prefill logits (audio prefix
    + BOS) and 8 teacher-forced single steps, GPU f32 vs CPU f32, within
    QWEN_TOL_REL of the largest logit; then the forced aligner (default
    widths, one seed) on a padded 4 s bucket: ``align_spans`` on both
    sides must give identical spans."""
    import copy
    from whisperjav_tpu_torch.models.qwen import aligner as qa
    from whisperjav_tpu_torch.models.qwen import model as qm
    from whisperjav_tpu_torch.models.qwen.weights import init_params
    from whisperjav_tpu_torch.models.layers import quantize
    cfg = qm.QWEN_SIZES["qwen3-asr-test"]
    cpu = qm.quantize_lm_weights(qm.fuse_lm_qkv(init_params(
        cfg, torch.Generator().manual_seed(0))))
    gpu = copy.deepcopy(cpu).to(dev)
    raw = qm.fuse_lm_qkv(init_params(cfg, torch.Generator().manual_seed(0)))
    q_gpu, s_gpu = quantize(raw.blocks["wqkv"].to(dev))
    same_codes = bool((q_gpu.cpu() == cpu.blocks["wqkv"].q).all()
                      and (s_gpu.cpu() == cpu.blocks["wqkv"].s).all())
    g = torch.Generator().manual_seed(1)
    mel = torch.randn(2, cfg.n_mels, 800, generator=g)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=g)
    audio_len = cfg.audio_tokens_for(800)
    t_max = audio_len + 1 + 8
    logits = {}
    with torch.inference_mode():
        for side, model, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
            emb = qm.encode_audio(model, mel.to(d))
            bos = model.tok_emb[torch.full((2, 1), cfg.bos_id, device=d)]
            cache = qm.LMCache.zeros(cfg, 2, t_max, torch.float32, d)
            lg, cache = qm.lm_step(model, torch.cat([emb, bos], 1), 0,
                                   cache)
            out = [lg[:, -1]]
            for i in range(8):
                lg, cache = qm.lm_step(model, model.tok_emb[
                    toks[:, i:i + 1].to(d)], audio_len + 1 + i, cache)
                out.append(lg[:, 0])
            logits[side] = torch.stack(out).float().cpu()
    lc, lg = logits["cpu"], logits["gpu"]
    err = ((lg - lc).abs().max() / lc.abs().max()).item()
    # the forced aligner: one seed, CPU and card
    acfg = qa.AlignerConfig()
    ap_cpu = qa.init_params(acfg, torch.Generator().manual_seed(2))
    ap_gpu = copy.deepcopy(ap_cpu).to(dev)
    lens = [4 * SR, 3 * SR + 555, SR, SR // 3]
    audio = np.zeros((4, 4 * SR), np.int16)
    counts = [40, 25, 12, 9]
    tok = np.zeros((4, 64), np.int64)
    rng = np.random.default_rng(3)
    for r, n in enumerate(lens):
        audio[r, :n] = np.round(speech_like(4.0, r)[:n] * 32767)
        tok[r, :counts[r]] = rng.integers(0, acfg.vocab_size, counts[r])
    spans = {}
    for side, params, d in (("cpu", ap_cpu, "cpu"), ("gpu", ap_gpu, dev)):
        spans[side] = qa.align_spans(
            params, torch.from_numpy(audio).to(d), torch.from_numpy(tok).to(d),
            torch.tensor(lens, device=d), torch.tensor(counts, device=d))
    same_spans = all(
        (spans["gpu"][k][r, :n] == spans["cpu"][k][r, :n]).all()
        for k in (0, 1) for r, n in enumerate(counts))
    log(f"small qwen reference (qwen3-asr-test widths, int8 LM, B=2, "
        f"prefill of {audio_len} audio tokens + BOS, 8 teacher-forced "
        f"steps): logits max rel err {err:.4g} (tol {QWEN_TOL_REL}); int8 "
        f"codes and scales quantised on the card equal the CPU's: "
        f"{same_codes}; align_spans (default aligner, 4 rows, 4 s "
        f"bucket, 64 tokens) identical on the card and the CPU: "
        f"{same_spans}")
    if not torch.isfinite(lg).all() or not err <= QWEN_TOL_REL:
        raise RuntimeError("qwen on the GPU disagrees with the CPU")
    if not same_codes:
        raise RuntimeError("int8 codes on the GPU differ from the CPU's")
    if not same_spans:
        raise RuntimeError(f"align_spans on the GPU differ from the CPU: "
                           f"{spans}")


# the column attention's cases: (label, L, B, T_max, n_kv, rep, hd,
# positions, types): Qwen3-ASR-1.7B in the qwen3-asr-balanced cell (a
# 625-position prefix, 576 steps), the translator at B=1 (a 400-token
# prompt, 128 new) with Qwen3-1.7B (two query heads a KV group) and
# Qwen3-4B (four), and the small qwen reference's test widths
QCOL_CASES = (
    ("cell", 28, 32, 1201, 8, 2, 128, (625, 913, 1200),
     (torch.float32, torch.bfloat16)),
    ("translator", 28, 1, 528, 8, 2, 128, (400, 527), (torch.float32,)),
    ("translator 4B", 36, 1, 528, 8, 4, 128, (400, 527),
     (torch.float32, torch.bfloat16)),
    ("test widths", 4, 2, 59, 4, 2, 32, (51, 58), (torch.float32,)))
# f32 on both sides, sums in another order; bf16: the kernel against the
# plain version in f32 on the same bf16 inputs, one bf16 step
QCOL_TOL_REL = 2e-5
QCOL_MAIN = ("cell", 913, torch.float32)


def qwen_column_bytes(b, nh, n_kv, hd, pos, itemsize) -> int:
    """One layer-step's least bytes: each row's filled K and V read once,
    the new column read and written, q read and the output written."""
    kvd = n_kv * hd
    return itemsize * b * (2 * pos * kvd + 4 * kvd + 2 * nh * hd)


def check_qwen_column_attention(dev, gen):
    """The Qwen3 decode step's column attention
    (``csrc/qwen_column_attention.cu``) against its plain version at
    QCOL_CASES: the output within its tolerance and the cache after the
    step equal (the column written at pos, nothing else); device ms of
    the kernel and the plain version walking the layers (a layer's K and
    V outgrow L2 at the cell's shapes, as in a step), SDPA on the filled
    positions of the cache as the library yardstick (GQA, the cache's
    strided view), and the byte bound."""
    import itertools
    from whisperjav_tpu_torch.ops.cuda import qwen_attention as qa
    worst, cases = 0.0, []
    for label, n_layer, b, t_max, n_kv, rep, hd, positions, dtypes \
            in QCOL_CASES:
        nh = rep * n_kv
        for dtype in dtypes:
            shape = (n_layer, b, t_max, n_kv * hd)
            ck = torch.randn(*shape, generator=gen, device=dev).to(dtype)
            cv = torch.randn(*shape, generator=gen, device=dev).to(dtype)
            for pos in positions:
                q = torch.randn(b, 1, nh, hd, generator=gen,
                                device=dev).to(dtype)
                kn, vn = (torch.randn(b, n_kv * hd, generator=gen,
                                      device=dev).to(dtype)
                          for _ in range(2))
                layer = n_layer - 1
                one = slice(layer, layer + 1)
                want = qa.column_attention_plain(
                    q.float(), ck[one].float().clone(),
                    cv[one].float().clone(), 0, pos, kn.float(), vn.float())
                low = (qa.column_attention_plain(
                    q, ck[one].clone(), cv[one].clone(), 0, pos, kn,
                    vn).float() if dtype != torch.float32 else None)
                after_k, after_v = ck[layer].clone(), cv[layer].clone()
                after_k[:, pos], after_v[:, pos] = kn, vn
                out = qa.column_attention(q, ck, cv, layer, pos, kn, vn)
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                tol = (QCOL_TOL_REL * want.abs().max().item()
                       if dtype == torch.float32 else _bf16_step(want))
                written = bool(torch.equal(ck[layer], after_k)
                               and torch.equal(cv[layer], after_v))
                del after_k, after_v
                low_err = (None if low is None
                           else (low - want).abs().max().item())
                name = (f"{label} L={n_layer} B={b} T_max={t_max} "
                        f"n_kv={n_kv} rep={rep} hd={hd} pos={pos} "
                        f"{str(dtype).split('.')[-1]}")
                if not torch.isfinite(out.float()).all() or err > tol \
                        or not written:
                    raise RuntimeError(
                        f"qwen column attention {name}: max |err| {err:.3g} "
                        f"(tol {tol:.3g}), column written {written}")
                if dtype == torch.float32:
                    worst = max(worst, err)

                # the position as the decode loop's graph hands it over
                at = torch.full((1,), pos, dtype=torch.int32, device=dev)

                def walk(fn):
                    layers = itertools.cycle(range(n_layer))
                    return lambda: fn(q, ck, cv, next(layers), at, kn, vn)
                ms = device_ms(walk(qa.column_attention), 40)
                plain_ms = device_ms(walk(qa.column_attention_plain), 5)
                qh = q.transpose(1, 2)
                cyc = itertools.cycle(range(n_layer))

                def library():
                    i = next(cyc)
                    kl, vl = (c[i, :, :pos + 1].unflatten(-1, (n_kv, hd))
                              .transpose(1, 2) for c in (ck, cv))
                    return torch.nn.functional.scaled_dot_product_attention(
                        qh, kl, vl, scale=hd ** -0.5, enable_gqa=True)
                try:
                    sdpa_ms = device_ms(library, 40)
                except TypeError:        # a torch without enable_gqa
                    sdpa_ms = None
                itemsize = torch.empty((), dtype=dtype).element_size()
                nbytes = qwen_column_bytes(b, nh, n_kv, hd, pos, itemsize)
                bnd = bound(nbytes, 4 * b * nh * hd * (pos + 1), PEAK_F32)
                log(f"qwen column attention {name}: max |err| {err:.3g} (tol "
                    f"{tol:.3g}"
                    + (f"; the bf16 plain version's own {low_err:.3g}"
                       if low is not None else "")
                    + f"), column written; kernel {ms:.4f} ms "
                    f"({nbytes / ms / 1e6:.0f} GB/s, {100 * bnd[0] / ms:.1f}% "
                    f"of the {bnd[0]:.4f} ms {bnd[1]} bound), plain "
                    f"{plain_ms:.4f} ms, SDPA (GQA, the cache's view) "
                    f"{sdpa_ms} ms")
                cases.append({"case": label, "b": b, "t_max": t_max,
                              "n_kv": n_kv, "rep": rep, "hd": hd,
                              "pos": pos,
                              "dtype": str(dtype).split(".")[-1], "ms": ms,
                              "plain_ms": plain_ms, "library_ms": sdpa_ms,
                              "bound_ms": bnd[0], "max_abs_err": err,
                              "tol": tol})
                del q, kn, vn, want, out
            del ck, cv
            torch.cuda.empty_cache()
    main = next(c for c in cases if (c["case"], c["pos"], c["dtype"])
                == (QCOL_MAIN[0], QCOL_MAIN[1], "float32"))
    rec = record("qwen_column_attention",
                 "whisperjav_tpu_torch/csrc/qwen_column_attention.cu",
                 "none (the JAX package's Qwen step has no Pallas kernel)",
                 worst, main["ms"], main["plain_ms"],
                 (main["bound_ms"], "bytes"),
                 per="one layer-step, L=28, B=32, T_max=1201, pos 913, f32",
                 cases=cases)
    rec["library_ms"] = main["library_ms"]
    return rec


@contextlib.contextmanager
def parameter_devices():
    """Inside the block, record the devices of the Qwen generator's and
    the forced aligner's parameters after every load (the pipeline
    unloads them when a file is done)."""
    from whisperjav_tpu_torch.modules.subtitle_pipeline import components
    seen = {"generator": set(), "aligner": set()}
    saved = {}

    def spy(cls, key, params):
        orig = saved[cls] = cls.load

        def load(self):
            orig(self)
            seen[key] |= {t.device.type for t in params(self).parameters()}
        cls.load = load
    spy(components.QwenGenerator, "generator", lambda g: g._params)
    spy(components.QwenAlignerAdapter, "aligner",
        lambda a: a._aligner.params)
    try:
        yield seen
    finally:
        for cls, orig in saved.items():
            cls.load = orig


def run_qwen_cli_path(tmp: Path, label: str, flags: list, needed: tuple):
    """``--mode qwen`` on the synthetic QWEN_CLIP_S clip through
    ``cli.main``; launch counts zeroed just before and read just after;
    the SRT and metadata must parse, the pipeline be qwen with two scenes
    or more, every cue lie inside the clip, the generate and align stages
    take time, and the kernels in ``needed`` have launched."""
    from whisperjav_tpu_torch import cli
    wav = tmp / "smoke.wav"
    duration = synthetic_clip(wav, QWEN_CLIP_S)
    out_dir = tmp / f"out-{label.replace(' ', '-')}"
    counters = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    with parameter_devices() as devices:
        t0 = time.perf_counter()
        rc = cli.main([str(wav), "--output-dir", str(out_dir), "--mode",
                       "qwen", *flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise RuntimeError(f"{label}: whisperjav-torch exited {rc}")
    cues = srt_cues(out_dir / "smoke.ja.whisperjav.srt")
    meta = json.loads((out_dir / "smoke.whisperjav.json").read_text(
        encoding="utf-8"))
    stats = meta["stats"]
    stage = stats["stage_s"]
    if meta["pipeline"] != "qwen" or meta["scenes"] < 2:
        raise RuntimeError(f"{label}: pipeline {meta['pipeline']!r}, "
                           f"{meta['scenes']} scenes")
    for start, end in cues:
        if not 0.0 <= start <= end <= duration + 1.0:
            raise RuntimeError(f"{label}: subtitle outside the clip: "
                               f"{start}-{end}")
    if not (stage.get("generate", 0) > 0 and stage.get("align", 0) > 0):
        raise RuntimeError(f"{label}: stages {stage}")
    # the Whisper generator's engine is checked by its kernels' launches
    if devices["aligner"] != {"cuda"} or ("--generator" not in flags
                                          and devices["generator"]
                                          != {"cuda"}):
        raise RuntimeError(f"{label}: parameters on {devices}")
    missing = [name for name in needed if launches[name] < 1]
    if missing:
        raise RuntimeError(f"{label}: kernels of the path never launched: "
                           f"{missing} ({launches})")
    log(f"{label} path (--mode qwen {' '.join(flags)}): clip "
        f"{duration:.3f} s, wall {wall:.3f} s, file RTF "
        f"{duration / wall:.3f}x (e2e_wall_s {stats['e2e_wall_s']}, "
        f"e2e_rtf_x {stats['e2e_rtf_x']}), scenes {meta['scenes']}, frames "
        f"{stats['windows']}, subtitles {stats['final_subtitles']}, "
        f"parameter devices {json.dumps({k: sorted(v) for k, v in devices.items()})}")
    log(f"{label} path stages (s): {json.dumps(stage)}; alignment "
        f"{json.dumps(meta['analytics']['alignment_metrics'])}")
    log(f"{label} path peak device memory: {peak} bytes "
        f"({peak / 2**30:.3f} GiB); launches {json.dumps(launches)}")
    return launches


def qwen_costs(dev):
    """The Qwen path's own costs at Qwen3-ASR-1.7B full width: one B=32
    batch of 8 s clips (the main path's frames padded to whole 4 s
    windows): the AuT encode; generate at 16 steps and at the budget, in
    turns, whose difference over the step difference is the ms per step;
    16 LM steps enqueued without a sync (the host's time a step); two
    short generates under torch.profiler for the device's busy share of
    the steps and the kernels that take the most device time; then
    ``align_spans`` per bucket at the main path's shapes (wall, Viterbi
    included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from whisperjav_tpu_torch.models.qwen import aligner as qa
    from whisperjav_tpu_torch.models.qwen import model as qm
    from whisperjav_tpu_torch.modules.subtitle_pipeline.components import (
        QwenGenerator,
    )
    from whisperjav_tpu_torch.ops.mel import log_mel_spectrogram
    gen = QwenGenerator("qwen3-asr-1.7b", batch_size=32, device=dev)
    gen.load()
    model, cfg = gen._params, gen.cfg
    audio = np.zeros((32, 8 * SR), np.float32)
    for r in range(32):
        n = int((5.0 + 0.09 * r) * SR)
        audio[r, :n] = speech_like(8.0, r)[:n]
    mel = log_mel_spectrogram(torch.from_numpy(audio).to(dev),
                              n_mels=cfg.n_mels)
    audio_len = cfg.audio_tokens_for(mel.shape[-1])
    budget = gen.budget(8.0)
    qm.generate(model, mel, 8, audio_len)                      # warm-up
    _, enc_s = _timed(lambda: qm.encode_audio(model, mel))
    # ms per step: generates of 16 steps and of the budget, in turns
    walls = {16: [], budget: []}
    for steps in (16, budget, budget, 16):
        res, wall = _timed(lambda: qm.generate(model, mel, steps, audio_len))
        walls[steps].append(wall)
    w16, wb = statistics.median(walls[16]), statistics.median(walls[budget])
    step_ms = (wb - w16) / (budget - 16) * 1e3
    # the host's share: 16 LM steps enqueued without a sync (no argmax,
    # penalty or log-softmax), then the sync
    cache = qm.LMCache.zeros(cfg, 32, audio_len + 40, torch.float32, dev)
    emb = model.tok_emb[torch.full((32, 1), 7, device=dev)]
    qm.lm_step(model, emb, audio_len, cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(16):
        qm.lm_step(model, emb, audio_len + 1 + i, cache)
    host_ms = (time.perf_counter() - t0) / 16 * 1e3
    torch.cuda.synchronize()
    lm_ms = (time.perf_counter() - t0) / 16 * 1e3
    del cache
    # the device's share of the steps: two short generates under the
    # profiler (device activity only, few events), the difference
    prof_runs = {}
    for steps in (8, 24):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall = _timed(lambda: qm.generate(model, mel, steps,
                                                 audio_len))
        by_name = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                by_name[e.key] = (e.count, e.device_time_total)
        prof_runs[steps] = (wall, by_name)
    (w1, p1), (w2, p2) = prof_runs[8], prof_runs[24]
    b1 = sum(t for _, t in p1.values()) / 1e6
    b2 = sum(t for _, t in p2.values()) / 1e6
    busy = (b2 - b1) / (w2 - w1) if w2 > w1 else float("nan")
    top = sorted(((k, (n - p1.get(k, (0, 0))[0], t - p1.get(k, (0, 0))[1]))
                  for k, (n, t) in p2.items()), key=lambda kv: -kv[1][1])[:8]
    log(f"qwen3-asr-1.7b generate B=32, 8 s clips ({audio_len} audio "
        f"tokens), int8 LM: AuT encode {enc_s * 1e3:.3f} ms a batch; "
        f"generate 16 steps {w16:.4f} s, {budget} steps {wb:.4f} s "
        f"(medians of {json.dumps(walls)}; shortest row "
        f"{int(res.length.min())} tokens) -> {step_ms:.3f} ms per step; an "
        f"LM step alone: {host_ms:.3f} ms of host enqueue, {lm_ms:.3f} ms "
        f"to the sync; profiled 8 -> 24 steps: {(w2 - w1) / 16 * 1e3:.3f} "
        f"ms per step of wall, device busy {100 * busy:.1f}% "
        f"({(b2 - b1) / 16 * 1e3:.3f} ms of device time a step); the "
        f"steps' top kernels: " + "; ".join(
            f"{name[:70]} x{n // 16} {t / 1e3 / 16:.4f} ms/step"
            for name, (n, t) in top))
    del gen, model
    torch.cuda.empty_cache()
    # align_spans at the main path's buckets: rows 8 and 32, 4 and 8 s
    params = qa.init_params(qa.AlignerConfig(),
                            torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    rng = np.random.default_rng(4)
    for rows, secs, n_tok in ((8, 4, 64), (32, 8, 128)):
        a16 = np.round(audio[:rows, :secs * SR] * 32767).astype(np.int16)
        args = (params, torch.from_numpy(a16).to(dev),
                torch.from_numpy(rng.integers(0, 4096, (rows, n_tok))).to(dev),
                torch.full((rows,), secs * SR - 999, device=dev),
                torch.full((rows,), n_tok - 3, device=dev))
        ms = call_ms(lambda: qa.align_spans(*args), 5)
        log(f"align_spans bucket rows={rows} audio={secs} s tokens={n_tok}: "
            f"{ms:.3f} ms a call (wall: mel, similarity, the Viterbi over "
            f"{secs * 25} frame columns on the card, backtrack on the host)")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# vad phase
# ---------------------------------------------------------------------------

def long_track(seconds: float, seed: int) -> np.ndarray:
    """``seconds`` of speech-like bursts (2-8 s) between silences (0.3-3 s),
    made in bulk from one seed."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n, dtype=np.float32) / SR
    env = np.zeros(n, np.float32)
    pos = 0
    while pos < n:
        speech = int(rng.uniform(2.0, 8.0) * SR)
        env[pos:pos + speech] = 1.0
        pos += speech + int(rng.uniform(0.3, 3.0) * SR)
    voice = (0.3 * np.sin(2 * np.pi * 180 * t)
             * (1 + 0.5 * np.sin(2 * np.pi * 4 * t)))
    return (voice * env + 0.02 * rng.standard_normal(n).astype(np.float32)
            ).astype(np.float32)


def check_vad_network(dev, label: str, module, cpu_model, gpu_model,
                      tracks: dict) -> None:
    """One small VAD network (Silero or TEN) on each track, GPU (f32, no
    TF32) against CPU: max |dp| within VAD_TOL_P, and each side's wall
    (the GPU's to a sync, after one warm-up call on the first track)."""
    first = next(iter(tracks.values()))
    module.probs(gpu_model, torch.from_numpy(first[None]).to(dev))
    for name, audio in tracks.items():
        x = torch.from_numpy(audio[None])
        got, gpu_s = _timed(lambda: module.probs(gpu_model, x.to(dev)))
        t0 = time.perf_counter()
        want = module.probs(cpu_model, x)
        cpu_s = time.perf_counter() - t0
        got = got.cpu()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"{label} {name}: bad output on the GPU")
        err = (got - want).abs().max().item()
        log(f"{label} {name} ({len(audio) / SR:.0f} s, {want.shape[1]} "
            f"frames): max |dp| GPU vs CPU {err:.3g} (tol {VAD_TOL_P}); "
            f"GPU {gpu_s:.4f} s to the sync, CPU {cpu_s:.4f} s; speech "
            f"frames (p >= 0.5) {int((want >= 0.5).sum())}")
        if err > VAD_TOL_P:
            raise RuntimeError(f"{label} {name}: the GPU disagrees with the "
                               f"CPU")


def check_kernels_whisperseg(dev, gen, kernels: list) -> None:
    """Kernel A and Kernel B (bf16 form, the one WhisperSeg's bf16 decoder
    takes) at the WhisperSeg network's shapes: the encoder's (4, 1500, 8,
    64) attention, and the decoder prefill's cross-attention, R = 1500
    query rows per int8 K/V row at T = 1500 (L = 2, B = 4, H = 8); each
    against its plain version, with device time, bound and the library
    yardstick (SDPA; for Kernel B on K/V dequantised beforehand, f32).
    Added to the kernels' records under ``whisperseg``."""
    import itertools
    from whisperjav_tpu_torch.ops.cuda import decode_attention as da
    from whisperjav_tpu_torch.ops.cuda.encoder_attention import (
        attention, encoder_attention,
    )
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shape = (4, 1500, 8, 64)
    b, t, h, hd = shape
    q, k = ((torch.randn(shape, generator=gen, device=dev) * 3).bfloat16()
            for _ in range(2))
    v = torch.randn(shape, generator=gen, device=dev).bfloat16()
    out = encoder_attention(q, k, v).float()
    ref = attention(q, k, v).float()
    err = (out - ref).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    tol = A_TOL_REL_MAX * ref.abs().max().item()
    if not torch.isfinite(out).all() or max_err > tol \
            or mean_err > A_TOL_MEAN:
        raise RuntimeError(f"encoder_attention {shape} disagrees with its "
                           f"plain version: {max_err} (tol {tol}), mean "
                           f"{mean_err}")
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    ms = device_ms(lambda: encoder_attention(q, k, v), iters=50)
    library_ms = device_ms(lambda: sdpa(qh, kh, vh), iters=50)
    plain_ms = device_ms(lambda: attention(q, k, v), iters=10)
    bnd = bound(4 * q.numel() * 2, 4 * b * h * t * t * hd, PEAK_BF16)
    log(f"kernel A encoder_attention {shape} bf16 (WhisperSeg encoder): "
        f"max_abs_err {max_err:.6g} (tol {tol:.6g}) mean {mean_err:.6g}; "
        f"{ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, "
        f"{100 * bnd[0] / ms:.1f}%), scaled_dot_product_attention "
        f"{library_ms:.4f} ms, plain {plain_ms:.4f} ms")
    a_rec = {"shape": list(shape), "max_abs_err": max_err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
             "library_ms": library_ms}
    del q, k, v, qh, kh, vh, out, ref, err
    n_layer, rows = 2, 1500
    k8, v8 = (torch.randint(-127, 128, (n_layer, b, h, hd, t), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    vs = torch.rand(n_layer, b, h, generator=gen, device=dev) * 0.02
    q = torch.randn(b, rows, h, hd, generator=gen, device=dev) * 0.01
    worst = {}
    for layer in range(n_layer):
        out = da.decode_cross_attention(q, k8, v8, layer)
        ref = da.decode_cross_attention_plain(q, k8, v8, layer)
        o16 = da.decode_cross_attention_bf16(q, k8, v8, layer, vs).float()
        r16 = da.decode_cross_attention_bf16_plain(q, k8, v8, layer,
                                                   vs).float()
        errs = {"f32": ((out - ref).abs().max().item(),
                        B_TOL_REL_MAX * ref.abs().max().item()),
                "bf16": ((o16 - r16).abs().max().item(), _bf16_step(r16))}
        bad = {k_: e for k_, e in errs.items() if e[0] > e[1]}
        if bad or not torch.isfinite(o16).all():
            raise RuntimeError(f"decode_cross_attention R={rows} layer "
                               f"{layer} disagrees with its plain version: "
                               f"{errs}")
        for k_, e in errs.items():
            worst[k_] = max(worst.get(k_, (0.0, e[1])), e)
    del out, ref, o16, r16

    def walk(fn, *extra):
        layers = itertools.cycle(range(n_layer))
        return lambda: fn(q, k8, v8, next(layers), *extra)
    ms = device_ms(walk(da.decode_cross_attention_bf16, vs), 20)
    f32_ms = device_ms(walk(da.decode_cross_attention), 20)
    plain_ms = device_ms(walk(da.decode_cross_attention_bf16_plain, vs), 5)
    # the library yardstick: SDPA on the same q and the K/V dequantised
    # (in f32, outside the timing; q already holds the scales)
    qf = q.transpose(1, 2)                                 # (B, H, R, hd)
    kv = [(k8[i].float().transpose(2, 3).contiguous(),
           v8[i].float().transpose(2, 3).contiguous())
          for i in range(n_layer)]
    cyc = itertools.cycle(kv)

    def library():
        kl, vl = next(cyc)
        return sdpa(qf, kl, vl, scale=1.0)
    library_ms = device_ms(library, 20)
    bnd = bound(2 * b * h * hd * t + 4 * b * rows * h * hd
                + 2 * b * rows * h * hd, 4 * b * rows * h * hd * t, PEAK_F32)
    log(f"kernel B decode_cross_attention WhisperSeg prefill L={n_layer} "
        f"B={b} R={rows} T={t} H={h}: max_abs_err "
        + ", ".join(f"{k_} {e:.6g} (tol {tl:.6g})"
                    for k_, (e, tl) in worst.items())
        + f"; bf16 form {ms:.4f} ms (f32 form {f32_ms:.4f} ms), bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}, {100 * bnd[0] / ms:.1f}%), plain "
        f"{plain_ms:.4f} ms, SDPA on dequantised f32 K/V {library_ms:.4f} ms"
        f" ({math.ceil(rows / 8)} grid rows of 8 query rows each)")
    b_rec = {"b": b, "r": rows, "t": t, "h": h, "l": n_layer,
             "max_abs_err": worst["bf16"][0], "ms": ms, "f32_ms": f32_ms,
             "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
             "library_ms": library_ms}
    del k8, v8, vs, q, qf, kv
    torch.cuda.empty_cache()
    for rec in kernels:
        if rec["name"] == "encoder_attention":
            rec["whisperseg"] = a_rec
        elif rec["name"] == "decode_cross_attention":
            rec["whisperseg"] = b_rec


def whisperseg_weights(seed: int):
    """WhisperSeg at SEG_CONFIG from a seeded init, on the CPU, in f32,
    with two changes that make its frames differ: the decoder positions
    are Whisper's sinusoids (with the init's zero positions every query
    token is the same, and so is every frame's logit), and the head's
    bias is minus the median logit over a synthetic 30 s window, so
    about half of that window's frames cross 0.5."""
    from whisperjav_tpu_torch.models.vad import whisperseg as ws
    from whisperjav_tpu_torch.models.layers import sinusoid_positions
    model = ws.init_params(torch.Generator().manual_seed(seed))
    cfg = model.config
    model.decoder.pos_emb.data = torch.from_numpy(
        sinusoid_positions(cfg.n_text_ctx, cfg.n_text_state))
    x = torch.from_numpy(long_track(30.0, 9)[None])
    model.head["b"].data -= ws.frame_logits(model, x)[0].median()
    return model


def check_whisperseg_network(dev) -> None:
    """WhisperSeg at Whisper-base widths (SEG_CONFIG: d = 512, 8 heads x
    64, 6 + 2 layers, 80 mels) from one seed, on a B = 4 batch of 30 s
    windows: bf16 on the GPU (Kernel A, Kernel B's bf16 form at R = 1500)
    against f32 on the CPU (the plain versions); max |dp| within
    WS_TOL_P, and how many frames cross 0.5 on each side and disagree."""
    from whisperjav_tpu_torch.models.vad import whisperseg as ws
    cpu_model = whisperseg_weights(3)
    gpu_model = ws.params_from_jax(ws._tree(cpu_model), ws.SEG_CONFIG,
                                   dtype=torch.bfloat16, device=dev)
    audio = long_track(120.0, 5).reshape(4, ws.N_SAMPLES)
    x = torch.from_numpy(audio)
    ws.probs(gpu_model, x.to(dev))                        # warm-up
    got, gpu_s = _timed(lambda: ws.probs(gpu_model, x.to(dev)))
    t0 = time.perf_counter()
    want = ws.probs(cpu_model, x)
    cpu_s = time.perf_counter() - t0
    got = got.cpu()
    if got.shape != (4, ws.N_FRAMES) or not torch.isfinite(got).all():
        raise RuntimeError(f"whisperseg: bad GPU output {tuple(got.shape)}")
    err = (got - want).abs().max().item()
    over_g, over_c = got >= 0.5, want >= 0.5
    log(f"whisperseg SEG_CONFIG B=4 x 30 s: max |dp| GPU bf16 vs CPU f32 "
        f"{err:.4g} (tol {WS_TOL_P}); frames >= 0.5: GPU "
        f"{int(over_g.sum())}, CPU {int(over_c.sum())} of {want.numel()}, "
        f"{int((over_g != over_c).sum())} differ; GPU {gpu_s:.4f} s to "
        f"the sync, CPU {cpu_s:.3f} s")
    if err > WS_TOL_P:
        raise RuntimeError("whisperseg on the GPU disagrees with the CPU")
    del gpu_model
    torch.cuda.empty_cache()


@contextlib.contextmanager
def counting(module, name: str):
    """Count the calls of ``module.<name>`` inside the block."""
    orig = getattr(module, name)
    calls = {"n": 0}

    def wrapped(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)
    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def run_vad_phase(dev, gen, tmp: Path, kernels: list) -> dict:
    """The VAD networks: Silero v5 and TEN (seeded, saved as .npz in the
    JAX package's layout and loaded back) on a 60 s clip and a 1-hour
    track, GPU against CPU; WhisperSeg at Whisper-base widths; Kernels A
    and B at WhisperSeg's shapes; then two CLI runs: the flagless path
    with ``--vad-arg weights=<silero npz>`` and ``--mode qwen
    --qwen-segmenter whisperseg --vad-arg weights=<whisperseg npz>``.
    Returns each CLI run's launches."""
    from whisperjav_tpu_torch.models.vad import silero, ten, whisperseg
    # whole 512-sample chunks (Silero's; two of TEN's hops)
    tracks = {name: x[:len(x) // 512 * 512] for name, x in (
        ("60 s clip", long_track(60.0, 1)),
        ("1-hour track", long_track(3600.0, 2)))}
    for label, module, seed in (("silero v5", silero, 1), ("ten", ten, 2)):
        npz = tmp / f"{label.split()[0]}.npz"
        module.save_params(str(npz), module.init_params(
            torch.Generator().manual_seed(seed)))
        cpu_model = module.load_params(str(npz))
        gpu_model = module.load_params(str(npz), device=dev)
        check_vad_network(dev, label, module, cpu_model, gpu_model, tracks)
        del gpu_model
    check_kernels_whisperseg(dev, gen, kernels)
    check_whisperseg_network(dev)
    ws_npz = tmp / "whisperseg.npz"
    whisperseg.save_params(str(ws_npz), whisperseg_weights(4))
    launches = {}
    with counting(silero, "probs") as calls:
        launches["vad_silero"] = run_cli_path(
            tmp, "silero network", VAD_CLIP_S,
            ["--vad-arg", f"weights={tmp / 'silero.npz'}"], TURBO_NEEDS)[0]
    log(f"silero network path: the network scored {calls['n']} scenes")
    if calls["n"] < 1:
        raise RuntimeError("silero network path: the network never ran")
    torch.cuda.empty_cache()
    with counting(whisperseg, "probs") as calls:
        launches["vad_whisperseg_qwen"] = run_qwen_cli_path(
            tmp, "qwen whisperseg",
            ["--qwen-segmenter", "whisperseg", "--vad-arg",
             f"weights={ws_npz}", "--no-signature"], WHISPERSEG_NEEDS)
    log(f"qwen whisperseg path: {calls['n']} WhisperSeg batches")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def port_is_free(port: int) -> bool:
    """Nothing listens on ``port``: a new server (which sets SO_REUSEADDR,
    as ThreadingHTTPServer does) can bind it."""
    import socket
    with socket.socket() as sock:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            sock.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def post(port: int, body: bytes, ctype: str = "application/json"):
    """POST /transcribe; returns (status, text, seconds)."""
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}/transcribe",
                                 data=body, headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read().decode("utf-8"), \
            time.perf_counter() - t0


def run_serve_phase(dev, tmp: Path) -> dict:
    """The resident engine: an in-process server (port 0) around the
    flagless turbo service on the card (B = 32); 4 concurrent
    /transcribe requests of distinct clips (coalesced), the same clips
    one after another with coalescing off, and one audio/wav body; the
    serial responses must equal, byte for byte, the SRTs the in-process
    CLI writes for the same clips on the same seeded weights. Both sides
    run without the sanitizer (``--no-sanitize``), which drops every cue
    of the random weights' text and would leave empty SRTs to compare;
    the clips must give cues. Then the
    CLI's --daemon route: it must autostart ``python -m
    whisperjav_tpu_torch.serve`` on cuda, whose /health reports the card
    and the torch backend, write both SRTs, and --daemon-stop must free
    the port. Returns the coalesced requests' launches."""
    import concurrent.futures as cf
    from whisperjav_tpu_torch import cli, serve
    from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
    from whisperjav_tpu_torch.pipelines import daemon_client
    from whisperjav_tpu_torch.pipelines.factory import build_pipeline
    clips = []
    for i, seconds in enumerate(SERVE_CLIPS_S):
        path = tmp / f"serve{i}.wav"
        synthetic_clip_seeded(path, seconds, 10 + i)
        clips.append(path)
    # the in-process CLI's SRTs, the serial responses' reference
    ref_dir = tmp / "serve-cli"
    if cli.main([*map(str, clips), "--output-dir", str(ref_dir),
                 "--no-signature", "--no-sanitize"]) != 0:
        raise RuntimeError("serve: the in-process CLI run failed")
    want = [(ref_dir / f"{c.stem}.ja.whisperjav.srt").read_text(
        encoding="utf-8") for c in clips]
    torch.cuda.empty_cache()

    cfg = resolve_pipeline_config()
    pipeline, load_s = _timed(lambda: build_pipeline(cfg, device=dev))
    fingerprint = daemon_client._fingerprint(cfg)
    encodes = {"n": 0}
    encode_batch = pipeline.engine.encode_batch

    def counted_encode(*a, **k):
        encodes["n"] += 1
        return encode_batch(*a, **k)
    pipeline.engine.encode_batch = counted_encode
    bodies = [json.dumps({"path": str(c)}).encode() for c in clips]
    audio_s = sum(wave_seconds(c) for c in clips)
    results = {}
    counters = kernel_counters()
    for mode, linger in (("coalesced", 30.0), ("serial", 0.0)):
        service = serve.TranscriptionService(
            pipeline, linger_ms=linger, device=dev, fingerprint=fingerprint)
        server = serve.make_server(service)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            encodes["n"] = 0
            if mode == "coalesced":
                # the first request pays the first batch's costs
                first = post(port, bodies[0])
                torch.cuda.synchronize()
                for fn in counters.values():
                    fn.launches = 0
                encodes["n"] = 0
                t0 = time.perf_counter()
                with cf.ThreadPoolExecutor(len(bodies)) as pool:
                    replies = list(pool.map(lambda b: post(port, b),
                                            bodies))
                wall = time.perf_counter() - t0
                launches = {n: fn.launches for n, fn in counters.items()}
                batches = encodes["n"]
                wav_reply = post(port, clips[0].read_bytes(), "audio/wav")
            else:
                t0 = time.perf_counter()
                replies = [post(port, b) for b in bodies]
                wall = time.perf_counter() - t0
                batches = encodes["n"]
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        for status, text, _ in replies:
            if status != 200:
                raise RuntimeError(f"serve {mode}: status {status}")
            srt_text_cues(text)
        results[mode] = {"replies": replies, "wall": wall,
                         "batches": batches}
        log(f"serve {mode} ({len(bodies)} requests, {audio_s:.3f} s of "
            f"audio): wall {wall:.3f} s, {60 * len(bodies) / wall:.2f} "
            f"requests and {60 * audio_s / wall:.1f} audio-seconds a "
            f"minute; request walls "
            f"{[round(r[2], 3) for r in replies]}; {batches} engine "
            f"batches (encodes, temperature-ladder rungs included)")
    if wav_reply[0] != 200:
        raise RuntimeError(f"serve audio/wav body: status {wav_reply[0]}")
    srt_text_cues(wav_reply[1])
    log(f"serve: engine load {load_s:.3f} s (to a sync); first request "
        f"{first[2]:.3f} s, steady requests (serial) "
        f"{[round(r[2], 3) for r in results['serial']['replies']]} s; "
        f"audio/wav body {wav_reply[2]:.3f} s, "
        f"{len(srt_text_cues(wav_reply[1]))} cues; coalesced batches "
        f"{results['coalesced']['batches']} vs serial batches "
        f"{results['serial']['batches']}")
    n_cues = sum(len(srt_text_cues(w)) for w in want)
    if n_cues < 1:
        raise RuntimeError("serve: the CLI's SRTs hold no cue to compare")
    serial = [r[1] for r in results["serial"]["replies"]]
    if serial != want:
        bad = [i for i, (a, b) in enumerate(zip(serial, want)) if a != b]
        raise RuntimeError(f"serve: serial responses {bad} differ from the "
                           f"in-process CLI's SRT")
    differ = sum(a != b for r, w in zip(results["coalesced"]["replies"],
                                        want)
                 for a, b in zip_longest(srt_text_cues(r[1]),
                                         srt_text_cues(w)))
    log(f"serve: serial responses equal the in-process CLI's SRTs ({n_cues} "
        f"cues) byte for byte; coalesced responses: {differ} cues differ "
        f"from them")
    missing = [n for n in TURBO_NEEDS if launches[n] < 1]
    if missing:
        raise RuntimeError(f"serve: kernels never launched: {missing}")
    del pipeline, service
    torch.cuda.empty_cache()
    run_daemon_route(tmp, clips[:2])
    return launches


def run_daemon_route(tmp: Path, clips: list) -> None:
    """``whisperjav-torch a.wav b.wav --daemon --daemon-port <free>`` then
    ``--daemon-stop``; the daemon process is stopped in any case."""
    from whisperjav_tpu_torch import cli
    from whisperjav_tpu_torch.pipelines import daemon_client
    port = free_port()
    out_dir = tmp / "daemon-out"
    try:
        t0 = time.perf_counter()
        rc = cli.main([*map(str, clips), "--daemon", "--daemon-port",
                       str(port), "--output-dir", str(out_dir)])
        wall = time.perf_counter() - t0
        health = daemon_client._health(port) or {}
        if rc != 0:
            raise RuntimeError(f"--daemon run exited {rc}")
        for c in clips:
            srt_cues(out_dir / f"{c.stem}.ja.whisperjav.srt")
        log(f"--daemon: {len(clips)} files in {wall:.3f} s (autostart "
            f"included); /health {json.dumps(health, ensure_ascii=False)}")
        if not (str(health.get("device", "")).startswith(DAEMON_DEVICE)
                and health.get("backend") == "torch"):
            raise RuntimeError(f"--daemon: /health says {health}")
        if cli.main(["--daemon-stop", "--daemon-port", str(port)]) != 0:
            raise RuntimeError("--daemon-stop failed")
        deadline = time.time() + 60
        while not port_is_free(port) and time.time() < deadline:
            time.sleep(0.5)
        if not port_is_free(port):
            raise RuntimeError(f"--daemon-stop: port {port} still bound")
        log(f"--daemon-stop: port {port} free")
    finally:
        if daemon_client._health(port) is not None:
            daemon_client.stop_daemon(port)
        subprocess.run(["pkill", "-f", f"whisperjav_tpu_torch.serve --port "
                        f"{port}"], check=False)


# ---------------------------------------------------------------------------
# the enhance phase: the heavy enhancers
# ---------------------------------------------------------------------------

def _attn_flops(n_seq: int, n: int, dim: int, heads: int, dh: int,
                hidden: int, gates: bool) -> float:
    """One pre-norm transformer layer over ``n_seq`` sequences of ``n``:
    the q/k/v and output projections, the logits and weighted sums, the
    per-head gates (BS-RoFormer) and the two FFN matrices."""
    inner = heads * dh
    rows = n_seq * n
    ops = 2 * rows * dim * 3 * inner + 2 * rows * inner * dim
    ops += 2 * 2 * n_seq * heads * n * n * dh
    ops += 2 * rows * dim * hidden * 2
    if gates:
        ops += 2 * rows * dim * heads
    return ops


def _stft_flops(n_fft: int, frames: int, forward: int = 1,
                inverse: int = 1) -> float:
    """``forward`` transforms (a strided conv with the (2F, n_fft) basis)
    and ``inverse`` ones (a matmul with it) over ``frames`` frames."""
    return 2 * (forward + inverse) * frames * (n_fft + 2) * n_fft


def bsr_flops(cfg, frames: int) -> float:
    """Operations of one BS-RoFormer separation of one chunk: the band
    split, ``depth`` time and band transformers, the mask heads, the
    STFT and ISTFT; 2 per multiply-add (norms and activations left
    out)."""
    nb, dim = len(cfg.freqs_per_bands), cfg.dim
    hidden_ff = dim * cfg.ff_mult
    ops = 2 * frames * sum(cfg.dim_inputs) * dim
    for _ in range(cfg.depth):
        ops += cfg.time_transformer_depth * _attn_flops(
            nb, frames, dim, cfg.heads, cfg.dim_head, hidden_ff, True)
        ops += cfg.freq_transformer_depth * _attn_flops(
            frames, nb, dim, cfg.heads, cfg.dim_head, hidden_ff, True)
    hid = dim * cfg.mlp_expansion_factor
    for d_in in cfg.dim_inputs:
        per = dim * hid + hid * hid * (cfg.mask_estimator_depth - 1) \
            + hid * 2 * d_in
        ops += cfg.num_stems * 2 * frames * per
    return float(ops + _stft_flops(cfg.n_fft, frames, cfg.channels,
                                   cfg.channels * cfg.num_stems))


def mf2_flops(cfg, frames: int) -> float:
    """Operations of one MossFormer2 enhance of one chunk: the fbank (rFFT
    counted as 5 n log2 n, the mel matrix), the mask net (per block the
    FLASH projections, group and linear attention, the gated FSMN block;
    the encoder, gates and decoder), the hamming STFT and inverse."""
    s, d, h, qk = frames, cfg.d_model, cfg.hidden, cfg.qk_dim
    inner, g = cfg.fsmn_inner, cfg.group_size
    groups = -(-s // g)
    per = 2 * s * d * 2 * h + 2 * s * d * qk + 2 * s * h * d
    per += 2 * groups * g * g * qk + 2 * 2 * groups * g * g * h
    per += 2 * 2 * 2 * s * qk * h
    per += 2 * s * d * inner + 2 * 2 * s * inner * inner
    per += 2 * 2 * s * inner * inner + 2 * s * inner * (2 * cfg.lorder - 1)
    per += 2 * s * inner * d + 2 * s * 17 * (2 * h + qk + d + 2 * inner)
    ops = cfg.num_blocks * per
    ops += 2 * s * cfg.n_mels * d + 3 * 2 * s * d * d + 2 * s * d * cfg.n_freqs
    ops += s * (5 * cfg.n_fft * math.log2(cfg.n_fft)
                + 2 * cfg.n_freqs * cfg.n_mels)
    return float(ops + _stft_flops(cfg.n_fft, frames))


def frcrn_flops(cfg, frames: int) -> float:
    """Operations of one FRCRN denoise of one chunk: per U-Net the four
    real convolutions of every complex (transposed) convolution and the
    four FSMN passes of every complex FSMN, twice (the cascade), and the
    STFT and ISTFT."""
    def stage(geom, f_in, t_in, transpose):
        kh, kw = geom.kernel
        if transpose:
            f_out, t_out = 2 * f_in, t_in - 1
            conv = 2 * geom.c_in * geom.c_out * kh * kw * f_in * t_in
        else:
            f_out, t_out = (f_in + 2 * 2 - kh) // 2 + 1, t_in + 1
            conv = 2 * geom.c_in * geom.c_out * kh * kw * f_out * t_out
        ops = 4 * conv
        if geom.fsmn:
            c = geom.c_out
            ops += 4 * (2 * 2 * c * c + 2 * c * (2 * cfg.lorder - 1)) \
                * f_out * t_out
        return ops, f_out, t_out

    ops, f, t, sizes = 0.0, cfg.n_freqs, frames, []
    for geom in cfg.encoders:
        o, f, t = stage(geom, f, t, False)
        ops += o
        sizes.append((f, t))
    for i, geom in enumerate(cfg.decoders):
        o, f, t = stage(geom, f, t, True)
        ops += o
        if i < len(cfg.decoders) - 1:
            f, t = sizes[len(cfg.decoders) - 2 - i]
    return float(2 * ops + _stft_flops(cfg.n_fft, frames))


def bandsplit_flops(cfg, frames: int) -> float:
    """Operations of the legacy band-split network on one chunk: the band
    embeddings and masks, ``n_layers`` time and band blocks, the STFT and
    ISTFT."""
    n_freqs = cfg.n_fft // 2 + 1
    d = cfg.d_model
    ops = 2 * 2 * frames * 2 * n_freqs * d
    for _ in range(cfg.n_layers):
        ops += _attn_flops(cfg.n_bands, frames, d, cfg.n_heads,
                           d // cfg.n_heads, 4 * d, False)
        ops += _attn_flops(frames, cfg.n_bands, d, cfg.n_heads,
                           d // cfg.n_heads, 4 * d, False)
    return float(ops + _stft_flops(cfg.n_fft, frames))


def check_enhancer_network(dev, label: str, cpu_model, run, rate: int,
                           flop: float, compare_s: float) -> dict:
    """One network at its published width on one ENHANCE_CHUNK_S chunk of
    synthetic speech at its native ``rate``: ``run(model, x)`` on the GPU
    (device time with CUDA events, the median of three; peak memory) and,
    with the same weights, GPU against CPU on the first ``compare_s``
    seconds (waveforms within ENH_TOL_REL of the input's largest
    magnitude); the kernels of one call from the profiler, their sum
    against the chunk's time (the device's busy share). ``flop``: the
    operations of one chunk."""
    import copy
    n = int(ENHANCE_CHUNK_S * rate)
    audio = speech_like(ENHANCE_CHUNK_S, 11, rate)[None]
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    xg = torch.from_numpy(audio).to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run(gpu_model, xg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if out.shape != xg.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"{label}: bad output on the GPU")
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(gpu_model, xg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    # where the chunk's device time goes: one call under the profiler
    per_kernel, _ = kernel_device_ms(lambda: run(gpu_model, xg), reps=1)
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:4]
    log(f"{label}: profiler: {busy:.3f} ms of kernels in the chunk "
        f"({100 * busy / ms:.1f}% of its {ms:.3f} ms); largest: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in top))
    m = int(compare_s * rate)
    x = torch.from_numpy(audio[:, :m])
    t0 = time.perf_counter()
    want = run(cpu_model, x)
    cpu_s = time.perf_counter() - t0
    got = run(gpu_model, x.to(dev)).cpu()
    err = (got - want).abs().max().item()
    tol = ENH_TOL_REL * x.abs().max().item()
    params = sum(p.numel() for p in cpu_model.parameters())
    # the weights read once, the chunk in and out
    bnd = bound(4 * (2 * n + params), flop, PEAK_F32)
    short = (" (shorter than the chunk: the CPU pass of a full one is "
             "slow)" if compare_s < ENHANCE_CHUNK_S else "")
    log(f"{label}: {params} parameters; one {ENHANCE_CHUNK_S:.0f} s chunk "
        f"at {rate} Hz: device {ms:.3f} ms (median of "
        f"{[round(t, 3) for t in times]}), bound {bnd[0]:.3f} ms by "
        f"{bnd[1]} ({flop / 1e12:.4f} TFLOP at {PEAK_F32 / 1e12:.0f} TFLOP/s "
        f"f32, {100 * bnd[0] / ms:.1f}% of it), peak memory {peak} bytes "
        f"({peak / 2**30:.3f} GiB) over {base} resident; GPU vs CPU on "
        f"{compare_s:g} s{short}: max_abs_err {err:.6g} (tol {tol:.6g}), "
        f"CPU {cpu_s:.3f} s")
    if err > tol:
        raise RuntimeError(f"{label} on the GPU disagrees with the CPU")
    del gpu_model, xg, out
    torch.cuda.empty_cache()
    return {"ms": ms, "bound_ms": bnd[0], "peak_bytes": peak,
            "max_abs_err": err}


def run_enhance_phase(dev, tmp: Path) -> dict:
    """The heavy enhancers at their published widths from seeded weights:
    BS-RoFormer (viperx), MossFormer2_SE_48K, FRCRN_SE_16K and the legacy
    band-split at ClearVoice's 48 kHz / 20 bands / 3 layers, each GPU
    against CPU on one chunk; then the flagless turbo CLI on the ~20 s
    clip with ``--enhancer clearvoice`` (MossFormer2), ``--enhancer-arg
    model=FRCRN_SE_16K`` and ``--enhancer bs-roformer``, each from weights
    written by the port's save_params: every scene enhanced by the
    expected network, Kernel A and Kernel B's bf16 form launched."""
    from whisperjav_tpu_torch.models.enhancement import (
        bandsplit, bs_roformer, frcrn, mossformer2,
    )
    nets = [
        ("bs_roformer", "BS-RoFormer viperx", bs_roformer,
         bs_roformer.BSRoformerConfig(),
         lambda m, x: bs_roformer.isolate_vocals(m, x), bsr_flops,
         BSR_COMPARE_S),
        ("mossformer2", "MossFormer2_SE_48K", mossformer2,
         mossformer2.MOSSFORMER2_SE_48K,
         lambda m, x: mossformer2.enhance(m, x, x.shape[-1]), mf2_flops,
         ENHANCE_CHUNK_S),
        ("frcrn", "FRCRN_SE_16K", frcrn, frcrn.FRCRN_SE_16K,
         lambda m, x: frcrn.denoise(m, x), frcrn_flops, ENHANCE_CHUNK_S),
        ("bandsplit", "legacy band-split (48 kHz, 20 bands, 3 layers)",
         bandsplit, bandsplit.BandSplitConfig(
             sample_rate=48_000, target="noise", n_bands=20, n_layers=3),
         lambda m, x: bandsplit.apply(m, x, x.shape[-1]), bandsplit_flops,
         ENHANCE_CHUNK_S)]
    files = {}
    for seed, (key, label, module, cfg, run, flops, compare_s) in \
            enumerate(nets):
        model = module.init_params(cfg, torch.Generator().manual_seed(seed))
        rate = getattr(cfg, "sample_rate", frcrn.SAMPLE_RATE)
        frames = int(ENHANCE_CHUNK_S * rate) // cfg.hop + 1   # centred
        check_enhancer_network(dev, label, model, run, rate,
                               flops(cfg, frames), compare_s)
        if key != "bandsplit":
            files[key] = tmp / f"{key}.npz"
            t0 = time.perf_counter()
            module.save_params(str(files[key]), model)
            log(f"{label}: wrote {files[key].stat().st_size} bytes with "
                f"save_params in {time.perf_counter() - t0:.3f} s")
        del model
    launches = {}
    for key, flags in (
            ("mossformer2", ["--enhancer", "clearvoice"]),
            ("frcrn", ["--enhancer", "clearvoice", "--enhancer-arg",
                       "model=FRCRN_SE_16K"]),
            ("bs_roformer", ["--enhancer", "bs-roformer"])):
        launches[f"enhance_{key}"], stats = run_cli_path(
            tmp, f"enhance {key}", FIDELITY_CLIP_S,
            [*flags, "--enhancer-weights", str(files[key])], TURBO_NEEDS)
        enh = stats.get("enhancer", {})
        log(f"enhance {key}: {stats['enhanced_scenes']} of {stats['scenes']} "
            f"scenes enhanced by {enh}; stage_s.enhance "
            f"{stats['stage_s']['enhance']} s, e2e_wall_s "
            f"{stats['e2e_wall_s']} s")
        if not stats["enhanced_scenes"] == stats["scenes"] > 0:
            raise RuntimeError(f"enhance {key}: {stats['enhanced_scenes']} "
                               f"of {stats['scenes']} scenes enhanced")
        if enh.get("engines") != [key]:
            raise RuntimeError(f"enhance {key}: the backend reports {enh}")
        torch.cuda.empty_cache()
    return launches


# the qwen3 generator runs no kernel of the port (the Qwen LM and the
# aligner are PyTorch matmuls); the anime-whisper generator runs the
# Whisper engine's unfused bf16 decoder
# ---------------------------------------------------------------------------
# the train phase: the fine-tuning path
# ---------------------------------------------------------------------------

# GPU f32 (no TF32) against CPU f32 train steps at a test width: the
# loss within 1e-5 relative, each gradient leaf within 1e-4 of its
# largest |g|; the updated parameters within 0.05 lr per step where the
# first step's |g| is above 1e-6, everywhere within the 2 lr a step that
# Adam's sign of a gradient at rounding level can part them, and on
# average within 1e-3 lr per leaf
TRAIN_TOL_LOSS = 1e-5
TRAIN_TOL_GRAD = 1e-4
TRAIN_TOL_LR_STEP = 0.05
TRAIN_CONDITIONED_G = 1e-6
TRAIN_PARITY_LR = 1e-3
TRAIN_TOL_LR_ANY = 4.2
# the full-width run: turbo, B = 4 (49.5 GiB peak on an H100, PERF.md
# §5; about 9.5 GiB a sample, so 8 would not fit), 448 tokens, a few
# steps on one repeated batch, the last under the profiler
TRAIN_BATCH = 4
TRAIN_STEPS = 7
# the batch sizes measured beside it (two steps each)
TRAIN_SCAN = (2, 6)
TRAIN_MAX_TOKENS = 448
TRAIN_CUES_PER_WINDOW = 12
TRAIN_CLIP_S = 20.0


def _flat_tree(tree: dict, prefix: str = "") -> dict:
    """A nested parameter tree as state-dict names -> arrays."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat_tree(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = np.asarray(value, np.float32)
    return out


def train_parity_inputs():
    """The train-parity test width (128 mels, d = 256, 4 heads x 64,
    2 + 2 layers, the real vocab), its seeded f32 tree on the CPU, and one
    batch of two rows whose masks hold 7 and 3 targets."""
    from whisperjav_tpu_torch.models.whisper.config import WhisperConfig
    from whisperjav_tpu_torch.models.whisper.weights import init_params
    cfg = WhisperConfig(name="train-test", n_mels=128, n_audio_state=256,
                        n_audio_head=4, n_audio_layer=2, n_text_state=256,
                        n_text_head=4, n_text_layer=2, n_vocab=51866)
    tree = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 128, 3000)).astype(np.float32)
    tokens = rng.integers(0, cfg.n_vocab, (2, 24)).astype(np.int32)
    mask = np.zeros((2, 24), np.float32)
    mask[0, 3:10] = 1.0
    mask[1, 3:6] = 1.0
    return cfg, tree, (mel, tokens, mask)


def train_parity_steps(mesh, steps: int = 2):
    """``steps`` train steps at the parity width on ``mesh`` (every rank
    of it calls this): the losses, the first step's gradients of this
    rank's shard, the whole updated tree (gathered over the
    tensor-parallel ranks) by state-dict name, and the wall."""
    from whisperjav_tpu_torch.parallel import train as tt
    cfg, tree, batch = train_parity_inputs()
    init_fn, step_fn = tt.build_sharded_train_step(
        cfg, mesh, tt.make_optimizer(TRAIN_PARITY_LR, 0.01))
    state = init_fn(tree)
    losses, grads = [], None
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step_fn(state, *batch)
        losses.append(loss)
        if grads is None:
            grads = {n: p.grad.cpu().numpy()
                     for n, p in state.params.named_parameters()}
    wall = time.perf_counter() - t0
    return losses, grads, _flat_tree(tt.full_params(state.params, mesh)), \
        wall


def train_parity_errors(want, got) -> tuple:
    """(loss rel err, worst gradient leaf of its max |g| or None, worst
    parameter error in lr where the first step's |g| is above
    TRAIN_CONDITIONED_G, anywhere, worst leaf mean) of run ``got`` against
    ``want`` (each as :func:`train_parity_steps` returns it; gradients are
    compared where ``got`` holds whole leaves)."""
    (lw, gw, pw, _), (lg, gg, pg, _) = want, got
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lw))
    grad_err = None
    if gg is not None and all(gg[n].shape == gw[n].shape for n in gw):
        grad_err = max(np.abs(gg[n] - gw[n]).max() / np.abs(gw[n]).max()
                       for n in gw)
    lr = TRAIN_PARITY_LR
    worst_cond = worst_any = worst_mean = 0.0
    for n in pw:
        err = np.abs(pg[n] - pw[n]) / lr
        cond = np.abs(gw[n]) > TRAIN_CONDITIONED_G
        worst_cond = max(worst_cond, float(err[cond].max(initial=0.0)))
        worst_any = max(worst_any, float(err.max()))
        worst_mean = max(worst_mean, float(err.mean()))
    return loss_err, grad_err, worst_cond, worst_any, worst_mean


def train_parity_ok(errors, losses) -> bool:
    loss_err, grad_err, worst_cond, worst_any, worst_mean = errors
    return (loss_err <= TRAIN_TOL_LOSS
            and (grad_err is None or grad_err <= TRAIN_TOL_GRAD)
            and worst_cond <= 2 * TRAIN_TOL_LR_STEP
            and worst_any <= TRAIN_TOL_LR_ANY and worst_mean <= 1e-3
            and losses[1] < losses[0])


def train_parity_line(errors) -> str:
    loss_err, grad_err, worst_cond, worst_any, worst_mean = errors
    grads = ("" if grad_err is None else
             f"worst gradient leaf {grad_err:.3e} of its max |g| (tol "
             f"{TRAIN_TOL_GRAD}); ")
    return (f"loss rel err {loss_err:.3e} (tol {TRAIN_TOL_LOSS}); {grads}"
            f"parameters {worst_cond:.3e} lr where |g| > "
            f"{TRAIN_CONDITIONED_G} (tol {2 * TRAIN_TOL_LR_STEP}), "
            f"{worst_any:.3e} lr anywhere (tol {TRAIN_TOL_LR_ANY}), mean "
            f"{worst_mean:.3e} lr (tol 1e-3)")


def check_train_parity(dev):
    """Two f32 train steps from one seeded tree at a test width
    (:func:`train_parity_inputs`) on the GPU and on the CPU: losses, the
    first step's gradients and the updated parameters must agree. Returns
    the GPU run, the one-card reference of the NCCL run."""
    from whisperjav_tpu_torch.parallel import train as tt
    runs = {}
    for where in ("cpu", dev):
        runs[str(where)] = train_parity_steps(
            tt.make_train_mesh(device=where))
    cpu, gpu = runs["cpu"], runs[str(dev)]
    errors = train_parity_errors(cpu, gpu)
    log(f"train parity (d=256, 2+2 layers, B=2, 2 steps, lr "
        f"{TRAIN_PARITY_LR}): losses GPU {gpu[0]} CPU {cpu[0]}, "
        f"{train_parity_line(errors)}; walls GPU {gpu[3]:.3f} s CPU "
        f"{cpu[3]:.3f} s")
    if not train_parity_ok(errors, gpu[0]):
        raise RuntimeError("train parity: the GPU step disagrees with the "
                           "CPU step")
    return gpu


def train_step_flops(cfg, seq: int) -> float:
    """Products of one sample's forward through ``forward`` at ``seq``
    decoder tokens, times 3 for forward plus backward (two products of
    the backward for each of the forward)."""
    d, t, n_mels = cfg.n_audio_state, cfg.n_audio_ctx, cfg.n_mels
    conv = 2 * n_mels * 3 * d * 2 * t + 2 * d * 3 * d * t
    enc = cfg.n_audio_layer * (24 * t * d * d + 4 * t * t * d)
    s = seq
    dec = cfg.n_text_layer * (28 * s * d * d + 4 * s * s * d
                              + 4 * t * d * d + 4 * s * t * d)
    head = 2 * s * d * cfg.n_vocab
    return 3.0 * (conv + enc + dec + head)


def write_train_pairs(data: Path, n_clips: int) -> None:
    """``n_clips`` 60 s WAVs of speech-like bursts, each with an SRT of
    TRAIN_CUES_PER_WINDOW cues of 18-30 characters in each 30 s window."""
    from whisperjav_tpu_torch.modules.srt import Subtitle, save_srt
    data.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    kana = [chr(c) for c in range(0x3042, 0x3094)]
    for i in range(n_clips):
        synthetic_clip_seeded(data / f"pair{i}.wav", 60.0, 20 + i)
        subs, start = [], 0.3
        for w in range(2):
            span = 30.0 / TRAIN_CUES_PER_WINDOW
            for c in range(TRAIN_CUES_PER_WINDOW):
                t0 = 30.0 * w + c * span + 0.1
                text = "".join(rng.choice(kana, int(rng.integers(18, 31))))
                subs.append(Subtitle(len(subs) + 1, t0, t0 + span - 0.3,
                                     text))
        save_srt(data / f"pair{i}.srt", subs)


def train_batch_scan(dev, data: Path, cfg) -> None:
    """The batch sizes of TRAIN_SCAN around TRAIN_BATCH: a fresh seeded
    turbo, two train steps on the pairs of ``data`` (the batch padded by
    repeats), the second step's wall and the peak device memory."""
    from whisperjav_tpu_torch import finetune
    from whisperjav_tpu_torch.models.whisper.tokenizer import (
        WhisperTokenizer,
    )
    from whisperjav_tpu_torch.models.whisper.weights import init_params
    from whisperjav_tpu_torch.parallel import train as tt
    tok = WhisperTokenizer(cfg)
    examples = [ex for wav, srt in finetune.discover_pairs(data)
                for ex in finetune.build_examples(wav, srt, tok, cfg,
                                                  TRAIN_MAX_TOKENS)]
    mesh = tt.make_train_mesh(device=dev)
    for batch in TRAIN_SCAN:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mel, tokens, mask = next(finetune.batch_examples(
            examples[:batch], batch, cfg.n_mels, dev))
        init_fn, step_fn = tt.build_sharded_train_step(
            cfg, mesh, tt.make_optimizer())
        state = init_fn(init_params(
            cfg, torch.Generator(device=dev).manual_seed(0),
            device=dev))
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step_fn(state, mel, tokens, mask)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        del state
        log(f"train batch scan B={batch}: second step {walls[1]:.4f} s, "
            f"{batch / walls[1]:.3f} samples/s, peak device memory {peak} "
            f"bytes ({peak / 2**30:.3f} GiB)")
    torch.cuda.empty_cache()


def run_finetune(dev, tmp: Path) -> dict:
    """``whisperjav-torch-finetune`` in-process on turbo at full width and
    depth from the seeded f32 init: B = TRAIN_BATCH, 448 tokens,
    TRAIN_STEPS steps on one repeated batch (each step timed to a sync);
    then the last checkpoint through the port's load_checkpoint into a
    TranscriptionEngine (bf16) that transcribes one clip, where Kernel A
    and Kernel B's bf16 form must launch. Returns that run's launches."""
    from whisperjav_tpu_torch import finetune
    from whisperjav_tpu_torch.models.whisper.config import WHISPER_SIZES
    from whisperjav_tpu_torch.models.whisper.decode import DecodeOptions
    from whisperjav_tpu_torch.models.whisper.weights import params_from_jax
    from whisperjav_tpu_torch.parallel import train as tt
    from whisperjav_tpu_torch.pipelines.engine import TranscriptionEngine
    from whisperjav_tpu_torch.pipelines.transcribe import TranscribePipeline
    from whisperjav_tpu_torch.utils.checkpoint import (
        checkpoint_metadata, load_checkpoint,
    )
    data, out = tmp / "ft-data", tmp / "ft-out"
    write_train_pairs(data, TRAIN_BATCH // 2)
    steps = []
    build = tt.build_sharded_train_step

    def timed_build(*a, **k):
        init_fn, run_step = build(*a, **k)

        def run(state, mel, tokens, mask):
            from torch.profiler import ProfilerActivity, profile
            last = len(steps) == TRAIN_STEPS - 1
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) \
                if last else contextlib.nullcontext()
            torch.cuda.synchronize()
            with prof:
                t0 = time.perf_counter()
                state, loss = run_step(state, mel, tokens, mask)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            steps.append((wall, loss, float(np.sum(mask[:, 1:]))))
            if last:
                log_profile(prof, wall, f"train step B={TRAIN_BATCH} "
                            "(the last, under the profiler)")
            return state, loss
        return init_fn, run

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tt.build_sharded_train_step = timed_build
    t0 = time.perf_counter()
    try:
        rc = finetune.main(["--data", str(data), "--model", "turbo",
                            "--batch-size", str(TRAIN_BATCH),
                            "--max-tokens", str(TRAIN_MAX_TOKENS),
                            "--steps", str(TRAIN_STEPS), "--save-every",
                            "0", "--output-dir", str(out)])
    finally:
        tt.build_sharded_train_step = build
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise RuntimeError(f"whisperjav-torch-finetune exited {rc}")
    cfg = WHISPER_SIZES["turbo"]
    walls = [s[0] for s in steps]
    losses = [s[1] for s in steps]
    step_s = statistics.median(walls[1:-1])
    targets = statistics.mean(s[2] for s in steps)
    flop = TRAIN_BATCH * train_step_flops(cfg, TRAIN_MAX_TOKENS - 1)
    bound_s = flop / PEAK_F32
    log(f"finetune turbo (128 mels, d=1280, 20x64, 32+4 layers, vocab "
        f"51866, f32, no TF32): B={TRAIN_BATCH}, {TRAIN_MAX_TOKENS} tokens, "
        f"{len(steps)} steps in {wall:.3f} s of main (load, data, steps, "
        f"checkpoint); step walls {[round(w, 4) for w in walls]} s, median "
        f"of those between the first and the profiled last {step_s:.4f} s; {TRAIN_BATCH / step_s:.3f} "
        f"samples/s, {targets / step_s:.1f} target tokens/s ({targets:.0f} "
        f"a step); losses {losses}; peak device memory {peak} bytes "
        f"({peak / 2**30:.3f} GiB); {flop / 1e12:.3f} TFLOP a step, bound "
        f"{bound_s:.4f} s at {PEAK_F32 / 1e12:.0f} TFLOP/s f32 "
        f"({bound_s / step_s:.1%} of it)")
    if len(steps) != TRAIN_STEPS or not all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        raise RuntimeError(f"finetune: losses {losses} over {len(steps)} "
                           "steps: not finite and falling")
    train_batch_scan(dev, data, cfg)
    ckpt = out / f"step_{TRAIN_STEPS:06d}"
    meta = checkpoint_metadata(ckpt)
    if meta.get("step") != TRAIN_STEPS or meta.get("backend") != "npz":
        raise RuntimeError(f"finetune: checkpoint metadata {meta}")
    # the fine-tuned weights transcribe a clip: the engine casts to bf16
    # and takes ownership of the (freshly built) model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = params_from_jax(load_checkpoint(ckpt), cfg)
    load_s = time.perf_counter() - t0
    engine = TranscriptionEngine(
        cfg, model, options=DecodeOptions(cross_kv_int8=True),
        batch_size=32, device=dev)
    wav = tmp / "ft-clip.wav"
    duration = synthetic_clip_seeded(wav, TRAIN_CLIP_S, 5)
    from whisperjav_tpu_torch.modules.audio_extraction import AudioExtractor
    audio, _ = AudioExtractor(SR).extract(wav)
    counters = kernel_counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    subs, stats = TranscribePipeline(engine).process_audio(audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    a = launches["encoder_attention"]
    log(f"finetuned turbo transcribes {duration:.3f} s: wall {wall:.3f} s "
        f"(checkpoint read and built in {load_s:.3f} s), windows "
        f"{stats.get('windows')}, raw subtitles {len(subs)}; launches "
        f"{json.dumps(launches)}")
    if a < 32 or a % cfg.n_audio_layer \
            or launches["decode_cross_attention_bf16"] < 1:
        raise RuntimeError(f"finetuned transcription: Kernel A {a} launches "
                           f"(32 an encoder batch), Kernel B bf16 "
                           f"{launches['decode_cross_attention_bf16']}")
    for s in subs:
        if not 0.0 <= s.start < s.end <= duration + 1.0:
            raise RuntimeError(f"finetuned transcription: subtitle outside "
                               f"the clip: {s.start}-{s.end}")
    del engine, model
    torch.cuda.empty_cache()
    return launches


# the dp x tp train step over NCCL, one process a card: at the parity
# width against the one-card step (the TRAIN_TOL_* tolerances: the
# tensor-parallel products and the data-parallel gradient sums add in
# other orders, which is rounding of the size the CPU comparison sees),
# then turbo at full width and depth, TRAIN_BATCH rows a data replica,
# TRAIN_NCCL_STEPS steps, the last under the CUDA profiler
TRAIN_NCCL_STEPS = 3
TRAIN_NCCL_TIMEOUT_S = 300.0
TRAIN_NCCL_MODEL = "turbo"

_TRAIN_NCCL_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
sys.exit(chip_smoke.train_nccl_child(*sys.argv[2:]))
"""


def _global_train_batch(cfg, rows: int, seed: int = 3):
    """A seeded batch of ``rows`` rows at ``cfg``'s widths: mel noise,
    TRAIN_MAX_TOKENS random text ids, the loss on all but the first 3
    positions, each row a different length."""
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((rows, cfg.n_mels, 3000)).astype(np.float32)
    tokens = rng.integers(0, cfg.eot, (rows, TRAIN_MAX_TOKENS)).astype(
        np.int32)
    mask = np.zeros((rows, TRAIN_MAX_TOKENS), np.float32)
    for r in range(rows):
        mask[r, 3:TRAIN_MAX_TOKENS - 17 * r] = 1.0
    return mel, tokens, mask


def train_nccl_child(out: str, device: str, model: str, rows: str,
                     steps: str) -> int:
    """One rank of the dp x tp train run (``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set): the JAX
    default mesh from ``make_train_mesh`` (NCCL on "cuda", gloo on
    "cpu"), the parity run, whose gathered tree rank 0 saves to
    ``out/nccl-parity.npz``, then ``model`` with ``rows`` rows a data
    replica for ``steps`` steps, each timed to a sync, the last under
    the profiler. Prints one ``TRAIN_NCCL {...}`` line."""
    import os
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from whisperjav_tpu_torch.models.whisper.config import WHISPER_SIZES
    from whisperjav_tpu_torch.models.whisper.weights import init_params
    from whisperjav_tpu_torch.parallel import train as tt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, rows, steps = int(os.environ["RANK"]), int(rows), int(steps)
    t_start = time.perf_counter()
    mesh = tt.make_train_mesh(device=device)
    cuda = mesh.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(mesh.device)

    losses, _, tree, parity_s = train_parity_steps(mesh)
    if rank == 0:
        np.savez(Path(out) / "nccl-parity.npz", **tree)
    res = {"rank": rank, "mesh": list(mesh.shape), "device":
           str(mesh.device), "backend": dist.get_backend(),
           "parity_losses": losses, "parity_s": parity_s,
           "start_s": time.perf_counter() - t_start}
    # the full-width run
    cfg = WHISPER_SIZES[model]
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(mesh.device)
    whole = init_params(cfg, torch.Generator(device=mesh.device)
                        .manual_seed(0), device=mesh.device)
    init_fn, step_fn = tt.build_sharded_train_step(cfg, mesh,
                                                   tt.make_optimizer())
    state = init_fn(whole)
    del whole
    if cuda:
        torch.cuda.empty_cache()
    batch = _global_train_batch(cfg, rows * mesh.dp)
    walls, step_losses = [], []
    prof = None
    for i in range(steps):
        last = cuda and i == steps - 1
        ctx = profile(activities=[ProfilerActivity.CUDA]) if last \
            else contextlib.nullcontext()
        sync()
        with ctx as prof_:
            t0 = time.perf_counter()
            state, loss = step_fn(state, *batch)
            sync()
            walls.append(time.perf_counter() - t0)
        if last:
            prof = prof_
        step_losses.append(loss)
    res.update({"model": model, "rows_per_replica": rows,
                "global_batch": rows * mesh.dp, "step_walls_s": walls,
                "losses": step_losses, "targets": float(batch[2][:, 1:]
                                                        .sum())})
    if cuda:
        res["peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
    if prof is not None:
        busy = nccl = 0.0
        top = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                busy += e.device_time_total
                if "nccl" in e.key.lower():
                    nccl += e.device_time_total
                    top[e.key[:60]] = (e.count, e.device_time_total / 1e3)
        res.update({"last_step_device_ms": busy / 1e3,
                    "last_step_nccl_ms": nccl / 1e3,
                    "nccl_kernels": top})
    del state
    dist.barrier()
    dist.destroy_process_group()
    print("TRAIN_NCCL " + json.dumps(res), flush=True)
    return 0


def run_train_nccl(tmp: Path, one_card, device: str = "cuda",
                   model: str = TRAIN_NCCL_MODEL, rows: int = TRAIN_BATCH,
                   world: int = 0) -> None:
    """The dp x tp train step over NCCL: one child process a card (4, or
    2 where two or three cards are found), each given the rendezvous in
    its environment; every child waited for and killed past
    TRAIN_NCCL_TIMEOUT_S. The gathered parity tree and every rank's
    losses against ``one_card`` (:func:`check_train_parity`'s GPU run)
    within the TRAIN_TOL_* tolerances; the full-width walls, peak memory
    a card and the collectives' share of the last step. On one card it
    logs that the run needs two. ``device`` "cpu" (gloo, ``world``
    processes) rehearses it without a card."""
    import os
    if device == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards < 2:
            log(f"train over NCCL: needs two cards or more, this machine "
                f"has {n_cards}; not run")
            return
        world = 4 if n_cards >= 4 else 2
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out = tmp / "train-nccl"
    out.mkdir(parents=True, exist_ok=True)
    repo = str(Path(__file__).resolve().parent)
    port = free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                         "MASTER_PORT")}
    procs = []
    t0 = time.perf_counter()
    for rank in range(world):
        env = dict(base, WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        log_file = open(out / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", _TRAIN_NCCL_CHILD, repo, str(out),
             device, model, str(rows), str(TRAIN_NCCL_STEPS)],
            stdout=subprocess.PIPE, stderr=log_file, text=True, env=env,
            stdin=subprocess.DEVNULL), log_file))
    results, failed = [], []
    try:
        for rank, (proc, _) in enumerate(procs):
            left = max(1.0, TRAIN_NCCL_TIMEOUT_S - (time.perf_counter() - t0))
            try:
                stdout, _ = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                failed.append(f"rank {rank} still running after "
                              f"{TRAIN_NCCL_TIMEOUT_S:.0f} s")
                break
            lines = [line for line in stdout.splitlines()
                     if line.startswith("TRAIN_NCCL ")]
            if proc.returncode != 0 or not lines:
                failed.append(f"rank {rank} exited {proc.returncode}")
                continue
            results.append(json.loads(lines[-1][len("TRAIN_NCCL "):]))
    finally:
        for proc, log_file in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
            log_file.close()
    wall = time.perf_counter() - t0
    if failed:
        for rank in range(world):
            tail = (out / f"rank{rank}.log").read_text(errors="replace")
            log(f"train over NCCL: rank {rank} log tail: {tail[-1500:]}")
        raise RuntimeError(f"train over NCCL: {'; '.join(failed)}")
    got = (results[0]["parity_losses"], None,
           dict(np.load(out / "nccl-parity.npz")), results[0]["parity_s"])
    errors = train_parity_errors(one_card, got)
    same_losses = all(np.allclose(r["parity_losses"],
                                  results[0]["parity_losses"], rtol=1e-6,
                                  atol=0) for r in results)
    mesh = results[0]["mesh"]
    log(f"train over {results[0]['backend']} ({world} processes, "
        f"{mesh[0]}x{mesh[1]} (dp x tp) mesh, devices "
        f"{[r['device'] for r in results]}), parity width, B=2, 2 steps: "
        f"losses {results[0]['parity_losses']} against one card "
        f"{one_card[0]} (every rank the same: {same_losses}); "
        f"{train_parity_line(errors)}; parity steps "
        f"{[round(r['parity_s'], 3) for r in results]} s; children's wall "
        f"{wall:.3f} s")
    if not (same_losses and train_parity_ok(errors, got[0])):
        raise RuntimeError("train over NCCL: the dp x tp step disagrees with "
                           "the one-card step")
    for r in results:
        walls = r["step_walls_s"]
        share = ""
        if "last_step_nccl_ms" in r:
            last_ms = walls[-1] * 1e3
            share = (f"; last step (profiled) {last_ms:.3f} ms of wall, "
                     f"device busy {r['last_step_device_ms']:.3f} ms, NCCL "
                     f"kernels {r['last_step_nccl_ms']:.3f} ms "
                     f"({100 * r['last_step_nccl_ms'] / last_ms:.1f}% of the "
                     f"wall, {100 * r['last_step_nccl_ms'] / max(r['last_step_device_ms'], 1e-9):.1f}% "
                     f"of the device time): {json.dumps(r['nccl_kernels'])}")
        peak = r.get("peak_bytes")
        log(f"train over {r['backend']} rank {r['rank']} ({r['device']}): "
            f"{model} "
            f"full width, {r['rows_per_replica']} rows a replica (global "
            f"batch {r['global_batch']}, {TRAIN_MAX_TOKENS} tokens), step "
            f"walls {[round(w, 4) for w in walls]} s, losses {r['losses']}"
            + (f", peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)"
               if peak else "") + share)
        if not (all(np.isfinite(r["losses"])) and r["losses"][-1]
                < r["losses"][0] and np.allclose(
                    r["losses"], results[0]["losses"], rtol=1e-6, atol=0)):
            raise RuntimeError(f"train over NCCL: rank {r['rank']} losses "
                               f"{r['losses']}: not finite, falling and "
                               "the same on every rank")
    walls = [max(r["step_walls_s"][i] for r in results)
             for i in range(TRAIN_NCCL_STEPS)]
    step_s = statistics.median(walls[1:])
    global_b = results[0]["global_batch"]
    log(f"train over {results[0]['backend']}: {model} global batch "
        f"{global_b} on {world} devices: step {step_s:.4f} s (median of steps 2-"
        f"{TRAIN_NCCL_STEPS}, slowest rank), {global_b / step_s:.3f} "
        f"samples/s, {results[0]['targets'] / step_s:.1f} target tokens/s")


# ---------------------------------------------------------------------------
# the multihost phase: --multihost file sharding, two processes
# ---------------------------------------------------------------------------

MULTIHOST_CLIPS_S = (8.0, 12.0, 16.0, 20.0)
# the partner that never comes: the rendezvous waits this long, and the
# process must be gone well within MULTIHOST_DEAD_LIMIT_S
MULTIHOST_DEAD_TIMEOUT_S = 10
MULTIHOST_DEAD_LIMIT_S = 120.0

_MULTIHOST_CHILD = """
import json, sys, time
import torch
from whisperjav_tpu_torch import cli
t0 = time.perf_counter()
rc = cli.main(sys.argv[1:])
if torch.cuda.is_initialized():
    torch.cuda.synchronize()
peak = torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() \\
    else 0
print("MULTIHOST_CHILD " + json.dumps({"rc": rc, "peak": peak,
      "wall_s": time.perf_counter() - t0}), flush=True)
sys.exit(rc)
"""


def _multihost_run(media: Path, out: Path, hosts, env=None,
                   timeout: float = 600.0) -> list:
    """``whisperjav-torch <media> --multihost`` as one process per host id
    in ``hosts`` (of 2), each through ``cli.main`` in its own interpreter,
    its output in files beside ``out``; every process is waited for and
    killed past ``timeout``. Returns per host (exit code, seconds from
    start to exit, its child record or None, the end of its log)."""
    import os
    repo = Path(__file__).resolve().parent
    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for host in hosts:
        argv = [str(media), "--multihost", "--coordinator", coord,
                "--num-hosts", "2", "--host-id", str(host),
                "--skip-existing", "--output-dir", str(out),
                "--stats-file", f"{out}-stats{host}.json"]
        logs = (Path(f"{out}-{host}.out"), Path(f"{out}-{host}.err"))
        with open(logs[0], "w") as fo, open(logs[1], "w") as fe:
            proc = subprocess.Popen(
                [sys.executable, "-c", _MULTIHOST_CHILD, *argv], cwd=repo,
                stdout=fo, stderr=fe, env={**os.environ, **(env or {})})
        procs.append((time.perf_counter(), proc, logs))
    ends = {}
    try:
        deadline = time.perf_counter() + timeout
        while len(ends) < len(procs) and time.perf_counter() < deadline:
            for i, (_, proc, _) in enumerate(procs):
                if i not in ends and proc.poll() is not None:
                    ends[i] = time.perf_counter()
            time.sleep(0.05)
    finally:
        for _, proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = []
    for i, (t0, proc, (out_log, err_log)) in enumerate(procs):
        rec = next((json.loads(line.split(" ", 1)[1])
                    for line in out_log.read_text().splitlines()
                    if line.startswith("MULTIHOST_CHILD ")), None)
        wall = ends[i] - t0 if i in ends else float("inf")
        results.append((proc.returncode, wall, rec,
                        err_log.read_text()[-2000:]))
    return results


def run_multihost_phase(tmp: Path) -> None:
    """Two ``--multihost`` processes (turbo, the flagless defaults, on the
    one card) over 4 clips of different lengths: their SRTs disjoint and
    covering; a ``--skip-existing`` re-run of both writes nothing; a
    process whose partner never comes exits non-zero within its
    rendezvous timeout, having written nothing."""
    media, out = tmp / "mh-media", tmp / "mh-out"
    media.mkdir()
    for i, seconds in enumerate(MULTIHOST_CLIPS_S):
        synthetic_clip_seeded(media / f"mh{i}.wav", seconds, 40 + i)
    names = sorted(p.stem for p in media.glob("*.wav"))
    runs = _multihost_run(media, out, (0, 1))
    done = []
    for host, (rc, wall, rec, err) in enumerate(runs):
        if rc != 0 or rec is None:
            raise RuntimeError(f"multihost host {host} exited {rc}: "
                               f"{err}")
        stats = json.loads(Path(f"{out}-stats{host}.json").read_text())
        mine = sorted(Path(r["input"]).stem for r in stats["results"])
        done.append(mine)
        log(f"multihost host {host}/2: files {mine}, wall {wall:.3f} s "
            f"(cli.main {rec['wall_s']:.3f} s), peak device memory "
            f"{rec['peak']} bytes ({rec['peak'] / 2**30:.3f} GiB)")
    if set(done[0]) & set(done[1]) or sorted(done[0] + done[1]) != names \
            or not all(done):
        raise RuntimeError(f"multihost: slices {done} are not disjoint and "
                           f"covering {names}")
    for stem in names:
        srt_cues(out / f"{stem}.ja.whisperjav.srt")
    stamps = {p.name: p.stat().st_mtime_ns for p in out.iterdir()}
    rerun = _multihost_run(media, out, (0, 1))
    for host, (rc, wall, rec, err) in enumerate(rerun):
        if rc != 0:
            raise RuntimeError(f"multihost re-run host {host} exited {rc}: "
                               f"{err}")
        log(f"multihost --skip-existing re-run host {host}/2: wall "
            f"{wall:.3f} s, peak device memory {rec['peak']} bytes")
    if {p.name: p.stat().st_mtime_ns for p in out.iterdir()} != stamps:
        raise RuntimeError("multihost: the --skip-existing re-run wrote "
                           "outputs")
    lone_out = tmp / "mh-lone"
    (rc, wall, _, err), = _multihost_run(
        media, lone_out, (0,), timeout=MULTIHOST_DEAD_LIMIT_S,
        env={"WJAV_RENDEZVOUS_TIMEOUT_S": str(MULTIHOST_DEAD_TIMEOUT_S)})
    wrote = list(lone_out.glob("*.srt")) if lone_out.exists() else []
    log(f"multihost host 0 of 2 without its partner: exit {rc} after "
        f"{wall:.3f} s (rendezvous timeout {MULTIHOST_DEAD_TIMEOUT_S} s), "
        f"{len(wrote)} SRTs written")
    if rc == 0 or wrote or wall > MULTIHOST_DEAD_LIMIT_S:
        raise RuntimeError("multihost: a process without its partner did "
                           f"not fail alone (exit {rc}, {len(wrote)} SRTs)")


# the ensemble, async and translate phases
# (seed, target seconds) of synthetic_clip_seeded: 25.8 s and 34.4 s
ENSEMBLE_CLIPS = ((61, 20.0), (60, 26.0))
# 15.6, 21.7 and 23.6 s
ASYNC_CLIPS = ((70, 15.0), (71, 20.0), (72, 20.0))
# memory pass 1 may leave behind when it is dropped (allocator slack)
ENSEMBLE_DROP_SLACK = 256 * 2**20
# the ensemble's pass 2 (large-v2 on bf16 weights: unfused, host-bound
# decode layers) runs at full width with its decoder cut to this depth
ENSEMBLE_PASS2_LAYERS = 8
TRANSLATE_TOL_REL = 1e-4
TRANSLATE_MAX_NEW = 128
# Qwen3-1.7B's LM widths: those of the port's qwen3-asr-1.7b config
QWEN3_LM = "qwen3-asr-1.7b"


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def zero_launches() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


@contextlib.contextmanager
def decoder_depth(model: str, n_layers: int):
    """The named Whisper size with its decoder cut to ``n_layers`` layers
    (widths kept) inside the block."""
    import dataclasses
    from whisperjav_tpu_torch.models.whisper import config as wc
    saved = wc.WHISPER_SIZES[model]
    wc.WHISPER_SIZES[model] = dataclasses.replace(saved,
                                                  n_text_layer=n_layers)
    try:
        yield
    finally:
        wc.WHISPER_SIZES[model] = saved


def run_ensemble_phase(tmp: Path) -> dict:
    """``whisperjav-torch a.wav b.wav --ensemble --pass1-mode balanced
    --pass2-mode fidelity --merge-strategy smart_merge``: turbo beam-2 bf16
    then large-v2 bf16 at aggressive (the fidelity enhancer passes audio
    through without weights), full width, the decoder cut to
    ENSEMBLE_PASS2_LAYERS layers. ``ensemble_batch.json``
    must say ok 2; each pass's parameters on the card; Kernel A and Kernel
    B's bf16 form launched in each pass; the memory allocated when pass 2
    is built back within ENSEMBLE_DROP_SLACK of where it was before pass
    1. Prints each pass's wall, the merge stats and the peak memory."""
    from whisperjav_tpu_torch import cli
    from whisperjav_tpu_torch.ensemble import orchestrator as orch
    media = tmp / "ens-media"
    media.mkdir()
    clips = [media / f"ens{i}.wav" for i in range(len(ENSEMBLE_CLIPS))]
    audio_s = [synthetic_clip_seeded(c, s, seed)
               for c, (seed, s) in zip(clips, ENSEMBLE_CLIPS)]
    marks, devices = [], []
    build = orch.EnsembleOrchestrator._build

    def spy(self, cfg):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), torch.cuda.memory_allocated(),
                      launch_counts(), cfg.mode.name, cfg.model))
        pipeline = build(self, cfg)
        devices.append({p.device.type
                        for p in pipeline.engine.model.parameters()})
        return pipeline

    out = tmp / "ens-out"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    orch.EnsembleOrchestrator._build = spy
    try:
        with decoder_depth("large-v2", ENSEMBLE_PASS2_LAYERS):
            rc = cli.main([*map(str, clips), "--output-dir", str(out),
                           "--ensemble", "--pass1-mode", "balanced",
                           "--pass2-mode", "fidelity", "--merge-strategy",
                           "smart_merge"])
        torch.cuda.synchronize()
        end = time.perf_counter()
    finally:
        orch.EnsembleOrchestrator._build = build
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    summary = json.loads((out / "ensemble_batch.json").read_text())
    if rc != 0 or summary["ok"] != len(clips) or len(marks) != 2:
        raise RuntimeError(f"ensemble: exit {rc}, {summary['ok']} ok, "
                           f"{len(marks)} passes built")
    if devices != [{"cuda"}, {"cuda"}]:
        raise RuntimeError(f"ensemble: pass parameters on {devices}")
    per_pass = [{k: marks[1][2][k] - marks[0][2][k] for k in launches},
                {k: launches[k] - marks[1][2][k] for k in launches}]
    for n, counts in enumerate(per_pass, 1):
        missing = [k for k in TURBO_NEEDS if counts[k] < 1]
        if missing:
            raise RuntimeError(f"ensemble pass {n}: kernels never launched: "
                               f"{missing} ({counts})")
    before, after = marks[0][1], marks[1][1]
    if after > before + ENSEMBLE_DROP_SLACK:
        raise RuntimeError(f"ensemble: {after} bytes allocated when pass 2 "
                           f"is built, {before} before pass 1: pass 1 was "
                           "not dropped")
    for c, seconds in zip(clips, audio_s):
        for start, end_s in srt_cues(out / f"{c.stem}.ja.whisperjav.srt"):
            if not 0.0 <= start < end_s <= seconds + 3.0:
                raise RuntimeError(f"ensemble: cue outside {c.name}: "
                                   f"{start}-{end_s}")
    walls = (marks[1][0] - marks[0][0], end - marks[1][0])
    log(f"ensemble (clips {[round(s, 3) for s in audio_s]} s): pass 1 "
        f"{marks[0][3]} {marks[0][4]} {walls[0]:.3f} s (build, both files, "
        f"drop), pass 2 {marks[1][3]} {marks[1][4]} {walls[1]:.3f} s "
        f"(build, both files, merge, write); memory allocated before pass "
        f"1 {before} bytes, when pass 2 is built {after} bytes; peak "
        f"{peak} bytes ({peak / 2**30:.3f} GiB)")
    log(f"ensemble merge: {json.dumps([r['merge'] for r in summary['results']])}")
    log(f"ensemble launches pass 1 {json.dumps(per_pass[0])}; pass 2 "
        f"{json.dumps(per_pass[1])}")
    torch.cuda.empty_cache()
    return launches


def run_async_phase(tmp: Path) -> tuple:
    """Three clips through the flagless path (``--no-sanitize``) twice: the
    file loop, then ``--async-processing --output-format both
    --trace-params``. The cues
    (times and texts) must be identical; each async SRT signed, with its
    VTT; the trace config then file_start, segmentation and file_complete
    per file. Prints both walls; returns the async run's launches and
    the SRT of its first clip."""
    from whisperjav_tpu_torch import cli
    media = tmp / "async-media"
    media.mkdir()
    clips = [media / f"as{i}.wav" for i in range(len(ASYNC_CLIPS))]
    audio_s = [synthetic_clip_seeded(c, s, seed)
               for c, (seed, s) in zip(clips, ASYNC_CLIPS)]
    walls, launches = {}, {}
    trace = tmp / "async-trace.jsonl"
    # without the sanitizer, which may empty a random-weight SRT (an
    # empty SRT gets no signature)
    for label, extra in (("sync", ["--no-sanitize"]),
                         ("async", ["--no-sanitize", "--async-processing",
                                    "--output-format", "both",
                                    "--trace-params", str(trace)])):
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        rc = cli.main([*map(str, clips), "--output-dir",
                       str(tmp / f"async-{label}"), *extra])
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        launches[label] = launch_counts()
        if rc != 0:
            raise RuntimeError(f"async phase: the {label} run exited {rc}")
    for c in clips:
        name = f"{c.stem}.ja.whisperjav.srt"
        sync = srt_text_cues((tmp / "async-sync" / name).read_text("utf-8"))
        srt = tmp / "async-async" / name
        got = srt_text_cues(srt.read_text(encoding="utf-8"))
        if got != sync:
            raise RuntimeError(f"async phase: {name} differs from the file "
                               f"loop's ({len(got)} against {len(sync)} "
                               "cues)")
        if not (got and got[-1][1].startswith("WhisperJAV-TPU")
                and srt.with_suffix(".vtt").exists()):
            raise RuntimeError(f"async phase: {name} unsigned or without "
                               "its VTT")
    events = [json.loads(line)["event"]
              for line in trace.read_text().splitlines()]
    if events != ["config"] + ["file_start", "segmentation",
                               "file_complete"] * len(clips):
        raise RuntimeError(f"async phase: trace events {events}")
    missing = [k for k in TURBO_NEEDS if launches["async"][k] < 1]
    if missing:
        raise RuntimeError(f"async phase: kernels never launched: {missing}")
    log(f"async phase (clips {[round(a, 3) for a in audio_s]} s, flagless "
        f"turbo): file "
        f"loop {walls['sync']:.3f} s, --async-processing "
        f"{walls['async']:.3f} s; cues identical, {len(events)} trace "
        f"events; launches (async) {json.dumps(launches['async'])}")
    return launches["async"], (tmp / "async-async"
                               / f"{clips[0].stem}.ja.whisperjav.srt")


def synthetic_srt(path: Path, cues: int = 24) -> None:
    """``cues`` kana cues of 1-3 s with short pauses."""
    rng = np.random.default_rng(9)
    kana = "あいうえおかきくけこさしすせそたちつてとなにぬねの"
    blocks, t = [], 0.0
    for i in range(cues):
        t += float(rng.uniform(0.2, 1.5))
        d = float(rng.uniform(1.0, 3.0))
        stamp = lambda x: (f"{int(x // 3600):02d}:{int(x % 3600 // 60):02d}:"  # noqa: E731
                           f"{int(x % 60):02d},{int(round(x % 1 * 1000)) % 1000:03d}")
        text = "".join(rng.choice(list(kana), int(rng.integers(4, 16))))
        blocks.append(f"{i + 1}\n{stamp(t)} --> {stamp(t + d)}\n{text}\n")
        t += d
    path.write_text("\n".join(blocks), encoding="utf-8")


def _lm_bytes(model) -> int:
    """Bytes one generate step reads: the block weights and the head
    (the embedding gives one row)."""
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters()
               if name.startswith("blocks.") or name.startswith("lm_head"))


def run_translate_phase(dev, tmp: Path, srt: Path) -> None:
    """The on-device translator: ``generate_text`` at the test width on
    the GPU against the CPU (tokens identical, first-step logits within
    TRANSLATE_TOL_REL of the largest); then the seeded LM-only tree at
    Qwen3-1.7B widths (f32, fused q/k/v, built on the card) translating
    ``srt`` through ``translate_srt`` with the local backend (every batch's
    call must return, the parameters be on the card), ms per generate
    step at B=1,
    tokens a second, the prefill time and the step's byte bound; then
    ``whisperjav-torch clip.wav --translate identity`` and
    ``whisperjav-torch --check`` (exit 0, naming the card)."""
    from whisperjav_tpu_torch import cli
    from whisperjav_tpu_torch.models.qwen import model as qm
    from whisperjav_tpu_torch.models.qwen import weights as qw
    from whisperjav_tpu_torch.models.qwen.tokenizer import QwenTokenizer
    from whisperjav_tpu_torch.translate.local_backend import LocalLMBackend
    from whisperjav_tpu_torch.translate.service import translate_srt

    test = qm.QWEN_SIZES["qwen3-asr-test"]
    cpu_lm = qm.fuse_lm_qkv(qw.init_params(
        test, torch.Generator().manual_seed(3), audio=False))
    gpu_lm = qm.fuse_lm_qkv(qw.init_params(
        test, torch.Generator().manual_seed(3), audio=False)).to(dev)
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        3, test.vocab_size - 1, (1, 40)))
    outs = [qm.generate_text(m, ids.to(m.tok_emb.device), torch.tensor([40]),
                             max_new=24, repetition_penalty=1.05)
            for m in (cpu_lm, gpu_lm)]
    logits = []
    for m in (cpu_lm, gpu_lm):
        cache = qm.LMCache.zeros(test, 1, 41, torch.float32, m.tok_emb.device)
        with torch.inference_mode():
            lg, _ = qm.lm_step(m, m.tok_emb[ids.to(m.tok_emb.device)], 0,
                               cache)
        logits.append(lg[0, -1].float().cpu())
    err = float((logits[1] - logits[0]).abs().max())
    scale = float(logits[0].abs().max())
    same = torch.equal(outs[0].tokens, outs[1].tokens.cpu())
    log(f"translate LM at test widths: GPU against CPU, first-step logits "
        f"max |err| {err:.3e} ({err / scale:.3e} of the largest, tolerance "
        f"{TRANSLATE_TOL_REL}); 24 tokens identical: {same}")
    if not same or err > TRANSLATE_TOL_REL * scale:
        raise RuntimeError("translate: the GPU's generate_text differs from "
                           "the CPU's")
    del cpu_lm, gpu_lm

    cfg = qm.QWEN_SIZES[QWEN3_LM]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = qw.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev, audio=False)
    backend = LocalLMBackend(params=lm, tokenizer=QwenTokenizer(),
                             max_new_tokens=TRANSLATE_MAX_NEW, device=dev)
    del lm
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = backend.model
    n_params = sum(p.numel() for p in model.parameters())
    on = {p.device.type for p in model.parameters()}
    step_bytes = _lm_bytes(model)
    log(f"translate LM {cfg.name} widths (d={cfg.d_model}, {cfg.n_layers} "
        f"layers, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), f32, fused q/k/v: "
        f"{n_params} parameters on {sorted(on)}, built in {build_s:.3f} s, "
        f"{torch.cuda.memory_allocated()} bytes allocated")
    if on != {"cuda"}:
        raise RuntimeError(f"translate: the LM's parameters on {on}")

    # the step's cost at B=1: generate at two lengths, in turns
    prompt = torch.from_numpy(np.random.default_rng(6).integers(
        3, cfg.vocab_size - 1, (1, 400))).to(dev)
    n = torch.tensor([400])
    short, long_ = 16, TRANSLATE_MAX_NEW
    qm.generate_text(model, prompt, n, max_new=4)
    walls = {short: [], long_: []}
    for steps in (short, long_, long_, short):
        res, wall = _timed(lambda: qm.generate_text(
            model, prompt, n, max_new=steps, repetition_penalty=1.05))
        if int(res.length[0]) != steps:
            raise RuntimeError(f"translate: {int(res.length[0])} tokens of "
                               f"{steps} (an EOS from seeded weights)")
        walls[steps].append(wall)
    step_ms = 1e3 * (statistics.median(walls[long_])
                     - statistics.median(walls[short])) / (long_ - short)
    cache = qm.LMCache.zeros(cfg, 1, 400, torch.float32, dev)
    with torch.inference_mode():
        _, prefill_s = _timed(lambda: qm.lm_step(
            model, model.tok_emb[prompt], 0, cache))
    bound_ms = 1e3 * step_bytes / HBM_BYTES_S
    log(f"translate generate at B=1 (400-token prompt): {step_ms:.3f} ms "
        f"per step, {1e3 / step_ms:.1f} tokens/s; byte bound {bound_ms:.3f} "
        f"ms a step ({step_bytes} bytes of block weights and head over 3.35 "
        f"TB/s, {bound_ms / step_ms:.1%} of it reached); prefill of 400 "
        f"tokens {1e3 * prefill_s:.3f} ms; walls {json.dumps(walls)}")
    del cache

    # translate_srt of the async phase's turbo SRT (a synthetic one where
    # it holds fewer than 4 cues), up to 30 cues a batch
    work = tmp / "translate" / srt.name
    work.parent.mkdir()
    work.write_bytes(srt.read_bytes())
    cues = len(srt_text_cues(srt.read_text(encoding="utf-8")))
    if cues < 4:
        log(f"translate: {srt.name} holds {cues} cues; translating a "
            "synthetic SRT instead")
        synthetic_srt(work)
        cues = len(srt_text_cues(work.read_text(encoding="utf-8")))
    calls, answers = [], []

    def call(prompt_text):
        calls.append(len(prompt_text))
        answers.append(backend(prompt_text))
        return answers[-1]

    t0 = time.perf_counter()
    out = translate_srt(work, provider="tpu-local", call_fn=call,
                        max_batch_size=30, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    proj = json.loads(work.with_suffix(".wjtrans.json").read_text())
    statuses = [b["status"] for b in proj["batches"]]
    # an error of the backend raises (translate_srt's on-device rule), so
    # every batch's call returned; the project marks a batch 'failed'
    # where the response holds no numbered line, as seeded weights' do
    log(f"translate_srt on {srt.name} ({cues} cues, tpu-local, max_new "
        f"{TRANSLATE_MAX_NEW}): {len(calls)} batches in {wall:.3f} s "
        f"(prompts of {calls} characters, answers of "
        f"{[len(a) for a in answers]}), project statuses {statuses} "
        f"(no numbered lines in a seeded model's answer), peak "
        f"{torch.cuda.max_memory_allocated()} bytes; wrote {out.name}")
    if len(answers) != len(statuses) or not answers \
            or not all(answers):
        raise RuntimeError(f"translate: {len(answers)} answers for "
                           f"{len(statuses)} batches")
    srt_text_cues(out.read_text(encoding="utf-8"))
    del backend, model
    torch.cuda.empty_cache()

    wav = tmp / "translate-identity.wav"
    synthetic_clip_seeded(wav, 15.0, 80)
    rc = cli.main([str(wav), "--output-dir", str(tmp / "tr-id"),
                   "--translate", "identity"])
    translated = tmp / "tr-id" / "translate-identity.ja.en.srt"
    if rc != 0 or not translated.exists():
        raise RuntimeError(f"--translate identity: exit {rc}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--check"])
    log("whisperjav-torch --check:\n" + buf.getvalue().rstrip())
    if rc != 0 or torch.cuda.get_device_name(0) not in buf.getvalue():
        raise RuntimeError(f"--check exited {rc}")


# ---------------------------------------------------------------------------
# the tools phase: the developer tools and whisperjav-torch-bench
# ---------------------------------------------------------------------------

# every tool's --device
TOOLS_DEVICE = "cuda"
# e2e_bench's synthetic file (its synth_long_wav), in minutes
TOOLS_E2E_MINUTES = 2.0
# e2e_bench's flags: the flagless path (turbo, beam 2, B=32)
TOOLS_E2E_FLAGS = ("--devices", "1")
# decode_profile: large-v2 greedy at B=64, every group, the bf16 phase
# included; one timed round, and budgets 32 and 64 (mid cell 48) where
# the JAX tool takes 32 and 128 (mid 80): the int8-unfused and bf16
# cells are host-bound (45-120 ms a step), two rounds took 363-394 s of
# the script's time and the JAX budgets in one round 175-237 s (H100
# 80GB HBM3, 700 W)
TOOLS_PROFILE_ARGS = ("--model", "large-v2", "--batch", "64", "--iters",
                      "1", "--budgets", "32", "64", "--mid-budget", "48")
# the greedy large-v2 int8 B=64 step of the large-v2 phase's breakdown
# (PERF.md §5, H100 80GB HBM3 at 700 W), printed beside the profile's
# slopes
GREEDY_LV2_MS_PER_STEP = 12.010
# first_weights' narrow HF Whisper: hd = 64 (Kernel A takes only that),
# 80 mels, the real vocabulary
TOOLS_FW_WHISPER = dict(vocab_size=51865, num_mel_bins=80, d_model=256,
                        encoder_layers=2, decoder_layers=2,
                        encoder_attention_heads=4, decoder_attention_heads=4,
                        encoder_ffn_dim=1024, decoder_ffn_dim=1024,
                        max_source_positions=1500, max_target_positions=448)
# its stage 2 arms must launch these (bf16: Kernel A and B's bf16 form;
# int8: the fused blocks and the kernels inside them)
FIRST_WEIGHTS_NEEDS = INT8_NEEDS
# determinism_suite: two flagless runs on a ~20 s clip
TOOLS_DET_CLIP_S = 20.0
TOOLS_DET_ARGS = ("--runs", "2", "--mode", "balanced", "--model", "turbo",
                  "--batch-size", "32")


def run_e2e_bench(tmp: Path) -> tuple:
    """``python -m whisperjav_tpu_torch.tools.e2e_bench`` on a synthetic
    file, flagless, with ``WJAV_TRACE_BATCHES=1``: the JSON line must name
    the metric, a positive value, the stage and batch-phase walls and the
    rungs, and a cuda engine. Returns the line and the kept SRT."""
    import os
    env = dict(os.environ, WJAV_TRACE_BATCHES="1", TMPDIR=str(tmp))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "whisperjav_tpu_torch.tools.e2e_bench",
         "--minutes", str(TOOLS_E2E_MINUTES), "--keep", "--budget-s", "600",
         "--stall-s", "300", "--device", TOOLS_DEVICE, "--",
         *TOOLS_E2E_FLAGS],
        cwd=str(Path(__file__).resolve().parent), env=env,
        capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"e2e_bench exited {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    kept = re.search(r"outputs kept in (\S+)", proc.stderr)
    missing = [k for k in ("stage_s", "batch_phase_s", "rungs_each")
               if k not in line]
    if (line.get("metric") != "e2e_file_rtf_balanced"
            or not line.get("value", 0) > 0 or missing or kept is None):
        raise RuntimeError(f"e2e_bench line: {line} (missing {missing})")
    if not str(line.get("device")).startswith(TOOLS_DEVICE):
        raise RuntimeError(f"e2e_bench: the CLI child ran on "
                           f"{line.get('device')!r}, not the card")
    srt = Path(kept.group(1)) / "out" / "e2e_input.ja.whisperjav.srt"
    log(f"e2e_bench (flagless, {line['audio_s']} s synthetic file, "
        f"engine {line['device']}): e2e_file_rtf_balanced {line['value']}x "
        f"(vs_baseline {line['vs_baseline']}), wall_s {line['wall_s']}, "
        f"process_wall_s {line['process_wall_s']}, tool wall {wall:.3f} s; "
        f"beside it: a 128.9 s clip took 5.2-9.1 s of flagless CLI wall "
        f"(PERF.md §5)")
    log(f"e2e_bench stages (s) {json.dumps(line['stage_s'])}; batch phases "
        f"(s) {json.dumps(line['batch_phase_s'])}; batch_s_each "
        f"{line['batch_s_each']}; rungs_each {line['rungs_each']}; windows "
        f"{line['windows']}, subtitles {line['subtitles']}")
    return line, srt


def run_decode_profile(tmp: Path) -> dict:
    """decode_profile in-process at TOOLS_PROFILE_ARGS: every variant,
    nibble-packed int4 cross-K/V included, gives timed rows, and the base
    slope is positive. Prints the slopes and launches per step."""
    from whisperjav_tpu_torch.tools import decode_profile
    out = tmp / "decode_profile.json"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = decode_profile.main([*TOOLS_PROFILE_ARGS, "--json", str(out),
                                  "--device", TOOLS_DEVICE])
    wall = time.perf_counter() - t0
    data = json.loads(out.read_text())
    rows, summary = data["rows"], data["summary"]
    by_variant: dict = {}
    for r in rows:
        by_variant.setdefault(r["variant"].split("@")[0], []).append(r)
    from whisperjav_tpu_torch.models.whisper.config import WHISPER_SIZES
    n_layer = WHISPER_SIZES[summary["model"]].n_text_layer
    # the layer ablations run on models deeper than their layer counts
    expected = {v for g in summary["groups"] for v in g
                if not (v.startswith("layers") and int(v[6:]) >= n_layer)}
    expected = (expected - {"__mid__"}) | {"base", "bf16_weights"}
    bad = sorted(v for v in expected if not (
        by_variant.get(v) and all(r.get("seconds", 0) > 0
                                  for r in by_variant[v])))
    if rc != 0 or bad or "int4_cross_kv" not in expected:
        raise RuntimeError(f"decode_profile: exit {rc}, variants without "
                           f"timed rows {bad}")
    slopes = summary["ms_per_step"]
    if not slopes.get("base", 0) > 0 \
            or not slopes.get("int4_cross_kv", 0) > 0:
        raise RuntimeError(f"decode_profile: base or int4 slope {slopes}")
    log(f"decode_profile ({' '.join(TOOLS_PROFILE_ARGS)}, {wall:.1f} s): "
        f"ms/step {json.dumps(slopes)}; base early "
        f"{summary['ms_per_step_base_early']} late "
        f"{summary['ms_per_step_base_late']}; attribution "
        f"{json.dumps(summary['attribution_ms'])}; layers "
        f"{json.dumps(summary.get('layer_decomposition'))}")
    log(f"decode_profile: base (int8, q/k/v apart: unfused layers) "
        f"{slopes['base']} ms/step, fused_qkv (the engine's tree: fused "
        f"blocks) {slopes.get('fused_qkv')} ms/step, beside the large-v2 "
        f"breakdown's greedy B=64 {GREEDY_LV2_MS_PER_STEP} ms/step (fused "
        f"blocks, prefill and host loop included); int4_cross_kv "
        f"(nibble-packed cross-K/V, plain PyTorch on the unfused layers) "
        f"{slopes['int4_cross_kv']} ms/step beside base {slopes['base']} "
        f"(int4_kv_saving {summary['attribution_ms']['int4_kv_saving']})")
    for name, per_step in summary["launches_per_step"].items():
        log(f"decode_profile launches per step, {name}: "
            f"{json.dumps(per_step)}")
    return summary


def write_fw_checkpoint(path: Path) -> None:
    """A narrow HF Whisper written by transformers from seed 0."""
    import transformers
    cfg = transformers.WhisperConfig(
        **TOOLS_FW_WHISPER, pad_token_id=50257, bos_token_id=50257,
        eos_token_id=50257, decoder_start_token_id=50258)
    torch.manual_seed(0)
    transformers.WhisperForConditionalGeneration(cfg).eval() \
        .save_pretrained(path)


def run_first_weights(tmp: Path) -> dict:
    """whisperjav-torch-first-weights on the narrow checkpoint: stages 0
    and 1 must pass; stage 2's two arms run on the card and launch every
    kernel of FIRST_WEIGHTS_NEEDS. Its verdict is printed, not required."""
    from whisperjav_tpu_torch.tools import first_weights
    ckpt = tmp / "fw-whisper"
    write_fw_checkpoint(ckpt)
    walls, arm_launches = [], []
    transcribe = first_weights._transcribe_text

    def timed(*a, **k):
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        out = transcribe(*a, **k)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        arm_launches.append(launch_counts())
        return out

    report_path = tmp / "first_weights.json"
    first_weights._transcribe_text = timed
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = first_weights.main(["--checkpoint", str(ckpt), "--report",
                                     str(report_path), "--device",
                                     TOOLS_DEVICE])
    finally:
        first_weights._transcribe_text = transcribe
    report = json.loads(report_path.read_text())
    s0, s1 = report["stage0_structural"], report.get("stage1_oracle", {})
    if not s0["ok"] or s1.get("status") != "pass" or len(walls) != 2:
        raise RuntimeError(f"first_weights: exit {rc}, stage 0 {s0}, "
                           f"stage 1 {s1}, {len(walls)} stage-2 arms")
    launches = {k: arm_launches[0][k] + arm_launches[1][k]
                for k in arm_launches[0]}
    for arm, needs in ((0, TURBO_NEEDS), (1, FIRST_WEIGHTS_NEEDS)):
        missing = [k for k in needs if arm_launches[arm][k] < 1]
        if missing:
            raise RuntimeError(f"first_weights stage 2 arm {arm}: kernels "
                               f"never launched: {missing}")
    s2 = report["stage2_int8_gate"]
    log(f"first_weights (d=256, 4 x 64 heads, 2 + 2 layers, seeded): stage "
        f"0 {s0['family']} {s0['n_leaves']} leaves ok; stage 1 encoder "
        f"max err {s1['encoder_max_err']:.3e}, argmax agreement "
        f"{s1['logit_argmax_agreement']}; stage 2 walls bf16 "
        f"{walls[0]:.3f} s, int8 {walls[1]:.3f} s; stage 2 verdict "
        f"{s2['status']} (divergence CER {s2.get('output_divergence_cer')}"
        f"; random weights set this verdict, not the port)")
    log(f"first_weights stage 2 launches: bf16 arm "
        f"{json.dumps(arm_launches[0])}; int8 arm "
        f"{json.dumps(arm_launches[1])}")
    return launches


def run_determinism(tmp: Path) -> tuple:
    """determinism_suite in-process: two flagless runs on one clip must
    write byte-identical SRTs, and byte-identical per-window decode
    diagnostics (``.transcribe.json``: segments, avg logprob, no-speech
    probability, characters of every window), which random weights
    leave non-empty where the sanitizer empties the SRT."""
    from whisperjav_tpu_torch.tools import determinism_suite
    clip = tmp / "det.wav"
    seconds = synthetic_clip_seeded(clip, TOOLS_DET_CLIP_S, 80)
    root = tmp / "det"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = determinism_suite.main(["--media", str(clip), *TOOLS_DET_ARGS,
                                     "--output-root", str(root),
                                     "--device", TOOLS_DEVICE])
    wall = time.perf_counter() - t0
    summary = json.loads((root / "summary.json").read_text())
    runs = [json.loads(ln) for ln in
            (root / "results.jsonl").read_text().splitlines()]
    diags = [(root / f"run_{i:03d}" / f"{clip.stem}.transcribe.json")
             .read_bytes() for i in range(len(runs))]
    windows = json.loads(diags[0])["windows"]
    if (summary["distinct_outputs"] != 1 or len(runs) != 2
            or diags[1] != diags[0] or not windows):
        raise RuntimeError(f"determinism: {summary} ({runs}); window "
                           f"diagnostics equal: {diags[1] == diags[0]}")
    log(f"determinism_suite ({seconds:.3f} s clip, {' '.join(TOOLS_DET_ARGS)}"
        f"; exit {rc}, {wall:.1f} s): {summary['distinct_outputs']} distinct "
        f"SRT hash over {len(runs)} runs ({runs[0]['srt_sha'][:16]}), "
        f"identical window diagnostics ({len(windows)} windows, "
        f"{sum(w['segments'] for w in windows)} segments, "
        f"{sum(w['chars'] for w in windows)} characters), "
        f"cues {[r['cues'] for r in runs]}, walls "
        f"{[r['wall_s'] for r in runs]} s, verdict {summary['verdict']} "
        f"(catastrophic runs {summary['catastrophic_runs']})")
    return summary, runs


def run_bench_self(tmp: Path, srt: Path) -> None:
    """whisperjav-torch-bench grades the e2e SRT against itself: CER 0
    and timing IoU 1."""
    from whisperjav_tpu_torch.bench import cli as bench_cli
    report = tmp / "bench.json"
    rc = bench_cli.main(["-g", str(srt), "-t", str(srt), "-o", str(report)])
    result = json.loads(report.read_text())["results"][str(srt)]
    if rc != 0 or result["cer"] != 0.0 or result["timing_iou"] != 1.0:
        raise RuntimeError(f"whisperjav-torch-bench: exit {rc}, {result}")
    log(f"whisperjav-torch-bench (the e2e SRT against itself, "
        f"{result['gt_cues']} cues): cer {result['cer']}, timing_iou "
        f"{result['timing_iou']}, temporal_order "
        f"{result['temporal_order']}")


def run_tools_phase(tmp: Path) -> dict:
    """The developer tools on the card: e2e_bench (a child CLI), then
    decode_profile, first_weights, determinism_suite and
    whisperjav-torch-bench in-process, whose launches it returns."""
    tools = tmp / "tools"
    tools.mkdir()
    _, srt = run_e2e_bench(tools)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    zero_launches()
    run_decode_profile(tools)
    torch.cuda.synchronize()
    profile = launch_counts()
    torch.cuda.empty_cache()
    fw = run_first_weights(tools)
    torch.cuda.empty_cache()
    zero_launches()
    run_determinism(tools)
    torch.cuda.synchronize()
    det = launch_counts()
    torch.cuda.empty_cache()
    run_bench_self(tools, srt)
    return {k: profile[k] + fw[k] + det[k] for k in profile}


# Qwen3-ASR's decode steps take the column attention kernel
QWEN_NEEDS = ("qwen_column_attention",)
QWEN_WHISPER_NEEDS = TURBO_NEEDS
# the WhisperSeg framer's network: its encoder takes Kernel A, its bf16
# decoder prefill Kernel B's bf16 form
WHISPERSEG_NEEDS = TURBO_NEEDS


# ---------------------------------------------------------------------------
# the gui phase: whisperjav-torch-gui's jobs through the resident engine
# ---------------------------------------------------------------------------

# the two queued clips and the cancelled one: (seed, seconds)
GUI_CLIPS = ((80, 20.0), (81, 20.0))
GUI_CANCEL_CLIP = (82, 12.0)
# every GUI job's options besides its input: without the sanitizer (the
# random weights' text would leave empty SRTs) and the signature
GUI_OPTIONS = {"no_sanitize": True, "no_signature": True}
GUI_JOB_DEADLINE_S = 300.0
GUI_VERSION_LIMIT_S = 5.0
GUI_POLL_S = 0.1
# model_loader's checkpoint: a narrow Whisper (hd = 64), seed 0
GUI_CKPT_WIDTHS = dict(n_mels=80, n_audio_state=256, n_audio_head=4,
                       n_audio_layer=2, n_text_state=256, n_text_head=4,
                       n_text_layer=2, n_vocab=51865)
ROOT = Path(__file__).resolve().parent


def offline_env(**extra) -> dict:
    """This process's environment with HTTPS sent to a proxy on a closed
    local port: a release poll fails at once and asks no outside host."""
    import os
    env = {k: v for k, v in os.environ.items()
           if k.lower() not in ("no_proxy", "https_proxy")}
    proxy = f"http://127.0.0.1:{free_port()}"
    env.update(https_proxy=proxy, HTTPS_PROXY=proxy, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    return env


def gui_get(base: str, path: str):
    """GET ``base + path``; the parsed JSON (the page: its text)."""
    import urllib.request
    with urllib.request.urlopen(base + path, timeout=60) as r:
        body = r.read()
        if r.headers.get_content_type() == "application/json":
            return json.loads(body)
        return body.decode("utf-8")


def gui_post(base: str, path: str, body: dict) -> dict:
    import urllib.request
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def wait_gui(base: str, proc, limit_s: float = 120.0) -> None:
    import urllib.error
    deadline = time.time() + limit_s
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"gui: the server exited {proc.returncode}")
        try:
            gui_get(base, "/api/status")
            return
        except (urllib.error.URLError, OSError):
            time.sleep(0.2)
    raise RuntimeError(f"gui: no answer from {base} in {limit_s} s")


def poll_jobs(base: str, ids: list, deadline_s: float,
              until=("done",)) -> tuple:
    """Poll /api/queue every GUI_POLL_S until every job in ``ids`` is in
    a final state; each job's wall from the first poll that saw it
    running to the first that saw it final. Returns (jobs, walls)."""
    final = ("done", "failed", "cancelled")
    started, walls = {}, {}
    deadline = time.time() + deadline_s
    while True:
        jobs = {j["id"]: j for j in gui_get(base, "/api/queue")["jobs"]}
        now = time.perf_counter()
        for i in ids:
            if jobs[i]["status"] == "running":
                started.setdefault(i, now)
            elif jobs[i]["status"] in final and i not in walls:
                walls[i] = now - started.get(i, now)
        if all(jobs[i]["status"] in final for i in ids):
            break
        if time.time() > deadline:
            raise RuntimeError(f"gui: jobs {ids} not finished within "
                               f"{deadline_s} s: {jobs}")
        time.sleep(GUI_POLL_S)
    bad = [jobs[i] for i in ids if jobs[i]["status"] not in until]
    if bad:
        raise RuntimeError(f"gui: jobs ended {bad}")
    return [jobs[i] for i in ids], [walls[i] for i in ids]


TRACE_STAGES = ("extracted ", "decoding ", "sanitizing")


@contextlib.contextmanager
def blocked_imports(*names):
    """Inside the block, importing any of the top-level packages
    ``names`` raises ImportError, loaded or not."""
    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in names:
                raise ImportError(f"blocked: {name}")
            return None
    saved = {m: sys.modules.pop(m) for m in list(sys.modules)
             if m.split(".")[0] in names}
    finder = Block()
    sys.meta_path.insert(0, finder)
    try:
        yield
    finally:
        sys.meta_path.remove(finder)
        sys.modules.update(saved)


def check_gui_pages(base: str, card: str) -> None:
    """The page, the schemas, the presets and the release poll."""
    from whisperjav_tpu_torch.gui.server import _COMPONENT_CONFIGS, schema
    page = gui_get(base, "/")
    if "<title>WhisperJAV PyTorch</title>" not in page \
            or "loadVersion" not in page:
        raise RuntimeError("gui: / is not the app page")
    if gui_get(base, "/api/schema") != json.loads(json.dumps(schema())):
        raise RuntimeError("gui: /api/schema differs from schema()")
    n = 0
    for ctype, names in _COMPONENT_CONFIGS.items():
        for name in names:
            got = gui_get(base, f"/api/component_schema?type={ctype}"
                                f"&name={name}")
            if not (got["success"] and got["fields"]):
                raise RuntimeError(f"gui: component {ctype}/{name}: {got}")
            n += 1
    preset = {"mode": "balanced", "no_sanitize": True}
    if gui_post(base, "/api/presets", {"name": "smoke 字幕",
                                       "options": preset}) != {"ok": True}:
        raise RuntimeError("gui: preset not saved")
    if gui_get(base, "/api/presets") != {"smoke 字幕": preset}:
        raise RuntimeError("gui: preset not listed")
    if gui_post(base, "/api/presets", {"name": "smoke 字幕",
                                       "delete": True}) != {"ok": True} \
            or gui_get(base, "/api/presets") != {}:
        raise RuntimeError("gui: preset not deleted")
    t0 = time.perf_counter()
    version = gui_get(base, "/api/version")
    version_s = time.perf_counter() - t0
    if version.get("checked") is not False or not version.get("version") \
            or version_s > GUI_VERSION_LIMIT_S:
        raise RuntimeError(f"gui: /api/version {version} in {version_s} s")
    log(f"gui: page {len(page)} characters, schema equal, {n} component "
        f"schemas, a preset saved, listed and deleted; /api/version "
        f"{json.dumps(version)} in {version_s:.3f} s ({card})")


def check_gui_utilities(dev, tmp: Path, walls: list, card: str) -> None:
    """whisperjav-torch-upgrade offline; resolve_checkpoint onto the card
    with the hub packages blocked; the job walls through
    MetadataManager."""
    from whisperjav_tpu_torch.models.whisper.config import WhisperConfig
    from whisperjav_tpu_torch.models.whisper.weights import (
        init_params, params_from_jax, params_to_jax,
    )
    from whisperjav_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    from whisperjav_tpu_torch.utils.metadata import MetadataManager
    from whisperjav_tpu_torch.utils.model_loader import resolve_checkpoint
    t0 = time.perf_counter()
    up = subprocess.run(
        [sys.executable, "-m", "whisperjav_tpu_torch.utils.version_check"],
        cwd=str(tmp), env=offline_env(), capture_output=True, text=True,
        timeout=120)
    up_s = time.perf_counter() - t0
    if up.returncode != 0 or \
            "update check unavailable (offline)" not in up.stdout:
        raise RuntimeError(f"whisperjav-torch-upgrade: rc {up.returncode}, "
                           f"{up.stdout!r} {up.stderr[-2000:]!r}")
    log(f"gui: whisperjav-torch-upgrade rc 0 in {up_s:.3f} s: "
        f"{up.stdout.strip()}")

    cfg = WhisperConfig(name="gui-narrow", **GUI_CKPT_WIDTHS)
    host = init_params(cfg, torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(tmp / "gui-ckpt", params_to_jax(host),
                           {"model": cfg.name})
    calls = []

    def loader(source, **kw):
        calls.append((source, kw))
        return params_from_jax(load_checkpoint(source), cfg, device=dev)
    t0 = time.perf_counter()
    with blocked_imports("huggingface_hub", "transformers"):
        model = resolve_checkpoint(str(ckpt), loader=loader)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    state = model.state_dict()
    if calls != [(str(ckpt), {})]:
        raise RuntimeError(f"resolve_checkpoint: loader calls {calls}")
    off = [k for k, v in state.items()
           if v.device.type != torch.device(dev).type]
    if off:
        raise RuntimeError(f"resolve_checkpoint: not on the card: {off}")
    want = host.state_dict()
    if sorted(state) != sorted(want) or not all(
            torch.equal(state[k].cpu(), want[k]) for k in want):
        raise RuntimeError("resolve_checkpoint: parameters differ from "
                           "the checkpoint's")
    log(f"gui: resolve_checkpoint loaded {len(state)} tensors "
        f"({sum(v.numel() for v in state.values())} parameters) onto "
        f"{torch.cuda.get_device_name(0)} in {load_s:.3f} s, one loader "
        f"call, huggingface_hub and transformers blocked")

    mm = MetadataManager(tmp / "gui-meta", "gui")
    mm.set_input(clips=[f"gui{i}.wav" for i in range(len(walls))],
                 card=card)
    for i, wall in enumerate(walls):
        mm.complete_stage(f"job{i}", wall_s=np.float64(wall))
    back = MetadataManager.load(mm.save())
    got = [back.data["stages"][f"job{i}"]["results"]["wall_s"]
           for i in range(len(walls))]
    if got != [float(w) for w in walls] or back.data["input"]["card"] != card:
        raise RuntimeError(f"MetadataManager: walls {walls} read back as "
                           f"{got}")
    log(f"gui: job walls written and read back through MetadataManager "
        f"({back.path.name})")


def run_gui_phase(dev, tmp: Path) -> dict:
    """``whisperjav-torch-gui`` as a user runs it: its jobs' CLI children
    go through the resident engine, here hosted in this process on the
    daemon's port so its kernel launches are counted. Returns the two
    jobs' launches."""
    from whisperjav_tpu_torch import cli, serve
    from whisperjav_tpu_torch.cli_args import parse_arguments
    from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
    from whisperjav_tpu_torch.gui.server import build_args
    from whisperjav_tpu_torch.pipelines import daemon_client
    from whisperjav_tpu_torch.pipelines.factory import build_pipeline
    t_phase = time.perf_counter()
    card = card_line()
    port = daemon_client.DEFAULT_PORT
    if not port_is_free(port):
        raise RuntimeError(f"gui: the daemon's port {port} is taken")
    clips = []
    for i, (seed, seconds) in enumerate((*GUI_CLIPS, GUI_CANCEL_CLIP)):
        clips.append(tmp / f"gui{i}.wav")
        synthetic_clip_seeded(clips[-1], seconds, seed)
    out_dir = tmp / "gui-out"
    options = {**GUI_OPTIONS, "output_dir": str(out_dir)}
    gui_port = free_port()
    base = f"http://127.0.0.1:{gui_port}"
    gui_log = tmp / "gui-server.log"
    server = thread = gui = None
    try:
        with open(gui_log, "wb") as log_f:
            gui = subprocess.Popen(
                [sys.executable, "-m", "whisperjav_tpu_torch.gui.server",
                 "--port", str(gui_port)], cwd=str(tmp),
                env=offline_env(XDG_CONFIG_HOME=str(tmp / "gui-xdg")),
                stdout=log_f, stderr=subprocess.STDOUT)
        wait_gui(base, gui)
        check_gui_pages(base, card)

        # the engine a job's --daemon finds: built for the config its
        # argv resolves to, as start_daemon would build it
        args = parse_arguments(build_args(
            {**options, "inputs": [str(clips[0])]})[3:])
        cfg = resolve_pipeline_config(
            mode=args.mode, sensitivity=args.sensitivity,
            language=args.language, model=args.model,
            batch_size=args.batch_size)
        t0 = time.perf_counter()
        pipeline = build_pipeline(cfg, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        service = serve.TranscriptionService(
            pipeline, device=dev, fingerprint=daemon_client._fingerprint(cfg))
        server = serve.make_server(service, port=port)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        log(f"gui: resident engine ({cfg.model}, {cfg.mode.name}/"
            f"{cfg.sensitivity.name}, B={cfg.batch_size}) built in this "
            f"process in {build_s:.3f} s, serving on port {port} ({card})")

        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        started = gui_post(base, "/api/start",
                           {**options, "inputs": [str(c) for c in clips[:2]]})
        if started != {"ok": True, "jobs": [0, 1]}:
            raise RuntimeError(f"gui: /api/start answered {started}")
        jobs, walls = poll_jobs(base, [0, 1], GUI_JOB_DEADLINE_S)
        torch.cuda.synchronize()
        jobs_s = time.perf_counter() - t0
        launches = launch_counts()
        srts = []
        for job, clip, wall in zip(jobs, clips, walls):
            lines = gui_get(base, f"/api/logs?job={job['id']}")["lines"]
            srt = out_dir / f"{clip.stem}.ja.whisperjav.srt"
            if "-m whisperjav_tpu_torch.cli" not in lines[0] \
                    or "--daemon" not in lines[0]:
                raise RuntimeError(f"gui: job argv {lines[0]}")
            if not any(", daemon, RTF" in ln for ln in lines):
                raise RuntimeError(f"gui: job {job['id']} did not go "
                                   f"through the resident engine: "
                                   f"{lines[-20:]}")
            cues = srt_cues(srt)
            if not cues:
                raise RuntimeError(f"gui: {srt.name} has no cue")
            if job["result"].get("srt") != srt.name \
                    or job["result"].get("subtitles") != len(cues):
                raise RuntimeError(f"gui: job {job['id']} result "
                                   f"{job['result']} ({len(cues)} cues)")
            if not any(st.startswith(TRACE_STAGES) for st in job["stages"]):
                raise RuntimeError(f"gui: job {job['id']} stages "
                                   f"{job['stages']}")
            srts.append(srt)
            log(f"gui: job {job['id']} ({clip.name}, "
                f"{wave_seconds(clip):.3f} s) wall {wall:.3f} s (polled "
                f"every {GUI_POLL_S} s), result {json.dumps(job['result'])}"
                f", stages {job['stages']} ({card})")
        missing = [n for n in TURBO_NEEDS if launches[n] < 1]
        if missing:
            raise RuntimeError(f"gui: kernels never launched: {missing} "
                               f"({launches})")
        log(f"gui: 2 jobs in {jobs_s:.3f} s; the hosted engine's launches "
            f"{json.dumps({n: launches[n] for n in TURBO_NEEDS})} ({card})")

        cli_dir = tmp / "gui-cli"
        flags = [a for a in build_args(GUI_OPTIONS)[3:] if a != "--daemon"]
        if cli.main([str(clips[0]), "--daemon", "--output-dir", str(cli_dir),
                     *flags]) != 0:
            raise RuntimeError("gui: the --daemon CLI run failed")
        if (cli_dir / srts[0].name).read_bytes() != srts[0].read_bytes():
            raise RuntimeError("gui: the CLI's --daemon SRT differs from "
                               "the GUI job's")
        log(f"gui: cli.main --daemon wrote {srts[0].name} byte-identical "
            f"to the GUI job's ({len(srt_cues(srts[0]))} cues)")

        started = gui_post(base, "/api/start", {
            **options, "inputs": [str(clips[2])], "daemon": False})
        if started != {"ok": True, "jobs": [2]}:
            raise RuntimeError(f"gui: /api/start answered {started}")
        deadline = time.time() + 120
        while gui_get(base, "/api/queue")["jobs"][2]["status"] == "queued":
            if time.time() > deadline:
                raise RuntimeError("gui: the third job never ran")
            time.sleep(GUI_POLL_S)
        t0 = time.perf_counter()
        gui_post(base, "/api/cancel", {"job": 2})
        jobs, _ = poll_jobs(base, [0, 1, 2], 120, until=("done",
                                                         "cancelled"))
        cancel_s = time.perf_counter() - t0
        if [j["status"] for j in jobs] != ["done", "done", "cancelled"] \
                or gui_get(base, "/api/queue")["status"] != "done":
            raise RuntimeError(f"gui: after the cancel {jobs}")
        alive = subprocess.run(["pgrep", "-f", str(clips[2])],
                               capture_output=True, text=True)
        if alive.returncode != 1:
            raise RuntimeError(f"gui: the cancelled job's child lives on: "
                               f"{alive.stdout}")
        log(f"gui: job 2 (daemon false) cancelled while running, ended "
            f"'cancelled' {cancel_s:.3f} s after the cancel, child gone; "
            f"the queue reads {[j['status'] for j in jobs]}")
        check_gui_utilities(dev, tmp, walls, card)
    except Exception:
        if gui_log.exists():
            log("gui: the GUI server's log ends: " + gui_log.read_text(
                encoding="utf-8", errors="replace")[-4000:])
        raise
    finally:
        if gui is not None:
            gui.terminate()
            try:
                gui.wait(30)
            except subprocess.TimeoutExpired:
                gui.kill()
                gui.wait(30)
        for clip in clips:
            subprocess.run(["pkill", "-f", str(clip)], check=False)
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        torch.cuda.empty_cache()
    log(f"gui: phase {time.perf_counter() - t_phase:.3f} s ({card})")
    return launches


# the kernels of the flagless path, by the names the model module calls
DEVICES_SPIED = ("encoder_attention", "decode_cross_attention_bf16")


@contextlib.contextmanager
def calls_by_stream():
    """Count the model's calls of Kernel A's and Kernel B's bf16 wrappers
    by (name, device index, stream) of the caller; besides, under
    ("captured", name) the calls made inside a CUDA graph capture (they
    launch at the graph's replays, not then), and under ("replayed",
    name) the launches the replays of the decode step's graphs added.
    The wrappers launch and count as they do."""
    from whisperjav_tpu_torch.models.whisper import model as wm
    from whisperjav_tpu_torch.ops.cuda import _build
    seen: dict = {}
    origs = {name: getattr(wm, name) for name in DEVICES_SPIED}
    count_replay = _build.count_replay

    def add(key, n=1):
        seen[key] = seen.get(key, 0) + n

    def spy(name, fn):
        def wrapped(*a, **k):
            stream = torch.cuda.current_stream()
            add((name, stream.device.index, stream.cuda_stream))
            if getattr(_build._CAPTURING, "launches", None) is not None:
                add(("captured", name))
            return fn(*a, **k)
        return wrapped

    def replay(held):
        for counter, n in held.values():
            add(("replayed", counter.__name__), n)
        count_replay(held)
    for name, fn in origs.items():
        setattr(wm, name, spy(name, fn))
    _build.count_replay = replay
    try:
        yield seen
    finally:
        for name, fn in origs.items():
            setattr(wm, name, fn)
        _build.count_replay = count_replay


def devices_run(wav: Path, out: Path, dev, mesh, label: str) -> dict:
    """The flagless turbo pipeline (no sanitizer) on ``mesh`` (None: one
    card) through one file; the launch counts zeroed just before and read
    just after, and each kernel's calls by the shard that made them."""
    from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
    from whisperjav_tpu_torch.models.whisper import step_graph
    from whisperjav_tpu_torch.modules.media_discovery import probe
    from whisperjav_tpu_torch.pipelines.factory import build_pipeline
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipeline, build_s = _timed(lambda: build_pipeline(
        resolve_pipeline_config(), device=dev, mesh=mesh))
    engine = pipeline.engine
    if mesh is None and len(engine._shards) != 1:
        raise RuntimeError(f"devices: the flagless factory built "
                           f"{len(engine._shards)} shards; its default is "
                           "one card")
    zero_launches()
    with calls_by_stream() as seen:
        result, wall = _timed(lambda: pipeline.process(probe(wav), out))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    shards = []
    for shard in engine._shards:
        # a shard encodes on its side stream and decodes on its stream,
        # the decode step's graphs captured on the stream its model's
        # graph cache keeps for that (and replayed on the shard's)
        capture = [slot.side for slot in
                   step_graph._SLOTS.get(shard.model, {}).values()
                   if slot.side is not None]
        streams = {"encoder_attention": [shard.side],
                   "decode_cross_attention_bf16": [
                       shard.stream if shard.stream is not None
                       else torch.cuda.current_stream(shard.device),
                       *capture]}
        shards.append({name: sum(seen.get((name, st.device.index,
                                           st.cuda_stream), 0)
                                 for st in streams[name])
                       for name in DEVICES_SPIED})
    missing = [(k, name) for k, calls in enumerate(shards)
               for name, n in calls.items() if n < 1]
    calls = sum(n for key, n in seen.items() if len(key) == 3)
    if missing or sum(sum(c.values()) for c in shards) != calls:
        raise RuntimeError(f"devices {label}: kernels not called on every "
                           f"shard {missing}, calls {seen}")
    # each call launches once, but a captured one, which launches at every
    # replay of its graph
    if any(launches[name] != sum(c[name] for c in shards)
           - seen.get(("captured", name), 0) + seen.get(("replayed", name), 0)
           for name in DEVICES_SPIED):
        raise RuntimeError(f"devices {label}: launch counts {launches} "
                           f"against the shards' calls {shards}, {seen}")
    stats = result.metadata["stats"]
    log(f"devices {label} ({engine.mesh.size} shard(s) on "
        f"{[str(d) for d in engine.mesh.devices]}, B={engine.batch_size}): "
        f"build {build_s:.3f} s, wall {wall:.3f} s, windows "
        f"{stats['windows']}, raw subtitles {stats['raw_subtitles']}, peak "
        f"device memory {peak} bytes ({peak / 2**30:.3f} GiB); launches by "
        f"shard {json.dumps(shards)}")
    del pipeline, engine
    torch.cuda.empty_cache()
    return {"launches": launches, "wall": wall, "peak": peak,
            "shards": shards}


def same_outputs(a: Path, b: Path, stem: str, what: str) -> None:
    """The SRT and the window diagnostics of two runs, byte for byte; on
    a difference, the windows that differ."""
    srt = f"{stem}.ja.whisperjav.srt"
    if (a / srt).read_bytes() != (b / srt).read_bytes():
        raise RuntimeError(f"devices: {what}: {srt} differs")
    diag = f"{stem}.transcribe.json"
    if (a / diag).read_bytes() != (b / diag).read_bytes():
        wa, wb = (json.loads((d / diag).read_text())["windows"]
                  for d in (a, b))
        diff = [(x, y) for x, y in zip(wa, wb) if x != y]
        raise RuntimeError(f"devices: {what}: {diag} differs in "
                           f"{len(diff)} of {len(wa)} windows: {diff[:4]}")


# cuBLAS picks a split of a product's K over blocks by the row count
# (measured: the K=5120 MLP product, 64 rows against 32); given no
# workspace it cannot split, and a shard's rows then compute as one
# card's. The devices phase runs in a child with it.
BATCH_INVARIANT_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":0:0",
                       "CUBLASLT_WORKSPACE_SIZE": "0"}


def row_split_difference(label: str) -> float:
    """Log and return the largest difference between 32 rows of one bf16
    product taken with 64 rows and taken alone: the decoder's MLP output
    product at turbo widths (K = 5120, N = 1280), the product whose rows
    cuBLAS splits by the row count."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(64, 5120, device=dev, generator=gen).to(torch.bfloat16)
    w = (torch.randn(5120, 1280, device=dev, generator=gen)
         * 0.02).to(torch.bfloat16)
    diff = (torch.mm(x, w)[:32].float()
            - torch.mm(x[:32], w).float()).abs().max().item()
    log(f"devices: {label}: a K=5120 x N=1280 bf16 product, 32 rows with "
        f"64 against alone: max |difference| {diff}")
    return diff


_DEVICES_CHILD = """
import json, sys
import chip_smoke
record = chip_smoke.devices_child(sys.argv[1])
print("DEVICES_CHILD " + json.dumps(record), flush=True)
"""


def devices_child(tmp: str) -> dict:
    """The devices phase, in a child with BATCH_INVARIANT_ENV: the CLI
    at --devices 2 against --devices 1 (capped to the cards there are);
    after a warm-up file, the flagless turbo engine over one shard and
    over two shards of cuda:0 (and, with a second card, over cuda:0 and
    cuda:1, then every kernel on cuda:1) on the turbo clip. Each pair's
    SRT and window diagnostics must be byte-identical."""
    from whisperjav_tpu_torch import cli
    from whisperjav_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tmp)
    wav = tmp / "devices.wav"
    dev = torch.device("cuda")
    n_cards = torch.cuda.device_count()
    row_split_difference("cuBLAS without workspace")
    walls = {}
    for n in ("2", "1"):
        torch.cuda.synchronize()
        rc, walls[n] = _timed(lambda: cli.main([
            str(wav), "--output-dir", str(tmp / f"devices-cli-{n}"),
            "--devices", n]))
        if rc != 0:
            raise RuntimeError(f"devices: --devices {n} exited {rc}")
    same_outputs(tmp / "devices-cli-2", tmp / "devices-cli-1", "devices",
                 f"--devices 2 on {n_cards} card(s) against --devices 1")
    log(f"devices: cli --devices 2 ({min(2, n_cards)} card(s) of "
        f"{n_cards}) wall {walls['2']:.3f} s, --devices 1 wall "
        f"{walls['1']:.3f} s: SRT and window diagnostics byte-identical")
    warm = tmp / "devices-warm.wav"
    synthetic_clip_seeded(warm, 8.0, 90)
    devices_run(warm, tmp / "devices-warm", dev, None, "warm-up")
    runs = {"one": devices_run(wav, tmp / "devices-one", dev, None,
                               "one shard"),
            "two": devices_run(wav, tmp / "devices-two", dev,
                               make_mesh(devices=["cuda:0", "cuda:0"]),
                               "two shards on cuda:0")}
    same_outputs(tmp / "devices-two", tmp / "devices-one", "devices",
                 "two shards of cuda:0 against one")
    if n_cards > 1:
        runs["cards"] = devices_run(wav, tmp / "devices-cards", dev,
                                    make_mesh(devices=["cuda:0", "cuda:1"]),
                                    "cuda:0 and cuda:1")
        same_outputs(tmp / "devices-cards", tmp / "devices-one", "devices",
                     "cuda:0 and cuda:1 against one card")
        second = torch.device("cuda:1")
        with torch.cuda.device(second):
            gen = torch.Generator(device=second).manual_seed(0)
            check_encoder_attention(second, gen, None)
            check_decode_attention(second, gen, None)
            check_fused_blocks(second, gen, None)
        log("devices: every kernel launched on cuda:1 after cuda:0 and "
            "held against its plain version")
    return runs


def run_devices_phase(tmp: Path) -> dict:
    """``--devices``: :func:`devices_child` in a child process with
    BATCH_INVARIANT_ENV on the turbo clip; its lines are relayed and its
    record logged. Returns the two-shard run's launches."""
    import os
    wav = tmp / "devices.wav"
    duration = synthetic_clip(wav, TURBO_CLIP_S)
    row_split_difference("cuBLAS as it comes (this process)")
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, "-c", _DEVICES_CHILD, str(tmp)],
        cwd=str(Path(__file__).resolve().parent), capture_output=True,
        text=True, timeout=600, env={**os.environ, **BATCH_INVARIANT_ENV})
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith("DEVICES_CHILD "):
            log(f"  {line}")
    record = next((json.loads(line.split(" ", 1)[1]) for line in lines
                   if line.startswith("DEVICES_CHILD ")), None)
    if proc.returncode != 0 or record is None:
        raise RuntimeError(f"devices: the child exited {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    one, two = record["one"], record["two"]
    log(f"devices (cuBLAS without workspace, the {duration:.3f} s clip): "
        f"two shards of one card against one shard: SRT and window "
        f"diagnostics byte-identical; walls {two['wall']:.3f} s against "
        f"{one['wall']:.3f} s; peak memory {two['peak']} bytes against "
        f"{one['peak']} (two model replicas against one)")
    if "cards" in record:
        log(f"devices: over cuda:0 and cuda:1 the SRT of one card, wall "
            f"{record['cards']['wall']:.3f} s")
    else:
        log("devices: one card visible: the launch of each kernel on a "
            "second card is unchecked here")
    return two["launches"]


# ---------------------------------------------------------------------------
# ahead phase
# ---------------------------------------------------------------------------

# the flagless engine's pipelining: 70 seeded windows of 3-30 s (batches
# of 32, 32 and 6), the ladder clamped to its first two rungs
# (WJAV_LADDER_RUNGS: random weights fail every gate and would run all
# six), after one warm-up batch, with pipelining off, encode-ahead only,
# and both (decode-ahead's memory gate, "auto", lets it on at turbo B=32)
AHEAD_WINDOWS = 70
AHEAD_LADDER_RUNGS = "2"
AHEAD_RUNS = (("off", "0", "0"), ("encode-ahead", "1", "0"),
              ("both", "1", "auto"))
# the run under the CUDA-only profiler (its stop and reading take 25-30 s
# after the wall): the busy share and overlap are read on it alone
AHEAD_PROFILED = "both"
# Kernel A on a side stream beside Kernel B's bf16 form on the main one:
# A's launches and B's (turbo's 4 decoder layers, B=32, beam fold R=2,
# T=1500), enough of B to outlast A
TWO_STREAM_A, TWO_STREAM_B = 4, 64
# whisper-vad's default engines (bf16, cross-K/V in the compute dtype) on
# the card and on the CPU from the same seeded tiny weights: bf16 on both
# sides, roundings in other places -> probabilities within this
WVAD_TOL_P = 0.02
WVAD_TRACK_S = 30.0


def device_intervals(prof) -> tuple:
    """(union of the device's activity intervals, their summed lengths),
    in ms, from a finished CUDA-only ``torch.profiler`` run: the sum
    exceeds the union where two streams ran at once. Reads the raw
    activity records (a pipelined run holds ~10^5 kernels, too many to
    build the profiler's event tree from)."""
    from torch.autograd import DeviceType
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    spans.sort()
    union, total, end = 0, 0, None
    for s, e in spans:
        total += e - s
        if end is None or s >= end:
            union += e - s
            end = e
        elif e > end:
            union += e - end
            end = e
    return union / 1e6, total / 1e6


def ahead_windows() -> list:
    from whisperjav_tpu_torch.parallel.batching import Window
    rng = np.random.default_rng(140)
    durations = np.round(rng.uniform(3.0, 30.0, AHEAD_WINDOWS), 2)
    return [Window(speech_like(float(d), 300 + i), 0.0, float(d), 0, i)
            for i, d in enumerate(durations)]


def window_bytes(results) -> str:
    """The window results as one string: group, and each segment's
    tokens, bounds, text, logprob and no-speech probability."""
    return json.dumps([
        (w.group_idx, [([int(t) for t in s.tokens], s.start, s.end, s.text,
                        float(s.avg_logprob), float(s.no_speech_prob))
                       for s in segs]) for w, segs in results])


def ahead_run(engine, windows, label: str, encode: str,
              decode: str) -> dict:
    """One ``transcribe_windows`` under the knobs, with the batch trace
    on (and the CUDA-only profiler on the AHEAD_PROFILED run); launches
    zeroed just before and read just after, Kernel A's calls by
    stream."""
    import os
    from torch.profiler import ProfilerActivity, profile
    os.environ.update(WJAV_ENCODE_AHEAD=encode, WJAV_DECODE_AHEAD=decode,
                      WJAV_TRACE_BATCHES="1")
    side = engine._shards[0].side
    profiled = label == AHEAD_PROFILED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with calls_by_stream() as seen, \
            (profile(activities=[ProfilerActivity.CUDA]) if profiled
             else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        results = engine.transcribe_windows(windows, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stop_s = time.perf_counter() - t0 - wall
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    busy = summed = None
    busy_line = "not profiled"
    if profiled:
        t1 = time.perf_counter()
        busy, summed = device_intervals(prof)
        read_s = time.perf_counter() - t1
        busy_line = (
            f"device busy {busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}% "
            f"of the wall), kernel time summed over streams {summed:.3f} "
            f"ms (overlap {summed - busy:.3f} ms); the profiler's stop "
            f"{stop_s:.3f} s and reading {read_s:.3f} s after the wall")
    a_side = seen.get(("encoder_attention", side.device.index,
                       side.cuda_stream), 0)
    decode_ahead = engine._decode_ahead_enabled()
    log(f"ahead {label} (WJAV_ENCODE_AHEAD={encode} "
        f"WJAV_DECODE_AHEAD={decode}, decode-ahead "
        f"{'on' if decode_ahead else 'off'}): wall {wall:.3f} s, "
        f"{len(windows)} windows; {busy_line}; peak device memory {peak} "
        f"bytes ({peak / 2**30:.3f} GiB); Kernel A "
        f"{launches['encoder_attention']} launches, {a_side} on the side "
        f"stream; Kernel B bf16 form "
        f"{launches['decode_cross_attention_bf16']}")
    for row in engine.batch_trace:
        log(f"  ahead {label} trace {json.dumps(row)}")
    return {"bytes": window_bytes(results), "wall": wall, "busy": busy,
            "summed": summed, "peak": peak, "a_side": a_side,
            "launches": launches, "decode_ahead": decode_ahead,
            "results": results}


def run_ahead_engine(dev) -> dict:
    """The flagless turbo engine's three pipelining settings on the same
    windows: byte-identical results, Kernel A's launches equal, and
    launched on the side stream. Returns the last run's launches."""
    from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
    from whisperjav_tpu_torch.pipelines.factory import build_pipeline
    with contextlib.ExitStack() as env:
        env.enter_context(switch_env("WJAV_LADDER_RUNGS",
                                     AHEAD_LADDER_RUNGS))
        for name in ("WJAV_ENCODE_AHEAD", "WJAV_DECODE_AHEAD"):
            env.enter_context(switch_env(name, None))
        engine = build_pipeline(resolve_pipeline_config(),
                                device=dev).engine
        windows = ahead_windows()
        log(f"ahead: turbo B={engine.batch_size}, beam "
            f"{engine.options.beam_size}, cross-K/V int8 "
            f"{engine.options.cross_kv_int8}, ladder "
            f"{engine.thresholds.temperatures} (WJAV_LADDER_RUNGS="
            f"{AHEAD_LADDER_RUNGS}), {len(windows)} windows of "
            f"{min(w.duration for w in windows):.2f}-"
            f"{max(w.duration for w in windows):.2f} s")
        env.enter_context(switch_env("WJAV_TRACE_BATCHES", "0"))
        _, warm = _timed(lambda: engine.transcribe_windows(
            windows[:engine.batch_size], seed=0))
        log(f"ahead: warm-up batch {warm:.3f} s")
        runs = {label: ahead_run(engine, windows, label, enc, dec)
                for label, enc, dec in AHEAD_RUNS}
    base = runs["off"]
    for label, run in runs.items():
        if run["bytes"] != base["bytes"]:
            diff = [(a, b) for a, b in zip(json.loads(run["bytes"]),
                                           json.loads(base["bytes"]))
                    if a != b]
            raise RuntimeError(f"ahead {label}: window results differ from "
                               f"pipelining off in {len(diff)} windows: "
                               f"{str(diff[:2])[:600]}")
        if run["launches"]["encoder_attention"] \
                != base["launches"]["encoder_attention"]:
            raise RuntimeError(
                f"ahead {label}: Kernel A launches "
                f"{run['launches']['encoder_attention']} against "
                f"{base['launches']['encoder_attention']}")
    for label in ("encode-ahead", "both"):
        if runs[label]["a_side"] < 1:
            raise RuntimeError(f"ahead {label}: Kernel A never ran on the "
                               "side stream")
    if not runs["both"]["decode_ahead"]:
        raise RuntimeError("ahead: the memory gate kept decode-ahead off at "
                           "turbo B=32")
    n_segs = sum(len(s) for _, s in base["results"])
    if not n_segs or len(base["results"]) != AHEAD_WINDOWS:
        raise RuntimeError(f"ahead: {len(base['results'])} windows back, "
                           f"{n_segs} segments")
    log("ahead: window results byte-identical over "
        + ", ".join(f"{k} ({r['wall']:.3f} s)" for k, r in runs.items())
        + f"; {n_segs} segments; Kernel A "
        f"{base['launches']['encoder_attention']} launches in each")
    del engine
    torch.cuda.empty_cache()
    return runs["both"]["launches"]


def check_two_streams(dev, gen) -> None:
    """Kernel A on a side stream while Kernel B's bf16 form runs on the
    main stream at the flagless path's shapes: each output equals its
    lone launch bit for bit and holds its plain version within the
    kernels phase's tolerances; the times alone and together."""
    from whisperjav_tpu_torch.ops.cuda import decode_attention as da
    from whisperjav_tpu_torch.ops.cuda.encoder_attention import (
        attention, encoder_attention,
    )
    shape = (32, 1500, 20, 64)
    q, k = ((torch.randn(shape, generator=gen, device=dev) * 3).bfloat16()
            for _ in range(2))
    v = torch.randn(shape, generator=gen, device=dev).bfloat16()
    n_layer, b, rows, t, h, hd = 4, 32, 2, 1500, 20, 64
    k8, v8 = (torch.randint(-127, 128, (n_layer, b, h, hd, t), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    vs = torch.rand(n_layer, b, h, generator=gen, device=dev) * 0.02
    qb = torch.randn(b, rows, h, hd, generator=gen, device=dev) * 0.01

    def run_a():
        return [encoder_attention(q, k, v) for _ in range(TWO_STREAM_A)]

    def run_b():
        return [da.decode_cross_attention_bf16(qb, k8, v8, i % n_layer, vs)
                for i in range(TWO_STREAM_B)]

    lone_a = encoder_attention(q, k, v)
    lone_b = [da.decode_cross_attention_bf16(qb, k8, v8, i, vs)
              for i in range(n_layer)]
    side = torch.cuda.Stream(device=dev)
    main = torch.cuda.current_stream(dev)
    walls = {}
    for label in ("A alone", "B alone", "together"):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(main)
        side.wait_event(start)
        outs_a = outs_b = []
        if label != "B alone":
            with torch.cuda.stream(side):
                outs_a = run_a()
        if label != "A alone":
            outs_b = run_b()
        main.wait_stream(side)
        end.record(main)
        end.synchronize()
        walls[label] = start.elapsed_time(end)
        if label == "together":
            same_a = all(torch.equal(o, lone_a) for o in outs_a)
            same_b = all(torch.equal(o, lone_b[i % n_layer])
                         for i, o in enumerate(outs_b))
    ref_a = attention(q, k, v).float()
    err_a = (lone_a.float() - ref_a).abs()
    tol_a = A_TOL_REL_MAX * ref_a.abs().max().item()
    err_b, tol_b = 0.0, 0.0
    for i in range(n_layer):
        r16 = da.decode_cross_attention_bf16_plain(qb, k8, v8, i, vs).float()
        err_b = max(err_b, (lone_b[i].float() - r16).abs().max().item())
        tol_b = max(tol_b, _bf16_step(r16))
    torch.cuda.synchronize()
    log(f"two streams: Kernel A (32,1500,20,64) x{TWO_STREAM_A} on a side "
        f"stream, Kernel B bf16 form (L=4, B=32, R=2, T=1500) "
        f"x{TWO_STREAM_B} on the main stream: A alone "
        f"{walls['A alone']:.4f} ms, B alone {walls['B alone']:.4f} ms, "
        f"together {walls['together']:.4f} ms (sum "
        f"{walls['A alone'] + walls['B alone']:.4f}); outputs equal to the "
        f"lone launches: A {same_a}, B {same_b}; against the plain "
        f"versions: A max_abs_err {err_a.max().item():.6g} (tol "
        f"{tol_a:.6g}) mean {err_a.mean().item():.6g} (tol {A_TOL_MEAN}), "
        f"B max_abs_err {err_b:.6g} (tol {tol_b:.6g})")
    if not (same_a and same_b):
        raise RuntimeError("two streams: a kernel's output on two streams "
                           "differs from its lone launch")
    if err_a.max().item() > tol_a or err_a.mean().item() > A_TOL_MEAN \
            or err_b > tol_b:
        raise RuntimeError("two streams: a kernel disagrees with its plain "
                           "version")
    del q, k, v, k8, v8, outs_a, outs_b, lone_a, lone_b, ref_a, err_a
    torch.cuda.empty_cache()


def check_bf16_cross_kv(dev) -> None:
    """One B=32 beam-2 first rung of the flagless turbo engine on cross
    K/V in bf16 (``DecodeOptions(cross_kv_int8=False)``, the JAX
    package's default) beside the int8 rung on the same encoder states:
    ms per step, the cross-K/V bytes of each, the tokens' agreement;
    Kernel B and the fused blocks never run on bf16 K/V."""
    import dataclasses
    from whisperjav_tpu_torch.models.whisper import model as tm
    from whisperjav_tpu_torch.pipelines.engine import to_host
    from whisperjav_tpu_torch.pipelines.factory import build_pipeline
    engine = build_pipeline(device=dev).engine   # flagless
    audio = np.stack([speech_like(28.0, s) for s in range(32)])
    audio = np.pad(audio, ((0, 0), (0, 480000 - audio.shape[1])))
    xa = engine.encode_batch(audio, max_duration=28.0)
    opts = engine.options
    out, walls = {}, {"int8": [], "bf16": []}
    try:
        for label in ("int8", "bf16", "bf16", "int8"):
            int8 = label == "int8"
            if label not in out:
                engine.options = dataclasses.replace(
                    opts, cross_kv_int8=int8, max_new_tokens=8)
                engine.decode_encoded(xa, 0.0, 0)      # warm-up
            engine.options = dataclasses.replace(opts, cross_kv_int8=int8)
            zero_launches()
            res, wall = _timed(lambda: to_host(engine.decode_encoded(
                xa, 0.0, 0)))
            launches = launch_counts()
            walls[label].append(wall)
            if label in out:
                if not np.array_equal(res.tokens, out[label].tokens):
                    raise RuntimeError(f"bf16 cross-K/V: the {label} rung's "
                                       "tokens differ between its turns")
                continue
            out[label] = res
            with torch.inference_mode():
                cross = tm.precompute_cross_kv(engine.model, xa[0],
                                               int8=int8)
                kv_bytes = sum(x.numel() * x.element_size()
                               for x in (cross.k, cross.v))
                del cross
            log(f"bf16 cross-K/V: turbo B=32 beam-2 rung on {label} K/V: "
                f"{int(np.max(res.length))} steps max; cross-K/V "
                f"{kv_bytes} bytes ({kv_bytes / 1e6:.1f} MB) at T="
                f"{xa.shape[1]}; Kernel B bf16 form "
                f"{launches['decode_cross_attention_bf16']}, fused blocks "
                f"{launches['cross_block']}")
            if not np.isfinite(res.avg_logprob).all():
                raise RuntimeError(f"bf16 cross-K/V: {label} rung: "
                                   "non-finite logprobs")
            if int8 != (launches["decode_cross_attention_bf16"] > 0) \
                    or launches["cross_block"]:
                raise RuntimeError(f"bf16 cross-K/V: {label} rung launched "
                                   f"{launches}")
    finally:
        engine.options = opts
    for label, ws in walls.items():
        steps = max(int(np.max(out[label].length)), 1)
        log(f"bf16 cross-K/V: {label} rung in turns (int8, bf16, bf16, "
            f"int8): walls {[round(w, 4) for w in ws]} s, "
            f"{statistics.median(ws) / steps * 1e3:.3f} ms/step")
    share = float(np.mean(out["bf16"].tokens == out["int8"].tokens))
    log(f"bf16 cross-K/V: {100 * share:.2f}% of the token slots agree with "
        "the int8 rung")
    del engine, xa
    torch.cuda.empty_cache()


def check_whisper_vad(dev) -> dict:
    """whisper-vad as ``create_segmenter("whisper-vad")`` builds it (model
    tiny, its own default engine: bf16, cross-K/V in the compute dtype),
    on the card and on the CPU from the same seeded weights (the
    factory's tiny init on the card, copied to the CPU) over a 30 s
    track: the speech probabilities within WVAD_TOL_P and the same
    segments; Kernel A runs in the card's encoder. Returns the card
    run's launches."""
    import copy
    from whisperjav_tpu_torch.modules.segmentation import create_segmenter
    from whisperjav_tpu_torch.pipelines import factory
    cfg, model = factory.load_model("tiny", device=dev)
    cpu_model = copy.deepcopy(model).to("cpu")
    orig = factory.load_model

    def load(name, checkpoint=None, device="cuda"):
        return cfg, cpu_model if torch.device(device).type == "cpu" \
            else model
    factory.load_model = load
    try:
        gpu, cpu = (create_segmenter("whisper-vad", device=d)
                    for d in (dev, "cpu"))
        audio = long_track(WVAD_TRACK_S, 14)
        gpu.window_speech_probs(audio[:5 * SR], SR)         # warm-up
        zero_launches()
        p_gpu, gpu_s = _timed(lambda: gpu.window_speech_probs(audio, SR))
        launches = launch_counts()
        t0 = time.perf_counter()
        p_cpu = cpu.window_speech_probs(audio, SR)
        cpu_s = time.perf_counter() - t0
        s_gpu, s_cpu = gpu.segment(audio, SR), cpu.segment(audio, SR)
    finally:
        factory.load_model = orig
    opts = gpu._engine.options
    err = float(np.abs(p_gpu - p_cpu).max())
    ns_rel = float(np.max(np.abs((1 - p_gpu) - (1 - p_cpu))
                          / np.maximum(1 - p_cpu, 1e-12)))
    same = [(s.start, s.end) for s in s_gpu.segments] == \
        [(s.start, s.end) for s in s_cpu.segments]
    log(f"whisper-vad (tiny, default engine: max_new_tokens "
        f"{opts.max_new_tokens}, int8 cross-K/V {opts.cross_kv_int8}, "
        f"{gpu._engine.compute_dtype}) on a {WVAD_TRACK_S:.0f} s track: "
        f"{len(p_gpu)} windows, card {gpu_s:.3f} s, CPU {cpu_s:.3f} s; "
        f"probabilities {np.round(p_gpu, 6).tolist()}; max |card - CPU| "
        f"{err:.3g} (tol {WVAD_TOL_P}); no-speech probabilities' largest "
        f"relative difference {ns_rel:.3g}; segments "
        f"{[(s.start, s.end) for s in s_gpu.segments]} (the same on both: "
        f"{same}); Kernel A {launches['encoder_attention']} launches, "
        f"Kernel B bf16 form {launches['decode_cross_attention_bf16']}")
    if opts.cross_kv_int8 or opts.cross_kv_int4:
        raise RuntimeError("whisper-vad: its engine quantises cross-K/V")
    if not err <= WVAD_TOL_P or not same:
        raise RuntimeError("whisper-vad: the card disagrees with the CPU")
    if launches["encoder_attention"] < 1:
        raise RuntimeError("whisper-vad: Kernel A never launched")
    del gpu, cpu, model, cpu_model
    torch.cuda.empty_cache()
    return launches


def run_ahead_phase(dev, gen) -> dict:
    """The engine's pipelining on the flagless turbo engine, Kernel A and
    Kernel B on two streams at once, bf16 cross-K/V at turbo width and
    whisper-vad at its default. Returns the launches of the pipelined
    engine run and of whisper-vad's card run."""
    launches = {"ahead_turbo": run_ahead_engine(dev)}
    check_two_streams(dev, gen)
    check_bf16_cross_kv(dev)
    launches["whisper_vad"] = check_whisper_vad(dev)
    return launches


# ---------------------------------------------------------------------------
# the switches phase: the JAX package's environment switches on the card
# ---------------------------------------------------------------------------

# new tokens of a timed Whisper rung (random weights end no row early)
SWITCHES_MAX_NEW = 64
# and of the large-v2 int8 rung, whose unfused layers are host-bound
SWITCHES_FUSE_MAX_NEW = 24
SWITCHES_VOCAB = "16384"
# the Qwen LM steps timed: the difference of two generates over their
# step difference
SWITCHES_QWEN_STEPS = (8, 40)
SWITCHES_ALIGN_CLIPS = 24
# the phase drives the large-v2 int8 engine, whose steps take every
# kernel
SWITCHES_NEEDS = INT8_NEEDS


@contextlib.contextmanager
def switch_env(name: str, value):
    """``name`` set to ``value`` (None: unset) inside the block."""
    import os
    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def _delta(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def _rung_turns(engine, xa, runs, max_new: int) -> dict:
    """Beam-2 rungs at T=0 of ``max_new`` tokens on ``xa``, one per
    (label, context) of ``runs`` in its order, after one warm-up each:
    per label the results, walls and launches."""
    import dataclasses
    from whisperjav_tpu_torch.pipelines.engine import to_host
    opts = engine.options
    engine.options = dataclasses.replace(opts, max_new_tokens=max_new)
    out = {}
    try:
        for label, ctx in runs:
            with ctx():
                if label not in out:
                    engine.decode_encoded(xa, 0.0, 0)    # warm-up
                before = launch_counts()
                res, wall = _timed(lambda: to_host(engine.decode_encoded(
                    xa, 0.0, 0)))
                launches = _delta(before)
            got = out.setdefault(label, {"res": res, "walls": [],
                                         "launches": launches})
            got["walls"].append(wall)
            if not np.array_equal(res.tokens, got["res"].tokens):
                raise RuntimeError(f"switches: {label} rung's tokens differ "
                                   "between its turns")
            if not np.isfinite(res.avg_logprob).all():
                raise RuntimeError(f"switches: {label} rung: non-finite "
                                   "logprobs")
    finally:
        engine.options = opts
    for got in out.values():
        got["ms"] = statistics.median(got["walls"]) / max(
            int(np.max(got["res"].length)), 1) * 1e3
    return out


def _agree(a, b) -> float:
    return float(np.mean(np.asarray(a.tokens) == np.asarray(b.tokens)))


def switch_beam_shared_cross(engine, xa) -> None:
    """``WJAV_BEAM_SHARED_CROSS=0`` on the flagless turbo engine: one B=32
    beam-2 rung on int8 cross-K/V, the shared layout (32 rows, the beams
    folded: Kernel B at R=2) and the repeat layout (64 rows, R=1) in
    turns; the repeat layout's cross-K/V must be twice the shared one's
    bytes, and Kernel B must launch in both."""
    from whisperjav_tpu_torch.models.whisper import decode as td
    real = td.precompute_cross_kv
    seen = []

    def spy(model, x, **kw):
        cross = real(model, x, **kw)
        seen.append((x.shape[0], sum(t.numel() * t.element_size()
                                     for t in (cross.k, cross.v,
                                               cross.k_scale,
                                               cross.v_scale)
                                     if t is not None)))
        return cross

    def shared():
        return switch_env("WJAV_BEAM_SHARED_CROSS", None)

    def repeat():
        return switch_env("WJAV_BEAM_SHARED_CROSS", "0")

    td.precompute_cross_kv = spy
    try:
        out = _rung_turns(engine, xa, [("shared", shared),
                                       ("repeat", repeat),
                                       ("repeat", repeat),
                                       ("shared", shared)],
                          SWITCHES_MAX_NEW)
    finally:
        td.precompute_cross_kv = real
    layouts = {}
    for rows, nbytes in seen:
        layouts.setdefault(rows, set()).add(nbytes)
    if sorted(layouts) != [32, 64] or any(len(v) != 1
                                          for v in layouts.values()):
        raise RuntimeError(f"switches: cross-K/V rows and bytes {seen}")
    shared_b, repeat_b = layouts[32].pop(), layouts[64].pop()
    for label, got in out.items():
        b = got["launches"]["decode_cross_attention_bf16"]
        log(f"switches WJAV_BEAM_SHARED_CROSS: turbo B=32 beam-2 rung, int8 "
            f"cross-K/V, {label} layout: {got['ms']:.3f} ms a step (walls "
            f"{[round(w, 4) for w in got['walls']]} s, in turns shared, "
            f"repeat, repeat, shared; {int(np.max(got['res'].length))} "
            f"steps); cross-K/V {shared_b if label == 'shared' else repeat_b}"
            f" bytes over {32 if label == 'shared' else 64} rows; Kernel B "
            f"(bf16 form) {b} launches at R={2 if label == 'shared' else 1}")
        if b < 1:
            raise RuntimeError(f"switches: Kernel B never launched on the "
                               f"{label} layout")
    log(f"switches WJAV_BEAM_SHARED_CROSS: {100 * _agree(out['repeat']['res'], out['shared']['res']):.2f}% "
        f"of the token slots agree; cross-K/V repeat / shared = "
        f"{repeat_b / shared_b:.4f}")
    if repeat_b != 2 * shared_b:
        raise RuntimeError(f"switches: repeat layout {repeat_b} bytes, not "
                           f"twice the shared {shared_b}")


def switch_vocab_slice(dev, engine, xa) -> None:
    """``WJAV_VOCAB_SLICE=<n>`` with no flag: the flagless factory slices
    the head to the synthetic subset; its B=32 beam-2 rung against the
    full head's on the same encoder states, in turns."""
    from whisperjav_tpu_torch.pipelines.factory import build_pipeline
    with switch_env("WJAV_VOCAB_SLICE", SWITCHES_VOCAB):
        sliced = build_pipeline(device=dev).engine
    n_sub = int(sliced.model.decoder.tok_emb.shape[0])
    if sliced._vocab is None or n_sub != int(SWITCHES_VOCAB) + \
            engine.config.n_vocab - engine.config.eot:
        raise RuntimeError(f"switches: WJAV_VOCAB_SLICE={SWITCHES_VOCAB} "
                           f"gave a head of {n_sub} rows")
    nothing = contextlib.nullcontext
    full = _rung_turns(engine, xa, [("full", nothing)], SWITCHES_MAX_NEW)
    part = _rung_turns(sliced, xa, [("sliced", nothing)], SWITCHES_MAX_NEW)
    full2 = _rung_turns(engine, xa, [("full", nothing)], SWITCHES_MAX_NEW)
    part2 = _rung_turns(sliced, xa, [("sliced", nothing)], SWITCHES_MAX_NEW)
    ms_full = statistics.median([full["full"]["ms"], full2["full"]["ms"]])
    ms_part = statistics.median([part["sliced"]["ms"],
                                 part2["sliced"]["ms"]])
    log(f"switches WJAV_VOCAB_SLICE={SWITCHES_VOCAB}: head {n_sub} of "
        f"{engine.config.n_vocab} rows; turbo B=32 beam-2 rung "
        f"{ms_part:.3f} ms a step against the full head's {ms_full:.3f} "
        f"(in turns full, sliced, full, sliced: "
        f"{[round(r, 3) for r in (full['full']['ms'], part['sliced']['ms'], full2['full']['ms'], part2['sliced']['ms'])]}); "
        f"{100 * _agree(part['sliced']['res'], full['full']['res']):.2f}% "
        "of the token slots agree")
    del sliced


def switch_fuse_qkv(dev) -> None:
    """``WJAV_FUSE_QKV=0`` on the large-v2 ``--int8-weights`` engine (the
    factory's, B=32, beam 2, int8 cross-K/V): one batch of 28 s windows,
    one rung fused and one apart; the fused blocks must launch only when
    q/k/v are fused."""
    from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
    from whisperjav_tpu_torch.pipelines.factory import build_pipeline
    audio = np.stack([speech_like(28.0, s) for s in range(32)])
    audio = np.pad(audio, ((0, 0), (0, 480000 - audio.shape[1])))
    out = {}
    for label, value in (("fused", None), ("apart", "0")):
        cfg = resolve_pipeline_config(model="large-v2")
        cfg.int8_weights = True
        torch.cuda.empty_cache()
        with switch_env("WJAV_FUSE_QKV", value):
            engine = build_pipeline(cfg, device=dev).engine
        blocks = engine.model.decoder.blocks
        if ("wqkv" in blocks) != (value is None):
            raise RuntimeError(f"switches: WJAV_FUSE_QKV={value}: decoder "
                               f"weights {sorted(blocks.keys())}")
        xa = engine.encode_batch(audio, max_duration=28.0)
        got = _rung_turns(engine, xa, [(label, contextlib.nullcontext)],
                          SWITCHES_FUSE_MAX_NEW)[label]
        out[label] = got
        fused = got["launches"]["self_block"]
        log(f"switches WJAV_FUSE_QKV={value or 'unset'}: large-v2 int8 "
            f"weights, B=32 beam-2 rung, {SWITCHES_FUSE_MAX_NEW} tokens: "
            f"{got['ms']:.3f} ms a step; fused blocks {fused} self / "
            f"{got['launches']['cross_block']} cross / "
            f"{got['launches']['mlp_block']} MLP, Kernel B (bf16 form) "
            f"{got['launches']['decode_cross_attention_bf16']}")
        if (fused > 0) != (value is None) or (value is not None and (
                got["launches"]["cross_block"]
                or got["launches"]["mlp_block"])):
            raise RuntimeError(f"switches: WJAV_FUSE_QKV={value}: launches "
                               f"{got['launches']}")
        del engine, xa, blocks
    log(f"switches WJAV_FUSE_QKV: apart / fused = "
        f"{out['apart']['ms'] / out['fused']['ms']:.3f}x a step; "
        f"{100 * _agree(out['apart']['res'], out['fused']['res']):.2f}% of "
        "the token slots agree")
    torch.cuda.empty_cache()


def switch_qwen_int8(dev) -> None:
    """``WJAV_QWEN_INT8=0``: the Qwen3-ASR-1.7B generator's LM as loaded
    (f32 from the random init, as the JAX generator's) against its int8
    default, one B=32 batch of 8 s clips: ms a generate step (the
    difference of SWITCHES_QWEN_STEPS), the LM bytes a step reads, peak
    memory and the ids' agreement."""
    from whisperjav_tpu_torch.models.qwen import model as qm
    from whisperjav_tpu_torch.modules.subtitle_pipeline.components import (
        QwenGenerator,
    )
    from whisperjav_tpu_torch.ops.mel import log_mel_spectrogram
    audio = np.zeros((32, 8 * SR), np.float32)
    for r in range(32):
        n = int((5.0 + 0.09 * r) * SR)
        audio[r, :n] = speech_like(8.0, r)[:n]
    lo, hi = SWITCHES_QWEN_STEPS
    out = {}
    for label, value in (("int8", None), ("float", "0")):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with switch_env("WJAV_QWEN_INT8", value):
            gen = QwenGenerator("qwen3-asr-1.7b", batch_size=32, device=dev)
            gen.load()
        model, cfg = gen._params, gen.cfg
        if ("lm_head_q" in model) != (value is None):
            raise RuntimeError(f"switches: WJAV_QWEN_INT8={value}: lm head "
                               "not as asked")
        mel = log_mel_spectrogram(torch.from_numpy(audio).to(dev),
                                  n_mels=cfg.n_mels)
        audio_len = cfg.audio_tokens_for(mel.shape[-1])
        qm.generate(model, mel, 4, audio_len)                  # warm-up
        walls = {lo: [], hi: []}
        for steps in (lo, hi, hi, lo):
            res, wall = _timed(lambda: qm.generate(model, mel, steps,
                                                   audio_len))
            walls[steps].append(wall)
        ms = (statistics.median(walls[hi]) - statistics.median(walls[lo])) \
            / (hi - lo) * 1e3
        nbytes = _lm_bytes(model) + sum(
            b.numel() * b.element_size() for n, b in model.named_buffers()
            if n.startswith("blocks.") or n.startswith("lm_head"))
        peak = torch.cuda.max_memory_allocated()
        out[label] = (ms, res.tokens.cpu().numpy())
        log(f"switches WJAV_QWEN_INT8={value or 'unset'}: qwen3-asr-1.7b "
            f"generate B=32, 8 s clips, {label} LM: {ms:.3f} ms a step "
            f"(walls {json.dumps({k: [round(w, 4) for w in v] for k, v in walls.items()})} s "
            f"for {lo} and {hi} steps); LM weights a step reads {nbytes} "
            f"bytes ({nbytes / 1e9:.3f} GB); peak device memory {peak} "
            f"bytes ({peak / 2**30:.3f} GiB)")
        del gen, model, mel
    share = float(np.mean(out["float"][1] == out["int8"][1]))
    log(f"switches WJAV_QWEN_INT8: float / int8 = "
        f"{out['float'][0] / out['int8'][0]:.3f}x a step; {100 * share:.2f}% "
        f"of the {hi} generated id slots agree")
    torch.cuda.empty_cache()


def switch_align_device(dev) -> None:
    """``WJAV_ALIGN_DEVICE=0``: the forced aligner's adapter (seeded
    weights on the card) on SWITCHES_ALIGN_CLIPS clips of 1.5-7 s with
    kana texts, the device path and the host path in turns: the spans
    must be equal; both walls."""
    from whisperjav_tpu_torch.modules.subtitle_pipeline.components import (
        QwenAlignerAdapter,
    )
    rng = np.random.default_rng(9)
    kana = [chr(c) for c in range(0x3042, 0x3094)]
    clips, texts = [], []
    for i in range(SWITCHES_ALIGN_CLIPS):
        secs = float(rng.uniform(1.5, 7.0))
        clips.append(speech_like(secs, 40 + i))
        texts.append("".join(rng.choice(kana, int(secs * 8))))
    adapter = QwenAlignerAdapter(device=dev)
    adapter.load()
    spans, walls = {}, {"device": [], "host": []}
    for label in ("device", "host", "host", "device"):
        with switch_env("WJAV_ALIGN_DEVICE", None if label == "device"
                        else "0"):
            if label not in spans:
                adapter.align_batch(clips, SR, texts)          # warm-up
            res, wall = _timed(lambda: adapter.align_batch(clips, SR,
                                                           texts))
        walls[label].append(wall)
        spans.setdefault(label, [[(w.word, w.start, w.end) for w in r.words]
                                 for r in res])
    words = sum(len(r) for r in spans["device"])
    same = spans["device"] == spans["host"]
    differ = sum(a != b for ra, rb in zip(spans["device"], spans["host"])
                 for a, b in zip(ra, rb))
    log(f"switches WJAV_ALIGN_DEVICE: {SWITCHES_ALIGN_CLIPS} clips, "
        f"{words} words; device path walls "
        f"{[round(w, 4) for w in walls['device']]} s, host path "
        f"{[round(w, 4) for w in walls['host']]} s (in turns device, host, "
        f"host, device); spans equal: {same} ({differ} words differ)")
    adapter.unload()
    if not same:
        raise RuntimeError("switches: the aligner's host path gives other "
                           "spans than its device path")


def switch_pool_scenes(dev, tmp: Path) -> None:
    """``WJAV_POOL_SCENES=0``: the qwen mode's pipeline as the CLI builds
    it (Qwen3-ASR-1.7B, the aligner, seeded) on its ~60 s clip, pooled
    (the default) and then scene by scene; both SRTs must parse with
    every cue inside the clip and the same scenes; whether they are
    equal is logged (their batches differ, so their rounding may);
    both walls."""
    from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
    from whisperjav_tpu_torch.modules.media_discovery import probe
    from whisperjav_tpu_torch.pipelines.qwen_factory import (
        build_qwen_pipeline,
    )
    wav = tmp / "switches-qwen.wav"
    duration = synthetic_clip(wav, QWEN_CLIP_S)
    pipeline = build_qwen_pipeline(resolve_pipeline_config(mode="qwen"),
                                   device=dev)
    runs = {}
    for label, value in (("pooled", None), ("per-scene", "0")):
        out = tmp / f"switches-{label}"
        with switch_env("WJAV_POOL_SCENES", value):
            result, wall = _timed(lambda: pipeline.process(probe(wav), out))
        srt = result.srt_path.read_text(encoding="utf-8")
        cues = srt_cues(result.srt_path)
        scenes = result.metadata["scenes"]
        for start, end in cues:
            if not 0.0 <= start <= end <= duration + 1.0:
                raise RuntimeError(f"switches: {label} cue outside the "
                                   f"clip: {start}-{end}")
        runs[label] = (srt, wall, len(cues), scenes,
                       result.metadata["stats"]["stage_s"])
    (a, wa, na, sa, ga), (b, wb, nb, sb, gb) = runs["pooled"], \
        runs["per-scene"]
    log(f"switches WJAV_POOL_SCENES: qwen pipeline on {duration:.3f} s, "
        f"{sa} scenes: pooled {wa:.3f} s ({na} cues; generate "
        f"{ga.get('generate')} s, align {ga.get('align')} s), scene by "
        f"scene {wb:.3f} s ({nb} cues; generate {gb.get('generate')} s, "
        f"align {gb.get('align')} s); SRTs equal: {a == b}")
    if sa != sb or sa < 2:
        raise RuntimeError(f"switches: scenes {sa} pooled, {sb} scene by "
                           "scene")
    del pipeline
    torch.cuda.empty_cache()


def run_switches_phase(dev, tmp: Path) -> dict:
    """Each of the JAX package's switches on the card against its
    default, on paths that exist at full width; every kernel's launches
    counted over the phase."""
    from whisperjav_tpu_torch.pipelines.factory import build_pipeline
    torch.cuda.synchronize()
    zero_launches()
    engine = build_pipeline(device=dev).engine   # flagless turbo
    audio = np.stack([speech_like(28.0, s) for s in range(32)])
    audio = np.pad(audio, ((0, 0), (0, 480000 - audio.shape[1])))
    xa = engine.encode_batch(audio, max_duration=28.0)
    switch_beam_shared_cross(engine, xa)
    switch_vocab_slice(dev, engine, xa)
    del engine, xa
    torch.cuda.empty_cache()
    switch_fuse_qkv(dev)
    switch_qwen_int8(dev)
    switch_align_device(dev)
    switch_pool_scenes(dev, tmp)
    torch.cuda.synchronize()
    launches = launch_counts()
    missing = [name for name in SWITCHES_NEEDS if launches[name] < 1]
    if missing:
        raise RuntimeError(f"switches: kernels never launched: {missing}")
    log(f"switches phase launches {json.dumps(launches)}")
    return launches


PHASES = ("kernels", "reference", "turbo", "large-v2", "fidelity", "qwen",
          "vad", "serve", "enhance", "train", "multihost", "ensemble",
          "async", "translate", "tools", "gui", "devices", "ahead", "switches")


# the phases whose paths run with the temperature ladder cut to its first
# rungs (WJAV_LADDER_RUNGS): random weights fail every quality gate, so
# every file would run the whole deferred ladder, each rung a best-of-2
# retry of 224 host-bound steps a row (4-6 s a file on a slow host). The
# serve, ensemble, async and tools phases keep one sampled rung, so the
# deferred pool still gathers rows across requests and files and
# determinism_suite still holds a sampled rung; the others, whose own
# path is not the ladder's, keep the first rung only. The turbo,
# large-v2 and devices phases run the whole ladder, the ahead phase
# sets its own and the switches phase drives single rungs.
LADDER_CUT = {"fidelity": "1", "vad": "1", "serve": "2", "enhance": "1",
              "train": "1", "multihost": "1", "ensemble": "2", "async": "2",
              "tools": "2", "gui": "1"}


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    with switch_env("WJAV_LADDER_RUNGS", LADDER_CUT[name]) \
            if name in LADDER_CUT else contextlib.nullcontext():
        yield
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")


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
    # each kernel file in its own nvcc process, all started together
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
        with phase("kernels"):
            kernels = [check_encoder_attention(dev, gen),
                       check_decode_attention(dev, gen),
                       *check_fused_blocks(dev, gen)]
            torch.cuda.empty_cache()
    if "reference" in only:
        with phase("reference"):
            check_small_reference(dev)
            check_small_int8_reference(dev)
            check_small_vocab_reference(dev)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        if "turbo" in only:
            with phase("turbo"):
                launches["turbo_flagless"] = run_cli_path(
                    Path(tmp), "turbo flagless", TURBO_CLIP_S, [],
                    TURBO_NEEDS)[0]
                torch.cuda.empty_cache()
                breakdown(dev)
                torch.cuda.empty_cache()
        if "large-v2" in only:
            with phase("large-v2"):
                launches["large_v2_int8"] = run_cli_path(
                    Path(tmp), "large-v2 int8", INT8_CLIP_S,
                    ["--model", "large-v2", "--int8-weights"],
                    INT8_NEEDS)[0]
                torch.cuda.empty_cache()
                breakdown_large_v2_greedy(dev)
                torch.cuda.empty_cache()
        if "fidelity" in only:
            with phase("fidelity"):
                check_zipenhancer(dev)
                launches.update(run_fidelity_paths(Path(tmp)))
        if "qwen" in only:
            with phase("qwen"):
                check_small_qwen_reference(dev)
                kernels.append(check_qwen_column_attention(dev, gen))
                launches["qwen"] = run_qwen_cli_path(
                    Path(tmp), "qwen", ["--no-signature"], QWEN_NEEDS)
                torch.cuda.empty_cache()
                qwen_costs(dev)
                launches["qwen_anime_whisper"] = run_qwen_cli_path(
                    Path(tmp), "qwen anime-whisper",
                    ["--generator", "anime-whisper", "--model", "small",
                     "--no-signature"],
                    QWEN_WHISPER_NEEDS)
                torch.cuda.empty_cache()
        if "vad" in only:
            with phase("vad"):
                launches.update(run_vad_phase(dev, gen, Path(tmp), kernels))
        if "serve" in only:
            with phase("serve"):
                launches["serve"] = run_serve_phase(dev, Path(tmp))
        if "enhance" in only:
            with phase("enhance"):
                launches.update(run_enhance_phase(dev, Path(tmp)))
        if "train" in only:
            with phase("train"):
                one_card = check_train_parity(dev)
                launches["finetuned_turbo"] = run_finetune(dev, Path(tmp))
                run_train_nccl(Path(tmp), one_card)
        if "multihost" in only:
            with phase("multihost"):
                run_multihost_phase(Path(tmp))
        if "ensemble" in only:
            with phase("ensemble"):
                launches["ensemble"] = run_ensemble_phase(Path(tmp))
        srt = None
        if "async" in only:
            with phase("async"):
                launches["async"], srt = run_async_phase(Path(tmp))
        if "translate" in only:
            with phase("translate"):
                if srt is None:
                    srt = Path(tmp) / "translate-source.ja.whisperjav.srt"
                    synthetic_srt(srt)
                run_translate_phase(dev, Path(tmp), srt)
        if "tools" in only:
            with phase("tools"):
                launches["tools"] = run_tools_phase(Path(tmp))
        if "gui" in only:
            with phase("gui"):
                launches["gui"] = run_gui_phase(dev, Path(tmp))
        if "devices" in only:
            with phase("devices"):
                launches["devices"] = run_devices_phase(Path(tmp))
        if "ahead" in only:
            with phase("ahead"):
                launches.update(run_ahead_phase(dev, gen))
        if "switches" in only:
            with phase("switches"):
                launches["switches"] = run_switches_phase(dev, Path(tmp))
    if only != set(PHASES):
        log(f"partial run ({sorted(only)}): no result line")
        return 3

    for k in kernels:
        names = RECORD_COUNTERS.get(k["name"], (k["name"],))
        by_path = {path: sum(counts[n] for n in names)
                   for path, counts in launches.items()}
        k["launches"] = by_path["large_v2_int8"]
        k["launches_by_path"] = by_path
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
