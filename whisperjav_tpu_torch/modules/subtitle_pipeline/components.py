"""Concrete framers / generators / cleaners / aligners + factories.

The port's copy of ``whisperjav_tpu/modules/subtitle_pipeline/
components.py``: the Qwen generator and the forced-aligner adapter run
the port's models on ``device`` (default ``cuda``), the Whisper
generator the port's engine.

Parity targets in the reference tree:
- framers: vad-grouped / full-scene / manual / srt-source
  (whisperjav/modules/subtitle_pipeline/framers/, factory.py)
- generators: qwen3 text-only, whisper-based (the reference's
  anime-whisper is a Whisper fine-tune consumed the same way —
  generators/anime_whisper.py:1-26)
- cleaners: assembly text cleaner run BEFORE alignment, preserving
  punctuation for the aligner (modules/assembly_text_cleaner.py:1-11);
  passthrough
- aligners: qwen3 ForcedAligner adapter (aligners/qwen3.py:19), none
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from whisperjav_tpu_torch.modules.subtitle_pipeline.types import (
    AlignmentResult, FramingResult, TemporalFrame, TranscriptionResult,
    WordTimestamp,
)
from whisperjav_tpu_torch.utils import tracer
from whisperjav_tpu_torch.utils.logger import logger


# ---------------------------------------------------------------------------
# framers
# ---------------------------------------------------------------------------

class VadGroupedFramer:
    """Frames = VAD groups; raw speech regions kept for sentinel recovery."""

    name = "vad-grouped"

    def __init__(self, vad_backend: str = "silero", device="cuda",
                 **vad_kwargs):
        self.vad_backend = vad_backend
        self.device = device            # of a network segmenter
        self.vad_kwargs = vad_kwargs

    def frame(self, audio: np.ndarray, sample_rate: int,
              max_group_s: float) -> FramingResult:
        from whisperjav_tpu_torch.modules.segmentation import create_segmenter
        seg = create_segmenter(self.vad_backend, device=self.device,
                               max_group_duration_s=max_group_s,
                               **self.vad_kwargs).segment(audio, sample_rate)
        frames = [
            TemporalFrame(i, g.start, g.end,
                          [(s.start - g.start, s.end - g.start)
                           for s in g.segments])
            for i, g in enumerate(seg.groups)
        ]
        return FramingResult(frames, self.name,
                             len(audio) / sample_rate,
                             [(s.start, s.end) for s in seg.segments])


class FullSceneFramer:
    name = "full-scene"

    def frame(self, audio, sample_rate, max_group_s) -> FramingResult:
        dur = len(audio) / sample_rate
        n = max(1, int(np.ceil(dur / max_group_s)))
        step = dur / n
        frames = [TemporalFrame(i, i * step, min((i + 1) * step, dur))
                  for i in range(n)]
        return FramingResult(frames, self.name, dur)


class ManualFramer:
    name = "manual"

    def __init__(self, boundaries: Sequence[Tuple[float, float]]):
        self.boundaries = list(boundaries)

    def frame(self, audio, sample_rate, max_group_s) -> FramingResult:
        dur = len(audio) / sample_rate
        frames = [TemporalFrame(i, max(a, 0.0), min(b, dur))
                  for i, (a, b) in enumerate(self.boundaries)]
        return FramingResult(frames, self.name, dur)


class SrtSourceFramer:
    """Frames from an existing SRT's cue times (re-alignment workflows)."""

    name = "srt-source"

    def __init__(self, srt_path: str):
        self.srt_path = srt_path

    def frame(self, audio, sample_rate, max_group_s) -> FramingResult:
        from whisperjav_tpu_torch.modules.srt import load_srt
        dur = len(audio) / sample_rate
        subs = load_srt(self.srt_path)
        frames = [TemporalFrame(i, max(s.start, 0.0), min(s.end, dur))
                  for i, s in enumerate(subs) if s.start < dur]
        return FramingResult(frames, self.name, dur)


def create_framer(backend: str = "vad-grouped", **kwargs):
    b = (backend or "vad-grouped").lower()
    if b in ("vad-grouped", "vad"):
        return VadGroupedFramer(**kwargs)
    if b in ("full-scene", "full"):
        return FullSceneFramer()
    if b == "manual":
        return ManualFramer(**kwargs)
    if b in ("srt-source", "srt"):
        return SrtSourceFramer(**kwargs)
    logger.warning("unknown framer %r; using vad-grouped", backend)
    return VadGroupedFramer()


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

def prepare_params(params):
    """The generator's post-load step on a :class:`QwenASR`, in place, as
    the JAX generator's ``load``: one fused q/k/v matmul per LM layer per
    step (``WJAV_FUSE_QKV=0``: three), then int8 LM matmuls and head,
    which halve the weights every step reads (``WJAV_QWEN_INT8=0``: the
    LM stays as loaded). Each switch is read when this runs; a tree
    already fused and quantised comes back as it is."""
    from whisperjav_tpu_torch.models.qwen.model import (
        fuse_lm_qkv, quantize_lm_weights,
    )
    if os.environ.get("WJAV_FUSE_QKV", "1") != "0":
        params = fuse_lm_qkv(params)
    if os.environ.get("WJAV_QWEN_INT8", "1") != "0":
        params = quantize_lm_weights(params)
    return params


class QwenGenerator:
    """Qwen3-ASR text-only generation (reference: generators/qwen3) on
    ``device``. ``params`` (a :class:`QwenASR`) are used as given, as the
    JAX generator uses them; else a checkpoint is loaded, or the named
    size is drawn at random from a generator seeded 0 on the device, and
    put through :func:`prepare_params`."""

    name = "qwen3"

    def __init__(self, model_size: str = "qwen3-asr-test",
                 params=None, tokenizer=None, batch_size: int = 4,
                 repetition_penalty: float = 1.1,
                 checkpoint: Optional[str] = None,
                 context: Optional[str] = None,
                 max_tokens: Optional[int] = None,
                 max_tokens_per_second: Optional[float] = None,
                 device="cuda"):
        from whisperjav_tpu_torch.models.qwen.model import QWEN_SIZES
        from whisperjav_tpu_torch.pipelines.engine import resolve_device
        self.cfg = QWEN_SIZES[model_size]
        self.device = resolve_device(device)
        self._params = params
        self.checkpoint = checkpoint
        self.tokenizer = tokenizer
        if tokenizer is None and checkpoint is not None:
            from whisperjav_tpu_torch.models.qwen.tokenizer import (
                QwenTokenizer, find_tokenizer_files,
            )
            src = find_tokenizer_files(checkpoint)
            if src is not None:
                self.tokenizer = QwenTokenizer(src)
        self.batch_size = batch_size
        self.repetition_penalty = repetition_penalty
        # contextual biasing + token budgets (reference: main.py:676-681
        # --context/--context-file; main.py:591-596 --qwen-max-tokens /
        # --qwen-max-tokens-per-second with 0 = disabled)
        self.context = context
        self.max_tokens = max_tokens
        self.max_tokens_per_second = max_tokens_per_second
        self.recorder: Optional[tracer.SpanRecorder] = None
        self._ctx_ids: Optional[np.ndarray] = None
        if context and self.tokenizer is not None:
            ids = self.tokenizer.encode(context)
            if ids:
                self._ctx_ids = np.asarray(ids, np.int32)[None, :]
        elif context:
            logger.warning("qwen generator: --context given but no "
                           "tokenizer available; context ignored")

    def load(self) -> None:
        if self._params is not None:
            self._params = self._params.to(self.device)
            return
        if self.checkpoint is not None:
            from whisperjav_tpu_torch.models.qwen.convert import (
                load_pretrained,
            )
            from whisperjav_tpu_torch.models.qwen.weights import (
                params_from_jax,
            )
            self.cfg, tree = load_pretrained(self.checkpoint)
            params = params_from_jax(tree, self.cfg, device=self.device)
            logger.info("qwen generator: loaded %s from %s",
                        self.cfg.name, self.checkpoint)
        else:
            from whisperjav_tpu_torch.models.qwen.weights import init_params
            logger.warning("qwen generator: random-init %s weights",
                           self.cfg.name)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            params = init_params(self.cfg, gen, device=self.device)
        self._params = prepare_params(params)

    def unload(self) -> None:
        self._params = None

    def _decode_text(self, ids: np.ndarray, length: int) -> str:
        ids = [int(t) for t in ids[:length]]
        if self.tokenizer is not None:
            return self.tokenizer.decode(ids)
        kana = ("あいうえおかきくけこさしすせそたちつてとなにぬねのはひふへほ"
                "まみむめもやゆよらりるれろわをん")
        return "".join(kana[i % len(kana)] for i in ids)

    def budget(self, seconds: float) -> int:
        """New-token budget for clips padded to ``seconds``."""
        from whisperjav_tpu_torch.models.qwen.model import token_budget
        tps = self.max_tokens_per_second
        if tps is not None and tps > 0:
            budget = max(self.cfg.min_token_budget, int(seconds * tps))
        elif tps is not None:   # 0 = dynamic budget disabled
            budget = self.max_tokens or self.cfg.min_token_budget * 8
        else:
            budget = token_budget(self.cfg, seconds)
        if self.max_tokens is not None:
            budget = min(budget, self.max_tokens)
        return budget

    def generate_batch(self, clips, sample_rate) -> List[TranscriptionResult]:
        """Every clip padded to the longest, rounded up to whole AuT
        attention windows (``mel_multiple`` mel frames x 160 samples, 4 s
        by default), in batches of ``batch_size`` rows (the last one
        padded with silent rows).

        Generate-ahead, as the JAX generator: batch i+1's ``generate``
        runs before batch i's tokens are drained to the host and
        detokenised (``WJAV_GENERATE_AHEAD=0`` drains each batch at
        once). It keeps two batches' LM caches resident, so it turns off,
        with a warning, where the JAX package's estimate of the pair
        exceeds ``WJAV_GENERATE_AHEAD_GB`` (default 6, the JAX package's
        value).

        ``WJAV_TRACE_BATCHES=1``: each call records its spans
        (``self.recorder``, ``tracer.latest()``): one ``qwen.batch`` a
        batch (counters ``rows``, the clips in it, ``audio_tokens``, the
        prefix positions a row, and ``budget``) over ``qwen.mel``,
        :func:`generate`'s stages and ``qwen.drain``."""
        from whisperjav_tpu_torch.models.qwen.model import generate
        from whisperjav_tpu_torch.ops.mel import log_mel_spectrogram
        assert self._params is not None, "call load() first"
        out: List[TranscriptionResult] = []
        max_len = max((len(c) for c in clips), default=0)
        unit = self.cfg.mel_multiple * 160
        max_len = ((max_len + unit - 1) // unit) * unit or unit
        budget = self.budget(max_len / sample_rate)
        ctx = (torch.from_numpy(self._ctx_ids).to(self.device)
               if self._ctx_ids is not None else None)
        ahead_on = os.environ.get("WJAV_GENERATE_AHEAD", "1") != "0"
        cfg = self.cfg
        t_max = (cfg.audio_tokens_for(
            ((max_len // 160 + cfg.mel_multiple - 1) // cfg.mel_multiple)
            * cfg.mel_multiple) + budget + 64)
        kv_d = cfg.n_kv_heads * cfg.head_dim
        pair_cache_gb = (2 * 2 * 2 * cfg.n_layers * self.batch_size
                         * t_max * kv_d) / 1e9   # 2 inflight × k+v × bf16
        limit_gb = float(os.environ.get("WJAV_GENERATE_AHEAD_GB", "6"))
        if ahead_on and pair_cache_gb > limit_gb:
            logger.warning(
                "generate-ahead disabled: two in-flight LM caches ≈ "
                "%.1f GB > %.1f GB budget (batch %d, t_max %d); serial "
                "drains (override with WJAV_GENERATE_AHEAD_GB)",
                pair_cache_gb, limit_gb, self.batch_size, t_max)
            ahead_on = False

        rec = self.recorder = (
            tracer.SpanRecorder()
            if os.environ.get("WJAV_TRACE_BATCHES", "0") != "0" else None)

        def drain(start: int, n: int, res, root) -> None:
            with tracer.span(root, "qwen.drain"):
                toks = res.tokens.cpu().numpy()
                lens = res.length.cpu().numpy()
                lps = res.avg_logprob.cpu().numpy()
                for r in range(n):
                    out.append(TranscriptionResult(
                        frame_index=start + r,
                        text=self._decode_text(toks[r], int(lens[r])),
                        avg_logprob=float(lps[r])))
            if root is not None:
                root.close()

        pending = None
        for i in range(0, len(clips), self.batch_size):
            chunk = clips[i:i + self.batch_size]
            root = tracer.child(rec, "qwen.batch", i // self.batch_size)
            with tracer.span(root, "qwen.mel"):
                buf = np.zeros((self.batch_size, max_len), np.float32)
                for r, c in enumerate(chunk):
                    buf[r, :len(c)] = c
                mel = log_mel_spectrogram(
                    torch.from_numpy(buf).to(self.device),
                    n_mels=self.cfg.n_mels)
            audio_len = self.cfg.audio_tokens_for(mel.shape[-1])
            if root is not None:
                root.counters.update(rows=len(chunk), audio_tokens=audio_len,
                                     budget=budget)
            with tracer.within(root):
                res = generate(self._params, mel, max_new=budget,
                               audio_len=audio_len,
                               repetition_penalty=self.repetition_penalty,
                               ctx_ids=ctx)
            if pending is not None:
                drain(*pending)
                pending = None
            if ahead_on:
                pending = (i, len(chunk), res, root)
            else:
                drain(i, len(chunk), res, root)
        if pending is not None:
            drain(*pending)
        return out


class WhisperGenerator:
    """Whisper-as-generator (covers the reference's anime-whisper slot:
    a Whisper fine-tune decoded greedily without prompts), on the port's
    engine (``pipelines.factory.build_engine``)."""

    name = "whisper"

    def __init__(self, engine=None):
        self.engine = engine   # a TranscriptionEngine

    def load(self) -> None:
        assert self.engine is not None, "WhisperGenerator needs an engine"

    def unload(self) -> None:
        pass

    def generate_batch(self, clips, sample_rate) -> List[TranscriptionResult]:
        from whisperjav_tpu_torch.parallel.batching import Window
        windows = [Window(np.asarray(c, np.float32), 0.0,
                          len(c) / sample_rate, scene_idx=0, group_idx=i)
                   for i, c in enumerate(clips)]
        results = self.engine.transcribe_windows(windows)
        out = []
        for w, segs in results:
            text = "".join(s.text for s in segs)
            lp = float(np.mean([s.avg_logprob for s in segs])) if segs else 0.0
            out.append(TranscriptionResult(w.group_idx, text, lp))
        out.sort(key=lambda r: r.frame_index)
        return out


class CohereStyleGenerator:
    """Experimental LALM text generator filling the reference's ``cohere``
    slot (reference: subtitle_pipeline/generators/cohere.py:60-725 — a
    gated HF audio-language model used text-only, with chunked long-audio
    reassembly and no native word timestamps).

    Design: the vendor model's graph ships as
    trust_remote_code Python inside a gated HF repo, which a hermetic
    zero-egress build can neither fetch nor execute — so the ROLE, an
    experimental audio-LM that emits punctuated text with no timing
    signal and relies on the downstream ForcedAligner, is filled by the
    in-tree Qwen audio-LM under the reference's behavioral contract:

    - text-only output; ``context`` is IGNORED with a debug note
      (reference cohere.py:617-621 — "Cohere does not accept initial
      prompts the way Whisper does")
    - deterministic greedy decode (the reference pins do_sample=False,
      num_beams=1 "for determinism ... guards against generation_config
      drift", cohere.py:652-661) — repetition_penalty 1.0, temperature 0
    - clips longer than ``chunk_s`` decode as overlapped chunks whose
      texts are reassembled by longest suffix/prefix overlap — the role
      of the processor's ``audio_chunk_index`` reassembly
      (cohere.py:597-600; it is a chunking index, NOT a timing signal)
    - load() failures raise one actionable diagnostic built by walking
      the exception chain (cohere.py:174-195 _walk_chain /
      _classify_error) instead of a bare stack trace
    """

    name = "cohere"

    def __init__(self, model_size: str = "qwen3-asr-test",
                 checkpoint: Optional[str] = None, batch_size: int = 4,
                 max_new_tokens: int = 512,
                 chunk_s: float = 30.0, overlap_s: float = 4.0,
                 language: str = "ja", device="cuda", **_ignored):
        if not chunk_s > 0:
            raise ValueError(f"cohere generator: chunk_s must be > 0 "
                             f"(got {chunk_s})")
        if overlap_s < 0 or overlap_s >= chunk_s:
            # hop = chunk - overlap drives the chunking loop; a
            # non-positive hop would never advance (unbounded append)
            raise ValueError(
                f"cohere generator: overlap_s ({overlap_s}) must be in "
                f"[0, chunk_s) — chunk_s is {chunk_s}")
        if _ignored:
            logger.warning(
                "cohere generator: ignoring unsupported generator-config "
                "key(s): %s", ", ".join(sorted(_ignored)))
        self.chunk_s = chunk_s
        self.overlap_s = overlap_s
        self.language = language
        self._inner = QwenGenerator(
            model_size=model_size, checkpoint=checkpoint,
            batch_size=batch_size, repetition_penalty=1.0,
            max_tokens=max_new_tokens, device=device)

    @property
    def is_loaded(self) -> bool:
        return self._inner._params is not None

    @staticmethod
    def _walk_chain(exc: BaseException, max_depth: int = 8):
        chain, seen, cur = [exc], {id(exc)}, exc
        for _ in range(max_depth):
            nxt = cur.__cause__ or cur.__context__
            if nxt is None or id(nxt) in seen:
                break
            chain.append(nxt)
            seen.add(id(nxt))
            cur = nxt
        return chain

    @classmethod
    def _format_load_error(cls, exc: Exception, checkpoint) -> str:
        msgs = [str(e) for e in cls._walk_chain(exc)]
        text = " ".join(msgs).lower()
        if any(t in text for t in ("no space left", "errno 28",
                                   "not enough space", "disk full")):
            hint = ("disk ran out of space while reading the checkpoint; "
                    "free space on the volume holding it and retry")
        elif any(t in text for t in ("no such file", "not found",
                                     "missing", "does not exist")):
            hint = (f"checkpoint files are missing under {checkpoint!r} "
                    "(interrupted copy?); re-download the model into a "
                    "local directory and pass it via --checkpoint")
        elif "safetensors" in text or "pickle" in text or "corrupt" in text:
            hint = (f"checkpoint under {checkpoint!r} failed to parse — "
                    "run whisperjav-verify-checkpoint on it for a "
                    "per-tensor diagnosis")
        else:
            hint = "run whisperjav-verify-checkpoint for a diagnosis"
        chain = "\n".join(f"  [{i}] {m.strip().splitlines()[0][:200]}"
                          for i, m in enumerate(msgs))
        return (f"Failed to load the cohere-slot audio-LM: {hint}\n"
                f"Full error chain (most recent -> original cause):\n{chain}")

    def load(self) -> None:
        try:
            self._inner.load()
        except Exception as exc:
            raise RuntimeError(
                self._format_load_error(exc, self._inner.checkpoint)
            ) from exc

    def unload(self) -> None:
        self._inner.unload()

    @staticmethod
    def _join_overlapped(a: str, b: str, max_overlap: int = 48) -> str:
        """Merge chunk texts: drop b's prefix that repeats a's suffix
        (longest match wins; the role of audio_chunk_index reassembly)."""
        if not a:
            return b
        if not b:
            return a
        lim = min(len(a), len(b), max_overlap)
        for k in range(lim, 2, -1):
            if a[-k:] == b[:k]:
                return a + b[k:]
        return a + b

    def generate_batch(self, clips, sample_rate,
                       contexts=None) -> List[TranscriptionResult]:
        if contexts and any(contexts):
            logger.debug("cohere generator: context ignored (the vendor "
                         "model accepts no initial prompt)")
        chunk_n = int(self.chunk_s * sample_rate)
        hop_n = chunk_n - int(self.overlap_s * sample_rate)
        pieces: List[np.ndarray] = []
        owner: List[int] = []
        for ci, clip in enumerate(clips):
            clip = np.asarray(clip, np.float32)
            if len(clip) <= chunk_n:
                pieces.append(clip)
                owner.append(ci)
                continue
            pos = 0
            while pos < len(clip):
                pieces.append(clip[pos:pos + chunk_n])
                owner.append(ci)
                if pos + chunk_n >= len(clip):
                    break
                pos += hop_n
        inner = self._inner.generate_batch(pieces, sample_rate)
        texts = [""] * len(clips)
        lps: List[List[float]] = [[] for _ in clips]
        for res, ci in zip(sorted(inner, key=lambda r: r.frame_index),
                           owner):
            texts[ci] = self._join_overlapped(texts[ci], res.text)
            lps[ci].append(res.avg_logprob)
        return [
            TranscriptionResult(ci, texts[ci],
                                float(np.mean(lps[ci])) if lps[ci] else 0.0)
            for ci in range(len(clips))
        ]


def create_generator(backend: str = "qwen3", **kwargs):
    b = (backend or "qwen3").lower()
    if b in ("qwen3", "qwen"):
        return QwenGenerator(**kwargs)
    if b in ("whisper", "anime-whisper", "anime_whisper"):
        return WhisperGenerator(**kwargs)
    if b == "cohere":
        return CohereStyleGenerator(**kwargs)
    logger.warning("unknown generator %r; using qwen3", backend)
    return QwenGenerator(**kwargs)


# ---------------------------------------------------------------------------
# cleaners
# ---------------------------------------------------------------------------

class AssemblyTextCleaner:
    """Pre-alignment raw-text cleaning: collapse repetition noise but
    PRESERVE punctuation — the aligner's tokenizer needs it (reference:
    assembly_text_cleaner.py:1-11)."""

    name = "assembly"

    def __init__(self):
        from whisperjav_tpu_torch.modules.sanitize.hallucinations import (
            HallucinationRemover,
        )
        from whisperjav_tpu_torch.modules.sanitize.repetition import (
            RepetitionCleaner,
        )
        self.hallucinations = HallucinationRemover("ja")
        self.repetitions = RepetitionCleaner()

    def clean_batch(self, results) -> List[TranscriptionResult]:
        out = []
        for r in results:
            text = r.text
            if self.hallucinations.is_hallucination(text):
                text = ""
            else:
                text, _ = self.repetitions.clean(text)
            out.append(TranscriptionResult(r.frame_index, text,
                                           r.avg_logprob, raw_text=r.text))
        return out


class PassthroughCleaner:
    name = "passthrough"

    def clean_batch(self, results) -> List[TranscriptionResult]:
        return list(results)


def create_cleaner(backend: str = "assembly", **kwargs):
    b = (backend or "assembly").lower()
    if b in ("assembly", "qwen3", "anime_whisper"):
        return AssemblyTextCleaner()
    return PassthroughCleaner()


# ---------------------------------------------------------------------------
# aligners
# ---------------------------------------------------------------------------

class QwenAlignerAdapter:
    """ForcedAligner adapter producing per-word timestamps (reference:
    aligners/qwen3.py:19 — fresh instance per load, merge_master step),
    on ``device``; the whole alignment runs on the device
    (``ForcedAligner.align_batch_audio``), or with ``WJAV_ALIGN_DEVICE=0``
    the JAX package's host path: the log-mel of the padded batch drained
    to the host, then ``ForcedAligner.align_batch`` (the similarity on the
    device, the log-softmax and the Viterbi on the host)."""

    name = "qwen3"

    def __init__(self, aligner=None, tokenizer=None, device="cuda"):
        from whisperjav_tpu_torch.pipelines.engine import resolve_device
        self._aligner = aligner
        self.tokenizer = tokenizer
        self.device = resolve_device(device)

    def load(self) -> None:
        if self._aligner is None:
            from whisperjav_tpu_torch.models.qwen.aligner import (
                ForcedAligner,
            )
            self._aligner = ForcedAligner(device=self.device)

    def unload(self) -> None:
        self._aligner = None

    def _tokenize(self, text: str) -> Tuple[List[int], List[str]]:
        if self.tokenizer is not None:
            ids = self.tokenizer.encode(text)
            pieces = [self.tokenizer.decode([i]) for i in ids]
            return ids, pieces
        # char-level fallback tokenization (deterministic)
        pieces = [c for c in text if not c.isspace()]
        ids = [(ord(c) * 31) % 4096 for c in pieces]
        return ids, pieces

    # fixed-shape ladders: clips snap up to a coarse grid of (audio,
    # tokens) buckets, rows to a power of two (at least 8) or MAX_ROWS,
    # so the batches' shapes repeat across scenes and files
    AUDIO_BUCKETS_S = (2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 180)
    TOKEN_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)
    MAX_ROWS = 32

    def buckets(self, clips, sample_rate, texts):
        """The alignment jobs by (audio bucket s, token bucket): each job
        (clip index, samples, ids, pieces); clips with no text or no
        tokens are left out."""
        def _bucket(ladder, v):
            for b in ladder:
                if v <= b:
                    return b
            return ladder[-1]

        groups: Dict[Tuple[int, int], List[Tuple[int, int, list, list]]] = {}
        for i, (clip, text) in enumerate(zip(clips, texts)):
            if not text.strip():
                continue
            ids, pieces = self._tokenize(text)
            if not ids:
                continue
            a_b = _bucket(self.AUDIO_BUCKETS_S,
                          max(1, -(-len(clip) // sample_rate)))
            t_b = _bucket(self.TOKEN_BUCKETS, len(ids))
            ids = ids[:t_b]          # 180 s-class clip, clamp to bucket
            pieces = pieces[:t_b]
            groups.setdefault((a_b, t_b), []).append((i, len(clip), ids,
                                                      pieces))
        return groups

    def align_batch(self, clips, sample_rate, texts) -> List[AlignmentResult]:
        from whisperjav_tpu_torch.ops.mel import log_mel_spectrogram
        assert self._aligner is not None, "call load() first"
        out: List[Optional[AlignmentResult]] = [None] * len(clips)
        device_path = os.environ.get("WJAV_ALIGN_DEVICE", "1") != "0"
        for (a_b, t_b), jobs in self.buckets(clips, sample_rate,
                                             texts).items():
            t_samples = a_b * sample_rate
            for c0 in range(0, len(jobs), self.MAX_ROWS):
                chunk = jobs[c0:c0 + self.MAX_ROWS]
                rows = self.MAX_ROWS if len(jobs) > self.MAX_ROWS \
                    else max(8, 1 << (len(chunk) - 1).bit_length())
                buf = np.zeros((rows, t_samples), np.float32)
                sample_valid = np.zeros(rows, np.int32)
                mel_valid = np.zeros(rows, np.int32)
                token_rows: List[list] = [[] for _ in range(rows)]
                for r, (i, clen, ids, _pieces) in enumerate(chunk):
                    clen = min(clen, t_samples)   # >180 s clips clamp
                    buf[r, :clen] = clips[i][:clen]
                    sample_valid[r] = clen
                    mel_valid[r] = -(-clen // 160)   # true mel frames
                    token_rows[r] = ids
                if device_path:
                    spans_rows = self._aligner.align_batch_audio(
                        buf, token_rows, sample_valid, n_pad=t_b)
                else:
                    mels = log_mel_spectrogram(
                        torch.from_numpy(buf).to(self.device),
                        n_mels=self._aligner.cfg.n_mels).cpu().numpy()
                    spans_rows = self._aligner.align_batch(
                        mels, token_rows, mel_valid, n_pad=t_b)
                for r, (i, _clen, _ids, pieces) in enumerate(chunk):
                    words = [WordTimestamp(piece, s.start, s.end)
                             for piece, s in zip(pieces, spans_rows[r])]
                    out[i] = AlignmentResult(i, words)
        return [r if r is not None else AlignmentResult(i, [])
                for i, r in enumerate(out)]


class NullAligner:
    """No alignment: words get null timestamps (hardening resolves them
    via VAD/proportional modes)."""

    name = "none"

    def load(self) -> None: ...

    def unload(self) -> None: ...

    def align_batch(self, clips, sample_rate, texts) -> List[AlignmentResult]:
        out = []
        for i, text in enumerate(texts):
            words = [WordTimestamp(c, None, None)
                     for c in text if not c.isspace()]
            out.append(AlignmentResult(i, words))
        return out


def create_aligner(backend: str = "qwen3", **kwargs):
    b = (backend or "qwen3").lower()
    if b in ("qwen3", "qwen", "forced"):
        return QwenAlignerAdapter(**kwargs)
    return NullAligner()
