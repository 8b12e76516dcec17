"""TranscriptionEngine: audio windows -> tokens on one device, in PyTorch.

Counterpart of ``whisperjav_tpu/pipelines/engine.py`` for one device:
int16 audio upload, log-mel, encoder, encoder states sliced to a
cross-K/V bucket, int8 cross-K/V, beam search at temperature 0 and
sampled best-of rungs above it, the quality gates, and the temperature
ladder with the failed rows of a whole file retried together at its end
(deferred retries). Batches run one after another.

Options: ``word_timestamps`` tightens segment bounds with a
cross-attention word alignment pass per decoded row
(``models/whisper/word_align.py``), on the inline and the deferred path
alike; ``vocab_subset`` decodes against a sliced vocabulary
(``models/whisper/vocab_subset.py``): the token embedding is sliced
before int8 quantisation (so the int8 lm head is built at subset size),
decoding runs in subset ids, and emitted tokens map back to full-vocab
ids on the device.

``WJAV_TRACE_BATCHES=1`` records one row per batch in ``batch_trace``
(the wall of each phase: encode, the first-rung decode, the ladder's
rungs, segment extraction; taken after a device sync, so each phase owns
its device time) and one row for the deferred retries; the file pipeline
copies it into its stats.
"""

from __future__ import annotations

import dataclasses
import os
import time
import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from whisperjav_tpu_torch.models.whisper.config import WhisperConfig
from whisperjav_tpu_torch.models.whisper.tokenizer import WhisperTokenizer
from whisperjav_tpu_torch.utils.logger import logger
from whisperjav_tpu_torch.models.whisper.decode import (
    DecodeOptions, DecodeResult, DecodedSegment, decode_beam, decode_greedy,
    extract_segments,
)
from whisperjav_tpu_torch.models.whisper.model import Whisper, encode
from whisperjav_tpu_torch.models.whisper.quant import (
    fuse_qkv_weights, quantize_decoder_weights,
)
from whisperjav_tpu_torch.models.whisper.vocab_subset import (
    SubsetTokenizerAdapter, VocabSubset,
)
from whisperjav_tpu_torch.models.whisper.word_align import word_timestamps
from whisperjav_tpu_torch.ops.mel import N_SAMPLES, log_mel_spectrogram
from whisperjav_tpu_torch.parallel.batching import (
    Window, WindowBatch, batch_windows,
)


@dataclass
class QualityThresholds:
    """Decoding gates and the temperature ladder."""
    logprob_threshold: float = -1.0
    no_speech_threshold: float = 0.6
    compression_ratio_threshold: float = 2.4
    temperatures: Tuple[float, ...] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


# Encoder-frame buckets for cross-K/V slicing: decoding reads the whole
# cross K/V every token, so a batch of short windows is decoded against
# the smallest bucket that covers its longest window.
CROSS_KV_BUCKETS = (448, 960, 1500)
FRAMES_PER_SECOND = 50   # whisper encoder frames


def device_label(device) -> str:
    """``cuda:<the card's name>`` or the device type (``cpu``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


def release_device_memory(device) -> None:
    """Return dropped tensors' memory before the next model is built:
    collect reference cycles, then hand the allocator's cached blocks
    back to the card."""
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA request without a visible GPU raises
    rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA GPU "
                           "is visible")
    return dev


class TranscriptionEngine:
    """Batched Whisper inference with the temperature-fallback ladder.

    Takes ownership of ``model``: it is moved to ``device``, cast to
    ``compute_dtype``, its token embedding is sliced to ``vocab_subset``
    (and its config replaced by the sliced one) and its decoder q/k/v
    weights are fused, in place; with ``int8_weights`` the decoder
    matmuls and the lm head are then quantised to int8
    (``--int8-weights``), which single decode steps run through the fused
    blocks.
    """

    def __init__(
        self,
        config: WhisperConfig,
        model: Whisper,
        options: DecodeOptions = DecodeOptions(cross_kv_int8=True),
        thresholds: QualityThresholds = QualityThresholds(),
        batch_size: int = 8,
        device="cuda",
        tokenizer: Optional[WhisperTokenizer] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        prompt_tokens: Tuple[int, ...] = (),
        int8_weights: bool = False,
        word_timestamps: bool = False,
        vocab_subset=None,   # kept text-token ids (< eot), full-vocab space
    ):
        # f32 matmuls and cuDNN convolutions (the mel STFT, the encoder
        # convs) in full f32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.options = options
        self.thresholds = thresholds
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or WhisperTokenizer(config)
        self.compute_dtype = compute_dtype
        self.word_timestamps = word_timestamps
        self.model = model.to(device=self.device, dtype=compute_dtype)
        self._vocab = None
        self._sub_ids = None
        if vocab_subset is not None:
            self._vocab = VocabSubset(config, vocab_subset)
            self.options = self._vocab.remap_options(options)
            if prompt_tokens:
                sub_prompt = self._vocab.to_subset(prompt_tokens)
                if len(sub_prompt) != len(prompt_tokens):
                    logger.warning(
                        "vocab slice: %d prompt token(s) outside the "
                        "subset were dropped",
                        len(prompt_tokens) - len(sub_prompt))
                prompt_tokens = sub_prompt
            # the decoder now holds the subset's rows only: it decodes in
            # subset ids under the sliced config
            self._sub_ids = torch.from_numpy(
                self._vocab.sub_ids.astype(np.int64)).to(self.device)
            dec = self.model.decoder
            dec.tok_emb = nn.Parameter(dec.tok_emb[self._sub_ids],
                                       requires_grad=False)
            self.model.config = self._vocab.config
        self.prompt_tokens = tuple(prompt_tokens)
        logger.info("engine %s on %s", config.name, device_label(self.device))
        fuse_qkv_weights(self.model)
        if int8_weights:
            quantize_decoder_weights(self.model)

    # ------------------------------------------------------------------
    def upload_audio(self, audio: np.ndarray) -> torch.Tensor:
        """float32 [-1, 1] host audio -> int16 on the device (the WAV's
        own dtype: half the bytes of float32)."""
        if audio.dtype != np.int16:
            audio = (np.clip(np.asarray(audio), -1.0, 1.0)
                     * 32767.0).astype(np.int16)
        return torch.from_numpy(audio).to(self.device)

    @torch.inference_mode()
    def encode_batch(self, audio: np.ndarray,
                     max_duration: Optional[float] = None) -> torch.Tensor:
        """(B, N_SAMPLES) audio -> encoder states, sliced to the cross-K/V
        bucket (CROSS_KV_BUCKETS) that covers ``max_duration`` seconds."""
        if audio.shape[1] != N_SAMPLES:
            raise ValueError(f"audio rows must hold {N_SAMPLES} samples, "
                             f"got {audio.shape[1]}")
        mel = log_mel_spectrogram(self.upload_audio(audio),
                                  n_mels=self.config.n_mels)
        xa = encode(self.model, mel.to(self.compute_dtype))
        if max_duration is not None:
            need = int(np.ceil(max_duration * FRAMES_PER_SECOND)) + 8
            bucket = next((b for b in CROSS_KV_BUCKETS if b >= need),
                          CROSS_KV_BUCKETS[-1])
            if bucket < xa.shape[1]:
                xa = xa[:, :bucket].contiguous()
        return xa

    def decode_batch(self, audio: np.ndarray, temperature: float = 0.0,
                     seed: int = 0) -> DecodeResult:
        """audio (B, N_SAMPLES) f32 → host results of one rung: the whole
        encoder output (no bucket), then :meth:`decode_encoded` (beam
        search at temperature 0 when the options ask for beams)."""
        return self.decode_encoded(self.encode_batch(audio), temperature,
                                   seed)

    @torch.inference_mode()
    def decode_encoded(self, xa: torch.Tensor, temperature: float = 0.0,
                       seed: int = 0) -> DecodeResult:
        """Decode encoder states; returns host (numpy) results.

        The token budget scales with the encoder-state length (a 448-frame
        bucket never needs the full 30 s budget). Temperature 0 runs beam
        search when the options ask for beams; sampled rungs draw
        ``best_of`` samples, each from a generator seeded
        ``seed + 7919*i``, and keep each row's best by avg logprob.
        """
        budget = min(self.options.max_new_tokens, xa.shape[1] // 4 + 32)
        opts = dataclasses.replace(self.options, max_new_tokens=budget)
        if temperature == 0.0 and opts.beam_size > 1:
            return self._to_host(decode_beam(self.model, xa, opts,
                                             prompt=self.prompt_tokens))
        n_best = opts.best_of if temperature > 0.0 else 1
        best = None
        for i in range(n_best):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed + 7919 * i)
            cand = self._to_host(decode_greedy(
                self.model, xa, opts, prompt=self.prompt_tokens,
                temperature=temperature, generator=gen))
            if best is None:
                best = cand
                continue
            win = cand.avg_logprob > best.avg_logprob
            best = DecodeResult(
                np.where(win[:, None], cand.tokens, best.tokens),
                np.where(win, cand.length, best.length),
                np.where(win, cand.sum_logprob, best.sum_logprob),
                np.where(win, cand.avg_logprob, best.avg_logprob),
                best.no_speech_prob)
        return best

    def _to_host(self, result: DecodeResult) -> DecodeResult:
        """Device results -> numpy, tokens in full-vocab ids (mapped back
        from subset ids on the device under a vocab slice)."""
        if self._sub_ids is not None:
            result = result._replace(tokens=self._sub_ids[result.tokens])
        return DecodeResult(*(x.cpu().numpy() for x in result))

    # ------------------------------------------------------------------
    def _compression_ratio(self, token_ids: Sequence[int]) -> float:
        """zlib compression ratio of the text (of the token bytes when no
        real tokenizer is loaded)."""
        text_ids = [t for t in token_ids if t < self.config.eot]
        if not text_ids:
            return 0.0
        if self.tokenizer.is_real:
            data = self.tokenizer.decode(text_ids).encode("utf-8")
        else:
            data = np.asarray(text_ids, np.int32).tobytes()
        if len(data) == 0:
            return 0.0
        return len(data) / len(zlib.compress(data))

    def _row_needs_fallback(self, tokens: np.ndarray, avg_lp: float,
                            no_speech: float = 0.0) -> bool:
        th = self.thresholds
        # confident silence is not retried: the no-speech gate drops it
        if no_speech > th.no_speech_threshold:
            return False
        if avg_lp < th.logprob_threshold:
            return True
        return self._compression_ratio(tokens) > th.compression_ratio_threshold

    def _segments(self, window: Window, tokens, avg_lp: float,
                  no_speech: float) -> List[DecodedSegment]:
        """Gate one row and split it into text segments: dropped when
        both no-speech is high and the decode is low-confidence."""
        th = self.thresholds
        if (no_speech > th.no_speech_threshold
                and avg_lp < th.logprob_threshold):
            return []
        segs = extract_segments(tokens, self.config, self.options,
                                window_duration=window.duration,
                                avg_logprob=float(avg_lp),
                                no_speech_prob=float(no_speech))
        for s in segs:
            s.text = self.tokenizer.decode(s.tokens)
        return segs

    # ------------------------------------------------------------------
    def finish_batch(self, batch: WindowBatch, xa, result: DecodeResult,
                     seed: int = 0, defer_pool: Optional[list] = None,
                     trace: Optional[dict] = None,
                     ) -> List[Optional[List[DecodedSegment]]]:
        """Run the ladder on the rows that fail the gates and extract
        segments.

        With ``defer_pool``, failing rows are not retried here: they go to
        the pool and their slot in the returned list is None, for
        :meth:`_retry_deferred` to settle at the end of the file. Without
        it, each rung re-decodes the batch and a failed row adopts the
        retry if its avg logprob improved; the ladder stops at a rung that
        improves nothing or raises the mean logprob by less than 0.02.
        ``trace`` receives the rungs run and the ladder's and extraction's
        walls.
        """
        temps = self.thresholds.temperatures
        tokens = np.array(result.tokens)
        avg_lp = np.array(result.avg_logprob)
        no_speech = np.array(result.no_speech_prob)

        def failed_rows() -> list:
            return [b for b in range(batch.n_valid)
                    if self._row_needs_fallback(tokens[b], avg_lp[b],
                                                no_speech[b])]

        deferred_rows: set = set()
        if defer_pool is not None and len(temps) > 1:
            for b in failed_rows():
                defer_pool.append({"window": batch.windows[b],
                                   "tokens": np.array(tokens[b]),
                                   "avg_lp": float(avg_lp[b]),
                                   "no_speech": float(no_speech[b])})
                deferred_rows.add(b)
            temps = temps[:1]
        prev_mean = (float(np.mean(avg_lp[:batch.n_valid]))
                     if batch.n_valid else 0.0)
        t_ladder0 = time.perf_counter()
        if trace is not None:
            trace.update(bucket=int(xa.shape[1]), rows=int(xa.shape[0]),
                         rungs=1)
        for t_i, temp in enumerate(temps[1:], start=1):
            failed = failed_rows()
            if not failed:
                break
            logger.debug("temperature fallback t=%.1f for %d/%d rows",
                         temp, len(failed), batch.n_valid)
            retry = self.decode_encoded(xa, temp, seed + t_i)
            improved = False
            for b in failed:
                if retry.avg_logprob[b] > avg_lp[b]:
                    tokens[b] = retry.tokens[b]
                    avg_lp[b] = retry.avg_logprob[b]
                    improved = True
            mean_now = float(np.mean(avg_lp[:batch.n_valid]))
            if trace is not None:
                trace["rungs"] = t_i + 1
            if not improved or mean_now < prev_mean + 0.02:
                break
            prev_mean = mean_now
        t_extract0 = time.perf_counter()

        out = [None if b in deferred_rows
               else self._segments(batch.windows[b], tokens[b], avg_lp[b],
                                   no_speech[b])
               for b in range(batch.n_valid)]
        if trace is not None:
            trace["ladder_s"] = t_extract0 - t_ladder0
            trace["extract_s"] = time.perf_counter() - t_extract0
        if self.word_timestamps:
            self._refine_with_word_alignment(xa, tokens, batch, out)
        return out

    @torch.inference_mode()
    def _refine_with_word_alignment(self, xa, tokens, batch, out) -> None:
        """Tighten segment bounds with cross-attention word spans: one
        teacher-forced pass per row with segments, over that row's encoder
        states (sliced to the batch's cross-K/V bucket); a segment's start
        and end snap to its first and last word span when those lie
        within 0.5 s of them (alignment refines, never relocates)."""
        tok = self.tokenizer
        if self._vocab is not None:
            # the pass embeds through the sliced table, so it takes
            # subset ids; word text still decodes from full ids
            tok = SubsetTokenizerAdapter(self._vocab, self.tokenizer)
        for b in range(batch.n_valid):
            segs = out[b]
            if not segs:
                continue
            row = tokens[b]
            if self._vocab is not None:
                row = np.asarray(self._vocab.to_subset(row), np.int32)
            spans = word_timestamps(self.model, xa[b:b + 1], row,
                                    tokenizer=tok,
                                    audio_duration=batch.windows[b].duration)
            si = 0
            for seg in segs:
                n = len(seg.tokens)
                seg_spans = spans[si:si + n]
                si += n
                if not seg_spans:
                    continue
                new_start, new_end = seg_spans[0].start, seg_spans[-1].end
                if abs(new_start - seg.start) <= 0.5:
                    seg.start = new_start
                if abs(new_end - seg.end) <= 0.5:
                    seg.end = max(new_end, seg.start + 0.05)

    def _retry_deferred(self, pool: list, seed: int, trace: bool = False,
                        ) -> List[Tuple[Window, List[DecodedSegment]]]:
        """Run the ladder over the file's deferred rows: each rung
        re-encodes the still-failing rows in packed batches and decodes
        them at ``temperatures[t_i]``; a row adopts a retry that improves
        its avg logprob and leaves once it passes the gates; the ladder
        stops at a rung that improves nothing. With ``trace``, one row
        (rows, rungs, wall) goes to ``batch_trace``."""
        t0 = time.perf_counter()
        active = list(pool)
        rungs_run = 0
        for t_i, temp in enumerate(self.thresholds.temperatures[1:],
                                   start=1):
            if not active:
                break
            rungs_run = t_i
            by_id = {id(rec["window"]): rec for rec in active}
            improved_any = False
            for rb in batch_windows([rec["window"] for rec in active],
                                    self.batch_size):
                max_dur = max((w.duration for w in rb.windows),
                              default=30.0)
                xa = self.encode_batch(rb.audio, max_duration=max_dur)
                res = self.decode_encoded(xa, temp, seed + 7919 * t_i)
                for b in range(rb.n_valid):
                    rec = by_id[id(rb.windows[b])]
                    if res.avg_logprob[b] > rec["avg_lp"]:
                        rec["tokens"] = np.array(res.tokens[b])
                        rec["avg_lp"] = float(res.avg_logprob[b])
                        improved_any = True
            active = [rec for rec in active
                      if self._row_needs_fallback(rec["tokens"],
                                                  rec["avg_lp"],
                                                  rec["no_speech"])]
            if not improved_any:
                break
        out = [(rec["window"],
                self._segments(rec["window"], rec["tokens"], rec["avg_lp"],
                               rec["no_speech"]))
               for rec in pool]
        if self.word_timestamps and any(segs for _, segs in out):
            # one alignment pass per retry batch over freshly encoded
            # states; rows padded to one length with EOT (the pass ignores
            # a row past its EOT)
            recs = {id(rec["window"]): rec for rec in pool}
            segs_by_id = {id(w): segs for w, segs in out}
            for rb in batch_windows([rec["window"] for rec in pool],
                                    self.batch_size):
                max_dur = max((w.duration for w in rb.windows),
                              default=30.0)
                xa = self.encode_batch(rb.audio, max_duration=max_dur)
                t_len = max(len(recs[id(w)]["tokens"]) for w in rb.windows)
                tok = np.full((rb.batch_size, t_len), self.config.eot,
                              np.int32)
                for b, w in enumerate(rb.windows):
                    row = recs[id(w)]["tokens"]
                    tok[b, :len(row)] = row
                self._refine_with_word_alignment(
                    xa, tok, rb, [segs_by_id[id(w)] for w in rb.windows])
        wall = time.perf_counter() - t0
        logger.info("deferred retry: %d row(s), %d rung(s), %.1fs",
                    len(pool), rungs_run, wall)
        if trace:
            self.batch_trace.append({"retry_rows": len(pool),
                                     "rungs": rungs_run + 1,
                                     "ladder_s": wall, "batch_s": wall})
        return out

    def _sync(self) -> None:
        """Wait for the device's queued work (the trace's walls)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def transcribe_windows(
        self, windows: Sequence[Window], seed: int = 0,
    ) -> List[Tuple[Window, List[DecodedSegment]]]:
        """Decode a window list in fixed-shape batches, batch i with seed
        ``seed + 131*i``, then settle the deferred rows; results come back
        in (scene, group) order. Under ``WJAV_TRACE_BATCHES=1`` each batch
        leaves a row of phase walls in ``batch_trace``."""
        trace_on = os.environ.get("WJAV_TRACE_BATCHES", "0") != "0"
        self.batch_trace: List[dict] = []
        pool: Optional[list] = (
            [] if len(self.thresholds.temperatures) > 1 else None)
        results: List[Tuple[Window, List[DecodedSegment]]] = []
        batches = list(batch_windows(windows, self.batch_size))
        for bi, batch in enumerate(batches):
            t_b0 = time.perf_counter()
            max_dur = max((w.duration for w in batch.windows), default=30.0)
            xa = self.encode_batch(batch.audio, max_duration=max_dur)
            trace = None
            if trace_on:
                self._sync()
                trace = {"encode_s": time.perf_counter() - t_b0}
                t_dec = time.perf_counter()
            result = self.decode_encoded(
                xa, self.thresholds.temperatures[0], seed + bi * 131)
            if trace is not None:
                trace["decode_s"] = time.perf_counter() - t_dec
            segs = self.finish_batch(batch, xa, result, seed + bi * 131,
                                     defer_pool=pool, trace=trace)
            if trace is not None:
                self._sync()
                trace["batch_s"] = time.perf_counter() - t_b0
                trace["audio_s"] = round(
                    sum(w.duration for w in batch.windows), 1)
                self.batch_trace.append(trace)
                logger.info(
                    "batch %d/%d: %.1fs (enc %.2f dec %.2f ladder %.2f "
                    "extract %.2f) rungs=%d bucket=%d rows=%d audio=%.0fs",
                    bi + 1, len(batches), trace["batch_s"],
                    trace["encode_s"], trace["decode_s"], trace["ladder_s"],
                    trace["extract_s"], trace["rungs"], trace["bucket"],
                    trace["rows"], trace["audio_s"])
            results.extend((w, s) for w, s in zip(batch.windows, segs)
                           if s is not None)
        if pool:
            results.extend(self._retry_deferred(pool, seed, trace=trace_on))
        results.sort(key=lambda p: (p[0].scene_idx, p[0].group_idx))
        return results
