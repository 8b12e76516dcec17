"""TranscriptionEngine: audio windows -> tokens, in PyTorch.

Counterpart of ``whisperjav_tpu/pipelines/engine.py``: int16 audio
upload, log-mel, encoder, encoder states sliced to a cross-K/V bucket,
cross-K/V in the compute dtype or int8 (the factory's choice), beam
search at temperature 0 and sampled best-of rungs above it, the quality
gates, and the temperature ladder with the failed rows of a whole file
retried together at its end (deferred retries, ``WJAV_DEFER_RETRY=0``
retries inline).

Batch pipelining, as the JAX engine's (``transcribe_windows``): batch
i+1's audio is uploaded while batch i decodes (a pinned int16 host
buffer copied without blocking on a side stream of the device); every
encode runs on that side stream, behind its upload, and records an
event, on which the stream that decodes waits (never a device-wide
sync), so batch i+1's encode, enqueued right after batch i's first-rung
decode (encode-ahead, ``WJAV_ENCODE_AHEAD=0`` turns it off), runs beside
batch i's ladder rungs. Decode-ahead (``WJAV_DECODE_AHEAD``: ``auto``
under a memory gate, ``1``, ``0``) keeps the JAX order: encode and
decode batch i, upload batch i+1, then drain and finish batch i-1. In
eager PyTorch a rung's decode has run by the time its host loop returns,
so only the side stream's work overlaps. Outputs are the same with
pipelining on and off: each batch's decode reads only its own encoder
states and seed.

Data parallelism (``mesh``, ``parallel/mesh.py``): the model is prepared
once (cast, vocabulary slice, q/k/v fusion, int8 quantisation) and then
copied to every device of the mesh. A batch's rows split into the mesh's
contiguous equal blocks; each device encodes and decodes its block in a
host thread of its own, under its device and, on CUDA, a stream of its
own (and its side stream for uploads and encodes), and the decode
results are gathered in row order on the mesh's first device. The
encoder states stay on their devices (:class:`ShardedStates`), so the
ladder's rungs and the word alignment read them where they are. The
sampled rungs' noise does not depend on the mesh: each device draws the
whole batch's gumbel noise from a generator seeded as one device would
seed it, and keeps its own rows, so a row gets the same noise on any
number of devices. On the CPU a row's numbers do not depend on the
mesh. On CUDA they do only where a product reduces in one order at
every row count: cuBLAS, given a workspace (its default), splits a
product's K over blocks by the row count (on an H100, the K = 4d MLP
product at 64 rows against 32), so a row's last bits, and a token whose
logits tie within them, can differ from one device's.
``CUBLAS_WORKSPACE_CONFIG=:0:0`` with ``CUBLASLT_WORKSPACE_SIZE=0``
leaves cuBLAS no workspace to split into.

Options: ``word_timestamps`` tightens segment bounds with a
cross-attention word alignment pass per decoded row
(``models/whisper/word_align.py``), on the inline and the deferred path
alike; ``vocab_subset`` decodes against a sliced vocabulary
(``models/whisper/vocab_subset.py``): the token embedding is sliced
before int8 quantisation (so the int8 lm head is built at subset size),
decoding runs in subset ids, and emitted tokens map back to full-vocab
ids on the device.

``WJAV_TRACE_BATCHES=1``: each :meth:`transcribe_windows` call records
host spans in a recorder (``recorder``, ``utils/tracer.py``), adding no
device sync: ``engine.batch`` a batch over its ``engine.upload``,
``engine.encode``, ``engine.decode`` (the decode loop's spans below it),
``engine.drain``, ``engine.ladder``, ``engine.extract`` and
``engine.align``, then ``engine.retry``. ``batch_trace`` is their view in
the JAX engine's rows, a wall the length of its spans: ``upload_s``,
``encode_s`` (when not encoded ahead), ``dispatch_s`` (the first rung's
host loop), ``ahead_s`` (the next batch's encode), ``drain_s``,
``ladder_s``, ``extract_s``, ``batch_s``, and a row for the deferred
retries; the file pipeline copies it into its stats.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import contextvars
import copy
import dataclasses
import os
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
from whisperjav_tpu_torch.models.layers import draw_gumbel
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
from whisperjav_tpu_torch.parallel.mesh import Mesh
from whisperjav_tpu_torch.utils import tracer


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
# batch_trace's walls (the JAX engine's keys) and the spans each sums
_BATCH_WALLS = {"upload_s": "engine.upload", "encode_s": "engine.encode",
                "dispatch_s": "engine.decode", "ahead_s": "engine.encode",
                "drain_s": "engine.drain", "ladder_s": "engine.ladder",
                "extract_s": "engine.extract"}


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


def gumbel_source(seed: int, rows: int, vocab: int, device):
    """The sampled rungs' noise: step i's (rows, vocab) gumbel draw from
    a generator on ``device`` seeded ``seed``, drawn in step order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return lambda step: draw_gumbel(gen, (rows, vocab), device)


class ShardedStates(tuple):
    """One batch on the devices, a block of rows a shard: element k holds
    the k-th row block on the mesh's device k (one element on one
    device). Audio from :meth:`TranscriptionEngine.upload_audio`, or
    encoder states from :meth:`TranscriptionEngine.encode_batch`.

    ``ready[k]`` is the CUDA event recorded on shard k's side stream
    after block k was written (None where no other stream needs to wait:
    on the CPU, and for an upload, which the encode reads on the same
    stream); ``host`` holds the pinned host buffers an upload copies
    from, so they live as long as what was copied into."""

    def __new__(cls, parts, ready=None, host=()):
        self = super().__new__(cls, parts)
        self.ready = tuple(ready) if ready is not None else (None,) * len(
            self)
        self.host = tuple(host)
        return self

    @property
    def shape(self) -> tuple:
        return (sum(x.shape[0] for x in self), *self[0].shape[1:])


def to_host(result: DecodeResult) -> DecodeResult:
    """Decode results (device tensors, or arrays) -> numpy, waiting for
    the stream that computed them."""
    return DecodeResult(*(x.cpu().numpy() if isinstance(x, torch.Tensor)
                          else np.asarray(x) for x in result))


def _mark(device: torch.device):
    """An event recorded on ``device``'s current stream (None on the
    CPU)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _after(x: torch.Tensor, event) -> torch.Tensor:
    """``x``, usable on its device's current stream: the stream waits on
    ``event`` (recorded after x was written on another stream), and the
    allocator keeps x's memory until the current stream's work on it is
    done."""
    if event is not None:
        stream = torch.cuda.current_stream(x.device)
        stream.wait_event(event)
        x.record_stream(stream)
    return x


@dataclass
class _Shard:
    """One device of the mesh: its model replica, its stream (None: the
    current one), its side stream for uploads and encodes (None on the
    CPU) and the vocabulary slice's ids on it."""
    device: torch.device
    model: Whisper
    stream: Optional[object] = None
    side: Optional[object] = None
    sub_ids: Optional[torch.Tensor] = None


class TranscriptionEngine:
    """Batched Whisper inference with the temperature-fallback ladder.

    Takes ownership of ``model``: it is moved to ``device`` (the mesh's
    first device when ``mesh`` is given), cast to ``compute_dtype``, its
    token embedding is sliced to ``vocab_subset`` (and its config
    replaced by the sliced one) and its decoder q/k/v weights are fused
    (unless ``WJAV_FUSE_QKV=0``), in place; with ``int8_weights`` the
    decoder matmuls and the lm head are then quantised to int8
    (``--int8-weights``), which single decode steps run through the
    fused blocks when q/k/v are fused. Over a mesh of N devices the
    prepared model is then copied to the other N - 1, and
    ``batch_size`` must be a multiple of N.
    """

    def __init__(
        self,
        config: WhisperConfig,
        model: Whisper,
        options: DecodeOptions = DecodeOptions(),
        thresholds: QualityThresholds = QualityThresholds(),
        batch_size: int = 8,
        device="cuda",
        tokenizer: Optional[WhisperTokenizer] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        prompt_tokens: Tuple[int, ...] = (),
        int8_weights: bool = False,
        word_timestamps: bool = False,
        vocab_subset=None,   # kept text-token ids (< eot), full-vocab space
        mesh: Optional[Mesh] = None,
    ):
        # f32 matmuls and cuDNN convolutions (the mel STFT, the encoder
        # convs) in full f32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.options = options
        self.thresholds = thresholds
        self.batch_size = batch_size
        self.mesh = mesh or Mesh((torch.device(device),))
        for dev in self.mesh.devices:
            resolve_device(dev)
        self.mesh.blocks(batch_size)      # the batch must split evenly
        self.device = self.mesh.devices[0]
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
        if os.environ.get("WJAV_FUSE_QKV", "1") != "0":
            # one (d, 3d) q/k/v product a decoder layer a step instead of
            # three, bitwise identical; WJAV_FUSE_QKV=0 keeps them apart
            # (on int8 weights the fused blocks then stand aside)
            fuse_qkv_weights(self.model)
        if int8_weights:
            quantize_decoder_weights(self.model)
        self._shards = [_Shard(self.device, self.model,
                               sub_ids=self._sub_ids)]
        for dev in self.mesh.devices[1:]:
            self._shards.append(_Shard(
                dev, copy.deepcopy(self.model).to(dev),
                sub_ids=(None if self._sub_ids is None
                         else self._sub_ids.to(dev))))
        self._pool = None
        self.recorder: Optional[tracer.SpanRecorder] = None
        for shard in self._shards:
            if shard.device.type == "cuda":
                # the prepared weights are whole before another stream
                # reads them
                torch.cuda.synchronize(shard.device)
                shard.side = torch.cuda.Stream(device=shard.device)
                if self.mesh.size > 1:
                    shard.stream = torch.cuda.Stream(device=shard.device)
        if self.mesh.size > 1:
            logger.info("engine %s replicated over %d devices: %s",
                        config.name, self.mesh.size,
                        ", ".join(device_label(d)
                                  for d in self.mesh.devices))
        else:
            logger.info("engine %s on %s", config.name,
                        device_label(self.device))

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _on(self, shard: _Shard, side: bool = False):
        """Run under ``shard``'s device and stream (its side stream with
        ``side``), in inference mode."""
        with contextlib.ExitStack() as stack:
            if shard.device.type == "cuda":
                stack.enter_context(torch.cuda.device(shard.device))
                stream = shard.side if side else shard.stream
                if stream is not None:
                    stack.enter_context(torch.cuda.stream(stream))
            stack.enter_context(torch.inference_mode())
            yield

    def _map(self, fn) -> list:
        """``fn(k, shard)`` for every shard of the mesh, each in a host
        thread of its own under its device and stream (in the caller's
        thread for one device); the results in shard order."""
        if len(self._shards) == 1:
            with self._on(self._shards[0]):
                return [fn(0, self._shards[0])]
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                len(self._shards), thread_name_prefix="wjt-shard")

        def run(k):
            tracer.set_shard(k)
            with self._on(self._shards[k]):
                return fn(k, self._shards[k])

        # each thread in a copy of the caller's context: its spans open
        # under the caller's
        futures = [self._pool.submit(contextvars.copy_context().run, run, k)
                   for k in range(len(self._shards))]
        concurrent.futures.wait(futures)
        return [f.result() for f in futures]

    def _split(self, xa) -> List[torch.Tensor]:
        """Encoder states as one tensor a shard (a tensor on one device,
        or :class:`ShardedStates`, as :meth:`encode_batch` gives them)."""
        parts = list(xa) if isinstance(xa, ShardedStates) else [xa]
        if len(parts) != len(self._shards):
            raise ValueError(f"encoder states in {len(parts)} block(s) for "
                             f"a mesh of {len(self._shards)} devices")
        return parts

    def _states(self, xa, k: int) -> torch.Tensor:
        """Shard k's encoder states, usable on the current stream (it
        waits on the event recorded after their encode)."""
        part = self._split(xa)[k]
        return _after(part, xa.ready[k] if isinstance(xa, ShardedStates)
                      else None)

    def upload_audio(self, audio) -> ShardedStates:
        """float32 [-1, 1] host audio -> int16 on the devices, a row block
        a shard (the WAV's own dtype: half the bytes of float32).

        On CUDA the rows go through a pinned host buffer, copied without
        blocking on the shard's side stream, so the host goes on while
        they stream (double buffering: the next batch's upload runs
        behind this one's decode). Uploaded audio is returned as it is."""
        if isinstance(audio, ShardedStates):
            return audio
        if audio.dtype != np.int16:
            audio = (np.clip(np.asarray(audio), -1.0, 1.0)
                     * 32767.0).astype(np.int16)
        blocks = self.mesh.blocks(audio.shape[0]) \
            if len(self._shards) > 1 else [slice(None)]
        parts, host = [], []
        for shard, rows in zip(self._shards, blocks):
            block = np.ascontiguousarray(audio[rows])
            if shard.side is None:
                parts.append(torch.from_numpy(block).to(shard.device))
                continue
            pinned = torch.empty(block.shape, dtype=torch.int16,
                                 pin_memory=True)
            pinned.numpy()[...] = block
            with torch.cuda.device(shard.device), \
                    torch.cuda.stream(shard.side):
                parts.append(pinned.to(shard.device, non_blocking=True))
            host.append(pinned)
        return ShardedStates(parts, host=host)

    def encode_batch(self, audio=None, device_audio=None,
                     max_duration: Optional[float] = None) -> ShardedStates:
        """(B, N_SAMPLES) audio (or its :meth:`upload_audio`) -> encoder
        states, sliced to the cross-K/V bucket (CROSS_KV_BUCKETS) that
        covers ``max_duration`` seconds, a row block a shard.

        Each shard's mel and encoder are enqueued on its side stream,
        behind the upload, and an event is recorded after them; the host
        returns once they are enqueued, so this can be called for batch
        i+1 while batch i's decode is in flight (encode-ahead)."""
        up = self.upload_audio(device_audio if device_audio is not None
                               else audio)
        if up.shape[1] != N_SAMPLES:
            raise ValueError(f"audio rows must hold {N_SAMPLES} samples, "
                             f"got {up.shape[1]}")

        def enc(k, shard):
            with self._on(shard, side=True):
                mel = log_mel_spectrogram(up[k], n_mels=self.config.n_mels)
                xa = encode(shard.model, mel.to(self.compute_dtype))
                if max_duration is not None:
                    need = int(np.ceil(max_duration * FRAMES_PER_SECOND)) + 8
                    bucket = next((b for b in CROSS_KV_BUCKETS if b >= need),
                                  CROSS_KV_BUCKETS[-1])
                    if bucket < xa.shape[1]:
                        xa = xa[:, :bucket].contiguous()
                return xa, _mark(shard.device)

        parts = self._map(enc)
        return ShardedStates([x for x, _ in parts],
                             ready=[e for _, e in parts], host=up.host)

    def decode_batch(self, audio: Optional[np.ndarray] = None,
                     temperature: float = 0.0, seed: int = 0,
                     device_audio=None) -> DecodeResult:
        """audio (B, N_SAMPLES) f32 (or ``device_audio``, its
        :meth:`upload_audio`) -> device results of one rung: the whole
        encoder output (no bucket), then :meth:`decode_encoded` (beam
        search at temperature 0 when the options ask for beams)."""
        return self.decode_encoded(
            self.encode_batch(audio, device_audio=device_audio),
            temperature, seed)

    def decode_encoded(self, xa, temperature: float = 0.0,
                       seed: int = 0) -> DecodeResult:
        """Decode encoder states (a tensor or :class:`ShardedStates`);
        returns the results as tensors on the mesh's first device, in row
        order (:func:`to_host` drains them).

        The token budget scales with the encoder-state length (a 448-frame
        bucket never needs the full 30 s budget). Temperature 0 runs beam
        search when the options ask for beams; sampled rungs draw
        ``best_of`` samples, sample i with the noise of
        ``gumbel_source(seed + 7919*i, ...)`` over the whole batch, and
        keep each row's best by avg logprob.
        """
        parts = self._split(xa)
        rows = sum(x.shape[0] for x in parts)
        starts = np.cumsum([0] + [x.shape[0] for x in parts])
        budget = min(self.options.max_new_tokens, parts[0].shape[1] // 4 + 32)
        opts = dataclasses.replace(self.options, max_new_tokens=budget)

        def dec(k, shard):
            res = self._decode_rows(shard, self._states(xa, k), opts,
                                    temperature, seed, int(starts[k]), rows)
            return res, (_mark(shard.device) if shard.stream is not None
                         else None)

        out = self._map(dec)
        if len(out) == 1:
            return out[0][0]
        # each shard's rows, once its stream is done with them, onto the
        # first device, in row order
        parts = [[_after(x, event).to(self.device) for x in res]
                 for res, event in out]
        return DecodeResult(*(torch.cat(field) for field in zip(*parts)))

    def _decode_rows(self, shard: _Shard, xa: torch.Tensor,
                     opts: DecodeOptions, temperature: float, seed: int,
                     start: int, rows: int) -> DecodeResult:
        """One shard's rows [start, start + len(xa)) of a ``rows``-row
        batch, on the shard's device, in full-vocab ids."""
        if temperature == 0.0 and opts.beam_size > 1:
            return self._full_ids(shard, decode_beam(
                shard.model, xa, opts, prompt=self.prompt_tokens))
        n_best = opts.best_of if temperature > 0.0 else 1
        stop = start + xa.shape[0]
        best = None
        for i in range(n_best):
            noise = gumbel_source(seed + 7919 * i, rows,
                                  shard.model.config.n_vocab, shard.device)
            cand = self._full_ids(shard, decode_greedy(
                shard.model, xa, opts, prompt=self.prompt_tokens,
                temperature=temperature,
                gumbel=lambda step: noise(step)[start:stop]))
            if best is None:
                best = cand
                continue
            win = cand.avg_logprob > best.avg_logprob
            best = DecodeResult(
                torch.where(win[:, None], cand.tokens, best.tokens),
                torch.where(win, cand.length, best.length),
                torch.where(win, cand.sum_logprob, best.sum_logprob),
                torch.where(win, cand.avg_logprob, best.avg_logprob),
                best.no_speech_prob)
        return best

    @staticmethod
    def _full_ids(shard: _Shard, result: DecodeResult) -> DecodeResult:
        """Tokens in full-vocab ids (mapped back from subset ids on the
        device under a vocab slice)."""
        if shard.sub_ids is not None:
            result = result._replace(tokens=shard.sub_ids[result.tokens])
        return result

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
    def transcribe_batch(self, batch: WindowBatch, seed: int = 0,
                         device_audio=None, device_xa=None,
                         on_decode_dispatched=None,
                         trace: Optional[tracer.Span] = None,
                         defer_pool: Optional[list] = None,
                         ) -> List[Optional[List[DecodedSegment]]]:
        """Decode one padded batch with the temperature ladder: segment
        lists (window-relative times) of its valid windows, gated.

        ``device_audio``: the batch's :meth:`upload_audio`;
        ``device_xa``: its encoder states from :meth:`encode_batch`
        (encoded ahead; the encoder is skipped here).
        ``on_decode_dispatched``: called with no argument after the first
        rung's decode and before its results are drained;
        :meth:`transcribe_windows` enqueues the next batch's encode there.
        ``trace``: the batch's ``engine.batch`` span, under which its
        phases are recorded (None: untraced).
        """
        xa = device_xa
        if xa is None:
            with tracer.span(trace, "engine.encode"):
                xa = self.encode_batch(
                    batch.audio, device_audio=device_audio,
                    max_duration=max((w.duration for w in batch.windows),
                                     default=30.0))
        with tracer.span(trace, "engine.decode"):
            result = self.decode_encoded(xa, self.thresholds.temperatures[0],
                                         seed)
        if on_decode_dispatched is not None:
            on_decode_dispatched()
        return self.finish_batch(batch, xa, result, seed, trace=trace,
                                 defer_pool=defer_pool)

    def finish_batch(self, batch: WindowBatch, xa, result: DecodeResult,
                     seed: int = 0, trace: Optional[tracer.Span] = None,
                     defer_pool: Optional[list] = None,
                     ) -> List[Optional[List[DecodedSegment]]]:
        """Drain a first-rung decode, run the ladder on the rows that
        fail the gates and extract segments (split from
        :meth:`transcribe_batch` so decode-ahead can decode batch i+1
        before finishing batch i).

        With ``defer_pool``, failing rows are not retried here: they go to
        the pool and their slot in the returned list is None, for
        :meth:`_retry_deferred` to settle at the end of the file. Without
        it, each rung re-decodes the batch and a failed row adopts the
        retry if its avg logprob improved; the ladder stops at a rung that
        improves nothing or raises the mean logprob by less than 0.02.
        ``trace`` (the batch's ``engine.batch`` span) receives the drain,
        ladder, extraction and alignment spans and the batch's counters.
        """
        temps = self.thresholds.temperatures
        with tracer.span(trace, "engine.drain"):
            host = to_host(result)
        tokens = np.array(host.tokens)            # writable host copies
        avg_lp = np.array(host.avg_logprob)
        no_speech = np.array(host.no_speech_prob)
        if trace is not None:
            trace.counters.update(bucket=int(xa.shape[1]),
                                  rows=int(xa.shape[0]), rungs=1,
                                  tokens=int(host.length.sum()))

        def failed_rows() -> list:
            return [b for b in range(batch.n_valid)
                    if self._row_needs_fallback(tokens[b], avg_lp[b],
                                                no_speech[b])]

        prev_mean = (float(np.mean(avg_lp[:batch.n_valid]))
                     if batch.n_valid else 0.0)
        deferred_rows: set = set()
        with tracer.span(trace, "engine.ladder") as ladder:
            if defer_pool is not None and len(temps) > 1:
                for b in failed_rows():
                    defer_pool.append({"window": batch.windows[b],
                                       "tokens": np.array(tokens[b]),
                                       "avg_lp": float(avg_lp[b]),
                                       "no_speech": float(no_speech[b])})
                    deferred_rows.add(b)
                temps = temps[:1]
            for t_i, temp in enumerate(temps[1:], start=1):
                failed = failed_rows()
                if not failed:
                    break
                logger.debug("temperature fallback t=%.1f for %d/%d rows",
                             temp, len(failed), batch.n_valid)
                with tracer.span(ladder, "engine.decode"):
                    retry = self.decode_encoded(xa, temp, seed + t_i)
                with tracer.span(ladder, "engine.drain"):
                    retry = to_host(retry)
                improved = False
                for b in failed:
                    if retry.avg_logprob[b] > avg_lp[b]:
                        tokens[b] = retry.tokens[b]
                        avg_lp[b] = retry.avg_logprob[b]
                        improved = True
                mean_now = float(np.mean(avg_lp[:batch.n_valid]))
                if trace is not None:
                    trace.counters["rungs"] = t_i + 1
                if not improved or mean_now < prev_mean + 0.02:
                    break
                prev_mean = mean_now

        with tracer.span(trace, "engine.extract"):
            out = [None if b in deferred_rows
                   else self._segments(batch.windows[b], tokens[b],
                                       avg_lp[b], no_speech[b])
                   for b in range(batch.n_valid)]
        if self.word_timestamps:
            with tracer.span(trace, "engine.align"):
                self._refine_with_word_alignment(xa, tokens, batch, out)
        return out

    def _refine_with_word_alignment(self, xa, tokens, batch, out) -> None:
        """Tighten segment bounds with cross-attention word spans: one
        teacher-forced pass per row with segments, over that row's encoder
        states (sliced to the batch's cross-K/V bucket) on the device
        that holds them; a segment's start and end snap to its first and
        last word span when those lie within 0.5 s of them (alignment
        refines, never relocates)."""
        tok = self.tokenizer
        if self._vocab is not None:
            # the pass embeds through the sliced table, so it takes
            # subset ids; word text still decodes from full ids
            tok = SubsetTokenizerAdapter(self._vocab, self.tokenizer)
        parts = self._split(xa)
        per = parts[0].shape[0]
        for b in range(batch.n_valid):
            segs = out[b]
            if not segs:
                continue
            row = tokens[b]
            if self._vocab is not None:
                row = np.asarray(self._vocab.to_subset(row), np.int32)
            k, r = divmod(b, per)
            with self._on(self._shards[k]):
                spans = word_timestamps(
                    self._shards[k].model, self._states(xa, k)[r:r + 1], row,
                    tokenizer=tok, audio_duration=batch.windows[b].duration)
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

    def _retry_deferred(self, pool: list, seed: int,
                        ) -> List[Tuple[Window, List[DecodedSegment]]]:
        """Run the ladder over the file's deferred rows: each rung
        re-encodes the still-failing rows in packed batches and decodes
        them at ``temperatures[t_i]``; a row adopts a retry that improves
        its avg logprob and leaves once it passes the gates; the ladder
        stops at a rung that improves nothing. Traced, one
        ``engine.retry`` span, whose row goes to ``batch_trace``."""
        retry = tracer.child(self.recorder, "engine.retry", "retry")
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
                with tracer.span(retry, "engine.encode", f"retry:{t_i}"):
                    xa = self.encode_batch(rb.audio, max_duration=max_dur)
                with tracer.span(retry, "engine.decode", f"retry:{t_i}"):
                    res = self.decode_encoded(xa, temp, seed + 7919 * t_i)
                with tracer.span(retry, "engine.drain", f"retry:{t_i}"):
                    res = to_host(res)
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
        with tracer.span(retry, "engine.extract"):
            out = [(rec["window"],
                    self._segments(rec["window"], rec["tokens"],
                                   rec["avg_lp"], rec["no_speech"]))
                   for rec in pool]
        if self.word_timestamps and any(segs for _, segs in out):
            # one alignment pass per retry batch over freshly encoded
            # states; rows padded to one length with EOT (the pass ignores
            # a row past its EOT)
            align = tracer.child(retry, "engine.align")
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
            if align is not None:
                align.close()
        logger.info("deferred retry: %d row(s), %d rung(s)", len(pool),
                    rungs_run)
        if retry is not None:
            retry.close(retry_rows=len(pool), rungs=rungs_run + 1)
            self.batch_trace.append({"retry_rows": len(pool),
                                     "rungs": rungs_run + 1,
                                     "ladder_s": retry.seconds,
                                     "batch_s": retry.seconds})
        return out

    def _trace_batch(self, batch: WindowBatch, root: tracer.Span,
                     n_batches: int) -> None:
        """Append and log the ``batch_trace`` row of the batch ``root``
        closed. A wall sums its spans of the batch under ``root``;
        ``ahead_s`` the next batch's encode under ``root``, ``upload_s``
        the batch's own upload wherever it ran."""
        row = {key: sum((s.seconds for s in self.recorder.spans
                         if s.name == name
                         and (s.batch == root.batch) != (key == "ahead_s")
                         and (key == "upload_s" or s.parent is root)), 0.0)
               for key, name in _BATCH_WALLS.items()}
        c = root.counters
        row.update(batch_s=root.seconds,
                   audio_s=round(sum(w.duration for w in batch.windows), 1),
                   rungs=c["rungs"], bucket=c["bucket"], rows=c["rows"])
        self.batch_trace.append(row)
        logger.info("batch %d/%d: %s", root.batch + 1, n_batches, " ".join(
            f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()))

    # ------------------------------------------------------------------
    def _decode_ahead_bytes(self) -> int:
        """The JAX engine's estimate of the bytes one in-flight decode
        holds: cross-K/V, the self-attention cache and the encoder states
        at the largest bucket (the weights are shared)."""
        c = self.config
        rows = self.batch_size * max(self.options.beam_size, 1)
        bucket = CROSS_KV_BUCKETS[-1]
        kv_byte = 1 if self.options.cross_kv_int8 else 2
        cross = 2 * c.n_text_layer * rows * bucket * c.n_text_state * kv_byte
        budget = self.options.max_new_tokens + 8
        self_kv = 2 * c.n_text_layer * rows * budget * c.n_text_state * 2
        xa = self.batch_size * bucket * c.n_audio_state * 2
        return cross + self_kv + xa

    # the JAX package's budget for two in-flight decodes (its own
    # constant, kept as it is)
    DECODE_AHEAD_BUDGET_BYTES = 5 * 1024 ** 3

    def _decode_ahead_enabled(self) -> bool:
        """``WJAV_DECODE_AHEAD``: ``1`` on, ``0`` off, ``auto`` (the
        default) on when two decodes' bytes fit the budget."""
        mode = os.environ.get("WJAV_DECODE_AHEAD", "auto")
        if mode == "0":
            return False
        if mode == "1":
            return True
        return 2 * self._decode_ahead_bytes() < self.DECODE_AHEAD_BUDGET_BYTES

    def transcribe_windows(
        self, windows: Sequence[Window], seed: int = 0,
    ) -> List[Tuple[Window, List[DecodedSegment]]]:
        """Decode a window list in fixed-shape batches, batch i with seed
        ``seed + 131*i``, then settle the deferred rows; results come back
        in (scene, group) order.

        The JAX engine's pipelining: batch i+1's upload is enqueued
        before batch i is drained (double buffering); with
        ``WJAV_ENCODE_AHEAD`` (on unless ``0``) batch i+1's encode is
        enqueued on the side stream right after batch i's first-rung
        decode, before its drain; with decode-ahead as well
        (:meth:`_decode_ahead_enabled`) the order is encode and decode
        batch i, upload batch i+1, then finish batch i-1. A single batch
        runs as it would without them."""
        ahead_on = os.environ.get("WJAV_ENCODE_AHEAD", "1") != "0"
        defer_on = (os.environ.get("WJAV_DEFER_RETRY", "1") != "0"
                    and len(self.thresholds.temperatures) > 1)
        pool: Optional[list] = [] if defer_on else None
        rec = self.recorder = (
            tracer.SpanRecorder()
            if os.environ.get("WJAV_TRACE_BATCHES", "0") != "0" else None)
        self.batch_trace: List[dict] = []
        results: List[Tuple[Window, List[DecodedSegment]]] = []
        batches = list(batch_windows(windows, self.batch_size))

        def longest(bi: int) -> float:
            return max((w.duration for w in batches[bi].windows),
                       default=30.0)

        def upload(bi: int, under):
            """Batch bi's audio on the devices (None past the last)."""
            if bi == len(batches):
                return None
            with tracer.span(under, "engine.upload", bi):
                return self.upload_audio(batches[bi].audio)

        def record(batch, segs, root) -> None:
            if root is not None:
                root.close()
                self._trace_batch(batch, root, len(batches))
            results.extend((w, s) for w, s in zip(batch.windows, segs)
                           if s is not None)

        def finish(batch, xa, result, seed_i, root) -> None:
            record(batch, self.finish_batch(batch, xa, result, seed_i,
                                            trace=root, defer_pool=pool),
                   root)

        # batch 0's upload, before any batch; each later one's during the
        # batch before it
        dev = upload(0, rec) if batches else None
        if ahead_on and len(batches) > 1 and self._decode_ahead_enabled():
            prev = None     # (batch, xa, result, seed, root)
            for bi, batch in enumerate(batches):
                root = tracer.child(rec, "engine.batch", bi)
                with tracer.span(root, "engine.encode"):
                    xa = self.encode_batch(batch.audio, device_audio=dev,
                                           max_duration=longest(bi))
                with tracer.span(root, "engine.decode"):
                    result = self.decode_encoded(
                        xa, self.thresholds.temperatures[0], seed + bi * 131)
                dev = upload(bi + 1, root)
                if prev is not None:
                    finish(*prev)
                prev = (batch, xa, result, seed + bi * 131, root)
            finish(*prev)
        else:
            xa = None
            for bi, batch in enumerate(batches):
                root = tracer.child(rec, "engine.batch", bi)
                nxt = upload(bi + 1, root)
                ahead: dict = {}

                def encode_ahead(nxt=nxt, bi=bi, ahead=ahead,
                                 root=root) -> None:
                    if nxt is not None:
                        with tracer.span(root, "engine.encode", bi + 1):
                            ahead["xa"] = self.encode_batch(
                                device_audio=nxt,
                                max_duration=longest(bi + 1))

                segs = self.transcribe_batch(
                    batch, seed=seed + bi * 131, device_audio=dev,
                    device_xa=xa,
                    on_decode_dispatched=encode_ahead if ahead_on else None,
                    trace=root, defer_pool=pool)
                record(batch, segs, root)
                dev = nxt
                xa = ahead.get("xa")
        if pool:
            results.extend(self._retry_deferred(pool, seed))
        results.sort(key=lambda p: (p[0].scene_idx, p[0].group_idx))
        return results
