"""Qwen3-ASR through the port's ``QwenGenerator.generate_batch``, the
call the decoupled pipeline makes for a pass over scenes
(``modules/subtitle_pipeline/orchestrator.py:_pooled_pass``).

The driver draws the configuration's weights on the device from the
seed with the benchmark's own drawer (``h100bench/qwen_weights.py``),
at the precision the configuration states for the tower and the
embedding, loads them into the port's ``QwenASR``, puts them through
the generator's post-load step
(``components.prepare_params``: fused q/k/v, int8 LM matmuls and head),
and hands them to a ``QwenGenerator`` at the configuration's batch size
and repetition penalty. A file is one list of the traffic's scenes,
served by one ``generate_batch`` call with the generator's own budget
(12 tokens a second of the padded length).

While the window runs, the driver wraps the port's ``encode_audio`` and
``generate`` (module functions of ``models/qwen/model.py``, which
``generate_batch`` reaches at every call): of rows drawn from the seed
it keeps the audio embeddings the program computed, copied to pinned
host memory without a sync (a reservoir of ``SAMPLE_ROWS`` over the
files served), and each call's tokens, lengths and average
log-probabilities.

The check: the plain reference (``reference/qwen3_asr.py``), given the
weights drawn again from the seed, reads each kept row:

- ``audio_err``: the widest token's rms gap between the program's audio
  embeddings and the reference tower's on the row's padded audio, over
  the rms of the reference's (log-mel and the AuT tower);
- ``decoder_gap``: |the program's summed log-probability of the served
  tokens (``avg_logprob * (length + 1)``) - the reference LM's, reading
  the program's embeddings| over the length + 1, nats a token: the
  prefill, every step through the cache, the penalty and the head;
- ``logprob_gap``: the same against the reference's whole path from the
  audio;
- ``select_lead``: the widest lead, over a row's steps, of the
  reference's largest penalised logit over that of the token the
  program served, reading the program's embeddings, in nats: the
  greedy choice under the repetition penalty, which the two gaps do not
  see (a served token's log-probability is the same whichever token was
  best);
- ``departures``: the precisions the configuration states that the
  built program does not keep (:func:`departures`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from h100bench import qwen_weights
from h100bench.traffic import SR, Pool
from reference.qwen3_asr import CONTROLS, judge_rows  # noqa: F401
from roofline import qwen3_asr as counts
from whisperjav_tpu_torch.models.qwen import model as qwen_model
from whisperjav_tpu_torch.models.whisper.model import Int8Weight
from whisperjav_tpu_torch.modules.subtitle_pipeline.components import (
    QwenGenerator, prepare_params,
)

# rows the check reads, a reservoir over the rows each call offers
SAMPLE_ROWS = 16
ROWS_PER_CALL = 16
NUMBERS = ("audio_err", "decoder_gap", "logprob_gap", "select_lead",
           "departures")
# the program's own lower path: the tower, embedding and cache at bf16
PROGRAM_CONTROLS = ("bf16_weights",)
WRAPPED = ("encode_audio", "generate")


def sizes(cfg: dict):
    """The port's sizes of the configuration's model, which must be the
    configuration's ``model`` row."""
    m = cfg["model"]
    row = qwen_model.QWEN_SIZES[m["name"]]
    if dataclasses.asdict(row) != m:
        raise ValueError(f"the configuration's model is not the port's "
                         f"{m['name']!r}")
    return row


def draw(cfg: dict, seed: int, device, dtype) -> dict:
    """The model's weight tree from ``seed`` on ``device`` in ``dtype``
    (``h100bench/qwen_weights.py``), as a checkpoint is loaded: before
    the post-load step."""
    sizes(cfg)
    return qwen_weights.draw(cfg["model"], seed, device, dtype)


class Recorder:
    """Wraps the port's ``encode_audio`` and ``generate`` until
    :meth:`close`. Each ``encode_audio`` call opens a record (the file
    and call it serves, its padded samples); of the rows ``pick(call)``
    names, the embeddings go to slots of a pinned host buffer, a uniform
    sample of every row offered (a reservoir of ``slots`` drawn from
    ``seed``), copied without blocking; ``generate`` adds its result to
    the record."""

    def __init__(self, slots: int, tokens: int, width: int, device,
                 seed: int):
        self.cuda = torch.device(device).type == "cuda"
        self.host = torch.empty((slots, tokens, width), dtype=torch.float32,
                                pin_memory=self.cuda)
        self.owner: dict = {}       # slot -> (record, row, tokens)
        self.offered = 0
        self.rng = np.random.default_rng([seed, 7])
        self.file = 0
        self.pick: Callable[[int], list] = lambda call: []
        self.records: list = []
        self.inner = {name: getattr(qwen_model, name) for name in WRAPPED}
        for name in WRAPPED:
            setattr(qwen_model, name, getattr(self, name))

    def close(self) -> None:
        for name, fn in self.inner.items():
            setattr(qwen_model, name, fn)

    def _slot(self) -> Optional[int]:
        self.offered += 1
        if self.offered <= len(self.host):
            return self.offered - 1
        j = int(self.rng.integers(self.offered))
        return j if j < len(self.host) else None

    def encode_audio(self, model, mel):
        out = self.inner["encode_audio"](model, mel)
        call = sum(r["file"] == self.file for r in self.records)
        record = {"file": self.file, "call": call,
                  "samples": mel.shape[-1] * counts.HOP}
        self.records.append(record)
        for row in self.pick(call):
            slot = self._slot()
            if slot is None:
                continue
            self.host[slot, :out.shape[1]].copy_(out[row],
                                                 non_blocking=self.cuda)
            self.owner[slot] = (record, row, out.shape[1])
        return out

    def generate(self, *args, **kwargs):
        out = self.inner["generate"](*args, **kwargs)
        self.records[-1]["out"] = out
        return out


@dataclasses.dataclass
class Program:
    """The generator under test and what the driver keeps of its files:
    the clips of each file served."""
    cfg: dict
    seed: int
    device: torch.device
    pool: Pool
    gen: QwenGenerator
    rec: Optional[Recorder] = None
    files: dict = dataclasses.field(default_factory=dict)


def build(cell: dict, seed: int, device,
          control: Optional[str] = None) -> Program:
    """The traffic pool and the generator, as the configuration serves
    it (with ``control``, one of PROGRAM_CONTROLS, switched on)."""
    if control not in (None, *PROGRAM_CONTROLS):
        raise ValueError(f"unknown program control {control!r}")
    cfg = cell["config"]
    serve = cfg["serve"]
    dtype = (torch.bfloat16 if control == "bf16_weights"
             else getattr(torch, serve["weights"]))
    params = prepare_params(qwen_model.QwenASR(
        sizes(cfg), draw(cfg, seed, device, dtype)))
    gen = QwenGenerator(cfg["model"]["name"], params=params,
                        batch_size=serve["batch_size"],
                        repetition_penalty=serve["repetition_penalty"],
                        device=device)
    gen.load()
    return Program(cfg, seed, torch.device(device),
                   Pool(cell["traffic"], seed), gen)


def cache_dtype(program: Program) -> torch.dtype:
    """The type of the K/V cache the generator makes: one call on a
    second of silence at a one-token budget, with the port's
    ``LMCache.zeros`` wrapped to read what it was asked for."""
    made = []
    inner = qwen_model.LMCache.__dict__["zeros"]

    def zeros(*args, **kwargs):
        cache = inner.__func__(*args, **kwargs)
        made.append(cache.k.dtype)
        return cache
    gen = program.gen
    budget = gen.max_tokens
    qwen_model.LMCache.zeros = staticmethod(zeros)
    try:
        gen.max_tokens = 1
        gen.generate_batch([np.zeros(SR, np.float32)], SR)
    finally:
        gen.max_tokens = budget
        qwen_model.LMCache.zeros = inner
    (dtype,) = set(made)
    return dtype


def departures(program: Program) -> int:
    """The precisions the configuration states that the built program
    does not keep: the tower's and the embedding's, the cache the
    generator makes (:func:`cache_dtype`), q/k/v fused, the LM's
    matmuls and its head in int8."""
    serve, p = program.cfg["serve"], program.gen._params
    stated = getattr(torch, serve["weights"])
    blocks = p.blocks
    int8 = serve["lm_matmuls"] == "int8"
    return (int(any(t.dtype != stated for t in p.audio.parameters()))
            + int(p.tok_emb.dtype != stated)
            + int(cache_dtype(program) != getattr(torch, serve["kv_cache"]))
            + int(("wqkv" in blocks) != (serve["qkv"] == "fused"))
            + int(any(isinstance(blocks[n], Int8Weight) != int8
                      for n in ("wqkv", "wq", "wk", "wv", "wo", "w_gate",
                                "w_up", "w_down") if n in blocks))
            + int(("lm_head_q" in p) != (serve["lm_head"] == "int8")))


def warm_up(program: Program) -> None:
    """One file's shape at a 2-token budget, then the recorder around
    the port's ``encode_audio`` and ``generate``."""
    gen = program.gen
    budget = gen.max_tokens
    gen.max_tokens = 2
    gen.generate_batch(file(program, 0)[1], SR)
    gen.max_tokens = budget
    samples = max(s.samples for s in program.pool.slots)
    unit = gen.cfg.mel_multiple * counts.HOP
    tokens = gen.cfg.audio_tokens_for(-(-samples // unit) * unit
                                      // counts.HOP)
    program.rec = Recorder(SAMPLE_ROWS, tokens, gen.cfg.d_model,
                           program.device, program.seed)


def file(program: Program, index: int) -> tuple:
    """File ``index``: (index, its clips, the source seconds of each, the
    rows it offers the check of each call)."""
    pairs = program.pool.file(index)
    clips = [audio for _, audio in pairs]
    batch = program.gen.batch_size

    def pick(call: int) -> list:
        rows = min(batch, len(clips) - call * batch)
        rng = np.random.default_rng([program.seed, 5, index, call])
        return [int(r) for r in rng.permutation(rows)[:ROWS_PER_CALL]]
    return index, clips, [slot.source_s for slot, _ in pairs], pick


def serve(program: Program, inputs: tuple, timed: bool = False) -> tuple:
    """Generate one :func:`file`; (its source seconds, clips attempted,
    clips answered)."""
    index, clips, source, pick = inputs
    rec = program.rec
    rec.file, rec.pick = index, pick
    program.files[index] = clips
    out = program.gen.generate_batch(clips, SR)
    return sum(source), len(clips), len(out)


def _rows(program: Program, record: dict) -> list:
    """(clip, length, avg_logprob) of a call's rows, on the host."""
    batch = program.gen.batch_size
    clips = program.files[record["file"]]
    res = record["out"]
    start = record["call"] * batch
    n = min(batch, len(clips) - start)
    lens = res.length[:n].cpu().numpy()
    lps = res.avg_logprob[:n].cpu().numpy()
    return [(clips[start + r], int(lens[r]), float(lps[r]))
            for r in range(n)]


def stretch(program: Program) -> dict:
    """The profiled file's :class:`Stretch` fields: a batch each call
    (``rows``, and each row's own prefix positions and steps, counted
    at its own length), the model's sizes and the cache's bytes an
    element, the model's operations (``roofline/qwen3_asr.row_flops`` a
    row) and the rows; after a sync."""
    m = program.cfg["model"]
    last = max(program.files)
    batches, flops = [], 0.0
    for record in program.rec.records:
        if record["file"] != last:
            continue
        budget = record["out"].tokens.shape[1]
        rows = _rows(program, record)
        steps = [min(n + 1, budget) for _, n, _ in rows]
        batches.append({
            "rows": len(rows),
            "prefix": [counts.audio_tokens(m, len(c)) + 1 for c, _, _ in rows],
            "steps": steps})
        flops += sum(counts.row_flops(m, len(c), s)
                     for (c, _, _), s in zip(rows, steps))
    itemsize = getattr(torch, program.cfg["serve"]["kv_cache"]).itemsize
    return {"batches": batches, "model": m,
            "decode": {"kv_itemsize": itemsize}, "model_flops": flops,
            "rows": sum(b["rows"] for b in batches)}


def kept(program: Program) -> List[dict]:
    """The rows the check reads, on the host; after a sync. Each: its
    padded audio, the tokens it served to the first EOS (that included),
    its length and average log-probability, and the program's audio
    embeddings of it."""
    rec = program.rec
    rec.close()
    out = []
    for slot, (record, row, tokens) in sorted(rec.owner.items()):
        clip, n, avg = _rows(program, record)[row]
        res = record["out"]
        budget = res.tokens.shape[1]
        audio = np.zeros(record["samples"], np.float32)
        audio[:len(clip)] = clip
        out.append({
            "audio": audio, "length": n, "avg_logprob": avg,
            "tokens": res.tokens[row, :min(n + 1, budget)].cpu().numpy(),
            "embedding": rec.host[slot, :tokens].clone()})
    return out


def judge(cell: dict, rows: list, seed: int, device, departed: int = 0,
          control: Optional[str] = None) -> tuple:
    """(readings, the control's readings or None) of the rows
    :func:`kept` gives; ``departed`` is the program's
    :func:`departures`. With ``control`` (``CONTROLS``) it also reads
    the reference one precision lower in the program's place."""
    cfg = cell["config"]
    tree = draw(cfg, seed, device, getattr(torch, cfg["serve"]["weights"]))
    ref = judge_rows(tree, cfg["model"], [r["audio"] for r in rows],
                     [r["tokens"] for r in rows],
                     [r["embedding"] for r in rows], device,
                     cfg["serve"]["repetition_penalty"], control)
    del tree
    readings = {k: [] for k in NUMBERS}
    readings["departures"].append(departed)
    lows = {k: [] for k in NUMBERS}
    lows["departures"].append(0)
    for r, got in zip(rows, ref):
        scored = r["length"] + 1.0
        total = r["avg_logprob"] * scored
        readings["audio_err"].append(got["audio_err"])
        readings["decoder_gap"].append(abs(total - got["decoder"]) / scored)
        readings["logprob_gap"].append(abs(total - got["full"]) / scored)
        readings["select_lead"].append(got["lead"])
        if control:
            low = got["control"]
            lows["audio_err"].append(low["audio_err"])
            lows["decoder_gap"].append(
                abs(low["decoder"] - got["decoder"]) / scored)
            lows["logprob_gap"].append(abs(low["full"] - got["full"])
                                       / scored)
            lows["select_lead"].append(low["lead"])
    return readings, (lows if control else None)
