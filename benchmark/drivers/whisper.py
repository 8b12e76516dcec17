"""Whisper through the port's ``TranscriptionEngine.transcribe_windows``.

The driver builds the engine itself from the configuration file (the
values ``pipelines/factory.build_pipeline`` gives, with EOT suppressed,
the traffic's token budget and the first rung only), from weights drawn
on the device from the seed; the engine casts, fuses and quantises them
in its own set-up. A file is one list of the traffic's windows, served
as the CLI serves a directory's file. Around ``decode_encoded`` the
driver keeps the results the window served and one row's encoder states
a batch, for the check, and in the profiled file the call's span on the
decoding stream, for ``decode.step_ms``.

The check: of the rows whose encoder states were kept (rows drawn from
the seed, and a file's longest window), ``SAMPLE_ROWS`` are drawn from
the seed, the longest window among them, and the plain reference
(``reference/whisper.py``) encodes each row's audio afresh and runs its
decoder teacher-forced along the tokens the program served, with the
decode options' logit rules. The numbers it reads, each a reading a
row:

- ``encoder_err``: the widest frame's rms gap between the program's
  encoder states and the reference's, over the rms of the reference's
  (log-mel, the encoder, Kernel A);
- ``decoder_gap``: |the program's summed log-probability of a row's
  served tokens - the reference decoder's, reading the program's encoder
  states| over the tokens + 1 (as the program averages), nats a token:
  the decoder's stage by itself (the cross-K/V, every decoder layer,
  Kernel B, the head);
- ``logprob_gap``: the same against the reference's whole path from the
  audio;
- ``departures``: how many of the precisions the configuration states
  the engine the window ran does not keep (:func:`departures`), limit 0.

Beam search serves each row's summed log-probability, so
``decoder_gap`` and ``logprob_gap`` read every step of the row. Where the
timestamp rule's margin lies within ``MARGIN_TOL`` of its threshold the
program may have taken either branch, and the reference takes, for each
such step, the branch that brings its sum nearest the program's. A
served token that no branch allows reads infinite.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from h100bench import weights
from h100bench.traffic import Pool, batch_rows
from reference.whisper import (  # noqa: F401 (CONTROLS: the driver's)
    CONTROLS, bucket as ref_bucket, judge_rows, prompt, specials,
)
from roofline import model_flops

# rows of encoder states the window keeps for the check: a sample of
# KEPT_STATES drawn from ROWS_PER_CALL rows of each batch
KEPT_STATES = 64
ROWS_PER_CALL = 4
SAMPLE_ROWS = 16
# how near its threshold, in nats, the timestamp rule's margin may lie
# for the reference to let either branch stand (see reference.along):
# sound runs took the other branch at margins up to 0.027 (PERF.md)
MARGIN_TOL = 0.1
NUMBERS = ("encoder_err", "decoder_gap", "logprob_gap", "departures")
# the program's own lower-precision paths: int8 decoder weights, int4
# cross-K/V (the reference's are reference.whisper.CONTROLS)
PROGRAM_CONTROLS = ("int8_weights", "int4_cross_kv")


def whisper_config(cfg: dict):
    from whisperjav_tpu_torch.models.whisper.config import WhisperConfig
    m = cfg["model"]
    return WhisperConfig(
        name=cfg["name"], n_mels=m["n_mels"], n_audio_ctx=m["n_audio_ctx"],
        n_audio_state=m["d_model"], n_audio_head=m["attention_heads"],
        n_audio_layer=m["encoder_layers"], n_vocab=m["vocab_size"],
        n_text_ctx=m["n_text_ctx"], n_text_state=m["d_model"],
        n_text_head=m["attention_heads"],
        n_text_layer=m["decoder_layers"])


def decode_options(cfg: dict, tokens: int):
    """The configuration's decode options with EOT suppressed and the
    traffic's budget."""
    from whisperjav_tpu_torch.models.whisper.decode import DecodeOptions
    opts = {k: v for k, v in cfg["decode_options"].items() if k != "source"}
    eot = specials(cfg["model"]["vocab_size"])["eot"]
    return DecodeOptions(
        **opts, suppress_tokens=tuple(cfg["suppress_tokens"]) + (eot,),
        max_new_tokens=tokens)


def build_engine(cfg: dict, tokens: int, seed: int, device):
    """The engine over weights drawn from ``seed`` on ``device``, as the
    configuration serves it."""
    from whisperjav_tpu_torch.models.whisper.model import Whisper
    from whisperjav_tpu_torch.pipelines.engine import (
        QualityThresholds, TranscriptionEngine,
    )
    serve = cfg["serve"]
    dtype = getattr(torch, serve["compute_dtype"])
    th = {k: v for k, v in cfg["thresholds"].items() if k != "source"}
    config = whisper_config(cfg)
    # the tree is not kept: the engine frees what it replaces
    model = Whisper(config, weights.draw(cfg["model"], seed, device, dtype))
    return TranscriptionEngine(
        config, model, options=decode_options(cfg, tokens),
        thresholds=QualityThresholds(**th, temperatures=(0.0,)),
        batch_size=serve["batch_size"], device=device, compute_dtype=dtype,
        int8_weights=serve["int8_weights"])


def switched_on(cfg: dict, control: Optional[str]) -> dict:
    """The configuration with the program's own lower path ``control``
    (one of PROGRAM_CONTROLS) switched on; as stated without one."""
    if control is None:
        return cfg
    if control not in PROGRAM_CONTROLS:
        raise ValueError(f"unknown program control {control!r}")
    cfg = copy.deepcopy(cfg)
    if control == "int8_weights":
        cfg["serve"]["int8_weights"] = True
    else:
        cfg["decode_options"]["cross_kv_int4"] = True
    return cfg


def windows_of(pairs: list) -> list:
    from whisperjav_tpu_torch.parallel.batching import Window
    return [Window(audio=audio, abs_start=0.0, duration=slot.duration,
                   scene_idx=0, group_idx=i)
            for i, (slot, audio) in enumerate(pairs)]


class Recorder:
    """Wraps the engine's ``decode_encoded``. Of each call (in call
    order, which is batch order) it keeps the results and, for the
    check, the encoder states of the batch rows ``pick(call)`` names,
    each copied to a slot of a pinned host buffer without blocking
    behind the encode: the first row marked longest to a slot of its
    own, the others to a uniform sample of all of them drawn from
    ``seed`` (a reservoir of ``slots``). With ``timed`` it also keeps
    the call's span on the decoding stream, from the encode being done
    to the decode being done, by CUDA events (no sync), with the steps
    it ran."""

    def __init__(self, engine, steps: Callable[[int], int], slots: int,
                 frames: int, width: int, dtype, device, seed: int):
        self.inner = engine.decode_encoded
        self.steps = steps
        self.cuda = torch.device(device).type == "cuda"
        self.host = torch.empty((slots + 1, frames, width), dtype=dtype,
                                pin_memory=self.cuda)
        self.owner: dict = {}        # slot -> (call's record, row)
        self.seen = 0
        self.rng = np.random.default_rng([seed, 7])
        self.timed = False
        self.pick: Callable[[int], list] = lambda call: []
        self.calls: list = []
        self.spans: list = []
        engine.decode_encoded = self

    def _slot(self, longest: bool) -> Optional[int]:
        last = len(self.host) - 1
        if longest and last not in self.owner:
            return last
        self.seen += 1
        if self.seen <= last:
            return self.seen - 1
        j = int(self.rng.integers(self.seen))
        return j if j < last else None

    def __call__(self, xa, temperature: float = 0.0, seed: int = 0):
        part = xa[0] if isinstance(xa, tuple) else xa
        ready = getattr(xa, "ready", (None,))[0]
        bucket = int(part.shape[1])
        record = {"bucket": bucket}
        if self.cuda:
            stream = torch.cuda.current_stream(part.device)
            if ready is not None:
                stream.wait_event(ready)
                part.record_stream(stream)
        for row, longest in self.pick(len(self.calls)):
            slot = self._slot(longest)
            if slot is None:
                continue
            self.host[slot, :bucket].copy_(part[row], non_blocking=self.cuda)
            self.owner[slot] = (record, row)
        if self.timed and self.cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record(stream)
        t0 = time.perf_counter()
        out = self.inner(xa, temperature, seed)
        if self.timed:
            if self.cuda:
                end.record(stream)
                self.spans.append(((start, end), self.steps(bucket)))
            else:
                self.spans.append((time.perf_counter() - t0,
                                   self.steps(bucket)))
        record["out"] = out
        self.calls.append(record)
        return out

    def states(self) -> None:
        """Give each call's record the states kept of its rows
        (``states``: row -> host tensor); after a sync."""
        for slot, (record, row) in self.owner.items():
            record.setdefault("states", {})[row] = \
                self.host[slot, :record["bucket"]]

    def span_s(self) -> list:
        """(seconds, steps) of each timed call; after a sync."""
        return [(span if isinstance(span, float)
                 else span[0].elapsed_time(span[1]) / 1e3, steps)
                for span, steps in self.spans]


@dataclasses.dataclass
class Program:
    """The engine under test and what the driver keeps of its files:
    a file served each, its windows, the ``decode_encoded`` calls'
    records and the window index of each batch row."""
    cfg: dict
    seed: int
    device: torch.device
    tokens: int
    prompt_len: int
    pool: Pool
    engine: object
    rec: Optional[Recorder] = None
    files: List[tuple] = dataclasses.field(default_factory=list)

    def steps(self, bucket: int) -> int:      # the engine's budget rule
        return min(self.tokens, bucket // 4 + 32)


def build(cell: dict, seed: int, device,
          control: Optional[str] = None) -> Program:
    """The traffic pool and the engine, as the configuration serves it
    (with ``control``, one of PROGRAM_CONTROLS, switched on)."""
    cfg, traffic = cell["config"], cell["traffic"]
    tokens = int(traffic["tokens_per_window"])
    prompt_len = len(prompt(cfg["model"]["vocab_size"],
                            cfg["decode_options"]["language"]))
    pool = Pool(traffic, seed)
    engine = build_engine(switched_on(cfg, control), tokens, seed, device)
    return Program(cfg, seed, device, tokens, prompt_len, pool, engine)


def departures(program: Program) -> int:
    """The precisions the configuration states that the built engine
    does not keep: its compute dtype, int8 decoder weights or none, and
    int8 cross-K/V (not int4) as the decode options say."""
    cfg, engine = program.cfg, program.engine
    serve, opts = cfg["serve"], engine.options
    int8 = any(p.dtype == torch.int8
               for p in engine.model.decoder.parameters())
    return (int(engine.compute_dtype != getattr(torch,
                                                serve["compute_dtype"]))
            + int(int8 != serve["int8_weights"])
            + int(bool(opts.cross_kv_int8)
                  != cfg["decode_options"]["cross_kv_int8"])
            + int(bool(opts.cross_kv_int4)))


def warm_up(program: Program) -> None:
    """One file's shapes at a 2-token budget (every bucket, the
    pipelined order, the kernels' build), then the recorder around
    ``decode_encoded``."""
    engine = program.engine
    options = engine.options
    engine.options = dataclasses.replace(options, max_new_tokens=2)
    engine.transcribe_windows(file(program, 0)[1], seed=0)
    engine.options = options
    m = program.cfg["model"]
    program.rec = Recorder(engine, program.steps, KEPT_STATES,
                           m["n_audio_ctx"], m["d_model"],
                           engine.compute_dtype, program.device,
                           program.seed)


def file(program: Program, index: int) -> tuple:
    """File ``index``: (index, its windows, the source seconds of each,
    the windows of each batch as the engine forms them, and the batch
    rows it offers the check of each call)."""
    pairs = program.pool.file(index)
    wins = windows_of(pairs)
    layout = batch_rows([w.duration for w in wins],
                        program.engine.batch_size)
    return (index, wins, [slot.source_s for slot, _ in pairs], layout,
            _pick(program.seed, index, wins, layout))


def _pick(seed: int, index: int, wins: list,
          layout: list) -> Callable[[int], list]:
    """The batch rows file ``index`` offers the check of each call,
    (row, longest): its longest window's, and rows drawn from the
    seed."""
    longest = max(range(len(wins)), key=lambda i: wins[i].duration)

    def rows(call: int) -> list:
        batch = layout[call]
        rng = np.random.default_rng([seed, 5, index, call])
        drawn = rng.permutation(len(batch))[:ROWS_PER_CALL]
        first = [batch.index(longest)] if longest in batch else []
        return [(r, True) for r in first] + [
            (int(r), False) for r in drawn if r not in first]
    return rows


def serve(program: Program, inputs: tuple, timed: bool = False) -> tuple:
    """Transcribe one :func:`file`; (its source seconds, windows
    attempted, windows answered). ``timed`` keeps each call's span."""
    index, wins, source, layout, pick = inputs
    rec = program.rec
    rec.timed = timed
    rec.calls, rec.pick = [], pick
    out = program.engine.transcribe_windows(wins, seed=index)
    program.files.append((wins, rec.calls, layout))
    return sum(source), len(wins), len(out)


def stretch(program: Program) -> dict:
    """The profiled file's :class:`Stretch` fields: its batches as
    (bucket, rows, steps), the model's and decode's numbers, each
    ``decode_encoded`` call's span, the model's operations for the
    file's work (``roofline/model_flops.batch`` a batch) and its rows;
    after a sync."""
    cfg = program.cfg
    batches = [{"bucket": r["bucket"], "rows": r["rows"],
                "steps": program.steps(r["bucket"])}
               for r in program.engine.batch_trace if "bucket" in r]
    decode = {"beams": cfg["decode_options"]["beam_size"],
              "prompt_len": program.prompt_len}
    return {"batches": batches, "model": cfg["model"], "decode": decode,
            "decode_spans": program.rec.span_s(),
            "model_flops": sum(
                model_flops.batch(cfg["model"], b["bucket"], b["rows"],
                                  decode["beams"], b["steps"],
                                  decode["prompt_len"]) for b in batches),
            "rows": sum(b["rows"] for b in batches)}


def to_host(result) -> dict:
    """One ``decode_encoded`` result on the host."""
    return {name: getattr(result, name).detach().cpu().numpy()
            for name in ("tokens", "length", "sum_logprob")}


def kept(program: Program) -> list:
    """What the check keeps of the files served, on the host; after a
    sync. A file each: its windows and, a ``decode_encoded`` call each,
    a dict of the call's host results (``result``), its bucket, the
    window index of each batch row (``layout``) and the encoder states
    kept of some rows (``states``: row -> tensor)."""
    program.rec.states()
    return [(wins, [{"result": to_host(c["out"]), "bucket": c["bucket"],
                     "layout": layout[j], "states": c.get("states", {})}
                    for j, c in enumerate(calls)])
            for wins, calls, layout in program.files]


def sample(served: list, seed: int, n: int = SAMPLE_ROWS) -> List[tuple]:
    """(file, call, row) of ``n`` of the rows whose encoder states were
    kept, drawn from the seed, the longest window among them."""
    cands, longest = [], None
    for f, (wins, calls) in enumerate(served):
        for j, call in enumerate(calls):
            for r in sorted(call["states"]):
                cands.append((f, j, r))
                duration = wins[call["layout"][r]].duration
                if longest is None or duration > longest[0]:
                    longest = (duration, (f, j, r))
    rng = np.random.default_rng([seed, 3])
    pick = [cands[i] for i in rng.permutation(len(cands))[:n]]
    if longest is not None and longest[1] not in pick:
        pick[-1] = longest[1]
    return sorted(pick)


def _gap(total: float, row: dict, n: int, crossed: list) -> float:
    """|``total`` - the reference's sum, its open branches taken as
    brings it nearest| over the tokens + 1; the margins of the open
    steps so taken go to ``crossed``."""
    rest = total - row["sum"]
    picked = closest_subset([d for d, _ in row["open"]], rest)
    crossed.extend(row["open"][i][1] for i in picked)
    taken = sum(row["open"][i][0] for i in picked)
    return abs(rest - taken) / (n + 1.0)


def judge(cell: dict, served: list, seed: int, device, departed: int = 0,
          control: Optional[str] = None) -> tuple:
    """(readings, the control's readings or None) of the rows
    ``served`` (:func:`kept`); ``departed`` is the engine's
    :func:`departures`. With ``control`` (``CONTROLS``) it also reads
    the control: the reference computed one precision lower in the
    program's place on the same rows."""
    cfg = cell["config"]
    rows = sample(served, seed)
    audio, buckets, tokens, states, prog = [], [], [], [], []
    for f, j, r in rows:
        wins, calls = served[f]
        call = calls[j]
        res, bucket = call["result"], call["bucket"]
        longest = max(wins[i].duration for i in call["layout"])
        if ref_bucket(longest) != bucket:
            raise RuntimeError(f"call {j} of file {f} ran bucket {bucket}, "
                               f"its windows need {ref_bucket(longest)}")
        audio.append(wins[call["layout"][r]].audio)
        buckets.append(bucket)
        states.append(call["states"][r])
        n = int(res["length"][r])
        tokens.append(np.asarray(res["tokens"][r][:n]))
        prog.append((float(res["sum_logprob"][r]), n))
    tree = weights.draw(cfg["model"], seed, device,
                        getattr(torch, cfg["serve"]["compute_dtype"]))
    options = {**cfg["decode_options"],
               "suppress_tokens": cfg["suppress_tokens"]
               + [specials(cfg["model"]["vocab_size"])["eot"]]}
    ref = judge_rows(tree, cfg["model"], options, audio, buckets, tokens,
                     states, device,
                     int8_weights=cfg["serve"]["int8_weights"],
                     margin_tol=MARGIN_TOL, control=control)
    del tree
    readings = {k: [] for k in NUMBERS + ("open_steps", "crossed")}
    readings["departures"].append(departed)
    lows = {k: [] for k in NUMBERS}
    lows["departures"].append(0)
    for (total, n), row in zip(prog, ref):
        readings["encoder_err"].append(row["encoder_err"])
        crossed = readings["crossed"]
        readings["decoder_gap"].append(_gap(total, row["decoder"], n,
                                            crossed))
        readings["logprob_gap"].append(_gap(total, row["full"], n, crossed))
        readings["open_steps"].append(len(row["full"]["open"])
                                      + len(row["decoder"]["open"]))
        crossed.extend(row["full"]["crossed"] + row["decoder"]["crossed"])
        if control:
            low = row["control"]
            lows["encoder_err"].append(low["encoder_err"])
            lows["decoder_gap"].append(_gap(low["decoder"], row["decoder"],
                                            n, []))
            lows["logprob_gap"].append(_gap(low["full"], row["full"], n, []))
    return readings, (lows if control else None)


def closest_subset(deltas: List[float], target: float) -> List[int]:
    """The indices of the subset of ``deltas`` whose sum is nearest
    ``target`` (every subset up to 2^14 of them, else greedily, largest
    first)."""
    if len(deltas) <= 14:
        sums = np.zeros(1)
        for d in deltas:
            sums = np.concatenate([sums, sums + d])
        best = int(np.argmin(np.abs(sums - target)))
        return [i for i in range(len(deltas)) if best >> i & 1]
    picked, total = [], 0.0
    for i in sorted(range(len(deltas)), key=lambda i: -abs(deltas[i])):
        if abs(target - total - deltas[i]) < abs(target - total):
            picked.append(i)
            total += deltas[i]
    return sorted(picked)
