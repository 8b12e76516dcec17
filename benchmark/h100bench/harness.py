"""One run of one cell: set-up, the measured window (or one profiled
file), and the check that decides ``correct``.

The system under test is the port's
``TranscriptionEngine.transcribe_windows``, driven in a closed loop:
one file of windows after another, as the CLI runs a directory. The
harness builds the engine itself from the configuration file (the
values ``pipelines/factory.build_pipeline`` gives, with EOT suppressed,
the traffic's token budget and the first rung only), from weights drawn
on the device from the seed; the engine casts, fuses and quantises them
in its own set-up. Around ``decode_encoded`` it keeps the results the
window served and one row's encoder states a batch, for the check, and
in the profiled file the call's span on the decoding stream, for
``decode.step_ms``.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from h100bench import check, trace as tr, weights
from h100bench.traffic import Pool, batch_rows
from reference.whisper import prompt, specials

SEED_MOD = 2 ** 63
# rows of encoder states the window keeps for the check: a sample of
# KEPT_STATES drawn from ROWS_PER_CALL rows of each batch
KEPT_STATES = 64
ROWS_PER_CALL = 4


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


def windows_of(pool: Pool, index: int) -> list:
    from whisperjav_tpu_torch.parallel.batching import Window
    return [Window(audio=audio, abs_start=0.0, duration=slot.duration,
                   scene_idx=0, group_idx=i)
            for i, (slot, audio) in enumerate(pool.file(index))]


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


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             per_layer: Optional[dict] = None,
             reference_control: Optional[str] = None) -> dict:
    """One run: set-up, then files until ``seconds`` have passed (one
    file at least), or with ``trace`` one profiled file, then the check.
    ``per_layer`` maps metric names to readers; ``reference_control``
    also reads the reference one precision below in the program's place
    (for the calibration of the check)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, traffic = cell["config"], cell["traffic"]
    seed = int(seed) % SEED_MOD
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    tokens = int(traffic["tokens_per_window"])
    prompt_len = len(prompt(cfg["model"]["vocab_size"],
                            cfg["decode_options"]["language"]))
    pool = Pool(traffic, seed)
    engine = build_engine(cfg, tokens, seed, dev)
    departed = check.departures(cfg, engine)
    batch = engine.batch_size

    def steps(bucket: int) -> int:      # the engine's budget rule
        return min(tokens, bucket // 4 + 32)

    def file(index: int) -> tuple:
        """File ``index``: its windows, the source seconds of each, and
        the windows of each batch as the engine forms them."""
        pairs = pool.file(index)
        wins = windows_of(pool, index)
        return (wins, [pairs[w.group_idx][0].source_s for w in wins],
                batch_rows([w.duration for w in wins], batch))

    def pick(index: int, wins: list, layout: list) -> Callable[[int], list]:
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

    # warm-up: one file's shapes at a 2-token budget (every bucket, the
    # pipelined order, the kernels' build)
    options = engine.options
    engine.options = dataclasses.replace(options, max_new_tokens=2)
    engine.transcribe_windows(file(0)[0], seed=0)
    engine.options = options
    m = cfg["model"]
    rec = Recorder(engine, steps, KEPT_STATES, m["n_audio_ctx"],
                   m["d_model"], engine.compute_dtype, dev, seed)
    gc.collect()
    _sync(dev)
    setup_s = time.perf_counter() - t_start

    served: List[list] = []       # a file each: its windows and calls
    stretch = None
    # no collection pauses inside the window
    gc.freeze()
    gc.disable()
    t0 = time.perf_counter()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        os.environ["WJAV_TRACE_BATCHES"] = "1"
        rec.timed = True
        wins, source, layout = file(1)
        rec.pick = pick(1, wins, layout)
        # the CUDA activity only: recording every host op would slow the
        # host-bound decode loop (the CPU's activity where there is no
        # card, which gives no device spans)
        with profile(activities=[ProfilerActivity.CUDA if cuda
                                 else ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            out = engine.transcribe_windows(wins, seed=1)
            _sync(dev)
            wall = time.perf_counter() - t0
        served.append((wins, rec.calls, len(out), sum(source), layout))
        rows = [r for r in engine.batch_trace if "bucket" in r]
        stretch = tr.Stretch(
            spans=tr.device_spans(prof), wall_s=wall,
            batches=[{"bucket": r["bucket"], "rows": r["rows"],
                      "steps": steps(r["bucket"])} for r in rows],
            model=cfg["model"],
            decode={"beams": cfg["decode_options"]["beam_size"],
                    "prompt_len": prompt_len},
            decode_spans=rec.span_s())
        del prof
    else:
        index = 1
        while True:
            wins, source, layout = file(index)
            rec.calls, rec.pick = [], pick(index, wins, layout)
            out = engine.transcribe_windows(wins, seed=index)
            served.append((wins, rec.calls, len(out), sum(source), layout))
            index += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        wall = elapsed
    _sync(dev)
    gc.enable()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    attempted = sum(len(f[0]) for f in served)
    answered = sum(f[2] for f in served)
    source_s = sum(f[3] for f in served)
    # the program's state goes before the reference runs
    rec.states()
    host = [(f[0], [{"result": check.to_host(c["out"]),
                     "bucket": c["bucket"], "layout": f[4][j],
                     "states": c.get("states", {})}
                    for j, c in enumerate(f[1])]) for f in served]
    del engine, rec, served
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = check.judge(cell, host, seed, dev, departed, reference_control)
    out = {"correct": verdict["correct"], "attempted": attempted,
           "failed": attempted - answered}
    if trace:
        out["metrics"] = {
            name: {"value": value, "unit": mod.UNIT}
            for name, mod in (per_layer or {}).items()
            for value in [mod.read(stretch)] if value is not None}
        out["breakdown"] = {"device_ops": stretch.top_ops(),
                            "idle_gaps": stretch.idle_gaps()}
    else:
        out["metrics"] = {
            "audio_rtf": {"value": source_s / wall, "unit": "audio_s/s"},
            "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    out["device"] = {"memory_peak_bytes": peak}
    if trace:
        out["device"].update(busy_s=stretch.busy_s(), window_s=wall)
    out["checks"] = verdict["checks"]
    out["readings"] = verdict["readings"]
    if reference_control:
        out["control"] = verdict["control"]
    return out
