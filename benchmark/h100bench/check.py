"""The check that decides ``correct``: a sample of the rows the window
served, judged by the plain reference.

The harness keeps the encoder states the program decoded from of a
sample of the window's rows (copied to the host; rows drawn from the
seed, and a file's longest window). Of those rows ``SAMPLE_ROWS`` are
drawn from the seed, the longest window among them, and the reference encodes each row's audio afresh and runs its
decoder teacher-forced along the tokens the program served, with the
decode options' logit rules. The numbers compared, each the widest over
the sample against its limit in ``workloads/<cell>.json`` (a cell
compares those it gives a limit):

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
``decoder_gap`` and ``logprob_gap`` read every step of the row. Where the timestamp rule's margin lies
within ``MARGIN_TOL`` of its threshold the program may have taken
either branch, and the reference takes, for each such step, the branch
that brings its sum nearest the program's. A served token that no
branch allows reads infinite.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from h100bench import weights
from reference.whisper import bucket as ref_bucket, judge_rows, specials

SAMPLE_ROWS = 16
# how near its threshold, in nats, the timestamp rule's margin may lie
# for the reference to let either branch stand (see reference.along):
# sound runs took the other branch at margins up to 0.027 (PERF.md)
MARGIN_TOL = 0.1
# a reading the JSON line can hold where a served token was forbidden
NOT_A_NUMBER = 1e30
NUMBERS = ("encoder_err", "decoder_gap", "logprob_gap", "departures")


def departures(cfg: dict, engine) -> int:
    """The precisions the configuration states that the built engine
    does not keep: its compute dtype, int8 decoder weights or none, and
    int8 cross-K/V (not int4) as the decode options say."""
    serve, opts = cfg["serve"], engine.options
    int8 = any(p.dtype == torch.int8
               for p in engine.model.decoder.parameters())
    return (int(engine.compute_dtype != getattr(torch,
                                                serve["compute_dtype"]))
            + int(int8 != serve["int8_weights"])
            + int(bool(opts.cross_kv_int8)
                  != cfg["decode_options"]["cross_kv_int8"])
            + int(bool(opts.cross_kv_int4)))


def to_host(result) -> dict:
    """One ``decode_encoded`` result on the host."""
    return {name: getattr(result, name).detach().cpu().numpy()
            for name in ("tokens", "length", "sum_logprob")}


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


def _verdict(readings: dict, limits: dict) -> tuple:
    checks, correct = {}, True
    for name, limit in limits.items():
        worst = float(np.max(readings[name]))
        if not np.isfinite(worst):
            worst = NOT_A_NUMBER
        checks[name] = {"value": worst, "limit": limit}
        correct &= limit is not None and worst <= limit
    return bool(correct), checks


def judge(cell: dict, served: list, seed: int, device, departed: int = 0,
          control: Optional[str] = None) -> dict:
    """Readings and verdict for the rows ``served``: a file each, its
    windows and, a ``decode_encoded`` call each, a dict of the call's
    host results (``result``), its bucket, the window index of each
    batch row (``layout``) and the encoder states kept of some rows
    (``states``: row -> tensor); ``departed`` is the engine's
    :func:`departures`. With ``control``
    (``reference.whisper.CONTROLS``) it also reads the control, the
    reference computed one precision lower in the program's place on the
    same rows, and judges it by the same limits (``control``)."""
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
    limits = cell.get("limits", {})
    correct, checks = _verdict(readings, limits)
    out = {"correct": correct, "checks": checks,
           "readings": _finite(readings)}
    if control:
        low_correct, low_checks = _verdict(lows, limits)
        out["control"] = {"name": control, "correct": low_correct,
                          "checks": low_checks, "readings": _finite(lows)}
    return out


def _finite(readings: dict) -> dict:
    return {k: [float(x) if np.isfinite(x) else NOT_A_NUMBER for x in v]
            for k, v in readings.items()}


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
