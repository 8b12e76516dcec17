"""The one traffic generator: a traffic file's parameters -> files of
decode windows.

A traffic file (``benchmark/traffic/<name>.json``) names a ``layout``
and its parameters; this module is the only code that reads them, so a
new mix is a new data file.

- ``vad_groups``: speech groups of ``group_s`` = [lo, hi] seconds
  (uniform), each one window, or packed as the port's ``pack_windows``
  packs them (``pack``: groups joined by ``gap_s`` of silence while the
  window stays within ``max_window_s``; one group alone stays as it is).
  A window covers the seconds of its groups (the gaps are not source
  audio).
- ``chunks``: fixed ``chunk_s`` windows hopping ``chunk_s - overlap_s``,
  as transformers mode cuts a file; a file covers ``hop * (n - 1) +
  chunk_s`` seconds.

Every file has the same window durations (drawn once from the traffic
file's ``layout_seed``), so every file and every seed carries the same
work; ``--seed`` draws the audio: a speech-like track (the port's
``tools/e2e_bench.synth_long_wav``, copied), from which set-up cuts
``variants`` versions of each window, and each file takes one version a
window, in a seeded order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

SR = 16_000
N_SAMPLES = 30 * SR


def speech_track(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """Speech-shaped audio: voiced bursts of 2-18 s (pitch contour and
    syllable-rate amplitude modulation over light noise) between pauses,
    with an occasional long silence (the body of the port's
    ``synth_long_wav``)."""
    total = int(seconds * SR)
    out = np.zeros(total, dtype=np.float32)
    pos = 0
    while pos < total:
        if rng.random() < 0.06:
            pos += int(rng.uniform(4.0, 9.0) * SR)
            continue
        dur = float(rng.uniform(2.0, 18.0))
        n = min(int(dur * SR), total - pos)
        if n <= 0:
            break
        t = np.arange(n) / SR
        f0 = rng.uniform(110.0, 240.0)
        f = f0 * (1.0 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.3, 1.2) * t))
        phase = 2 * np.pi * np.cumsum(f) / SR
        voiced = (np.sin(phase) + 0.5 * np.sin(2 * phase)
                  + 0.25 * np.sin(3 * phase))
        am = 0.55 + 0.45 * np.clip(
            np.sin(2 * np.pi * rng.uniform(2.5, 5.0) * t), 0.0, None)
        seg = 0.22 * voiced * am + 0.015 * rng.standard_normal(n)
        edge = min(480, n // 2)
        env = np.ones(n, dtype=np.float32)
        ramp = np.linspace(0.0, 1.0, edge, dtype=np.float32)
        env[:edge] = ramp
        env[-edge:] = ramp[::-1]
        out[pos:pos + n] = (seg * env).astype(np.float32)
        pos += n + int(rng.uniform(0.4, 3.0) * SR)
    return out


@dataclass(frozen=True)
class Slot:
    """One window of the layout: its groups' lengths in samples (one
    group, or several packed), the silence between them, and the source
    seconds it covers."""
    groups: tuple
    gap: int
    source_s: float

    @property
    def samples(self) -> int:
        return sum(self.groups) + self.gap * (len(self.groups) - 1)

    @property
    def duration(self) -> float:
        return self.samples / SR


def _pack(groups: Sequence[int], gap: int, cap: int, n: int) -> List[tuple]:
    """The first ``n`` windows that ``pack_windows`` makes of ``groups``
    (in samples): a group joins the open window while it stays within
    ``cap`` with the gap before it, else the window closes."""
    windows, cur, cur_len = [], [], 0
    for g in groups:
        extra = g + (gap if cur else 0)
        if cur and cur_len + extra > cap:
            windows.append(tuple(cur))
            if len(windows) == n:
                return windows
            cur, cur_len, extra = [], 0, g
        cur.append(g)
        cur_len += extra
    raise ValueError("not enough groups for the layout")


def layout(traffic: dict) -> List[Slot]:
    """The windows of one file, in the order they are drawn."""
    n = int(traffic["windows_per_file"])
    kind = traffic["layout"]
    if kind == "chunks":
        chunk = int(round(traffic["chunk_s"] * SR))
        hop = traffic["chunk_s"] - traffic["overlap_s"]
        # the last chunk covers its whole length, the others their hop
        return [Slot((chunk,), 0, traffic["chunk_s"] if i == n - 1 else hop)
                for i in range(n)]
    if kind != "vad_groups":
        raise ValueError(f"unknown traffic layout {kind!r}")
    rng = np.random.default_rng(int(traffic["layout_seed"]))
    lo, hi = traffic["group_s"]
    if not traffic.get("pack", False):
        lens = (rng.uniform(lo, hi, n) * SR).astype(int)
        return [Slot((int(g),), 0, g / SR) for g in lens]
    gap = int(round(traffic["gap_s"] * SR))
    cap = int(round(traffic["max_window_s"] * SR))
    per = max(1, int(cap // (lo * SR)))
    lens = (rng.uniform(lo, hi, n * per + 1) * SR).astype(int)
    return [Slot(tuple(int(g) for g in w), gap, sum(w) / SR)
            for w in _pack(lens, gap, cap, n)]


class Pool:
    """The audio of ``variants`` versions of every slot, made from
    ``seed`` at set-up and held in host memory."""

    def __init__(self, traffic: dict, seed: int):
        self.slots = layout(traffic)
        self.seed = seed
        rng = np.random.default_rng([seed, 1])
        self.track = speech_track(rng, float(traffic["track_s"]))
        variants = int(traffic["variants"])
        self.audio = [[self._cut(rng, slot) for _ in range(variants)]
                      for slot in self.slots]

    def _cut(self, rng: np.random.Generator, slot: Slot) -> np.ndarray:
        parts = []
        for i, g in enumerate(slot.groups):
            if i:
                parts.append(np.zeros(slot.gap, np.float32))
            start = int(rng.integers(0, len(self.track) - g))
            parts.append(self.track[start:start + g])
        return np.ascontiguousarray(np.concatenate(parts), np.float32)

    @property
    def source_s(self) -> float:
        """Source seconds one file covers."""
        return float(sum(s.source_s for s in self.slots))

    def file(self, index: int) -> List[tuple]:
        """File ``index``: (slot, audio) a window, one variant a slot, in
        a seeded order."""
        rng = np.random.default_rng([self.seed, 2, index])
        order = rng.permutation(len(self.slots))
        pick = rng.integers(0, len(self.audio[0]), len(self.slots))
        return [(self.slots[i], self.audio[i][pick[i]]) for i in order]


def batch_rows(durations: Sequence[float], batch: int) -> List[List[int]]:
    """The window indices of each batch as the engine forms them: stable
    sort by duration, then runs of ``batch``."""
    order = sorted(range(len(durations)), key=lambda i: durations[i])
    return [order[i:i + batch] for i in range(0, len(order), batch)]
