"""Reconstruction: regroup timestamped words into subtitle segments.

Full parity with the reference's stable-ts regroup algebra (reference:
whisperjav/modules/subtitle_pipeline/reconstruction.py:62-104),
re-implemented as ordered passes over the word list (no stable-ts
dependency):

REGROUP_JAV (STANDARD mode) =
    split at sentence-ending punctuation (。？?！!…)
    → split at gaps ≥ 1.5 s
    → merge fragments (gap < 1.5 s, combined < 80 chars)
    → split at commas (、，,) when the cue exceeds 50 chars
    → split when > 80 chars
    → split when > 8 s
    → clamp boundaries monotonic.

REGROUP_VAD_ONLY / SENTENCE_ONLY drop the two gap-based passes
(synthetic proportional timestamps don't reflect audio gaps —
reference's Branch-B rationale). OFF keeps one cue per word run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from whisperjav_tpu_torch.modules.srt import Subtitle
from whisperjav_tpu_torch.modules.subtitle_pipeline.types import (
    RegroupMode, WordTimestamp,
)

SENTENCE_END = "。！？!?…"
CLAUSE_END = "、，,"

Group = List[WordTimestamp]


@dataclass
class RegroupConfig:
    gap_split_s: float = 1.5          # sg=1.5
    merge_gap_s: float = 1.5          # mg=1.5++80+1
    merge_max_chars: int = 80
    comma_split_over_chars: int = 50  # sp=,* /，/、++++50
    max_cue_chars: int = 80           # sl=80
    max_cue_duration_s: float = 8.0   # sd=8


def _chars(g: Group) -> int:
    return sum(len(w.word) for w in g)


def _split_after_punct(groups: List[Group], punct: str) -> List[Group]:
    out: List[Group] = []
    for g in groups:
        cur: Group = []
        for w in g:
            cur.append(w)
            if w.word and w.word.rstrip()[-1:] in punct:
                out.append(cur)
                cur = []
        if cur:
            out.append(cur)
    return out


def _split_at_gaps(groups: List[Group], gap_s: float) -> List[Group]:
    out: List[Group] = []
    for g in groups:
        cur = [g[0]]
        for prev, w in zip(g[:-1], g[1:]):
            if w.start - prev.end >= gap_s:
                out.append(cur)
                cur = [w]
            else:
                cur.append(w)
        out.append(cur)
    return out


def _merge_fragments(groups: List[Group], gap_s: float,
                     max_chars: int) -> List[Group]:
    out: List[Group] = []
    for g in groups:
        if (out
                and g[0].start - out[-1][-1].end < gap_s
                and _chars(out[-1]) + _chars(g) < max_chars
                and not (out[-1][-1].word
                         and out[-1][-1].word.rstrip()[-1:]
                         in SENTENCE_END)):
            out[-1] = out[-1] + g
        else:
            out.append(g)
    return out


def _split_commas_when_long(groups: List[Group], over_chars: int
                            ) -> List[Group]:
    out: List[Group] = []
    for g in groups:
        if _chars(g) <= over_chars:
            out.append(g)
            continue
        cur: Group = []
        for w in g:
            cur.append(w)
            if w.word and w.word.rstrip()[-1:] in CLAUSE_END:
                out.append(cur)
                cur = []
        if cur:
            out.append(cur)
    return out


def _split_by_chars(groups: List[Group], max_chars: int) -> List[Group]:
    out: List[Group] = []
    for g in groups:
        cur: Group = []
        for w in g:
            if cur and _chars(cur) + len(w.word) > max_chars:
                out.append(cur)
                cur = []
            cur.append(w)
        if cur:
            out.append(cur)
    return out


def _split_by_duration(groups: List[Group], max_s: float) -> List[Group]:
    out: List[Group] = []
    for g in groups:
        cur: Group = [g[0]]
        for w in g[1:]:
            if w.end - cur[0].start > max_s:
                out.append(cur)
                cur = [w]
            else:
                cur.append(w)
        out.append(cur)
    return out


def regroup_words(
    words: Sequence[WordTimestamp],
    mode: RegroupMode = RegroupMode.STANDARD,
    config: RegroupConfig = RegroupConfig(),
) -> List[Subtitle]:
    """Words → cues via the REGROUP_JAV pass sequence (see module doc)."""
    ws = [w for w in words
          if w.start is not None and w.end is not None and w.word]
    if not ws:
        return []

    groups: List[Group] = [list(ws)]
    if mode != RegroupMode.OFF:
        groups = _split_after_punct(groups, SENTENCE_END)
        if mode == RegroupMode.STANDARD:
            groups = _split_at_gaps(groups, config.gap_split_s)
            groups = _merge_fragments(groups, config.merge_gap_s,
                                      config.merge_max_chars)
        groups = _split_commas_when_long(groups,
                                         config.comma_split_over_chars)
        groups = _split_by_chars(groups, config.max_cue_chars)
        groups = _split_by_duration(groups, config.max_cue_duration_s)

    cues = [Subtitle(0, g[0].start, g[-1].end,
                     "".join(x.word for x in g)) for g in groups if g]
    # clamp boundaries monotonic (cm)
    for prev, c in zip(cues[:-1], cues[1:]):
        if c.start < prev.end:
            c.start = prev.end
        if c.end < c.start:
            c.end = c.start
    for i, c in enumerate(cues, start=1):
        c.index = i
    return cues
