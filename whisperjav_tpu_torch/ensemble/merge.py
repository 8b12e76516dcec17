"""Ensemble merge engine: combine two-pass subtitle outputs (the port's
copy of ``whisperjav_tpu/ensemble/merge.py``).

Strategy-set parity with the reference's MergeEngine (reference:
whisperjav/ensemble/merge.py:12-505 — pass1/2_primary gap-fill,
pass1/2_overlap agreement filters, smart_merge quality heuristics,
full_merge union, longest), re-implemented over the in-memory Subtitle
model with interval arithmetic helpers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from whisperjav_tpu_torch.modules.srt import Subtitle


def _overlap(a: Subtitle, b: Subtitle) -> float:
    return max(0.0, min(a.end, b.end) - max(a.start, b.start))


def _overlaps_any(sub: Subtitle, others: Sequence[Subtitle],
                  min_ratio: float = 0.3) -> bool:
    for o in others:
        ov = _overlap(sub, o)
        if ov > 0 and ov / max(min(sub.duration, o.duration), 1e-6) >= min_ratio:
            return True
    return False


def _fits_gap(sub: Subtitle, existing: Sequence[Subtitle],
              tolerance: float = 0.2) -> bool:
    """True when sub does not materially overlap any existing cue."""
    for o in existing:
        if _overlap(sub, o) > tolerance:
            return False
    return True


def _renumber(subs: List[Subtitle]) -> List[Subtitle]:
    subs.sort(key=lambda s: (s.start, s.end))
    for i, s in enumerate(subs, start=1):
        s.index = i
    return subs


def _quality(sub: Subtitle) -> float:
    """Per-cue quality heuristic for smart merging: favors natural CPS and
    substantive text, penalizes suspicious extremes."""
    text_len = len(sub.text.replace("\n", ""))
    if text_len == 0 or sub.duration <= 0:
        return 0.0
    cps = text_len / sub.duration
    cps_score = 1.0 - min(abs(cps - 8.0) / 20.0, 1.0)  # natural JA ~4-12 cps
    len_score = min(text_len / 20.0, 1.0)
    return 0.6 * cps_score + 0.4 * len_score


def _merge_primary(primary: Sequence[Subtitle], secondary: Sequence[Subtitle],
                   gap_fill: bool = True) -> List[Subtitle]:
    out = [Subtitle(0, s.start, s.end, s.text) for s in primary]
    if gap_fill:
        for s in secondary:
            if _fits_gap(s, out):
                out.append(Subtitle(0, s.start, s.end, s.text))
    return _renumber(out)


def _merge_overlap(primary: Sequence[Subtitle],
                   secondary: Sequence[Subtitle]) -> List[Subtitle]:
    out = [Subtitle(0, s.start, s.end, s.text) for s in primary
           if _overlaps_any(s, secondary)]
    return _renumber(out)


def _merge_smart(pass1: Sequence[Subtitle],
                 pass2: Sequence[Subtitle]) -> List[Subtitle]:
    """Overlapping cues resolved by quality; disjoint cues all kept."""
    out: List[Subtitle] = []
    used2 = set()
    for s1 in pass1:
        best_j, best_ov = None, 0.0
        for j, s2 in enumerate(pass2):
            ov = _overlap(s1, s2)
            if ov > best_ov:
                best_j, best_ov = j, ov
        if best_j is not None and best_ov > 0.3 * min(
                s1.duration, pass2[best_j].duration):
            winner = s1 if _quality(s1) >= _quality(pass2[best_j]) else pass2[best_j]
            out.append(Subtitle(0, winner.start, winner.end, winner.text))
            used2.add(best_j)
        else:
            out.append(Subtitle(0, s1.start, s1.end, s1.text))
    for j, s2 in enumerate(pass2):
        if j not in used2 and _fits_gap(s2, out):
            out.append(Subtitle(0, s2.start, s2.end, s2.text))
    return _dedup_consecutive(_renumber(out))


def _merge_full(pass1: Sequence[Subtitle],
                pass2: Sequence[Subtitle]) -> List[Subtitle]:
    out = [Subtitle(0, s.start, s.end, s.text) for s in pass1]
    for s in pass2:
        if _fits_gap(s, out, tolerance=0.5):
            out.append(Subtitle(0, s.start, s.end, s.text))
    return _dedup_consecutive(_renumber(out))


def _merge_longest(pass1: Sequence[Subtitle],
                   pass2: Sequence[Subtitle]) -> List[Subtitle]:
    """Per overlap cluster keep the cue with the most text."""
    all_subs = ([Subtitle(0, s.start, s.end, s.text) for s in pass1]
                + [Subtitle(0, s.start, s.end, s.text) for s in pass2])
    all_subs.sort(key=lambda s: (s.start, s.end))
    out: List[Subtitle] = []
    for s in all_subs:
        if out and _overlap(s, out[-1]) > 0.3 * min(s.duration,
                                                    out[-1].duration):
            if len(s.text) > len(out[-1].text):
                out[-1] = s
        else:
            out.append(s)
    return _renumber(out)


def _dedup_consecutive(subs: List[Subtitle]) -> List[Subtitle]:
    out: List[Subtitle] = []
    for s in subs:
        if out and s.text == out[-1].text and s.start - out[-1].end < 1.0:
            out[-1].end = max(out[-1].end, s.end)
        else:
            out.append(s)
    return _renumber(out)


MERGE_STRATEGIES: Dict[str, Callable] = {
    "pass1_primary": lambda p1, p2: _merge_primary(p1, p2),
    "pass2_primary": lambda p1, p2: _merge_primary(p2, p1),
    "pass1_overlap": lambda p1, p2: _merge_overlap(p1, p2),
    "pass2_overlap": lambda p1, p2: _merge_overlap(p2, p1),
    "smart_merge": _merge_smart,
    "full_merge": _merge_full,
    "longest": _merge_longest,
}


@dataclass
class MergeStats:
    strategy: str
    pass1_cues: int
    pass2_cues: int
    merged_cues: int
    coverage_s: float

    def to_dict(self) -> Dict:
        return self.__dict__.copy()


class MergeEngine:
    def __init__(self, strategy: str = "smart_merge"):
        if strategy not in MERGE_STRATEGIES:
            raise ValueError(f"unknown merge strategy {strategy!r}; "
                             f"choose from {sorted(MERGE_STRATEGIES)}")
        self.strategy = strategy

    def merge(self, pass1: Sequence[Subtitle],
              pass2: Sequence[Subtitle]) -> Tuple[List[Subtitle], MergeStats]:
        merged = MERGE_STRATEGIES[self.strategy](list(pass1), list(pass2))
        stats = MergeStats(
            strategy=self.strategy,
            pass1_cues=len(pass1), pass2_cues=len(pass2),
            merged_cues=len(merged),
            coverage_s=round(sum(s.duration for s in merged), 2),
        )
        return merged, stats
