"""Subtitle matching: align test cues to ground-truth cues.

Role parity with reference ``whisperjav/bench/matcher.py`` — temporal
overlap gates candidates, text similarity picks the winner, greedy in
GT order with each test cue usable once. The three output buckets are
the quality vocabulary the report speaks: matched / missed (GT with no
counterpart = deletions) / hallucinated (test with no counterpart).
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from whisperjav_tpu_torch.bench.metrics import normalize_for_cer
from whisperjav_tpu_torch.modules.srt import Subtitle


@dataclass
class MatchResult:
    matched: List[Tuple[Subtitle, Subtitle]] = field(default_factory=list)
    missed: List[Subtitle] = field(default_factory=list)
    hallucinated: List[Subtitle] = field(default_factory=list)
    similarities: List[float] = field(default_factory=list)

    @property
    def recall(self) -> float:
        n = len(self.matched) + len(self.missed)
        return len(self.matched) / n if n else 0.0

    @property
    def precision(self) -> float:
        n = len(self.matched) + len(self.hallucinated)
        return len(self.matched) / n if n else 0.0

    def to_dict(self) -> Dict:
        return {
            "matched": len(self.matched),
            "missed": len(self.missed),
            "hallucinated": len(self.hallucinated),
            "recall": round(self.recall, 4),
            "precision": round(self.precision, 4),
            "mean_text_similarity": round(
                sum(self.similarities) / len(self.similarities), 4)
            if self.similarities else 0.0,
        }


def text_similarity(a: str, b: str) -> float:
    return difflib.SequenceMatcher(
        None, normalize_for_cer(a), normalize_for_cer(b)).ratio()


def match_subtitles(
    gt_subs: Sequence[Subtitle],
    test_subs: Sequence[Subtitle],
    min_overlap_s: float = 0.1,
    min_text_similarity: float = 0.2,
) -> MatchResult:
    """Greedy GT-order matching (reference: matcher.py:19-60): for each
    GT cue, candidates are unused test cues overlapping ≥ min_overlap_s;
    the highest text similarity ≥ threshold wins."""
    used = set()
    out = MatchResult()
    for gt in gt_subs:
        best_i, best_sim = None, min_text_similarity
        for i, t in enumerate(test_subs):
            if i in used:
                continue
            overlap = min(gt.end, t.end) - max(gt.start, t.start)
            if overlap < min_overlap_s:
                continue
            sim = text_similarity(gt.text, t.text)
            if sim >= best_sim:
                best_i, best_sim = i, sim
        if best_i is None:
            out.missed.append(gt)
        else:
            used.add(best_i)
            out.matched.append((gt, test_subs[best_i]))
            out.similarities.append(best_sim)
    out.hallucinated = [t for i, t in enumerate(test_subs)
                        if i not in used]
    return out
