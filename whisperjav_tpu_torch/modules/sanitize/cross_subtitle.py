"""Cross-subtitle analysis: merges and dedup across neighboring cues.

Role parity with reference ``whisperjav/modules/cross_subtitle_processor.py``
(inter-subtitle merging/dedup analysis), extending the sanitizer's
same-text dedup with:

- similar-consecutive merge: close cues whose texts clear a similarity
  threshold merge into one (the reference's consecutive-repetition
  merge, MERGE_SIMILARITY_THRESHOLD semantics);
- containment dedup: a cue whose text is wholly contained in an
  overlapping neighbor is dropped (double-decode artifacts, common after
  ensemble merging);
- stutter-pair collapse: A, A+B sequences become A+B.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from whisperjav_tpu_torch.modules.srt import Subtitle

SENTENCE_END = "。！？!?…"


@dataclass
class CrossSubtitleConfig:
    continuation_gap_s: float = 0.5
    max_merged_chars: int = 42
    containment_overlap_s: float = 0.2
    # minimum text similarity for merging consecutive cues (reference:
    # sanitization_constants.py:71 MERGE_SIMILARITY_THRESHOLD=0.9)
    merge_similarity: float = 0.9
    # a similar-run merges only at this size (reference:
    # sanitization_constants.py:85 DEDUP_THRESHOLD=3) — a pair is kept;
    # intentional repeats are common in the target content
    merge_threshold: int = 3


class CrossSubtitleProcessor:
    def __init__(self, config: CrossSubtitleConfig | None = None):
        self.config = config or CrossSubtitleConfig()

    def process(self, subs: Sequence[Subtitle]) -> Tuple[List[Subtitle], Dict]:
        out = [Subtitle(s.index, s.start, s.end, s.text) for s in subs]
        stats = {"containment_removed": 0, "continuations_merged": 0,
                 "stutters_collapsed": 0, "high_density_phrases": []}
        out = self._containment_dedup(out, stats)
        out = self._stutter_collapse(out, stats)
        out = self._continuation_merge(out, stats)
        stats["high_density_phrases"] = self._high_density_analysis(out)
        for i, s in enumerate(out, start=1):
            s.index = i
        return out, stats

    # ------------------------------------------------------------------
    @staticmethod
    def _high_density_analysis(subs: Sequence[Subtitle]) -> List[Dict]:
        """Flag phrases saturating the transcript (reference:
        cross_subtitle_processor.py:94-135 — words + 2-grams counted
        across all cues; a phrase with ≥5 occurrences, >20% word density
        and >3 affected cues is reported as a cross-subtitle repetition
        symptom). Analysis only — records feed diagnostics, not edits."""
        import re
        from collections import Counter

        if len(subs) < 3:
            return []
        all_text = "".join(s.text for s in subs)
        if len(all_text) < 50:
            return []
        token_re = re.compile(r"[぀-ゟ]+|[゠-ヿ]+|[一-鿿々ヶ]+")
        counts: Counter = Counter()
        total_words = 0
        for s in subs:
            words = token_re.findall(s.text)
            total_words += len(words)
            for w in words:
                if len(w) >= 2:
                    counts[w] += 1
            for i in range(len(words) - 1):
                gram = words[i] + words[i + 1]
                if len(gram) >= 3:
                    counts[gram] += 1
        records: List[Dict] = []
        for phrase, count in counts.most_common(3):
            if count < 5 or len(phrase) < 2:
                continue
            density = count / max(total_words, 1)
            if density <= 0.2:
                continue
            affected = [s.index for s in subs if phrase in s.text]
            if len(affected) > 3:
                records.append({"phrase": phrase, "occurrences": count,
                                "density": round(density, 3),
                                "affected": affected})
        return records

    # ------------------------------------------------------------------
    def _containment_dedup(self, subs, stats):
        cfg = self.config
        kept: List[Subtitle] = []
        for s in subs:
            drop = False
            for n in kept[-2:]:
                overlap = min(s.end, n.end) - max(s.start, n.start)
                if overlap >= cfg.containment_overlap_s and s.text and \
                        s.text in n.text and s.text != n.text:
                    drop = True
                    break
            if drop:
                stats["containment_removed"] += 1
            else:
                kept.append(s)
        return kept

    def _stutter_collapse(self, subs, stats):
        out: List[Subtitle] = []
        for s in subs:
            if (out and s.text.startswith(out[-1].text)
                    and len(s.text) > len(out[-1].text)
                    and s.start - out[-1].end < 1.0):
                stats["stutters_collapsed"] += 1
                out[-1] = Subtitle(out[-1].index, out[-1].start, s.end,
                                   s.text)
            else:
                out.append(s)
        return out

    def _continuation_merge(self, subs, stats):
        """Merge RUNS of consecutive SIMILAR cues (reference semantics:
        cross_subtitle_processor.py:36-90 — pairwise similarity vs the
        run's FIRST cue must clear MERGE_SIMILARITY_THRESHOLD within
        MAX_GAP_MS, and the run merges only at DEDUP_THRESHOLD (3) —
        it never glues unrelated dialogue or a lone intentional repeat)."""
        from difflib import SequenceMatcher

        cfg = self.config
        out: List[Subtitle] = []
        i = 0
        while i < len(subs):
            run = [subs[i]]
            j = i + 1
            while j < len(subs) and subs[i].text:
                nxt = subs[j]
                if (nxt.text
                        and nxt.start - run[-1].end <= cfg.continuation_gap_s
                        and SequenceMatcher(None, subs[i].text,
                                            nxt.text).ratio()
                        >= cfg.merge_similarity):
                    run.append(nxt)
                    j += 1
                else:
                    break
            if len(run) >= cfg.merge_threshold:
                stats["continuations_merged"] += len(run) - 1
                keep = max((s.text for s in run), key=len)
                out.append(Subtitle(run[0].index, run[0].start,
                                    run[-1].end, keep))
                i = j
            else:
                # below threshold: emit only the head and advance one —
                # the next cue may anchor its own run (reference
                # pointer semantics)
                out.append(run[0])
                i += 1
        return out
