"""Multi-phase CJK subtitle sanitizer.

Behavioral counterpart of the reference's SubtitleSanitizer
(reference: whisperjav/modules/subtitle_sanitizer.py:235-1094 — phases:
purge empty → content cleaning (hallucination + repetition) → sequential
dedup → CPS limiter → timing adjustment → renumber, with an artifacts
record of removals and a statistics dict).

Operates on the in-memory Subtitle list (no file round-trips) and returns
both the cleaned list and a stats/artifacts bundle.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from whisperjav_tpu_torch.modules.sanitize.hallucinations import HallucinationRemover
from whisperjav_tpu_torch.modules.sanitize.repetition import RepetitionCleaner
from whisperjav_tpu_torch.modules.srt import Subtitle

# Symbol-only residue detector (reference: subtitle_sanitizer.py:946-954,
# issue #287): after the mutating cleaners run, a cue whose text contains
# no character from any Whisper-transcribable script is punctuation/emoji
# residue (e.g. '!!' left by a partial strip) and must be dropped before
# CPS/timing/output. The script class is the reference's v1.8.14 set
# (issue #324 widened it beyond CJK+Latin, whose narrowness silently ate
# Korean/Cyrillic/Arabic/Thai/Hebrew/Devanagari/Greek output):
# kana + CJK ideographs + full/half-width Latin+digits + Hangul (incl.
# jamo) + Cyrillic + Greek + Arabic + Hebrew + Thai + Devanagari +
# Latin-Extended.
_LINGUISTIC_CHAR_RE = re.compile(
    "["
    "\u3041-\u3096\u309D-\u309F"   # hiragana + iteration marks
    "\u30A1-\u30FA\u30FC-\u30FF"   # katakana letters + prolonged mark
    "\u4E00-\u9FFF"                  # CJK unified ideographs
    "\uFF10-\uFF19\uFF21-\uFF3A\uFF41-\uFF5A"  # fullwidth alnum
    "A-Za-z0-9"
    "\uAC00-\uD7AF\u1100-\u11FF\u3130-\u318F"  # Hangul + jamo
    "\u0400-\u04FF"                  # Cyrillic
    "\u0370-\u03FF"                  # Greek
    "\u0600-\u06FF"                  # Arabic
    "\u0590-\u05FF"                  # Hebrew
    "\u0E00-\u0E7F"                  # Thai
    "\u0900-\u097F"                  # Devanagari
    "\u00C0-\u024F"                  # Latin Extended-A/-B
    "]")


# reading speed by language (reference: config/sanitization_constants.py:
# 77-83 CrossSubtitleConstants.CHARS_PER_SECOND)
CHARS_PER_SECOND = {"ja": 7.0, "zh": 6.0, "ko": 6.5, "en": 15.0,
                    "default": 10.0}


@dataclass
class SanitizerConfig:
    # CPS (characters/second) limits (reference: sanitization_constants.py:
    # 90-108 TimingConstants — MAX_SAFE_CPS removes, MIN_SAFE_CPS on short
    # text removes, MIN_SAFE_CPS on long text retimes)
    max_safe_cps: float = 30.0
    min_safe_cps: float = 1.0
    min_text_len_for_cps: int = 1
    slow_cps_max_len: int = 4      # short-text bound for slow-CPS removal
    min_duration_s: float = 0.3
    max_duration_s: float = 12.0   # longer = hallucination suspect
    # sequential dedup (reference: sanitization_constants.py:72,85 —
    # MAX_GAP_MS=600, DEDUP_THRESHOLD=3): only a RUN of >= threshold
    # identical cues merges; a single repeat is kept as-is (intentional
    # repeats are common in the target content)
    dedup_gap_s: float = 0.6
    dedup_threshold: int = 3
    # drop lines that are mostly repetition noise
    repetition_density: float = 0.75
    # content-aware retiming triggers (reference: timing_adjuster.py:44-117)
    content_change_ratio: float = 0.3
    merged_duration_delta_s: float = 0.25
    merged_text_max_len: int = 20


@dataclass
class SanitizerReport:
    empty_removed: int = 0
    hallucinations_removed: int = 0
    repetitions_cleaned: int = 0
    duplicates_merged: int = 0
    cross_removed: int = 0
    cross_merged: int = 0
    cps_violations_removed: int = 0
    timing_adjusted: int = 0
    artifacts: List[Dict] = field(default_factory=list)  # removed cues
    # cross-subtitle high-density phrase analysis (diagnostics)
    high_density_phrases: List[Dict] = field(default_factory=list)

    def to_dict(self) -> Dict:
        return {
            "empty_removed": self.empty_removed,
            "hallucinations_removed": self.hallucinations_removed,
            "repetitions_cleaned": self.repetitions_cleaned,
            "duplicates_merged": self.duplicates_merged,
            "cross_removed": self.cross_removed,
            "cross_merged": self.cross_merged,
            "cps_violations_removed": self.cps_violations_removed,
            "timing_adjusted": self.timing_adjusted,
            "high_density_phrases": self.high_density_phrases,
            "total_removed": (self.empty_removed
                              + self.hallucinations_removed
                              + self.cps_violations_removed
                              + self.cross_removed
                              + self.duplicates_merged),
        }


class SubtitleSanitizer:
    def __init__(self, language: str = "ja",
                 config: Optional[SanitizerConfig] = None):
        self.language = language
        self.config = config or SanitizerConfig()
        self.hallucinations = HallucinationRemover(language)
        self.repetitions = RepetitionCleaner()

    # ------------------------------------------------------------------
    def process(self, subs: Sequence[Subtitle]) -> Tuple[List[Subtitle],
                                                         SanitizerReport]:
        report = SanitizerReport()
        out = [Subtitle(s.index, s.start, s.end, s.text) for s in subs]
        # pre-cleaning snapshot keyed by index, for the content-aware
        # timing pass (reference: timing_adjuster.py:44-56 compares
        # original vs modified subtitles)
        originals = {s.index: Subtitle(s.index, s.start, s.end, s.text)
                     for s in out}

        out = self._purge_empty(out, report)
        out = self._clean_content(out, report)
        out = self._dedup_sequential(out, report)
        out = self._cross_subtitle(out, report)
        out = self._limit_cps(out, report)
        out = self._adjust_timing(out, report, originals)
        for i, s in enumerate(out, start=1):
            s.index = i
        return out, report

    # ------------------------------------------------------------------
    def _purge_empty(self, subs, report):
        kept = []
        for s in subs:
            if s.text.strip():
                kept.append(s)
            else:
                report.empty_removed += 1
        return kept

    def _clean_content(self, subs, report):
        kept = []
        for s in subs:
            text, h_stats = self.hallucinations.clean(s.text)
            if h_stats.total and not text:
                report.hallucinations_removed += 1
                report.artifacts.append({"reason": "hallucination",
                                         "start": s.start, "end": s.end,
                                         "text": s.text})
                continue
            # all-repetition lines are CLEANED, not dropped (reference:
            # subtitle_sanitizer.py:541 — clean_repetitions collapses
            # loops to a short echo; the line survives as content)
            text, r_stats = self.repetitions.clean(text)
            if r_stats.total:
                report.repetitions_cleaned += 1
            if not text.strip():
                report.empty_removed += 1
                continue
            # symbol-only purge (reference issue #287): the mutating
            # cleaners above can leave pure punctuation/emoji residue
            # ('!!', '。') — no transcribable-script character means the
            # cue carries no content; drop before CPS/timing see it
            if not _LINGUISTIC_CHAR_RE.search(text):
                report.hallucinations_removed += 1
                report.artifacts.append({"reason": "symbol_only_residue",
                                         "start": s.start, "end": s.end,
                                         "text": s.text})
                continue
            kept.append(Subtitle(s.index, s.start, s.end, text))
        return kept

    def _dedup_sequential(self, subs, report):
        """Merge RUNS of identical consecutive cues (reference:
        subtitle_sanitizer.py:984): a run merges only when it reaches
        dedup_threshold (3) cues with inter-cue gaps in [0, gap); a
        lone repeat is kept — it's usually an intentional repeat, not a
        stuck decoder."""
        cfg = self.config
        out: List[Subtitle] = []
        i = 0
        while i < len(subs):
            run = [subs[i]]
            j = i + 1
            while j < len(subs):
                gap = subs[j].start - run[-1].end
                if (subs[j].text.strip() == run[0].text.strip()
                        and 0 <= gap < cfg.dedup_gap_s):
                    run.append(subs[j])
                    j += 1
                else:
                    break
            if len(run) >= cfg.dedup_threshold:
                first = run[0]
                out.append(Subtitle(first.index, first.start,
                                    run[-1].end, first.text))
                report.duplicates_merged += len(run) - 1
                i = j
            else:
                # below threshold: emit only the head and advance one —
                # the next cue may anchor its own run (reference
                # pointer semantics)
                out.append(run[0])
                i += 1
        return out

    def _cross_subtitle(self, subs, report):
        """Inter-subtitle merge/dedup analysis between sequential dedup and
        the CPS pass (reference order: subtitle_sanitizer.py:867-1094 runs
        CrossSubtitleProcessor inside the content-cleaning chain)."""
        from whisperjav_tpu_torch.modules.sanitize.cross_subtitle import (
            CrossSubtitleProcessor,
        )
        out, stats = CrossSubtitleProcessor().process(subs)
        report.cross_removed += stats["containment_removed"]
        report.cross_merged += (stats["continuations_merged"]
                                + stats["stutters_collapsed"])
        report.high_density_phrases = stats.get("high_density_phrases", [])
        return out

    def _limit_cps(self, subs, report):
        """Remove abnormal-CPS cues, both directions (reference:
        subtitle_sanitizer.py:1094-1160 _remove_abnormally_fast_subs):
        too fast (> MAX_SAFE_CPS) = hallucination squeezed into impossible
        timing; too slow (< MIN_SAFE_CPS) on SHORT text (≤ 4 chars) =
        hallucination label stretched over silence (息子 at 0.5 CPS)."""
        cfg = self.config
        kept = []
        for s in subs:
            dur = max(s.duration, 1e-3)
            # internal newlines excluded from the char count (reference
            # v1.8.11 fix 3)
            text_len = len(s.text.replace("\n", "").strip())
            if text_len >= cfg.min_text_len_for_cps and dur > 0:
                cps = text_len / dur
                if cps > cfg.max_safe_cps:
                    report.cps_violations_removed += 1
                    report.artifacts.append(
                        {"reason": f"abnormally_fast_cps_{cps:.1f}",
                         "start": s.start, "end": s.end, "text": s.text})
                    continue
                if text_len <= cfg.slow_cps_max_len and cps < cfg.min_safe_cps:
                    report.cps_violations_removed += 1
                    report.artifacts.append(
                        {"reason": f"abnormally_slow_cps_{cps:.1f}",
                         "start": s.start, "end": s.end, "text": s.text})
                    continue
            kept.append(s)
        return kept

    def _adjust_timing(self, subs, report, originals=None):
        """Content-aware timing adjustment + monotonic overlap repair.

        Reference: modules/timing_adjuster.py:44-200 — a cue is RETIMED
        (end fixed, start pulled in so duration = text_len / reading-CPS,
        clamped to [MIN, MAX] duration) when any of:
          (a) its text changed substantially during cleaning (>30%),
          (c) it absorbed a merge (duration moved >0.25 s, short text),
          (b) its duration exceeds the 12 s hallucination threshold,
          (d) its CPS is abnormally slow on checkable-length text.
        Untouched cues keep their model timestamps. A final monotonic
        pass repairs overlaps introduced upstream.
        """
        cfg = self.config
        originals = originals or {}
        cps_rate = CHARS_PER_SECOND.get(self.language,
                                        CHARS_PER_SECOND["default"])
        retimed: List[Subtitle] = []
        for s in subs:
            orig = originals.get(s.index)
            text_len = len(s.text.replace("\n", "").strip())
            dur = s.duration
            reason = None
            if orig is not None:
                orig_len = len(orig.text.strip())
                if orig_len > 0 and (abs(orig_len - len(s.text.strip()))
                                     / orig_len) > cfg.content_change_ratio:
                    reason = "substantial_content_change"
                elif (abs(orig.duration - dur) > cfg.merged_duration_delta_s
                        and text_len < cfg.merged_text_max_len):
                    reason = "merged_line_duration_change"
            if reason is None and dur > cfg.max_duration_s:
                reason = "duration_hallucination"
            if (reason is None and text_len >= cfg.min_text_len_for_cps
                    and dur > 0 and text_len / dur < cfg.min_safe_cps):
                reason = "abnormally_slow_cps"
            if reason is not None:
                ideal = min(max(text_len / cps_rate, cfg.min_duration_s),
                            cfg.max_duration_s)
                new_start = max(0.0, s.end - ideal)
                report.timing_adjusted += 1
                retimed.append(Subtitle(s.index, new_start, s.end, s.text))
            else:
                retimed.append(s)

        out: List[Subtitle] = []
        for s in retimed:
            start, end = s.start, s.end
            if end - start < cfg.min_duration_s:
                end = start + cfg.min_duration_s
                report.timing_adjusted += 1
            if out and start < out[-1].end:
                start = out[-1].end
                if end <= start:
                    end = start + cfg.min_duration_s
                report.timing_adjusted += 1
            out.append(Subtitle(s.index, start, end, s.text))
        return out


def write_artifacts_srt(path, artifacts: Sequence[Dict],
                        summary: Optional[Dict] = None) -> None:
    """Write removed cues as an artifacts SRT + a trailing summary cue.

    Mirrors the reference's artifacts SRT of removals and summary
    subtitle (subtitle_sanitizer.py:235,867,984,1094): each removed cue
    keeps its original timing with a ``[reason]`` prefix; a final cue
    carries the run's removal statistics so the file is self-describing
    when opened in a player.
    """
    from whisperjav_tpu_torch.modules.srt import save_srt

    cues: List[Subtitle] = []
    last_end = 0.0
    for art in artifacts:
        start = float(art.get("start", 0.0))
        end = float(art.get("end", start + 1.5))
        if end <= start:
            end = start + 1.5
        text = f"[{art.get('reason', 'removed')}] {art.get('text', '')}"
        cues.append(Subtitle(0, start, end, text.strip()))
        last_end = max(last_end, end)
    if summary:
        parts = [f"{k}={v}" for k, v in summary.items()
                 if isinstance(v, (int, float)) and v]
        cues.append(Subtitle(0, last_end + 0.5, last_end + 3.0,
                             "[sanitizer summary] " + " ".join(parts)))
    for i, c in enumerate(cues, start=1):
        c.index = i
    save_srt(path, cues)
