"""Japanese linguistic post-processing: subtitle regrouping.

Behavioral counterpart of the reference's JapanesePostProcessor
(reference: whisperjav/modules/japanese_postprocessor.py:33-620 — six
passes over stable-ts results: aizuchi/filler removal → hierarchical
linguistic splitting for unpunctuated text → isolated-particle re-merge
(JP-002) → structural anchoring at quotes/endings → gap/punctuation
merging → readability splitting → tiny-fragment merge (JP-003), with
presets default/high_moan/narrative).

This implementation works on whole subtitle cues (the word-level regroup
algebra lives in modules/subtitle_pipeline/reconstruction.py); splitting
distributes time proportionally to character counts.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence

from whisperjav_tpu_torch.modules.srt import Subtitle

# ---------------------------------------------------------------------------
# Linguistic sets (reference: japanese_postprocessor.py:33-195
# JapaneseLinguisticSets)
# ---------------------------------------------------------------------------

# Backchanneling and fillers (aizuchi) — removed in pass 1
AIZUCHI_FILLERS = ("あのー", "ええと", "えっと", "あの", "まあ", "なんか",
                   "こう", "うん", "はい", "ええ", "そう", "えっ", "あっ")

# Emotional/expressive interjections — meaningful content, never removed
EXPRESSIVE_EMOTIONS = ("ああ", "うう", "ええ", "おお", "はあ", "ふう",
                       "あっ", "うっ", "はっ", "ふっ", "んっ")

# Compound particle sequences that must never be split apart (JP-002);
# longest first so prefix matches don't shadow them
COMPOUND_PARTICLES = (
    "でしたよね", "ましたよね", "ですよね", "ますよね", "ですよな",
    "ますよな", "ですよ", "ますよ", "ですね", "ますね", "ですな",
    "ますな", "だよね", "だよな", "だよ", "だね", "だな", "よね",
    "よな", "わね", "わよ", "のよ", "のね", "のな", "かな", "っけ",
)

# Isolated particles that make no sense standing alone — merged back
MERGEABLE_ISOLATED_PARTICLES = frozenset(
    ("よ", "ね", "な", "わ", "の", "さ", "ぞ", "ぜ",
     "よね", "よな", "わね", "わよ", "のよ", "のね",
     "か", "かな", "でしょ", "じゃん"))

# Level 1: definite sentence-final verb endings (unconditional split)
DEFINITE_ENDINGS = ("ございます", "ください", "ましょう", "でしょう",
                    "ました", "ません", "でした", "です", "ます")

# Levels 2/3: emphatic and soft sentence-final particles (split at cue
# level only when followed by punctuation-free overlong text)
STRONG_PARTICLES = ("よ", "ぞ", "ぜ", "わよ", "のよ", "ぜよ")
SOFT_PARTICLES = ("ね", "な", "わ", "の", "かな", "っけ", "さ")

FRAGMENT_MAX_CHARS = 2
SPLIT_PUNCT = "。！？!?…"
OPEN_QUOTES = "「『"
CLOSE_QUOTES = "」』"

_FILLER_LEAD_RE = re.compile(
    "^(?:" + "|".join(re.escape(f) for f in
                      sorted(AIZUCHI_FILLERS, key=len, reverse=True))
    + ")[、,。・ ]+")


@dataclass
class JapanesePostConfig:
    """Preset parameters (reference: japanese_postprocessor.py:241-269
    PRESETS — gap_threshold/segment_length/min_segment_duration/
    min_segment_chars per content type)."""
    merge_gap_s: float = 0.3        # cues closer than this may merge
    max_merged_chars: int = 28
    max_cue_chars: int = 35         # split beyond this (segment_length)
    min_cue_duration_s: float = 0.3
    min_cue_chars: int = 3          # tiny-fragment threshold (JP-003)
    particle_merge: bool = True
    remove_fillers: bool = True


PRESETS = {
    "default": JapanesePostConfig(),
    # moan-heavy content: tiny vocal fragments are frequent and
    # meaningful — merge less aggressively, allow shorter cues
    "high_moan": JapanesePostConfig(merge_gap_s=0.1, max_merged_chars=20,
                                    max_cue_chars=25,
                                    min_cue_duration_s=0.2,
                                    min_cue_chars=2,
                                    particle_merge=False,
                                    remove_fillers=False),
    # narration: longer sentences, merge more, split later
    "narrative": JapanesePostConfig(merge_gap_s=0.4, max_merged_chars=36,
                                    max_cue_chars=45,
                                    min_cue_duration_s=0.4,
                                    min_cue_chars=4),
}


def _is_fragment(text: str) -> bool:
    t = text.strip()
    if not t:
        return False
    if t in MERGEABLE_ISOLATED_PARTICLES or t in COMPOUND_PARTICLES:
        return True
    return (len(t) <= FRAGMENT_MAX_CHARS
            and not any(c in SPLIT_PUNCT for c in t))


def _is_pure_filler(text: str) -> bool:
    """A cue that is nothing but backchannel (possibly repeated)."""
    t = re.sub(r"[、,。・…  ]", "", text)
    if not t or t in EXPRESSIVE_EMOTIONS:
        return False
    for f in sorted(AIZUCHI_FILLERS, key=len, reverse=True):
        while t.startswith(f):
            t = t[len(f):]
    return not t


class JapanesePostProcessor:
    def __init__(self, preset: str = "default",
                 config: Optional[JapanesePostConfig] = None):
        self.config = config or PRESETS.get(preset, PRESETS["default"])

    # ------------------------------------------------------------------
    def process(self, subs: Sequence[Subtitle]) -> List[Subtitle]:
        out = [Subtitle(s.index, s.start, s.end, s.text) for s in subs]
        if self.config.remove_fillers:
            out = self._remove_fillers(out)                      # pass 1
        if self.config.particle_merge:
            out = self._merge_fragments(out)                     # pass 2.5
        out = self._merge_close(out)                             # pass 4
        out = self._split_long(out)                              # passes 2+5
        out = self._merge_tiny(out)                              # pass 6
        for i, s in enumerate(out, start=1):
            s.index = i
        return out

    # ------------------------------------------------------------------
    def _remove_fillers(self, subs: List[Subtitle]) -> List[Subtitle]:
        """Pass 1: aizuchi/filler removal (reference:
        remove_words_by_str(aizuchi_fillers), :355-361). Cue-level form:
        drop pure-backchannel cues, strip leading filler+pause prefixes;
        expressive emotions (ああ/んっ…) are protected content."""
        out: List[Subtitle] = []
        for s in subs:
            if _is_pure_filler(s.text):
                continue
            text = _FILLER_LEAD_RE.sub("", s.text.strip()) or s.text.strip()
            out.append(Subtitle(s.index, s.start, s.end, text))
        return out

    def _merge_fragments(self, subs: List[Subtitle]) -> List[Subtitle]:
        """Glue particle/fragment cues onto the closer neighbor
        (reference: _merge_isolated_particles JP-002, :496-570)."""
        cfg = self.config
        out: List[Subtitle] = []
        i = 0
        while i < len(subs):
            s = subs[i]
            if _is_fragment(s.text):
                prev_gap = (s.start - out[-1].end) if out else float("inf")
                next_gap = (subs[i + 1].start - s.end
                            if i + 1 < len(subs) else float("inf"))
                if prev_gap <= min(next_gap, cfg.merge_gap_s) and out and \
                        len(out[-1].text) + len(s.text) <= cfg.max_merged_chars:
                    out[-1] = Subtitle(out[-1].index, out[-1].start, s.end,
                                       out[-1].text + s.text)
                    i += 1
                    continue
                if next_gap <= cfg.merge_gap_s and i + 1 < len(subs) and \
                        len(s.text) + len(subs[i + 1].text) <= cfg.max_merged_chars:
                    nxt = subs[i + 1]
                    subs[i + 1] = Subtitle(nxt.index, s.start, nxt.end,
                                           s.text + nxt.text)
                    i += 1
                    continue
            out.append(s)
            i += 1
        return out

    def _merge_close(self, subs: List[Subtitle]) -> List[Subtitle]:
        """Merge adjacent short cues separated by tiny gaps (reference:
        merge_by_gap, :414-421). Quote boundaries are structural anchors
        (reference lock() on 「」『』, :378-381): never merge across them."""
        cfg = self.config
        out: List[Subtitle] = []
        for s in subs:
            if (out and s.start - out[-1].end <= cfg.merge_gap_s
                    and len(out[-1].text) + len(s.text) <= cfg.max_merged_chars
                    and not out[-1].text.endswith(tuple(SPLIT_PUNCT))
                    and not out[-1].text.endswith(tuple(CLOSE_QUOTES))
                    and not s.text.startswith(tuple(OPEN_QUOTES))):
                out[-1] = Subtitle(out[-1].index, out[-1].start, s.end,
                                   out[-1].text + s.text)
            else:
                out.append(s)
        return out

    def _merge_tiny(self, subs: List[Subtitle]) -> List[Subtitle]:
        """Final pass: cues too short to read merge into the previous cue
        (reference: _merge_tiny_fragments JP-003, :572-620). Zero-duration
        cues are left alone — they get VAD-fallback timestamps later."""
        cfg = self.config
        out: List[Subtitle] = []
        for s in subs:
            chars = len(s.text.strip())
            tiny = (0.0 < s.duration < cfg.min_cue_duration_s
                    or 0 < chars < cfg.min_cue_chars)
            if (tiny and out
                    and len(out[-1].text) + chars <= cfg.max_merged_chars
                    and not out[-1].text.endswith(tuple(SPLIT_PUNCT))):
                out[-1] = Subtitle(out[-1].index, out[-1].start, s.end,
                                   out[-1].text + s.text)
            else:
                out.append(s)
        return out

    def _split_long(self, subs: List[Subtitle]) -> List[Subtitle]:
        """Split overlong cues, time ∝ characters. Punctuated text splits
        at sentence punctuation; unpunctuated text (Qwen-style output)
        falls back to hierarchical linguistic splitting after definite
        verb endings and sentence-final particles (reference:
        _apply_hierarchical_splitting, :128-141 levels 1-3)."""
        cfg = self.config
        out: List[Subtitle] = []
        for s in subs:
            if len(s.text) <= cfg.max_cue_chars or "\n" in s.text:
                out.append(s)
                continue
            parts = self._split_text(s.text)
            if len(parts) == 1:
                parts = self._split_unpunctuated(s.text)
            if len(parts) == 1:
                out.append(s)
                continue
            total_chars = sum(len(p) for p in parts)
            t = s.start
            for p in parts:
                dur = max(s.duration * len(p) / total_chars,
                          cfg.min_cue_duration_s)
                end = min(t + dur, s.end)
                out.append(Subtitle(0, t, end, p))
                t = end
            out[-1].end = s.end
        return out

    @staticmethod
    def _split_text(text: str) -> List[str]:
        """Split at sentence punctuation, never inside 「」/『』 quotes."""
        parts: List[str] = []
        cur = ""
        depth = 0
        for ch in text:
            cur += ch
            if ch in OPEN_QUOTES:
                depth += 1
            elif ch in CLOSE_QUOTES:
                depth = max(0, depth - 1)
            elif ch in SPLIT_PUNCT and depth == 0:
                parts.append(cur)
                cur = ""
        if cur:
            parts.append(cur)
        # avoid over-fragmenting: rejoin pieces that are tiny
        merged: List[str] = []
        for p in parts:
            if merged and len(p) <= 2:
                merged[-1] += p
            else:
                merged.append(p)
        return merged

    @staticmethod
    def _split_unpunctuated(text: str) -> List[str]:
        """Hierarchical linguistic splitting for unpunctuated text:
        split AFTER definite polite endings (level 1 — です/ます/ました…),
        then after strong/soft sentence-final particles, respecting
        compound sequences (ですよね never splits mid-compound) and
        quote spans."""
        boundaries: List[int] = []
        n = len(text)
        depth = 0
        i = 0
        while i < n:
            ch = text[i]
            if ch in OPEN_QUOTES:
                depth += 1
            elif ch in CLOSE_QUOTES:
                depth = max(0, depth - 1)
            if depth:
                i += 1
                continue
            # longest compound ending at position i+len
            matched = None
            for cand in COMPOUND_PARTICLES + DEFINITE_ENDINGS:
                if text.startswith(cand, i):
                    matched = cand
                    break
            if matched is None:
                for cand in STRONG_PARTICLES + SOFT_PARTICLES:
                    if text.startswith(cand, i):
                        # particle must not be glued to a following particle
                        # (that would be part of a compound we missed)
                        nxt = i + len(cand)
                        if nxt >= n or text[nxt] not in "よねなわのさぞぜかっ":
                            matched = cand
                        break
            if matched is not None:
                end = i + len(matched)
                if 2 < end < n:          # never split off a tiny head/tail
                    boundaries.append(end)
                i = end
            else:
                i += 1
        if not boundaries:
            return [text]
        parts: List[str] = []
        prev = 0
        for b in boundaries:
            if b - prev >= 3:            # keep pieces readable
                parts.append(text[prev:b])
                prev = b
        if prev < n:
            parts.append(text[prev:])
        return parts if len(parts) > 1 else [text]
