"""Repetition cleaner: kill Whisper decode loops in subtitle text.

Behavioral twin of the reference's production repetition path
(reference: whisperjav/modules/repetition_cleaner.py:94-170
``clean_repetitions`` — the only method the sanitizer chain calls,
subtitle_sanitizer.py:541). Three layers, applied in order:

1. **Curated patterns** (repetition_cleaner.py:50-84): eight ordered
   pattern classes from most specific to most general — phrase loops
   with separators/commas, multi-char word loops, whitespace-separated
   single-char floods, prefix+char floods, plain char floods (dakuten-
   aware), vowel extensions, wave-dash comma phrases, sentence-ending
   phrase repetitions. Replacements collapse to one unit (phrases) or a
   doubled echo (chars/words).
2. **Generic substring dominance** (repetition_cleaner.py:177-227): for
   text still >40 chars, any 2-50 char unit whose non-overlapping
   occurrences (≥3) cover >50% of the text collapses to 1-2 occurrences
   — the safety net for loops the curated list misses.
3. **Length limit** (repetition_cleaner.py:152-168): >200 chars is a
   hallucination by construction; truncate at the last 。/、 boundary
   no earlier than 75% of the limit.

The per-layer thresholds (40 / 0.50 / 3 / 200 / 0.75) carry the
reference's constants (config/sanitization_constants.py:23-66) so the
differential suite (tests/test_text_chain_differential.py) can hold the
two chains string-equal over the adversarial corpus.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# stdlib-re equivalents of the reference's regex-module classes:
# [^\W_] ~ \p{L}\p{N} (unicode letters+digits), [^\W\d_] ~ \p{L}
_LN = r"[^\W_]"          # letter or digit
_L = r"[^\W\d_]"         # letter
_KANA = r"[ぁ-んァ-ン]"
_DAKUTEN = "[゙゚゛゜]"  # combining + standalone ゛゜

# (name, compiled pattern, replacement) — reference order is load-bearing
# (repetition_cleaner.py:50-84: most specific/extreme first)
_CURATED: List[Tuple[str, "re.Pattern[str]", str]] = [
    # extreme phrase repetition with separators: "あ!!あ!!あ!!あ!!"
    ("phrase_with_separator",
     re.compile(r"((?:%s{1,30}[、,!\s！?？。．・〜ー]+))\1{3,}" % _LN), r"\1"),
    # multi-character word loops: "ハッハッハッハッ" → "ハッハッ"
    ("multi_char_word",
     re.compile(r"((%s{2,4}))\1{3,}" % _KANA), r"\1\1"),
    # phrase + comma loops: "ゆーちゃん、ゆーちゃん、ゆーちゃん、"
    ("phrase_with_comma",
     re.compile(r"((?:%s{1,30}[、,]\s*))\1{2,}" % _LN), r"\1"),
    # newline/whitespace-separated single-char floods: "あ\nあ\nあ\nあ"
    ("single_char_whitespace_flood",
     re.compile(r"(%s)(?:[\s　]*\1){3,}" % _KANA), r"\1\1"),
    # prefix + char flood: "あらららら" → "あらら"
    ("prefix_plus_char",
     re.compile(r"(%s{1,2})(%s)\2{3,}" % (_KANA, _KANA)), r"\1\2\2"),
    # plain char floods (dakuten-aware): "あ゛あ゛あ゛あ゛" → "あ゛あ゛"
    ("single_char_flood",
     re.compile(r"(%s%s?)\1{3,}" % (_KANA, _DAKUTEN)), r"\1\1"),
    # vowel extensions: "あ〜〜〜〜〜" → "あ〜〜"
    ("vowel_extension",
     re.compile(r"(%s)([〜ー])\2{3,}" % _KANA), r"\1\2\2"),
    # wave-dash + comma phrases: "あ〜、あ〜、あ〜、" → "あ〜、"
    ("wavedash_comma_phrase",
     re.compile(r"(%s{1,10}[〜ー]+[、,]\s*)\1{2,}" % _L), r"\1"),
    # sentence-ending phrase loops: "はい、はい、はい・・・。"×3 → once
    ("sentence_phrase_repetition",
     re.compile(r"((?:%s[、,]?\s*){1,10}[・…。!！]{1,5}\s*)\1{2,}" % _LN),
     r"\1"),
]

# layer-2/3 thresholds (reference: config/sanitization_constants.py:61-66)
GENERIC_MIN_TEXT_LEN = 40
GENERIC_COVERAGE_THRESHOLD = 0.50
GENERIC_MIN_OCCURRENCES = 3
MAX_SUBTITLE_TEXT_LENGTH = 200
TRUNCATION_FLOOR_FRACTION = 0.75


@dataclass
class RepetitionStats:
    curated: int = 0          # layer-1 pattern applications
    generic: int = 0          # layer-2 substring-dominance collapses
    truncated: int = 0        # layer-3 length-limit truncations
    by_type: Dict[str, int] = field(default_factory=dict)

    @property
    def total(self) -> int:
        return self.curated + self.generic + self.truncated


def _generic_repetition(text: str) -> Tuple[str, bool]:
    """Substring-dominance detector (reference:
    repetition_cleaner.py:177-227): best unit of length 2-50 starting
    within one unit length of the text start, counted non-overlapping
    left-to-right; ≥3 occurrences covering >50% collapse to 2 (unit ≤5
    chars) or 1 occurrences."""
    n = len(text)
    best_unit = None
    best_coverage = 0.0
    for sub_len in range(2, min(50, n // 2) + 1):
        for start in range(min(sub_len, n - sub_len + 1)):
            unit = text[start:start + sub_len]
            count = 0
            pos = 0
            while pos <= n - sub_len:
                if text[pos:pos + sub_len] == unit:
                    count += 1
                    pos += sub_len
                else:
                    pos += 1
            if count >= GENERIC_MIN_OCCURRENCES:
                coverage = count * sub_len / n
                if coverage > best_coverage:
                    best_coverage = coverage
                    best_unit = unit
    if best_unit and best_coverage >= GENERIC_COVERAGE_THRESHOLD:
        keep = 2 if len(best_unit) <= 5 else 1
        return (best_unit * keep).strip(), True
    return text, False


class RepetitionCleaner:
    """Three-layer loop killer; see module docstring for the contract."""

    def __init__(self, max_text_length: int = MAX_SUBTITLE_TEXT_LENGTH):
        self.max_text_length = max_text_length

    def clean(self, text: str) -> Tuple[str, RepetitionStats]:
        stats = RepetitionStats()
        if not text or not text.strip():
            return text, stats
        cur = text

        # layer 1: curated patterns, in order
        for name, pattern, repl in _CURATED:
            new = pattern.sub(repl, cur)
            if new != cur:
                stats.curated += 1
                stats.by_type[name] = stats.by_type.get(name, 0) + 1
                cur = new

        # layer 2: generic substring dominance for still-long lines
        if len(cur) > GENERIC_MIN_TEXT_LEN:
            cleaned, hit = _generic_repetition(cur)
            if hit:
                stats.generic += 1
                cur = cleaned

        # layer 3: absolute length limit with 。/、 break above the floor
        if len(cur) > self.max_text_length:
            floor = int(self.max_text_length * TRUNCATION_FLOOR_FRACTION)
            truncated = cur[:self.max_text_length]
            for sep in ("。", "、"):
                if sep in truncated:
                    candidate = truncated.rsplit(sep, 1)[0]
                    if len(candidate) >= floor:
                        truncated = candidate
                        break
            stats.truncated += 1
            cur = truncated

        return cur.strip(), stats

    def is_mostly_repetition(self, text: str,
                             threshold: float = 0.0) -> bool:
        """Is the line almost entirely repetitive? (reference
        ``_is_all_repetition``, repetition_cleaner.py:290-330: >90%
        single-char dominance, short-phrase+separator floods, whole-line
        word loops, long vowel extensions)."""
        if not text:
            return False
        import unicodedata
        stripped = "".join(ch for ch in text
                           if unicodedata.category(ch)[0] not in "PZ")
        if len(stripped) > 10:
            from collections import Counter
            top = Counter(stripped).most_common(1)[0][1]
            if top / len(stripped) > 0.9:
                return True
        if re.match(r"^((?:.{1,5}?)[、,!\s!?・]){5,}$", text):
            return True
        if re.match(r"^((?:.{2,5}?))\1{3,}$", text):
            return True
        if re.match(r"^%s[〜ー]{10,}$" % _KANA, text):
            return True
        return False
