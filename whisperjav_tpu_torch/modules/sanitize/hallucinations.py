"""Hallucination removal: versioned phrase/regex DBs + guard heuristics.

Behavioral counterpart of the reference's hallucination remover
(reference: whisperjav/modules/hallucination_remover.py:81-900). The
databases are the reference's own versioned JSON DATA, bundled
(whisperjav_tpu/data/hallucination_filters/: ``filter_list_v08.json`` —
per-language exact phrase lists, 3,590 JA / 100 EN; ``regexp_v09.json``
— categorized patterns with confidence + replacement). Loader chain:
explicit path → user cache (~/.cache/whisperjav-tpu) → bundled; URL
refresh is attempted only when ``WJAV_FILTER_URL_OK=1`` (the build and
default deployment are zero-egress).

Matching stages per subtitle line (reference order,
hallucination_remover.py:445-585):

1. bracketed-context drop — text fully wrapped in (), 【】, … is an SDH
   caption/sound-effect, removed whole;
2. emoji-contains drop — any emoji/dingbat character drops the line;
3. exact full-line match (lowercased/stripped);
4. exact match with trailing punctuation stripped;
5. fully-normalized exact match (all whitespace/quotes/punct stripped,
   Latin case-folded; ー and ゛ deliberately preserved — they are
   semantic);
6. regex DB: full-line-removal categories (closing_phrase,
   meta_reference, media_reference, nonsensical) drop the line; other
   categories strip only the match, honoring the ``${N:0:M}`` slice
   replacement syntax;
7. fuzzy match against phrases distilled from the regex DB + user
   blacklist (threshold 0.9), guarded by the valid-Japanese-expression
   heuristic so real speech never fuzzy-matches away.

All patterns are applied with linear-time discipline; the ReDoS suite
(tests/test_redos.py) exercises every pattern loaded from the DB.
"""

from __future__ import annotations

import json
import os
import re
import time
import unicodedata
from dataclasses import dataclass
from difflib import SequenceMatcher
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from whisperjav_tpu_torch.utils.logger import logger

CACHE_DIR = Path.home() / ".cache" / "whisperjav-tpu" / "hallucination_filters"
CACHE_MAX_AGE_DAYS = 7.0
FUZZY_MATCH_THRESHOLD = 0.9
MIN_CONFIDENCE_THRESHOLD = 0.5

LANGUAGE_CODE_MAP = {
    "ja": "japanese", "jp": "japanese", "japanese": "japanese",
    "ko": "korean", "korean": "korean",
    "zh": "chinese", "zh-cn": "chinese", "zh-tw": "chinese",
    "chinese": "chinese",
    "en": "english", "english": "english",
    "af": "afrikaans", "afrikaans": "afrikaans",
}

BRACKET_PAIRS = (("(", ")"), ("[", "]"), ("{", "}"),
                 ("（", "）"), ("［", "］"), ("｛", "｝"), ("【", "】"))

FULL_LINE_REMOVAL_CATEGORIES = {
    "closing_phrase", "meta_reference", "media_reference", "nonsensical",
}

FUZZY_SOURCE_CATEGORIES = {
    "meta_reference", "media_reference", "closing_phrase",
    "nonsensical", "user_defined",
}

# ${N:0:M} → keep first M characters of match.group(N)
_SLICE_SYNTAX_RE = re.compile(r"^\$\{(\d+):0:(\d+)\}$")

# Misc Symbols / Dingbats / emoji blocks — any hit drops the line
_EMOJI_RE = re.compile(r"[☀-⛿✂-➰\U0001F300-\U0001FAFF]")

# Characters stripped for the fully-normalized match. ー (U+30FC) and the
# combining voicing mark ゛ (U+3099) are NOT stripped — they are semantic.
_STRIP_CHARS = frozenset(
    " \t\n\r\x0b\x0c　"
    "\"'`‘’“”「」『』"
    ".,!?;:-"
    "．，！？；："
    "。、・…"
    "〜〰～~"
)

_HIRAGANA_RE = re.compile(r"[぀-ゟ]")
_KATAKANA_RE = re.compile(r"[゠-ヿ]")
_KANJI_RE = re.compile(r"[一-鿿]")
_NUM_CURRENCY_RE = re.compile(r"[\d¥$€£円]")
_JA_ENDINGS = ("です", "だ", "である", "ます", "でした", "いる", "ある",
               "する", "した")


def normalize_text(text: str) -> str:
    """NFKC + strip all whitespace + lowercase — legacy comparison space."""
    t = unicodedata.normalize("NFKC", text)
    return re.sub(r"\s+", "", t).lower()


def normalize_for_match(text: str) -> str:
    """Stage-5 normalization: strip whitespace/quotes/punct, casefold."""
    if not text:
        return ""
    return "".join(ch for ch in text if ch not in _STRIP_CHARS).lower()


# ---------------------------------------------------------------------------
# DB loading: explicit → cache → bundled (→ URL only when opted in)
# ---------------------------------------------------------------------------

def _read_json(path: Path) -> Optional[Dict]:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except Exception as e:  # noqa: BLE001
        logger.debug("filter DB read failed for %s: %s", path, e)
        return None


def _cache_fresh(path: Path) -> bool:
    if not path.exists():
        return False
    age_days = (time.time() - path.stat().st_mtime) / 86400.0
    return age_days < CACHE_MAX_AGE_DAYS


def load_filter_db(kind: str, explicit: Optional[str] = None,
                   url: Optional[str] = None) -> Tuple[Optional[Dict], str]:
    """Resolve a hallucination DB. kind ∈ {"filter_list", "regexp"}.

    Returns (data, source_label). Chain mirrors the reference
    (hallucination_remover.py:272-344) with the URL step gated behind
    WJAV_FILTER_URL_OK (zero-egress default).
    """
    from whisperjav_tpu_torch.data.hallucination_filters import (
        bundled_filter_list_path, bundled_regexp_path,
    )

    if explicit:
        data = _read_json(Path(explicit))
        if data is not None:
            return data, f"{kind}: explicit path"

    cache_path = CACHE_DIR / f"{kind}.json"
    if _cache_fresh(cache_path):
        data = _read_json(cache_path)
        if data is not None:
            return data, f"{kind}: cache"

    if url and os.environ.get("WJAV_FILTER_URL_OK") == "1":
        try:
            import urllib.request
            with urllib.request.urlopen(url, timeout=10) as resp:
                data = json.loads(resp.read().decode("utf-8"))
            CACHE_DIR.mkdir(parents=True, exist_ok=True)
            cache_path.write_text(json.dumps(data, ensure_ascii=False),
                                  encoding="utf-8")
            return data, f"{kind}: url (fresh)"
        except Exception as e:  # noqa: BLE001
            logger.debug("filter DB download failed: %s", e)

    if cache_path.exists():          # stale cache beats nothing
        data = _read_json(cache_path)
        if data is not None:
            return data, f"{kind}: stale cache"

    bundled = (bundled_filter_list_path() if kind == "filter_list"
               else bundled_regexp_path())
    data = _read_json(bundled)
    if data is not None:
        return data, f"{kind}: bundled"
    return None, f"{kind}: FAILED"


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def is_bracketed_context(text: str) -> Optional[List[str]]:
    """Wrapper sequence when the text is fully bracket-wrapped, else None."""
    inner = text.strip()
    if len(inner) < 3:
        return None
    wrappers: List[str] = []
    matched = True
    while matched:
        matched = False
        for left, right in BRACKET_PAIRS:
            if (inner.startswith(left) and inner.endswith(right)
                    and len(inner) > len(left) + len(right)):
                inner = inner[len(left):-len(right)].strip()
                wrappers.append(left + right)
                matched = True
                break
    return wrappers if wrappers and inner else None


def looks_like_valid_japanese(text: str) -> bool:
    """False-positive guard for fuzzy matching (reference
    hallucination_remover.py:614)."""
    text = text.strip()
    if len(text) <= 10 and any(p in text for p in
                               ("、", "。", "です", "だ", "である")):
        return True
    scripts = sum((bool(_HIRAGANA_RE.search(text)),
                   bool(_KATAKANA_RE.search(text)),
                   bool(_KANJI_RE.search(text))))
    if scripts >= 2:
        return True
    if _NUM_CURRENCY_RE.search(text):
        return True
    return any(e in text for e in _JA_ENDINGS)


def apply_regex_replacement_safe(pattern: re.Pattern, replacement: str,
                                 text: str) -> str:
    """re.sub with ${N:0:M} slice-syntax support; malformed ${...} → ''."""
    if not replacement or replacement in ("null", "None"):
        return pattern.sub("", text)
    m = _SLICE_SYNTAX_RE.match(replacement)
    if m:
        group_num, keep = int(m.group(1)), int(m.group(2))

        def _slice(mm):
            try:
                captured = mm.group(group_num)
            except (IndexError, TypeError):
                return ""
            return captured[:keep] if captured else ""

        return pattern.sub(_slice, text)
    if replacement.startswith("${"):
        return pattern.sub("", text)
    return pattern.sub(replacement, text)


# ---------------------------------------------------------------------------
# stats + remover
# ---------------------------------------------------------------------------

@dataclass
class HallucinationStats:
    exact_removed: int = 0
    regex_removed: int = 0
    fuzzy_removed: int = 0
    bracket_removed: int = 0
    emoji_removed: int = 0
    lines_emptied: int = 0

    @property
    def total(self) -> int:
        return (self.exact_removed + self.regex_removed
                + self.fuzzy_removed + self.bracket_removed
                + self.emoji_removed)


class HallucinationRemover:
    """DB-driven multi-stage hallucination detector (see module doc)."""

    def __init__(self, language: str = "ja",
                 extra_phrases: Optional[Iterable[str]] = None,
                 filter_list_path: Optional[str] = None,
                 regexp_path: Optional[str] = None,
                 min_confidence: float = MIN_CONFIDENCE_THRESHOLD,
                 fuzzy_threshold: float = FUZZY_MATCH_THRESHOLD):
        self.language = (language or "ja").lower()
        self.min_confidence = min_confidence
        self.fuzzy_threshold = fuzzy_threshold
        self.load_sources: List[str] = []

        filter_db, src1 = load_filter_db("filter_list", filter_list_path)
        regex_db, src2 = load_filter_db("regexp", regexp_path)
        self.load_sources += [src1, src2]

        # per-language exact sets at three normalization levels
        self._exact: Dict[str, Set[str]] = {}
        self._exact_punct: Dict[str, Set[str]] = {}
        self._exact_full: Dict[str, Set[str]] = {}
        if filter_db:
            for lang, phrases in filter_db.items():
                plist = [p for p in phrases if isinstance(p, str) and p.strip()]
                self._exact[lang] = {p.strip().lower() for p in plist}
                self._exact_punct[lang] = {
                    p.strip().lower().rstrip(".,!?;:。、！？…") for p in plist}
                self._exact_full[lang] = {
                    n for n in (normalize_for_match(p) for p in plist) if n}
        if extra_phrases:
            self.add_phrases(extra_phrases)

        # regex DB is CJK-only: its nonsensical/sound-effect patterns are
        # written for Japanese transcripts (e.g. all-Latin lines are
        # hallucinations THERE); the reference routes EN to a dedicated
        # cleaner with its own list (srt_postprocessing.py:92).
        mapped = LANGUAGE_CODE_MAP.get(self.language, self.language)
        self._cjk = mapped in ("japanese", "korean", "chinese")
        self._patterns: List[Dict[str, Any]] = []
        if regex_db and self._cjk:
            for info in regex_db.get("patterns", []):
                pat = info.get("pattern", "")
                conf = float(info.get("confidence", 0.9))
                if conf < self.min_confidence or not pat:
                    continue
                try:
                    compiled = re.compile(pat)
                except re.error as e:
                    logger.warning("bad filter pattern %r: %s", pat[:40], e)
                    continue
                self._patterns.append({
                    "re": compiled, "pattern": pat,
                    "category": info.get("category", ""),
                    "confidence": conf,
                    "replacement": info.get("replacement", "") or "",
                })

        if self._cjk:
            self._fuzzy_phrases = self._distill_fuzzy_phrases()
        else:
            # EN-class: fuzzy against the language's own exact phrases
            # (the reference's EnglishSubtitleCleaner behavior)
            self._fuzzy_phrases = sorted(
                self._exact.get(mapped, set()), key=len, reverse=True)

    # -- setup helpers ------------------------------------------------------

    def _lang_key(self) -> str:
        mapped = LANGUAGE_CODE_MAP.get(self.language, self.language)
        if mapped in self._exact:
            return mapped
        return "japanese" if "japanese" in self._exact else mapped

    def add_phrases(self, phrases: Iterable[str]) -> None:
        key = LANGUAGE_CODE_MAP.get(self.language, self.language)
        for store, norm in ((self._exact, lambda p: p.strip().lower()),
                            (self._exact_punct,
                             lambda p: p.strip().lower().rstrip(".,!?;:。、！？…")),
                            (self._exact_full, normalize_for_match)):
            dst = store.setdefault(key, set())
            dst |= {norm(p) for p in phrases if p.strip()}

    def _distill_fuzzy_phrases(self) -> List[str]:
        """Literal-ish phrases from the regex DB for fuzzy matching
        (reference hallucination_remover.py:420-450)."""
        out: List[str] = []
        special = set(r".*+?^${}()|[]\<>")
        for info in self._patterns:
            if info["category"] not in FUZZY_SOURCE_CATEGORIES:
                continue
            pat = info["pattern"]
            if sum(1 for ch in pat if ch in special) <= 2 and len(pat) > 5:
                cleaned = pat
                for ch in r"\^$.*+?()[]{}|":
                    cleaned = cleaned.replace(ch, "")
                if len(cleaned) >= 3:
                    out.append(cleaned)
        return out

    # -- public API ---------------------------------------------------------

    def database_stats(self) -> Dict[str, Any]:
        return {
            "exact_lists": {k: len(v) for k, v in self._exact.items()},
            "regex_patterns": len(self._patterns),
            "fuzzy_phrases": len(self._fuzzy_phrases),
            "sources": list(self.load_sources),
        }

    def iter_patterns(self) -> List[str]:
        """All loaded regex pattern strings (for the ReDoS suite)."""
        return [p["pattern"] for p in self._patterns]

    def is_hallucination(self, text: str) -> bool:
        cleaned, stats = self.clean(text)
        return stats.total > 0 and not cleaned.strip()

    def _check_line(self, text: str, stats: HallucinationStats) -> str:
        """Run the full stage chain on one line; '' when dropped."""
        stripped = text.strip()
        if not stripped:
            return ""

        if is_bracketed_context(stripped):
            stats.bracket_removed += 1
            return ""
        if _EMOJI_RE.search(stripped):
            stats.emoji_removed += 1
            return ""

        key = self._lang_key()
        low = stripped.lower()
        if low in self._exact.get(key, ()):
            stats.exact_removed += 1
            return ""
        if low.rstrip(".,!?;:。、！？…") in self._exact_punct.get(key, ()):
            stats.exact_removed += 1
            return ""
        full = normalize_for_match(stripped)
        if full and full in self._exact_full.get(key, ()):
            stats.exact_removed += 1
            return ""

        # regex substitutions run on the RAW line (edge whitespace intact):
        # the downstream repetition patterns treat trailing separators as
        # part of the repeated unit (e.g. "はい はい はい はい はい "), and
        # the reference never strips between stages — the chain strips once
        # at the very end (subtitle_sanitizer.py:541)
        current = text
        for info in self._patterns:
            if not info["re"].search(current):
                continue
            if info["category"] in FULL_LINE_REMOVAL_CATEGORIES:
                stats.regex_removed += 1
                return ""
            new = apply_regex_replacement_safe(info["re"],
                                               info["replacement"], current)
            if new != current:
                stats.regex_removed += 1
                current = new
                if not current.strip():
                    return ""

        if (len(current.strip()) >= 3 and self._fuzzy_phrases
                and not looks_like_valid_japanese(current)):
            norm = current.strip().lower()
            for phrase in self._fuzzy_phrases:
                p = phrase.strip().lower()
                if len(p) < 3 or len(p) < len(norm) * 0.3:
                    continue
                if SequenceMatcher(None, norm, p).ratio() >= \
                        self.fuzzy_threshold:
                    stats.fuzzy_removed += 1
                    return ""
        return current

    def clean(self, text: str) -> Tuple[str, HallucinationStats]:
        stats = HallucinationStats()
        if not text:
            return text, stats
        kept = [out for ln in text.split("\n")
                if (out := self._check_line(ln, stats)).strip()]
        # do NOT strip here: trailing separators feed the repetition
        # cleaner's unit patterns; the sanitizer chain strips once at the
        # end (reference: subtitle_sanitizer.py:541)
        result = "\n".join(kept)
        if text.strip() and not result.strip():
            stats.lines_emptied += 1
            result = ""
        return result, stats
