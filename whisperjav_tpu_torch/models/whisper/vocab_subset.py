"""Vocab-sliced decoding: shrink the LM head to a language-plausible
token subset.

The port's copy of ``whisperjav_tpu/models/whisper/vocab_subset.py``
(numpy only).

The final (d_model, n_vocab) projection and the (B, n_vocab) logit-rule
tensors are sized by the FULL multilingual vocabulary (51,865 ids) even
though a Japanese transcription run can only ever emit JA-script /
ASCII / punctuation text tokens plus the special tail. Slicing the head
to that subset cuts the per-step lm-head weight stream and every
(B, V) logit-rule op proportionally (ADR-002 round-4 lever; the
reference has no analogue — CTranslate2 always projects the full
vocab).

Design: the kept ids are ``sub_ids = sorted(keep_text_ids) +
[eot .. n_vocab)`` — the special tail (EOT, SOT, language/task tags,
no-speech, timestamps) is ALWAYS kept whole, so every id >= eot maps to
``id - shift`` with one constant ``shift = n_vocab - len(sub_ids)``.
That makes a sliced `WhisperConfig` exact: all special-token properties
shift uniformly, and the timestamp grammar (contiguous tail compare)
is preserved bit-for-bit. Text ids remap by position via searchsorted.

Decoding runs entirely in subset id space; the engine maps emitted
tokens back to full-vocab ids with one gather, so tokenizers, quality
gates, and word alignment downstream never see subset ids.

Exactness: if the full-vocab decode would only ever emit kept ids, the
sliced decode emits the identical token sequence — logits of kept ids
equal the full run's (same hidden states, same rows of the head), and
every rule (suppression, penalties, n-gram bans, timestamp grammar)
sees the same history. Tokens outside the subset become unreachable —
which is the point: for JA decoding they are noise candidates only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from whisperjav_tpu_torch.models.whisper.config import WhisperConfig


@dataclasses.dataclass(frozen=True)
class SlicedVocabConfig(WhisperConfig):
    """A WhisperConfig whose vocab is ``sub_ids``; special ids shift by
    ``full_n_vocab - n_vocab`` (the special tail is kept contiguously)."""

    full_n_vocab: int = 51865

    @property
    def vocab_shift(self) -> int:
        return self.full_n_vocab - self.n_vocab

    # --- every special id = full-vocab id - shift ---------------------
    @property
    def eot(self) -> int:
        return 50257 - self.vocab_shift

    @property
    def sot(self) -> int:
        return 50258 - self.vocab_shift

    @property
    def lang_token_offset(self) -> int:
        return self.sot + 1

    @property
    def translate(self) -> int:
        return (50358 if self.full_n_vocab == 51865 else 50359) \
            - self.vocab_shift

    @property
    def transcribe(self) -> int:
        return (50359 if self.full_n_vocab == 51865 else 50360) \
            - self.vocab_shift

    @property
    def sot_prev(self) -> int:
        return (50361 if self.full_n_vocab == 51865 else 50362) \
            - self.vocab_shift

    @property
    def no_speech(self) -> int:
        return (50362 if self.full_n_vocab == 51865 else 50363) \
            - self.vocab_shift

    @property
    def no_timestamps(self) -> int:
        return (50363 if self.full_n_vocab == 51865 else 50364) \
            - self.vocab_shift

    @property
    def timestamp_begin(self) -> int:
        return (50364 if self.full_n_vocab == 51865 else 50365) \
            - self.vocab_shift


class VocabSubset:
    """Precomputed id maps for one (config, keep_text_ids) pair."""

    def __init__(self, config: WhisperConfig,
                 keep_text_ids: Sequence[int]):
        keep = np.unique(np.asarray(keep_text_ids, np.int32))
        if keep.size and (keep[0] < 0 or keep[-1] >= config.eot):
            raise ValueError(
                f"keep_text_ids must lie in [0, eot={config.eot}); "
                f"got range [{keep[0]}, {keep[-1]}]")
        tail = np.arange(config.eot, config.n_vocab, dtype=np.int32)
        self.sub_ids = np.concatenate([keep, tail])      # sorted
        self.full_config = config
        self.config = SlicedVocabConfig(
            **{f.name: getattr(config, f.name)
               for f in dataclasses.fields(WhisperConfig)
               if f.name != "n_vocab"},
            n_vocab=int(self.sub_ids.size),
            full_n_vocab=config.n_vocab)

    # ------------------------------------------------------------------
    def to_subset(self, ids: Sequence[int],
                  strict: bool = False) -> Tuple[int, ...]:
        """Full-vocab ids → subset ids; non-kept ids are dropped
        (strict=True raises instead — for prompt tokens, where silently
        dropping would change conditioning)."""
        out = []
        for t in ids:
            pos = int(np.searchsorted(self.sub_ids, t))
            if pos < self.sub_ids.size and self.sub_ids[pos] == t:
                out.append(pos)
            elif strict:
                raise ValueError(f"token id {t} not in the vocab subset")
        return tuple(out)

    def to_full(self, ids):
        """Subset-space id array → full-vocab ids (vectorized gather)."""
        return np.asarray(self.sub_ids)[np.asarray(ids)]

    def remap_options(self, options):
        """DecodeOptions with suppress list + blank id in subset space."""
        blank = self.to_subset([options.blank_token])
        return dataclasses.replace(
            options,
            suppress_tokens=self.to_subset(options.suppress_tokens),
            # if " " is not kept it cannot be emitted; point the
            # first-step blank suppression at EOT (already suppressed
            # there) to keep the rule shape valid
            blank_token=blank[0] if blank else self.config.eot)


class SubsetTokenizerAdapter:
    """Tokenizer view over subset-space ids (word-alignment path: the
    teacher-forced pass runs in subset space against the sliced
    embedding table, but word text must decode from full-vocab ids)."""

    def __init__(self, subset: "VocabSubset", tokenizer):
        self._subset = subset
        self._tok = tokenizer
        self.is_real = getattr(tokenizer, "is_real", False)

    def decode(self, ids):
        full = [int(self._subset.sub_ids[int(i)]) for i in ids]
        return self._tok.decode(full)


def synthetic_text_ids(config: WhisperConfig, n_text: int) -> np.ndarray:
    """Evenly-spaced measurement subset of n_text text ids.

    Decode cost depends only on |subset|, not on WHICH ids are kept, so
    benches use this without a tokenizer (WJAV_VOCAB_SLICE=<int>)."""
    n_text = max(1, min(int(n_text), config.eot))
    return np.unique(np.linspace(0, config.eot - 1, n_text).astype(np.int32))


# Unicode ranges that can appear in Japanese transcription output:
# Hiragana, Katakana (+ phonetic ext), CJK unified (+ ext A), CJK
# punctuation, fullwidth forms, halfwidth katakana, ASCII.
_JA_RANGES = (
    (0x0020, 0x007E),   # ASCII printable
    (0x3000, 0x303F),   # CJK symbols/punctuation
    (0x3040, 0x309F),   # hiragana
    (0x30A0, 0x30FF),   # katakana
    (0x31F0, 0x31FF),   # katakana phonetic extensions
    (0x3400, 0x4DBF),   # CJK ext A
    (0x4E00, 0x9FFF),   # CJK unified
    (0xFF00, 0xFFEF),   # full/halfwidth forms
    (0x2010, 0x2027),   # general punctuation subset (dashes, ellipsis)
    (0x2030, 0x205E),
)


def _ja_plausible(text: str) -> bool:
    return all(any(lo <= ord(c) <= hi for lo, hi in _JA_RANGES)
               or c in "\n\téü"   # stray latin-1 accents ok
               for c in text)


def ja_text_ids(tokenizer, config: WhisperConfig) -> Optional[np.ndarray]:
    """Derive the JA-plausible text-token subset from a REAL tokenizer
    (requires a local checkpoint's vocab under zero egress). Returns
    None when only the fallback tokenizer is available.

    Byte-level BPE caveat: ids whose bytes are not standalone-decodable
    (UTF-8 continuation fragments) are KEPT — multi-token kanji
    sequences need them. Only ids decoding cleanly to non-JA scripts
    (latin letters beyond ASCII already excluded, cyrillic, arabic, ...)
    are dropped.
    """
    if not getattr(tokenizer, "is_real", False):
        return None
    keep = []
    for t in range(config.eot):
        try:
            s = tokenizer.decode([t])
        except Exception:
            keep.append(t)          # undecodable alone: keep (fragment)
            continue
        if "�" in s or _ja_plausible(s):
            keep.append(t)          # fragment or JA-plausible
    return np.asarray(keep, np.int32)
