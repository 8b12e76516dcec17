"""Whisper tokenizer access with an offline-safe fallback.

Production path: load the GPT-2-BPE multilingual tokenizer from a local
checkpoint directory (the same files every Whisper checkpoint ships).
Zero-egress/test path: a deterministic id→kana fallback so the full
pipeline (decode → sanitize → SRT) runs without vocab data; the mapping is
stable and injective enough for round-trip tests but is NOT real text.

Special-token ids live in :class:`~whisperjav_tpu_torch.models.whisper.config.
WhisperConfig`; this module only renders text-token ids.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

from whisperjav_tpu_torch.models.whisper.config import WhisperConfig

# Published default suppress list used by faster-whisper/ctranslate2 for the
# multilingual vocab (`suppress_tokens: [-1]` semantics): punctuation-art,
# music symbols, and special tokens that should never be sampled as text.
DEFAULT_NONSPEECH_TOKENS = (
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63,
    90, 91, 92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350,
    1853, 1982, 2460, 2627, 3246, 3253, 3268, 3536, 3846, 3961, 4183, 4667,
    6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938, 12033, 12331, 12562,
    13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362, 18956, 20075,
    21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470,
    36865, 42863, 47425, 49870, 50254,
)


class WhisperTokenizer:
    """Render Whisper token ids to text; encode text to ids when possible."""

    def __init__(self, config: WhisperConfig,
                 local_path: Optional[str] = None):
        self.config = config
        self._hf = None
        if local_path is not None:
            self._hf = self._load_hf(local_path)

    @staticmethod
    def _load_hf(path: str):
        import transformers
        return transformers.WhisperTokenizerFast.from_pretrained(path)

    @property
    def is_real(self) -> bool:
        return self._hf is not None

    # -- decoding -----------------------------------------------------------
    def decode(self, ids: Sequence[int]) -> str:
        text_ids = [int(i) for i in ids if int(i) < self.config.eot]
        if self._hf is not None:
            return self._hf.decode(text_ids)
        return self._fallback_decode(text_ids)

    def _fallback_decode(self, ids: Sequence[int]) -> str:
        # Deterministic id→kana rendering (testing only): maps each id to a
        # syllable so downstream CJK text processing sees plausible input.
        kana = ("あいうえおかきくけこさしすせそたちつてとなにぬねのはひふへほ"
                "まみむめもやゆよらりるれろわをんアイウエオカキクケコ")
        out = []
        for i in ids:
            out.append(kana[i % len(kana)])
            if i % 17 == 0:
                out.append("、")
        return "".join(out)

    # -- encoding -----------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        if self._hf is not None:
            return self._hf.encode(text, add_special_tokens=False)
        # fallback: hash chars into the text-token range (testing only)
        return [(ord(c) * 7) % 50000 for c in text]

    def non_speech_tokens(self) -> Sequence[int]:
        if self._hf is not None:
            # derive like openai-whisper: tokens rendering to symbols/music
            symbols = set('"#()*+/:;<=>@[\\]^_`{|}~「」『』♪♩♫♬〃〜')
            bad = []
            vocab_size = min(self._hf.vocab_size, self.config.eot)
            for tid in range(vocab_size):
                piece = self._hf.decode([tid]).strip()
                if piece and all(ch in symbols for ch in piece):
                    bad.append(tid)
            return tuple(bad)
        return DEFAULT_NONSPEECH_TOKENS


def find_tokenizer_files(checkpoint_path: Optional[str]) -> Optional[str]:
    """Return a loadable tokenizer source for the checkpoint, or None.

    Accepts both local directories (tokenizer files alongside weights)
    and hub ids resolvable from the local HF cache — the same sources
    ``load_pretrained`` accepts for weights, so real weights never end up
    silently paired with the kana fallback tokenizer.
    """
    if checkpoint_path is None:
        return None
    p = Path(checkpoint_path)
    if (p / "tokenizer.json").exists() or (p / "vocab.json").exists():
        return str(p)
    if not p.exists():
        # maybe a hub id in the local cache; probe without network
        try:
            import transformers
            transformers.WhisperTokenizerFast.from_pretrained(
                checkpoint_path, local_files_only=True)
            return checkpoint_path
        except Exception:  # noqa: BLE001 — any failure means "not usable"
            pass
    from whisperjav_tpu_torch.utils.logger import logger
    logger.warning("no tokenizer found for checkpoint %s — falling back to "
                   "the TESTING kana tokenizer; transcription text will be "
                   "meaningless", checkpoint_path)
    return None
