"""Whisper model family configuration.

Size table follows the published Whisper architecture (tiny…large-v3,
turbo). The reference consumes these models through faster-whisper /
openai-whisper / HF transformers (reference:
whisperjav/modules/faster_whisper_pro_asr.py:31,
whisperjav/modules/whisper_pro_asr.py:29); here they are native JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class WhisperConfig:
    name: str = "tiny"
    n_mels: int = 80
    n_audio_ctx: int = 1500          # encoder frames after conv stride-2
    n_audio_state: int = 384         # d_model
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865             # multilingual v1/v2 vocab
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    # per-model word-alignment heads ((layer, head) pairs) from the
    # checkpoint's generation_config; None → top-half-layers fallback
    # (models/whisper/word_align.py)
    alignment_heads: Optional[Tuple[Tuple[int, int], ...]] = None

    # --- special token ids (multilingual vocab; +1 for large-v3/turbo) ---
    @property
    def eot(self) -> int:
        return 50257

    @property
    def sot(self) -> int:
        return 50258

    @property
    def lang_token_offset(self) -> int:
        # <|en|> = sot+1; language id adds its index
        return self.sot + 1

    @property
    def translate(self) -> int:
        return 50358 if self.n_vocab == 51865 else 50359

    @property
    def transcribe(self) -> int:
        return 50359 if self.n_vocab == 51865 else 50360

    @property
    def sot_prev(self) -> int:
        return 50361 if self.n_vocab == 51865 else 50362

    @property
    def no_speech(self) -> int:
        # <|nospeech|> / <|nocaptions|>
        return 50362 if self.n_vocab == 51865 else 50363

    @property
    def no_timestamps(self) -> int:
        return 50363 if self.n_vocab == 51865 else 50364

    @property
    def timestamp_begin(self) -> int:
        # <|0.00|>; timestamps advance in 0.02 s steps
        return 50364 if self.n_vocab == 51865 else 50365

    @property
    def head_dim(self) -> int:
        return self.n_text_state // self.n_text_head

    @property
    def sample_len(self) -> int:
        return self.n_text_ctx // 2  # max new tokens per 30 s window


# Language id order of the multilingual tokenizer: index of "ja" etc.
# (subset; full table loaded with a real tokenizer when available)
LANGUAGES = [
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su",
]


def language_token(config: WhisperConfig, language: str = "ja") -> int:
    try:
        return config.lang_token_offset + LANGUAGES.index(language)
    except ValueError:
        raise ValueError(f"unknown language code: {language}")


def _cfg(name, n_mels, d, heads, enc_layers, dec_layers, vocab=51865):
    return WhisperConfig(
        name=name, n_mels=n_mels,
        n_audio_state=d, n_audio_head=heads, n_audio_layer=enc_layers,
        n_text_state=d, n_text_head=heads, n_text_layer=dec_layers,
        n_vocab=vocab,
    )


WHISPER_SIZES = {
    "tiny": _cfg("tiny", 80, 384, 6, 4, 4),
    "base": _cfg("base", 80, 512, 8, 6, 6),
    "small": _cfg("small", 80, 768, 12, 12, 12),
    "medium": _cfg("medium", 80, 1024, 16, 24, 24),
    "large-v2": _cfg("large-v2", 80, 1280, 20, 32, 32),
    "large-v3": _cfg("large-v3", 128, 1280, 20, 32, 32, vocab=51866),
    "turbo": _cfg("turbo", 128, 1280, 20, 32, 4, vocab=51866),
    "large-v3-turbo": _cfg("large-v3-turbo", 128, 1280, 20, 32, 4, vocab=51866),
}
