"""Qwen tokenizer access with an offline-safe fallback.

The port's copy of ``whisperjav_tpu/models/qwen/tokenizer.py``; a real
tokenizer needs ``transformers`` and a local checkpoint.

Mirrors models/whisper/tokenizer.py: production path loads the Qwen2/3
byte-level-BPE tokenizer from a local checkpoint directory (reference:
the qwen-asr package resolves it via AutoTokenizer —
whisperjav/modules/qwen_asr.py:581-608); the zero-egress/test path is a
deterministic id→kana rendering so plumbing tests run without vocab
files.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence


class QwenTokenizer:
    """Render Qwen token ids to text; encode text to ids when possible."""

    def __init__(self, local_path: Optional[str] = None,
                 eos_id: int = 151_645):
        self.eos_id = eos_id
        self._hf = None
        if local_path is not None:
            self._hf = self._load_hf(local_path)
            eos = getattr(self._hf, "eos_token_id", None)
            if eos is not None:
                self.eos_id = int(eos)

    @staticmethod
    def _load_hf(path: str):
        import transformers
        return transformers.AutoTokenizer.from_pretrained(
            path, local_files_only=True)

    @property
    def is_real(self) -> bool:
        return self._hf is not None

    def decode(self, ids: Sequence[int]) -> str:
        ids = [int(i) for i in ids if int(i) != self.eos_id]
        if self._hf is not None:
            return self._hf.decode(ids, skip_special_tokens=True)
        kana = ("あいうえおかきくけこさしすせそたちつてとなにぬねのはひふへほ"
                "まみむめもやゆよらりるれろわをん")
        return "".join(kana[i % len(kana)] for i in ids)

    def encode(self, text: str) -> List[int]:
        if self._hf is not None:
            return self._hf.encode(text, add_special_tokens=False)
        return [(ord(c) * 7) % 4096 for c in text]


def find_tokenizer_files(checkpoint_path: Optional[str]) -> Optional[str]:
    """Return a loadable tokenizer source for the checkpoint, or None.

    Same probe chain as the Whisper twin: a local directory holding
    tokenizer files, else a hub id resolvable from the local HF cache.
    """
    if checkpoint_path is None:
        return None
    p = Path(checkpoint_path)
    if (p / "tokenizer.json").exists() or (p / "vocab.json").exists():
        return str(p)
    if not p.exists():
        try:
            import transformers
            transformers.AutoTokenizer.from_pretrained(
                checkpoint_path, local_files_only=True)
            return checkpoint_path
        except Exception:  # noqa: BLE001 — any failure means "not usable"
            pass
    from whisperjav_tpu_torch.utils.logger import logger
    logger.warning("no tokenizer found for qwen checkpoint %s — falling "
                   "back to the TESTING kana tokenizer; transcription text "
                   "will be meaningless", checkpoint_path)
    return None
