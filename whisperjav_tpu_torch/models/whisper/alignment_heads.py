"""Per-model word-alignment head tables + the openai blob format.

Word-timestamp quality depends on WHICH decoder cross-attention heads
feed the DTW aligner (word_align.py). The whisper ecosystem publishes a
per-model head list two ways:

  * HF checkpoints: ``generation_config.alignment_heads`` — a JSON list
    of [layer, head] pairs (convert.load_pretrained reads this first);
  * openai-whisper: ``_ALIGNMENT_HEADS`` — a base85-encoded,
    gzip-compressed boolean (n_text_layer, n_text_head) mask baked into
    the package. :func:`decode_alignment_heads_blob` decodes that format
    so openai-format checkpoints can be used directly.

Resolution order (highest wins):
  1. the checkpoint's ``generation_config.alignment_heads``;
  2. an ``alignment_heads.json`` file next to the checkpoint
     (``{"alignment_heads": [[l, h], ...]}`` or a raw list);
  3. the bundled per-model table ``data/alignment_heads.json``
     (community-published values from the HF generation configs;
     checkpoint metadata always takes precedence);
  4. word_align.default_head_mask's top-half-layers fallback.

Reference role: stable-ts word-timestamp adjustment over
faster-whisper's aligner (whisperjav/modules/stable_ts_asr.py); the
head tables are the same data openai-whisper ships as blobs.
"""

from __future__ import annotations

import base64
import gzip
import json
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from whisperjav_tpu_torch.utils.logger import logger

HeadList = Tuple[Tuple[int, int], ...]

_DATA_FILE = (Path(__file__).resolve().parents[2]
              / "data" / "alignment_heads.json")
_cached_table: Optional[dict] = None


def decode_alignment_heads_blob(blob, n_text_layer: int,
                                n_text_head: int) -> HeadList:
    """Decode an openai-whisper ``_ALIGNMENT_HEADS`` blob.

    Format: base85(gzip(bool array of shape (n_text_layer, n_text_head)))
    — the mask marks which cross-attention heads align to audio time.
    Accepts bytes or str.
    """
    if isinstance(blob, str):
        blob = blob.encode("ascii")
    raw = gzip.decompress(base64.b85decode(blob))
    mask = np.frombuffer(raw, dtype=bool)
    expect = n_text_layer * n_text_head
    if mask.size != expect:
        raise ValueError(
            f"alignment-head blob decodes to {mask.size} entries, expected "
            f"{n_text_layer}x{n_text_head}={expect}")
    mask = mask.reshape(n_text_layer, n_text_head)
    layers, heads = np.nonzero(mask)
    return tuple((int(l), int(h)) for l, h in zip(layers, heads))


def encode_alignment_heads_blob(heads: Sequence[Sequence[int]],
                                n_text_layer: int,
                                n_text_head: int) -> bytes:
    """Inverse of :func:`decode_alignment_heads_blob` (round-trip tests,
    exporting tables in the openai format)."""
    mask = np.zeros((n_text_layer, n_text_head), dtype=bool)
    for l, h in heads:
        mask[int(l), int(h)] = True
    return base64.b85encode(gzip.compress(mask.tobytes()))


def _bundled_table() -> dict:
    global _cached_table
    if _cached_table is None:
        try:
            _cached_table = json.loads(_DATA_FILE.read_text())
        except (OSError, json.JSONDecodeError) as e:
            logger.warning("bundled alignment-head table unreadable: %s", e)
            _cached_table = {}
    return _cached_table


def _name_candidates(model_name: str):
    """Normalize checkpoint names/paths to table keys.

    "/ckpt/whisper-large-v2" → ["<as-is>", "whisper-large-v2",
    "large-v2"]; "openai/whisper-tiny.en" → [..., "tiny.en"].
    """
    yield model_name
    base = model_name.rstrip("/").split("/")[-1]
    yield base
    if base.startswith("whisper-"):
        yield base[len("whisper-"):]


def bundled_alignment_heads(model_name: str) -> Optional[HeadList]:
    """Bundled per-model head list, or None if the model has no entry."""
    models = _bundled_table().get("models", {})
    for key in _name_candidates(model_name):
        entry = models.get(key)
        if entry:
            return tuple((int(l), int(h)) for l, h in entry)
    return None


def _sidecar_heads(checkpoint_dir) -> Optional[HeadList]:
    p = Path(checkpoint_dir) / "alignment_heads.json"
    if not p.is_file():
        return None
    try:
        data = json.loads(p.read_text())
    except (OSError, json.JSONDecodeError) as e:
        logger.warning("unreadable %s: %s", p, e)
        return None
    if isinstance(data, dict):
        data = data.get("alignment_heads", [])
    return tuple((int(l), int(h)) for l, h in data) or None


def resolve_alignment_heads(
    model_name: str,
    n_text_layer: int,
    n_text_head: int,
    generation_config_heads=None,
    checkpoint_dir=None,
) -> Optional[HeadList]:
    """Best available head list for a model (None → caller's fallback).

    Out-of-range pairs are dropped with a warning (a table for the wrong
    architecture must not silently misalign words).
    """
    source = None
    heads: Optional[HeadList] = None
    if generation_config_heads:
        heads = tuple((int(l), int(h)) for l, h in generation_config_heads)
        source = "generation_config"
    if heads is None and checkpoint_dir is not None:
        heads = _sidecar_heads(checkpoint_dir)
        source = "checkpoint alignment_heads.json"
    if heads is None:
        heads = bundled_alignment_heads(model_name)
        source = "bundled table"
    if heads is None:
        return None
    valid = tuple((l, h) for l, h in heads
                  if 0 <= l < n_text_layer and 0 <= h < n_text_head)
    if len(valid) != len(heads):
        logger.warning(
            "%d/%d alignment heads from %s out of range for %s "
            "(%dL x %dH) — dropped",
            len(heads) - len(valid), len(heads), source, model_name,
            n_text_layer, n_text_head)
    return valid or None
