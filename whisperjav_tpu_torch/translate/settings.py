"""Persisted translation settings with precedence rules (the port's copy
of ``whisperjav_tpu/translate/settings.py``: the same file, so settings
saved by either package's translate CLI are read by both).

Role parity with reference ``whisperjav/translate/settings.py`` —
a user settings JSON (provider/model/tone/batch/movie context) loaded as
CLI defaults, where explicit CLI flags always win. Path:
``$WJAV_CONFIG_DIR`` or ``~/.config/whisperjav-tpu/translate/``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional

from whisperjav_tpu_torch.utils.logger import logger

SETTINGS_VERSION = "v1.0.0"

DEFAULT_SETTINGS: Dict = {
    "version": SETTINGS_VERSION,
    "_comment": "whisperjav-tpu translate user settings",
    "provider": "identity",
    "model": None,
    "target_language": "English",
    "tone": "standard",
    "max_batch_size": 30,
    # scene split gap in seconds (reference: translate/cli.py:293)
    "scene_threshold": 60.0,
    "autosave": True,
    # movie context woven into the translation instructions
    # (reference: settings.py movie_title/movie_plot/actress)
    "movie_title": None,
    "movie_plot": None,
    "actress": None,
    "ollama_url": None,
}


def get_settings_path() -> Path:
    base = os.environ.get("WJAV_CONFIG_DIR")
    root = Path(base) if base else Path.home() / ".config" / "whisperjav-tpu"
    return root / "translate" / "settings.json"


def load_settings() -> Dict:
    """File settings merged over defaults; corrupt files warn and fall
    back (never crash a translation run over a settings file)."""
    merged = dict(DEFAULT_SETTINGS)
    path = get_settings_path()
    if path.exists():
        try:
            data = json.loads(path.read_text(encoding="utf-8"))
            if isinstance(data, dict):
                merged.update(data)
            else:
                logger.warning("settings file %s is not an object; "
                               "using defaults", path)
        except (OSError, json.JSONDecodeError) as e:
            logger.warning("unreadable settings file %s (%s); "
                           "using defaults", path, e)
    return merged


def save_settings(settings: Dict) -> Path:
    """Atomic write (tmp + rename), creating parent dirs."""
    path = get_settings_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    out = {k: v for k, v in settings.items()}
    out["version"] = SETTINGS_VERSION
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(out, indent=2, ensure_ascii=False),
                   encoding="utf-8")
    tmp.replace(path)
    return path


def movie_context_block(settings: Dict) -> Optional[str]:
    """Render movie metadata as an instruction block (the reference
    injects title/plot/actress into the prompt for better pronoun and
    name handling)."""
    parts = []
    if settings.get("movie_title"):
        parts.append(f"Title: {settings['movie_title']}")
    if settings.get("actress"):
        parts.append(f"Performer(s): {settings['actress']}")
    if settings.get("movie_plot"):
        parts.append(f"Plot: {settings['movie_plot']}")
    if not parts:
        return None
    return "Movie context (use for names/pronouns/register):\n" + \
        "\n".join(parts)
