"""Translation instruction management: cache → bundled, URL opt-in
(the port's copy of ``whisperjav_tpu/translate/instructions.py``; the
same cache directory).

Role parity with the reference's instructions machinery (reference:
whisperjav/translate/instructions.py — per-tone instruction text fetched
from Gist with ETag caching and a bundled fallback). The zero-egress
default here is cache → bundled; set WJAV_FILTER_URL_OK=1 to allow a
refresh from the configured URLs.
"""

from __future__ import annotations

import os
import urllib.request
from pathlib import Path
from typing import Dict, Optional

from whisperjav_tpu_torch.utils.logger import logger

CACHE_DIR = Path.home() / ".cache" / "whisperjav-tpu" / "instructions"

INSTRUCTION_URLS: Dict[str, str] = {
    # populated by deployments that allow egress; empty by default
}

# Bundled defaults: the behavioral contract the reference's instruction
# files implement — numbered-line protocol, tone guidance.
_BUNDLED: Dict[str, str] = {
    "standard": (
        "You are a professional subtitle translator. Translate each "
        "numbered Japanese subtitle line into natural {target}. Rules:\n"
        "1. Reply with the SAME numbered list, one translation per line.\n"
        "2. Never merge, split, reorder, or drop lines.\n"
        "3. Keep each line short enough to read as a subtitle.\n"
        "4. Preserve the speaker's register and emotional tone.\n"
        "5. Do not add notes, explanations, or romaji.\n"
    ),
    "pornify": (
        "You are a professional adult-content subtitle translator. "
        "Translate each numbered Japanese subtitle line into explicit, "
        "natural {target} appropriate for adult video subtitles. Rules:\n"
        "1. Reply with the SAME numbered list, one translation per line.\n"
        "2. Never merge, split, reorder, or drop lines.\n"
        "3. Use direct, colloquial language; preserve moans and "
        "interjections as natural equivalents.\n"
        "4. Do not censor, soften, or annotate.\n"
    ),
}


def get_instruction_content(tone: str = "standard",
                            target: str = "English",
                            refresh: bool = False) -> Optional[str]:
    """Resolve instruction text: cache → bundled (URL refresh opt-in)."""
    cache_path = CACHE_DIR / f"instruction_{tone}.txt"

    url = INSTRUCTION_URLS.get(tone)
    if url and (refresh or not cache_path.exists()) \
            and os.environ.get("WJAV_FILTER_URL_OK") == "1":
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                content = resp.read().decode("utf-8")
            CACHE_DIR.mkdir(parents=True, exist_ok=True)
            cache_path.write_text(content, encoding="utf-8")
        except Exception as e:  # noqa: BLE001
            logger.debug("instruction fetch failed (%s); using fallback", e)

    if cache_path.exists():
        try:
            return cache_path.read_text(encoding="utf-8").format(
                target=target)
        except Exception:  # noqa: BLE001 — malformed cache → bundled
            pass

    content = _BUNDLED.get(tone)
    if content is None:
        logger.warning("no instructions for tone %r; using standard", tone)
        content = _BUNDLED["standard"]
    return content.format(target=target)
