"""Load one pipeline run's artifacts for deep benchmarking.

Role parity with reference ``whisperjav/bench/loader.py`` (which loads
the reference's temp-dir artifact layout): here the artifact set is this
framework's own output family next to the final SRT —

- ``{base}.{lang}.whisperjav.srt``       final subtitles
- ``{base}.whisperjav.json``             run stats (scenes, sanitization)
- ``{base}.transcribe.json``             per-window decode diagnostics
- ``{base}.{lang}.whisperjav.artifacts.srt``  removed cues

Graceful degradation: any missing artifact becomes an empty structure,
never an error (reference loader contract).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from whisperjav_tpu_torch.modules.srt import Subtitle, load_srt
from whisperjav_tpu_torch.utils.logger import logger


@dataclass
class RunArtifacts:
    """Everything a single transcription run left on disk."""
    name: str
    srt_path: Path
    subtitles: List[Subtitle]
    windows: List[Dict] = field(default_factory=list)   # decode diag
    stats: Dict = field(default_factory=dict)
    removed: List[Subtitle] = field(default_factory=list)  # artifacts SRT

    @property
    def scene_spans(self) -> List[Dict]:
        return self.stats.get("scene_spans", [])


def _sibling(srt_path: Path, suffix: str) -> Optional[Path]:
    base = srt_path.name
    for marker in (".ja.whisperjav.srt", ".en.whisperjav.srt",
                   ".whisperjav.srt", ".srt"):
        if base.endswith(marker):
            cand = srt_path.with_name(base[:-len(marker)] + suffix)
            if cand.exists():
                return cand
    return None


def load_run(srt_path: Path, name: Optional[str] = None) -> RunArtifacts:
    srt_path = Path(srt_path)
    subs = load_srt(srt_path) if srt_path.exists() else []

    windows: List[Dict] = []
    tpath = _sibling(srt_path, ".transcribe.json")
    if tpath:
        try:
            windows = json.loads(
                tpath.read_text(encoding="utf-8")).get("windows", [])
        except (json.JSONDecodeError, OSError) as e:
            logger.warning("unreadable %s: %s", tpath, e)

    stats: Dict = {}
    mpath = _sibling(srt_path, ".whisperjav.json")
    if mpath:
        try:
            meta = json.loads(mpath.read_text(encoding="utf-8"))
            stats = meta.get("stats", meta)
        except (json.JSONDecodeError, OSError) as e:
            logger.warning("unreadable %s: %s", mpath, e)

    removed: List[Subtitle] = []
    apath = srt_path.with_name(
        srt_path.name.replace(".srt", ".artifacts.srt"))
    if apath.exists() and apath != srt_path:
        try:
            removed = load_srt(apath)
        except Exception as e:  # noqa: BLE001
            logger.warning("unreadable %s: %s", apath, e)

    return RunArtifacts(name=name or srt_path.stem, srt_path=srt_path,
                        subtitles=subs, windows=windows, stats=stats,
                        removed=removed)
