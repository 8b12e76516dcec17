"""SRT/VTT subtitle codec, stitching, and data model.

Fresh implementation of the roles of the reference's ``srt`` / ``pysrt``
dependencies plus ``whisperjav/modules/srt_stitching.py:19-84`` (offset,
clamp non-positive durations, renumber) and the SRT→VTT converter
(``whisperjav/modules/srt_postprocessing.py:255``).

Times are float seconds end-to-end; rendering formats them as
``HH:MM:SS,mmm``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple, Union


@dataclass
class Subtitle:
    index: int
    start: float  # seconds
    end: float    # seconds
    text: str

    @property
    def duration(self) -> float:
        return self.end - self.start

    def shifted(self, offset: float) -> "Subtitle":
        return Subtitle(self.index, self.start + offset, self.end + offset, self.text)


_TIME_RE = re.compile(
    r"(\d{1,2}):(\d{1,2}):(\d{1,2})[,.](\d{1,3})"
)


def parse_timestamp(ts: str) -> float:
    m = _TIME_RE.search(ts)
    if not m:
        raise ValueError(f"bad SRT timestamp: {ts!r}")
    h, mnt, s, ms = m.groups()
    return int(h) * 3600 + int(mnt) * 60 + int(s) + int(ms.ljust(3, "0")) / 1000.0


def format_timestamp(seconds: float, vtt: bool = False) -> str:
    if seconds < 0:
        seconds = 0.0
    ms = int(round(seconds * 1000))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    sep = "." if vtt else ","
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def parse_srt(content: str) -> List[Subtitle]:
    """Parse SRT text into subtitles. Tolerant of BOM, CRLF, stray blanks."""
    content = content.lstrip("﻿").replace("\r\n", "\n").replace("\r", "\n")
    subs: List[Subtitle] = []
    blocks = re.split(r"\n\s*\n", content.strip())
    for block in blocks:
        lines = [ln for ln in block.split("\n")]
        if not lines:
            continue
        # Optional numeric index line
        i = 0
        if lines and lines[0].strip().isdigit():
            i = 1
        if i >= len(lines) or "-->" not in lines[i]:
            continue
        try:
            left, right = lines[i].split("-->")
            start = parse_timestamp(left)
            end = parse_timestamp(right)
        except (ValueError, IndexError):
            continue
        text = "\n".join(lines[i + 1:]).strip()
        subs.append(Subtitle(len(subs) + 1, start, end, text))
    return subs


def load_srt(path: Union[str, Path]) -> List[Subtitle]:
    return parse_srt(Path(path).read_text(encoding="utf-8", errors="replace"))


def compose_srt(subs: Sequence[Subtitle], renumber: bool = True) -> str:
    out = []
    for i, sub in enumerate(subs, start=1):
        idx = i if renumber else sub.index
        out.append(
            f"{idx}\n{format_timestamp(sub.start)} --> {format_timestamp(sub.end)}\n{sub.text}\n"
        )
    return "\n".join(out)


def save_srt(path: Union[str, Path], subs: Sequence[Subtitle]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(compose_srt(subs), encoding="utf-8")


def compose_vtt(subs: Sequence[Subtitle]) -> str:
    lines = ["WEBVTT", ""]
    for i, sub in enumerate(subs, start=1):
        lines.append(str(i))
        lines.append(
            f"{format_timestamp(sub.start, vtt=True)} --> {format_timestamp(sub.end, vtt=True)}"
        )
        lines.append(sub.text)
        lines.append("")
    return "\n".join(lines)


def srt_to_vtt(srt_path: Union[str, Path], vtt_path: Optional[Union[str, Path]] = None) -> Path:
    srt_path = Path(srt_path)
    if vtt_path is None:
        vtt_path = srt_path.with_suffix(".vtt")
    subs = load_srt(srt_path)
    Path(vtt_path).write_text(compose_vtt(subs), encoding="utf-8")
    return Path(vtt_path)


def add_signatures(
    srt_path: Union[str, Path],
    producer_credit: Optional[str] = None,
    add_technical_sig: bool = True,
    mode: str = "balanced",
    sensitivity: str = "balanced",
    version: Optional[str] = None,
) -> None:
    """Add producer credit / technical signature cues to an SRT file.

    Mirrors the reference's ``add_signatures_to_srt`` (whisperjav/
    main.py:698-770): an optional credit cue at 0–100 ms, and a
    "WhisperJAV <version> | Mode/Sensitivity" cue starting 500 ms after
    the last subtitle, lasting 2 s. Failures never abort the run.
    """
    try:
        path = Path(srt_path)
        if not path.exists():
            return
        subs = load_srt(path)
        if not subs:
            return
        if producer_credit and producer_credit.strip():
            subs.insert(0, Subtitle(0, 0.0, 0.1, producer_credit.strip()))
        if add_technical_sig:
            if version is None:
                from whisperjav_tpu_torch.version import __version__ as version
            sig = (f"WhisperJAV-TPU {version} | "
                   f"{mode.capitalize()}/{sensitivity.capitalize()}")
            start = subs[-1].end + 0.5
            subs.append(Subtitle(0, start, start + 2.0, sig))
        save_srt(path, subs)
    except Exception:  # signature failure must not fail the run
        pass


MIN_SUBTITLE_DURATION = 0.1  # guard for non-positive durations while stitching


def stitch(
    scene_subs: Iterable[Tuple[Sequence[Subtitle], float]],
    min_duration: float = MIN_SUBTITLE_DURATION,
) -> List[Subtitle]:
    """Merge per-scene subtitles into one globally-timed, renumbered list.

    ``scene_subs`` yields ``(subtitles, scene_start_offset_seconds)`` pairs.
    Non-positive durations are clamped to ``min_duration`` (reference:
    whisperjav/modules/srt_stitching.py:52-60 guards the same way).
    """
    merged: List[Subtitle] = []
    for subs, offset in scene_subs:
        for sub in subs:
            start = sub.start + offset
            end = sub.end + offset
            if end <= start:
                end = start + min_duration
            if not sub.text.strip():
                continue
            merged.append(Subtitle(0, start, end, sub.text))
    merged.sort(key=lambda s: (s.start, s.end))
    for i, sub in enumerate(merged, start=1):
        sub.index = i
    return merged
