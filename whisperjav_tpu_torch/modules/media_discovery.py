"""Media discovery: expand files/dirs/globs into a media work list.

Role parity with reference ``whisperjav/modules/media_discovery.py:37-170``
(``MediaDiscovery.discover`` + per-file ffprobe metadata), with a native WAV
header probe so discovery works without ffmpeg installed.
"""

from __future__ import annotations

import glob
import json
import shutil
import subprocess
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

from whisperjav_tpu_torch.utils.logger import logger

MEDIA_EXTENSIONS = {
    ".wav", ".wave", ".mp3", ".flac", ".m4a", ".aac", ".ogg", ".opus", ".wma",
    ".mp4", ".mkv", ".avi", ".mov", ".wmv", ".flv", ".webm", ".ts", ".m2ts",
    ".mpg", ".mpeg", ".3gp",
}
AUDIO_EXTENSIONS = {".wav", ".wave", ".mp3", ".flac", ".m4a", ".aac", ".ogg",
                    ".opus", ".wma"}


@dataclass
class MediaInfo:
    path: Path
    basename: str            # stem used for output naming
    duration: Optional[float] = None
    media_type: str = "unknown"     # audio | video | unknown
    sample_rate: Optional[int] = None
    channels: Optional[int] = None
    extra: Dict = field(default_factory=dict)


def ffprobe_available() -> bool:
    return shutil.which("ffprobe") is not None


def ffprobe_duration(path: Union[str, Path]) -> Optional[float]:
    info = ffprobe_info(path)
    return info.get("duration") if info else None


def ffprobe_info(path: Union[str, Path]) -> Optional[Dict]:
    """Full ffprobe JSON probe → {duration, streams, ...}; None if unavailable."""
    if not ffprobe_available():
        return None
    try:
        proc = subprocess.run(
            ["ffprobe", "-v", "quiet", "-print_format", "json",
             "-show_format", "-show_streams", str(path)],
            capture_output=True, text=True, timeout=60,
        )
        if proc.returncode != 0:
            return None
        data = json.loads(proc.stdout)
        out: Dict = {"streams": data.get("streams", [])}
        fmt = data.get("format", {})
        if "duration" in fmt:
            out["duration"] = float(fmt["duration"])
        for s in out["streams"]:
            if s.get("codec_type") == "audio":
                out["sample_rate"] = int(s.get("sample_rate", 0)) or None
                out["channels"] = s.get("channels")
                break
        return out
    except (subprocess.SubprocessError, ValueError, OSError):
        return None


def probe(path: Union[str, Path]) -> MediaInfo:
    p = Path(path)
    ext = p.suffix.lower()
    media_type = "audio" if ext in AUDIO_EXTENSIONS else (
        "video" if ext in MEDIA_EXTENSIONS else "unknown")
    info = MediaInfo(path=p, basename=p.stem, media_type=media_type)
    if ext in (".wav", ".wave"):
        try:
            from whisperjav_tpu_torch.modules.audio_io import wav_info
            wi = wav_info(p)
            info.duration = wi.duration
            info.sample_rate = wi.sample_rate
            info.channels = wi.num_channels
            return info
        except (ValueError, OSError) as e:
            logger.warning("WAV probe failed for %s: %s", p, e)
    ff = ffprobe_info(p)
    if ff:
        info.duration = ff.get("duration")
        info.sample_rate = ff.get("sample_rate")
        info.channels = ff.get("channels")
        info.extra = {"streams": len(ff.get("streams", []))}
    return info


def discover(inputs: Sequence[Union[str, Path]], recursive: bool = False) -> List[MediaInfo]:
    """Expand files, directories, and glob patterns into probed media infos.

    Mirrors reference ``MediaDiscovery.discover`` semantics: dirs scan for
    known media extensions; globs expand; order is stable and deduplicated.
    """
    found: List[Path] = []
    seen = set()

    def add(p: Path):
        rp = p.resolve()
        if rp not in seen and rp.suffix.lower() in MEDIA_EXTENSIONS:
            seen.add(rp)
            found.append(rp)

    for item in inputs:
        s = str(item)
        p = Path(s)
        if p.is_file():
            if p.suffix.lower() not in MEDIA_EXTENSIONS:
                logger.warning("skipping %s: unrecognized media extension "
                               "%r", p.name, p.suffix)
            add(p)
        elif p.is_dir():
            pattern = "**/*" if recursive else "*"
            for child in sorted(p.glob(pattern)):
                if child.is_file():
                    add(child)
        elif any(ch in s for ch in "*?["):
            for match in sorted(glob.glob(s, recursive=True)):
                mp = Path(match)
                if mp.is_file():
                    add(mp)
        else:
            logger.warning("input not found: %s", s)

    return [probe(p) for p in found]


# ---------------------------------------------------------------------------
# output-directory resolution
# ---------------------------------------------------------------------------

def is_source_sentinel(output_dir) -> bool:
    """True when --output-dir is the ``source`` sentinel (any case,
    surrounding whitespace ignored — reference main.py:974-975)."""
    return str(output_dir).lower().strip() == "source"


def resolve_output_dir(output_dir, media: MediaInfo) -> Path:
    """Per-file output directory.

    The reference's default ``--output-dir source`` saves each SRT next
    to its own input file (main.py:286 default, main.py:1263-1266
    per-file override in the batch loop); anything else is a literal
    directory shared by the whole batch.
    """
    if is_source_sentinel(output_dir):
        return Path(media.path).parent
    return Path(output_dir)
