"""Window collection and fixed-shape batching (host code).

A copy of ``whisperjav_tpu/parallel/batching.py``, which imports jax
through its ``N_SAMPLES`` import; here ``N_SAMPLES`` comes from the
port's own ``ops/mel.py``. Every VAD group becomes a window of at most
30 s, windows from all scenes are flattened into one work list and
decoded as padded (B, N_SAMPLES) batches; padding rows are masked out on
the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from whisperjav_tpu_torch.modules.scene_detection.base import Scene
from whisperjav_tpu_torch.modules.segmentation.base import (
    SegmentationResult, SpeechGroup,
)
from whisperjav_tpu_torch.modules.audio_io import WHISPER_SAMPLE_RATE
from whisperjav_tpu_torch.ops.mel import N_SAMPLES


@dataclass
class Window:
    """One ASR decode unit: ≤30 s of audio with its global placement."""
    audio: np.ndarray          # float32, ≤ N_SAMPLES samples @16 kHz
    abs_start: float           # seconds in the source file
    duration: float            # true (unpadded) seconds
    scene_idx: int = 0
    group_idx: int = 0
    speech_segments: List[Tuple[float, float]] = field(default_factory=list)
    # window-relative speech regions, for diagnostics / timestamp fallback
    members: List[Tuple[float, "Window"]] = field(default_factory=list)
    # non-empty for PACKED windows: (offset_in_window_s, original window)
    keep_range: Optional[Tuple[float, float]] = None
    # for OVERLAPPED chunked windows: only segments whose midpoint falls in
    # [lo, hi) (window-relative) are kept — boundary reconciliation


def chunked_windows(
    audio: np.ndarray,
    sample_rate: int = WHISPER_SAMPLE_RATE,
    chunk_s: float = 30.0,
    overlap_s: float = 5.0,
) -> List[Window]:
    """Fixed overlapped chunking (HF-pipeline-style long-form decoding,
    reference: whisperjav/modules/transformers_asr.py:31 — chunked ASR
    with stride overlap). Each chunk owns the span
    [overlap/2, chunk − overlap/2); boundary segments are reconciled by
    midpoint via ``keep_range``."""
    hop = chunk_s - overlap_s
    total = len(audio) / sample_rate
    windows: List[Window] = []
    start = 0.0
    idx = 0
    while start < total:
        a = int(start * sample_rate)
        b = min(a + int(chunk_s * sample_rate), len(audio))
        clip = audio[a:b]
        dur = len(clip) / sample_rate
        lo = 0.0 if idx == 0 else overlap_s / 2.0
        hi = dur if b >= len(audio) else chunk_s - overlap_s / 2.0
        windows.append(Window(
            audio=np.ascontiguousarray(clip, np.float32),
            abs_start=start, duration=dur, scene_idx=idx, group_idx=0,
            keep_range=(lo, hi)))
        if b >= len(audio):
            break
        start += hop
        idx += 1
    return windows


def windows_from_segmentation(
    audio: np.ndarray,
    scene: Scene,
    seg_result: SegmentationResult,
    sample_rate: int = WHISPER_SAMPLE_RATE,
) -> List[Window]:
    """Slice one scene's audio into decode windows, one per VAD group."""
    windows: List[Window] = []
    scene_offset = scene.start
    for gi, group in enumerate(seg_result.groups):
        a = int(round((scene_offset + group.start) * sample_rate))
        b = int(round((scene_offset + group.end) * sample_rate))
        a = max(0, min(a, len(audio)))
        b = max(a, min(b, len(audio)))
        if b - a < int(0.05 * sample_rate):
            continue
        clip = audio[a:b]
        if len(clip) > N_SAMPLES:
            clip = clip[:N_SAMPLES]
        windows.append(Window(
            audio=np.ascontiguousarray(clip, np.float32),
            abs_start=a / sample_rate,
            duration=len(clip) / sample_rate,
            scene_idx=scene.index,
            group_idx=gi,
            speech_segments=[(s.start - group.start, s.end - group.start)
                             for s in group.segments],
        ))
    return windows


def pack_windows(
    windows: Sequence[Window],
    sample_rate: int = WHISPER_SAMPLE_RATE,
    max_duration_s: float = 28.0,
    gap_s: float = 0.6,
) -> List[Window]:
    """Pack short decode windows into shared 30 s windows.

    Short VAD groups (5-7 s subtitle-granularity presets) leave most of
    each Whisper window empty; the encoder/decoder cost is per WINDOW, so
    packing k groups into one window divides device cost by ~k. Groups are
    separated by ``gap_s`` of silence; decoded segments are routed back to
    their source group by timestamp (see unpack_segments). Windows are
    consumed in order, so packs stay (scene, group)-contiguous.
    """
    gap = int(gap_s * sample_rate)
    cap = int(max_duration_s * sample_rate)
    packed: List[Window] = []
    cur: List[Window] = []
    cur_len = 0

    def flush():
        nonlocal cur, cur_len
        if not cur:
            return
        if len(cur) == 1:
            packed.append(cur[0])
        else:
            parts: List[np.ndarray] = []
            members: List[Tuple[float, Window]] = []
            pos = 0
            for w in cur:
                if parts:
                    parts.append(np.zeros(gap, np.float32))
                    pos += gap
                members.append((pos / sample_rate, w))
                parts.append(w.audio)
                pos += len(w.audio)
            audio = np.concatenate(parts)
            packed.append(Window(
                audio=audio, abs_start=cur[0].abs_start,
                duration=len(audio) / sample_rate,
                scene_idx=cur[0].scene_idx, group_idx=cur[0].group_idx,
                members=members))
        cur, cur_len = [], 0

    for w in windows:
        extra = len(w.audio) + (gap if cur else 0)
        if cur and cur_len + extra > cap:
            flush()
            extra = len(w.audio)
        cur.append(w)
        cur_len += extra
    flush()
    return packed


def unpack_segments(window: Window, segments: list) -> List[Tuple[Window, list]]:
    """Route a packed window's decoded segments back to member windows.

    Each segment is assigned to the member whose span contains its
    midpoint; times are re-based to the member and clamped into it.
    Returns [(member_window, member_segments)] for ALL members (possibly
    empty lists). Non-packed windows pass through unchanged.
    """
    if not window.members:
        return [(window, segments)]
    out = {id(m): (m, []) for _, m in window.members}
    bounds = [(off, off + m.duration, m) for off, m in window.members]
    for seg in segments:
        mid = (seg.start + seg.end) / 2.0
        target = None
        for off, end, m in bounds:
            if off <= mid < end + 1e-6:
                target = (off, m)
                break
        if target is None:  # inside a silence gap: snap to nearest member
            target = min(((off, m) for off, end, m in bounds),
                         key=lambda t: abs((t[0] + t[1].duration / 2) - mid))
        off, m = target
        seg.start = min(max(seg.start - off, 0.0), m.duration)
        seg.end = min(max(seg.end - off, seg.start), m.duration)
        out[id(m)][1].append(seg)
    return [out[id(m)] for _, m in window.members]


@dataclass
class WindowBatch:
    audio: np.ndarray          # (B, N_SAMPLES) float32, zero-padded
    windows: List[Window]      # len ≤ B; row i ↔ windows[i]
    n_valid: int

    @property
    def batch_size(self) -> int:
        return self.audio.shape[0]


def batch_windows(
    windows: Sequence[Window],
    batch_size: int,
    sort_by_duration: bool = True,
) -> Iterator[WindowBatch]:
    """Yield fixed-size padded batches.

    Sorting by duration groups similar-length windows so the while_loop
    decode (which runs until the LAST row finishes) wastes minimal steps on
    short rows batched with long ones. Order is restored by the caller via
    (scene_idx, group_idx).
    """
    order = list(range(len(windows)))
    if sort_by_duration:
        order.sort(key=lambda i: windows[i].duration)
    for i in range(0, len(order), batch_size):
        chunk = [windows[j] for j in order[i:i + batch_size]]
        buf = np.zeros((batch_size, N_SAMPLES), np.float32)
        for r, w in enumerate(chunk):
            buf[r, :len(w.audio)] = w.audio
        yield WindowBatch(buf, chunk, len(chunk))
