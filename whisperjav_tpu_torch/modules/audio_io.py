"""Native audio I/O: dependency-free RIFF/WAVE read/write + resampling.

Replaces the reference's soundfile/ffmpeg decode path
(reference: whisperjav/modules/audio_extraction.py:33-103) with a host-side
pure-numpy WAV codec. Non-WAV containers (mp4/mkv/…) are handled by
:mod:`whisperjav_tpu_torch.modules.audio_extraction` via ffmpeg when present.

Supports PCM 8/16/24/32-bit and IEEE float32/float64, mono or multichannel
(downmixed to mono on load by default). All audio in the framework is
float32 in [-1, 1] at 16 kHz unless stated otherwise.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

WHISPER_SAMPLE_RATE = 16_000


@dataclass
class WavInfo:
    sample_rate: int
    num_channels: int
    num_frames: int
    bits_per_sample: int
    audio_format: int  # 1=PCM, 3=IEEE float

    @property
    def duration(self) -> float:
        return self.num_frames / float(self.sample_rate)


_WAVE_FORMAT_PCM = 1
_WAVE_FORMAT_IEEE_FLOAT = 3
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _extensible_subformat(fmt_chunk: bytes) -> int:
    """WAVE_FORMAT_EXTENSIBLE: the real format code is the first two bytes
    of the SubFormat GUID (base fmt 16B + cbSize 2B + wValidBits 2B +
    dwChannelMask 4B, GUID at offset 24)."""
    if len(fmt_chunk) >= 26:
        (code,) = struct.unpack_from("<H", fmt_chunk, 24)
        if code in (_WAVE_FORMAT_PCM, _WAVE_FORMAT_IEEE_FLOAT):
            return code
    return _WAVE_FORMAT_PCM


def _parse_chunks(data: bytes):
    """Yield (chunk_id, offset, size) for each top-level RIFF chunk."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    n = len(data)
    while pos + 8 <= n:
        cid = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        yield cid, pos + 8, min(size, n - pos - 8)
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def wav_info(path: Union[str, Path]) -> WavInfo:
    """Read WAV header only (cheap duration probe, no full decode).

    Streams chunk headers with seeks, so multi-GB data chunks cost nothing.
    """
    import os
    file_size = os.path.getsize(path)
    fmt = None
    fmt_chunk = b""
    data_size = None
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        while fmt is None or data_size is None:
            header = f.read(8)
            if len(header) < 8:
                break
            cid = header[:4]
            (size,) = struct.unpack("<I", header[4:])
            body_start = f.tell()
            if cid == b"fmt ":
                fmt_chunk = f.read(min(size, 64))
                fmt = struct.unpack_from("<HHIIHH", fmt_chunk, 0)
            elif cid == b"data":
                # Clamp a lying/streaming header to the actual file extent.
                data_size = min(size, file_size - body_start) if size else (
                    file_size - body_start)
            f.seek(body_start + size + (size & 1))
    if fmt is None or data_size is None:
        raise ValueError(f"malformed WAV (missing fmt/data chunk): {path}")
    audio_format, channels, rate, _brate, block_align, bits = fmt
    if audio_format == _WAVE_FORMAT_EXTENSIBLE:
        audio_format = _extensible_subformat(fmt_chunk)
    frames = data_size // max(block_align, 1)
    return WavInfo(rate, channels, frames, bits, audio_format)


def read_wav(
    path: Union[str, Path],
    mono: bool = True,
    dtype=np.float32,
) -> Tuple[np.ndarray, int]:
    """Decode a WAV file to float array in [-1, 1]. Returns (audio, rate).

    ``audio`` is shape ``(frames,)`` when mono else ``(frames, channels)``.
    """
    data = Path(path).read_bytes()
    fmt = None
    fmt_chunk = b""
    raw = None
    for cid, off, size in _parse_chunks(data):
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", data, off)
            fmt_chunk = data[off:off + size]
        elif cid == b"data":
            raw = data[off:off + size]
    if fmt is None or raw is None:
        raise ValueError(f"malformed WAV (missing fmt/data chunk): {path}")
    audio_format, channels, rate, _brate, _block, bits = fmt
    if audio_format == _WAVE_FORMAT_EXTENSIBLE:
        audio_format = _extensible_subformat(fmt_chunk)

    if audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        if bits not in (32, 64):
            raise ValueError(f"unsupported float WAV bits={bits}")
        x = np.frombuffer(raw, dtype="<f4" if bits == 32 else "<f8")
        x = x.astype(dtype)
    elif bits == 16:
        from whisperjav_tpu_torch import native
        x = native.pcm16_to_f32(np.frombuffer(raw, dtype="<i2")).astype(
            dtype, copy=False)
    elif bits == 32:
        x = np.frombuffer(raw, dtype="<i4").astype(dtype) / 2147483648.0
    elif bits == 8:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(dtype) - 128.0) / 128.0
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8)
        b = b[: (len(b) // 3) * 3].reshape(-1, 3)
        vals = (b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals & 0x800000, vals - 0x1000000, vals)
        x = vals.astype(dtype) / 8388608.0
    else:
        raise ValueError(f"unsupported WAV: format={audio_format} bits={bits}")

    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels)
        if mono:
            x = x.mean(axis=1)
    return np.ascontiguousarray(x, dtype=dtype), rate


def write_wav(
    path: Union[str, Path],
    audio: np.ndarray,
    sample_rate: int,
    subtype: str = "pcm16",
) -> None:
    """Write mono/multichannel float audio as WAV (pcm16 or float32)."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        channels = 1
    else:
        channels = audio.shape[1]
    if subtype == "pcm16":
        fmt_code, bits = _WAVE_FORMAT_PCM, 16
        payload = np.clip(np.round(audio * 32767.0), -32768, 32767).astype("<i2").tobytes()
    elif subtype == "float32":
        fmt_code, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
        payload = audio.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported subtype: {subtype}")

    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    fmt = struct.pack("<HHIIHH", fmt_code, channels, sample_rate, byte_rate,
                      block_align, bits)
    out = bytearray()
    out += b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(payload)) + b"WAVE"
    out += b"fmt " + struct.pack("<I", len(fmt)) + fmt
    out += b"data" + struct.pack("<I", len(payload)) + payload
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(bytes(out))


def resample(audio: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Polyphase resampling (scipy), identity when rates match."""
    if src_rate == dst_rate:
        return audio
    from math import gcd
    from scipy.signal import resample_poly
    g = gcd(src_rate, dst_rate)
    out = resample_poly(audio, dst_rate // g, src_rate // g, axis=0)
    return np.ascontiguousarray(out, dtype=audio.dtype)


def load_audio(
    path: Union[str, Path],
    sample_rate: int = WHISPER_SAMPLE_RATE,
    mono: bool = True,
) -> np.ndarray:
    """Load any supported file as float32 mono at ``sample_rate``.

    WAV files decode natively; other containers fall back to ffmpeg via
    :mod:`whisperjav_tpu_torch.modules.audio_extraction`.
    """
    p = Path(path)
    if p.suffix.lower() in (".wav", ".wave"):
        x, rate = read_wav(p, mono=mono)
        return resample(x, rate, sample_rate)
    from whisperjav_tpu_torch.modules.audio_extraction import extract_audio_ffmpeg
    return extract_audio_ffmpeg(p, sample_rate=sample_rate)


def audio_duration(path: Union[str, Path]) -> Optional[float]:
    """Cheap duration probe: WAV header, else ffprobe when available."""
    p = Path(path)
    if p.suffix.lower() in (".wav", ".wave"):
        try:
            return wav_info(p).duration
        except (ValueError, OSError):
            return None
    from whisperjav_tpu_torch.modules.media_discovery import ffprobe_duration
    return ffprobe_duration(p)
