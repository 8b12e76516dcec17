"""Native host kernels: build-on-first-use g++ shared library + ctypes.

The library is optional: :data:`available` is False (and every wrapper
falls back to its numpy twin) when no compiler is present or the build
fails. Build artifacts cache under ``build/whisperjav_tpu_torch/native/``
at the root of the checkout (the port's own key: the JAX package's build
is never loaded), named by a source hash so edits rebuild automatically.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from whisperjav_tpu_torch.utils.logger import logger

_SRC = Path(__file__).parent / "wjav_native.cpp"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _cache_dir() -> Path:
    return (Path(__file__).resolve().parents[2] / "build"
            / "whisperjav_tpu_torch" / "native")


def _build() -> Optional[Path]:
    if shutil.which("g++") is None:
        return None
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = _cache_dir() / f"wjav_native_{tag}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # each process builds into its own file and moves it into place; a
    # process that loses a race (or fails) takes the output another one
    # has already put there
    fd, tmp_name = tempfile.mkstemp(suffix=".so.tmp", dir=out.parent)
    os.close(fd)
    tmp = Path(tmp_name)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=120)
        if proc.returncode != 0:
            logger.debug("native build failed: %s",
                         proc.stderr.decode(errors="replace")[-500:])
        else:
            os.replace(tmp, out)
    except (subprocess.SubprocessError, OSError) as e:
        logger.debug("native build error: %s", e)
    finally:
        tmp.unlink(missing_ok=True)
    return out if out.exists() else None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        logger.debug("native kernels unavailable; using numpy fallbacks")
        return None
    lib = ctypes.CDLL(str(path))
    i64, f32p, i16p, u8p, i64p = (ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_float),
                                  ctypes.POINTER(ctypes.c_int16),
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.POINTER(ctypes.c_int64))
    lib.wj_pcm16_to_f32.argtypes = [i16p, f32p, i64]
    lib.wj_pcm24_to_f32.argtypes = [u8p, f32p, i64]
    lib.wj_downmix_mean.argtypes = [f32p, f32p, i64, ctypes.c_int]
    lib.wj_frame_energy_db.argtypes = [f32p, i64, i64, f32p, i64]
    lib.wj_hysteresis.argtypes = [f32p, i64, ctypes.c_float,
                                  ctypes.c_float, i64p, i64p, i64]
    lib.wj_hysteresis.restype = i64
    _LIB = lib
    logger.debug("native kernels loaded: %s", path.name)
    return _LIB


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pcm16_to_f32(raw: np.ndarray) -> np.ndarray:
    lib = _load()
    raw = np.ascontiguousarray(raw, dtype="<i2")
    if lib is None:
        return raw.astype(np.float32) / 32768.0
    out = np.empty(raw.shape, np.float32)
    lib.wj_pcm16_to_f32(_ptr(raw, ctypes.c_int16),
                        _ptr(out, ctypes.c_float), raw.size)
    return out


def frame_energy_db(audio: np.ndarray, hop: int) -> np.ndarray:
    lib = _load()
    audio = np.ascontiguousarray(audio, np.float32)
    n_frames = len(audio) // hop
    if lib is None or n_frames == 0:
        if n_frames == 0:
            return np.zeros((0,), np.float32)
        x = (audio[: n_frames * hop].astype(np.float64) * 32768.0) ** 2
        return (10.0 * np.log10(x.reshape(-1, hop).mean(axis=1) + 1e-12)
                ).astype(np.float32)
    out = np.empty(n_frames, np.float32)
    lib.wj_frame_energy_db(_ptr(audio, ctypes.c_float), len(audio), hop,
                           _ptr(out, ctypes.c_float), n_frames)
    return out


def hysteresis(probs: np.ndarray, onset: float,
               release: float) -> List[Tuple[int, int]]:
    lib = _load()
    probs = np.ascontiguousarray(probs, np.float32)
    n = len(probs)
    if lib is None:
        out = []
        in_speech = False
        start = 0
        for i, p in enumerate(probs):
            if not in_speech and p >= onset:
                in_speech, start = True, i
            elif in_speech and p < release:
                in_speech = False
                out.append((start, i))
        if in_speech:
            out.append((start, n))
        return out
    cap = n // 1 + 1
    starts = np.empty(cap, np.int64)
    ends = np.empty(cap, np.int64)
    count = lib.wj_hysteresis(_ptr(probs, ctypes.c_float), n,
                              onset, release,
                              _ptr(starts, ctypes.c_int64),
                              _ptr(ends, ctypes.c_int64), cap)
    return [(int(starts[i]), int(ends[i])) for i in range(count)]
