"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file compiles for Hopper (``sm_90a``) in its own
``nvcc`` process, all started together, and the objects link into one
shared library with a plain C interface. The library
lands in ``build/whisperjav_tpu_torch/`` at the root of the checkout,
named by a hash of the sources and flags, so an edited source builds
anew and an unchanged one loads what is there. Nothing is built or
loaded at import time: :func:`load_library` does both at first use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "whisperjav_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA kernels "
                       "need the CUDA toolkit")


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libwjt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, float, str]:
    """Compile the kernels unless this exact build exists.

    Returns (library path, build seconds, nvcc's ptxas report); the
    seconds are 0.0 and the report empty when the library was there.
    """
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    tmp_dir = BUILD_DIR / f"objects.{os.getpid()}"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        jobs = []
        for src in sources():
            obj = tmp_dir / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        report = []
        for cmd, _, proc in jobs:
            _, err = proc.communicate()
            report.append(err)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{err[-4000:]}")
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.unlink(missing_ok=True)
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return out, time.perf_counter() - t0, "".join(report)


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.wjt_encoder_attention.argtypes = [
        _P, _P, _P, _P, _I, _I, _I,
        _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P]
    lib.wjt_encoder_attention.restype = _I
    lib.wjt_decode_cross_attention.argtypes = [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.wjt_decode_cross_attention.restype = _I
    lib.wjt_decode_cross_attention_max_t.argtypes = []
    lib.wjt_decode_cross_attention_max_t.restype = _I
    lib.wjt_fused_workspace_bytes.argtypes = [_I, _I, _I, _I]
    lib.wjt_fused_workspace_bytes.restype = ctypes.c_longlong
    lib.wjt_self_block.argtypes = [_P] * 15 + [_I] * 6 + [_P]
    lib.wjt_self_block.restype = _I
    lib.wjt_cross_block.argtypes = [_P] * 15 + [_I] * 6 + [_P]
    lib.wjt_cross_block.restype = _I
    lib.wjt_mlp_block.argtypes = [_P] * 11 + [_I] * 4 + [_P]
    lib.wjt_mlp_block.restype = _I
    lib.wjt_error_string.argtypes = [_I]
    lib.wjt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err:
        msg: Optional[bytes] = load_library().wjt_error_string(err)
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({(msg or b'?').decode()})")
