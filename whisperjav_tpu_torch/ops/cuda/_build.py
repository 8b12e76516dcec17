"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file compiles for Hopper (``sm_90a``) in its own
``nvcc`` process, all started together, and the objects link into one
shared library with a plain C interface. The library
lands in ``build/whisperjav_tpu_torch/`` at the root of the checkout,
named by a hash of the sources, their ``*.cuh`` headers and the flags,
so an edited source builds anew and an unchanged one loads what is
there. Nothing is built or
loaded at import time: :func:`load_library` does both at first use,
once per process however many threads make that first call together
(``--async-processing`` runs the VAD networks in a producer thread while
the engine decodes in the caller's). A build's temporary files carry the
process and thread ids, so concurrent builds never share one.

This module knows no kernel. Each wrapper module declares the C entries
it calls (:class:`entry`), takes the plain version on CPU tensors
(:func:`on_cpu`) and launches through :func:`launch`, which counts each
launch in the wrapper's ``launches``. A new kernel is a ``.cu`` file and
its wrapper.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

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


def sources(csrc_dir: Path = CSRC_DIR) -> List[Path]:
    return sorted(Path(csrc_dir).glob("*.cu"))


def library_path(csrc_dir: Path = CSRC_DIR,
                 build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(csrc_dir) + sorted(Path(csrc_dir).glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return Path(build_dir) / f"libwjt_kernels_{h.hexdigest()[:16]}.so"


def build(csrc_dir: Path = CSRC_DIR,
          build_dir: Path = BUILD_DIR) -> Tuple[Path, float, str]:
    """Compile the kernels of ``csrc_dir`` (the package's own by
    default) unless this exact build exists.

    Returns (library path, build seconds, nvcc's ptxas report); the
    seconds are 0.0 and the report empty when the library was there.
    """
    out = library_path(csrc_dir, build_dir)
    if out.exists():
        return out, 0.0, ""
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp_dir = Path(build_dir) / f"objects.{tag}"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{tag}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        jobs = []
        for src in sources(csrc_dir):
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


# the C types of the entries' arguments: a pointer (a tensor's data or
# a stream), an int, an int64
P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def open_library(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its one library-wide entry,
    ``wjt_error_string`` (the kernels' entries: :class:`entry`)."""
    lib = ctypes.CDLL(str(path))
    lib.wjt_error_string.argtypes = [I]
    lib.wjt_error_string.restype = ctypes.c_char_p
    return lib


_LIBRARY: Optional[ctypes.CDLL] = None
_LIBRARY_LOCK = threading.Lock()


def load_library() -> ctypes.CDLL:
    """Build if needed and load once per process; threads that make the
    first call together wait for one build."""
    global _LIBRARY
    if _LIBRARY is None:
        with _LIBRARY_LOCK:
            if _LIBRARY is None:
                _LIBRARY = open_library(build()[0])
    return _LIBRARY


_COUNT_LOCK = threading.Lock()
# the launches a CUDA graph capture in this thread holds (None: no capture)
_CAPTURING = threading.local()


def count(counter, n: int = 1) -> None:
    """Add ``n`` to ``counter.launches`` (a kernel wrapper's count of
    its launches) under one lock, so the counts stay exact when the
    devices of a mesh launch from threads of their own. While this
    thread captures a CUDA graph (:func:`capturing`) nothing runs: the
    launch is noted for the graph's replays instead."""
    held = getattr(_CAPTURING, "launches", None)
    if held is not None:
        held[id(counter)] = (counter, held.get(id(counter), (None, 0))[1] + n)
        return
    with _COUNT_LOCK:
        counter.launches += n


@contextlib.contextmanager
def capturing():
    """Collect this thread's launch counts inside the block, as
    ``{id(counter): (counter, launches)}``, without adding them: the
    block captures a CUDA graph, and :func:`count_replay` adds them at
    each replay."""
    _CAPTURING.launches = held = {}
    try:
        yield held
    finally:
        _CAPTURING.launches = None


def count_replay(held: dict) -> None:
    """Count one replay of a graph as the launches it holds."""
    with _COUNT_LOCK:
        for counter, n in held.values():
            counter.launches += n


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err:
        msg: Optional[bytes] = load_library().wjt_error_string(err)
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({(msg or b'?').decode()})")


class entry:
    """One C entry of the library with its signature, declared by the
    wrapper module that calls it; looked up in the library (built and
    loaded if need be) at its first call, then held."""

    def __init__(self, name: str, argtypes: Sequence, restype=I):
        self.name = name
        self.argtypes = list(argtypes)
        self.restype = restype
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            fn = getattr(load_library(), self.name)
            fn.argtypes, fn.restype = self.argtypes, self.restype
            self._fn = fn
        return self._fn(*args)


def on_cpu(what: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper runs its plain
    version); False when all lie on one CUDA device (it launches its
    kernel); raises otherwise: a kernel's operands never fall back."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{what}: tensors must share one CUDA device or all "
                         f"lie on the CPU, got {devices}")
    return False


def launch(counter, what: str, device: torch.device, fn: entry,
           *args) -> None:
    """Call ``fn`` with ``args`` and the handle of ``device``'s current
    stream, inside ``device``; raise on the error it returns (``what``
    names the kernel), then count one launch in ``counter.launches``
    (:func:`count`)."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, what)
    count(counter)
