"""Environment preflight checks (``whisperjav-torch --check``).

The port's counterpart of ``whisperjav_tpu/utils/preflight.py``: the same
rows and verdicts with ``torch`` in place of ``jax``. The ``accelerator``
row reads the card through ``torch.cuda`` (count, name, compute
capability), and one ``nvcc`` row is a hard requirement, because the
port's kernels are built from ``csrc/`` at first use
(``ops/cuda/_build.py``): it takes the place of the JAX backend-health
row.
"""

from __future__ import annotations

import shutil
import sys
from typing import List, Tuple


def gather_checks() -> List[Tuple[str, bool, str]]:
    checks: List[Tuple[str, bool, str]] = []

    checks.append(("python", sys.version_info >= (3, 10),
                   f"{sys.version_info.major}.{sys.version_info.minor}"))

    for mod in ("numpy", "scipy", "torch"):
        try:
            m = __import__(mod)
            checks.append((mod, True, getattr(m, "__version__", "?")))
        except ImportError as e:
            checks.append((mod, False, str(e)))

    try:
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n:
            major, minor = torch.cuda.get_device_capability(0)
            detail = (f"{n}x cuda ({torch.cuda.get_device_name(0)}, "
                      f"sm_{major}{minor})")
        else:
            detail = "0x cuda (-)"
        checks.append(("accelerator", n > 0, detail))
    except Exception as e:  # noqa: BLE001 — report, don't crash preflight
        checks.append(("accelerator", False, str(e)))

    try:
        from whisperjav_tpu_torch.ops.cuda._build import _nvcc
        checks.append(("nvcc", True, _nvcc()))
    except RuntimeError as e:
        checks.append(("nvcc", False, str(e)))

    checks.append(("ffmpeg", shutil.which("ffmpeg") is not None,
                   shutil.which("ffmpeg") or "not found (WAV-only mode)"))
    checks.append(("ffprobe", shutil.which("ffprobe") is not None,
                   shutil.which("ffprobe") or "not found (native WAV probe)"))

    try:
        import transformers
        checks.append(("transformers", True, transformers.__version__))
    except ImportError:
        checks.append(("transformers", False,
                       "optional: needed for checkpoint conversion"))
    return checks


def run_preflight_checks(verbose: bool = True) -> bool:
    """True when all hard requirements pass (ffmpeg/transformers are soft)."""
    soft = {"ffmpeg", "ffprobe", "transformers"}
    ok = True
    for name, passed, detail in gather_checks():
        status = "OK " if passed else ("--- " if name in soft else "FAIL")
        if verbose:
            print(f"[{status}] {name:14s} {detail}")
        if not passed and name not in soft:
            ok = False
    return ok
