"""The PyTorch port imports no jax, directly or through the JAX package."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import whisperjav_tpu_torch

PKG_DIR = Path(whisperjav_tpu_torch.__file__).parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG_DIR)], prefix="whisperjav_tpu_torch."))


def test_every_module_is_listed():
    mods = _modules()
    for name in ("whisperjav_tpu_torch.cli",
                 "whisperjav_tpu_torch.ops.cuda.encoder_attention",
                 "whisperjav_tpu_torch.ops.cuda.decode_attention",
                 "whisperjav_tpu_torch.pipelines.factory"):
        assert name in mods


def test_importing_the_port_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
            "print(','.join(bad))\n")
    root = str(PKG_DIR.parent)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"jax loaded: {proc.stdout}"


def test_no_port_source_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    offenders = [str(p) for p in PKG_DIR.rglob("*.py")
                 if pat.search(p.read_text(encoding="utf-8"))]
    assert offenders == []
