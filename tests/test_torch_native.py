"""The port's native host library builds safely from concurrent first
uses: every process builds into a file of its own and takes the output
another process has already moved into place."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import whisperjav_tpu_torch

ROOT = Path(whisperjav_tpu_torch.__file__).parent.parent

_BUILD = """
import sys
from pathlib import Path
from whisperjav_tpu_torch import native
native._cache_dir = lambda: Path(sys.argv[1])
print("AVAILABLE" if native.available() else "FALLBACK")
"""


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_concurrent_first_builds_all_load(tmp_path):
    cache = tmp_path / "native"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(cache)],
                              cwd=str(ROOT), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    assert [o.strip() for o, _ in outs] == ["AVAILABLE"] * 4
    built = sorted(p.name for p in cache.iterdir())
    assert len(built) == 1 and built[0].endswith(".so"), built
