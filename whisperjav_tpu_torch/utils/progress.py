"""Unified progress reporting (the port's copy of
``whisperjav_tpu/utils/progress.py``).

Role parity with the reference's three-system progress stack unified
behind adapters (reference: whisperjav/utils/unified_progress.py:1-5,
progress_display*.py — spam reduction, external-library suppression,
async bridging) collapsed into ONE manager: hierarchical task progress
with throttled console rendering, quiet/plain modes for logs and CI, and
a context manager that silences third-party tqdm output.
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional


@dataclass
class _Task:
    name: str
    total: int
    done: int = 0
    started: float = field(default_factory=time.time)


class ProgressManager:
    """Throttled hierarchical progress: file → stage → items."""

    def __init__(self, enabled: Optional[bool] = None,
                 min_interval_s: float = 0.25, stream=None):
        self.stream = stream or sys.stderr
        self.enabled = (self.stream.isatty()
                        if enabled is None else enabled)
        self.min_interval_s = min_interval_s
        self._tasks: Dict[str, _Task] = {}
        self._last_render = 0.0
        self._messages = 0

    # ------------------------------------------------------------------
    def task(self, name: str, total: int) -> None:
        self._tasks[name] = _Task(name, max(total, 1))
        self._render(force=True)

    def advance(self, name: str, n: int = 1) -> None:
        t = self._tasks.get(name)
        if t is None:
            return
        t.done = min(t.done + n, t.total)
        self._render()

    def finish(self, name: str) -> None:
        t = self._tasks.pop(name, None)
        if t is not None and self.enabled:
            elapsed = time.time() - t.started
            self._line(f"{t.name}: done ({t.done}/{t.total}, "
                       f"{elapsed:.1f}s)", final=True)

    # ------------------------------------------------------------------
    def _render(self, force: bool = False) -> None:
        if not self.enabled:
            return
        now = time.time()
        if not force and now - self._last_render < self.min_interval_s:
            return    # spam reduction: cap render rate
        self._last_render = now
        parts = []
        for t in self._tasks.values():
            pct = 100.0 * t.done / t.total
            parts.append(f"{t.name} {t.done}/{t.total} ({pct:.0f}%)")
        if parts:
            self._line(" | ".join(parts))

    def _line(self, text: str, final: bool = False) -> None:
        self._messages += 1
        end = "\n" if final else "\r"
        self.stream.write("\x1b[2K" + text + end)
        self.stream.flush()

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def suppress_external(self) -> Iterator[None]:
        """Silence third-party tqdm bars inside the block (reference:
        external-library suppression context). Only the tqdm import is
        guarded — an ImportError raised by USER code inside the block must
        propagate, not trip a second yield."""
        try:
            import tqdm
        except ImportError:
            yield
            return
        orig = tqdm.tqdm.__init__

        def muted(self_, *a, **k):
            k["disable"] = True
            orig(self_, *a, **k)

        tqdm.tqdm.__init__ = muted
        try:
            yield
        finally:
            tqdm.tqdm.__init__ = orig


class NullProgress:
    def task(self, *a, **k): pass
    def advance(self, *a, **k): pass
    def finish(self, *a, **k): pass

    @contextlib.contextmanager
    def suppress_external(self):
        yield
