"""Parameter tracing: streaming JSONL event log (``--trace-params``).

The port's copy of ``whisperjav_tpu/utils/tracer.py``: the same records
(``t``, ``ts``, ``event``, ``data``), so a trace either package wrote
reads the same. Events: ``config``, ``file_start``, ``segmentation``,
``file_complete``; :class:`NullTracer` is the no-op with the same
interface.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class ParameterTracer:
    def __init__(self, path: Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._t0 = time.time()

    def event(self, kind: str, data: Optional[Dict[str, Any]] = None) -> None:
        rec = {
            "t": round(time.time() - self._t0, 4),
            "ts": time.time(),
            "event": kind,
            "data": _jsonable(data or {}),
        }
        self._fh.write(json.dumps(rec, ensure_ascii=False) + "\n")
        self._fh.flush()

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NullTracer:
    """No-op tracer; same interface."""

    def event(self, kind: str, data: Optional[Dict[str, Any]] = None) -> None:
        pass

    def close(self) -> None:
        pass


def create_tracer(path: Optional[Path]) -> Any:
    return ParameterTracer(path) if path else NullTracer()


def _jsonable(obj):
    """Numpy-safe JSON conversion (reference keeps the same guard in its
    metadata manager)."""
    import numpy as np
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
