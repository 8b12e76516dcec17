"""Per-file master metadata manager.

The port's copy of ``whisperjav_tpu/utils/metadata.py``: the same schema
in the same ``<basename>.whisperjav.json`` file, so either package's
:class:`MetadataManager` loads what the other wrote.

Role parity with reference ``whisperjav/utils/metadata_manager.py`` —
one JSON per media file recording input info, scenes, stage completions,
and summary/quality metrics, with numpy-safe serialization.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

from whisperjav_tpu_torch.utils.tracer import _jsonable


class MetadataManager:
    SCHEMA_VERSION = "1.0"

    def __init__(self, output_dir: Path, basename: str):
        self.path = Path(output_dir) / f"{basename}.whisperjav.json"
        self.data: Dict[str, Any] = {
            "schema_version": self.SCHEMA_VERSION,
            "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "input": {},
            "stages": {},
            "scenes": [],
            "summary": {},
            "quality_metrics": {},
        }

    def set_input(self, **info) -> None:
        self.data["input"].update(_jsonable(info))

    def start_stage(self, name: str, **params) -> None:
        self.data["stages"][name] = {
            "status": "running", "started": time.time(),
            "params": _jsonable(params),
        }
        self.save()

    def complete_stage(self, name: str, **results) -> None:
        stage = self.data["stages"].setdefault(name, {"started": time.time()})
        stage.update({
            "status": "complete",
            "duration_s": round(time.time() - stage.get("started",
                                                        time.time()), 3),
            "results": _jsonable(results),
        })
        self.save()

    def fail_stage(self, name: str, error: str) -> None:
        stage = self.data["stages"].setdefault(name, {})
        stage.update({"status": "failed", "error": error})
        self.save()

    def add_scene(self, **scene_info) -> None:
        self.data["scenes"].append(_jsonable(scene_info))

    def set_summary(self, **summary) -> None:
        self.data["summary"].update(_jsonable(summary))

    def set_quality_metrics(self, **metrics) -> None:
        self.data["quality_metrics"].update(_jsonable(metrics))

    def save(self) -> Path:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self.data, indent=2,
                                        ensure_ascii=False, default=str),
                             encoding="utf-8")
        return self.path

    @classmethod
    def load(cls, path: Path) -> "MetadataManager":
        mm = cls(Path(path).parent, Path(path).stem.replace(".whisperjav", ""))
        mm.data = json.loads(Path(path).read_text(encoding="utf-8"))
        return mm
