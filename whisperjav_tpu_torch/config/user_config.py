"""User configuration persistence + named preset CRUD.

The port's copy of ``whisperjav_tpu/config/user_config.py``: the same
file (``$XDG_CONFIG_HOME/whisperjav-tpu/config.json``) in the same
format, so a preset saved in either package's GUI is read by the other's.

Role parity with reference ``whisperjav/config/manager.py:24`` (the
``asr_config.json`` v4.3 store: sensitivity profiles, UI prefs,
import/export) and ``whisperjav/settings/presets.py`` (named ensemble
preset CRUD with atomic writes, schema versioning, unicode names —
the P01–P20 scenario matrix in the reference test suite).

Storage is one JSON file; every write goes through an atomic
temp-file + rename, and corrupt files are quarantined (renamed
``*.corrupt``) rather than crashing the app.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from whisperjav_tpu_torch.utils.logger import logger

SCHEMA_VERSION = "1.0"


def default_config_path() -> Path:
    base = os.environ.get("XDG_CONFIG_HOME",
                          str(Path.home() / ".config"))
    return Path(base) / "whisperjav-tpu" / "config.json"


def _default_data() -> Dict[str, Any]:
    return {
        "schema_version": SCHEMA_VERSION,
        "updated": None,
        "preferences": {},          # UI / CLI defaults
        "presets": {},              # name → options dict (ensemble etc.)
    }


class UserConfigManager:
    def __init__(self, path: Optional[Path] = None):
        self.path = Path(path) if path else default_config_path()
        self.data = self._load()

    # ------------------------------------------------------------------
    def _load(self) -> Dict[str, Any]:
        if not self.path.exists():
            return _default_data()
        try:
            data = json.loads(self.path.read_text(encoding="utf-8"))
            if not isinstance(data, dict) or "schema_version" not in data:
                raise ValueError("not a config file")
            base = _default_data()
            base.update(data)
            return base
        except (json.JSONDecodeError, ValueError, OSError) as e:
            quarantine = self.path.with_suffix(".json.corrupt")
            try:
                self.path.rename(quarantine)
                logger.warning("corrupt config quarantined to %s (%s)",
                               quarantine, e)
            except OSError:
                pass
            return _default_data()

    def save(self) -> None:
        """Atomic write: temp file in the same directory + rename."""
        self.data["updated"] = time.strftime("%Y-%m-%dT%H:%M:%S")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                json.dump(self.data, fh, ensure_ascii=False, indent=1)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- preferences ----------------------------------------------------
    def get_pref(self, key: str, default=None):
        return self.data["preferences"].get(key, default)

    def set_pref(self, key: str, value) -> None:
        self.data["preferences"][key] = value
        self.save()

    # -- named presets (CRUD) -------------------------------------------
    def list_presets(self) -> List[str]:
        return sorted(self.data["presets"])

    def get_preset(self, name: str) -> Optional[Dict]:
        return self.data["presets"].get(name)

    def save_preset(self, name: str, options: Dict) -> None:
        if not name or not name.strip():
            raise ValueError("preset name must be non-empty")
        self.data["presets"][name] = dict(options)
        self.save()

    def delete_preset(self, name: str) -> bool:
        if name in self.data["presets"]:
            del self.data["presets"][name]
            self.save()
            return True
        return False

    def rename_preset(self, old: str, new: str) -> None:
        if old not in self.data["presets"]:
            raise KeyError(old)
        if not new or not new.strip():
            raise ValueError("preset name must be non-empty")
        self.data["presets"][new] = self.data["presets"].pop(old)
        self.save()

    # -- import / export ------------------------------------------------
    def export_to(self, path: Path) -> Path:
        Path(path).write_text(
            json.dumps(self.data, ensure_ascii=False, indent=1),
            encoding="utf-8")
        return Path(path)

    def import_from(self, path: Path, merge: bool = True) -> None:
        incoming = json.loads(Path(path).read_text(encoding="utf-8"))
        if merge:
            self.data["preferences"].update(incoming.get("preferences", {}))
            self.data["presets"].update(incoming.get("presets", {}))
        else:
            base = _default_data()
            base.update(incoming)
            self.data = base
        self.save()
