"""Cells, configurations, traffic mixes and per-layer metrics, found by
the names ``BENCHMARK.json`` gives them.

- ``benchmark/workloads/<cell>.json``: the configuration and traffic a
  cell runs, its chips, why it exists and the limits of its check;
- ``benchmark/configs/<config>.json``: the model's sizes, as published,
  how the port serves it, and the ``driver`` that serves it;
- ``benchmark/drivers/<driver>.py``: what builds, warms up, serves and
  judges the program a configuration names (the harness's loop calls
  it);
- ``benchmark/traffic/<traffic>.json``: the parameters the one traffic
  generator (``h100bench/traffic.py``) reads;
- ``benchmark/metrics/<metric>.py``: one per-layer metric, its
  declarations and its reader.

Adding any of them is adding a file; nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]


def _json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                       f"named {name!r} ({path} is missing)")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def workload(name: str) -> dict:
    """A cell, with its configuration and traffic read in."""
    cell = _json("workloads", name)
    return {**cell, "config": config(cell["config"]),
            "traffic": traffic(cell["traffic"])}


def names(kind: str) -> List[str]:
    """The names of every file of ``kind`` (workloads, configs, traffic,
    metrics, drivers)."""
    suffix = ".py" if kind in ("metrics", "drivers") else ".json"
    return sorted(p.name[:-len(suffix)] for p in (ROOT / kind).glob(
        f"*{suffix}") if not p.name.startswith("_"))


def metric(name: str) -> ModuleType:
    """The reader of per-layer metric ``name``."""
    path = ROOT / "metrics" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no metric named {name!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(
        f"h100bench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics() -> Dict[str, ModuleType]:
    return {name: metric(name) for name in names("metrics")}


def driver(name: str) -> ModuleType:
    """The driver ``drivers/<name>.py``, imported as ``drivers.<name>``
    (one module however often it is asked for; the benchmark's root on
    ``sys.path``)."""
    path = ROOT / "drivers" / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise KeyError(f"no driver named {name!r} ({path} is missing)")
    return importlib.import_module(f"drivers.{name}")
