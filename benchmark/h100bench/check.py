"""The verdict that decides ``correct``: a driver's readings against the
cell's limits.

A driver's ``judge`` reads the numbers its check compares, each a list
of readings (a sampled row's each, or the run's one), from the plain
reference under ``reference/``; ``workloads/<cell>.json`` gives each
number the cell compares its limit (``limits``). A number is judged by
its widest reading. A number that ``limits`` names and the driver did
not read makes the run not correct; a number the driver reads that
``limits`` does not name is printed and not judged.
"""

from __future__ import annotations

import numpy as np

# a reading the JSON line can hold where a served token was forbidden
NOT_A_NUMBER = 1e30


def widest(values) -> float:
    worst = float(np.max(values))
    return worst if np.isfinite(worst) else NOT_A_NUMBER


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, checks): each number ``limits`` names with its widest
    reading (None where none was read) and its limit."""
    checks, correct = {}, True
    for name, limit in limits.items():
        if len(readings.get(name, ())) == 0:
            checks[name] = {"value": None, "limit": limit}
            correct = False
            continue
        worst = widest(readings[name])
        checks[name] = {"value": worst, "limit": limit}
        correct &= limit is not None and worst <= limit
    return bool(correct), checks


def unjudged(readings: dict, limits: dict, numbers) -> dict:
    """The widest reading of each of the driver's ``numbers`` that
    ``limits`` does not name."""
    return {name: widest(readings[name]) for name in numbers
            if name not in limits and len(readings.get(name, ()))}


def finite(readings: dict) -> dict:
    return {k: [float(x) if np.isfinite(x) else NOT_A_NUMBER for x in v]
            for k, v in readings.items()}
