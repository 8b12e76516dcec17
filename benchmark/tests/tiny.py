"""A tiny-width cell for the CPU tests: the turbo packed cell's options
and limits, test widths, f32, 8 windows a file, 6 tokens a window."""

import copy
import json
from pathlib import Path

from h100bench import spec

DATA = Path(__file__).resolve().parent / "data"


def tiny_cell(int8_weights: bool = False) -> dict:
    cfg = json.loads((DATA / "tiny.json").read_text())
    cfg["serve"]["int8_weights"] = int8_weights
    cell = copy.deepcopy(spec.workload("turbo-balanced-packed"))
    cell.update(name="tiny", config=cfg,
                traffic=json.loads((DATA / "tiny-traffic.json").read_text()))
    return cell
