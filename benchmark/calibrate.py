"""Readings that the check's limits are set from, in one process.

    python benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--reference-control <control>] \
        [--program-controls <path> ... --control-seeds 7 8]

For each ``--seeds`` seed, one file of the cell's traffic as the window
runs it, judged as a run judges it: the lower readings. With
``--reference-control``, each such seed's rows are also read by the
reference one precision below, in the program's place, and judged by
the cell's limits. For each ``--program-controls`` path and each
``--control-seeds`` seed, one file of the program with its own
lower-precision path switched on, judged as a run judges it against the
configuration as stated. The controls are the cell's driver's
(``drivers/<driver>.py``: ``CONTROLS``, ``PROGRAM_CONTROLS``; Whisper's
``fp8`` and ``int4_weights``, and ``int8_weights`` and
``int4_cross_kv``). Prints a JSON line a run and one summary line last:
each number's largest sound reading, each control's smallest. Runs on
the card; the benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def widest(into: dict, readings: dict, numbers) -> None:
    """Append a run's widest reading of each number ``numbers`` names."""
    for name in numbers:
        if readings.get(name):
            into.setdefault(name, []).append(max(readings[name]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--reference-control", default=None)
    ap.add_argument("--program-controls", nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    from h100bench import harness, spec
    cell = spec.workload(args.workload)
    numbers = spec.driver(cell["config"]["driver"]).NUMBERS
    lower, upper = {}, {}

    def report(seed, path, out, t0):
        print(json.dumps({"seed": seed, "path": path,
                          "correct": out["correct"], "checks": out["checks"],
                          "readings": out["readings"],
                          "control": out.get("control"),
                          "metrics": out["metrics"],
                          "seconds": time.perf_counter() - t0}), flush=True)

    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, 0.0, False, device=args.device,
                               reference_control=args.reference_control)
        widest(lower, out["readings"], numbers)
        if "control" in out:
            widest(upper.setdefault(args.reference_control, {}),
                   out["control"]["readings"], numbers)
        report(seed, None, out, t0)
    for path in args.program_controls:
        for seed in args.control_seeds:
            t0 = time.perf_counter()
            out = harness.run_cell(cell, seed, 0.0, False,
                                   device=args.device, program_control=path)
            widest(upper.setdefault(path, {}), out["readings"], numbers)
            report(seed, path, out, t0)
    print(json.dumps({
        "workload": args.workload,
        "lower": {k: max(v) for k, v in lower.items()},
        "upper": {c: {k: min(v) for k, v in r.items()}
                  for c, r in upper.items()},
        "sound": lower, "controls": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
