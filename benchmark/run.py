"""Run one cell of the benchmark of ``whisperjav_tpu_torch`` once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number the check compared, with its limit (also the
last lines on standard error, after any number read and not judged).
The configuration's driver (``drivers/<driver>.py``) runs the program;
this file and the harness know none of it. Exits non-zero, printing no
result,
without enough CUDA cards, without the port beside the benchmark, or
when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# what the port may not load (whole top-level module names): JAX, Flax,
# the JAX package and the JAX package's own benchmark script
FORBIDDEN = {"jax", "jaxlib", "flax", "whisperjav_tpu", "bench"}


def forbidden_modules() -> set:
    return {name.split(".")[0] for name in sys.modules} & FORBIDDEN


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, device: str = "cuda") -> int:
    """The command; ``device="cpu"`` (tests only) skips the look for
    cards and runs the port's plain paths."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # libraries the port may load must not load JAX themselves
    os.environ.update(USE_FLAX="0", USE_JAX="0", USE_TF="0",
                      HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
    sys.path[:0] = [str(HERE), str(CHECKOUT)]
    from h100bench import spec
    cell = spec.workload(args.workload)
    try:
        import whisperjav_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port is not beside the benchmark: {e}", file=sys.stderr)
        return 2
    import torch
    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell["chips"]):
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); {seen} "
              "visible", file=sys.stderr)
        return 3
    from h100bench.harness import run_cell
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device=device, t_start=T_START,
                   per_layer=spec.metrics() if args.trace else None)
    found = forbidden_modules()
    if found:
        print(f"loaded what the port may not load: {sorted(found)}",
              file=sys.stderr)
        return 4
    checks = out.pop("checks")
    unjudged = out.pop("unjudged")
    out.pop("readings")
    out["device"] = {"platform": "gpu" if cuda else "cpu",
                     "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                     "count": cell["chips"], **out["device"],
                     "power_limit": power_limit() if cuda else "none"}
    out["checks"] = checks
    for name, value in unjudged.items():
        print(f"reading {name}: {value!r} (no limit: not judged)",
              file=sys.stderr)
    for name, c in checks.items():
        value = "not read" if c["value"] is None else repr(c["value"])
        print(f"check {name}: {value} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
