"""Put one cell's device idle time down to the port's host spans.

    python3 benchmark/idle_by_span.py --workload <cell> --seed <n>

From the root of a checkout, on a machine with a CUDA card. Runs the
cell's profiled file as ``run.py --trace 1`` does and prints one JSON
line: the per-layer metrics, ``idle_by_span`` (the device's idle seconds
by the innermost program span open over them, ``outside spans`` for the
rest), ``span_self_s`` (each span name's seconds less its children's),
``decode_row_steps`` (the decode loops' rows times steps, their
counters), ``wall_s`` and ``busy_s``. Without the port's spans the span
readings are empty.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


class _Keep:
    """A reader that keeps the stretch and reports nothing."""
    UNIT = ""
    stretch = None

    @classmethod
    def read(cls, stretch):
        cls.stretch = stretch
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    from h100bench import spec, spans
    from h100bench.harness import run_cell
    out = run_cell(spec.workload(args.workload), args.seed, 0.0, True,
                   device=args.device,
                   per_layer={**spec.metrics(), "_keep": _Keep})
    stretch = _Keep.stretch
    from whisperjav_tpu_torch.utils import tracer
    rec = tracer.latest()
    print(json.dumps({
        "workload": args.workload, "correct": out["correct"],
        "metrics": out["metrics"],
        "idle_by_span": spans.idle_by_span(stretch, n=20),
        "span_self_s": rec.self_seconds() if rec is not None else {},
        "decode_row_steps": sum(
            s.counters.get("steps", 0) * s.counters.get("rows", 0)
            for s in spans.program_spans(stretch) if s.name == "decode.loop"),
        "wall_s": stretch.wall_s, "busy_s": stretch.busy_s()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
