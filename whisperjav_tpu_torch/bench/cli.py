"""``whisperjav-torch-bench``: grade pipeline output against ground-truth SRT.

Role parity with reference ``whisperjav/bench/cli.py:21-60`` — CER/IoU/
drift/order report JSON with provenance.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="whisperjav-torch-bench",
        description="grade subtitle output against ground truth")
    p.add_argument("--ground-truth", "-g", required=True,
                   help="ground-truth SRT file")
    p.add_argument("--test", "-t", required=True, nargs="+",
                   help="one or more test SRT files")
    p.add_argument("--report", "-o", default=None,
                   help="write the report JSON here (default: stdout)")
    p.add_argument("--full", action="store_true",
                   help="deep report: cue matching, hallucination/miss "
                        "buckets, worst decode windows, provenance "
                        "(reads the run's sibling artifact JSONs)")
    p.add_argument("--forensic", default=None, metavar="OUT.csv",
                   help="per-GT-cue loss-stage CSV (matched/coverage_"
                        "loss/model_empty/sanitizer_removed/text_lost) "
                        "for the FIRST --test run, from its sibling "
                        "artifacts (reference: tools/forensic_csv_"
                        "generator.py)")
    args = p.parse_args(argv)

    from whisperjav_tpu_torch.bench.metrics import evaluate
    from whisperjav_tpu_torch.modules.srt import load_srt
    from whisperjav_tpu_torch.version import __version__

    gt = load_srt(args.ground_truth)

    if args.forensic:
        from whisperjav_tpu_torch.bench.forensic import (
            loss_stage_rows, summarize, write_forensic_csv,
        )
        from whisperjav_tpu_torch.bench.loader import load_run
        run = load_run(Path(args.test[0]))
        rows = loss_stage_rows(gt, run)
        write_forensic_csv(Path(args.forensic), rows)
        print(json.dumps(summarize(rows), indent=1))

    if args.full:
        from whisperjav_tpu_torch.bench.loader import load_run
        from whisperjav_tpu_torch.bench.report import (
            analyze, print_summary, write_json_report,
        )
        runs = [load_run(Path(t)) for t in args.test]
        analysis = analyze(gt, runs)
        analysis["provenance"] = {
            "tool": f"whisperjav-tpu-bench {__version__}",
            "ground_truth": str(Path(args.ground_truth).resolve()),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        print_summary(analysis)
        if args.report:
            write_json_report(analysis, Path(args.report))
        return 0
    results = {}
    for test_path in args.test:
        test = load_srt(test_path)
        results[test_path] = evaluate(gt, test).to_dict()

    report = {
        "provenance": {
            "tool": f"whisperjav-tpu-bench {__version__}",
            "ground_truth": str(Path(args.ground_truth).resolve()),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        },
        "results": results,
    }
    out = json.dumps(report, indent=2, ensure_ascii=False)
    if args.report:
        Path(args.report).write_text(out, encoding="utf-8")
    else:
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
