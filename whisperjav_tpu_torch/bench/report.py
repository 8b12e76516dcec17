"""Full benchmark report: metrics + matching + provenance across runs.

Role parity with reference ``whisperjav/bench/report.py`` (analyze /
print_summary / worst-scenes / write_json_report): grades one or more
pipeline runs against a ground-truth SRT, combining

- the metric family (CER, timing IoU, boundary drift, signed offsets,
  temporal order — bench/metrics.py),
- cue matching (matched/missed/hallucinated — bench/matcher.py),
- provenance analytics (worst decode windows — bench/provenance.py),
- run stats from the pipeline's own artifact JSONs (bench/loader.py).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from whisperjav_tpu_torch.bench.loader import RunArtifacts
from whisperjav_tpu_torch.bench.matcher import match_subtitles
from whisperjav_tpu_torch.bench.metrics import evaluate
from whisperjav_tpu_torch.bench.provenance import build_provenance, window_analytics
from whisperjav_tpu_torch.modules.srt import Subtitle


def analyze(gt_subs: Sequence[Subtitle],
            runs: Sequence[RunArtifacts]) -> Dict:
    """All metrics for every run, plus per-run drill-down structures."""
    gt_dur = max((s.end for s in gt_subs), default=0.0)
    out: Dict = {
        "ground_truth": {"cues": len(gt_subs),
                         "duration_s": round(gt_dur, 3)},
        "runs": {},
    }
    for run in runs:
        match = match_subtitles(gt_subs, run.subtitles)
        report = evaluate(gt_subs, run.subtitles)
        worst = window_analytics(match, run.windows, run.subtitles)
        out["runs"][run.name] = {
            "metrics": report.to_dict(),
            "matching": match.to_dict(),
            "worst_windows": worst[:10],
            "provenance": build_provenance(run.subtitles, run.windows),
            "removed_by_sanitizer": len(run.removed),
            "stats": {k: run.stats[k] for k in
                      ("scenes", "groups", "windows", "rtf_x",
                       "sanitization") if k in run.stats},
        }
    return out


def print_summary(analysis: Dict, file=None) -> None:
    """Console comparison table (reference report.py:260 print_summary)."""
    import sys
    file = file or sys.stdout
    gt = analysis["ground_truth"]
    print(f"ground truth: {gt['cues']} cues / {gt['duration_s']}s",
          file=file)
    hdr = (f"{'run':<24} {'CER':>6} {'IoU':>6} {'match':>6} "
           f"{'miss':>5} {'halluc':>6} {'order':>6}")
    print(hdr, file=file)
    print("-" * len(hdr), file=file)
    for name, r in analysis["runs"].items():
        m, mt = r["metrics"], r["matching"]
        print(f"{name[:24]:<24} {m['cer']:>6.3f} {m['timing_iou']:>6.3f} "
              f"{mt['matched']:>6} {mt['missed']:>5} "
              f"{mt['hallucinated']:>6} {m['temporal_order']:>6.3f}",
              file=file)
    for name, r in analysis["runs"].items():
        worst = [w for w in r["worst_windows"] if w["hallucinated"]]
        if worst:
            w = worst[0]
            print(f"{name}: worst window scene={w['scene']} "
                  f"group={w['group']} hallucinated={w['hallucinated']} "
                  f"logprob={w['avg_logprob']}", file=file)


def write_json_report(analysis: Dict, path: Path) -> Path:
    path = Path(path)
    path.write_text(json.dumps(analysis, indent=2, ensure_ascii=False),
                    encoding="utf-8")
    return path
