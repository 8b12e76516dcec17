"""Parity check: run the port's pipeline on fixture media and grade
against GT.

Point it at a local checkpoint, media files, and their ground-truth
SRTs; it transcribes on ``--device`` (default cuda), grades (CER /
timing IoU / drift / order), times the run, and writes a combined
report.

    python -m whisperjav_tpu_torch.tools.parity_check \
        --checkpoint /models/whisper-large-v2 \
        --pairs clip1.wav:clip1.gt.srt clip2.wav:clip2.gt.srt \
        --mode balanced --report parity.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="whisperjav-torch-parity-check")
    p.add_argument("--pairs", nargs="+", required=True,
                   help="media:gt_srt pairs")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--mode", default="balanced")
    p.add_argument("--sensitivity", default="balanced")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--report", default="parity_report.json")
    p.add_argument("--output-dir", default="./parity_out")
    p.add_argument("--device", default="cuda",
                   help="device to transcribe on (default cuda; a "
                        "missing card is an error)")
    args = p.parse_args(argv)

    from whisperjav_tpu_torch.bench.metrics import evaluate
    from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
    from whisperjav_tpu_torch.modules.media_discovery import probe
    from whisperjav_tpu_torch.modules.sanitize import SRTPostProcessor
    from whisperjav_tpu_torch.modules.srt import load_srt
    from whisperjav_tpu_torch.pipelines.factory import build_pipeline

    cfg = resolve_pipeline_config(mode=args.mode,
                                  sensitivity=args.sensitivity,
                                  batch_size=args.batch_size)
    pipeline = build_pipeline(cfg, checkpoint=args.checkpoint,
                              postprocessor=SRTPostProcessor(),
                              device=args.device)
    results = {}
    total_audio = 0.0
    total_wall = 0.0
    for pair in args.pairs:
        media_path, gt_path = pair.rsplit(":", 1)
        info = probe(media_path)
        t0 = time.time()
        out = pipeline.process(info, Path(args.output_dir))
        wall = time.time() - t0
        gt = load_srt(gt_path)
        report = evaluate(gt, out.subtitles).to_dict()
        report["wall_s"] = round(wall, 2)
        report["audio_s"] = round(info.duration or 0.0, 2)
        report["rtf_x"] = round((info.duration or 0.0) / max(wall, 1e-9), 1)
        results[media_path] = report
        total_audio += info.duration or 0.0
        total_wall += wall

    summary = {
        "checkpoint": args.checkpoint,
        "mode": args.mode,
        "sensitivity": args.sensitivity,
        "aggregate_rtf_x": round(total_audio / max(total_wall, 1e-9), 1),
        "mean_cer": round(sum(r["cer"] for r in results.values())
                          / max(len(results), 1), 4),
        "results": results,
    }
    Path(args.report).write_text(json.dumps(summary, indent=2,
                                            ensure_ascii=False),
                                 encoding="utf-8")
    print(json.dumps(summary, indent=2, ensure_ascii=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
