"""Determinism / failure-rate suite on the port.

The reference project ships a failure-rate harness for its
non-deterministic CTranslate2 ensemble (reference:
tools/ensemble_failure_rate_suite.py — N independent runs per config,
"catastrophic" = pass-2 SRT cue count below a threshold, JSONL + summary
output) and applies safety caps (ensemble/orchestrator
apply_ensemble_safety_caps) to contain the intermittent truncation it
probes for. This suite turns the claim that the port's pipeline is
deterministic on one device (fixed shapes, kernels whose reductions run
in a fixed order, seeded sampling) into evidence:

  * repeat: N runs of the same config over the same media must produce
    byte-identical SRT output (zero distinct hashes beyond the first);
  * cue-count floor: the reference's catastrophic-truncation probe,
    applied to every run;
  * ensemble: both passes + merge, repeated, byte-identical merged SRT
    and zero degraded passes.

Usage:
    python -m whisperjav_tpu_torch.tools.determinism_suite --media clip.wav \
        --runs 5 --mode fast --model tiny --output-root /tmp/det
    # ensemble mode (two passes + merge per run):
    ... --ensemble --runs 3

Every run is on ``--device`` (default cuda; a missing card is an error).
Outputs <output-root>/results.jsonl (one line per run) and summary.json
(distinct-hash count per config, failure rate, verdict).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

from whisperjav_tpu_torch.utils.logger import logger


def _sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest() \
        if path.exists() else "missing"


def run_once(media: Path, out_dir: Path, mode: str, model: str,
             batch_size: int, seed: int = 0,
             checkpoint: Optional[str] = None, device="cuda") -> Dict:
    """One full pipeline run on ``device``; returns {srt_sha, cues,
    wall_s, srt_path}. The pipeline is dropped before returning."""
    from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
    from whisperjav_tpu_torch.modules.media_discovery import probe
    from whisperjav_tpu_torch.modules.sanitize import SRTPostProcessor
    from whisperjav_tpu_torch.modules.srt import load_srt
    from whisperjav_tpu_torch.pipelines.engine import release_device_memory
    from whisperjav_tpu_torch.pipelines.factory import build_pipeline

    cfg = resolve_pipeline_config(mode=mode, sensitivity="balanced",
                                  batch_size=batch_size, model=model)
    pipe = build_pipeline(cfg, checkpoint=checkpoint,
                          postprocessor=SRTPostProcessor(), device=device)
    t0 = time.time()
    res = pipe.process(probe(media), out_dir, seed=seed)
    wall = time.time() - t0
    srt = res.srt_path
    del pipe
    release_device_memory(device)
    return {
        "srt_sha": _sha(srt),
        "cues": len(load_srt(srt)) if srt and srt.exists() else 0,
        "wall_s": round(wall, 2),
        "srt_path": str(srt),
    }


def run_ensemble_once(media: Path, out_dir: Path, modes, model: str,
                      batch_size: int, device="cuda") -> Dict:
    """One two-pass ensemble run on ``device``; returns merged hash + pass
    statuses."""
    from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
    from whisperjav_tpu_torch.ensemble.orchestrator import EnsembleOrchestrator
    from whisperjav_tpu_torch.modules.media_discovery import probe
    from whisperjav_tpu_torch.modules.srt import load_srt

    cfgs = [resolve_pipeline_config(mode=m, sensitivity="balanced",
                                    batch_size=batch_size, model=model)
            for m in modes]
    orch = EnsembleOrchestrator(cfgs[0], cfgs[1], device=device)
    report = orch.process_batch([probe(media)], out_dir)
    r = report["results"][0]
    merged = Path(r["output"]) if r["output"] else None
    return {
        "srt_sha": _sha(merged) if merged else "missing",
        "cues": len(load_srt(merged)) if merged and merged.exists() else 0,
        "degraded": r["status"] != "ok",
        "srt_path": str(merged),
    }


def summarize(runs: List[Dict], floor: int) -> Dict:
    hashes = {r["srt_sha"] for r in runs}
    catastrophic = [i for i, r in enumerate(runs) if r["cues"] < floor]
    degraded = [i for i, r in enumerate(runs) if r.get("degraded")]
    return {
        "runs": len(runs),
        "distinct_outputs": len(hashes),
        "deterministic": len(hashes) == 1,
        "catastrophic_runs": catastrophic,
        "catastrophic_rate": len(catastrophic) / max(len(runs), 1),
        "degraded_runs": degraded,
        "verdict": ("PASS" if len(hashes) == 1 and not catastrophic
                    and not degraded else "FAIL"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--media", required=True, type=Path)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--mode", default="fast")
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--ensemble", action="store_true",
                    help="two-pass ensemble (balanced+fast) per run")
    ap.add_argument("--catastrophic-floor", type=int, default=1,
                    help="min cue count for a healthy run (reference "
                         "default scales to ~half the healthy count)")
    ap.add_argument("--output-root", type=Path, default=Path("det_suite"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from whisperjav_tpu_torch.pipelines.engine import resolve_device
    resolve_device(args.device)

    args.output_root.mkdir(parents=True, exist_ok=True)
    results_path = args.output_root / "results.jsonl"
    runs: List[Dict] = []
    with results_path.open("a") as fh:
        for i in range(args.runs):
            out_dir = args.output_root / f"run_{i:03d}"
            if args.ensemble:
                rec = run_ensemble_once(args.media, out_dir,
                                        ("balanced", "fast"),
                                        args.model, args.batch_size,
                                        device=args.device)
            else:
                rec = run_once(args.media, out_dir, args.mode, args.model,
                               args.batch_size, checkpoint=args.checkpoint,
                               device=args.device)
            rec["run"] = i
            runs.append(rec)
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
            logger.info("run %d/%d: sha=%s cues=%d", i + 1, args.runs,
                        rec["srt_sha"][:12], rec["cues"])

    summary = summarize(runs, args.catastrophic_floor)
    (args.output_root / "summary.json").write_text(
        json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    return 0 if summary["verdict"] == "PASS" else 1


if __name__ == "__main__":
    raise SystemExit(main())
