"""VAD ground-truth analyser: grade and compare segmentation backends.

Role parity with reference ``tools/vad_groundtruth_analyser/`` (frame
F1/precision/recall, segment IoU, boundary drift, miss/false-alarm
rates vs a ground-truth SRT; inter-backend agreement matrix when no GT
exists; report output). Plotly HTML is replaced by a self-contained JSON
+ markdown report. The network backends (a ``weights`` path for silero,
ten and whisperseg; whisper-vad always) run on ``device`` (default
cuda, as the port's segmenter factory); the energy backends touch no
device.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from whisperjav_tpu_torch.bench.metrics import frame_f1
from whisperjav_tpu_torch.modules.segmentation import create_segmenter
from whisperjav_tpu_torch.modules.srt import load_srt


def regions_from_srt(srt_path: Path) -> List[Tuple[float, float]]:
    return [(s.start, s.end) for s in load_srt(srt_path)]


def segment_iou(gt: Sequence[Tuple[float, float]],
                test: Sequence[Tuple[float, float]]) -> float:
    """Mean best-match IoU of GT segments against test segments."""
    if not gt:
        return 1.0 if not test else 0.0
    scores = []
    for a, b in gt:
        best = 0.0
        for c, d in test:
            inter = max(0.0, min(b, d) - max(a, c))
            union = (b - a) + (d - c) - inter
            if union > 0:
                best = max(best, inter / union)
        scores.append(best)
    return float(np.mean(scores))


def miss_fa_rates(gt: Sequence[Tuple[float, float]],
                  test: Sequence[Tuple[float, float]],
                  min_overlap: float = 0.3) -> Dict[str, float]:
    """Segment-level miss rate (GT without a matching detection) and
    false-alarm rate (detections matching no GT)."""
    def matched(seg, others):
        a, b = seg
        for c, d in others:
            inter = max(0.0, min(b, d) - max(a, c))
            if inter >= min_overlap * min(b - a, d - c):
                return True
        return False

    misses = sum(1 for g in gt if not matched(g, test))
    fas = sum(1 for t in test if not matched(t, gt))
    return {
        "miss_rate": misses / len(gt) if gt else 0.0,
        "false_alarm_rate": fas / len(test) if test else 0.0,
        "gt_segments": len(gt),
        "detected_segments": len(test),
    }


def boundary_drift_regions(gt: Sequence[Tuple[float, float]],
                           test: Sequence[Tuple[float, float]]) -> Dict:
    starts, ends = [], []
    for a, b in gt:
        best, best_iou = None, 0.0
        for c, d in test:
            inter = max(0.0, min(b, d) - max(a, c))
            union = (b - a) + (d - c) - inter
            iou = inter / union if union > 0 else 0.0
            if iou > best_iou:
                best, best_iou = (c, d), iou
        if best and best_iou > 0.1:
            starts.append(abs(a - best[0]))
            ends.append(abs(b - best[1]))
    return {
        "mean_start_drift_s": float(np.mean(starts)) if starts else None,
        "mean_end_drift_s": float(np.mean(ends)) if ends else None,
        "matched": len(starts),
    }


def analyse_backend(audio: np.ndarray, sample_rate: int, backend: str,
                    gt: Optional[Sequence[Tuple[float, float]]] = None,
                    device="cuda", **kwargs) -> Dict:
    seg = create_segmenter(backend, device=device, **kwargs).segment(
        audio, sample_rate)
    regions = [(s.start, s.end) for s in seg.segments]
    report: Dict = {
        "backend": seg.backend,
        "segments": len(regions),
        "coverage": round(seg.speech_coverage, 4),
        "stats": seg.stats,
        "_regions": regions,
    }
    if gt is not None:
        total = len(audio) / sample_rate
        report["frame"] = {k: round(v, 4) for k, v in
                           frame_f1(gt, regions, total).items()}
        report["segment_iou"] = round(segment_iou(gt, regions), 4)
        report["detection"] = miss_fa_rates(gt, regions)
        report["drift"] = boundary_drift_regions(gt, regions)
    return report


def agreement_matrix(reports: Sequence[Dict],
                     total: float) -> Dict[str, Dict[str, float]]:
    """Pairwise frame-F1 between backends (used when no GT exists)."""
    out: Dict[str, Dict[str, float]] = {}
    for r1 in reports:
        row = {}
        for r2 in reports:
            f1 = frame_f1(r1["_regions"], r2["_regions"], total)["f1"]
            row[r2["backend"]] = round(f1, 4)
        out[r1["backend"]] = row
    return out


def analyse(
    audio: np.ndarray,
    sample_rate: int,
    backends: Sequence[str] = ("energy", "silero", "whisperseg"),
    gt_srt: Optional[Path] = None,
    report_path: Optional[Path] = None,
    device="cuda",
) -> Dict:
    gt = regions_from_srt(gt_srt) if gt_srt else None
    reports = [analyse_backend(audio, sample_rate, b, gt, device=device)
               for b in backends]
    total = len(audio) / sample_rate
    result: Dict = {
        "audio_duration_s": round(total, 2),
        "ground_truth": str(gt_srt) if gt_srt else None,
        "backends": [],
    }
    if gt is None:
        result["agreement_matrix"] = agreement_matrix(reports, total)
    for r in reports:
        r = dict(r)
        r.pop("_regions")
        result["backends"].append(r)
    if report_path:
        Path(report_path).write_text(
            json.dumps(result, indent=2, default=str), encoding="utf-8")
    return result
