"""Forensic loss-stage attribution: where did each GT cue die?

Counterpart of the reference's forensic CSV generator (reference:
tools/forensic_csv_generator.py — one row per ground-truth subtitle
with full pipeline trace metadata and a mechanically-determined loss
stage). Joins a GT SRT against everything a run left on disk (final
SRT, per-window `.transcribe.json` diagnostics, artifacts SRT of
sanitizer removals — all aggregated by bench.loader.load_run).

Loss stages, checked in order for each unmatched GT cue:
  matched             a final cue overlaps with text similarity ≥ 0.2
  coverage_loss       no decode window overlapped the GT span — the
                      scene detector or VAD never produced a window
  model_empty         windows covered the span but emitted no text
  sanitizer_removed   an artifacts-SRT removal overlaps the span
                      (reason extracted from its [reason] prefix)
  text_lost           windows emitted text, nothing was removed, but
                      no final cue matches — boundary/stitch losses or
                      a transcript too dissimilar to match
"""

from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from whisperjav_tpu_torch.bench.loader import RunArtifacts
from whisperjav_tpu_torch.bench.matcher import match_subtitles
from whisperjav_tpu_torch.modules.srt import Subtitle

_REASON_RE = re.compile(r"^\[([^\]]+)\]")


def _overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    return min(a1, b1) - max(a0, b0)


def loss_stage_rows(gt_subs: Sequence[Subtitle],
                    run: RunArtifacts) -> List[Dict]:
    """One row per GT cue with its loss stage and trace metadata."""
    match = match_subtitles(gt_subs, run.subtitles)
    matched_gt = {id(gt) for gt, _ in match.matched}
    sims = {id(gt): sim for (gt, _), sim in
            zip(match.matched, match.similarities)}

    rows: List[Dict] = []
    for gt in gt_subs:
        wins = [w for w in run.windows
                if _overlap(gt.start, gt.end, w["start"],
                            w["start"] + w["duration"]) > 0]
        removed = [r for r in run.removed
                   if _overlap(gt.start, gt.end, r.start, r.end) > 0]
        chars = sum(w.get("chars") or 0 for w in wins)

        if id(gt) in matched_gt:
            stage = "matched"
        elif not wins:
            stage = "coverage_loss"
        elif chars == 0:
            stage = "model_empty"
        elif removed:
            stage = "sanitizer_removed"
        else:
            stage = "text_lost"

        reason: Optional[str] = None
        if stage == "sanitizer_removed":
            m = _REASON_RE.match(removed[0].text)
            reason = m.group(1) if m else None

        rows.append({
            "gt_start": round(gt.start, 3),
            "gt_end": round(gt.end, 3),
            "gt_text": gt.text,
            "loss_stage": stage,
            "n_windows": len(wins),
            "window_chars": chars,
            "min_avg_logprob": min(
                (w["avg_logprob"] for w in wins
                 if w.get("avg_logprob") is not None), default=None),
            "max_no_speech": max(
                (w["no_speech_prob"] for w in wins
                 if w.get("no_speech_prob") is not None), default=None),
            "removal_reason": reason,
            "match_similarity": round(sims.get(id(gt), 0.0), 4),
        })
    return rows


def summarize(rows: Sequence[Dict]) -> Dict:
    stages: Dict[str, int] = {}
    for r in rows:
        stages[r["loss_stage"]] = stages.get(r["loss_stage"], 0) + 1
    n = max(len(rows), 1)
    return {"gt_cues": len(rows),
            "stages": stages,
            "capture_rate": round(stages.get("matched", 0) / n, 4)}


def write_forensic_csv(path: Path, rows: Sequence[Dict]) -> Path:
    path = Path(path)
    with open(path, "w", newline="", encoding="utf-8") as f:
        if rows:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    return path
