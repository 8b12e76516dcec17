"""Post-run pipeline analytics: health report over outputs.

Role parity with reference ``whisperjav/modules/pipeline_analytics.py``
(reads per-scene diagnostics + final SRT → scene/alignment/subtitle/
timing metrics + traffic-light health scorecard, called at
qwen_pipeline.py:1056; metric families at pipeline_analytics.py:149-465).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from whisperjav_tpu_torch.modules.srt import Subtitle


def compute_analytics(
    subtitles: Sequence[Subtitle],
    audio_duration_s: float,
    window_stats: Optional[Sequence[Dict]] = None,
) -> Dict:
    """Health metrics for one processed file."""
    subs = list(subtitles)
    if not subs:
        return {
            "subtitle_count": 0,
            "coverage_ratio": 0.0,
            "health": "empty",
            "issues": ["no subtitles produced"],
        }

    durations = np.asarray([s.duration for s in subs])
    gaps = np.asarray([b.start - a.end for a, b in zip(subs[:-1], subs[1:])]
                      ) if len(subs) > 1 else np.zeros(0)
    chars = np.asarray([len(s.text.replace("\n", "")) for s in subs])
    cps = chars / np.maximum(durations, 1e-3)
    covered = float(durations.sum())

    issues: List[str] = []
    out_of_order = int((gaps < -1e-6).sum())
    if out_of_order:
        issues.append(f"{out_of_order} out-of-order cue pairs")
    collapsed = int((durations < 0.15).sum())
    if collapsed:
        issues.append(f"{collapsed} near-zero-duration cues")
    too_fast = int((cps > 30).sum())
    if too_fast:
        issues.append(f"{too_fast} cues above 30 chars/sec")
    coverage = covered / max(audio_duration_s, 1e-6)
    if coverage < 0.05 and audio_duration_s > 60:
        issues.append(f"very low coverage ({coverage:.1%})")

    health = "ok" if not issues else (
        "warning" if len(issues) < 3 else "poor")
    report = {
        "subtitle_count": len(subs),
        "coverage_s": round(covered, 2),
        "coverage_ratio": round(coverage, 4),
        "mean_duration_s": round(float(durations.mean()), 3),
        "mean_gap_s": round(float(gaps.mean()), 3) if len(gaps) else 0.0,
        "mean_cps": round(float(cps.mean()), 2),
        "p95_cps": round(float(np.quantile(cps, 0.95)), 2),
        "health": health,
        "issues": issues,
    }
    if window_stats:
        empty = sum(1 for w in window_stats if not w.get("segments", 1))
        report["windows"] = len(window_stats)
        report["empty_windows"] = empty
    return report


# ---------------------------------------------------------------------------
# Metric families (reference: pipeline_analytics.py:149-465)
# ---------------------------------------------------------------------------

def compute_scene_metrics(scene_spans: Sequence[Tuple[float, float]],
                          speech_regions_s: float = 0.0) -> Dict:
    """Scene/audio health (reference: _compute_scene_metrics, :149-185)."""
    if not scene_spans:
        return {"scene_count": 0, "total_audio_duration_sec": 0.0,
                "speech_ratio": 0.0}
    durs = np.asarray([b - a for a, b in scene_spans], dtype=np.float64)
    total = float(durs.sum())
    return {
        "scene_count": len(scene_spans),
        "total_audio_duration_sec": round(total, 3),
        "scene_duration_min": round(float(durs.min()), 3),
        "scene_duration_max": round(float(durs.max()), 3),
        "scene_duration_mean": round(float(durs.mean()), 3),
        "scene_duration_median": round(float(np.median(durs)), 3),
        "total_vad_speech_sec": round(speech_regions_s, 3),
        "speech_ratio": round(speech_regions_s / total, 4) if total else 0.0,
    }


def compute_alignment_metrics(scene_diagnostics: Sequence[Dict]) -> Dict:
    """Step-down/alignment health from SceneDiagnostics dicts (reference:
    _compute_alignment_metrics, :191-265 — collapse/acceptance rates,
    null-timestamp ratios)."""
    frames = sum(d.get("frames", 0) for d in scene_diagnostics)
    collapsed = sum(d.get("collapsed_frames", 0) for d in scene_diagnostics)
    retries = sum(d.get("step_down_retries", 0) for d in scene_diagnostics)
    words = sum(d.get("aligned_words", 0) for d in scene_diagnostics)
    null_words = sum(d.get("null_timestamp_words", 0)
                     for d in scene_diagnostics)
    hardened = sum(d.get("hardening_actions", 0) for d in scene_diagnostics)
    return {
        "total_frames": frames,
        "collapsed_frames": collapsed,
        "collapse_rate": round(collapsed / frames, 4) if frames else 0.0,
        "step_down_retries": retries,
        "aligned_words": words,
        "null_timestamp_words": null_words,
        "aligner_native_pct": round(100.0 * (1 - null_words / words), 1)
        if words else 0.0,
        "hardening_actions": hardened,
    }


def compute_timing_metrics(subs: Sequence[Subtitle]) -> Dict:
    """Gap/overlap structure of the final cue list (reference:
    _compute_subtitle_metrics gap analysis + _compute_timing_metrics)."""
    subs = list(subs)
    if len(subs) < 2:
        return {"max_gap_sec": 0.0, "large_gaps": [], "overlaps": 0,
                "short_subs_pct": 0.0}
    gaps = [(subs[i + 1].start - subs[i].end, i) for i in range(len(subs) - 1)]
    large = sorted(((g, i) for g, i in gaps if g >= 30.0), reverse=True)[:5]
    short = sum(1 for s in subs if s.duration < 0.3)
    return {
        "max_gap_sec": round(max(g for g, _ in gaps), 2),
        "large_gaps": [{"gap_sec": round(g, 2), "after_sub": i + 1,
                        "before_sub": i + 2} for g, i in large],
        "overlaps": sum(1 for g, _ in gaps if g < -1e-6),
        "short_subs_pct": round(100.0 * short / len(subs), 1),
    }


_LEVELS = ("GREEN", "YELLOW", "RED")


def _grade(value: float, green, yellow, invert: bool = False) -> str:
    """green/yellow are (lo, hi) ranges or scalar thresholds."""
    if isinstance(green, tuple):
        if green[0] <= value <= green[1]:
            return "GREEN"
        return "YELLOW" if yellow[0] <= value <= yellow[1] else "RED"
    ok = value > green if invert else value < green
    mid = value > yellow if invert else value < yellow
    return "GREEN" if ok else ("YELLOW" if mid else "RED")


def health_scorecard(alignment: Dict, timing: Dict, scene: Dict) -> List[Dict]:
    """Traffic-light indicators with the reference's thresholds
    (reference: _compute_health_scorecard, :372-461)."""
    cr = alignment.get("collapse_rate", 0.0) * 100
    an = alignment.get("aligner_native_pct", 100.0)
    sr = scene.get("speech_ratio", 0.0) * 100
    mg = timing.get("max_gap_sec", 0.0)
    ss = timing.get("short_subs_pct", 0.0)
    return [
        {"name": "Collapse rate", "value": f"{cr:.1f}%",
         "level": _grade(cr, 5, 20)},
        {"name": "Aligner native", "value": f"{an:.1f}%",
         "level": _grade(an, 90, 70, invert=True)},
        {"name": "Speech ratio", "value": f"{sr:.1f}%",
         "level": _grade(sr, (25, 70), (15, 85))},
        {"name": "Max gap", "value": f"{mg:.1f}s",
         "level": _grade(mg, 30, 60)},
        {"name": "Short subs (<0.3s)", "value": f"{ss:.1f}%",
         "level": _grade(ss, 5, 15)},
    ]


def compute_full_analytics(
    subtitles: Sequence[Subtitle],
    audio_duration_s: float,
    scene_spans: Optional[Sequence[Tuple[float, float]]] = None,
    scene_diagnostics: Optional[Sequence[Dict]] = None,
    speech_regions_s: float = 0.0,
    window_stats: Optional[Sequence[Dict]] = None,
) -> Dict:
    """Full post-run report: subtitle health + scene/alignment/timing
    metric families + scorecard (the reference's compute_analytics,
    pipeline_analytics.py:580)."""
    report = compute_analytics(subtitles, audio_duration_s, window_stats)
    scene = compute_scene_metrics(scene_spans or [], speech_regions_s)
    alignment = compute_alignment_metrics(scene_diagnostics or [])
    timing = compute_timing_metrics(subtitles)
    report.update({
        "scene_metrics": scene,
        "alignment_metrics": alignment,
        "timing_metrics": timing,
        "scorecard": health_scorecard(alignment, timing, scene),
    })
    return report


_LEVEL_SYMBOLS = {"GREEN": "+", "YELLOW": "~", "RED": "!"}


def print_summary(analytics: Dict, title: str = "") -> None:
    """Console scorecard (reference: print_summary, :465-560)."""
    from whisperjav_tpu_torch.utils.logger import logger
    if title:
        logger.info("─── %s ───", title)
    logger.info("subtitles=%s coverage=%.1f%% health=%s",
                analytics.get("subtitle_count"),
                100 * analytics.get("coverage_ratio", 0.0),
                analytics.get("health"))
    for ind in analytics.get("scorecard", []):
        logger.info(" [%s] %-20s %s", _LEVEL_SYMBOLS[ind["level"]],
                    ind["name"], ind["value"])
