"""Quality metrics: CER, timing IoU, boundary drift, temporal order.

Role parity with the reference bench harness (reference:
whisperjav/bench/metrics.py:25-134 — NFKC-normalized speaker-label-
stripped char-level CER, IoU timing score, temporal-order analysis) and
the VAD ground-truth analyser's frame-level F1 (reference:
tools/vad_groundtruth_analyser/__init__.py:1-26). All pure numpy.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from whisperjav_tpu_torch.modules.srt import Subtitle

_SPEAKER_LABEL = re.compile(r"^[（(\[【][^）)\]】]{1,12}[）)\]】][:：]?\s*")
_WS = re.compile(r"\s+")


def normalize_for_cer(text: str) -> str:
    """NFKC, strip speaker labels per line, collapse whitespace."""
    lines = []
    for ln in text.split("\n"):
        ln = _SPEAKER_LABEL.sub("", ln.strip())
        lines.append(ln)
    t = unicodedata.normalize("NFKC", " ".join(lines))
    return _WS.sub("", t)


def levenshtein(a: str, b: str) -> int:
    """Char-level edit distance, O(len(a)·len(b)) with vectorized rows.

    The insertion recurrence cur[j] = min(base[j], cur[j-1]+1) is resolved
    without an inner Python loop via the prefix-min identity
    cur[j] = min_{i≤j}(vals[i] + (j-i)) = accmin(vals - idx)[j] + j.
    """
    if not a:
        return len(b)
    if not b:
        return len(a)
    bb = np.frombuffer(b.encode("utf-32-le"), dtype=np.uint32)
    idx = np.arange(len(b) + 1, dtype=np.int32)
    prev = idx.copy()
    for i, ca in enumerate(a, start=1):
        sub_cost = prev[:-1] + (bb != ord(ca))
        base = np.minimum(sub_cost, prev[1:] + 1)
        vals = np.concatenate(([np.int32(i)], base))
        prev = np.minimum.accumulate(vals - idx) + idx
    return int(prev[-1])


def character_error_rate(reference: str, hypothesis: str) -> float:
    ref = normalize_for_cer(reference)
    hyp = normalize_for_cer(hypothesis)
    if not ref:
        return 0.0 if not hyp else 1.0
    return levenshtein(ref, hyp) / len(ref)


# ---------------------------------------------------------------------------
# timing metrics
# ---------------------------------------------------------------------------

def _timeline_mask(subs: Sequence[Subtitle], resolution: float,
                   total: float) -> np.ndarray:
    n = int(np.ceil(total / resolution)) + 1
    mask = np.zeros(n, bool)
    for s in subs:
        a = int(s.start / resolution)
        b = int(np.ceil(s.end / resolution))
        mask[a:min(b, n)] = True
    return mask


def timing_iou(gt: Sequence[Subtitle], test: Sequence[Subtitle],
               resolution: float = 0.05) -> float:
    """Global timeline IoU between subtitle coverage masks."""
    if not gt and not test:
        return 1.0
    total = max([s.end for s in list(gt) + list(test)] + [1.0])
    g = _timeline_mask(gt, resolution, total)
    t = _timeline_mask(test, resolution, total)
    union = np.logical_or(g, t).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(g, t).sum() / union)


def frame_f1(gt: Sequence[Tuple[float, float]],
             test: Sequence[Tuple[float, float]],
             total: float, resolution: float = 0.01) -> Dict[str, float]:
    """Frame-level precision/recall/F1 between speech-region sets (the VAD
    ground-truth analyser's headline metric)."""
    n = int(np.ceil(total / resolution)) + 1
    g = np.zeros(n, bool)
    t = np.zeros(n, bool)
    for a, b in gt:
        g[int(a / resolution):int(np.ceil(b / resolution))] = True
    for a, b in test:
        t[int(a / resolution):int(np.ceil(b / resolution))] = True
    tp = float(np.logical_and(g, t).sum())
    fp = float(np.logical_and(~g, t).sum())
    fn = float(np.logical_and(g, ~t).sum())
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"precision": precision, "recall": recall, "f1": f1}


def boundary_drift(gt: Sequence[Subtitle],
                   test: Sequence[Subtitle]) -> Dict[str, float]:
    """Mean |start/end offset| between each GT cue and its best-IoU match."""
    if not gt or not test:
        return {"mean_start_drift": float("nan"),
                "mean_end_drift": float("nan"), "matched": 0}
    starts, ends, matched = [], [], 0
    for g in gt:
        best, best_iou = None, 0.0
        for t in test:
            inter = max(0.0, min(g.end, t.end) - max(g.start, t.start))
            union = (g.end - g.start) + (t.end - t.start) - inter
            iou = inter / union if union > 0 else 0.0
            if iou > best_iou:
                best, best_iou = t, iou
        if best is not None and best_iou > 0.1:
            matched += 1
            starts.append(abs(g.start - best.start))
            ends.append(abs(g.end - best.end))
    return {
        "mean_start_drift": float(np.mean(starts)) if starts else float("nan"),
        "mean_end_drift": float(np.mean(ends)) if ends else float("nan"),
        "matched": matched,
    }


def timing_offsets(gt: Sequence[Subtitle],
                   test: Sequence[Subtitle]) -> Dict[str, float]:
    """Signed + absolute start/end offsets (ms) over best-IoU matched
    pairs (reference: bench/metrics.py:248-280 compute_timing_offsets —
    signed means reveal systematic early/late bias, absolute means
    reveal jitter)."""
    d_start, d_end = [], []
    for g in gt:
        best, best_iou = None, 0.0
        for t in test:
            inter = max(0.0, min(g.end, t.end) - max(g.start, t.start))
            union = (g.end - g.start) + (t.end - t.start) - inter
            iou = inter / union if union > 0 else 0.0
            if iou > best_iou:
                best, best_iou = t, iou
        if best is not None and best_iou > 0.1:
            d_start.append((best.start - g.start) * 1000.0)
            d_end.append((best.end - g.end) * 1000.0)
    if not d_start:
        return {"start_offset_mean_ms": 0.0, "end_offset_mean_ms": 0.0,
                "start_offset_abs_mean_ms": 0.0,
                "end_offset_abs_mean_ms": 0.0, "matched_pairs": 0}
    return {
        "start_offset_mean_ms": float(np.mean(d_start)),
        "end_offset_mean_ms": float(np.mean(d_end)),
        "start_offset_abs_mean_ms": float(np.mean(np.abs(d_start))),
        "end_offset_abs_mean_ms": float(np.mean(np.abs(d_end))),
        "matched_pairs": len(d_start),
    }


def temporal_order_score(test: Sequence[Subtitle]) -> float:
    """Fraction of consecutive cue pairs in chronological order."""
    if len(test) < 2:
        return 1.0
    ok = sum(1 for a, b in zip(test[:-1], test[1:]) if b.start >= a.start)
    return ok / (len(test) - 1)


@dataclass
class BenchReport:
    cer: float
    timing_iou: float
    boundary: Dict[str, float]
    offsets: Dict[str, float]
    temporal_order: float
    gt_cues: int
    test_cues: int

    def to_dict(self) -> Dict:
        return {
            "cer": round(self.cer, 4),
            "timing_iou": round(self.timing_iou, 4),
            "boundary_drift": {k: (round(v, 3) if isinstance(v, float) else v)
                               for k, v in self.boundary.items()},
            "timing_offsets": {k: (round(v, 2) if isinstance(v, float)
                                   else v)
                               for k, v in self.offsets.items()},
            "temporal_order": round(self.temporal_order, 4),
            "gt_cues": self.gt_cues,
            "test_cues": self.test_cues,
        }


def evaluate(gt: Sequence[Subtitle], test: Sequence[Subtitle]) -> BenchReport:
    gt_text = "\n".join(s.text for s in gt)
    test_text = "\n".join(s.text for s in test)
    return BenchReport(
        cer=character_error_rate(gt_text, test_text),
        timing_iou=timing_iou(gt, test),
        boundary=boundary_drift(gt, test),
        offsets=timing_offsets(gt, test),
        temporal_order=temporal_order_score(list(test)),
        gt_cues=len(gt),
        test_cues=len(test),
    )
