"""Cue provenance: trace each subtitle back through the pipeline.

Role parity with reference ``whisperjav/bench/provenance.py`` — for
every final cue: which decode window (scene, group) produced it, that
window's confidence (avg_logprob / no_speech_prob), and aggregate
analytics: accuracy per window, which windows produced the misses and
hallucinations. This is the debugging view that turns "CER went up"
into "scene 7's window decoded at logprob −2.3 and hallucinated
4 cues".
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from whisperjav_tpu_torch.modules.srt import Subtitle


def find_window(sub: Subtitle, windows: Sequence[Dict]) -> Optional[int]:
    """Window whose [start, start+duration) contains the cue midpoint."""
    mid = (sub.start + sub.end) / 2.0
    for i, w in enumerate(windows):
        w0 = w.get("start", 0.0)
        if w0 <= mid < w0 + w.get("duration", 0.0):
            return i
    return None


def build_provenance(subs: Sequence[Subtitle],
                     windows: Sequence[Dict]) -> List[Dict]:
    """Per-cue provenance records (cue → window → scene/group/conf)."""
    out = []
    for s in subs:
        wi = find_window(s, windows)
        rec = {"index": s.index, "start": round(s.start, 3),
               "end": round(s.end, 3), "window": wi}
        if wi is not None:
            w = windows[wi]
            rec.update({
                "scene": w.get("scene"), "group": w.get("group"),
                "avg_logprob": w.get("avg_logprob"),
                "no_speech_prob": w.get("no_speech_prob"),
            })
        out.append(rec)
    return out


def window_analytics(match_result, windows: Sequence[Dict],
                     test_subs: Sequence[Subtitle]) -> List[Dict]:
    """Per-window scorecard: matched / hallucinated counts + confidence.

    Sorted worst-first (hallucinations desc, then matched asc) — the
    reference report's "worst scenes" ranking at window granularity.
    """
    matched_ids = {id(t) for _, t in match_result.matched}
    halluc_ids = {id(t) for t in match_result.hallucinated}
    per: Dict[int, Dict] = {}
    for s in test_subs:
        wi = find_window(s, windows)
        if wi is None:
            continue
        rec = per.setdefault(wi, {
            "window": wi,
            "scene": windows[wi].get("scene"),
            "group": windows[wi].get("group"),
            "avg_logprob": windows[wi].get("avg_logprob"),
            "matched": 0, "hallucinated": 0, "cues": 0})
        rec["cues"] += 1
        if id(s) in matched_ids:
            rec["matched"] += 1
        elif id(s) in halluc_ids:
            rec["hallucinated"] += 1
    return sorted(per.values(),
                  key=lambda r: (-r["hallucinated"], r["matched"]))
