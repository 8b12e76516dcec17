"""Per-VAD-group decode diagnostic: which parameter empties a group?

The port's counterpart of the reference's Faster-Whisper diagnostic suite
(reference: tools/fw_diagnostic_suite.py — reproduce the EXACT
production audio flow, scene detection + VAD grouping, then decode
each VAD group under controlled parameter variants, capturing every
quality signal per group so an empty-output regression can be
attributed to a specific gate or decode option).

Flow (identical modules to the production pipeline):
  scenes (scene_detection) → VAD groups (segmentation) → windows
  (parallel.batching.windows_from_segmentation, NO packing so rows map
  1:1 to groups) → TranscriptionEngine.transcribe_windows under each
  variant.

Variants:
  base        production decode options + quality gates
  gates_off   thresholds disabled (logprob/no-speech/compression) —
              separates "model emitted nothing" from "gate ate it"
  no_ts       timestamp rules off
  ladder      full temperature fallback ladder (0.0 … 1.0)
  beam        beam search (size 2)

Outputs:
  <outdir>/groups.csv      one row per (group, variant): timing,
                           n_segments, n_tokens, empty flag,
                           avg_logprob, no_speech_prob
  <outdir>/summary.json    per-variant empty rates + gate-attribution

The engine runs on ``--device`` (default cuda; a missing card is an
error), in bf16, from the checkpoint or a random init seeded 0.

Usage:
  python -m whisperjav_tpu_torch.tools.decode_diagnostic <audio.wav>
      [--model tiny] [--checkpoint DIR] [--outdir DIAG]
      [--variants base,gates_off] [--batch 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path
from typing import Dict, List


def _variants(names):
    from whisperjav_tpu_torch.models.whisper.decode import DecodeOptions
    from whisperjav_tpu_torch.pipelines.engine import QualityThresholds

    all_variants = {
        "base": dict(
            options=DecodeOptions(max_new_tokens=128, cross_kv_int8=True),
            thresholds=QualityThresholds(temperatures=(0.0,))),
        "gates_off": dict(
            options=DecodeOptions(max_new_tokens=128, cross_kv_int8=True),
            thresholds=QualityThresholds(
                temperatures=(0.0,), logprob_threshold=-1e9,
                no_speech_threshold=1.0,
                compression_ratio_threshold=1e9)),
        "no_ts": dict(
            options=DecodeOptions(max_new_tokens=128, cross_kv_int8=True,
                                  with_timestamps=False),
            thresholds=QualityThresholds(temperatures=(0.0,))),
        "ladder": dict(
            options=DecodeOptions(max_new_tokens=128, cross_kv_int8=True),
            thresholds=QualityThresholds()),
        "beam": dict(
            options=DecodeOptions(max_new_tokens=128, cross_kv_int8=True,
                                  beam_size=2),
            thresholds=QualityThresholds(temperatures=(0.0,))),
    }
    return {n: all_variants[n] for n in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="whisperjav-torch-decode-diagnostic", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input")
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--outdir", default="DIAG")
    ap.add_argument("--variants",
                    default="base,gates_off,no_ts,ladder,beam")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--scene-backend", default="energy")
    ap.add_argument("--segmenter", default="energy")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from whisperjav_tpu_torch.modules.audio_io import read_wav, resample
    from whisperjav_tpu_torch.modules.scene_detection.base import (
        create_scene_detector,
    )
    from whisperjav_tpu_torch.modules.segmentation.base import create_segmenter
    from whisperjav_tpu_torch.parallel.batching import windows_from_segmentation
    from whisperjav_tpu_torch.pipelines.engine import resolve_device

    device = resolve_device(args.device)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    audio, sr = read_wav(args.input)
    if sr != 16_000:
        audio = resample(audio, sr, 16_000)
        sr = 16_000

    # ---- production prep: scenes → VAD groups → windows (no packing) --
    detector = create_scene_detector(args.scene_backend, device=device)
    scenes = detector.detect(audio, sr).scenes
    segmenter = create_segmenter(args.segmenter, device=device)
    windows = []
    for scene in scenes:
        a = int(scene.start * sr)
        b = int(scene.end * sr)
        seg = segmenter.segment(audio[a:b], sr)
        windows.extend(windows_from_segmentation(audio, scene, seg, sr))
    (outdir / "vad_groups.json").write_text(json.dumps([
        {"scene": w.scene_idx, "group": w.group_idx,
         "abs_start": round(w.abs_start, 3),
         "duration": round(w.duration, 3),
         "speech_segments": [[round(s, 3), round(e, 3)]
                             for s, e in w.speech_segments]}
        for w in windows], indent=1))
    print(f"prep: {len(scenes)} scenes → {len(windows)} VAD-group windows")
    if not windows:
        print(json.dumps({"error": "no speech found"}))
        return 1

    # ---- engine per variant ------------------------------------------
    from whisperjav_tpu_torch.pipelines.engine import TranscriptionEngine
    from whisperjav_tpu_torch.pipelines.factory import load_model

    config, model = load_model(args.model, args.checkpoint, device=device)

    rows: List[Dict] = []
    summary: Dict[str, Dict] = {}
    for vname, spec in _variants(
            [v.strip() for v in args.variants.split(",") if v.strip()]
    ).items():
        engine = TranscriptionEngine(
            config, model, options=spec["options"],
            thresholds=spec["thresholds"], batch_size=args.batch,
            device=device)
        results = engine.transcribe_windows(windows)
        empty = 0
        for w, segs in results:
            n_tok = sum(len(s.tokens) for s in segs)
            if not segs:
                empty += 1
            rows.append({
                "variant": vname, "scene": w.scene_idx,
                "group": w.group_idx,
                "abs_start": round(w.abs_start, 3),
                "duration": round(w.duration, 3),
                "n_segments": len(segs), "n_tokens": n_tok,
                "empty": int(not segs),
                "avg_logprob": round(
                    min((s.avg_logprob for s in segs), default=0.0), 4),
                "no_speech_prob": round(
                    max((s.no_speech_prob for s in segs), default=0.0), 4),
            })
        summary[vname] = {
            "groups": len(results), "empty": empty,
            "empty_rate": round(empty / max(len(results), 1), 4),
        }
        print(f"{vname}: {empty}/{len(results)} empty groups")

    # gate attribution: groups empty under base but NOT under gates_off
    # were eaten by a quality gate, not by the model
    base_empty = {(r["scene"], r["group"]) for r in rows
                  if r["variant"] == "base" and r["empty"]}
    open_full = {(r["scene"], r["group"]) for r in rows
                 if r["variant"] == "gates_off" and not r["empty"]}
    if any(r["variant"] == "gates_off" for r in rows):
        summary["gate_attribution"] = {
            "empty_under_base": len(base_empty),
            "recovered_with_gates_off": len(base_empty & open_full),
        }

    with open(outdir / "groups.csv", "w", newline="") as f:
        if rows:
            wtr = csv.DictWriter(f, fieldnames=list(rows[0]))
            wtr.writeheader()
            wtr.writerows(rows)
    (outdir / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
