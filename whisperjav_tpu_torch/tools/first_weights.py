"""whisperjav-torch-first-weights: one-command runbook for real-checkpoint
day, on the port.

Sequences the validation ladder so quality parity is established (or a
regression localized) within hours of the first real checkpoint
appearing (the reference project's binding sites this replaces ad-hoc
debugging for: whisperjav/modules/faster_whisper_pro_asr.py:247-253
model load, bench/metrics.py:77 CER grading):

  stage 0  structural audit — family detect → the port's converter →
           tree/NaN audit → forward smoke on ``--device``
           (tools/verify_checkpoint.verify)
  stage 1  torch-oracle parity — for whisper-family HF dirs, run the
           vendor graph (transformers) and the port's model on the SAME
           weights, both f32 on the CPU (a converter check: its gates are
           f32 gates); gate encoder max-err and teacher-forced logit
           argmax agreement
  stage 2  int8-vs-bf16 quality gate — transcribe the same audio with
           bf16 and int8 decoder weights on ``--device`` (default cuda);
           with ``--pairs`` the gate is CER(int8) − CER(bf16) vs ground
           truth, without it a direct int8-vs-bf16 output-divergence CER
           (consistency gate).
  stage 3  (``--pairs`` only) full CER/IoU/drift grading via
           tools/parity_check — printed as the follow-on command when
           pairs are absent.

Exit 0 = every executed gate passed. The report JSON records each
stage's status so CI or a human can see exactly where weights day
stalled.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ENC_MAX_ERR = 5e-3          # encoder states, float32 vendor vs port
ARGMAX_AGREE = 0.999        # teacher-forced logit argmax agreement
CER_DELTA_GATE = 0.005      # CER(int8) - CER(bf16) vs GT
CONSISTENCY_GATE = 0.02     # int8-vs-bf16 direct output CER (no GT)


def _stage0(path: str, report: Dict, device="cuda") -> bool:
    from whisperjav_tpu_torch.tools.verify_checkpoint import verify
    r = verify(path, forward=True, device=device)
    report["stage0_structural"] = r.to_dict()
    return r.ok


def _is_whisper_hf_dir(path: Path) -> bool:
    cfg = path / "config.json"
    if not cfg.is_file():
        return False
    try:
        return json.loads(cfg.read_text()).get("model_type") == "whisper"
    except (OSError, json.JSONDecodeError):
        return False


def _stage1_whisper_oracle(path: Path, report: Dict) -> Optional[bool]:
    """Encoder + teacher-forced logits vs transformers on the same
    weights, both f32 on the CPU."""
    try:
        import torch
        import transformers
    except ImportError:
        report["stage1_oracle"] = {"status": "skipped: no transformers"}
        return None
    from whisperjav_tpu_torch.models.whisper.convert import (
        config_from_hf, params_from_hf_state_dict,
    )
    from whisperjav_tpu_torch.models.whisper.model import encode, forward
    from whisperjav_tpu_torch.models.whisper.weights import params_from_jax

    hf = transformers.WhisperForConditionalGeneration.from_pretrained(
        str(path), torch_dtype=torch.float32)
    hf.eval()
    config = config_from_hf(hf.config)
    model = params_from_jax(
        params_from_hf_state_dict(hf.model.state_dict(), config), config)

    rng = np.random.default_rng(42)
    mel = rng.standard_normal((1, config.n_mels, 3000)).astype(np.float32)
    mel *= 0.5
    tokens = rng.integers(0, config.n_vocab, size=(1, 12)).astype(np.int32)
    with torch.no_grad():
        ref_enc = hf.model.encoder(
            torch.from_numpy(mel)).last_hidden_state.numpy()
        ours_enc = encode(model, torch.from_numpy(mel)).numpy()
        ref_logits = hf(
            input_features=torch.from_numpy(mel),
            decoder_input_ids=torch.from_numpy(tokens.astype(np.int64)),
        ).logits.numpy()
        ours_logits = forward(model, torch.from_numpy(mel),
                              torch.from_numpy(tokens.astype(np.int64))
                              ).numpy()
    enc_err = float(np.max(np.abs(ours_enc - ref_enc)))
    agree = float((ours_logits.argmax(-1) == ref_logits.argmax(-1)).mean())
    ok = enc_err < ENC_MAX_ERR and agree >= ARGMAX_AGREE
    report["stage1_oracle"] = {
        "status": "pass" if ok else "FAIL",
        "encoder_max_err": enc_err, "encoder_gate": ENC_MAX_ERR,
        "logit_argmax_agreement": agree, "agreement_gate": ARGMAX_AGREE,
    }
    return ok


def _transcribe_text(checkpoint: str, wavs: List[Path], int8: bool,
                     mode: str, batch_size: int,
                     device="cuda") -> List[str]:
    """One pipeline pass over ``wavs`` on ``device``; returns the joined
    cue text per file. A fresh pipeline per arm keeps the int8/bf16
    engines from sharing state; each is dropped before the next."""
    from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
    from whisperjav_tpu_torch.modules.audio_io import load_audio
    from whisperjav_tpu_torch.pipelines.engine import release_device_memory
    from whisperjav_tpu_torch.pipelines.factory import build_pipeline

    cfg = resolve_pipeline_config(mode=mode, batch_size=batch_size,
                                  int8_weights=int8 or None)
    pipeline = build_pipeline(cfg, checkpoint=checkpoint, device=device)
    out = []
    for wav in wavs:
        audio = load_audio(str(wav), 16000)
        subs, _stats = pipeline.process_audio(audio, 16000)
        out.append(" ".join(s.text.strip() for s in subs))
    del pipeline
    release_device_memory(device)
    return out


def _stage2_int8_gate(checkpoint: str, wavs: List[Path],
                      gts: Optional[List[Path]], mode: str,
                      batch_size: int, report: Dict,
                      device="cuda") -> bool:
    from whisperjav_tpu_torch.bench.metrics import character_error_rate as cer

    bf16 = _transcribe_text(checkpoint, wavs, False, mode, batch_size,
                            device)
    int8 = _transcribe_text(checkpoint, wavs, True, mode, batch_size,
                            device)
    if gts:
        from whisperjav_tpu_torch.modules.srt import load_srt
        gt_texts = [" ".join(s.text.strip() for s in load_srt(g))
                    for g in gts]
        cer_bf16 = float(np.mean([cer(g, h) for g, h in zip(gt_texts, bf16)]))
        cer_int8 = float(np.mean([cer(g, h) for g, h in zip(gt_texts, int8)]))
        delta = cer_int8 - cer_bf16
        ok = delta <= CER_DELTA_GATE
        report["stage2_int8_gate"] = {
            "status": "pass" if ok else "FAIL",
            "cer_bf16": round(cer_bf16, 4), "cer_int8": round(cer_int8, 4),
            "delta": round(delta, 4), "gate": CER_DELTA_GATE,
            "protocol": "CER vs ground truth, int8 minus bf16",
        }
        return ok
    div = float(np.mean([cer(a, b) for a, b in zip(bf16, int8)])) \
        if any(bf16) or any(int8) else 0.0
    ok = div <= CONSISTENCY_GATE
    report["stage2_int8_gate"] = {
        "status": "pass" if ok else "FAIL",
        "output_divergence_cer": round(div, 4), "gate": CONSISTENCY_GATE,
        "protocol": "no GT given: direct int8-vs-bf16 output CER",
    }
    return ok


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="whisperjav-torch-first-weights",
        description="Run the first-real-checkpoint validation ladder "
                    "on the port.")
    ap.add_argument("--checkpoint", required=True,
                    help="local checkpoint file or HF model directory")
    ap.add_argument("--pairs", nargs="*", default=[],
                    help="media:gt_srt pairs (enables the GT-graded "
                         "int8 gate and prints the stage-3 command)")
    ap.add_argument("--wavs", nargs="*", default=[],
                    help="GT-less audio for the int8 consistency gate "
                         "(default: 20 s synthesized speech-shaped WAV)")
    ap.add_argument("--mode", default="balanced")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--report", default="first_weights_report.json")
    ap.add_argument("--skip-int8-gate", action="store_true",
                    help="stop after stages 0-1 (structure + oracle)")
    ap.add_argument("--device", default="cuda",
                    help="device of the forward smoke and stage 2 "
                         "(default cuda; a missing card is an error)")
    args = ap.parse_args(argv)

    from whisperjav_tpu_torch.pipelines.engine import resolve_device
    resolve_device(args.device)
    report: Dict = {"checkpoint": args.checkpoint}
    ok = _stage0(args.checkpoint, report, args.device)
    print(f"stage 0 structural audit: {'PASS' if ok else 'FAIL'}",
          file=sys.stderr, flush=True)

    path = Path(args.checkpoint)
    if ok and path.is_dir() and _is_whisper_hf_dir(path):
        s1 = _stage1_whisper_oracle(path, report)
        if s1 is not None:
            ok = ok and s1
            print(f"stage 1 torch-oracle parity: {'PASS' if s1 else 'FAIL'}",
                  file=sys.stderr, flush=True)
    elif ok:
        report["stage1_oracle"] = {
            "status": "skipped: oracle comparison is automated for "
                      "whisper HF dirs; other families run their parity "
                      "tests (tests/test_torch_*.py)"}

    if ok and not args.skip_int8_gate:
        wavs: List[Path] = [Path(w) for w in args.wavs]
        gts: Optional[List[Path]] = None
        if args.pairs:
            wavs = [Path(p.rsplit(":", 1)[0]) for p in args.pairs]
            gts = [Path(p.rsplit(":", 1)[1]) for p in args.pairs]
        if not wavs:
            import tempfile
            from whisperjav_tpu_torch.tools.e2e_bench import synth_long_wav
            tmp = Path(tempfile.mkdtemp(prefix="wjav_fw_"))
            wav = tmp / "gate_input.wav"
            synth_long_wav(wav, minutes=20 / 60.0)
            wavs = [wav]
        s2 = _stage2_int8_gate(args.checkpoint, wavs, gts, args.mode,
                               args.batch_size, report, args.device)
        ok = ok and s2
        print(f"stage 2 int8-vs-bf16 gate: {'PASS' if s2 else 'FAIL'}",
              file=sys.stderr, flush=True)

    if args.pairs:
        report["stage3_next"] = (
            "python -m whisperjav_tpu_torch.tools.parity_check --checkpoint "
            f"{args.checkpoint} --pairs {' '.join(args.pairs)} --device "
            f"{args.device}")
    report["ok"] = ok
    Path(args.report).write_text(
        json.dumps(report, indent=2, ensure_ascii=False), encoding="utf-8")
    print(json.dumps(report, indent=2, ensure_ascii=False))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
