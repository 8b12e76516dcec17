"""``whisperjav-torch-finetune``: fine-tune Whisper on (WAV, SRT) pairs.

Counterpart of ``whisperjav_tpu/finetune.py``, with its flags and
defaults and ``--device`` (default ``cuda``; a CUDA device that is not
there is an error). Subtitles corrected by hand become training data:
each 30 s window with cues becomes one teacher-forced example in the
timestamp-token grammar the decoder emits (sot, language, task, then
``<|t0|> text <|t1|>`` per cue, eot), with the loss on everything after
the task token. The train step (``parallel/train.py``) runs data and
tensor parallel over the processes ``torchrun`` starts, one per GPU;
rank 0 logs and writes ``step_NNNNNN`` checkpoints in the npz format of
``utils/checkpoint.py``, which the JAX package's ``load_checkpoint``
reads too.

    whisperjav-torch-finetune --data pairs/ --model turbo --batch-size 4
    torchrun --nproc-per-node 4 -m whisperjav_tpu_torch.finetune \\
        --data pairs/ --model turbo --tp 2
    whisperjav-torch-finetune --data pairs/ --device cpu --model tiny
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from whisperjav_tpu_torch.utils.logger import logger

WINDOW_S = 30.0


# ---------------------------------------------------------------------------
# dataset: (wav, srt) pairs -> fixed-shape teacher-forced examples
# ---------------------------------------------------------------------------

def discover_pairs(data_dir: Path) -> List[Tuple[Path, Path]]:
    """WAV files with a sibling SRT (any of `x.srt`, `x.ja.srt`,
    `x.ja.whisperjav.srt`)."""
    pairs = []
    for wav in sorted(data_dir.rglob("*.wav")):
        for cand in (wav.with_suffix(".srt"),
                     wav.with_suffix(".ja.srt"),
                     wav.with_name(wav.stem + ".ja.whisperjav.srt")):
            if cand.exists():
                pairs.append((wav, cand))
                break
    return pairs


def build_examples(
    wav_path: Path,
    srt_path: Path,
    tokenizer,
    config,
    max_tokens: int,
    language: str = "ja",
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (audio_window f32 (N,), tokens i32 (max_tokens,),
    loss_mask f32 (max_tokens,)) per 30 s window containing cues.

    Token layout per window — exactly what decode emits (sot, lang,
    task, then ``<|ts|> text <|ts|>`` per cue, eot); loss is masked to
    everything AFTER the task token so the model is not trained to
    predict its own prompt. A cue that would overflow ``max_tokens``
    ends the window's cues there (a window left with none is skipped).
    """
    from whisperjav_tpu_torch.models.whisper.config import language_token
    from whisperjav_tpu_torch.modules.audio_extraction import AudioExtractor
    from whisperjav_tpu_torch.modules.audio_io import WHISPER_SAMPLE_RATE
    from whisperjav_tpu_torch.modules.srt import load_srt

    audio, duration = AudioExtractor(WHISPER_SAMPLE_RATE).extract(wav_path)
    subs = load_srt(srt_path)
    sr = WHISPER_SAMPLE_RATE
    n_win = int(np.ceil(duration / WINDOW_S))
    ts_begin = config.timestamp_begin
    precision = 0.02

    for w in range(n_win):
        w0 = w * WINDOW_S
        w1 = w0 + WINDOW_S
        cues = [s for s in subs if s.start < w1 and s.end > w0
                and s.text.strip()]
        if not cues:
            continue
        toks: List[int] = [config.sot,
                           language_token(config, language),
                           config.transcribe]
        prompt_len = len(toks)
        ok = True
        for s in cues:
            t0 = int(round(max(s.start - w0, 0.0) / precision))
            t1 = int(round(min(s.end - w0, WINDOW_S) / precision))
            text_ids = tokenizer.encode(s.text.strip())
            if len(toks) + len(text_ids) + 3 > max_tokens:
                ok = False
                break
            toks.append(ts_begin + t0)
            toks.extend(text_ids)
            toks.append(ts_begin + min(t1, 1500))
        if not ok and len(toks) <= prompt_len:
            continue
        toks.append(config.eot)
        buf = np.full((max_tokens,), config.eot, np.int32)
        buf[:len(toks)] = toks
        mask = np.zeros((max_tokens,), np.float32)
        mask[prompt_len:len(toks)] = 1.0   # train on ts/text/eot only
        a0 = int(w0 * sr)
        clip = audio[a0:a0 + int(WINDOW_S * sr)]
        win = np.zeros((int(WINDOW_S * sr),), np.float32)
        win[:len(clip)] = clip
        yield win, buf, mask


def batch_examples(examples, batch_size: int, n_mels: int, device="cpu"):
    """Group examples into fixed (B, n_mels, 3000) mel + token batches:
    yields (mel f32 tensor on ``device``, tokens i32 (B, S), loss mask
    f32 (B, S)). The final partial batch pads with repeats so shapes never
    vary; as in the JAX package, every pad row repeats the tail's first
    example (``buf[len(buf) % len(buf)]`` is ``buf[0]``), so that example
    weighs more in the last step's loss."""
    buf: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for ex in examples:
        buf.append(ex)
        if len(buf) == batch_size:
            yield _finalize(buf, n_mels, device)
            buf = []
    if buf:
        while len(buf) < batch_size:      # repeat-pad the tail
            buf.append(buf[len(buf) % max(len(buf), 1)])
        yield _finalize(buf, n_mels, device)


def _finalize(buf, n_mels: int, device):
    from whisperjav_tpu_torch.ops.mel import log_mel_spectrogram
    audio = torch.from_numpy(np.stack([b[0] for b in buf])).to(device)
    mel = log_mel_spectrogram(audio, n_mels=n_mels)
    tokens = np.stack([b[1] for b in buf])
    mask = np.stack([b[2] for b in buf])
    return mel, tokens, mask


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="whisperjav-torch-finetune",
        description="fine-tune Whisper on corrected (WAV, SRT) pairs")
    p.add_argument("--data", required=True,
                   help="directory of WAV files with sibling SRTs")
    p.add_argument("--model", default="tiny",
                   help="whisper size to fine-tune")
    p.add_argument("--checkpoint", default=None,
                   help="initial weights (local Hugging Face directory)")
    p.add_argument("--output-dir", default="./finetuned")
    p.add_argument("--steps", type=int, default=100,
                   help="max optimizer steps (epochs repeat the data)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-tokens", type=int, default=448)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel degree (default: 2 on an even "
                        "world of 2 or more processes, else 1)")
    p.add_argument("--save-every", type=int, default=50)
    p.add_argument("--language", default="ja")
    p.add_argument("--seed", type=int, default=0,
                   help="accepted as in the JAX CLI, which reads it "
                        "nowhere (the random init is seeded 0)")
    p.add_argument("--device", default="cuda",
                   help="train device: cuda (cuda:$LOCAL_RANK under "
                        "torchrun) or cpu")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)

    from whisperjav_tpu_torch.models.whisper.tokenizer import (
        WhisperTokenizer, find_tokenizer_files,
    )
    from whisperjav_tpu_torch.parallel.train import (
        build_sharded_train_step, full_params, make_optimizer,
        make_train_mesh,
    )
    from whisperjav_tpu_torch.pipelines import factory
    from whisperjav_tpu_torch.utils.checkpoint import save_checkpoint

    data_dir = Path(args.data)
    pairs = discover_pairs(data_dir)
    if not pairs:
        logger.error("no (wav, srt) pairs under %s", data_dir)
        return 1

    mesh = make_train_mesh(tp=args.tp, device=args.device)
    lead = mesh.rank == 0

    def info(*a):
        if lead:
            logger.info(*a)

    info("found %d (wav, srt) pair(s)", len(pairs))
    config, model = factory.load_model(args.model, args.checkpoint,
                                       device=mesh.device,
                                       dtype=torch.float32)
    tokenizer = WhisperTokenizer(config,
                                 find_tokenizer_files(args.checkpoint))
    if not tokenizer.is_real and lead:
        logger.warning("no real tokenizer found — token ids use the "
                       "fallback hash (plumbing/testing only)")

    info("mesh %s (dp, tp) on %s", mesh.shape, mesh.device)
    if args.batch_size % mesh.dp:
        padded = ((args.batch_size + mesh.dp - 1) // mesh.dp) * mesh.dp
        info("batch %d → %d (data-parallel axis %d)", args.batch_size,
             padded, mesh.dp)
        args.batch_size = padded
    optimizer = make_optimizer(args.lr, args.weight_decay)
    init_fn, step_fn = build_sharded_train_step(config, mesh, optimizer)
    state = init_fn(model)
    del model

    out_dir = Path(args.output_dir)
    if lead:
        out_dir.mkdir(parents=True, exist_ok=True)
    losses: List[float] = []
    t0 = time.time()
    step = 0

    def save():
        tree = full_params(state.params, mesh)   # every tp rank gathers
        if not lead:
            return None
        return save_checkpoint(
            out_dir / f"step_{step:06d}", tree,
            metadata={"model": config.name, "step": step,
                      "loss": losses[-1] if losses else None,
                      "loss_history_tail": losses[-20:]})

    while step < args.steps:
        def examples():
            for wav, srt in pairs:
                yield from build_examples(wav, srt, tokenizer, config,
                                          args.max_tokens, args.language)
        saw_batch = False
        for mel, tokens, mask in batch_examples(examples(),
                                                args.batch_size,
                                                config.n_mels, mesh.device):
            saw_batch = True
            state, loss = step_fn(state, mel, tokens, mask)
            losses.append(loss)
            step += 1
            if step % 10 == 0 or step == args.steps:
                info("step %d/%d  loss %.4f", step, args.steps, losses[-1])
            if args.save_every and step % args.save_every == 0:
                save()
            if step >= args.steps:
                break
        if not saw_batch:
            logger.error("dataset produced no training windows")
            return 1
    path = save()
    info("fine-tune done: %d steps in %.1fs → %s", step, time.time() - t0,
         path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
