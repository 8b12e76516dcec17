"""JA voice-type classifier: train/infer a small MLP on audio clips.

Role parity with the reference's standalone classifier utility
(reference: utils/japanese_ero_voice_classifier_AkitoP_v1.py — a torch
MLP over pyannote speaker embeddings, used to label JAV voice types like
moan/dialogue/narration). Features come from the port's MFCC texture
statistics (the same front-end the semantic scene detector uses — no
pyannote, no network), and the classifier is a torch MLP trained
full-batch with Adam (betas (0.9, 0.999), eps 1e-8, no weight decay: the
JAX package's ``optax.adam``, in its order of operations, see
:class:`Adam`) on ``--device`` (default cuda; a missing card is an
error).

Model files are the JAX package's ``.npz`` layout (``w{i}``, ``b{i}``,
``labels``) both ways; :func:`params_from_jax` carries a JAX init (a list
of ``(w, b)``) into the port.

CLI:
    python -m whisperjav_tpu_torch.tools.voice_classifier train \
        --data /clips --labels labels.json --out clf.npz
    python -m whisperjav_tpu_torch.tools.voice_classifier infer \
        --model clf.npz clip.wav

labels.json: {"clip1.wav": "moan", "clip2.wav": "dialogue", ...}
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from whisperjav_tpu_torch.utils.logger import logger


def clip_features(audio: np.ndarray, sample_rate: int) -> np.ndarray:
    """One fixed-length feature vector per clip: mean + std of MFCC
    texture windows (the semantic detector's representation pooled over
    the clip)."""
    from whisperjav_tpu_torch.modules.scene_detection.semantic import (
        compute_mfcc, texture_features,
    )
    mfcc = compute_mfcc(audio, sample_rate)
    feats = texture_features(mfcc, frames_per_window=50)
    if feats.shape[0] == 0:
        feats = np.zeros((1, feats.shape[1]), np.float32)
    return np.concatenate([feats.mean(axis=0), feats.std(axis=0)]) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class VoiceMLP(nn.Module):
    """ReLU MLP: weights (in, out) and biases (out,) per layer, f32."""

    def __init__(self, layers: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.weights = nn.ParameterList(
            [nn.Parameter(torch.as_tensor(w, dtype=torch.float32))
             for w, _ in layers])
        self.biases = nn.ParameterList(
            [nn.Parameter(torch.as_tensor(b, dtype=torch.float32))
             for _, b in layers])

    def layers(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return list(zip(self.weights, self.biases))


def init_mlp(generator: torch.Generator, dims: List[int],
             device="cpu") -> VoiceMLP:
    """He-normal weights N(0, 2/in) from ``generator`` (on ``device``),
    zero biases."""
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=generator, device=device) \
            * (2.0 / a) ** 0.5
        layers.append((w, torch.zeros((b,), device=device)))
    return VoiceMLP(layers)


def params_from_jax(params, device="cpu") -> VoiceMLP:
    """The JAX tool's parameters (a list of ``(w, b)`` arrays) ->
    :class:`VoiceMLP` on ``device``."""
    return VoiceMLP([(torch.from_numpy(np.array(w, np.float32)),
                      torch.from_numpy(np.array(b, np.float32)))
                     for w, b in params]).to(device)


def mlp_logits(model: VoiceMLP, x: torch.Tensor) -> torch.Tensor:
    h = x
    layers = model.layers()
    for w, b in layers[:-1]:
        h = torch.relu(torch.matmul(h, w) + b)
    w, b = layers[-1]
    return torch.matmul(h, w) + b


class Adam(torch.optim.Optimizer):
    """``optax.adam``'s update: moments (1-b)*g + b*m, bias corrections
    1 - b**t taken in the parameters' dtype, m_hat / (sqrt(v_hat) + eps)
    scaled by -lr. ``torch.optim.Adam`` computes the same update in
    another order, with its bias corrections in float64; on the 20-step
    classifier test its loss drifted 1.8e-5 (relative) from the JAX
    tool's, this one's 1.1e-6."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, b1, b2, eps = (group[k] for k in ("lr", "b1", "b2", "eps"))
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["t"] = 0
                    st["m"] = torch.zeros_like(p)
                    st["v"] = torch.zeros_like(p)
                st["t"] += 1
                g, t = p.grad, st["t"]
                st["m"] = (1 - b1) * g + b1 * st["m"]
                st["v"] = (1 - b2) * (g * g) + b2 * st["v"]
                one = p.new_tensor(1.0)
                m_hat = st["m"] / (one - p.new_tensor(b1) ** t)
                v_hat = st["v"] / (one - p.new_tensor(b2) ** t)
                p.add_(m_hat / (v_hat.sqrt() + eps) * -lr)


def train(features: np.ndarray, labels: np.ndarray, n_classes: int,
          hidden: int = 128, steps: int = 300, lr: float = 1e-3,
          seed: int = 0, device="cuda",
          init: Optional[VoiceMLP] = None) -> Tuple[VoiceMLP, float]:
    """Full-batch Adam on the mean cross-entropy; returns the model and
    the loss of the last step (taken before its update). ``init``
    replaces the seeded He-normal start."""
    from whisperjav_tpu_torch.pipelines.engine import resolve_device
    device = resolve_device(device)
    if init is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        model = init_mlp(gen, [features.shape[1], hidden, n_classes],
                         device)
    else:
        model = init.to(device)
    opt = Adam(model.parameters(), lr=lr)
    x = torch.as_tensor(features, dtype=torch.float32, device=device)
    y = torch.as_tensor(labels, dtype=torch.long, device=device)
    loss = None
    for _ in range(steps):
        opt.zero_grad()
        loss = F.cross_entropy(mlp_logits(model, x), y)
        loss.backward()
        opt.step()
    return model, float(loss.detach())


@torch.no_grad()
def predict(model: VoiceMLP, feats: np.ndarray) -> np.ndarray:
    dev = next(model.parameters()).device
    x = torch.as_tensor(feats, dtype=torch.float32, device=dev)
    return torch.softmax(mlp_logits(model, x), dim=-1).cpu().numpy()


# ---------------------------------------------------------------------------
# persistence (the JAX package's file layout)
# ---------------------------------------------------------------------------

def save_model(path: Path, model: VoiceMLP,
               id2label: Dict[int, str]) -> Path:
    flat = {}
    for i, (w, b) in enumerate(model.layers()):
        flat[f"w{i}"] = w.detach().cpu().numpy()
        flat[f"b{i}"] = b.detach().cpu().numpy()
    flat["labels"] = np.asarray(
        json.dumps({str(k): v for k, v in id2label.items()}))
    np.savez(path, **flat)
    return Path(path)


def load_model(path: Path, device="cpu") -> Tuple[VoiceMLP, Dict[int, str]]:
    data = np.load(path, allow_pickle=False)
    id2label = {int(k): v for k, v in
                json.loads(str(data["labels"])).items()}
    params = []
    i = 0
    while f"w{i}" in data:
        params.append((data[f"w{i}"], data[f"b{i}"]))
        i += 1
    return params_from_jax(params, device), id2label


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="voice-classifier")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train")
    t.add_argument("--data", required=True, help="directory of WAV clips")
    t.add_argument("--labels", required=True,
                   help="JSON {filename: label}")
    t.add_argument("--out", default="voice_classifier.npz")
    t.add_argument("--steps", type=int, default=300)
    t.add_argument("--hidden", type=int, default=128)
    t.add_argument("--device", default="cuda")
    i = sub.add_parser("infer")
    i.add_argument("--model", required=True)
    i.add_argument("clips", nargs="+")
    i.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from whisperjav_tpu_torch.modules.audio_io import load_audio
    from whisperjav_tpu_torch.pipelines.engine import resolve_device

    device = resolve_device(args.device)
    if args.cmd == "train":
        label_map = json.loads(Path(args.labels).read_text(encoding="utf-8"))
        names = sorted(set(label_map.values()))
        label2id = {n: i for i, n in enumerate(names)}
        feats, ys = [], []
        for fname, label in sorted(label_map.items()):
            path = Path(args.data) / fname
            if not path.exists():
                logger.warning("missing clip %s; skipped", path)
                continue
            audio = load_audio(path, 16000)
            feats.append(clip_features(audio, 16000))
            ys.append(label2id[label])
        if not feats:
            logger.error("no usable clips")
            return 1
        model, loss = train(np.stack(feats), np.asarray(ys, np.int32),
                            n_classes=len(names), hidden=args.hidden,
                            steps=args.steps, device=device)
        out = save_model(Path(args.out), model,
                         {v: k for k, v in label2id.items()})
        print(json.dumps({"model": str(out), "clips": len(feats),
                          "classes": names, "final_loss": round(loss, 4)}))
        return 0

    model, id2label = load_model(Path(args.model), device)
    results = {}
    for clip in args.clips:
        audio = load_audio(clip, 16000)
        probs = predict(model, clip_features(audio, 16000)[None])[0]
        order = np.argsort(probs)[::-1]
        results[clip] = [(id2label[int(k)], round(float(probs[k]), 4))
                         for k in order]
    print(json.dumps(results, ensure_ascii=False, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
