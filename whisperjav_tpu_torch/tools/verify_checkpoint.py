"""whisperjav-torch-verify-checkpoint: diagnose a real checkpoint BEFORE
use.

The first user with real weights should get a pass/fail report, not a
stack trace (the reference project's binding sites this guards:
whisperjav/modules/speech_enhancement/backends/{clearvoice,bs_roformer,
zipenhancer}.py, speech_segmentation/backends/{silero,whisperseg,ten}.py,
modules/faster_whisper_pro_asr.py:247-253). For any local checkpoint
file/dir it:

1. detects the model family from the artifact itself (config.json
   model_type, ONNX graph content, or state-dict key signatures);
2. runs the family's converter in the port (the code the pipeline uses)
   and takes its result as the parameter tree of the JAX package's
   layout (the enhancers' modules through their name tables), so the
   audit counts and checks the same leaves in both packages;
3. audits the result: leaf count, NaN/Inf, degenerate (all-zero)
   tensors;
4. optionally runs a tiny forward smoke (--forward) of the small model
   families on ``--device`` (default cuda) and checks the output's
   shape and finiteness;
5. prints a human report and exits nonzero on failure.

Detection is signature-based, then falls back to trying every converter
— so renamed files still resolve.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

FAMILIES = ("whisper", "qwen", "silero", "whisperseg", "ten",
            "zipenhancer", "frcrn", "mossformer2", "bs_roformer")


@dataclass
class Report:
    path: str
    family: Optional[str] = None
    fmt: Optional[str] = None          # hf-dir | torch-sd | onnx | npz
    ok: bool = False
    n_source_keys: int = 0
    n_leaves: int = 0
    errors: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)
    forward: Optional[str] = None      # "ok (shape)" | error text

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in
                ("path", "family", "fmt", "ok", "n_source_keys",
                 "n_leaves", "errors", "warnings", "notes", "forward")}


# ---------------------------------------------------------------- loading

def _load_state_dict(path: Path) -> Tuple[Dict[str, Any], str]:
    """Load a tensor dict from .pt/.pth/.bin/.ckpt/.safetensors/.npz."""
    suffix = path.suffix.lower()
    if suffix == ".npz":
        data = np.load(path)
        return {k: data[k] for k in data.files}, "npz"
    if suffix == ".safetensors":
        from safetensors.numpy import load_file
        return dict(load_file(str(path))), "safetensors"
    import torch
    obj = torch.load(str(path), map_location="cpu", weights_only=False)
    # common wrappers: {'state_dict': ...} (lightning/ckpt),
    # {'model_state_dict': ...}, JIT archives expose .state_dict()
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    for key in ("state_dict", "model_state_dict", "model", "module"):
        if isinstance(obj, dict) and key in obj and isinstance(
                obj[key], dict) and len(obj[key]) > 4:
            obj = obj[key]
    if not isinstance(obj, dict):
        raise ValueError(f"unsupported checkpoint object {type(obj)}")
    return obj, "torch-sd"


# ---------------------------------------------------------------- detection

def _strip_common_prefixes(keys: List[str]) -> List[str]:
    out = []
    for k in keys:
        for pre in ("model.mossformer.", "model.", "_model.", "module.",
                    "generator.", "thinker."):
            if k.startswith(pre):
                k = k[len(pre):]
        out.append(k)
    return out


def detect_family_from_keys(keys: List[str]) -> Optional[str]:
    ks = set(_strip_common_prefixes(keys))

    def has(*subs):
        return all(any(s in k for k in ks) for s in subs)

    if has("stft.forward_basis_buffer", "decoder.rnn.weight_ih"):
        return "silero"
    if has("band_split.to_features.0.0.gamma"):
        return "bs_roformer"
    if has("unet.encoders.0.conv.conv_re.weight"):
        return "frcrn"
    if has("conv1d_encoder.weight", "mdl.intra_mdl.mossformerM"):
        return "mossformer2"
    if has("dense_encoder.conv1.weight", "phase_decoder."):
        return "zipenhancer"
    if has("audio_tower.") or has("audio.") and has("lm_head.weight"):
        return "qwen"
    if has("encoder.conv1.weight", "decoder.embed_tokens.weight"):
        # whisper trunk; a (1, d) frame head outside it means whisperseg
        trunk = {k for k in ks if k.startswith(("encoder.", "decoder."))}
        extra = ks - trunk
        if any(k.endswith(".weight") and ("head" in k or "classifier" in k)
               for k in extra):
            return "whisperseg"
        return "whisper"
    return None


def detect_family_from_dir(path: Path) -> Optional[str]:
    cfg = path / "config.json"
    if cfg.exists():
        try:
            data = json.loads(cfg.read_text())
        except Exception:
            return None
        mt = (data.get("model_type") or "").lower()
        archs = " ".join(data.get("architectures") or []).lower()
        if "qwen" in mt or "qwen" in archs:
            return "qwen"
        if "whisper" in mt or "whisper" in archs:
            return "whisper"
    return None


def _onnx_family(path: Path) -> Optional[str]:
    from whisperjav_tpu_torch.utils.onnx_io import read_initializers
    low = " ".join(sorted(read_initializers(str(path)))).lower()
    if "lstm" in low or "iofc" in low:
        return "ten"
    if "dense_encoder" in low or "phase_decoder" in low:
        return "zipenhancer"
    if "conv_re" in low or "unet" in low:
        return "frcrn"
    return None


# ---------------------------------------------------------------- converters

def _convert(family: str, sd: Optional[Dict[str, Any]],
             path: Path) -> Tuple[Any, List[str]]:
    """Run the family's converter; returns (params_tree, notes)."""
    notes: List[str] = []
    if family == "whisper":
        from whisperjav_tpu_torch.models.whisper.convert import load_pretrained
        if path.is_dir():
            config, params = load_pretrained(str(path))
            notes.append(f"arch {config.name}: {config.n_audio_layer}+"
                         f"{config.n_text_layer} layers, d={config.n_audio_state}")
            return params, notes
        from whisperjav_tpu_torch.models.whisper.convert import (
            params_from_hf_state_dict,
        )
        config = _infer_whisper_config(sd)
        notes.append(f"inferred arch {config.name}")
        return params_from_hf_state_dict(sd, config), notes
    if family == "qwen":
        from whisperjav_tpu_torch.models.qwen.convert import load_pretrained
        config, params = load_pretrained(str(path))
        notes.append(f"qwen cfg: {config}")
        return params, notes
    if family == "silero":
        from whisperjav_tpu_torch.models.vad.silero import (
            params_from_torch_state_dict,
        )
        return params_from_torch_state_dict(sd), notes
    if family == "whisperseg":
        from whisperjav_tpu_torch.models.vad.whisperseg import (
            SEG_CONFIG, params_from_hf_state_dict,
        )
        config = _infer_whisper_config(sd)
        if (config.n_audio_state, config.n_audio_layer) == (
                SEG_CONFIG.n_audio_state, SEG_CONFIG.n_audio_layer):
            config = SEG_CONFIG
        else:
            notes.append(f"non-default trunk: {config.name}")
        return params_from_hf_state_dict(sd, config), notes
    if family == "ten":
        from whisperjav_tpu_torch.models.vad.ten import params_from_onnx
        return params_from_onnx(str(path)), notes
    if family == "zipenhancer":
        from whisperjav_tpu_torch.models.enhancement import zipenhancer as z
        model = (z.params_from_onnx(str(path))
                 if path.suffix.lower() == ".onnx"
                 else z.params_from_vendor(sd))
        return z.tree_from_state_dict(model.state_dict(), model.cfg), notes
    if family == "frcrn":
        from whisperjav_tpu_torch.models.enhancement.frcrn import (
            params_from_torch_state_dict, tree_from_module,
        )
        model, cfg = params_from_torch_state_dict(sd)
        notes.append(f"inferred cfg: {cfg}")
        return tree_from_module(model), notes
    if family == "mossformer2":
        from whisperjav_tpu_torch.models.enhancement.mossformer2 import (
            params_from_torch_state_dict, tree_from_module,
        )
        model, cfg = params_from_torch_state_dict(sd)
        notes.append(f"inferred cfg: {cfg}")
        return tree_from_module(model), notes
    if family == "bs_roformer":
        from whisperjav_tpu_torch.models.enhancement.bs_roformer import (
            config_from_state_dict, params_from_torch_state_dict,
            tree_from_module,
        )
        # the port's modules need the widths: inferred from the tensors
        cfg = config_from_state_dict(sd)
        notes.append(f"inferred cfg: {cfg}")
        return tree_from_module(params_from_torch_state_dict(sd, cfg)), \
            notes
    raise ValueError(f"unknown family {family!r}")


def _infer_whisper_config(sd):
    """Build a WhisperConfig from state-dict shapes alone.

    Prefers the matching named size (so alignment-head tables apply);
    falls back to a bespoke config so fine-tuned/resized trunks still
    convert and audit instead of raising.
    """
    from whisperjav_tpu_torch.models.whisper.config import (
        WHISPER_SIZES, WhisperConfig,
    )
    keys = {k[len("model."):] if k.startswith("model.") else k: v
            for k, v in sd.items()}

    def shape(name):
        return tuple(np.asarray(keys[name]).shape)

    def n_layers(side):
        return 1 + max(int(k.split(".")[2]) for k in keys
                       if k.startswith(f"{side}.layers."))

    d, n_mels, _ = shape("encoder.conv1.weight")
    n_enc, n_dec = n_layers("encoder"), n_layers("decoder")
    n_vocab, _ = shape("decoder.embed_tokens.weight")
    n_text_ctx = shape("decoder.embed_positions.weight")[0]
    n_audio_ctx = shape("encoder.embed_positions.weight")[0]
    for c in WHISPER_SIZES.values():
        if (c.n_audio_state, c.n_audio_layer, c.n_text_layer,
                c.n_vocab) == (d, n_enc, n_dec, n_vocab):
            return c
    heads = next((c.n_audio_head for c in WHISPER_SIZES.values()
                  if c.n_audio_state == d), max(1, d // 64))
    return WhisperConfig(
        name=f"custom-d{d}-e{n_enc}-d{n_dec}", n_mels=n_mels,
        n_audio_ctx=n_audio_ctx, n_audio_state=d, n_audio_head=heads,
        n_audio_layer=n_enc, n_vocab=n_vocab, n_text_ctx=n_text_ctx,
        n_text_state=d, n_text_head=heads, n_text_layer=n_dec)


# ---------------------------------------------------------------- audit

def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict/list/tuple tree, dict keys sorted (the
    order ``jax.tree.leaves`` gives the JAX package's trees)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def _audit_tree(tree: Any, report: Report) -> None:
    leaves = tree_leaves(tree)
    report.n_leaves = len(leaves)
    n_nan = n_zero = 0
    for leaf in leaves:
        if hasattr(leaf, "detach"):
            leaf = leaf.detach().cpu().float().numpy()
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f":
            if not np.isfinite(arr).all():
                n_nan += 1
            elif arr.size > 8 and float(np.abs(arr).max()) == 0.0:
                n_zero += 1
    if n_nan:
        report.errors.append(f"{n_nan} leaves contain NaN/Inf")
    if n_zero:
        report.warnings.append(
            f"{n_zero} non-trivial leaves are all-zero (zeroed biases are "
            "normal; zeroed weights are not)")


def smoke_input(family: str) -> Optional[np.ndarray]:
    """The forward smoke's seeded input for a small model family (the JAX
    tool's draws), None for the others."""
    rng = np.random.default_rng(0)
    if family == "silero":
        return rng.standard_normal((1, 1536)).astype(np.float32)
    if family == "ten":
        return rng.standard_normal((1, 4096)).astype(np.float32)
    if family == "zipenhancer":
        return (rng.standard_normal((1, 1600)) * 0.1).astype(np.float32)
    return None          # heavier families: structure/value audit only


def forward_outputs(family: str, params: Any, device="cuda",
                    audio: Optional[np.ndarray] = None
                    ) -> Optional[np.ndarray]:
    """The forward smoke's output for the small model families (None for
    the others): the family's module built from the converted tree on
    ``device``, run on ``audio`` (default: :func:`smoke_input`)."""
    import torch
    if audio is None:
        audio = smoke_input(family)
    if audio is None:
        return None
    x = torch.from_numpy(np.asarray(audio, np.float32)).to(device)
    with torch.inference_mode():
        if family == "silero":
            from whisperjav_tpu_torch.models.vad import silero
            return silero.probs(silero.params_from_jax(params, device),
                                x).cpu().numpy()
        if family == "ten":
            from whisperjav_tpu_torch.models.vad import ten
            return ten.probs(ten.params_from_jax(params, device),
                             x).cpu().numpy()
        from whisperjav_tpu_torch.models.enhancement import zipenhancer as z
        return z.denoise(z.params_from_jax(params, device=device), x,
                         x.shape[-1]).cpu().numpy()


def _forward_smoke(family: str, params: Any,
                   device="cuda") -> Optional[str]:
    """Tiny forward drive for the small model families."""
    out = forward_outputs(family, params, device)
    if out is None:
        return None
    assert np.isfinite(out).all() and out.shape[0] == 1
    if family == "zipenhancer":
        assert out.shape[-1] == 1600
        return f"ok audio{out.shape}"
    return f"ok probs{out.shape}"


# ---------------------------------------------------------------- verify

def verify(path: str, family: Optional[str] = None,
           forward: bool = False, device="cuda") -> Report:
    p = Path(path)
    report = Report(path=str(p))
    if not p.exists():
        report.errors.append("path does not exist")
        return report

    sd: Optional[Dict[str, Any]] = None
    try:
        if p.is_dir():
            report.fmt = "hf-dir"
            family = family or detect_family_from_dir(p)
        elif p.suffix.lower() == ".onnx":
            report.fmt = "onnx"
            family = family or _onnx_family(p)
        else:
            sd, report.fmt = _load_state_dict(p)
            report.n_source_keys = len(sd)
            family = family or detect_family_from_keys(list(sd))
    except Exception as e:
        report.errors.append(f"load failed: {e}")
        return report

    candidates = [family] if family else list(FAMILIES)
    last_err = None
    for cand in candidates:
        if cand in ("ten",) and report.fmt != "onnx":
            continue
        try:
            params, notes = _convert(cand, sd, p)
            report.family = cand
            report.notes.extend(notes)
            _audit_tree(params, report)
            if forward:
                try:
                    report.forward = _forward_smoke(cand, params, device)
                except Exception as e:
                    report.errors.append(f"forward smoke failed: {e}")
            report.ok = not report.errors
            return report
        except Exception as e:              # try the next family
            last_err = f"{cand}: {type(e).__name__}: {e}"
    report.errors.append(
        f"no converter accepted this checkpoint (last: {last_err})")
    return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="whisperjav-torch-verify-checkpoint",
        description="Detect, convert, and audit a local model checkpoint.")
    ap.add_argument("path", help="checkpoint file or HF model directory")
    ap.add_argument("--family", choices=FAMILIES, default=None,
                    help="skip detection, use this family's converter")
    ap.add_argument("--forward", action="store_true",
                    help="also run a tiny forward smoke (small families)")
    ap.add_argument("--json", action="store_true",
                    help="print the report as one JSON line")
    ap.add_argument("--device", default="cuda",
                    help="device of the forward smoke (default cuda; a "
                         "missing card is an error)")
    args = ap.parse_args(argv)

    if args.forward:
        from whisperjav_tpu_torch.pipelines.engine import resolve_device
        resolve_device(args.device)
    report = verify(args.path, family=args.family, forward=args.forward,
                    device=args.device)
    if args.json:
        print(json.dumps(report.to_dict()))
    else:
        status = "PASS" if report.ok else "FAIL"
        print(f"[{status}] {report.path}")
        print(f"  family: {report.family or 'UNDETECTED'}  "
              f"format: {report.fmt}  source keys: {report.n_source_keys}  "
              f"converted leaves: {report.n_leaves}")
        for n in report.notes:
            print(f"  note: {n}")
        for w in report.warnings:
            print(f"  warn: {w}")
        for e in report.errors:
            print(f"  ERROR: {e}")
        if report.forward:
            print(f"  forward: {report.forward}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
