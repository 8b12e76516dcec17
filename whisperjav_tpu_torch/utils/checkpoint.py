"""Checkpoints of fine-tuned parameters.

Counterpart of ``whisperjav_tpu/utils/checkpoint.py`` in the format that
module falls back to without orbax, which the port always writes: a
directory with ``params.npz`` (each leaf keyed by its tree path joined
with "/", e.g. ``encoder/blocks/wq``: the layout of ``pytree_npz``) and
``metadata.json`` (``saved``,
``backend: "npz"`` and the caller's metadata). The JAX package's
``load_checkpoint`` reads the port's checkpoints, and the port reads the
JAX package's npz ones; an orbax checkpoint raises here.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from whisperjav_tpu_torch.utils.logger import logger
from whisperjav_tpu_torch.utils.pytree_npz import load_pytree, save_pytree


def save_checkpoint(path: Path, params: Dict,
                    metadata: Optional[Dict] = None) -> Path:
    """Write a nested dict of host arrays and metadata."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    save_pytree(str(path / "params.npz"), params)
    meta = {"saved": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "backend": "npz", **(metadata or {})}
    (path / "metadata.json").write_text(json.dumps(meta, indent=1),
                                        encoding="utf-8")
    logger.info("checkpoint saved: %s (npz)", path)
    return path


def load_checkpoint(path: Path, template: Optional[Any] = None) -> Dict:
    """The parameter tree of a checkpoint directory, numpy leaves.

    With a ``template`` (a nested dict of the same keys) every leaf of the
    template must be in the file with its shape, and the tree returned
    has exactly the template's keys; without one, the tree is rebuilt
    from the file's keys."""
    path = Path(path)
    meta = checkpoint_metadata(path)
    if meta.get("backend") != "npz":
        raise ValueError(f"{path}: a {meta.get('backend')!r} checkpoint; "
                         "the port reads only the npz format (the JAX "
                         "package writes it where orbax is missing)")
    tree, _ = load_pytree(str(path / "params.npz"))
    if template is None:
        return tree
    return _like(template, tree, "")


def _like(template: Dict, tree: Dict, prefix: str) -> Dict:
    out = {}
    for key, want in template.items():
        name = f"{prefix}{key}"
        if key not in tree:
            raise KeyError(f"checkpoint has no leaf {name!r}")
        if isinstance(want, dict):
            out[key] = _like(want, tree[key], f"{name}/")
            continue
        got = tree[key]
        if tuple(np.shape(got)) != tuple(np.shape(want)):
            raise ValueError(f"checkpoint leaf {name!r} has shape "
                             f"{np.shape(got)}, the template "
                             f"{tuple(np.shape(want))}")
        out[key] = got
    return out


def checkpoint_metadata(path: Path) -> Dict:
    return json.loads((Path(path) / "metadata.json").read_text(
        encoding="utf-8"))
