"""Generic nested-pytree ↔ .npz round-trip for model checkpoints.

The port's copy of ``whisperjav_tpu/utils/pytree_npz.py``, the same
layout, so a file either package writes loads in the other. Flattens
dict/list trees of arrays into path-keyed npz entries (``a/0/w``) and
rebuilds the exact structure on load (a level whose keys are all
integers becomes a list). Used by model families whose param trees mix
dicts and per-band/per-stem lists (BS-RoFormer, FRCRN, MossFormer2) so
every model gets the same offline checkpoint format.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

_SEP = "/"
_META = "__meta__"


def _flatten(node: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(node, dict):
        for k, v in node.items():
            if _SEP in str(k):
                raise ValueError(f"key {k!r} contains {_SEP!r}")
            _flatten(v, f"{prefix}{k}{_SEP}", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, f"{prefix}{i}{_SEP}", out)
    elif node is None:
        pass
    else:
        out[prefix[:-1]] = np.asarray(node)


def save_pytree(path: str, tree: Any, meta: Dict | None = None) -> None:
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    if meta is not None:
        flat[_META] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), np.uint8)
    np.savez(path, **flat)


def load_pytree(path: str):
    """Returns (tree, meta) — meta is None when absent."""
    data = np.load(path)
    meta = None
    nested: Dict[str, Any] = {}
    for key in data.files:
        if key == _META:
            meta = json.loads(bytes(data[key].tobytes()).decode("utf-8"))
            continue
        node = nested
        parts = key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [rebuild(node[str(i)]) for i in range(len(keys))]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(nested), meta
