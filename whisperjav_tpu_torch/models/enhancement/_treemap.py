"""Vendor state dict <-> the JAX package's parameter tree, from one table.

A model lists its tensors once, as entries ``(name, path, index, form)``:
the state-dict ``name``; the tree ``path`` of the leaf (dict keys and
list indices); ``index``, the position of this tensor along the leaf's
leading axis where the JAX package stacks layers for ``lax.scan`` (None
for a leaf of its own); and ``form``, how the tensor's layout becomes the
leaf's (each form has its inverse). Both directions read the same table,
so they cannot drift apart.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Entry = Tuple[str, Sequence[Any], Optional[int], str]

# form -> (state-dict tensor -> tree leaf, tree leaf -> state-dict tensor)
FORMS = {
    "id": (lambda a: a, lambda a: a),
    # torch Linear (out, in) <-> matrix (in, out)
    "T": (lambda a: a.T, lambda a: a.T),
    # Conv1d kernel 1 (out, in, 1) <-> matrix (in, out)
    "c1x1": (lambda a: a[:, :, 0].T, lambda a: a.T[:, :, None]),
    # one-element parameter (1,) <-> scalar ()
    "scalar": (lambda a: a.reshape(()), lambda a: a.reshape(1)),
    # depthwise Conv1d (C, 1, K) <-> (C, K)
    "dw": (lambda a: a[:, 0, :], lambda a: a[:, None, :]),
    # depthwise Conv2d over one axis (C, 1, K, 1) <-> (C, K)
    "dw2": (lambda a: a[:, 0, :, 0], lambda a: a[:, None, :, None]),
}


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def listify(node):
    """Nested dicts whose keys are all integers (or digit strings) ->
    lists, recursively."""
    if isinstance(node, dict):
        if node and all(isinstance(k, int) or str(k).isdigit()
                        for k in node):
            return [listify(node[k]) for k in sorted(node, key=int)]
        return {k: listify(v) for k, v in node.items()}
    if isinstance(node, list):
        return [listify(v) for v in node]
    return node


def tree_from_state_dict(sd: Mapping[str, Any],
                         entries: Iterable[Entry]) -> Dict:
    """The JAX package's tree (numpy f32 leaves) from a state dict."""
    tree: Dict = {}
    stacks: Dict[Tuple, Dict[int, np.ndarray]] = {}
    for name, path, index, form in entries:
        if name not in sd:
            raise KeyError(f"missing tensor {name!r}")
        leaf = FORMS[form][0](_np(sd[name]))
        if index is not None:
            stacks.setdefault(tuple(path), {})[index] = leaf
            continue
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    for path, parts in stacks.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.stack([parts[i] for i in range(len(parts))])
    return listify(tree)


def state_dict_from_tree(tree, entries: Iterable[Entry]
                         ) -> Dict[str, np.ndarray]:
    """A state dict (numpy f32) from the JAX package's tree (array or
    numpy leaves); the inverse of :func:`tree_from_state_dict`."""
    sd = {}
    for name, path, index, form in entries:
        leaf = _np(_get(tree, path))
        if index is not None:
            leaf = leaf[index]
        sd[name] = np.ascontiguousarray(FORMS[form][1](leaf))
    return sd


def load_module(model: torch.nn.Module, sd: Mapping[str, Any]
                ) -> torch.nn.Module:
    """Load the tensors ``model`` holds from ``sd`` (f32, copied to the
    model's device); names the model does not hold are ignored, as the
    JAX converters ignore them, and a missing one raises."""
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"missing tensors {missing[:4]} "
                       f"({len(missing)} in all)")
    model.load_state_dict({k: torch.from_numpy(np.array(_np(sd[k])))
                           for k in own})
    return model
