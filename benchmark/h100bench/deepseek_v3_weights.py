"""DeepSeek-V3-block weights (Kanana-2-30B-A3B's) drawn from ``--seed`` on
the device, a layer at a time.

The benchmark's own draw, so that what decides ``correct`` does not move
with the port's loader. Each part, the embedding, final norm and head
(``top``) or one layer, comes from a generator of its own, seeded from
(seed, part): the program places the model a layer at a time as it is
drawn, and the reference draws one layer again alone, the same numbers
on the same device. Matrices N(0, 1/d) of their input width d, the
token embedding N(0, 1/d_model), the router N(0, 1/d_model); every norm
scale 1 + 0.1 N(0, 1) and the correction bias 0.1 N(0, 1), so that a
norm dropped or a bias dropped from the choice, or added to the weights,
changes the result. Leaves are (in, out), under the names the port's
``models/deepseek_v3/model.py:place`` reads, experts stacked first; each
is one ``randn`` call, in the order :func:`shapes` lists them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

SCALE = 0.1
BIAS = 0.1


def _attn_shapes(m: dict) -> Dict[str, tuple]:
    d, H = m["d_model"], m["n_heads"]
    r, dr = m["kv_lora_rank"], m["qk_rope_dim"]
    return {"ln1": (d,), "wq": (d, H * (m["qk_nope_dim"] + dr)),
            "wkva": (d, r + dr), "kv_norm": (r,),
            "wkvb": (r, H * (m["qk_nope_dim"] + m["v_head_dim"])),
            "wo": (H * m["v_head_dim"], d), "ln2": (d,)}


def shapes(m: dict, part) -> Dict[str, tuple]:
    """The leaves of ``part`` ("top" or a layer index), in drawing order."""
    d = m["d_model"]
    if part == "top":
        return {"tok_emb": (m["vocab_size"], d), "ln_f": (d,),
                "lm_head": (d, m["vocab_size"])}
    out = _attn_shapes(m)
    if part < m["first_dense"]:
        ff = m["d_ff"]
        out.update(w_gate=(d, ff), w_up=(d, ff), w_down=(ff, d))
        return out
    E, f = m["n_routed_experts"], m["moe_d_ff"]
    fs = m["n_shared_experts"] * f
    out.update(router=(d, E), bias=(E,), w_gate=(E, d, f), w_up=(E, d, f),
               w_down=(E, f, d), shared_gate=(d, fs), shared_up=(d, fs),
               shared_down=(fs, d))
    return out


# the top part's tag beside the layers' indices
TOP = 1 << 20


def _seed(seed: int, part) -> int:
    tag = TOP if part == "top" else int(part)
    state = np.random.SeedSequence([int(seed), tag]).generate_state(
        1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


def draw(m: dict, seed: int, part, device, dtype=torch.float32) -> Dict:
    """The leaves of ``part`` of the model ``m`` (a configuration file's
    ``model`` sizes) from ``seed`` on ``device``, in ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, part))
    out = {}
    for name, shape in shapes(m, part).items():
        x = torch.randn(shape, generator=gen, device=device)
        if name in ("ln1", "ln2", "kv_norm", "ln_f"):
            x.mul_(SCALE).add_(1.0)
        elif name == "bias":
            x.mul_(BIAS)
        elif name == "tok_emb":
            x.mul_(shape[-1] ** -0.5)
        else:
            x.mul_(shape[-2] ** -0.5)
        out[name] = x.to(dtype)
    return out


class Source:
    """The model of ``m`` from ``seed`` as the port's ``place`` reads it:
    ``top()`` and ``layer(i)``, each drawn when asked for."""

    def __init__(self, m: dict, seed: int, device, dtype=torch.float32):
        self.m, self.seed, self.device, self.dtype = m, seed, device, dtype

    def top(self) -> Dict:
        return draw(self.m, self.seed, "top", self.device, self.dtype)

    def layer(self, i: int) -> Dict:
        return draw(self.m, self.seed, i, self.device, self.dtype)
