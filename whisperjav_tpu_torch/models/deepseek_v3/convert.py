"""Checkpoint reading for the DeepSeek-V3 block: a Hugging Face
``deepseek_v3`` checkpoint (``config.json`` and ``*.safetensors``) as a
layer source for ``model.place``.

Nothing is read whole: :class:`StateDictLayers` takes one layer's
tensors from a state dict when ``place`` asks for that layer, and
:func:`load` reads them lazily from the checkpoint's safetensors files
(the ``safetensors`` package), so a 30B model in bf16 never lies in host
memory whole, nor in f32 anywhere. Torch ``Linear.weight`` is (out, in)
and becomes (in, out); the routed experts of a layer stack first. The
state dict's names (``model.layers.<i>.``):

- ``input_layernorm``, ``post_attention_layernorm``;
- ``self_attn.q_proj``, ``self_attn.kv_a_proj_with_mqa``,
  ``self_attn.kv_a_layernorm``, ``self_attn.kv_b_proj``,
  ``self_attn.o_proj``;
- a dense layer's ``mlp.gate_proj``, ``mlp.up_proj``, ``mlp.down_proj``;
- an expert layer's ``mlp.gate.weight`` (the router),
  ``mlp.gate.e_score_correction_bias``, ``mlp.experts.<e>.{gate,up,
  down}_proj`` and ``mlp.shared_experts.{gate,up,down}_proj``;

and ``model.embed_tokens``, ``model.norm``, ``lm_head``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping

import torch

from whisperjav_tpu_torch.models.deepseek_v3.model import (
    DSV3_SIZES, DeepseekV3Config,
)

# what the block implements, as config.json states it
_REQUIRED = {"q_lora_rank": None, "n_group": 1, "topk_group": 1,
             "scoring_func": "sigmoid", "topk_method": "noaux_tc",
             "rope_scaling": None, "rope_interleave": True,
             "norm_topk_prob": True, "hidden_act": "silu",
             "moe_layer_freq": 1, "tie_word_embeddings": False}


def config_from_hf(c: Mapping, name: str = "hf") -> DeepseekV3Config:
    """Our config from a ``deepseek_v3`` config.json (a dict). The
    special ids, where the file gives none, are Kanana-2's assumed
    ones (``DSV3_SIZES``). Raises ValueError for what the block does not
    implement (q LoRA, grouped routing, softmax scores, rope scaling)."""
    for key, want in _REQUIRED.items():
        if c.get(key, want) != want:
            raise ValueError(f"deepseek_v3 config: {key}={c[key]!r}; the "
                             f"port's DeepSeek-V3 block implements "
                             f"{key}={want!r}")
    kanana = DSV3_SIZES["kanana-2-30b-a3b"]

    def special(key, default):
        v = c.get(key)
        return int(v[0] if isinstance(v, list) else v) if v is not None \
            else default
    return DeepseekV3Config(
        name=name, vocab_size=c["vocab_size"], d_model=c["hidden_size"],
        n_layers=c["num_hidden_layers"], n_heads=c["num_attention_heads"],
        qk_nope_dim=c["qk_nope_head_dim"], qk_rope_dim=c["qk_rope_head_dim"],
        v_head_dim=c["v_head_dim"], kv_lora_rank=c["kv_lora_rank"],
        d_ff=c["intermediate_size"], moe_d_ff=c["moe_intermediate_size"],
        n_routed_experts=c["n_routed_experts"],
        n_shared_experts=c["n_shared_experts"],
        experts_per_token=c["num_experts_per_tok"],
        first_dense=c["first_k_dense_replace"],
        routed_scale=float(c["routed_scaling_factor"]),
        rope_theta=float(c["rope_theta"]), rms_eps=float(c["rms_norm_eps"]),
        eos_id=special("eos_token_id", kanana.eos_id),
        bos_id=special("bos_token_id", kanana.bos_id))


class StateDictLayers:
    """A state dict (HF names, any dtype, on the host) as ``place`` reads
    it: ``top()`` and ``layer(i)``, (in, out) matrices in the stored
    type, the other leaves in ``dtype``."""

    def __init__(self, sd: Mapping[str, torch.Tensor], cfg: DeepseekV3Config,
                 dtype=torch.float32):
        self.sd, self.cfg, self.dtype = sd, cfg, dtype

    def _vec(self, name: str) -> torch.Tensor:
        return self.sd[name].to(self.dtype)

    def _mat(self, name: str) -> torch.Tensor:
        return self.sd[name].t()

    def top(self) -> Dict[str, torch.Tensor]:
        head = ("lm_head.weight" if "lm_head.weight" in self.sd
                else "model.embed_tokens.weight")
        return {"tok_emb": self._vec("model.embed_tokens.weight"),
                "ln_f": self._vec("model.norm.weight"),
                "lm_head": self._mat(head)}

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        p = f"model.layers.{i}."
        a = p + "self_attn."
        out = {"ln1": self._vec(p + "input_layernorm.weight"),
               "wq": self._mat(a + "q_proj.weight"),
               "wkva": self._mat(a + "kv_a_proj_with_mqa.weight"),
               "kv_norm": self._vec(a + "kv_a_layernorm.weight"),
               "wkvb": self._mat(a + "kv_b_proj.weight"),
               "wo": self._mat(a + "o_proj.weight"),
               "ln2": self._vec(p + "post_attention_layernorm.weight")}
        m = p + "mlp."
        if i < self.cfg.first_dense:
            out.update({f"w_{n}": self._mat(f"{m}{n}_proj.weight")
                        for n in ("gate", "up", "down")})
            return out
        out["router"] = self._mat(m + "gate.weight").to(self.dtype)
        out["bias"] = self._vec(m + "gate.e_score_correction_bias")
        for n in ("gate", "up", "down"):
            out[f"w_{n}"] = torch.stack([
                self._mat(f"{m}experts.{e}.{n}_proj.weight")
                for e in range(self.cfg.n_routed_experts)])
            out[f"shared_{n}"] = self._mat(
                f"{m}shared_experts.{n}_proj.weight")
        return out


class _Safetensors(Mapping):
    """A checkpoint directory's tensors by name, each read from its
    safetensors file when asked for."""

    def __init__(self, path: Path):
        from safetensors import safe_open
        index = path / "model.safetensors.index.json"
        if index.exists():
            files = json.loads(index.read_text())["weight_map"]
        else:
            single = path / "model.safetensors"
            with safe_open(str(single), framework="pt") as f:
                files = {k: single.name for k in f.keys()}
        self.files = {k: path / v for k, v in files.items()}
        self.open = {f: safe_open(str(f), framework="pt")
                     for f in set(self.files.values())}

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.open[self.files[name]].get_tensor(name)

    def __iter__(self):
        return iter(self.files)

    def __len__(self) -> int:
        return len(self.files)


def load(path, dtype=torch.float32):
    """(config, layer source) of a ``deepseek_v3`` checkpoint directory,
    its tensors read lazily. Raises ImportError where the safetensors
    package is not installed."""
    path = Path(path)
    c = json.loads((path / "config.json").read_text())
    cfg = config_from_hf(c, name=path.name or "hf")
    try:
        sd = _Safetensors(path)
    except ImportError as e:
        raise ImportError(f"reading the deepseek_v3 checkpoint {path} needs "
                          "the safetensors package, which is not "
                          "installed") from e
    return cfg, StateDictLayers(sd, cfg, dtype)
