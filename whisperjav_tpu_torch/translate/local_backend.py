"""The local translation backend: a Qwen3 LM on the card (``tpu-local``).

The port's counterpart of ``whisperjav_tpu/translate/local_backend.py``
(reference: whisperjav/translate/local_backend.py, a llama.cpp server
running GGUF models). The LM runs in this process through the port's
Qwen3 implementation (``models/qwen/model.py:generate_text``), f32 with
fused q/k/v, on ``device``. A local Qwen3-family instruct checkpoint
(e.g. Qwen3-1.7B/4B-Instruct) loads through ``convert.load_lm``, which
needs ``transformers``; ``params`` injects a tree instead. The provider
keeps the JAX CLI's name, ``tpu-local``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from whisperjav_tpu_torch.utils.logger import logger

_CHAT_PREFIX = "<|im_start|>user\n"
_CHAT_SUFFIX = "<|im_end|>\n<|im_start|>assistant\n"


def cap_batch_size_for_context(max_batch_size: int, n_ctx: int) -> int:
    """Cap subtitle lines per prompt to the LM context window (reference:
    translate/core.py:7-60 — ~500 tokens/line worst case + ~2500 fixed
    overhead for instructions/protocol/retry margin)."""
    overhead, per_line = 2500, 500
    usable = max(n_ctx - overhead, per_line)
    return max(1, min(max_batch_size, usable // per_line))


class LocalLMBackend:
    """Callable translation backend: prompt string → response string.

    Plugs into ``translate_srt(call_fn=...)``: the service keeps its
    numbered-line protocol, batching and resume; this class owns the
    chat template, the tokenizer and generation on ``device``. ``params``
    is a :class:`QwenASR` (moved to ``device``) or a JAX-layout tree
    (``cfg`` then names its config); without it ``checkpoint`` is read
    with ``convert.load_lm`` and then moved. ``prompt_bucket`` is kept for
    the JAX backend's signature: the port prefills the real prompt only.
    """

    def __init__(self, checkpoint: Optional[str] = None,
                 params=None, cfg=None, tokenizer=None,
                 max_new_tokens: int = 2048,
                 temperature: float = 0.0,
                 repetition_penalty: float = 1.05,
                 prompt_bucket: int = 256,
                 device="cuda"):
        from whisperjav_tpu_torch.models.qwen.model import (
            QwenASR, fuse_lm_qkv,
        )
        from whisperjav_tpu_torch.models.qwen.weights import params_from_jax
        self.device = torch.device(device)
        if params is None:
            if checkpoint is None:
                raise ValueError(
                    "the tpu-local backend needs a local checkpoint "
                    "directory (--translate-model <dir>) or injected params")
            from whisperjav_tpu_torch.models.qwen.convert import load_lm
            cfg, params = load_lm(checkpoint)
            logger.info("tpu-local translation: loaded %s (%d layers, "
                        "d=%d) on %s", cfg.name, cfg.n_layers, cfg.d_model,
                        self.device)
        if not isinstance(params, QwenASR):
            params = params_from_jax(params, cfg)
        self.model = params.to(self.device)
        if os.environ.get("WJAV_FUSE_QKV", "1") != "0":
            self.model = fuse_lm_qkv(self.model)
        self.cfg = self.model.config
        if tokenizer is None and checkpoint is not None:
            from whisperjav_tpu_torch.models.qwen.tokenizer import (
                QwenTokenizer, find_tokenizer_files,
            )
            src = find_tokenizer_files(checkpoint)
            tokenizer = QwenTokenizer(src) if src else None
        self.tokenizer = tokenizer
        if self.tokenizer is None:
            raise ValueError("the tpu-local backend needs a tokenizer "
                             "(tokenizer.json next to the weights)")
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.repetition_penalty = repetition_penalty
        self.prompt_bucket = prompt_bucket
        self.generator = None
        if temperature != 0.0:      # the JAX backend's key is 0 too
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(0)

    @property
    def context_window(self) -> int:
        return 32_768   # Qwen3 instruct native window

    def _encode_chat(self, prompt: str) -> list:
        """Wrap in the Qwen chat template (im_start/im_end markers are
        ordinary vocabulary strings for the BPE, so plain encode handles
        them)."""
        return self.tokenizer.encode(_CHAT_PREFIX + prompt + _CHAT_SUFFIX)

    def __call__(self, prompt: str) -> str:
        from whisperjav_tpu_torch.models.qwen.model import generate_text
        ids = self._encode_chat(prompt)
        res = generate_text(
            self.model, torch.tensor([ids], device=self.device),
            torch.tensor([len(ids)]), max_new=self.max_new_tokens,
            repetition_penalty=self.repetition_penalty,
            temperature=self.temperature, generator=self.generator)
        toks = res.tokens[0].cpu().numpy()
        length = int(res.length[0])
        return self.tokenizer.decode([int(t) for t in toks[:length]])
