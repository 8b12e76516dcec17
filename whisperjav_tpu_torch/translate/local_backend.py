"""The local translation backend: an instruct LM on the card (``tpu-local``).

The port's counterpart of ``whisperjav_tpu/translate/local_backend.py``
(reference: whisperjav/translate/local_backend.py, a llama.cpp server
running GGUF models). The LM runs in this process, on ``device``, in one
of two families, which a checkpoint's ``model_type`` picks
(``models/qwen/convert.py:load_lm``):

- the Qwen3 block (``models/qwen/model.py:generate_text``), f32 with
  fused q/k/v: a Qwen3-family instruct checkpoint (e.g.
  Qwen3-1.7B/4B-Instruct), read with ``transformers``;
- the DeepSeek-V3 block (``models/deepseek_v3/model.py:generate_text``):
  latent attention and routed and shared experts, e.g. Kanana-2-30B-A3B,
  read lazily with ``safetensors``, every matrix quantised to int8 as it
  moves to the card (``place``).

``params`` injects weights instead: a built model of either family, a
JAX-layout Qwen tree (``cfg`` then names its config), or a DeepSeek-V3
layer source with its ``DeepseekV3Config`` (``place`` reads it). Both
families' steps run the one decode loop (``models/qwen/model.py:
_decode``). ``__call__`` is the chat encoding, :meth:`generate_ids` and
the decoding; under ``WJAV_TRACE_BATCHES=1`` :meth:`generate_ids`
records ``translate.prompt`` (counters ``prompt_tokens``, ``budget``,
the new tokens allowed, and ``cues``, the numbered lines of the
prompt) over the LM's spans, closed after a sync. The provider keeps
the JAX CLI's name, ``tpu-local``.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Sequence

import torch

from whisperjav_tpu_torch.utils import tracer
from whisperjav_tpu_torch.utils.logger import logger

_CHAT_PREFIX = "<|im_start|>user\n"
_CHAT_SUFFIX = "<|im_end|>\n<|im_start|>assistant\n"


# a numbered cue line of the prompt's last block (translate/service.py)
_CUE = re.compile(r"^\d+: ", re.MULTILINE)


def count_cues(prompt: str) -> int:
    """The numbered cue lines after the prompt's last ``---``."""
    return len(_CUE.findall(prompt.rsplit("\n---\n", 1)[-1]))


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
    chat template, the tokenizer and generation on ``device``. Without
    ``params`` the ``checkpoint`` directory is read with
    ``convert.load_lm`` (see the module's note for ``params``).
    ``prompt_bucket`` is kept for the JAX backend's signature: the port
    prefills the real prompt only.
    """

    def __init__(self, checkpoint: Optional[str] = None,
                 params=None, cfg=None, tokenizer=None,
                 max_new_tokens: int = 2048,
                 temperature: float = 0.0,
                 repetition_penalty: float = 1.05,
                 prompt_bucket: int = 256,
                 device="cuda"):
        from whisperjav_tpu_torch.models.deepseek_v3 import model as dsv3
        from whisperjav_tpu_torch.models.qwen import model as qm
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
        self.qwen = not isinstance(params, dsv3.DeepseekV3) \
            and not isinstance(cfg, dsv3.DeepseekV3Config)
        if self.qwen:
            if not isinstance(params, qm.QwenASR):
                params = params_from_jax(params, cfg)
            self.model = params.to(self.device)
            if os.environ.get("WJAV_FUSE_QKV", "1") != "0":
                self.model = qm.fuse_lm_qkv(self.model)
            self._generate = qm.generate_text
        else:
            self.model = (params.to(self.device)
                          if isinstance(params, dsv3.DeepseekV3)
                          else dsv3.place(cfg, params, self.device))
            self._generate = dsv3.generate_text
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
        self.recorder: Optional[tracer.SpanRecorder] = None
        self.generator = None
        if temperature != 0.0:      # the JAX backend's key is 0 too
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(0)

    @property
    def context_window(self) -> int:
        return 32_768   # Qwen3 instruct and Kanana-2's native window

    def _encode_chat(self, prompt: str) -> list:
        """Wrap in the family's chat template. Qwen's im_start/im_end
        markers are ordinary vocabulary strings for the BPE, so plain
        encode handles them; a DeepSeek-V3-block checkpoint's tokenizer
        renders its own template, where it has one (else the prompt is
        encoded as it is)."""
        if self.qwen:
            return self.tokenizer.encode(_CHAT_PREFIX + prompt + _CHAT_SUFFIX)
        hf = getattr(self.tokenizer, "_hf", None)
        if hf is not None and getattr(hf, "chat_template", None):
            text = hf.apply_chat_template(
                [{"role": "user", "content": prompt}],
                add_generation_prompt=True, tokenize=False)
            return hf.encode(text, add_special_tokens=False)
        return self.tokenizer.encode(prompt)

    def generate_ids(self, ids: Sequence[int], cues: Optional[int] = None):
        """The LM's answer to the prompt ``ids``: greedy (or sampled at
        ``temperature``) under the repetition penalty, up to
        ``max_new_tokens``; the family's ``generate_text`` result (tokens
        (1, max_new), EOS-padded, ``length`` and ``avg_logprob``), on the
        device."""
        n = len(ids)
        under = tracer.current()
        if under is None and os.environ.get("WJAV_TRACE_BATCHES",
                                            "0") != "0":
            under = self.recorder = tracer.SpanRecorder()
        span = tracer.child(under, "translate.prompt")
        with tracer.within(span):
            res = self._generate(
                self.model, torch.tensor([list(ids)], device=self.device),
                torch.tensor([n]), max_new=self.max_new_tokens,
                repetition_penalty=self.repetition_penalty,
                temperature=self.temperature, generator=self.generator)
        if span is not None:
            counters = dict(prompt_tokens=n, budget=self.max_new_tokens)
            if cues is not None:
                counters["cues"] = cues
            span.close_synced(self.device, **counters)
        return res

    def __call__(self, prompt: str) -> str:
        ids = self._encode_chat(prompt)
        res = self.generate_ids(ids, cues=count_cues(prompt))
        toks = res.tokens[0].cpu().numpy()
        length = int(res.length[0])
        return self.tokenizer.decode([int(t) for t in toks[:length]])
