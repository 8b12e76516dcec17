"""Translation provider registry (the port's copy of
``whisperjav_tpu/translate/providers.py``: the same names and limits).

Role parity with reference ``whisperjav/translate/providers.py`` —
provider configs for deepseek/openrouter/gemini/claude/gpt/glm/groq/
ollama/local/custom. Each provider describes an OpenAI-compatible (or
native) chat endpoint plus context-window limits used to cap batch sizes
(reference: translate/core.py:7-30). All remote providers require
network access and an API key at call time; the ``identity`` provider is
an offline no-op for plumbing tests.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass(frozen=True)
class ProviderConfig:
    name: str
    api_style: str              # openai | gemini | anthropic | ollama | none
    base_url: Optional[str] = None
    default_model: str = ""
    context_window: int = 32_768
    api_key_env: str = ""
    supports_resume: bool = True


PROVIDERS: Dict[str, ProviderConfig] = {
    "deepseek": ProviderConfig("deepseek", "openai",
                               "https://api.deepseek.com/v1",
                               "deepseek-chat", 65_536, "DEEPSEEK_API_KEY"),
    "openrouter": ProviderConfig("openrouter", "openai",
                                 "https://openrouter.ai/api/v1",
                                 "deepseek/deepseek-chat", 65_536,
                                 "OPENROUTER_API_KEY"),
    "gpt": ProviderConfig("gpt", "openai", "https://api.openai.com/v1",
                          "gpt-4o-mini", 128_000, "OPENAI_API_KEY"),
    "claude": ProviderConfig("claude", "anthropic", None,
                             "claude-3-5-haiku-latest", 200_000,
                             "ANTHROPIC_API_KEY"),
    "gemini": ProviderConfig("gemini", "gemini", None,
                             "gemini-2.0-flash", 1_000_000,
                             "GEMINI_API_KEY"),
    "glm": ProviderConfig("glm", "openai",
                          "https://open.bigmodel.cn/api/paas/v4",
                          "glm-4-flash", 128_000, "GLM_API_KEY"),
    "groq": ProviderConfig("groq", "openai",
                           "https://api.groq.com/openai/v1",
                           "llama-3.3-70b-versatile", 32_768,
                           "GROQ_API_KEY"),
    "ollama": ProviderConfig("ollama", "ollama", "http://localhost:11434",
                             "qwen2.5:7b", 32_768, ""),
    "local": ProviderConfig("local", "openai", "http://localhost:8080/v1",
                            "local", 8_192, ""),
    # the local LM on the card (a local Qwen3 or DeepSeek-V3-block
    # instruct checkpoint, translate/local_backend.py); the name is the
    # JAX CLI's
    "tpu-local": ProviderConfig("tpu-local", "tpu-local", None,
                                "", 32_768, ""),
    "custom": ProviderConfig("custom", "openai", None, "", 32_768,
                             "CUSTOM_API_KEY"),
    # offline no-op provider: returns source text untranslated
    "identity": ProviderConfig("identity", "none", None, "", 10 ** 9, ""),
}


def resolve_provider(name: str,
                     base_url: Optional[str] = None,
                     model: Optional[str] = None) -> ProviderConfig:
    if name not in PROVIDERS:
        raise ValueError(f"unknown provider {name!r}; "
                         f"choose from {sorted(PROVIDERS)}")
    cfg = PROVIDERS[name]
    if base_url or model:
        from dataclasses import replace
        cfg = replace(cfg, base_url=base_url or cfg.base_url,
                      default_model=model or cfg.default_model)
    return cfg


def get_api_key(cfg: ProviderConfig) -> Optional[str]:
    return os.environ.get(cfg.api_key_env) if cfg.api_key_env else None


def max_batch_lines(cfg: ProviderConfig, avg_line_chars: int = 40,
                    target_fraction: float = 0.25, cap: int = 30) -> int:
    """Cap translation batch size to a fraction of the context window
    (reference: translate/core.py:7-30). ~1.5 tokens per CJK char, both
    directions plus instructions. ``cap`` mirrors the reference's
    max_batch_size default of 30 (translate/settings.py) — huge-context
    providers still get bounded batches so one bad response can't lose
    hundreds of lines."""
    budget_tokens = cfg.context_window * target_fraction
    per_line = avg_line_chars * 1.5 * 2 + 10
    return min(cap, max(8, int(budget_tokens / per_line)))
