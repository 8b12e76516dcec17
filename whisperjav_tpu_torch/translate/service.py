"""Subtitle translation service with scene/batch resume.

The port's counterpart of ``whisperjav_tpu/translate/service.py``
(reference: ``whisperjav/translate/service.py`` + ``core.py``): cues are
grouped into scenes and gap-aligned batches (:mod:`.project`), each
batch goes to a provider with rolling <scene>/<summary> context in the
numbered-line protocol, and the ``.wjtrans.json`` project is saved after
every batch, so an interrupted run resumes at batch granularity. A
network provider's failed batch keeps its source text, as in the JAX
package. The on-device provider (``tpu-local``) differs on purpose: its
backend is built before the first batch, outside any guard (the weights
go to the card first), and an error from its call raises once the
project is saved, so the run stops and can resume instead of writing
untranslated text and succeeding.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Callable, Dict, Optional

from whisperjav_tpu_torch.modules.srt import Subtitle, load_srt, save_srt
from whisperjav_tpu_torch.translate.providers import (
    ProviderConfig, get_api_key, max_batch_lines, resolve_provider,
)
from whisperjav_tpu_torch.translate.instructions import get_instruction_content
from whisperjav_tpu_torch.translate.project import (
    DEFAULT_SCENE_THRESHOLD, ProjectV2, extract_summary,
)
from whisperjav_tpu_torch.utils.logger import logger

# numbered-line response protocol appended to every instruction set
_PROTOCOL = (
    "\nOutput one line per number in the exact form 'N: translation'. "
    "After the last line, you may add one line "
    "'<summary>one sentence summarizing this dialogue</summary>'.")


_LINE_RE = re.compile(r"^\s*(\d+)\s*[:：.)）]\s*(.*)$")

_LANG_TAGS = {
    "english": "en", "japanese": "ja", "chinese": "zh", "korean": "ko",
    "german": "de", "french": "fr", "spanish": "es", "portuguese": "pt",
    "italian": "it", "russian": "ru", "indonesian": "id", "thai": "th",
    "vietnamese": "vi", "arabic": "ar", "hindi": "hi", "dutch": "nl",
    "polish": "pl", "turkish": "tr",
}


def _iso_tag(language_name: str) -> str:
    """Language NAME → ISO tag for output filenames; 2-letter inputs pass
    through, unknown names fall back to their first two letters."""
    name = (language_name or "en").strip().lower()
    if len(name) == 2:
        return name
    return _LANG_TAGS.get(name, name[:2])


def parse_numbered_response(text: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    for ln in text.split("\n"):
        m = _LINE_RE.match(ln)
        if m:
            out[int(m.group(1))] = m.group(2).strip()
    return out


def _call_provider(cfg: ProviderConfig, prompt: str, model: str) -> str:
    """Dispatch one chat request. Network access + SDKs are runtime-gated;
    unavailable providers raise RuntimeError (handled per batch)."""
    if cfg.api_style == "none":      # identity provider: echo source lines
        return prompt.split("---\n", 1)[-1]
    if cfg.api_style == "openai":
        try:
            import openai
        except ImportError as e:
            raise RuntimeError(f"openai SDK not installed: {e}")
        client = openai.OpenAI(base_url=cfg.base_url,
                               api_key=get_api_key(cfg) or "none")
        resp = client.chat.completions.create(
            model=model, messages=[{"role": "user", "content": prompt}])
        return resp.choices[0].message.content or ""
    if cfg.api_style == "anthropic":
        try:
            import anthropic
        except ImportError as e:
            raise RuntimeError(f"anthropic SDK not installed: {e}")
        client = anthropic.Anthropic(api_key=get_api_key(cfg))
        resp = client.messages.create(
            model=model, max_tokens=8192,
            messages=[{"role": "user", "content": prompt}])
        return resp.content[0].text
    if cfg.api_style == "gemini":
        try:
            from google import genai
        except ImportError as e:
            raise RuntimeError(f"google-genai SDK not installed: {e}")
        client = genai.Client(api_key=get_api_key(cfg))
        resp = client.models.generate_content(model=model, contents=prompt)
        return resp.text
    if cfg.api_style == "ollama":
        import json as _json
        import urllib.request
        req = urllib.request.Request(
            f"{cfg.base_url}/api/generate",
            data=_json.dumps({"model": model, "prompt": prompt,
                              "stream": False}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return _json.loads(r.read())["response"]
    raise RuntimeError(f"unsupported api style {cfg.api_style}")


def translate_srt(
    srt_path: Path,
    provider: str = "identity",
    model: Optional[str] = None,
    target_language: str = "English",
    output_path: Optional[Path] = None,
    base_url: Optional[str] = None,
    tone: str = "standard",
    auto_start_ollama: bool = True,
    call_fn: Optional[Callable] = None,   # injection point for tests
    max_batch_size: Optional[int] = None,
    movie_context: Optional[str] = None,
    scene_threshold: float = DEFAULT_SCENE_THRESHOLD,
    device="cuda",
) -> Path:
    """Translate an SRT file batch-by-batch with resume; returns output path.

    A network provider's untranslatable batch keeps its source text. The
    ``tpu-local`` provider runs the local LM on ``device`` (``call_fn``,
    when given, stands in for that backend), and its errors raise after
    the project is saved. The ollama provider runs through OllamaManager
    (server auto-start, VRAM-based model pick, context-window-derived
    batch size — reference: translate/ollama_manager.py,
    translate/core.py:7-30).
    """
    srt_path = Path(srt_path)
    cfg = resolve_provider(provider, base_url=base_url, model=model)
    model = model or cfg.default_model
    batch_override: Optional[int] = None
    on_device = cfg.api_style == "tpu-local"
    if on_device and call_fn is None:
        # the local LM on the card: --translate-model is the local
        # checkpoint directory
        from whisperjav_tpu_torch.translate.local_backend import (
            LocalLMBackend,
        )
        call_fn = LocalLMBackend(checkpoint=model or None, device=device)
    if cfg.api_style == "ollama" and call_fn is None:
        from whisperjav_tpu_torch.translate.ollama_manager import OllamaManager
        mgr = OllamaManager(base_url=cfg.base_url)
        ready = mgr.ensure_ready(model=model if model != "auto" else None,
                                 auto_start=auto_start_ollama)
        model = ready["model"]
        batch_override = ready["batch_size"]
        cfg = resolve_provider(provider, base_url=ready["base_url"],
                               model=model)
        logger.info("ollama ready: %s (num_ctx=%d, batch=%d%s)",
                    model, ready["num_ctx"], ready["batch_size"],
                    ", server auto-started"
                    if ready["server_started"] else "")
    subs = load_srt(srt_path)
    project = ProjectV2.load_or_new(srt_path, provider, model,
                                    target_language,
                                    scene_threshold=scene_threshold,
                                    synopsis=movie_context)
    batch_size = batch_override or max_batch_lines(cfg)
    if max_batch_size:
        batch_size = min(batch_size, max_batch_size)
    project.build(subs, batch_size)
    call = call_fn or (lambda prompt: _call_provider(cfg, prompt, model))
    instructions = get_instruction_content(tone, target_language)
    if movie_context:
        # movie metadata block (reference: settings.py movie_title/plot/
        # actress injected for name & register handling)
        instructions = instructions + "\n" + movie_context + "\n"

    by_index = {s.index: s for s in subs}
    pending = project.pending()
    n_pending = sum(len(b.indices) for b in pending)
    logger.info("translating %d/%d cues via %s (%s): %d scenes, "
                "%d/%d batches left, batch<=%d",
                n_pending, len(subs), provider, model,
                len({b.scene for b in project.batches}),
                len(pending), len(project.batches), batch_size)

    for bstate in pending:
        batch = [by_index[i] for i in bstate.indices if i in by_index]
        if not batch:
            continue
        numbered = "\n".join(
            f"{s.index}: {s.text.replace(chr(10), ' ')}" for s in batch)
        ctx = project.context_for(bstate)
        prompt = (instructions + _PROTOCOL
                  + (("\n" + ctx) if ctx else "")
                  + "\n---\n" + numbered)
        try:
            response = call(prompt)
        except Exception as e:  # noqa: BLE001 — keep remaining batches
            bstate.status = "failed"
            project.save(srt_path)
            if on_device:
                raise
            logger.error("translation batch failed (%s); keeping source "
                         "text for %d cues", e, len(batch))
            continue
        project.record(bstate, parse_numbered_response(response),
                       extract_summary(response))
        project.save(srt_path)

    translated = project.translated_map()
    out = [Subtitle(s.index, s.start, s.end,
                    translated.get(str(s.index), s.text))
           for s in subs]
    if output_path is None:
        lang_tag = _iso_tag(target_language)
        output_path = srt_path.with_name(
            srt_path.stem.rsplit(".", 1)[0] + f".{lang_tag}.srt"
            if srt_path.stem.endswith(".whisperjav")
            else srt_path.stem + f".{lang_tag}.srt")
    save_srt(output_path, out)
    logger.info("translated SRT written: %s", output_path)
    return Path(output_path)


def translate_with_config(config: Dict) -> Path:
    """Dict-config entry point (reference: translate_with_config)."""
    return translate_srt(
        Path(config["input"]),
        provider=config.get("provider", "identity"),
        model=config.get("model"),
        target_language=config.get("target_language", "English"),
        output_path=(Path(config["output"]) if config.get("output")
                     else None),
        base_url=config.get("base_url"),
        tone=config.get("tone", "standard"),
        auto_start_ollama=config.get("auto_start_ollama", True),
        scene_threshold=config.get("scene_threshold",
                                   DEFAULT_SCENE_THRESHOLD),
        device=config.get("device", "cuda"),
    )
