"""Resilient model/checkpoint resolution.

The port's copy of ``whisperjav_tpu/utils/model_loader.py``. Neither
``transformers`` nor ``huggingface_hub`` is imported at module level:
the default loader imports transformers when it is first needed, and the
mirror rung patches huggingface_hub only where it is installed.

Role parity with reference ``whisperjav/utils/model_loader.py:1-8``
(monkeypatched huggingface_hub downloads: normal → local cache →
hf-mirror.com fallback for China networks). Instead of monkeypatching,
this exposes one resolution chain used by checkpoint loading:

1. local directory path (offline-first — the common TPU-pod case);
2. hub id from the local HF cache (``local_files_only``);
3. hub download, honoring ``HF_ENDPOINT`` if set;
4. retry the download against the configured mirror.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Optional

from whisperjav_tpu_torch.utils.logger import logger

DEFAULT_MIRROR = "https://hf-mirror.com"


def resolve_checkpoint(
    name_or_path: str,
    loader: Optional[Callable] = None,
    mirror: Optional[str] = None,
):
    """Run ``loader(source, **kw)`` through the resolution chain.

    ``loader`` defaults to transformers' WhisperForConditionalGeneration
    loading; pass any ``from_pretrained``-style callable for other model
    types. Returns the loader's result; raises the LAST error when every
    step fails.
    """
    if loader is None:
        import transformers
        loader = transformers.WhisperForConditionalGeneration.from_pretrained
    mirror = mirror or os.environ.get("WJAV_HF_MIRROR", DEFAULT_MIRROR)

    p = Path(name_or_path)
    last_err: Optional[Exception] = None

    if p.exists():
        return loader(str(p))

    try:
        return loader(name_or_path, local_files_only=True)
    except Exception as e:  # noqa: BLE001 — each rung falls through
        last_err = e
        logger.debug("not in local HF cache: %s (%s)", name_or_path, e)

    try:
        return loader(name_or_path)
    except Exception as e:  # noqa: BLE001
        last_err = e
        logger.warning("hub download failed for %s (%s); trying mirror %s",
                       name_or_path, e, mirror)

    with _mirror_endpoint(mirror):
        try:
            return loader(name_or_path)
        except Exception as e:  # noqa: BLE001
            last_err = e
    raise last_err


class _mirror_endpoint:
    """Temporarily point huggingface_hub at a mirror.

    HF_ENDPOINT alone is useless at this point — huggingface_hub freezes
    its ENDPOINT constant at import time (which already happened when the
    earlier rungs ran the loader). The constant and the URL template are
    patched directly and restored afterwards; this is the runtime-scoped
    version of the monkeypatching the reference ships permanently.
    """

    def __init__(self, mirror: str):
        self.mirror = mirror.rstrip("/")
        self._saved = {}
        self._env = None

    def __enter__(self):
        # the caller's own HF_ENDPOINT comes back on exit (the JAX
        # context drops it)
        self._env = os.environ.get("HF_ENDPOINT")
        os.environ["HF_ENDPOINT"] = self.mirror
        try:
            import huggingface_hub.constants as c
            self._saved["ENDPOINT"] = getattr(c, "ENDPOINT", None)
            self._saved["TEMPLATE"] = getattr(
                c, "HUGGINGFACE_CO_URL_TEMPLATE", None)
            c.ENDPOINT = self.mirror
            if self._saved["TEMPLATE"]:
                c.HUGGINGFACE_CO_URL_TEMPLATE = (
                    self.mirror + "/{repo_id}/resolve/{revision}/{filename}")
            # file_download caches the template as a default arg in some
            # versions; patch its module global too when present
            import huggingface_hub.file_download as fd
            if hasattr(fd, "HUGGINGFACE_CO_URL_TEMPLATE"):
                self._saved["FD_TEMPLATE"] = fd.HUGGINGFACE_CO_URL_TEMPLATE
                fd.HUGGINGFACE_CO_URL_TEMPLATE = (
                    self.mirror + "/{repo_id}/resolve/{revision}/{filename}")
        except ImportError:
            pass
        return self

    def __exit__(self, *exc):
        if self._env is None:
            os.environ.pop("HF_ENDPOINT", None)
        else:
            os.environ["HF_ENDPOINT"] = self._env
        try:
            import huggingface_hub.constants as c
            if self._saved.get("ENDPOINT") is not None:
                c.ENDPOINT = self._saved["ENDPOINT"]
            if self._saved.get("TEMPLATE") is not None:
                c.HUGGINGFACE_CO_URL_TEMPLATE = self._saved["TEMPLATE"]
            if "FD_TEMPLATE" in self._saved:
                import huggingface_hub.file_download as fd
                fd.HUGGINGFACE_CO_URL_TEMPLATE = self._saved["FD_TEMPLATE"]
        except ImportError:
            pass
        return False
