"""Ollama detection, lifecycle, and hardware-aware model selection (the
port's copy of ``whisperjav_tpu/translate/ollama_manager.py``).

Role parity with the reference's OllamaManager (reference:
whisperjav/translate/ollama_manager.py:1-12 — detect/start the local
server, pick a model by available VRAM, compute num_ctx/batch). Built
on urllib only (no new dependencies); server start uses a detached
subprocess with an atexit stop hook only when WE started it.

The VRAM probe reads the card with ``nvidia-smi``; a host without one
gets 0 and the smallest model of the ladder.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import subprocess
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Optional

from whisperjav_tpu_torch.utils.logger import logger

DEFAULT_BASE_URL = "http://127.0.0.1:11434"


class OllamaError(RuntimeError):
    pass


class OllamaNotInstalledError(OllamaError):
    pass


class OllamaNotRunningError(OllamaError):
    pass


class ModelNotAvailableError(OllamaError):
    pass


@dataclass
class ModelRecommendation:
    name: str
    num_ctx: int
    quality: str
    min_vram_gb: float
    note: str = ""


# VRAM ladder mirroring the reference's recommendation table
MODEL_LADDER: List[ModelRecommendation] = [
    ModelRecommendation("qwen2.5:32b", 16384, "excellent", 16.0),
    ModelRecommendation("gemma3:12b", 16384, "very_good", 12.0),
    ModelRecommendation("gemma2:9b", 8192, "very_good", 8.0),
    ModelRecommendation("qwen2.5:7b", 8192, "good", 4.0),
    ModelRecommendation("gemma2:2b", 4096, "basic", 0.0),
]


class OllamaManager:
    """Detect/start the Ollama server and prepare a model for batching."""

    def __init__(self, base_url: Optional[str] = None):
        self.base_url = (base_url or os.environ.get("OLLAMA_HOST")
                         or DEFAULT_BASE_URL)
        if not self.base_url.startswith("http"):
            self.base_url = "http://" + self.base_url
        self._proc: Optional[subprocess.Popen] = None

    # -- HTTP helpers --------------------------------------------------
    def _get(self, path: str, timeout: float = 5.0):
        with urllib.request.urlopen(self.base_url + path,
                                    timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def _post(self, path: str, payload: Dict, timeout: float = 30.0):
        req = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))

    # -- detection -----------------------------------------------------
    def detect_server(self) -> bool:
        try:
            self._get("/api/tags", timeout=2.0)
            return True
        except Exception:  # noqa: BLE001 — any failure means "not running"
            return False

    def detect_installation(self) -> Optional[str]:
        return shutil.which("ollama")

    def list_models(self) -> List[str]:
        try:
            data = self._get("/api/tags")
        except Exception as e:  # noqa: BLE001
            raise OllamaNotRunningError(str(e)) from e
        return [m.get("name", "") for m in data.get("models", [])]

    def check_model(self, name: str) -> bool:
        models = self.list_models()
        return any(m == name or m.split(":")[0] == name for m in models)

    def get_context_length(self, name: str) -> int:
        try:
            info = self._post("/api/show", {"name": name})
        except Exception:  # noqa: BLE001
            return 8192
        mi = info.get("model_info", {})
        for key, val in mi.items():
            if key.endswith("context_length") or key == "num_ctx":
                return int(val)
        return 8192

    # -- lifecycle -----------------------------------------------------
    def start_server(self, timeout: float = 15.0) -> bool:
        binary = self.detect_installation()
        if binary is None:
            raise OllamaNotInstalledError(
                "ollama binary not found on PATH")
        logger.info("starting ollama server (%s serve)", binary)
        self._proc = subprocess.Popen(
            [binary, "serve"], stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            start_new_session=True)
        atexit.register(self.stop_server)
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.detect_server():
                return True
            time.sleep(0.5)
        return False

    def stop_server(self) -> None:
        """Stop the server ONLY if this manager started it."""
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
            self._proc = None

    # -- hardware-aware selection ---------------------------------------
    @staticmethod
    def _detect_vram_gb() -> float:
        """Best-effort local-GPU VRAM probe (nvidia-smi); 0 when absent,
        which picks the smallest model."""
        smi = shutil.which("nvidia-smi")
        if not smi:
            return 0.0
        try:
            out = subprocess.run(
                [smi, "--query-gpu=memory.total",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=5).stdout
            values = [float(v) for v in out.split() if v.strip()]
            return max(values) / 1024.0 if values else 0.0
        except Exception:  # noqa: BLE001
            return 0.0

    def recommend_model(self, vram_gb: Optional[float] = None
                        ) -> ModelRecommendation:
        if vram_gb is None:
            vram_gb = self._detect_vram_gb()
        for rec in MODEL_LADDER:
            if vram_gb >= rec.min_vram_gb:
                return rec
        return MODEL_LADDER[-1]

    # -- the one-call entry point ---------------------------------------
    def ensure_ready(self, model: Optional[str] = None,
                     auto_start: bool = True) -> Dict:
        """Detect/start the server, resolve the model, compute batching.

        Returns {model, num_ctx, batch_size, server_started, base_url} —
        the readiness record the translation service consumes
        (reference: ollama_manager.ensure_ready).
        """
        started = False
        if not self.detect_server():
            if not auto_start:
                raise OllamaNotRunningError(
                    f"no ollama server at {self.base_url}")
            if not self.start_server():
                raise OllamaNotRunningError(
                    "ollama server failed to start within timeout")
            started = True

        if model is None:
            model = self.recommend_model().name
        if not self.check_model(model):
            raise ModelNotAvailableError(
                f"model {model!r} not pulled; run: ollama pull {model}")

        num_ctx = self.get_context_length(model)
        # ~40 chars/line, ~4 chars/token, headroom for the instruction
        # prompt: cap lines per batch to half the context window
        batch_size = max(8, min(96, num_ctx // 2 // 16))
        return {
            "model": model,
            "num_ctx": num_ctx,
            "batch_size": batch_size,
            "server_started": started,
            "base_url": self.base_url,
        }
