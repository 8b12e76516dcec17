"""Resident-engine CLI routing: reuse a ``whisperjav-torch-serve`` daemon.

The port's copy of ``whisperjav_tpu/pipelines/daemon_client.py``. A
fresh ``whisperjav-torch`` process pays the model's load (a seeded init
or a checkpoint read, the cast, the int8 quantisation) and the CUDA
context before its first batch; a resident engine pays that once, and
every later file runs at steady state.

``whisperjav-torch <files> --daemon`` routes each file through the
daemon's HTTP API (autostarting one when none is up). The daemon must
match the request's (mode, sensitivity, model, language, batch size) and
the hash of its whole resolved config; a mismatch falls back to
in-process with a warning rather than silently decoding under different
settings.

The fingerprint names the backend (``"backend": "torch"``) and salts
the config hash with it, so the JAX package's daemon (same default port,
8478) never serves a port request and the JAX package's client never
accepts a port daemon: the JAX client compares the hash, which differs,
and the port's client asks for the backend key, which the JAX daemon
does not send.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

from whisperjav_tpu_torch.utils.logger import logger

DEFAULT_PORT = 8478
BACKEND = "torch"


def _health(port: int, timeout: float = 3.0) -> Optional[dict]:
    import urllib.request
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/health", timeout=timeout) as r:
            return json.loads(r.read().decode())
    except Exception:
        return None


def _fingerprint(cfg) -> dict:
    import hashlib
    from whisperjav_tpu_torch.config.presets import config_fingerprint
    salted = f"{BACKEND}:{config_fingerprint(cfg)}".encode()
    return {
        "backend": BACKEND,
        "mode": cfg.mode.name,
        "sensitivity": cfg.sensitivity.name,
        "model": cfg.model,
        "language": cfg.language,
        "batch_size": cfg.batch_size,
        # full-config hash, salted with the backend: dot-overrides /
        # --vad-backend / sensitivity tweaks all change it, so a daemon
        # started under different knobs (or the JAX package's daemon)
        # never silently serves this request
        "cfg_hash": hashlib.sha1(salted).hexdigest()[:12],
    }


def daemon_reproducible(cfg) -> bool:
    """True iff ``start_daemon``'s command line (mode/sensitivity/model/
    language/batch-size only) would resolve to exactly this config — i.e.
    the invocation carries no cfg-level overrides a daemon can't receive.
    The CLI checks this before routing so it never autostarts a daemon
    doomed to a fingerprint mismatch."""
    from whisperjav_tpu_torch.config.presets import (
        config_fingerprint, resolve_pipeline_config,
    )
    plain = resolve_pipeline_config(
        mode=cfg.mode.name, sensitivity=cfg.sensitivity.name,
        language=cfg.language, model=cfg.model,
        batch_size=cfg.batch_size)
    return config_fingerprint(plain) == config_fingerprint(cfg)


class DaemonClient:
    """One healthy, fingerprint-matched whisperjav-torch-serve endpoint."""

    def __init__(self, port: int):
        self.port = port

    def transcribe(self, wav_path: Path) -> Tuple[List, dict]:
        """POST the file path; returns (subtitles, stats)."""
        import urllib.request
        from whisperjav_tpu_torch.modules.srt import Subtitle
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/transcribe",
            data=json.dumps({"path": str(wav_path),
                             "format": "json"}).encode(),
            headers={"Content-Type": "application/json"})
        # no read timeout: a long file decodes for as long as it takes
        with urllib.request.urlopen(req) as r:
            payload = json.loads(r.read().decode())
        subs = [Subtitle(index=c["index"], start=c["start"], end=c["end"],
                         text=c["text"]) for c in payload["cues"]]
        return subs, payload.get("stats", {})


def find_daemon(cfg, port: int = DEFAULT_PORT) -> Optional[DaemonClient]:
    """A healthy daemon whose fingerprint matches ``cfg``, else None."""
    h = _health(port)
    if h is None or h.get("status") != "ok":
        return None
    want = _fingerprint(cfg)
    got = {k: h.get(k) for k in want}
    if got != want:
        logger.warning(
            "daemon on port %d runs %s but this invocation wants %s — "
            "falling back to in-process engine (restart the daemon with "
            "matching settings to reuse it)", port, got, want)
        return None
    return DaemonClient(port)


def start_daemon(cfg, port: int = DEFAULT_PORT,
                 checkpoint: Optional[str] = None, device: str = "cuda",
                 wait_s: float = 300.0) -> Optional[DaemonClient]:
    """Launch ``python -m whisperjav_tpu_torch.serve`` detached on
    ``device`` and wait for a matching /health (the engine loads its
    weights before the server answers)."""
    log_dir = Path(os.environ.get(
        "WJAV_CACHE_DIR", Path.home() / ".cache" / "whisperjav_tpu_torch"))
    log_dir.mkdir(parents=True, exist_ok=True)
    log_path = log_dir / f"serve-{port}.log"
    cmd = [sys.executable, "-m", "whisperjav_tpu_torch.serve",
           "--port", str(port),
           "--device", str(device),
           "--mode", cfg.mode.name,
           "--sensitivity", cfg.sensitivity.name,
           "--language", cfg.language,
           "--batch-size", str(cfg.batch_size)]
    if cfg.model:
        cmd += ["--model", cfg.model]
    if checkpoint:
        cmd += ["--checkpoint", checkpoint]
    logger.info("starting resident engine: %s (log: %s)",
                " ".join(cmd[2:]), log_path)
    # the daemon imports this copy of the package, installed or not
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    with open(log_path, "ab") as log_f:
        proc = subprocess.Popen(cmd, stdout=log_f, stderr=log_f, env=env,
                                start_new_session=True)
    deadline = time.time() + wait_s
    while time.time() < deadline:
        client = find_daemon(cfg, port)
        if client is not None:
            logger.info("resident engine ready on port %d (pid %d)", port,
                        proc.pid)
            return client
        if proc.poll() is not None:
            logger.warning("resident engine exited with %d before it "
                           "became healthy (log: %s) — falling back to "
                           "in-process engine", proc.returncode, log_path)
            return None
        time.sleep(1.0)
    logger.warning("daemon did not become healthy within %.0fs — "
                   "falling back to in-process engine", wait_s)
    return None


def stop_daemon(port: int = DEFAULT_PORT, wait_s: float = 30.0) -> bool:
    """POST /shutdown to the resident engine; wait for the port to free.

    True when nothing is listening afterwards. An engine without the
    /shutdown endpoint answers 404 and keeps running — the caller falls
    back rather than killing blind."""
    import urllib.error
    import urllib.request
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/shutdown", data=b"{}")
        urllib.request.urlopen(req, timeout=10).read()
    except (urllib.error.URLError, OSError):
        return _health(port) is None
    deadline = time.time() + wait_s
    while time.time() < deadline:
        if _health(port) is None:
            return True
        time.sleep(0.5)
    return False


def get_daemon(cfg, port: int = DEFAULT_PORT, autostart: bool = True,
               checkpoint: Optional[str] = None, device: str = "cuda",
               replace: bool = False) -> Optional[DaemonClient]:
    """A config-matched resident engine on ``port``, autostarted on
    ``device`` if the port is free. ``replace``: when a healthy but
    mismatched engine occupies the port, shut it down first (frees its
    device memory — two resident engines can exceed one card) and start
    a matching one."""
    client = find_daemon(cfg, port)
    if client is not None:
        return client
    occupied = _health(port) is not None
    if occupied and replace:
        logger.info("replacing the mismatched resident engine on port %d",
                    port)
        if stop_daemon(port):
            occupied = False
        else:
            logger.warning("could not stop the resident engine on "
                           "port %d — falling back in-process", port)
            return None
    if not occupied and autostart:
        client = start_daemon(cfg, port, checkpoint=checkpoint,
                              device=device)
    return client
