"""The PyTorch port imports no jax, and nothing of the JAX package: it keeps
its own copy of every host module it runs."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import whisperjav_tpu_torch

PKG_DIR = Path(whisperjav_tpu_torch.__file__).parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG_DIR)], prefix="whisperjav_tpu_torch."))


# the developer tools and the bench scorer (counterparts of the JAX
# package's tools/ and bench/)
TOOL_MODULES = tuple(
    [f"whisperjav_tpu_torch.bench.{m}" for m in (
        "cli", "forensic", "loader", "matcher", "metrics", "provenance",
        "report")]
    + [f"whisperjav_tpu_torch.tools.{m}" for m in (
        "e2e_bench", "decode_profile", "verify_checkpoint", "first_weights",
        "parity_check", "decode_diagnostic", "vad_analyser",
        "determinism_suite", "voice_classifier")])


# the web GUI and the small utilities beside it
GUI_MODULES = ("whisperjav_tpu_torch.config.user_config",
               "whisperjav_tpu_torch.utils.version_check",
               "whisperjav_tpu_torch.utils.metadata",
               "whisperjav_tpu_torch.utils.model_loader",
               "whisperjav_tpu_torch.gui.app_page",
               "whisperjav_tpu_torch.gui.server")


def test_every_module_is_listed():
    mods = _modules()
    for name in ("whisperjav_tpu_torch.cli",
                 "whisperjav_tpu_torch.ops.cuda.encoder_attention",
                 "whisperjav_tpu_torch.ops.cuda.decode_attention",
                 "whisperjav_tpu_torch.pipelines.factory",
                 "whisperjav_tpu_torch.ops.stft",
                 "whisperjav_tpu_torch.models.enhancement.zipenhancer",
                 "whisperjav_tpu_torch.models.enhancement.zipnet",
                 "whisperjav_tpu_torch.modules.enhancement.zipenhancer",
                 "whisperjav_tpu_torch.models.whisper.word_align",
                 "whisperjav_tpu_torch.models.whisper.vocab_subset",
                 "whisperjav_tpu_torch.models.qwen.model",
                 "whisperjav_tpu_torch.models.qwen.aligner",
                 "whisperjav_tpu_torch.modules.subtitle_pipeline.components",
                 "whisperjav_tpu_torch.pipelines.qwen",
                 "whisperjav_tpu_torch.serve",
                 "whisperjav_tpu_torch.pipelines.daemon_client",
                 "whisperjav_tpu_torch.utils.onnx_io",
                 "whisperjav_tpu_torch.models.vad.silero",
                 "whisperjav_tpu_torch.models.vad.silero_like",
                 "whisperjav_tpu_torch.models.vad.ten",
                 "whisperjav_tpu_torch.models.vad.whisperseg",
                 "whisperjav_tpu_torch.modules.segmentation.ten",
                 "whisperjav_tpu_torch.modules.segmentation.whisper_vad",
                 "whisperjav_tpu_torch.modules.scene_detection.silero_scene",
                 "whisperjav_tpu_torch.utils.pytree_npz",
                 "whisperjav_tpu_torch.models.enhancement.bandsplit",
                 "whisperjav_tpu_torch.models.enhancement.bs_roformer",
                 "whisperjav_tpu_torch.models.enhancement.frcrn",
                 "whisperjav_tpu_torch.models.enhancement.mossformer2",
                 "whisperjav_tpu_torch.modules.enhancement"
                 ".bandsplit_backends",
                 "whisperjav_tpu_torch.utils.tracer",
                 "whisperjav_tpu_torch.utils.progress",
                 "whisperjav_tpu_torch.utils.preflight",
                 "whisperjav_tpu_torch.utils.async_processor",
                 "whisperjav_tpu_torch.ensemble.merge",
                 "whisperjav_tpu_torch.ensemble.orchestrator",
                 "whisperjav_tpu_torch.translate.providers",
                 "whisperjav_tpu_torch.translate.instructions",
                 "whisperjav_tpu_torch.translate.settings",
                 "whisperjav_tpu_torch.translate.project",
                 "whisperjav_tpu_torch.translate.ollama_manager",
                 "whisperjav_tpu_torch.translate.local_backend",
                 "whisperjav_tpu_torch.translate.service",
                 "whisperjav_tpu_torch.translate.cli",
                 *TOOL_MODULES, *GUI_MODULES):
        assert name in mods


def test_every_port_script_names_a_port_module():
    """Each ``whisperjav-torch*`` script of pyproject.toml points into the
    port, at a module that exists and has the named function."""
    import importlib
    text = (PKG_DIR.parent / "pyproject.toml").read_text(encoding="utf-8")
    scripts = dict(re.findall(
        r'^(whisperjav-torch[\w-]*) = "([\w.:]+)"$', text, re.M))
    assert set(scripts) == {"whisperjav-torch", "whisperjav-torch-serve",
                            "whisperjav-torch-finetune",
                            "whisperjav-torch-translate",
                            "whisperjav-torch-bench",
                            "whisperjav-torch-verify-checkpoint",
                            "whisperjav-torch-first-weights",
                            "whisperjav-torch-gui",
                            "whisperjav-torch-upgrade"}
    for target in scripts.values():
        module, func = target.split(":")
        assert module.startswith("whisperjav_tpu_torch.")
        assert callable(getattr(importlib.import_module(module), func))


def test_importing_the_port_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
            "print(','.join(bad))\n")
    root = str(PKG_DIR.parent)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"jax loaded: {proc.stdout}"


def test_each_tool_leaves_jax_and_the_jax_package_out():
    """Importing each bench/ and tools/ module alone (a fresh process per
    module) loads no jax, optax or whisperjav_tpu module."""
    code = ("import importlib, sys\n"
            "importlib.import_module(sys.argv[1])\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'optax',\n"
            "                                    'whisperjav_tpu'))\n"
            "print(','.join(bad))\n")
    root = str(PKG_DIR.parent)
    procs = [subprocess.Popen([sys.executable, "-c", code, name], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for name in TOOL_MODULES]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for name, p, (out, err) in zip(TOOL_MODULES, procs, outs):
        assert p.returncode == 0, (name, err)
        assert out.strip() == "", f"{name} loaded: {out}"


def test_no_tool_source_imports_optax():
    pat = re.compile(r"^\s*(import\s+optax|from\s+optax[\s.])", re.M)
    files = sorted((PKG_DIR / "tools").glob("*.py")) \
        + sorted((PKG_DIR / "bench").glob("*.py"))
    assert len(files) == len(TOOL_MODULES) + 2     # and two __init__
    assert [str(p) for p in files
            if pat.search(p.read_text(encoding="utf-8"))] == []


def test_no_port_source_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    offenders = [str(p) for p in PKG_DIR.rglob("*.py")
                 if pat.search(p.read_text(encoding="utf-8"))]
    assert offenders == []


# `whisperjav_tpu` as a module, never the port's own `whisperjav_tpu_torch`
_JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(from\s+whisperjav_tpu(\.|\s+import\b)"
    r"|import\s+whisperjav_tpu(\.|\s|,|$))", re.M)


def test_no_port_source_imports_the_jax_package():
    files = sorted(PKG_DIR.rglob("*.py")) + [PKG_DIR.parent / "chip_smoke.py"]
    offenders = [str(p) for p in files
                 if _JAX_PACKAGE_IMPORT.search(p.read_text(encoding="utf-8"))]
    assert offenders == []
    assert _JAX_PACKAGE_IMPORT.search("from whisperjav_tpu.cli import x")
    assert _JAX_PACKAGE_IMPORT.search("  import whisperjav_tpu")
    assert not _JAX_PACKAGE_IMPORT.search("from whisperjav_tpu_torch import x")
    assert not _JAX_PACKAGE_IMPORT.search("import whisperjav_tpu_torch.cli")


_PIPELINE_RUN = """
import sys, tempfile
from pathlib import Path
import numpy as np
import torch
from whisperjav_tpu_torch import cli
from whisperjav_tpu_torch.models.whisper.config import WhisperConfig
from whisperjav_tpu_torch.models.whisper.decode import DecodeOptions
from whisperjav_tpu_torch.models.whisper.weights import init_params
from whisperjav_tpu_torch.modules.audio_io import write_wav
from whisperjav_tpu_torch.modules.media_discovery import probe
from whisperjav_tpu_torch.modules.sanitize import SRTPostProcessor
from whisperjav_tpu_torch.pipelines.engine import (
    QualityThresholds, TranscriptionEngine,
)
from whisperjav_tpu_torch.pipelines.transcribe import TranscribePipeline

torch.set_num_threads(1)
cfg = WhisperConfig(name="isolation-tiny", n_mels=80, n_audio_state=64,
                    n_audio_head=4, n_audio_layer=1, n_text_state=64,
                    n_text_head=4, n_text_layer=1, n_vocab=51865)
model = init_params(cfg, torch.Generator().manual_seed(0))
sr, rng = 16000, np.random.default_rng(0)
t = np.arange(6 * sr) / sr
burst = (0.3 * np.sin(2 * np.pi * 180 * t)
         + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
audio = np.concatenate([burst, np.zeros(2 * sr, np.float32), burst])
with tempfile.TemporaryDirectory() as tmp:
    wav = Path(tmp) / "clip.wav"
    write_wav(wav, audio, sr)
    for int8 in (False, True):
        engine = TranscriptionEngine(
            cfg, model, options=DecodeOptions(max_new_tokens=6, beam_size=2,
                                              cross_kv_int8=True),
            thresholds=QualityThresholds(temperatures=(0.0,)),
            batch_size=2, device="cpu", compute_dtype=torch.float32,
            int8_weights=int8)
        out = TranscribePipeline(
            engine, scene_backend="energy", vad_backend="silero",
            postprocessor=SRTPostProcessor()).process(
                probe(wav), Path(tmp) / f"out{int(int8)}")
        assert out.srt_path.exists() and out.metadata["stats"]["windows"] >= 1
    assert cli.main([str(wav), "--int8-weights", "--dump-params"]) == 0
    from whisperjav_tpu_torch.models.enhancement import zipenhancer
    zip_path = str(Path(tmp) / "zip.npz")
    zipenhancer.save_params(zip_path, zipenhancer.init_params(
        zipenhancer.ZIP_TEST, torch.Generator().manual_seed(0)))
    assert cli.main([str(wav), "--output-dir", str(Path(tmp) / "fid"),
                     "--device", "cpu", "--model", "tiny", "--batch-size",
                     "1", "--logprob-threshold", "-100", "--mode",
                     "fidelity", "--enhancer-weights", zip_path,
                     "--word-timestamps", "--vocab-slice", "4000"]) == 0
    assert (Path(tmp) / "fid" / "clip.ja.whisperjav.srt").exists()
    # the VAD networks from their .npz files, a vendor ONNX file, and the
    # resident engine's service with its fingerprint
    import dataclasses, json, threading, urllib.request
    from whisperjav_tpu_torch import serve
    from whisperjav_tpu_torch.config.presets import resolve_pipeline_config
    from whisperjav_tpu_torch.models.vad import silero, ten, whisperseg
    from whisperjav_tpu_torch.modules.segmentation import create_segmenter
    from whisperjav_tpu_torch.pipelines.daemon_client import _fingerprint
    from whisperjav_tpu_torch.utils import onnx_io
    gen = torch.Generator().manual_seed(0)
    narrow = dataclasses.replace(whisperseg.SEG_CONFIG, n_audio_state=64,
                                 n_text_state=64, n_audio_layer=1,
                                 n_vocab=64)
    for backend, module, model in (
            ("silero", silero, silero.init_params(gen)),
            ("ten", ten, ten.init_params(gen)),
            ("whisperseg", whisperseg, whisperseg.init_params(gen, narrow))):
        npz = str(Path(tmp) / f"{backend}.npz")
        module.save_params(npz, model)
        res = create_segmenter(backend, weights=npz, device="cpu").segment(
            audio, sr)
        assert res.stats["model"] == "network"
    onnx_path = str(Path(tmp) / "ten.onnx")
    onnx_io.write_onnx(onnx_path, onnx_io.OnnxGraph(
        initializers=ten.init_params(gen).tree()))
    assert sorted(onnx_io.read_initializers(onnx_path)) == sorted(
        ten.init_params(gen).tree())
    svc = serve.TranscriptionService(TranscribePipeline(engine),
                                     device="cpu", fingerprint=_fingerprint(
                                         resolve_pipeline_config()))
    httpd = serve.make_server(svc)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    with urllib.request.urlopen(
            f"http://127.0.0.1:{httpd.server_address[1]}/health") as r:
        assert json.loads(r.read())["backend"] == "torch"
    httpd.shutdown()
bad = sorted(m for m in sys.modules
             if m == "whisperjav_tpu" or m.startswith("whisperjav_tpu."))
print("LOADED:" + ",".join(bad))
"""


def test_port_pipeline_and_cli_leave_the_jax_package_out():
    """The port's file pipeline (silero VAD, sanitizer, bf16 and int8
    decoder weights), its CLI (a fidelity run with the ZipEnhancer, word
    timestamps and a sliced vocabulary), the VAD networks (Silero, TEN,
    WhisperSeg), the ONNX reader and the resident service run on the CPU
    without loading a single module of ``whisperjav_tpu``."""
    proc = subprocess.run([sys.executable, "-c", _PIPELINE_RUN],
                          cwd=str(PKG_DIR.parent), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    loaded = [line for line in proc.stdout.splitlines()
              if line.startswith("LOADED:")]
    assert loaded == ["LOADED:"], f"JAX package modules loaded: {loaded}"


_QWEN_RUN = """
import sys, tempfile
from pathlib import Path


class _Blocked:
    # what the GPU machine does not have: importing it fails
    NAMES = ("jax", "jaxlib", "sklearn", "transformers", "whisperjav_tpu")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.NAMES:
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, _Blocked())
import numpy as np
import torch
from whisperjav_tpu_torch import cli
from whisperjav_tpu_torch.modules.audio_io import write_wav

torch.set_num_threads(1)
sr, rng = 16000, np.random.default_rng(0)
t = np.arange(5 * sr) / sr
burst = (0.3 * np.sin(2 * np.pi * 180 * t)
         + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
audio = np.concatenate([burst, np.zeros(sr, np.float32), burst,
                        np.zeros(sr, np.float32), burst])
with tempfile.TemporaryDirectory() as tmp:
    wav = Path(tmp) / "clip.wav"
    write_wav(wav, audio, sr)
    for extra in ([], ["--qwen-timestamps", "none"]):
        out = Path(tmp) / f"out{len(extra)}"
        assert cli.main([str(wav), "--output-dir", str(out), "--mode",
                         "qwen", "--device", "cpu", "--qwen-model-id",
                         "qwen3-asr-test", "--qwen-batch-size", "2",
                         *extra]) == 0
        assert (out / "clip.ja.whisperjav.srt").exists()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in _Blocked.NAMES)
print("LOADED:" + ",".join(bad))
"""


_CLEARVOICE_RUN = """
import sys, tempfile
from pathlib import Path


class _Blocked:
    NAMES = ("jax", "jaxlib", "whisperjav_tpu")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.NAMES:
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, _Blocked())
import json
import numpy as np
import torch
from whisperjav_tpu_torch import cli
from whisperjav_tpu_torch.models.enhancement import mossformer2
from whisperjav_tpu_torch.modules.audio_io import write_wav

torch.set_num_threads(1)
sr, rng = 16000, np.random.default_rng(0)
t = np.arange(5 * sr) / sr
burst = (0.3 * np.sin(2 * np.pi * 180 * t)
         + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
gap = np.zeros(sr, np.float32)
with tempfile.TemporaryDirectory() as tmp:
    wav = Path(tmp) / "clip.wav"
    write_wav(wav, np.concatenate([gap, burst, gap]), sr)
    weights = str(Path(tmp) / "mf2.npz")
    mossformer2.save_params(weights, mossformer2.init_params(
        mossformer2.MF2_TEST, torch.Generator().manual_seed(0)))
    out = Path(tmp) / "out"
    assert cli.main([str(wav), "--output-dir", str(out), "--device", "cpu",
                     "--model", "tiny", "--batch-size", "1",
                     "--logprob-threshold", "-100", "--enhancer",
                     "clearvoice", "--enhancer-weights", weights]) == 0
    stats = json.loads((out / "clip.whisperjav.json").read_text())["stats"]
    assert stats["enhanced_scenes"] == stats["scenes"] >= 1
    assert stats["enhancer"]["engines"] == ["mossformer2"]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in _Blocked.NAMES)
print("LOADED:" + ",".join(bad))
"""


def test_clearvoice_cli_runs_without_jax():
    """``--enhancer clearvoice`` (MossFormer2 from a seeded ``.npz``)
    runs on the CPU with jax and the JAX package blocked from import, and
    enhances every scene."""
    proc = subprocess.run([sys.executable, "-c", _CLEARVOICE_RUN],
                          cwd=str(PKG_DIR.parent), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    loaded = [line for line in proc.stdout.splitlines()
              if line.startswith("LOADED:")]
    assert loaded == ["LOADED:"], f"blocked modules loaded: {loaded}"


_REST_RUN = """
import sys, tempfile
from pathlib import Path


class _Blocked:
    NAMES = ("jax", "jaxlib", "transformers", "whisperjav_tpu")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.NAMES:
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, _Blocked())
import numpy as np
import torch
from whisperjav_tpu_torch import cli
from whisperjav_tpu_torch.models.qwen import model as qm
from whisperjav_tpu_torch.models.qwen import weights as qw
from whisperjav_tpu_torch.models.qwen.tokenizer import QwenTokenizer
from whisperjav_tpu_torch.modules.audio_io import write_wav
from whisperjav_tpu_torch.translate import cli as tcli
from whisperjav_tpu_torch.translate.local_backend import LocalLMBackend
from whisperjav_tpu_torch.translate.service import translate_srt

torch.set_num_threads(1)
sr, rng = 16000, np.random.default_rng(0)
t = np.arange(5 * sr) / sr
burst = (0.3 * np.sin(2 * np.pi * 180 * t)
         + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
gap = np.zeros(sr, np.float32)
run = ["--device", "cpu", "--model", "tiny", "--batch-size", "2",
       "--logprob-threshold", "-100", "--no-sanitize"]
with tempfile.TemporaryDirectory() as tmp:
    wav = Path(tmp) / "clip.wav"
    write_wav(wav, np.concatenate([gap, burst, gap]), sr)
    ens = Path(tmp) / "ens"
    assert cli.main([str(wav), "--output-dir", str(ens), "--ensemble",
                     "--pass2-mode", "balanced", *run]) == 0
    assert (ens / "ensemble_batch.json").exists()
    out = Path(tmp) / "async"
    assert cli.main([str(wav), "--output-dir", str(out),
                     "--async-processing", "--output-format", "both",
                     "--translate", "identity", "--trace-params",
                     str(Path(tmp) / "t.jsonl"), *run]) == 0
    assert (out / "clip.ja.whisperjav.vtt").exists()
    assert (out / "clip.ja.en.srt").exists()
    lm = qw.init_params(qm.QWEN_SIZES["qwen3-asr-test"],
                        torch.Generator().manual_seed(0), audio=False)
    backend = LocalLMBackend(params=lm, tokenizer=QwenTokenizer(),
                             max_new_tokens=4, device="cpu")
    translate_srt(out / "clip.ja.whisperjav.srt", provider="tpu-local",
                  call_fn=backend, device="cpu")
    import os
    os.environ["WJAV_CONFIG_DIR"] = tmp
    assert tcli.main(["--show-settings"]) == 0
    assert cli.main(["--check"]) in (0, 1)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in _Blocked.NAMES)
print("LOADED:" + ",".join(bad))
"""


def test_ensemble_async_translate_run_without_jax():
    """``--ensemble``, ``--async-processing`` with ``--translate
    identity`` and ``--trace-params``, the tpu-local backend on a seeded
    LM-only tree, ``whisperjav-torch-translate --show-settings`` and
    ``--check`` run on the CPU with jax, transformers and the JAX package
    blocked from import, and load none of them."""
    proc = subprocess.run([sys.executable, "-c", _REST_RUN],
                          cwd=str(PKG_DIR.parent), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    loaded = [line for line in proc.stdout.splitlines()
              if line.startswith("LOADED:")]
    assert loaded == ["LOADED:"], f"blocked modules loaded: {loaded}"


def test_qwen_cli_runs_without_jax_sklearn_transformers():
    """``--mode qwen`` (semantic scenes, whisperseg, the Qwen generator,
    the forced aligner) runs on the CPU with jax, scikit-learn,
    transformers and the JAX package blocked from import, and loads none
    of them."""
    proc = subprocess.run([sys.executable, "-c", _QWEN_RUN],
                          cwd=str(PKG_DIR.parent), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    loaded = [line for line in proc.stdout.splitlines()
              if line.startswith("LOADED:")]
    assert loaded == ["LOADED:"], f"blocked modules loaded: {loaded}"


_GUI_RUN = """
import sys


class _Blocked:
    NAMES = ("jax", "jaxlib", "transformers", "huggingface_hub",
             "whisperjav_tpu")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.NAMES:
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, _Blocked())
import importlib
for name in sys.argv[1:]:
    importlib.import_module(name)
from whisperjav_tpu_torch.gui import server
from whisperjav_tpu_torch.utils import version_check
s = server.schema()
assert "tpu-local" in s["translate_providers"]
n = 0
for ctype, names in server._COMPONENT_CONFIGS.items():
    for name in names:
        assert server.component_schema(ctype, name)["fields"]
        n += 1
assert n == 14
assert version_check.upgrade_main([]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in _Blocked.NAMES)
print("LOADED:" + ",".join(bad))
"""


def test_gui_and_upgrade_run_without_jax_transformers_or_hub():
    """The six GUI-slice modules import, ``schema()`` and every
    ``component_schema`` build and ``whisperjav-torch-upgrade`` runs
    offline (its poll sent to a proxy on a closed local port) with jax,
    transformers, huggingface_hub and the JAX package blocked from
    import, and none of them is loaded."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        closed = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k.lower() not in ("no_proxy", "pythonpath")}
    env["https_proxy"] = env["HTTPS_PROXY"] = f"http://127.0.0.1:{closed}"
    proc = subprocess.run([sys.executable, "-c", _GUI_RUN, *GUI_MODULES],
                          cwd=str(PKG_DIR.parent), capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "update check unavailable (offline)" in proc.stdout
    loaded = [line for line in proc.stdout.splitlines()
              if line.startswith("LOADED:")]
    assert loaded == ["LOADED:"], f"blocked modules loaded: {loaded}"


def test_no_gui_slice_module_imports_hub_packages_at_top_level():
    pat = re.compile(r"^(import|from)\s+(transformers|huggingface_hub)\b",
                     re.M)
    for name in GUI_MODULES:
        path = PKG_DIR.parent / (name.replace(".", "/") + ".py")
        assert not pat.search(path.read_text(encoding="utf-8")), name
