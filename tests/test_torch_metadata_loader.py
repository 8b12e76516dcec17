"""The port's ``utils/metadata.py`` and ``utils/model_loader.py`` against
the JAX package's: one call sequence writes the same metadata JSON (time
stamps masked) and each package loads the other's file; the checkpoint
resolution chain makes the same loader calls and returns or raises the
same for each rung, under a recording loader (no hub is contacted)."""

import json
import os

import numpy as np
import pytest

from whisperjav_tpu.utils import metadata as jmd
from whisperjav_tpu.utils import model_loader as jml
from whisperjav_tpu_torch.utils import metadata as pmd
from whisperjav_tpu_torch.utils import model_loader as pml


def _calls(module, out_dir):
    mm = module.MetadataManager(out_dir, "movie")
    mm.set_input(path="/x/movie.mp4", duration=np.float32(3600.5),
                 channels=np.int64(2))
    mm.start_stage("scene_detection", backend="energy",
                   thresholds=np.array([0.25, 0.5]))
    mm.complete_stage("scene_detection", scenes=np.int32(42),
                      spans=[(0.0, np.float64(20.0))])
    mm.start_stage("asr", batch=32)
    mm.fail_stage("asr", "boom")
    mm.fail_stage("translate", "no key")
    mm.complete_stage("sanitize", removed=3)
    mm.add_scene(index=0, start=0.0, end=np.float32(20.0),
                 meta={1: np.int16(5)})
    mm.add_scene(index=1, start=20.0, end=31.5)
    mm.set_summary(subtitles=500, rtf=np.float64(17.75))
    mm.set_quality_metrics(hallucinations_removed=np.int64(7),
                           ratio=np.float32(0.5))
    return mm.save()


def _masked(path):
    data = json.loads(path.read_text(encoding="utf-8"))
    data["created"] = "T"
    for stage in data["stages"].values():
        for key in ("started", "duration_s"):
            if key in stage:
                stage[key] = "T"
    return data


def test_one_call_sequence_writes_the_same_json(tmp_path):
    pj = _calls(jmd, tmp_path / "jax")
    pp = _calls(pmd, tmp_path / "torch")
    assert pj.name == pp.name == "movie.whisperjav.json"
    assert _masked(pp) == _masked(pj)
    data = _masked(pp)
    assert data["stages"]["scene_detection"]["results"]["scenes"] == 42
    assert data["stages"]["asr"]["status"] == "failed"
    assert data["scenes"][0]["meta"] == {"1": 5}
    assert data["quality_metrics"] == {"hallucinations_removed": 7,
                                       "ratio": 0.5}


@pytest.mark.parametrize("writer,reader", [(jmd, pmd), (pmd, jmd)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_metadata_cross_loads(tmp_path, writer, reader):
    path = _calls(writer, tmp_path)
    mm = reader.MetadataManager.load(path)
    assert mm.path == path
    assert mm.data == json.loads(path.read_text(encoding="utf-8"))
    mm.set_summary(reloaded=True)
    mm.save()
    back = writer.MetadataManager.load(path)
    assert back.data["summary"] == {"subtitles": 500, "rtf": 17.75,
                                    "reloaded": True}


def _recorder(fail_on):
    """A from_pretrained-style loader that records each call and the
    HF_ENDPOINT it saw, failing on the calls numbered in ``fail_on``."""
    calls = []

    def loader(src, **kw):
        calls.append((src, kw, os.environ.get("HF_ENDPOINT")))
        if len(calls) in fail_on:
            raise OSError(f"rung {len(calls)} failed for {src}")
        return {"loaded": src, "call": len(calls)}
    return loader, calls


# (name, is a local directory, calls that fail): rung 1 is the local
# path, then local_files_only, the hub, the mirror
CHAIN = [("local-dir", True, ()), ("cache-hit", False, ()),
         ("hub", False, (1,)), ("mirror", False, (1, 2)),
         ("all-fail", False, (1, 2, 3))]


@pytest.mark.parametrize("name,local,fails", CHAIN, ids=[c[0] for c in CHAIN])
def test_resolve_checkpoint_chain_parity(tmp_path, monkeypatch, name, local,
                                         fails):
    monkeypatch.delenv("HF_ENDPOINT", raising=False)
    monkeypatch.delenv("WJAV_HF_MIRROR", raising=False)
    src = str(tmp_path / "model") if local else "org/whisper-x"
    if local:
        (tmp_path / "model").mkdir()
    outs = []
    for module in (jml, pml):
        loader, calls = _recorder(fails)
        try:
            got = ("ok", module.resolve_checkpoint(src, loader=loader))
        except OSError as e:
            got = ("raised", type(e).__name__, str(e))
        outs.append((got, calls))
        assert "HF_ENDPOINT" not in os.environ
    assert outs[0] == outs[1]
    got, calls = outs[1]
    assert len(calls) == {(): 1, (1,): 2, (1, 2): 3,
                          (1, 2, 3): 3}[fails]
    if name == "mirror":
        assert calls[-1][2] == pml.DEFAULT_MIRROR
        assert got == ("ok", {"loaded": src, "call": 3})
    if name == "all-fail":
        assert got == ("raised", "OSError", "rung 3 failed for org/whisper-x")
    if name == "cache-hit":
        assert calls == [(src, {"local_files_only": True}, None)]


def test_mirror_from_the_environment(monkeypatch):
    monkeypatch.setenv("WJAV_HF_MIRROR", "https://mirror.example/")
    monkeypatch.delenv("HF_ENDPOINT", raising=False)
    for module in (jml, pml):
        loader, calls = _recorder((1, 2))
        module.resolve_checkpoint("org/x", loader=loader)
        assert calls[-1][2] == "https://mirror.example"
        assert "HF_ENDPOINT" not in os.environ


def test_the_callers_hf_endpoint_comes_back(monkeypatch):
    """Departure: the port's mirror rung restores an HF_ENDPOINT the
    caller had set; the JAX one drops it."""
    for module, after in ((jml, None), (pml, "https://own.example")):
        monkeypatch.setenv("HF_ENDPOINT", "https://own.example")
        loader, calls = _recorder((1, 2))
        module.resolve_checkpoint("org/x", loader=loader)
        assert [c[2] for c in calls] == ["https://own.example"] * 2 + [
            "https://hf-mirror.com"]
        assert os.environ.get("HF_ENDPOINT") == after


def test_mirror_patches_and_restores_huggingface_hub(monkeypatch):
    """Where huggingface_hub is installed, the mirror rung points its
    frozen endpoint constant at the mirror and puts it back."""
    c = pytest.importorskip("huggingface_hub.constants")
    before = c.ENDPOINT
    monkeypatch.delenv("HF_ENDPOINT", raising=False)
    seen = []

    def loader(src, **kw):
        seen.append(c.ENDPOINT)
        if len(seen) < 3:
            raise OSError("down")
        return src
    assert pml.resolve_checkpoint("org/x", loader=loader) == "org/x"
    assert seen == [before, before, "https://hf-mirror.com"]
    assert c.ENDPOINT == before


def test_the_mirror_rung_runs_without_huggingface_hub(monkeypatch):
    """On a host without huggingface_hub (the GPU machine) the mirror
    rung still runs the loader under HF_ENDPOINT."""
    import sys
    for name in ("huggingface_hub", "huggingface_hub.constants",
                 "huggingface_hub.file_download"):
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.delenv("HF_ENDPOINT", raising=False)
    loader, calls = _recorder((1, 2))
    assert pml.resolve_checkpoint("org/x", loader=loader)["call"] == 3
    assert calls[-1][2] == "https://hf-mirror.com"
    assert "HF_ENDPOINT" not in os.environ
