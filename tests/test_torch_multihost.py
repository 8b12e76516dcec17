"""The port's multi-host file sharding against the JAX package's, its
rendezvous failing loudly (where the JAX one falls back to one process),
and two real CLI processes over one directory on the CPU."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from whisperjav_tpu.modules.media_discovery import MediaInfo
from whisperjav_tpu.parallel import multihost as jmh
from whisperjav_tpu_torch import cli
from whisperjav_tpu_torch.modules.audio_io import write_wav
from whisperjav_tpu_torch.modules.media_discovery import (
    MediaInfo as TorchMediaInfo,
)
from whisperjav_tpu_torch.parallel import multihost as tmh
from test_torch_logging import keep_package_logger  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
_DIST_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
             "LOCAL_RANK")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def no_dist_env(monkeypatch):
    for key in _DIST_ENV:
        monkeypatch.delenv(key, raising=False)


# ------------------------------------------------------------- sharding

_DURATIONS = [("a", 7200.0), ("b", 600.0), ("c", 660.0), ("d", 630.0),
              ("e", 640.0), ("f", 610.0)]


@pytest.mark.parametrize("case", ["durations", "some-unknown", "names",
                                  "one-process", "more-hosts-than-files"])
def test_shard_files_matches_jax(case):
    """The same slices as the JAX package for every host: LPT by audio
    seconds when every duration is known, round-robin by name otherwise."""
    def files(info):
        if case == "names":
            return [f"f{i}" for i in (3, 0, 4, 1, 2)]
        durs = list(_DURATIONS)
        if case == "some-unknown":
            durs[2] = ("c", None)
        if case == "more-hosts-than-files":
            durs = durs[:2]
        return [info(path=Path(f"/x/{n}.wav"), basename=n, duration=d)
                for n, d in durs]

    count = {"one-process": 1, "more-hosts-than-files": 3}.get(case, 2)
    seen = []
    for host in range(count):
        ours = tmh.shard_files(files(TorchMediaInfo), host, count)
        theirs = jmh.shard_files(files(MediaInfo), host, count)
        key = (lambda m: getattr(m, "basename", m))
        assert [key(m) for m in ours] == [key(m) for m in theirs]
        seen += [key(m) for m in ours]
    assert sorted(seen) == sorted(
        getattr(m, "basename", m) for m in files(TorchMediaInfo))


def test_lpt_puts_the_feature_alone():
    files = [TorchMediaInfo(path=Path(f"/x/{n}.wav"), basename=n, duration=d)
             for n, d in _DURATIONS]
    names = [{m.basename for m in tmh.shard_files(files, h, 2)}
             for h in (0, 1)]
    assert {"a"} in names and not names[0] & names[1]


# ------------------------------------------------------------ rendezvous

def test_no_coordinator_runs_alone(no_dist_env):
    assert tmh.initialize_distributed() == (0, 1)
    assert tmh.initialize_distributed("127.0.0.1:1", 1, 0) == (0, 1)


@pytest.mark.parametrize("host_id", [0, 1], ids=["server", "client"])
def test_dead_rendezvous_raises(no_dist_env, host_id):
    """A named coordinator whose partner never comes (host 0 serves and
    waits; host 1 finds no server) raises within the timeout's order,
    where the JAX package warns and returns (0, 1)."""
    import torch.distributed as dist
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rendezvous"):
        tmh.initialize_distributed(f"127.0.0.1:{_free_port()}", 2, host_id,
                                   timeout_s=1.0)
    assert time.monotonic() - t0 < 30.0
    assert not dist.is_initialized()


@pytest.mark.parametrize("argv,match", [
    (["127.0.0.1:1", None, 0], "num-hosts"),
    (["127.0.0.1:1", 2, 2], "outside"),
])
def test_bad_rendezvous_arguments_raise(no_dist_env, argv, match):
    with pytest.raises(ValueError, match=match):
        tmh.initialize_distributed(*argv)


def _wav(directory: Path, name: str, seconds: float) -> Path:
    sr = 16000
    t = np.arange(int(seconds * sr)) / sr
    x = (0.3 * np.sin(2 * np.pi * 200 * t)
         * (1 + 0.5 * np.sin(2 * np.pi * 4 * t))).astype(np.float32)
    path = directory / name
    write_wav(path, x, sr)
    return path


def test_cli_exits_nonzero_when_the_partner_never_comes(tmp_path,
                                                        monkeypatch,
                                                        no_dist_env):
    """--multihost with a rendezvous that fails exits 1 before any
    transcription; no output is written."""
    import whisperjav_tpu_torch.pipelines.factory as factory

    def boom(*a, **k):
        raise AssertionError("no model loads after a failed rendezvous")
    monkeypatch.setattr(factory, "load_model", boom)
    monkeypatch.setenv("WJAV_RENDEZVOUS_TIMEOUT_S", "1")
    _wav(tmp_path, "m0.wav", 1.0)
    out = tmp_path / "out"
    rc = cli.main([str(tmp_path), "--multihost", "--coordinator",
                   f"127.0.0.1:{_free_port()}", "--num-hosts", "2",
                   "--host-id", "0", "--device", "cpu",
                   "--output-dir", str(out)])
    assert rc == 1
    assert not out.exists() or not any(out.iterdir())


def _fake_done(out_dir: Path, stem: str) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    p = out_dir / f"{stem}.ja.whisperjav.srt"
    p.write_text("1\n00:00:00,000 --> 00:00:01,000\nfinished-before-crash\n")
    return p


def test_resume_noop_when_the_slice_is_done(tmp_path, monkeypatch):
    """A re-run over a finished slice exits 0 without loading a model or
    touching its outputs; the other host's files are not this one's."""
    import whisperjav_tpu_torch.pipelines.factory as factory
    monkeypatch.setattr(tmh, "initialize_distributed",
                        lambda *a, **k: (0, 2))

    def boom(*a, **k):
        raise AssertionError("load_model must not run on a no-op resume")
    monkeypatch.setattr(factory, "load_model", boom)
    for i in range(4):
        _wav(tmp_path, f"m{i}.wav", 1.0)
    out = tmp_path / "out"
    done = [_fake_done(out, f"m{i}") for i in (0, 2)]   # host 0's slice
    before = [p.read_text() for p in done]
    rc = cli.main([str(tmp_path), "--multihost", "--skip-existing",
                   "--device", "cpu", "--output-dir", str(out)])
    assert rc == 0
    assert [p.read_text() for p in done] == before


# ------------------------------------------- two real CLI processes

_CLI_CHILD = """
import sys
import torch
sys.path.insert(0, {repo!r})
torch.set_num_threads(1)
import whisperjav_tpu_torch.pipelines.factory as factory
from whisperjav_tpu_torch.models.whisper.config import WhisperConfig
from whisperjav_tpu_torch.models.whisper.weights import init_params
cfg = WhisperConfig(name="mh-tiny", n_audio_state=64, n_audio_head=4,
                    n_audio_layer=2, n_text_state=64, n_text_head=4,
                    n_text_layer=2)
factory.load_model = lambda *a, **k: (
    cfg, init_params(cfg, torch.Generator().manual_seed(0)))
from whisperjav_tpu_torch import cli
sys.exit(cli.main([sys.argv[3], "--multihost", "--coordinator", sys.argv[1],
                   "--num-hosts", "2", "--host-id", sys.argv[2],
                   "--skip-existing", "--device", "cpu", "--batch-size", "1",
                   "--logprob-threshold", "-100", "--output-dir",
                   sys.argv[4], "--stats-file",
                   sys.argv[4] + f"-stats{{sys.argv[2]}}.json"]))
"""


def _run_pair(script: Path, media: Path, out: Path, timeout=150):
    env = {k: v for k, v in os.environ.items() if k not in _DIST_ENV}
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, str(host), str(media),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for host in (0, 1)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def test_two_process_cli_is_disjoint_and_covering(tmp_path):
    """Two OS processes run the real CLI under one gloo control plane
    over a shared directory: each transcribes its own slice (the two
    slices disjoint and covering, by audio seconds), and a
    --skip-existing re-run of both writes nothing."""
    media = tmp_path / "media"
    media.mkdir()
    for i, seconds in enumerate((1.5, 3.0, 2.0, 2.5)):
        _wav(media, f"m{i}.wav", seconds)
    out = tmp_path / "out"
    script = tmp_path / "cli_child.py"
    script.write_text(_CLI_CHILD.format(repo=str(REPO)))
    _run_pair(script, media, out)
    srts = sorted(p.name for p in out.glob("m*.ja.whisperjav.srt"))
    assert srts == [f"m{i}.ja.whisperjav.srt" for i in range(4)]
    # each process's --stats-file lists the files it transcribed
    done = [sorted(Path(r["input"]).name for r in json.loads(
        Path(f"{out}-stats{host}.json").read_text())["results"])
        for host in (0, 1)]
    assert all(done) and not set(done[0]) & set(done[1])
    assert sorted(done[0] + done[1]) == [f"m{i}.wav" for i in range(4)]
    stamps = {p.name: p.stat().st_mtime_ns for p in out.iterdir()}
    _run_pair(script, media, out)
    assert {p.name: p.stat().st_mtime_ns for p in out.iterdir()} == stamps
