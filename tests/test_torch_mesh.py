"""Data-parallel decoding over a device mesh (``parallel/mesh.py``, the
engine's ``mesh``, ``build_pipeline(devices=, mesh=)``) against the JAX
package's mesh, and the port's mesh sizes against each other (tiny model,
f32 on the CPU: the replicas are CPU devices, each driven from a host
thread of its own).

The JAX engine shards over 2 of the 8 virtual CPU devices that
``conftest.py`` forces; its sampled rungs draw gumbel noise inside the
decode program, which the port is fed through ``engine.gumbel_source``
(the noise a JAX decode draws from ``PRNGKey(seed)``: split once a step,
gumbel of the whole batch from the subkey)."""

import json
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from whisperjav_tpu.config.presets import resolve_pipeline_config
from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.models.whisper.model import init_params
from whisperjav_tpu.modules.media_discovery import probe
from whisperjav_tpu.modules.sanitize import SRTPostProcessor
from whisperjav_tpu_torch.config.presets import (
    resolve_pipeline_config as t_resolve,
)
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax
from whisperjav_tpu_torch.modules.media_discovery import probe as torch_probe
from whisperjav_tpu_torch.modules.sanitize import (
    SRTPostProcessor as TorchSRTPostProcessor,
)
from whisperjav_tpu_torch.parallel.batching import Window
from whisperjav_tpu_torch.parallel.mesh import (
    DevicesConflict, Mesh, make_mesh, mesh_for, padded_batch,
)
from whisperjav_tpu_torch.pipelines import engine as te
from whisperjav_tpu_torch.pipelines import factory as tfactory
from test_torch_logging import keep_package_logger  # noqa: F401 (autouse)
from test_torch_pipeline_e2e import _wav

_DIMS = dict(name="torch-mesh-tiny", n_mels=128, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51866)
TINY = WhisperConfig(**_DIMS)          # the JAX package's
TTINY = TorchWhisperConfig(**_DIMS)    # the port's
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors, many ops: one intra-op thread a replica avoids
    oversubscribing the CPU when the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return init_params(TINY, jax.random.PRNGKey(11))


def _model(params):
    return params_from_jax(jax.tree.map(np.asarray, params), TTINY)


def cpu_mesh(n: int) -> Mesh:
    return make_mesh(devices=["cpu"] * n)


# ------------------------------------------------------------------ the mesh

def test_make_mesh_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert make_mesh().devices == (torch.device("cpu"),)
    assert make_mesh(4).devices == (torch.device("cpu"),)
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh.size == 2
    with pytest.raises(ValueError, match="at least one device"):
        make_mesh(devices=[])


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_row_blocks_are_the_jax_data_shards(n):
    """Device k's block is the slice ``P("data")`` gives the k-th device
    of a JAX mesh over the same number of devices."""
    rows = 16
    jmesh = JMesh(np.array(jax.devices()[:n]), ("data",))
    index = NamedSharding(jmesh, P("data")).devices_indices_map((rows,))
    want = [index[d][0] for d in jmesh.devices.flat]
    assert cpu_mesh(n).blocks(rows) == [slice(s.start or 0, s.stop or rows)
                                        for s in want]


def test_row_blocks_refuse_an_uneven_batch():
    with pytest.raises(ValueError, match="does not split"):
        cpu_mesh(3).blocks(8)


def _four_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


@pytest.mark.parametrize("device,devices", [
    ("cpu", None), ("cpu", 4), ("cuda", None), ("cuda", 1), ("cuda:0", 1),
    ("cuda:1", None),
])
def test_mesh_for_one_device(device, devices, monkeypatch):
    """One device by default, also with four cards visible: the mesh is
    opt-in."""
    _four_cards(monkeypatch)
    assert mesh_for(device, devices) is None


@pytest.mark.parametrize("devices,want", [(2, 2), (4, 4), (8, 4)])
def test_mesh_for_takes_the_first_cards_asked_for(devices, want,
                                                   monkeypatch):
    _four_cards(monkeypatch)
    assert mesh_for("cuda", devices).devices == tuple(
        torch.device(f"cuda:{k}") for k in range(want))


def test_mesh_for_refuses_devices_with_an_indexed_card():
    with pytest.raises(DevicesConflict, match="--device cuda:1"):
        mesh_for("cuda:1", 2)


# ----------------------------------------------------------- batch padding

def _jax_factory_batch(batch_size, n, params):
    from whisperjav_tpu.pipelines.factory import build_pipeline
    cfg = resolve_pipeline_config(mode="balanced", sensitivity="balanced",
                                  batch_size=batch_size)
    pipe = build_pipeline(cfg, model_config=TINY, params=params, devices=n)
    assert pipe.engine.mesh.devices.size == n
    return cfg.batch_size


def _port_factory_batch(batch_size, n, params, monkeypatch):
    monkeypatch.setattr(tfactory, "load_model",
                        lambda *a, **k: (TTINY, _model(params)))
    cfg = t_resolve(mode="balanced", sensitivity="balanced",
                    batch_size=batch_size)
    pipe = tfactory.build_pipeline(cfg, device="cpu", mesh=cpu_mesh(n))
    assert pipe.engine.mesh.size == n and pipe.engine.batch_size == \
        cfg.batch_size
    return cfg.batch_size


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.mark.parametrize("batch_size,n,want", [(32, 3, 33), (4, 3, 6),
                                                (8, 8, 8)])
def test_batch_padding_matches_the_jax_factory(batch_size, n, want, params,
                                               monkeypatch):
    """The global batch rounds up to a multiple of the mesh, with the JAX
    factory's log line (both packages log to one logger name)."""
    lines = _Lines()
    log = logging.getLogger("whisperjav_tpu")
    log.addHandler(lines)
    try:
        ref = _jax_factory_batch(batch_size, n, params)
        jax_lines = [m for m in lines.lines if "data-parallel" in m]
        lines.lines.clear()
        out = _port_factory_batch(batch_size, n, params, monkeypatch)
        port_lines = [m for m in lines.lines if "data-parallel" in m]
    finally:
        log.removeHandler(lines)
    assert ref == out == want == padded_batch(batch_size, n)
    assert port_lines == jax_lines and len(jax_lines) == 1


# ------------------------------------------------ the engine over a mesh

def _jax_gumbel_source(seed, rows, vocab, device):
    """The noise the JAX decode loop draws from PRNGKey(seed) for a
    ``rows``-row batch: split once a step, gumbel from the subkey."""
    state = {"key": jax.random.PRNGKey(seed), "noise": []}

    def noise(step):
        while len(state["noise"]) <= step:
            state["key"], sub = jax.random.split(state["key"])
            state["noise"].append(torch.from_numpy(np.array(
                jax.random.gumbel(sub, (rows, vocab), jnp.float32))))
        return state["noise"][step]
    return noise




def _settings(ladder):
    cfg = t_resolve(mode="balanced", sensitivity="balanced")
    sens = cfg.sensitivity
    options = dict(repetition_penalty=sens.repetition_penalty,
                   no_repeat_ngram_size=sens.no_repeat_ngram_size,
                   beam_size=sens.beam_size, patience=sens.patience,
                   best_of=sens.best_of, cross_kv_int8=True,
                   max_new_tokens=64)
    gates = dict(logprob_threshold=sens.logprob_threshold,
                 no_speech_threshold=sens.no_speech_threshold,
                 temperatures=ladder)
    vad = {"threshold": sens.vad_threshold,
           "max_group_duration_s": sens.max_group_duration_s}
    return options, gates, vad


def _port_run(params, wav, out_dir, mesh, ladder, batch_size=4,
              word_timestamps=False):
    from whisperjav_tpu_torch.models.whisper import decode as td
    from whisperjav_tpu_torch.pipelines.transcribe import TranscribePipeline
    options, gates, vad = _settings(ladder)
    engine = te.TranscriptionEngine(
        TTINY, _model(params), options=td.DecodeOptions(**options),
        thresholds=te.QualityThresholds(**gates), batch_size=batch_size,
        device="cpu", compute_dtype=torch.float32, mesh=mesh,
        word_timestamps=word_timestamps)
    return TranscribePipeline(engine, vad_backend="silero", vad_kwargs=vad,
                              postprocessor=TorchSRTPostProcessor(),
                              keep_intermediates=True).process(
        torch_probe(wav), out_dir)


def _jax_run(params, wav, out_dir, n, ladder):
    from whisperjav_tpu.models.whisper import decode as jd
    from whisperjav_tpu.pipelines import engine as je
    from whisperjav_tpu.pipelines.transcribe import TranscribePipeline
    options, gates, vad = _settings(ladder)
    engine = je.TranscriptionEngine(
        TINY, params, options=jd.DecodeOptions(**options),
        thresholds=je.QualityThresholds(**gates), batch_size=4,
        mesh=JMesh(np.array(jax.devices()[:n]), ("data",)),
        compute_dtype=jnp.float32)
    return TranscribePipeline(engine, vad_backend="silero", vad_kwargs=vad,
                              postprocessor=SRTPostProcessor(),
                              keep_intermediates=True).process(
        probe(wav), out_dir)


SRTS = ("clip.ja.whisperjav.raw.srt", "clip.ja.whisperjav.srt")


def _diag(out_dir):
    return json.loads((out_dir / "clip.transcribe.json").read_text())[
        "windows"]


@pytest.mark.parametrize("ladder", [(0.0,), (0.0, 0.4, 0.8)],
                         ids=["beam", "sampled-rungs"])
def test_port_mesh_writes_the_jax_mesh_srt(tmp_path, params, monkeypatch,
                                           ladder):
    """Two CPU replicas against the JAX engine over two CPU devices: the
    SRT before and after the sanitizer and the window diagnostics, byte
    for byte. With the ladder, every random-weight row fails the gates
    and is retried at 0.4 and 0.8 (best of 2), from the JAX noise."""
    sources = []

    def source(seed, rows, vocab, device):
        sources.append(seed)
        return _jax_gumbel_source(seed, rows, vocab, device)
    monkeypatch.setattr(te, "gumbel_source", source)
    wav = _wav(tmp_path)
    ref = _jax_run(params, wav, tmp_path / "jax", 2, ladder)
    out = _port_run(params, wav, tmp_path / "torch", cpu_mesh(2), ladder)
    # each sampled draw (best of 2 at each rung run) on both replicas,
    # seeded as one device seeds it
    if len(ladder) == 1:
        assert not sources
    else:
        assert len(sources) >= 4
        assert all(sources.count(seed) == 2 for seed in sources)
    assert ref.metadata["stats"]["windows"] >= 2
    assert ref.metadata["stats"]["raw_subtitles"] >= 2
    for key in ("windows", "groups", "raw_subtitles", "final_subtitles"):
        assert out.metadata["stats"][key] == ref.metadata["stats"][key], key
    for name in (*SRTS, "clip.transcribe.json"):
        assert (tmp_path / "torch" / name).read_text(encoding="utf-8") == \
            (tmp_path / "jax" / name).read_text(encoding="utf-8"), name
    assert any(w["segments"] for w in _diag(tmp_path / "jax"))


def test_port_mesh_sizes_agree(tmp_path, params):
    """One, two and three CPU replicas at batch 6 (the ladder's sampled
    rungs from the port's own noise): the same SRTs and the same window
    diagnostics, byte for byte."""
    wav = _wav(tmp_path)
    for n in (1, 2, 3):
        _port_run(params, wav, tmp_path / f"n{n}", cpu_mesh(n),
                  (0.0, 0.4, 0.8), batch_size=6)
    for name in (*SRTS, "clip.transcribe.json"):
        texts = {(tmp_path / f"n{n}" / name).read_text(encoding="utf-8")
                 for n in (1, 2, 3)}
        assert len(texts) == 1, name


def _engine(params, n, batch_size=4, **kw):
    from whisperjav_tpu_torch.models.whisper import decode as td
    options, gates, _ = _settings((0.0, 0.4))
    return te.TranscriptionEngine(
        TTINY, _model(params), options=td.DecodeOptions(**options),
        thresholds=te.QualityThresholds(**gates), batch_size=batch_size,
        device="cpu", compute_dtype=torch.float32, mesh=cpu_mesh(n), **kw)


def _audio(rows=4):
    rng = np.random.default_rng(3)
    audio = np.zeros((rows, 480000), np.float32)
    for r in range(rows):
        audio[r, :SR * (3 + 2 * r)] = 0.2 * rng.standard_normal(
            SR * (3 + 2 * r))
    return audio


def _same_rows(a, b):
    """Tokens and lengths equal; the f32 logprob sums within 1e-6 of
    their size (a BLAS may order a row's sums by the batch's row
    count, and a replica holds half the rows)."""
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.length, b.length)
    for x, y in zip(a[2:], b[2:]):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=0)


@pytest.mark.parametrize("temperature", [0.0, 0.6])
def test_a_rows_decode_does_not_depend_on_the_mesh(params, temperature):
    """The beam rung and a sampled best-of-2 rung over one and two
    replicas: the same tokens for every row; over two, the encoder
    states stay on their shards."""
    audio = _audio()
    one, two = _engine(params, 1), _engine(params, 2)
    xa1 = one.encode_batch(audio, max_duration=11.0)
    xa2 = two.encode_batch(audio, max_duration=11.0)
    assert isinstance(xa1, te.ShardedStates) and len(xa1) == 1
    assert isinstance(xa2, te.ShardedStates) and len(xa2) == 2
    assert xa2.shape == xa1.shape == (4, 960, 64)
    np.testing.assert_array_equal(torch.cat(list(xa2)).numpy(),
                                  xa1[0].numpy())
    a = one.decode_encoded(xa1, temperature, seed=5)
    _same_rows(a, two.decode_encoded(xa2, temperature, seed=5))
    with pytest.raises(ValueError, match="1 block"):
        two.decode_encoded(xa1, temperature, seed=5)


def test_word_alignment_follows_the_shards(params):
    """Word timestamps over two replicas: each row aligned on the shard
    that holds its encoder states, with one replica's bounds."""
    wins = [Window(a[:SR * (3 + 2 * r)], 0.0, 3.0 + 2 * r, 0, r)
            for r, a in enumerate(_audio())]

    def run(n):
        eng = _engine(params, n, word_timestamps=True)
        eng.thresholds = te.QualityThresholds(logprob_threshold=-100.0,
                                              temperatures=(0.0,))
        return [[(s.start, s.end, tuple(s.tokens)) for s in segs]
                for _, segs in eng.transcribe_windows(wins, seed=1)]
    one = run(1)
    assert any(one)
    assert run(2) == one


def test_replicas_are_prepared_once_and_copied(params):
    """int8 weights and a vocabulary slice: every replica holds the same
    tensors (its own copies), and the same ids."""
    from whisperjav_tpu_torch.models.whisper.vocab_subset import (
        synthetic_text_ids,
    )
    eng = _engine(params, 3, batch_size=6, int8_weights=True,
                  vocab_subset=synthetic_text_ids(TTINY, 512))
    first = eng._shards[0]
    assert first.model is eng.model and first.device == eng.device
    ref = first.model.state_dict()
    for shard in eng._shards[1:]:
        assert shard.model is not first.model
        got = shard.model.state_dict()
        assert got.keys() == ref.keys()
        for name, t in ref.items():
            assert got[name].data_ptr() != t.data_ptr(), name
            torch.testing.assert_close(got[name], t, rtol=0, atol=0)
        assert torch.equal(shard.sub_ids, first.sub_ids)
    assert hasattr(first.model.decoder, "lm_head_q")


def test_engine_refuses_a_batch_the_mesh_does_not_split(params):
    with pytest.raises(ValueError, match="does not split"):
        te.TranscriptionEngine(TTINY, _model(params), batch_size=4,
                               device="cpu", mesh=cpu_mesh(3))


def test_launch_counts_stay_exact_under_threads():
    """The kernel wrappers' counts (``_build.count``) from more threads
    than cores, the interpreter switching threads every microsecond and
    the count's read handing the lock to another thread before its
    write: no update is lost."""
    import os
    import sys
    import threading
    import time
    from whisperjav_tpu_torch.ops.cuda import _build

    class Counter:
        def __init__(self):
            self.n = 0

        @property
        def launches(self):
            n = self.n
            time.sleep(0)          # another thread runs mid-update
            return n

        @launches.setter
        def launches(self, value):
            self.n = value

    counter = Counter()
    n_threads, each = 2 * (os.cpu_count() or 1) + 2, 300

    def work():
        for _ in range(each):
            _build.count(counter)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counter.launches == n_threads * each
