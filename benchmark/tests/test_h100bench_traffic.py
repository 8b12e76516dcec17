"""The traffic generator repeats exactly for a seed, gives every seed
the same work, and packs and batches as the port does."""

import json

import numpy as np
import pytest

from h100bench import spec, traffic

MIXES = spec.names("traffic")
# the mixes of the cells Whisper's driver serves: windows of 30 s at most
WHISPER_MIXES = sorted({
    w["traffic"] for w in json.loads(
        (spec.ROOT.parent / "BENCHMARK.json").read_text())["workloads"]
    if spec.config(w["config"])["driver"] == "whisper"})


def _small(name):
    t = dict(spec.traffic(name))
    t.update(track_s=60, variants=2)
    return t


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_files(name):
    a, b = traffic.Pool(_small(name), 2 ** 31 + 11), \
        traffic.Pool(_small(name), 2 ** 31 + 11)
    for index in (0, 1, 5):
        fa, fb = a.file(index), b.file(index)
        assert [s for s, _ in fa] == [s for s, _ in fb]
        assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(fa, fb))


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_and_file_carries_the_same_work(name):
    t = _small(name)
    pools = [traffic.Pool(t, s) for s in (1, 2 ** 31 + 3)]
    want = sorted(s.duration for s in traffic.layout(t))
    for pool in pools:
        for index in (0, 3):
            pairs = pool.file(index)
            assert sorted(s.duration for s, _ in pairs) == want
            assert all(len(a) == s.samples for s, a in pairs)
    a, b = (p.file(1) for p in pools)
    assert not all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert pools[0].source_s == pools[1].source_s > 0


@pytest.mark.parametrize("name", WHISPER_MIXES)
def test_windows_fit_whisper(name):
    for slot in traffic.layout(spec.traffic(name)):
        assert 0 < slot.samples <= traffic.N_SAMPLES
        assert slot.source_s <= slot.duration + 1e-9


def test_packing_is_the_ports():
    from whisperjav_tpu_torch.parallel.batching import Window, pack_windows
    t = spec.traffic("packed-dialogue")
    rng = np.random.default_rng(int(t["layout_seed"]))
    lo, hi = t["group_s"]
    n = int(t["windows_per_file"])
    per = max(1, int(t["max_window_s"] // lo))
    lens = (rng.uniform(lo, hi, n * per + 1) * traffic.SR).astype(int)
    groups = [Window(np.zeros(g, np.float32), 0.0, g / traffic.SR, 0, i)
              for i, g in enumerate(lens)]
    packed = pack_windows(groups, traffic.SR, t["max_window_s"], t["gap_s"])
    ours = traffic.layout(t)
    assert [len(w.audio) for w in packed[:n]] == [s.samples for s in ours]
    assert [len(w.members) or 1 for w in packed[:n]] == [
        len(s.groups) for s in ours]


@pytest.mark.parametrize("name", WHISPER_MIXES)
def test_batches_are_the_engines(name):
    from whisperjav_tpu_torch.parallel.batching import Window, batch_windows
    pool = traffic.Pool(_small(name), 7)
    pairs = pool.file(2)
    wins = [Window(a, 0.0, s.duration, 0, i)
            for i, (s, a) in enumerate(pairs)]
    ours = traffic.batch_rows([w.duration for w in wins], 32)
    theirs = [[w.group_idx for w in b.windows]
              for b in batch_windows(wins, 32)]
    assert ours == theirs
