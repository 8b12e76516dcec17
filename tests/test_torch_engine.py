"""The port's TranscriptionEngine vs the JAX one: the temperature ladder
with file-wide deferred retries takes the same decisions on the same
decode results (tiny model, f32 on the CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperjav_tpu.models.whisper.config import WhisperConfig
from whisperjav_tpu.models.whisper.model import init_params
from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig as TorchWhisperConfig,
)
from whisperjav_tpu_torch.models.whisper.weights import params_from_jax

_DIMS = dict(name="torch-engine-tiny", n_mels=128, n_audio_state=64,
             n_audio_head=4, n_audio_layer=2, n_text_state=64,
             n_text_head=4, n_text_layer=2, n_vocab=51866)
TINY = WhisperConfig(**_DIMS)          # the JAX package's
TTINY = TorchWhisperConfig(**_DIMS)    # the port's
SR = 16000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors, many ops: one intra-op thread avoids oversubscribing
    the CPU when the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rigged(orig, result_cls, bumps):
    """decode_encoded whose sampled rungs are the t=0 decode with the
    first token marked by the rung and the avg logprob moved by
    ``bumps[temperature]``: the same payload for both packages, so the
    ladder's decisions (defer, adopt iff improved, exit on a passing
    gate, stop on a rung that improves nothing) can be compared."""
    def decode_encoded(self, xa, temperature=0.0, seed=0):
        res = [np.array(x) for x in orig(self, xa, 0.0, 0)]
        if temperature > 0.0:
            res[0][:, 0] = 100 + int(round(10 * temperature))
            res[3] = res[3] + bumps[temperature]
        return result_cls(*res)
    return decode_encoded


@pytest.mark.parametrize("bumps,marker", [
    ({0.4: 0.5, 0.6: 1.0, 0.8: -5.0}, 106),   # adopt, adopt, keep
    ({0.4: -1.0, 0.6: 2.0, 0.8: 2.0}, None),  # nothing improves: stop
    ({0.4: 20.0, 0.6: 30.0, 0.8: 40.0}, 104),  # rows pass at 0.4
])
def test_engine_ladder_matches_jax(monkeypatch, bumps, marker):
    from whisperjav_tpu.models.whisper import decode as jd
    from whisperjav_tpu.parallel.batching import Window as JWindow
    from whisperjav_tpu.pipelines import engine as je
    from whisperjav_tpu_torch.models.whisper import decode as td
    from whisperjav_tpu_torch.parallel.batching import Window as TWindow
    from whisperjav_tpu_torch.pipelines import engine as te

    params = init_params(TINY, jax.random.PRNGKey(2))
    model = params_from_jax(jax.tree.map(np.asarray, params), TTINY)
    temps = (0.0, 0.4, 0.6, 0.8)
    for mod, cls in ((je, jd.DecodeResult), (te, td.DecodeResult)):
        monkeypatch.setattr(mod.TranscriptionEngine, "decode_encoded",
                            _rigged(mod.TranscriptionEngine.decode_encoded,
                                    cls, bumps))
    jeng = je.TranscriptionEngine(
        TINY, params, options=jd.DecodeOptions(max_new_tokens=8,
                                               cross_kv_int8=True),
        thresholds=je.QualityThresholds(temperatures=temps), batch_size=2,
        mesh=None, compute_dtype=jnp.float32)
    teng = te.TranscriptionEngine(
        TTINY, model, options=td.DecodeOptions(max_new_tokens=8,
                                              cross_kv_int8=True),
        thresholds=te.QualityThresholds(temperatures=temps), batch_size=2,
        device="cpu", compute_dtype=torch.float32)
    rng = np.random.default_rng(7)
    audio = [(0.2 * rng.standard_normal(int(SR * d))).astype(np.float32)
             for d in (3.0, 8.0, 3.0, 12.0)]

    def run(engine, window_cls):
        wins = [window_cls(a, 0.0, len(a) / SR, 0, i)
                for i, a in enumerate(audio)]
        results = engine.transcribe_windows(wins, seed=3)
        segs = [(w.group_idx, [(tuple(s.tokens), s.start, s.end, s.text)
                               for s in ss]) for w, ss in results]
        return segs, [s.avg_logprob for _, ss in results for s in ss]

    (ref, ref_lp), (out, out_lp) = run(jeng, JWindow), run(teng, TWindow)
    assert [g for g, _ in ref] == [0, 1, 2, 3]
    assert out == ref
    # f32 logits differ in the last bits between the two packages
    np.testing.assert_allclose(out_lp, ref_lp, atol=1e-4)
    firsts = {ss[0][0][0] for _, ss in ref if ss and ss[0][0]}
    assert (marker in firsts) if marker else not (firsts & {104, 106, 108})
