"""Decode-step int8 cross-attention: the port's plain version vs the
Pallas kernel (interpret mode) and vs the JAX ``cross_attention`` beam
fold, CPU dispatch, and the CUDA kernel vs the plain version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisperjav_tpu.models.whisper import model as jm
from whisperjav_tpu.ops.pallas.decode_attention import (
    decode_cross_attention_stacked,
)
from whisperjav_tpu_torch.models.whisper import model as tm
from whisperjav_tpu_torch.ops.cuda.decode_attention import (
    decode_cross_attention, decode_cross_attention_plain,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors, many ops: one intra-op thread avoids oversubscribing
    the CPU when the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _int8_kv(shape, seed):
    """Random K/V quantised per (layer, batch, head) as the JAX package
    does; returns codes and scales (..., 1, 1)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    s = np.abs(x).max(axis=(-2, -1), keepdims=True) / 127.0 + 1e-9
    q = np.clip(np.round(x / s), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def test_plain_matches_pallas_stacked_kernel():
    from jax.experimental.pallas import tpu as pltpu
    l, b, h, hd, t = 3, 2, 4, 64, 256
    k8, _ = _int8_kv((l, b, h, hd, t), 1)
    v8, _ = _int8_kv((l, b, h, hd, t), 2)
    q = np.random.default_rng(3).standard_normal((b, h, hd)).astype(
        np.float32) * 0.01
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(decode_cross_attention_stacked(
            jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), 1,
            interpret=True))
    out = decode_cross_attention_plain(
        torch.from_numpy(q)[:, None], torch.from_numpy(k8),
        torch.from_numpy(v8), 1)[:, 0].numpy()
    # f32 on both sides over T=256 int8 values up to 127
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("q_len", [1, 3])
def test_cross_attention_fold_matches_jax(q_len):
    """g=2 beams fold onto one cross-K/V row: q_len 1 is a beam step,
    q_len 3 the beam prefill of the SOT sequence."""
    l, b, g, h, hd, t = 2, 3, 2, 4, 64, 448
    k8, ks = _int8_kv((l, b, h, hd, t), 4)
    v8, vs = _int8_kv((l, b, h, hd, t), 5)
    q = np.random.default_rng(6).standard_normal(
        (b * g, q_len, h, hd)).astype(np.float32)
    cross = tm.CrossKV(*(torch.from_numpy(x) for x in (k8, v8, ks, vs)))
    for layer in range(l):
        ref = np.asarray(jm.cross_attention(
            jnp.asarray(q), jnp.asarray(k8[layer]), jnp.asarray(v8[layer]),
            jnp.asarray(ks[layer]), jnp.asarray(vs[layer])))
        out = tm.cross_attention(torch.from_numpy(q), cross, layer).numpy()
        assert out.shape == ref.shape == (b * g, q_len, h, hd)
        # f32; k_scale multiplies q here and the logits there
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)


def test_wrapper_runs_plain_version_on_cpu():
    k8, _ = _int8_kv((2, 2, 3, 64, 37), 7)
    v8, _ = _int8_kv((2, 2, 3, 64, 37), 8)
    q = torch.randn(2, 5, 3, 64, generator=torch.Generator().manual_seed(0))
    before = decode_cross_attention.launches
    out = decode_cross_attention(q, torch.from_numpy(k8),
                                 torch.from_numpy(v8), 1)
    assert decode_cross_attention.launches == before
    ref = decode_cross_attention_plain(q, torch.from_numpy(k8),
                                       torch.from_numpy(v8), 1)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [448, 960, 1500, 37])
@pytest.mark.parametrize("rows", [1, 2, 6, 9])
def test_kernel_matches_plain_on_gpu(cuda_device, t, rows):
    g = torch.Generator(device=cuda_device).manual_seed(t * 10 + rows)
    shape = (4, 3, 5, 64, t)
    k8, v8 = (torch.randint(-127, 128, shape, generator=g,
                            device=cuda_device, dtype=torch.int8)
              for _ in range(2))
    q = torch.randn(3, rows, 5, 64, generator=g, device=cuda_device) * 0.01
    before = decode_cross_attention.launches
    out = decode_cross_attention(q, k8, v8, 2)
    torch.cuda.synchronize()
    assert decode_cross_attention.launches == before + 1
    ref = decode_cross_attention_plain(q, k8, v8, 2)
    # f32 on both sides, sums over T in different orders
    assert (out - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()
