"""Encoder attention: the port's plain version vs the Pallas kernel (in
interpret mode, as tests/test_pallas_attention.py runs it), CPU dispatch,
and the CUDA kernel vs the plain version on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisperjav_tpu.models.whisper.model import attention as jax_attention
from whisperjav_tpu_torch.ops.cuda.encoder_attention import (
    attention, encoder_attention,
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


def _rand(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


@pytest.mark.parametrize("t", [256, 1500])
def test_plain_matches_pallas_kernel(t):
    from jax.experimental.pallas import tpu as pltpu
    from whisperjav_tpu.ops.pallas import attention as pa

    q, k, v = (_rand((2, t, 4, 64), s) for s in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pa.encoder_attention(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v)))
    out = attention(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    assert out.shape == ref.shape
    # the tolerance of the JAX package's own kernel test
    np.testing.assert_allclose(out, ref, atol=2e-3)


def test_plain_with_bias_matches_jax():
    q, k, v = (_rand((2, 5, 4, 16), s) for s in range(3))
    bias = np.where(np.arange(9)[None, :] <= np.arange(5)[:, None] + 4,
                    0.0, -np.inf).astype(np.float32)[None, None]
    k9, v9 = _rand((2, 9, 4, 16), 7), _rand((2, 9, 4, 16), 8)
    ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k9),
                                   jnp.asarray(v9), jnp.asarray(bias)))
    out = attention(torch.from_numpy(q), torch.from_numpy(k9),
                    torch.from_numpy(v9), torch.from_numpy(bias)).numpy()
    # f32 on both sides; only the order of the sums differs
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_wrapper_runs_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(_rand((2, 70, 3, 64), s)) for s in range(3))
    before = encoder_attention.launches
    out = encoder_attention(q, k, v)
    assert encoder_attention.launches == before
    torch.testing.assert_close(out, attention(q, k, v), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 200, 4, 64), (2, 1500, 3, 64)])
def test_kernel_matches_plain_on_gpu(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k = ((torch.randn(shape, generator=g, device=cuda_device) * 3)
            .bfloat16() for _ in range(2))
    v = torch.randn(shape, generator=g, device=cuda_device).bfloat16()
    before = encoder_attention.launches
    out = encoder_attention(q, k, v)
    torch.cuda.synchronize()
    assert encoder_attention.launches == before + 1
    ref = attention(q, k, v).float()
    err = (out.float() - ref).abs()
    # probabilities and output round to bf16 at other points than in the
    # plain version: two bf16 steps at the output's largest magnitude
    assert err.max().item() <= ref.abs().max().item() / 64
    assert err.mean().item() <= 2e-3
