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
    decode_cross_attention, decode_cross_attention_bf16,
    decode_cross_attention_bf16_plain, decode_cross_attention_plain,
    decode_cross_attention_terms, decode_cross_attention_terms_plain,
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


def _fold_q(q, ks, layer):
    """q (B*g, Tq, H, hd) folded as ``cross_attention`` does: (B, g*Tq, H,
    hd) f32 times hd^-0.5 and k_scale."""
    bg, tq, h, hd = q.shape
    b = ks.shape[1]
    return (torch.from_numpy(q).reshape(b, bg // b * tq, h, hd) * hd ** -0.5
            * torch.from_numpy(ks[layer]).reshape(b, 1, h, 1)).contiguous()


@pytest.mark.parametrize("g,q_len", [(1, 1), (1, 3), (2, 1), (2, 3)])
def test_scaled_forms_plain_match_jax_cross_attention(g, q_len):
    """The bf16 and terms forms of Kernel B's plain version against the
    JAX ``cross_attention`` (f32, v_scale applied): the beam fold g, a step
    (q_len 1) and a prefill (q_len 3)."""
    l, b, h, hd, t = 2, 2, 4, 64, 448
    k8, ks = _int8_kv((l, b, h, hd, t), 11 + g)
    v8, vs = _int8_kv((l, b, h, hd, t), 13 + q_len)
    q = np.random.default_rng(15).standard_normal(
        (b * g, q_len, h, hd)).astype(np.float32)
    kt, vt, vst = (torch.from_numpy(x) for x in (k8, v8, vs))
    for layer in range(l):
        ref = np.asarray(jm.cross_attention(
            jnp.asarray(q), jnp.asarray(k8[layer]), jnp.asarray(v8[layer]),
            jnp.asarray(ks[layer]), jnp.asarray(vs[layer])))
        qf = _fold_q(q, ks, layer)
        y = (decode_cross_attention_plain(qf, kt, vt, layer)
             * vst[layer].reshape(b, 1, h, 1))
        out = decode_cross_attention_bf16_plain(qf, kt, vt, layer, vst)
        hi, lo = decode_cross_attention_terms_plain(qf, kt, vt, layer, vst)
        for o in (out, hi, lo):
            assert o.dtype == torch.bfloat16 and o.shape == (b, g * q_len,
                                                             h, hd)
        # bf16 form: y rounded once
        assert torch.equal(out, y.to(torch.bfloat16))
        # terms: hi + lo within 2^-16 of y, relative, element by element
        sum_ = hi.float() + lo.float()
        assert ((sum_ - y).abs() <= 2.0 ** -16 * y.abs()).all()
        # against JAX: the f32 fold tolerance (k_scale multiplies q here
        # and the logits there), plus one bf16 rounding for the bf16 form
        shaped = lambda x: x.reshape(b * g, q_len, h, hd).numpy()  # noqa
        np.testing.assert_allclose(shaped(sum_), ref, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(shaped(out.float()), ref, atol=1e-5,
                                   rtol=1e-4 + 2.0 ** -8)


def test_scaled_wrappers_run_plain_versions_on_cpu():
    k8, _ = _int8_kv((2, 2, 3, 64, 37), 17)
    v8, vs = _int8_kv((2, 2, 3, 64, 37), 18)
    kt, vt, vst = (torch.from_numpy(x) for x in (k8, v8, vs))
    q = torch.randn(2, 3, 3, 64, generator=torch.Generator().manual_seed(1))
    before = (decode_cross_attention_bf16.launches,
              decode_cross_attention_terms.launches)
    torch.testing.assert_close(
        decode_cross_attention_bf16(q, kt, vt, 1, vst),
        decode_cross_attention_bf16_plain(q, kt, vt, 1, vst), rtol=0, atol=0)
    for o, r in zip(decode_cross_attention_terms(q, kt, vt, 0, vst),
                    decode_cross_attention_terms_plain(q, kt, vt, 0, vst)):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    assert (decode_cross_attention_bf16.launches,
            decode_cross_attention_terms.launches) == before


def test_bf16_cross_attention_is_the_bf16_form():
    """``cross_attention`` on bf16 queries returns the bf16 form, which
    is the f32 output times v_scale rounded once, as before the form
    existed."""
    l, b, g, h, hd, t = 2, 2, 2, 4, 64, 448
    k8, ks = _int8_kv((l, b, h, hd, t), 19)
    v8, vs = _int8_kv((l, b, h, hd, t), 20)
    q = torch.randn(b * g, 1, h, hd,
                    generator=torch.Generator().manual_seed(2)).bfloat16()
    cross = tm.CrossKV(*(torch.from_numpy(x) for x in (k8, v8, ks, vs)))
    out = tm.cross_attention(q, cross, 1)
    qf = (q.reshape(b, g, h, hd).float() * (hd ** -0.25) * (hd ** -0.25)
          * cross.k_scale[1].reshape(b, 1, h, 1)).contiguous()
    ref = (decode_cross_attention_plain(qf, cross.k, cross.v, 1)
           * cross.v_scale[1].reshape(b, 1, h, 1)).bfloat16()
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref.reshape(b * g, 1, h, hd))


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


def _bf16_step(ref):
    """One bf16 step at the largest magnitude of ``ref``."""
    return 2.0 ** (torch.floor(torch.log2(ref.abs().max())).item() - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [448, 1500, 37])
@pytest.mark.parametrize("rows", [1, 2, 3, 6, 9])
def test_scaled_forms_match_plain_on_gpu(cuda_device, t, rows):
    g = torch.Generator(device=cuda_device).manual_seed(t * 7 + rows)
    shape = (4, 3, 5, 64, t)
    k8, v8 = (torch.randint(-127, 128, shape, generator=g,
                            device=cuda_device, dtype=torch.int8)
              for _ in range(2))
    q = torch.randn(3, rows, 5, 64, generator=g, device=cuda_device) * 0.01
    vs = torch.rand(4, 3, 5, 1, 1, generator=g, device=cuda_device) * 0.02
    before = (decode_cross_attention_bf16.launches,
              decode_cross_attention_terms.launches)
    out = decode_cross_attention_bf16(q, k8, v8, 3, vs)
    hi, lo = decode_cross_attention_terms(q, k8, v8, 3, vs)
    torch.cuda.synchronize()
    assert (decode_cross_attention_bf16.launches,
            decode_cross_attention_terms.launches) == (before[0] + 1,
                                                       before[1] + 1)
    ref = decode_cross_attention_bf16_plain(q, k8, v8, 3, vs).float()
    rhi, rlo = decode_cross_attention_terms_plain(q, k8, v8, 3, vs)
    step = _bf16_step(ref)
    # bf16 outputs: within one bf16 step at the largest magnitude
    assert (out.float() - ref).abs().max().item() <= step
    assert (hi.float() - rhi.float()).abs().max().item() <= step
    # the terms together: the f32 tolerance plus what the terms drop
    y = rhi.float() + rlo.float()
    assert ((hi.float() + lo.float()) - y).abs().max().item() <= (
        2e-5 + 2.0 ** -16) * y.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 2, 6])
def test_kernel_is_deterministic_on_gpu(cuda_device, rows):
    """The ranks' partial logits are added in rank order: two runs give
    the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    shape = (2, 32, 20, 64, 1500)
    k8, v8 = (torch.randint(-127, 128, shape, generator=g,
                            device=cuda_device, dtype=torch.int8)
              for _ in range(2))
    q = torch.randn(32, rows, 20, 64, generator=g, device=cuda_device) * 0.01
    vs = torch.rand(2, 32, 20, generator=g, device=cuda_device) * 0.02
    first = decode_cross_attention(q, k8, v8, 1)
    terms = decode_cross_attention_terms(q, k8, v8, 1, vs)
    for _ in range(2):
        assert torch.equal(decode_cross_attention(q, k8, v8, 1), first)
        for o, r in zip(decode_cross_attention_terms(q, k8, v8, 1, vs),
                        terms):
            assert torch.equal(o, r)
