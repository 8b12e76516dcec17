"""The fused decode blocks: each plain version vs the Pallas kernel
(interpret mode) on the same int8 weights and caches, the cross block's
beam fold, CPU dispatch, and the CUDA kernels vs the plain versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisperjav_tpu.models.whisper.quant import _quantize
from whisperjav_tpu.ops.pallas import fused_decode as jfd
from whisperjav_tpu_torch.models.whisper.model import Int8
from whisperjav_tpu_torch.ops.cuda import fused_decode as tfd

L, B, D, H, T_SELF, T_CROSS = 3, 2, 256, 4, 16, 64
# f32 on both sides; sums in other orders, and the Pallas GELU's A&S erf
# (max error 1.5e-7) against erf
ATOL, RTOL = 1e-5, 1e-5


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
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _rng(seed):
    return np.random.default_rng(seed)


def _vec(seed, n, scale=0.1, base=0.0):
    return (base + scale * _rng(seed).standard_normal((L, n))).astype(
        np.float32)


def _int8_weight(seed, k, n):
    """JAX-quantised (L, k, n) weight: the JAX dict and the port's Int8."""
    w = _rng(seed).standard_normal((L, k, n)).astype(np.float32) * k ** -0.5
    jw = _quantize(jnp.asarray(w))
    return jw, Int8(*(torch.from_numpy(np.array(jw[n_])) for n_ in "qs"))


def _x(seed, rows):
    return _rng(seed).standard_normal((rows, D)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _int8_kv(seed):
    """Cross K/V (L, B, d, T) int8 and scales (L, B, H), as
    precompute_cross_kv quantises them."""
    x = _rng(seed).standard_normal((L, B, H, 64, T_CROSS)).astype(np.float32)
    s = np.abs(x).max(axis=(-2, -1), keepdims=True) / 127.0 + 1e-9
    q = np.clip(np.round(x / s), -127, 127).astype(np.int8)
    return q.reshape(L, B, D, T_CROSS), s.reshape(L, B, H).astype(np.float32)


@pytest.mark.parametrize("layer,pos", [(0, 0), (1, 7), (2, T_SELF - 1)])
def test_self_block_plain_matches_pallas(layer, pos):
    ln_s, ln_b = _vec(1, D, base=1.0), _vec(2, D)
    jqkv, tqkv = _int8_weight(3, D, 3 * D)
    jwo, two = _int8_weight(4, D, D)
    bqkv, bo = _vec(5, 3 * D), _vec(6, D)
    ck = _rng(7).standard_normal((L, B, T_SELF, D)).astype(np.float32)
    cv = _rng(8).standard_normal((L, B, T_SELF, D)).astype(np.float32)
    x = _x(9, B)
    ref = jfd.self_block_stacked(
        jnp.asarray(x), jnp.asarray(ln_s), jnp.asarray(ln_b), jqkv,
        jnp.asarray(bqkv), jwo, jnp.asarray(bo), jnp.asarray(ck),
        jnp.asarray(cv), layer, pos, H, interpret=True)
    out = tfd.self_block_plain(_t(x), _t(ln_s), _t(ln_b), tqkv, _t(bqkv),
                               two, _t(bo), _t(ck), _t(cv), layer, pos, H)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("layer", [0, 2])
def test_cross_block_plain_matches_pallas(layer):
    ln_s, ln_b = _vec(11, D, base=1.0), _vec(12, D)
    jwq, twq = _int8_weight(13, D, D)
    jwo, two = _int8_weight(14, D, D)
    bq, bo = _vec(15, D), _vec(16, D)
    ck, ks = _int8_kv(17)
    cv, vs = _int8_kv(18)
    x = _x(19, B)
    ref = jfd.cross_block_stacked(
        jnp.asarray(x), jnp.asarray(ln_s), jnp.asarray(ln_b), jwq,
        jnp.asarray(bq), jwo, jnp.asarray(bo), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(ks), jnp.asarray(vs), layer, H,
        interpret=True)
    out = tfd.cross_block_plain(_t(x), _t(ln_s), _t(ln_b), twq, _t(bq),
                                two, _t(bo), _t(ck), _t(cv), _t(ks), _t(vs),
                                layer, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("layer", [0, 2])
def test_mlp_block_plain_matches_pallas(layer):
    ln_s, ln_b = _vec(21, D, base=1.0), _vec(22, D)
    jw1, tw1 = _int8_weight(23, D, 4 * D)
    jw2, tw2 = _int8_weight(24, 4 * D, D)
    b1, b2 = _vec(25, 4 * D), _vec(26, D)
    x = _x(27, B)
    ref = jfd.mlp_block_stacked(
        jnp.asarray(x), jnp.asarray(ln_s), jnp.asarray(ln_b), jw1,
        jnp.asarray(b1), jw2, jnp.asarray(b2), layer, interpret=True)
    out = tfd.mlp_block_plain(_t(x), _t(ln_s), _t(ln_b), tw1, _t(b1), tw2,
                              _t(b2), layer)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def _cross_args(seed, rows):
    """Cross-block operands as torch tensors, x with ``rows`` rows."""
    ck, ks = _int8_kv(seed)
    cv, vs = _int8_kv(seed + 1)
    return dict(
        x=_t(_x(seed + 2, rows)), ln_s=_t(_vec(seed + 3, D, base=1.0)),
        ln_b=_t(_vec(seed + 4, D)), cwq=_int8_weight(seed + 5, D, D)[1],
        cbq=_t(_vec(seed + 6, D)), cwo=_int8_weight(seed + 7, D, D)[1],
        cbo=_t(_vec(seed + 8, D)), ck=_t(ck), cv=_t(cv), k_scale=_t(ks),
        v_scale=_t(vs))


@pytest.mark.parametrize("layer", [0, 1])
def test_cross_block_fold_equals_repeated_rows(layer):
    """g=2 query rows per cross-K/V row (row r reads K/V row r // 2) give
    what g=1 gives on K/V with each row repeated twice."""
    args = _cross_args(30, 2 * B)
    folded = tfd.cross_block_plain(**args, layer=layer, n_head=H)
    rep = dict(args)
    for name in ("ck", "cv", "k_scale", "v_scale"):
        rep[name] = args[name].repeat_interleave(2, dim=1).contiguous()
    ref = tfd.cross_block_plain(**rep, layer=layer, n_head=H)
    torch.testing.assert_close(folded, ref, rtol=0, atol=1e-6)


def test_wrappers_run_plain_versions_on_cpu():
    args = _cross_args(40, 2 * B)
    before = (tfd.self_block.launches, tfd.cross_block.launches,
              tfd.mlp_block.launches)
    out = tfd.cross_block(**args, layer=1, n_head=H)
    torch.testing.assert_close(
        out, tfd.cross_block_plain(**args, layer=1, n_head=H), rtol=0,
        atol=0)
    w1, w2 = _int8_weight(41, D, 4 * D)[1], _int8_weight(42, 4 * D, D)[1]
    mlp = dict(x=args["x"], ln_s=args["ln_s"], ln_b=args["ln_b"], w1=w1,
               b1=_t(_vec(43, 4 * D)), w2=w2, b2=args["cbo"], layer=2)
    torch.testing.assert_close(tfd.mlp_block(**mlp),
                               tfd.mlp_block_plain(**mlp), rtol=0, atol=0)
    cache = _t(_rng(44).standard_normal((L, 2 * B, T_SELF, D)).astype(
        np.float32))
    slf = dict(x=args["x"], ln_s=args["ln_s"], ln_b=args["ln_b"],
               wqkv=_int8_weight(45, D, 3 * D)[1], bqkv=_t(_vec(46, 3 * D)),
               wo=args["cwo"], bo=args["cbo"], cache_k=cache,
               cache_v=cache.flip(0).contiguous(), layer=0, pos=3, n_head=H)
    for o, r in zip(tfd.self_block(**slf), tfd.self_block_plain(**slf)):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    assert (tfd.self_block.launches, tfd.cross_block.launches,
            tfd.mlp_block.launches) == before


def test_wrapper_refuses_mixed_devices():
    args = _cross_args(50, B)
    args["x"] = args["x"].to("meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        tfd.cross_block(**args, layer=0, n_head=H)


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain versions (on the card only)
# ---------------------------------------------------------------------------

def _gpu_int8(gen, dev, k, n, n_layer):
    w = torch.randn(n_layer, k, n, generator=gen, device=dev) * k ** -0.5
    s = w.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    return Int8(torch.round(w / s).clamp(-127, 127).to(torch.int8), s)


def _assert_bf16_close(out, ref, what):
    """Within one bf16 step at the output's largest magnitude."""
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all(), what
    step = 2.0 ** (torch.floor(torch.log2(ref.abs().max())).item() - 7)
    assert (out - ref).abs().max().item() <= step, what


@pytest.mark.cuda
@pytest.mark.parametrize("rows,pos", [(32, 1), (64, 100), (64, 226)])
def test_self_block_kernel_matches_plain_on_gpu(cuda_device, rows, pos):
    dev, n_layer, d, h, t = cuda_device, 4, 1280, 20, 227
    gen = torch.Generator(device=dev).manual_seed(rows + pos)
    ln_s = 1 + 0.1 * torch.randn(n_layer, d, generator=gen, device=dev)
    args = dict(
        x=torch.randn(rows, d, generator=gen, device=dev),
        ln_s=ln_s, ln_b=0.1 * torch.randn(n_layer, d, generator=gen,
                                          device=dev),
        wqkv=_gpu_int8(gen, dev, d, 3 * d, n_layer),
        bqkv=0.1 * torch.randn(n_layer, 3 * d, generator=gen, device=dev),
        wo=_gpu_int8(gen, dev, d, d, n_layer),
        bo=0.1 * torch.randn(n_layer, d, generator=gen, device=dev),
        cache_k=torch.randn(n_layer, rows, t, d, generator=gen, device=dev),
        cache_v=torch.randn(n_layer, rows, t, d, generator=gen, device=dev),
        layer=n_layer - 1, pos=pos, n_head=h)
    for name in ("x", "ln_s", "ln_b", "bqkv", "bo", "cache_k", "cache_v"):
        args[name] = args[name].bfloat16()
    before = tfd.self_block.launches
    out = tfd.self_block(**args)
    torch.cuda.synchronize()
    assert tfd.self_block.launches == before + 1
    for o, r, what in zip(out, tfd.self_block_plain(**args),
                          ("x_out", "k_new", "v_new")):
        _assert_bf16_close(o, r, what)


@pytest.mark.cuda
@pytest.mark.parametrize("g,t", [(1, 448), (2, 1500), (2, 37)])
def test_cross_block_kernel_matches_plain_on_gpu(cuda_device, g, t):
    dev, n_layer, b, d, h = cuda_device, 4, 32, 1280, 20
    gen = torch.Generator(device=dev).manual_seed(g * 1000 + t)
    args = dict(
        x=torch.randn(b * g, d, generator=gen, device=dev).bfloat16(),
        ln_s=(1 + 0.1 * torch.randn(n_layer, d, generator=gen,
                                    device=dev)).bfloat16(),
        ln_b=(0.1 * torch.randn(n_layer, d, generator=gen,
                                device=dev)).bfloat16(),
        cwq=_gpu_int8(gen, dev, d, d, n_layer),
        cbq=(0.1 * torch.randn(n_layer, d, generator=gen,
                               device=dev)).bfloat16(),
        cwo=_gpu_int8(gen, dev, d, d, n_layer),
        cbo=(0.1 * torch.randn(n_layer, d, generator=gen,
                               device=dev)).bfloat16(),
        ck=torch.randint(-127, 128, (n_layer, b, d, t), generator=gen,
                         device=dev, dtype=torch.int8),
        cv=torch.randint(-127, 128, (n_layer, b, d, t), generator=gen,
                         device=dev, dtype=torch.int8),
        k_scale=torch.rand(n_layer, b, h, generator=gen, device=dev) * 0.02,
        v_scale=torch.rand(n_layer, b, h, generator=gen, device=dev) * 0.02,
        layer=n_layer - 1, n_head=h)
    before = tfd.cross_block.launches
    out = tfd.cross_block(**args)
    torch.cuda.synchronize()
    assert tfd.cross_block.launches == before + 1
    _assert_bf16_close(out, tfd.cross_block_plain(**args), "x_out")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 64, 5])
def test_mlp_block_kernel_matches_plain_on_gpu(cuda_device, rows):
    dev, n_layer, d = cuda_device, 4, 1280
    gen = torch.Generator(device=dev).manual_seed(rows)
    args = dict(
        x=torch.randn(rows, d, generator=gen, device=dev).bfloat16(),
        ln_s=(1 + 0.1 * torch.randn(n_layer, d, generator=gen,
                                    device=dev)).bfloat16(),
        ln_b=(0.1 * torch.randn(n_layer, d, generator=gen,
                                device=dev)).bfloat16(),
        w1=_gpu_int8(gen, dev, d, 4 * d, n_layer),
        b1=(0.1 * torch.randn(n_layer, 4 * d, generator=gen,
                              device=dev)).bfloat16(),
        w2=_gpu_int8(gen, dev, 4 * d, d, n_layer),
        b2=(0.1 * torch.randn(n_layer, d, generator=gen,
                              device=dev)).bfloat16(),
        layer=0)
    before = tfd.mlp_block.launches
    out = tfd.mlp_block(**args)
    torch.cuda.synchronize()
    assert tfd.mlp_block.launches == before + 1
    _assert_bf16_close(out, tfd.mlp_block_plain(**args), "x_out")
