"""The Qwen3 decode step's column attention
(``ops/cuda/qwen_attention.py``): the plain version against a softmax
written here, head by head in float64, over the cache's [0, pos) and the
new column; CPU tensors to the plain version, any other device to the
kernel or an error; ``lm_step``'s single steps against its prefill form
and ``generate``'s tokens with the step's attention taken in that form;
the decode loop's ``start`` and ``kernel_layers`` counters; and, on a
card, the kernel against the plain version."""

import math

import pytest
import torch

from whisperjav_tpu_torch.models.qwen import model as qm
from whisperjav_tpu_torch.models.qwen.weights import init_params
from whisperjav_tpu_torch.ops.cuda import qwen_attention as qa
from whisperjav_tpu_torch.utils import tracer

CFG = qm.QWEN_SIZES["qwen3-asr-test"]
# plain f32 against float64: sums of 32-128 products and a softmax over
# up to 37 positions
F32_REL = 1e-5
# plain bf16 (the scaled q, the logits, the weights and each product
# rounded to bf16) against float64 on the same bf16 inputs: four bf16
# steps at the output's largest magnitude
BF16_STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(b, t_max, nkv, hd, dtype, seed, device="cpu", layers=3,
              rep=2):
    g = torch.Generator().manual_seed(seed)
    nh = rep * nkv

    def draw(*shape):
        return torch.randn(*shape, generator=g).to(device=device,
                                                   dtype=dtype)
    return (draw(b, 1, nh, hd), draw(layers, b, t_max, nkv * hd),
            draw(layers, b, t_max, nkv * hd), draw(b, nkv * hd),
            draw(b, nkv * hd))


def _reference(q, ck, cv, layer, pos, kn, vn):
    """Each query head's float64 softmax over its group's keys [0, pos)
    and the new key, the weighted sum of the values."""
    b, _, nh, hd = q.shape
    rep = nh // (ck.shape[-1] // hd)
    out = torch.empty(b, 1, nh, hd, dtype=torch.float64)
    for row in range(b):
        for h in range(nh):
            cols = slice(h // rep * hd, (h // rep + 1) * hd)
            keys = torch.cat([ck[layer, row, :pos, cols],
                              kn[row, None, cols]]).double()
            vals = torch.cat([cv[layer, row, :pos, cols],
                              vn[row, None, cols]]).double()
            w = torch.softmax(keys @ q[row, 0, h].double() / math.sqrt(hd),
                              dim=0)
            out[row, 0, h] = w @ vals
    return out


def _tolerance(ref, dtype):
    top = ref.abs().max().item()
    if dtype == torch.float32:
        return F32_REL * top
    return BF16_STEPS * 2.0 ** (math.floor(math.log2(top)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,nkv", [(32, 4), (128, 2)],
                         ids=["test-widths", "hd128"])
@pytest.mark.parametrize("pos", [1, 18, 36], ids=["pos1", "mid", "last"])
@pytest.mark.parametrize("rep", [2, 4], ids=["rep2", "rep4"])
def test_plain_matches_a_softmax_over_the_filled_positions(dtype, hd, nkv,
                                                           pos, rep):
    """GQA with two query heads a group (Qwen3-0.6B, 1.7B) or four (4B,
    8B), a 37-slot cache: the output, and the cache after the step (the
    column at ``pos`` of the layer, nothing else changed)."""
    q, ck, cv, kn, vn = _operands(2, 37, nkv, hd, dtype, seed=pos, rep=rep)
    # what lies at and after pos is masked (the plain version reads it)
    ck[:, :, pos:] = 1e4
    cv[:, :, pos:] = 1e4
    want = _reference(q, ck, cv, 1, pos, kn, vn)
    k0, v0 = ck.clone(), cv.clone()
    out = qa.column_attention_plain(q, ck, cv, 1, pos, kn, vn)
    assert out.dtype == dtype and out.shape == q.shape
    err = (out.double() - want).abs().max().item()
    assert err <= _tolerance(want, dtype), err
    k0[1, :, pos], v0[1, :, pos] = kn, vn
    assert torch.equal(ck, k0) and torch.equal(cv, v0)


def test_cpu_tensors_take_the_plain_version():
    args = _operands(3, 20, 4, 32, torch.float32, seed=7)
    copies = [t.clone() for t in args]
    before = qa.column_attention.launches
    out = qa.column_attention(args[0], args[1], args[2], 2, 11, *args[3:])
    want = qa.column_attention_plain(copies[0], copies[1], copies[2], 2, 11,
                                     *copies[3:])
    assert qa.column_attention.launches == before
    assert torch.equal(out, want)
    assert torch.equal(args[1], copies[1]) and torch.equal(args[2],
                                                           copies[2])


def test_other_devices_do_not_fall_back():
    """Tensors off the CPU go to the kernel or raise; here, on no card,
    they raise."""
    q, ck, cv, kn, vn = _operands(1, 8, 4, 32, torch.float32, seed=8,
                                  device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        qa.column_attention(q, ck, cv, 0, 3, kn, vn)
    assert qa.column_attention.launches == 0


@pytest.fixture(scope="module")
def model():
    return qm.quantize_lm_weights(qm.fuse_lm_qkv(init_params(
        CFG, torch.Generator().manual_seed(5))))


def _attend_as_prefill(q, ck, cv, layer, pos, kn, vn):
    """The step's attention in ``_lm_block``'s prefill form: the column
    written into the cache, then a causal softmax over every slot. The
    decode loop hands the position over as a one-element tensor."""
    pos = int(pos)
    b, _, nh, hd = q.shape
    t_max, kvd = ck.shape[2:]
    nkv = kvd // hd
    ck[layer, :, pos] = kn.reshape(b, kvd)
    cv[layer, :, pos] = vn.reshape(b, kvd)
    bias = torch.where(torch.arange(t_max) <= pos, 0.0, float("-inf"))
    qg = (q * hd ** -0.5).reshape(b, 1, nkv, nh // nkv, hd)
    kk = ck[layer].reshape(b, t_max, nkv, hd)
    vv = cv[layer].reshape(b, t_max, nkv, hd)
    lg = torch.einsum("bqgrd,bkgd->bgrqk", qg, kk).float() + bias
    a = torch.softmax(lg, dim=-1)
    return torch.einsum("bgrqk,bkgd->bqgrd", a, vv).reshape(b, 1, nh, hd)


_attend_as_prefill.launches = 0


def test_lm_step_columns_match_the_prefill_form(model):
    """A 9-position prefill, then four single steps, against the same
    positions prefilled at once: logits and the whole cache."""
    g = torch.Generator().manual_seed(6)
    emb = torch.randn(2, 13, CFG.d_model, generator=g) * 0.5
    stepped = qm.LMCache.zeros(CFG, 2, 16, torch.float32, "cpu")
    whole = qm.LMCache.zeros(CFG, 2, 16, torch.float32, "cpu")
    with torch.inference_mode():
        out = [qm.lm_step(model, emb[:, :9], 0, stepped)[0][:, -1]]
        for p in range(9, 13):
            logits, _ = qm.lm_step(model, emb[:, p:p + 1], p, stepped)
            out.append(logits[:, 0])
        ref = qm.lm_step(model, emb, 0, whole)[0][:, 8:]
    got = torch.stack(out, dim=1)
    assert (got - ref).abs().max() <= F32_REL * ref.abs().max()
    for a, b in zip(stepped, whole):
        assert (a - b).abs().max() <= F32_REL * b.abs().max()
        assert not a[:, :, 13:].any()


def test_generate_tokens_match_the_prefill_form(model, monkeypatch):
    """Greedy generation under the repetition penalty: the same tokens
    and lengths with each step's attention in the prefill form."""
    mel = torch.randn(3, CFG.n_mels, 400, generator=torch.Generator()
                      .manual_seed(9))
    kw = dict(max_new=12, audio_len=50, repetition_penalty=1.1)
    got = qm.generate(model, mel, **kw)
    monkeypatch.setattr(qa, "column_attention", _attend_as_prefill)
    want = qm.generate(model, mel, **kw)
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.length, want.length)
    assert torch.allclose(got.avg_logprob, want.avg_logprob, atol=1e-5)


def test_the_loop_counts_kernel_layers(model):
    """``decode.loop`` carries the first generated token's position and
    the layer-steps the kernel ran, the steps replayed from a CUDA graph
    and the graphs captured: none of the last three on the CPU."""
    rec = tracer.SpanRecorder()
    with rec.span("test"):
        qm.generate_text(model, torch.tensor([[5, 6, 7, 8]]),
                         torch.tensor([4]), max_new=6)
    (loop,) = [s for s in rec.spans if s.name == "decode.loop"]
    assert loop.counters == {"steps": 6, "rows": 1, "start": 4,
                             "kernel_layers": 0, "graph_steps": 0,
                             "captures": 0}


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t_max,nkv,hd,pos,rep", [
    (2, 37, 4, 32, 0, 2), (2, 37, 4, 32, 1, 2), (3, 37, 4, 32, 36, 2),
    (1, 530, 8, 128, 401, 2), (32, 1201, 8, 128, 625, 2),
    (32, 1201, 8, 128, 1200, 2), (5, 300, 8, 128, 77, 2),
    (1, 530, 8, 128, 401, 4), (4, 300, 8, 128, 299, 4),
    (2, 37, 4, 32, 20, 4), (1, 530, 8, 128, 401, 5),
    (1, 530, 8, 128, 401, 8), (3, 37, 4, 32, 36, 1)])
def test_kernel_matches_plain(cuda_device, dtype, b, t_max, nkv, hd, pos,
                              rep):
    """The kernel against the plain version on the same card, in f32 on
    the same inputs (the bf16 kernel keeps its logits and weights in
    f32): the output within one step of its type, and the cache after
    the step equal. Query heads a KV group: 2 (Qwen3-0.6B, 1.7B), 4 (4B,
    8B), 5 (14B), 8 (32B) and 1."""
    q, ck, cv, kn, vn = _operands(b, t_max, nkv, hd, dtype, seed=pos,
                                  device=cuda_device, rep=rep)
    want = qa.column_attention_plain(q.float(), ck.float().clone(),
                                     cv.float().clone(), 1, pos, kn.float(),
                                     vn.float())
    want_k, want_v = ck.clone(), cv.clone()
    want_k[1, :, pos], want_v[1, :, pos] = kn, vn
    ck[:, :, pos + 1:] = float("nan")      # never read
    want_k[:, :, pos + 1:] = float("nan")
    before = qa.column_attention.launches
    out = qa.column_attention(q, ck, cv, 1, pos, kn, vn)
    torch.cuda.synchronize()
    assert qa.column_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    top = want.abs().max().item()
    tol = (2e-5 * top if dtype == torch.float32
           else 2.0 ** (math.floor(math.log2(top)) - 7))
    assert (out.float() - want).abs().max().item() <= tol
    assert torch.equal(ck.nan_to_num(), want_k.nan_to_num())
    assert torch.equal(cv, want_v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,rep", [(1, 2), (32, 2), (1, 4), (32, 4)],
                         ids=["b1-rep2", "b32-rep2", "b1-rep4", "b32-rep4"])
@pytest.mark.parametrize("pos", [0, 1, 31, 32, 625, 913, 1200])
def test_kernel_at_a_device_position(cuda_device, dtype, b, rep, pos):
    """The position read from device memory (one int32), at the cell's
    cache of 1,201 positions, 8 groups of 128: the grid follows T_max,
    so at B=1 the first positions leave ranks with nothing to read,
    which must add nothing; the output as the plain version's at the
    int position and the cache after the step equal."""
    t_max = 1201
    q, ck, cv, kn, vn = _operands(b, t_max, 8, 128, dtype, seed=pos,
                                  device=cuda_device, layers=2, rep=rep)
    want = qa.column_attention_plain(q.float(), ck.float().clone(),
                                     cv.float().clone(), 1, pos, kn.float(),
                                     vn.float())
    want_k, want_v = ck.clone(), cv.clone()
    want_k[1, :, pos], want_v[1, :, pos] = kn, vn
    at = torch.full((1,), pos, dtype=torch.int32, device=cuda_device)
    out = qa.column_attention(q, ck, cv, 1, at, kn, vn)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.isfinite(out).all()
    top = want.abs().max().item()
    tol = (2e-5 * top if dtype == torch.float32
           else 2.0 ** (math.floor(math.log2(top)) - 7))
    assert (out.float() - want).abs().max().item() <= tol
    assert torch.equal(ck, want_k) and torch.equal(cv, want_v)
