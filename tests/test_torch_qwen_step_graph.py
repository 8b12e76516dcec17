"""The Qwen3 decode loop's forward from a CUDA graph
(``models/qwen/step_graph.py``).

On the CPU: the loop (its forward at a device-style int32 position,
which a graph captures on a card) against the loop with int positions
that ran before the graph, tokens, lengths and ``avg_logprob`` equal bit
for bit, greedy and sampled, through ``generate`` and ``generate_text``;
the plain column attention at a tensor position against an int one; the
rotary frequencies made once; the plans' bookkeeping. On a card: the
graph loop against the same loop run eagerly, bit for bit, with its
counters; the column kernel at a device position under one captured
launch. This file imports no JAX."""

import dataclasses

import pytest
import torch

from whisperjav_tpu_torch.models.layers import draw_gumbel
from whisperjav_tpu_torch.models.qwen import model as qm
from whisperjav_tpu_torch.models.qwen import step_graph as sg
from whisperjav_tpu_torch.models.qwen.weights import init_params
from whisperjav_tpu_torch.modules.subtitle_pipeline.components import (
    prepare_params,
)
from whisperjav_tpu_torch.ops.cuda import qwen_attention as qa
from whisperjav_tpu_torch.utils import tracer

CFG = qm.QWEN_SIZES["qwen3-asr-test"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return prepare_params(init_params(CFG, torch.Generator().manual_seed(5)))


def _decode_int_positions(model, cur, cache, start, max_new,
                          repetition_penalty, temperature, generator,
                          gumbel):
    """The decode loop as it ran before the graph: each step's forward
    through ``lm_step`` at an int position."""
    cfg = model.config
    sample = temperature != 0.0
    b, dev = cur.shape[0], cur.device
    eos = cfg.eos_id
    tokens = torch.full((b, max_new), eos, dtype=torch.long, device=dev)
    sum_lp = torch.zeros((b,), device=dev)
    length = torch.zeros((b,), dtype=torch.long, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    penalize = repetition_penalty != 1.0
    rp = torch.tensor(repetition_penalty, device=dev)
    seen = (torch.zeros((b, cfg.vocab_size), dtype=torch.bool, device=dev)
            if penalize else None)
    for step in range(max_new):
        if step and step % qm.FINISHED_CHECK_EVERY == 0 \
                and bool(finished.all()):
            break
        lg = cur
        if penalize:
            pen = torch.where(lg > 0, lg / rp, lg * rp)
            lg = torch.where(seen, pen, lg)
        if sample:
            noise = (gumbel(step) if gumbel is not None
                     else draw_gumbel(generator, lg.shape, dev))
            tok = torch.argmax(lg + temperature * noise.to(dev), dim=-1)
        else:
            tok = torch.argmax(lg, dim=-1)
        tok = torch.where(finished, eos, tok)
        lp = torch.log_softmax(lg, dim=-1)
        tok_lp = lp.gather(1, tok[:, None])[:, 0]
        is_eos = tok == eos
        sum_lp = sum_lp + torch.where(finished, 0.0, tok_lp)
        length = length + (~(finished | is_eos)).long()
        tokens[:, step] = tok
        if penalize:
            seen.scatter_(1, tok[:, None], True)
            seen[:, eos] = False
        nxt, cache = qm.lm_step(model, model.tok_emb[tok[:, None]],
                                start + step, cache)
        cur = nxt[:, 0]
        finished = finished | is_eos
    return qm.QwenGenResult(tokens, length, sum_lp / (length.float() + 1.0))


def _noise(rows, steps, seed=11):
    g = torch.Generator().manual_seed(seed)
    table = [draw_gumbel(g, (rows, CFG.vocab_size), "cpu")
             for _ in range(steps)]
    return lambda step: table[step]


def _run(model, entry, sampled):
    if entry == "generate":
        mel = torch.randn(3, CFG.n_mels, 400,
                          generator=torch.Generator().manual_seed(9))
        kw = dict(max_new=18, audio_len=50, repetition_penalty=1.1)
        if sampled:
            kw.update(temperature=0.7, gumbel=_noise(3, 18))
        return qm.generate(model, mel, **kw)
    kw = dict(max_new=14, repetition_penalty=1.05)
    if sampled:
        kw.update(temperature=0.9, gumbel=_noise(1, 14))
    return qm.generate_text(model, torch.tensor([[5, 6, 7, 8, 9, 3, 0]]),
                            torch.tensor([5]), **kw)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("entry", ["generate", "generate_text"])
def test_loop_equals_the_int_position_loop(model, monkeypatch, entry,
                                           sampled):
    got = _run(model, entry, sampled)
    monkeypatch.setattr(qm, "_decode", _decode_int_positions)
    want = _run(model, entry, sampled)
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
    assert got.length.max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 1, 36], ids=["0", "1", "t_max-1"])
def test_plain_tensor_position_equals_int(dtype, pos):
    g = torch.Generator().manual_seed(pos)
    b, t_max, nkv, hd, rep = 3, 37, 4, 32, 2

    def draw(*shape):
        return torch.randn(*shape, generator=g).to(dtype)
    q = draw(b, 1, nkv * rep, hd)
    ck, cv = draw(2, b, t_max, nkv * hd), draw(2, b, t_max, nkv * hd)
    kn, vn = draw(b, nkv * hd), draw(b, nkv * hd)
    caches = [(ck.clone(), cv.clone()) for _ in range(2)]
    out_int = qa.column_attention_plain(q, *caches[0], 1, pos, kn, vn)
    at = torch.tensor([pos], dtype=torch.int32)
    out_t = qa.column_attention(q, *caches[1], 1, at, kn, vn)
    assert torch.equal(out_int, out_t)
    assert torch.equal(caches[0][0], caches[1][0])
    assert torch.equal(caches[0][1], caches[1][1])
    assert torch.equal(caches[1][0][1, :, pos], kn)
    assert torch.equal(caches[1][0][0], ck[0])


def test_rope_frequencies_are_made_once():
    """The frequencies are made once a width, base and device (their
    making copies theta from the host); the angles at a tensor position
    equal those at an int one."""
    a = qm.rope_freqs(32, 1e6, torch.device("cpu"))
    assert qm.rope_freqs(32, 1e6, torch.device("cpu")) is a
    half = torch.arange(16, dtype=torch.float32) / 16
    assert torch.equal(a, torch.pow(torch.tensor(1e6), -half))
    cos, sin = qm.rope_angles(7 + torch.arange(1), 32, 1e6)
    cos_t, sin_t = qm.rope_angles(
        torch.tensor([7], dtype=torch.int32) + torch.arange(1), 32, 1e6)
    assert torch.equal(cos, cos_t) and torch.equal(sin, sin_t)


def test_cpu_forward_runs_eagerly(model):
    """On the CPU no plan is made and no step replays; a position outside
    the cache raises."""
    cache = qm.LMCache.zeros(CFG, 2, 9, torch.float32, "cpu")
    fwd = sg.StepForward(model, cache, qm.step_forward)
    assert fwd.plan is None and fwd.pos.dtype == torch.int32
    with torch.inference_mode():
        logits = fwd(torch.tensor([3, 4]), 0)
    assert logits.shape == (2, CFG.vocab_size)
    assert fwd.graph_steps == fwd.captures == 0
    assert cache.k[:, :, 0].abs().sum() > 0 and not cache.k[:, :, 1:].any()
    with pytest.raises(ValueError, match="outside"):
        fwd(torch.tensor([3, 4]), 9)


def test_slot_keeps_the_most_recent_plans():
    slot = sg._Slot(torch.device("cpu"))
    made = []

    def make():
        made.append(sg._Plan(None, None))
        return made[-1]
    plans = [slot.plan("w", (rows,), make) for rows in range(sg._PLANS)]
    assert slot.plan("w", (0,), make) is plans[0]      # now most recent
    slot.plan("w", ("new",), make)                     # (1,) goes
    assert list(slot.plans) == [*((r,) for r in range(2, sg._PLANS)),
                                (0,), ("new",)]
    assert slot.plan("w", (2,), make) is plans[2]
    slot.plan("other", (2,), make)                     # weights changed
    assert list(slot.plans) == [(2,)] and slot.plans[(2,)] is made[-1]
    assert len(made) == sg._PLANS + 2


def test_plan_drops_its_graph_for_another_cache():
    plan = sg._Plan(None, None)
    plan.read_at((1, 2))
    plan.graph, plan.logits, plan.launches = "graph", "logits", {1: 2}
    plan.read_at((1, 2))
    assert plan.graph == "graph"
    plan.read_at((3, 4))
    assert (plan.graph, plan.logits, plan.launches) == (None, None, {})


def test_weights_key_follows_the_lm_only(model):
    key = sg._weights_key(model)
    assert key[0] == CFG
    names = [k[0] for k in key[1:]]
    assert "tok_emb" in names and "lm_head_q.q" in names
    assert not any(n.startswith("audio.") for n in names)
    other = dataclasses.replace(CFG, rms_eps=1e-5)
    assert key != (other,) + key[1:]


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs and the column kernel "
                    "have no CPU mode")
    return torch.device("cuda")


# the cell's model (Qwen3-ASR-1.7B's LM widths: d 2048, 16 query heads
# over 8 KV groups of 128, vocab 151,936, int8 LM and head) at 4 LM
# layers and a 2-layer tower
SMALL_CELL = dataclasses.replace(qm.QWEN_SIZES["qwen3-asr-1.7b"],
                                 n_layers=4, audio_layers=2)


def _loop(model, entry, monkeypatch):
    """One call through ``entry`` under a span: (result, its
    ``decode.loop`` counters, each step's logits, the cache's address)."""
    steps, caches = [], []
    inner_call = sg.StepForward.__call__
    inner_zeros = qm.LMCache.__dict__["zeros"]

    def call(self, token, pos):
        out = inner_call(self, token, pos)
        steps.append(out.clone())
        return out

    def zeros(*args, **kwargs):
        cache = inner_zeros.__func__(*args, **kwargs)
        caches.append(cache.k.data_ptr())
        return cache
    monkeypatch.setattr(sg.StepForward, "__call__", call)
    monkeypatch.setattr(qm.LMCache, "zeros", staticmethod(zeros))
    rec = tracer.SpanRecorder()
    with rec.span("test"):
        res = entry(model)
    torch.cuda.synchronize()
    monkeypatch.setattr(sg.StepForward, "__call__", inner_call)
    monkeypatch.setattr(qm.LMCache, "zeros", inner_zeros)
    (loop,) = [s for s in rec.spans if s.name == "decode.loop"]
    return res, loop.counters, steps, caches[0]


def _generate(model):
    g = torch.Generator(device="cuda").manual_seed(4)
    mel = torch.randn(32, SMALL_CELL.n_mels, 400, generator=g,
                      device="cuda")
    return qm.generate(model, mel, max_new=40, audio_len=52,
                       repetition_penalty=1.1)


def _generate_text(model):
    ids = torch.tensor([[11, 12, 13, 14, 15, 16, 17]], device="cuda")
    return qm.generate_text(model, ids, torch.tensor([7]), max_new=24,
                            repetition_penalty=1.1)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", [_generate, _generate_text],
                         ids=["generate-b32", "generate_text-b1"])
def test_graph_loop_equals_the_eager_loop(cuda_device, monkeypatch, entry):
    """Two calls replayed from the graph, then the same loop run eagerly
    (no slot): tokens, lengths, ``avg_logprob`` and each step's logits
    equal bit for bit; every step a replay; one capture on the first
    call and none on the second where its cache lies where the first's
    did; every layer-step through the column kernel."""
    model = prepare_params(init_params(
        SMALL_CELL, torch.Generator(device="cuda").manual_seed(3),
        device="cuda"))
    first = _loop(model, entry, monkeypatch)
    second = _loop(model, entry, monkeypatch)
    monkeypatch.setattr(sg, "_claim", lambda model, device: None)
    eager = _loop(model, entry, monkeypatch)
    n_layers = SMALL_CELL.n_layers
    for got, captures in ((first, 1), (second, int(second[3] != first[3]))):
        res, counters, steps, _ = got
        for name, a, b in zip(res._fields, res, eager[0]):
            assert torch.equal(a, b), name
        assert len(steps) == len(eager[2])
        for a, b in zip(steps, eager[2]):
            assert torch.equal(a, b)
        assert counters["graph_steps"] == counters["steps"] == len(steps)
        assert counters["captures"] == captures
        assert counters["kernel_layers"] == counters["steps"] * n_layers
    assert eager[1]["graph_steps"] == eager[1]["captures"] == 0
    assert eager[1]["kernel_layers"] == eager[1]["steps"] * n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("b,rep", [(1, 2), (32, 2), (2, 4)])
def test_one_captured_launch_serves_every_position(cuda_device, b, rep):
    """The column kernel captured once at a device position, replayed at
    positions 0, 1, 31, 32 and the last: each replay's output and cache
    as the plain version's at that position."""
    t_max, nkv, hd = 300, 8, 128
    g = torch.Generator(device="cuda").manual_seed(b + rep)

    def draw(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    q = draw(b, 1, nkv * rep, hd)
    ck, cv = draw(2, b, t_max, nkv * hd), draw(2, b, t_max, nkv * hd)
    kn, vn = draw(b, nkv * hd), draw(b, nkv * hd)
    pos = torch.zeros((1,), dtype=torch.int32, device="cuda")
    qa.column_attention(q, ck.clone(), cv.clone(), 1, pos, kn, vn)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = qa.column_attention.launches
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        out = qa.column_attention(q, ck, cv, 1, pos, kn, vn)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for p in (0, 1, 31, 32, t_max - 1):
        ck_plain, cv_plain = ck.clone(), cv.clone()
        want = qa.column_attention_plain(q, ck_plain, cv_plain, 1, p, kn,
                                         vn)
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        top = want.abs().max().item()
        assert (out - want).abs().max().item() <= 2e-5 * top, p
        assert torch.equal(ck, ck_plain) and torch.equal(cv, cv_plain)
    # outside ``_build.capturing`` the capture counts its launch once
    assert qa.column_attention.launches == before + 1
