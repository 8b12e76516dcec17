"""The decode step's forward at a position held in a tensor, and its
replay from captured CUDA graphs (``models/whisper/step_graph.py``).

On the CPU: a single step at a tensor position gives the logits and
cache of the same step at the integer position, on the unfused layers
and the fused int8 blocks' plain versions, at the first, second and last
positions; the fused self block refuses an int position outside the
cache; the beam reorder gathers into the other buffer of the pair; a
slot keeps its newest plans. On a card: the loops'
replays against the same loops run eagerly (the tokens and every step's
logits bitwise), the fused self block's kernel at device positions under
one captured launch, a second batch of one shape replaying the first
one's graphs, and beam loops and greedy rungs in turns keeping theirs.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from whisperjav_tpu_torch.models.whisper import decode as td
from whisperjav_tpu_torch.models.whisper import model as tm
from whisperjav_tpu_torch.models.whisper import step_graph as sg
from whisperjav_tpu_torch.models.whisper.config import WhisperConfig
from whisperjav_tpu_torch.models.layers import Int8
from whisperjav_tpu_torch.models.whisper.quant import (
    fuse_qkv_weights, quantize_decoder_weights,
)
from whisperjav_tpu_torch.models.whisper.weights import init_params
from whisperjav_tpu_torch.ops.cuda import fused_decode as tfd
from whisperjav_tpu_torch.ops.cuda.decode_attention import (
    decode_cross_attention_bf16,
)
from whisperjav_tpu_torch.utils import tracer

TINY = WhisperConfig(name="graph-tiny", n_audio_state=256, n_audio_head=4,
                     n_audio_layer=1, n_text_state=256, n_text_head=4,
                     n_text_layer=2)
# turbo's and large-v2's decoder widths (hd = 64, as the kernels take),
# four layers
WIDE = WhisperConfig(name="graph-wide", n_mels=128, n_audio_state=1280,
                     n_audio_head=20, n_audio_layer=1, n_text_state=1280,
                     n_text_head=20, n_text_layer=4, n_vocab=51866)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the graphs and kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _model(config, int8: bool, device="cpu", seed=0):
    """Seeded weights as the engine prepares them: bf16, q/k/v fused,
    int8 decoder weights with ``int8``; decoder positions drawn, so a
    step's position shows in its logits."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = init_params(config, gen, device=device)
    dec = model.decoder
    dec.pos_emb.data = 0.5 * torch.randn(dec.pos_emb.shape, generator=gen,
                                         device=device)
    for name in ("bqkv", "bq", "bv", "cbq", "cbo", "b1", "b2", "bo"):
        if name in dec.blocks:
            p = dec.blocks[name]
            p.data = 0.1 * torch.randn(p.shape, generator=gen, device=device)
    model = model.to(dtype=torch.bfloat16)
    fuse_qkv_weights(model)
    if int8:
        quantize_decoder_weights(model)
    return model


def _states(config, batch, frames, device="cpu", seed=1):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, frames, config.n_audio_state), generator=gen,
                       device=device).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("where", ["first", "second", "last"])
def test_step_at_a_tensor_position_equals_the_int_one(int8, where):
    """One step at a position held in an int32 tensor against the same
    step at the int: the same logits and cache, bit for bit; the step
    writes its column at that position and nowhere else."""
    model = _model(TINY, int8)
    rows, total_len = 4, 12
    pos = {"first": 0, "second": 1, "last": total_len - 1}[where]
    cross = tm.precompute_cross_kv(model, _states(TINY, 2, 64), int8=True)
    assert tm.fused_step(model, cross.k.dtype) == int8
    gen = torch.Generator().manual_seed(2)
    shape = (TINY.n_text_layer, rows, total_len, TINY.n_text_state)
    cache = tm.KVCache(*(torch.randn(shape, generator=gen).bfloat16()
                         for _ in range(2)))
    tokens = torch.tensor([[50364], [440], [2000], [51000]])
    caches = [tm.KVCache(cache.k.clone(), cache.v.clone())
              for _ in range(2)]
    at_int, _ = tm.decode_step(model, tokens, pos, caches[0], cross)
    at_tensor, _ = tm.decode_step(
        model, tokens, torch.tensor([pos], dtype=torch.int32), caches[1],
        cross)
    assert at_int.dtype == torch.float32
    assert at_int.shape == (rows, 1, TINY.n_vocab)
    assert torch.equal(at_int, at_tensor)
    for got, want in zip(caches[1], caches[0]):
        assert torch.equal(got, want)
    others = [t for t in range(total_len) if t != pos]
    for got, was in zip(caches[1], cache):
        assert torch.equal(got[:, :, others], was[:, :, others])
        assert not torch.equal(got[:, :, pos], was[:, :, pos])
    # the position is read: another one gives other logits
    other, _ = tm.decode_step(model, tokens, (pos + 1) % total_len,
                              tm.KVCache(cache.k.clone(), cache.v.clone()),
                              cross)
    assert not torch.equal(other, at_int)


def _self_block_args(seed: int) -> dict:
    """The fused self block's operands at small widths, but the
    position."""
    gen = torch.Generator().manual_seed(seed)
    n_layer, rows, t, d, h = 2, 3, 16, 256, 4

    def w(k, n):
        return Int8(torch.randint(-127, 128, (n_layer, k, n), generator=gen,
                                  dtype=torch.int8),
                    torch.rand((n_layer, 1, n), generator=gen) * 1e-2)

    return dict(x=torch.randn(rows, d, generator=gen),
                ln_s=1 + 0.1 * torch.randn(n_layer, d, generator=gen),
                ln_b=0.1 * torch.randn(n_layer, d, generator=gen),
                wqkv=w(d, 3 * d), bqkv=torch.randn(n_layer, 3 * d,
                                                   generator=gen),
                wo=w(d, d), bo=torch.randn(n_layer, d, generator=gen),
                cache_k=torch.randn(n_layer, rows, t, d, generator=gen),
                cache_v=torch.randn(n_layer, rows, t, d, generator=gen),
                layer=1, n_head=h)


@pytest.mark.parametrize("pos", [0, 1, 15])
def test_self_block_plain_takes_a_tensor_position(pos):
    args = _self_block_args(pos)
    want = tfd.self_block_plain(**args, pos=pos)
    for got in (tfd.self_block_plain(
            **args, pos=torch.tensor([pos], dtype=torch.int32)),
            tfd.self_block(**args,
                           pos=torch.tensor([pos], dtype=torch.int32))):
        for g, r in zip(got, want):
            assert torch.equal(g, r)


@pytest.mark.parametrize("pos", [-1, 16])
def test_self_block_refuses_an_int_position_outside_the_cache(pos):
    """An int position is checked before it goes to the device (a
    tensor's is the caller's to keep)."""
    with pytest.raises(ValueError, match="outside"):
        tfd.self_block(**_self_block_args(0), pos=pos)


def test_reorder_gathers_into_the_other_buffer():
    """On the CPU the step forward runs eagerly (no graph, no capture)
    and the beam reorder gathers each row into the pair's other buffer,
    which takes over; two reorders come back to the first."""
    model = _model(TINY, int8=False)
    xa = _states(TINY, 2, 64)
    fwd = sg.StepForward(model, xa, 4, 10, True, False, True,
                         tm.decode_step, tm.precompute_cross_kv)
    first = fwd.cache
    gen = torch.Generator().manual_seed(3)
    first.k.copy_(torch.randn(first.k.shape, generator=gen))
    first.v.copy_(torch.randn(first.v.shape, generator=gen))
    index = torch.tensor([1, 1, 3, 0])
    want = (first.k[:, index], first.v[:, index])
    fwd.reorder(index)
    assert fwd.cache is not first
    assert torch.equal(fwd.cache.k, want[0])
    assert torch.equal(fwd.cache.v, want[1])
    logits = fwd(torch.tensor([50364, 440, 2000, 51000]), 3)
    assert logits.shape == (4, TINY.n_vocab)
    fwd.reorder(torch.arange(4))
    assert fwd.cache is first
    assert (fwd.graph_steps, fwd.captures) == (0, 0)


def test_a_slot_keeps_its_newest_plans():
    """A slot's plans (no card needed: only the graphs are the card's):
    the same loop shape gets its plan back, made the newest; past
    ``_PLANS`` the least recently used goes; other decoder weights drop
    every plan. A plan drops its graphs when a loop's buffers lie
    elsewhere."""
    slot = sg._Slot(torch.device("cpu"))
    weights = ("w",)

    def make():
        return sg._Plan(torch.zeros(4, 1), torch.zeros(1), [])

    plans = [slot.plan(weights, ("shape", i), make)
             for i in range(sg._PLANS)]
    assert slot.plan(weights, ("shape", 0), make) is plans[0]
    assert list(slot.plans)[-1] == ("shape", 0)
    slot.plan(weights, ("shape", "new"), make)
    assert len(slot.plans) == sg._PLANS
    assert ("shape", 1) not in slot.plans
    fresh = slot.plan(("other weights",), ("shape", 0), make)
    assert fresh is not plans[0] and list(slot.plans) == [("shape", 0)]
    plan = plans[2]
    plan.read_at((1, 2), (3, 4))
    plan.graphs[0] = "captured"
    plan.read_at((1, 2), (3, 4))
    assert plan.graphs[0] == "captured"
    plan.read_at((1, 2), (3, 5))
    assert plan.graphs == [None, None] and plan.caches_at == (3, 5)


def test_fresh_buffers_take_the_roles_of_their_addresses():
    """Buffers of one size, unwritten, are ordered to the addresses a
    plan's graphs read where they are the same set; else left as they
    come."""
    bufs = [torch.empty(8) for _ in range(3)]
    ptrs = [t.data_ptr() for t in bufs]
    want = (ptrs[2], ptrs[0], ptrs[1])
    got, at = sg._in_place_of(bufs, want)
    assert at == want and [t.data_ptr() for t in got] == list(want)
    got, at = sg._in_place_of(bufs, None)
    assert got == bufs and at == tuple(ptrs)
    got, at = sg._in_place_of(bufs, (ptrs[0], ptrs[1], 1))
    assert got == bufs and at == tuple(ptrs)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wide_models():
    """turbo-shaped (bf16, unfused layers) and large-v2-shaped (int8,
    fused blocks) decoders on the card, built once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the graphs and kernels have no CPU "
                    "mode")
    dev = torch.device("cuda")
    return {"turbo": _model(WIDE, False, dev), "int8": _model(WIDE, True,
                                                             dev)}


def _run(model, xa, beams, eager, monkeypatch, cross="int8"):
    """One decode with its loop traced; each step's logits as returned,
    copied. ``eager`` takes the slots away, so every step runs the
    forward eagerly. ``cross`` is the cross-K/V's form: int8, int4 or
    bf16 (unquantised)."""
    steps = []
    call = sg.StepForward.__call__

    def recording(self, token, pos):
        out = call(self, token, pos)
        steps.append(out.clone())
        return out

    with monkeypatch.context() as m:
        m.setattr(sg.StepForward, "__call__", recording)
        if eager:
            m.setattr(sg, "_claim", lambda model, device: None)
        opts = td.DecodeOptions(max_new_tokens=24, beam_size=beams,
                                cross_kv_int8=cross == "int8",
                                cross_kv_int4=cross == "int4")
        rec = tracer.SpanRecorder()
        with tracer.span(rec, "engine.decode", 0):
            out = td.decode_beam(model, xa, opts)
        torch.cuda.synchronize()
    (loop,) = [s for s in rec.spans if s.name == "decode.loop"]
    return out, steps, loop.counters


@pytest.mark.cuda
@pytest.mark.parametrize("beams", [2, 1], ids=["beam2", "greedy"])
@pytest.mark.parametrize("frames", [448, 1500])
@pytest.mark.parametrize("kind", ["turbo", "int8"])
def test_graph_replay_matches_eager(cuda_device, wide_models, monkeypatch,
                                    kind, frames, beams):
    model = wide_models[kind]
    xa = _states(WIDE, 4, frames, cuda_device, seed=frames)
    eager, eager_steps, eager_counts = _run(model, xa, beams, True,
                                            monkeypatch)
    graph, graph_steps, counts = _run(model, xa, beams, False, monkeypatch)
    assert eager_counts["graph_steps"] == 0
    assert counts["graph_steps"] == counts["steps"] == len(graph_steps)
    assert len(graph_steps) == len(eager_steps) > 0
    for i, (g, e) in enumerate(zip(graph_steps, eager_steps)):
        assert torch.equal(g, e), f"step {i}"
    for field in ("tokens", "length", "sum_logprob", "no_speech_prob"):
        assert torch.equal(getattr(graph, field), getattr(eager, field))


@pytest.mark.cuda
@pytest.mark.parametrize("cross", ["int4", "bf16"])
def test_graph_replay_matches_eager_on_the_other_cross_kv(
        cuda_device, wide_models, monkeypatch, cross):
    """Nibble-packed int4 and unquantised cross-K/V run plain PyTorch
    inside the captured step (no kernel), on the unfused bf16 layers."""
    model = wide_models["turbo"]
    xa = _states(WIDE, 4, 448, cuda_device, seed=9)
    eager, eager_steps, _ = _run(model, xa, 2, True, monkeypatch, cross)
    graph, graph_steps, counts = _run(model, xa, 2, False, monkeypatch,
                                      cross)
    assert counts["graph_steps"] == counts["steps"] == len(graph_steps)
    for i, (g, e) in enumerate(zip(graph_steps, eager_steps)):
        assert torch.equal(g, e), f"step {i}"
    assert torch.equal(graph.tokens, eager.tokens)


@pytest.mark.cuda
def test_a_second_batch_replays_the_first_ones_graphs(cuda_device,
                                                      wide_models,
                                                      monkeypatch):
    """The same shapes again capture nothing, and each replay counts the
    kernel launches its graph holds: the fused blocks and Kernel B's
    bf16 form once a layer a step."""
    n_layer = WIDE.n_text_layer
    for kind, counter in (("int8", tfd.self_block),
                          ("turbo", decode_cross_attention_bf16)):
        model = wide_models[kind]
        _run(model, _states(WIDE, 4, 448, cuda_device, seed=5), 2, False,
             monkeypatch)
        before = counter.launches
        _, steps, counts = _run(model, _states(WIDE, 4, 448, cuda_device,
                                               seed=6), 2, False,
                                monkeypatch)
        assert counts["captures"] == 0, kind
        assert counts["graph_steps"] == counts["steps"] == len(steps)
        # the prefill's cross-attention launches Kernel B too, once a
        # layer; the fused blocks run in single steps only
        prefill = n_layer if kind == "turbo" else 0
        assert counter.launches - before == n_layer * len(steps) + prefill


def _gpu_int8(gen, dev, k, n, n_layer):
    w = torch.randn(n_layer, k, n, generator=gen, device=dev) * k ** -0.5
    s = w.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    return Int8(torch.round(w / s).clamp(-127, 127).to(torch.int8), s)


@pytest.mark.cuda
def test_self_block_kernel_reads_its_position_on_the_device(cuda_device):
    """One captured launch of the fused self block, replayed after a fill
    of its position, at each position of
    ``test_self_block_kernel_matches_plain_on_gpu``: within one bf16 step
    of the plain version there."""
    dev, n_layer, d, h, t = cuda_device, 4, 1280, 20, 227
    for rows, pos in ((32, 1), (64, 100), (64, 226)):
        gen = torch.Generator(device=dev).manual_seed(rows + pos)
        args = dict(
            x=torch.randn(rows, d, generator=gen, device=dev),
            ln_s=1 + 0.1 * torch.randn(n_layer, d, generator=gen,
                                       device=dev),
            ln_b=0.1 * torch.randn(n_layer, d, generator=gen, device=dev),
            wqkv=_gpu_int8(gen, dev, d, 3 * d, n_layer),
            bqkv=0.1 * torch.randn(n_layer, 3 * d, generator=gen,
                                   device=dev),
            wo=_gpu_int8(gen, dev, d, d, n_layer),
            bo=0.1 * torch.randn(n_layer, d, generator=gen, device=dev),
            cache_k=torch.randn(n_layer, rows, t, d, generator=gen,
                                device=dev),
            cache_v=torch.randn(n_layer, rows, t, d, generator=gen,
                                device=dev),
            layer=n_layer - 1, n_head=h)
        for name in ("x", "ln_s", "ln_b", "bqkv", "bo", "cache_k",
                     "cache_v"):
            args[name] = args[name].bfloat16()
        at = torch.zeros((1,), dtype=torch.int32, device=dev)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            tfd.self_block(**args, pos=at)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="thread_local")
            out = tfd.self_block(**args, pos=at)
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        for p in (pos, 0, pos):
            at.fill_(p)
            graph.replay()
            torch.cuda.synchronize()
            want = tfd.self_block_plain(**args, pos=p)
            for o, r, what in zip(out, want, ("x_out", "k_new", "v_new")):
                o, r = o.float(), r.float()
                assert torch.isfinite(o).all(), what
                step = 2.0 ** (np.floor(np.log2(r.abs().max().item())) - 7)
                assert (o - r).abs().max().item() <= step, (what, rows, p)


@pytest.mark.cuda
def test_replays_stay_exact_after_the_cache_is_emptied(cuda_device,
                                                       wide_models,
                                                       monkeypatch):
    """Between two batches of one shape the allocator's cached memory is
    released (as the engine's ``release_device_memory`` does): the second
    batch replays or captures anew, and its steps equal the eager ones."""
    model = wide_models["int8"]
    _run(model, _states(WIDE, 4, 448, cuda_device, seed=7), 2, False,
         monkeypatch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    xa = _states(WIDE, 4, 448, cuda_device, seed=8)
    graph, graph_steps, counts = _run(model, xa, 2, False, monkeypatch)
    eager, eager_steps, _ = _run(model, xa, 2, True, monkeypatch)
    assert counts["graph_steps"] == counts["steps"]
    assert counts["captures"] in (0, 2)
    for g, e in zip(graph_steps, eager_steps):
        assert torch.equal(g, e)
    assert torch.equal(graph.tokens, eager.tokens)


@pytest.mark.cuda
def test_beam_loops_and_greedy_rungs_keep_their_graphs(cuda_device,
                                                       wide_models,
                                                       monkeypatch):
    """Beam loops and greedy rungs of one batch shape in turns (the
    ladder's order) keep a plan each: after the first of each, nothing is
    captured, and replays stay equal to the eager steps. A loop at
    another bucket between them takes a plan of its own beside theirs;
    after it, theirs replay, or capture anew where the allocator handed
    their buffers out elsewhere, and stay equal to the eager steps."""
    model = wide_models["turbo"]
    xa = _states(WIDE, 4, 448, cuda_device, seed=11)
    captures = []
    for beams in (2, 1, 2, 1):
        out, steps, counts = _run(model, xa, beams, False, monkeypatch)
        captures.append(counts["captures"])
        assert counts["graph_steps"] == counts["steps"]
        eager, eager_steps, _ = _run(model, xa, beams, True, monkeypatch)
        for g, e in zip(steps, eager_steps):
            assert torch.equal(g, e)
        assert torch.equal(out.tokens, eager.tokens)
    assert captures[2:] == [0, 0]
    (slot,) = sg._SLOTS[model].values()
    _run(model, _states(WIDE, 4, 1500, cuda_device, seed=12), 2, False,
         monkeypatch)
    assert len(slot.plans) >= 3
    for beams in (2, 1):
        out, steps, counts = _run(model, xa, beams, False, monkeypatch)
        assert counts["captures"] <= (2 if beams == 2 else 1)
        assert counts["graph_steps"] == counts["steps"]
        eager, eager_steps, _ = _run(model, xa, beams, True, monkeypatch)
        for g, e in zip(steps, eager_steps):
            assert torch.equal(g, e)
        assert torch.equal(out.tokens, eager.tokens)


@pytest.mark.cuda
def test_captures_go_on_after_every_graph_is_dropped(cuda_device,
                                                     wide_models,
                                                     monkeypatch):
    """Every plan dropped (as new decoder weights drop them): the next
    loop captures into the same pool, and its steps equal the eager
    ones."""
    model = wide_models["int8"]
    xa = _states(WIDE, 4, 448, cuda_device, seed=13)
    _run(model, xa, 2, False, monkeypatch)
    (slot,) = sg._SLOTS[model].values()
    pool = slot.graph_pool
    slot.plans.clear()
    graph, steps, counts = _run(model, xa, 2, False, monkeypatch)
    eager, eager_steps, _ = _run(model, xa, 2, True, monkeypatch)
    assert counts["captures"] == 2 and slot.graph_pool is pool
    for g, e in zip(steps, eager_steps):
        assert torch.equal(g, e)
    assert torch.equal(graph.tokens, eager.tokens)
