"""The port's DeepSeek-V3 block (``models/deepseek_v3``) against the
benchmark's plain float32 reference (``benchmark/reference/deepseek_v3.py``,
loaded by path) and against Hugging Face's ``DeepseekV3ForCausalLM``, on
the CPU at the test widths (``deepseek-v3-test``: 3 layers, the first
dense, 8 routed experts of which 3 a token, 2 shared, latent rank 32) on
the benchmark's seeded weights (``benchmark/h100bench/
deepseek_v3_weights.py``: norm scales and a correction bias that are not
trivial): the prefill's logits, every absorbed decode step's logits
through the latent cache against one full forward, the routing (ids and
weights, the correction bias in the choice only), the shared experts, the
interleaved rotary embeddings, and the penalised log-probabilities and
greedy choices of what ``generate_text`` served. A step with one fault
(the correction bias dropped from the choice or added to the weights,
the routed scale left out, ``k_pe`` cached before its rope) fails the
tolerance.

Tolerances: both sides compute in float32 from the same weights (the
reference takes the int8 codes back to float32, the port scales the int8
product), so only the order of the sums differs, and in the absorbed
step where ``W_kvb`` meets the query and the output: logits agree within
1e-4 of their largest magnitude (measured: ~1e-6); each fault misses by
ten times that or more."""

import ast
import dataclasses
import importlib.util
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from whisperjav_tpu_torch.models.deepseek_v3 import convert as dconv
from whisperjav_tpu_torch.models.deepseek_v3 import model as dm
from whisperjav_tpu_torch.models.qwen import convert as qconv
from whisperjav_tpu_torch.utils import tracer

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
PATH = BENCH / "reference" / "deepseek_v3.py"
CFG = dm.DSV3_SIZES["deepseek-v3-test"]
M = dataclasses.asdict(CFG)
SEED = 2 ** 31 + 17
REL = 1e-4


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load(PATH, "deepseek_v3_reference")
drawer = _load(BENCH / "h100bench" / "deepseek_v3_weights.py",
               "deepseek_v3_weights")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def source():
    return drawer.Source(M, SEED, "cpu")


@pytest.fixture(scope="module")
def model(source):
    return dm.place(CFG, source, "cpu")


PROMPT = [int(t) for t in torch.randint(
    2, CFG.vocab_size, (21,), generator=torch.Generator().manual_seed(3))]
SERVED = [17, 401, 17, 256, 3, 99, 17, 248, 5, 77, 495, 12]


def _close(out, want, rel=REL):
    out, want = out.detach().double(), want.detach().double()
    assert out.shape == want.shape
    err = float((out - want).abs().max() / want.abs().max())
    assert err <= rel, err


def _err(out, want) -> float:
    return float((out.double() - want.double()).abs().max()
                 / want.double().abs().max())


def _reference_logits(source, ids):
    """The reference's logits at every position of ``ids``."""
    with torch.no_grad():
        states = ref.hidden(source, M, [torch.tensor(ids)])[0]
    return states @ ref.int8(source.top()["lm_head"])


def _step_logits(model, prompt, served):
    """The port's logits before each served token: the prefill, then one
    absorbed step a token through the latent cache."""
    cache = dm.LatentCache.zeros(CFG, 1, 64, torch.float32, "cpu")
    out = []
    with torch.no_grad():
        logits, _ = dm.prefill(model, model.tok_emb[torch.tensor([prompt])],
                               cache)
        out.append(logits[0])
        for i, tok in enumerate(served[:-1]):
            pos = torch.tensor([len(prompt) + i], dtype=torch.int32)
            out.append(dm.step_forward(model, torch.tensor([tok]), pos,
                                       cache)[0])
    return torch.stack(out), cache


def _want(source):
    ids = PROMPT + SERVED[:-1]
    return _reference_logits(source, ids)[len(PROMPT) - 1:]


def test_prefill_logits(model, source):
    cache = dm.LatentCache.zeros(CFG, 1, len(PROMPT), torch.float32, "cpu")
    with torch.no_grad():
        logits, routed = dm.prefill(
            model, model.tok_emb[torch.tensor([PROMPT])], cache)
    _close(logits[0], _reference_logits(source, PROMPT)[-1])
    # one count a routed expert a layer, every token's choices counted
    assert len(routed) == CFG.n_moe
    assert all(len(c) == CFG.n_routed_experts
               and sum(c) == len(PROMPT) * CFG.experts_per_token
               for c in routed)


def test_every_step_through_the_cache(model, source):
    got, cache = _step_logits(model, PROMPT, SERVED)
    _close(got, _want(source))
    # 576 values a position at Kanana's widths: c and the roped k_pe
    filled = len(PROMPT) + len(SERVED) - 1
    assert cache.ckv.shape == (CFG.n_layers, 1, 64, CFG.latent_dim)
    assert cache.ckv[:, :, :filled].abs().amax(-1).amin() > 0
    assert not cache.ckv[:, :, filled:].any()
    assert dm.DSV3_SIZES["kanana-2-30b-a3b"].latent_dim == 576


def _rows(model, n=40):
    g = torch.Generator().manual_seed(8)
    return torch.randn(n, CFG.d_model, generator=g)


def test_routing(model, source):
    """Ids and weights of every expert layer against the reference's gate
    vector; the correction bias moves some choices and no weight."""
    x = _rows(model)
    for j in range(CFG.n_moe):
        w = ref.weights(source.layer(CFG.first_dense + j))
        ids, weights = dm.route(x, model.moe, j, CFG)
        got = torch.zeros(len(x), CFG.n_routed_experts).scatter(
            1, ids, weights)
        want, gap = ref.gates(w, M, x)
        _close(got, want, 1e-6)
        assert gap == 0.0
        # the port's choice given to the reference: the same gates, no gap
        given, gap = ref.gates(w, M, x, ids=ids)
        _close(given, want, 1e-6)
        assert gap < 1e-6
        assert torch.allclose(weights.sum(-1),
                              torch.full((len(x),), CFG.routed_scale))
        plain = torch.topk(torch.sigmoid(x @ w["router"]),
                           CFG.experts_per_token).indices
        assert (plain.sort(-1).values != ids.sort(-1).values).any()


def test_shared_experts(model, source):
    x = _rows(model)
    for j in range(CFG.n_moe):
        w = ref.weights(source.layer(CFG.first_dense + j))
        got = dm._swiglu(x, model.moe["shared_gu"][j],
                         model.moe["shared_down"][j])
        _close(got, ref._swiglu(x, w["shared_gate"], w["shared_up"],
                                w["shared_down"], False))


@pytest.mark.parametrize("grouped", [True, False], ids=["prefill", "step"])
def test_expert_layer(model, source, grouped):
    """The grouped (prefill) and gathered (step) expert layers against
    the reference's dense one."""
    x = _rows(model)
    for j in range(CFG.n_moe):
        i = CFG.first_dense + j
        got = dm._moe(x[None], model.moe, j, CFG, grouped, [])[0]
        _close(got, ref.ffn(ref.weights(source.layer(i)), M, i, x))


def test_interleaved_rope():
    """The port's rotation, the reference's and Hugging Face's
    ``apply_rotary_pos_emb_interleave`` agree; the pairs are (2i, 2i+1)."""
    from transformers.models.deepseek_v3 import modeling_deepseek_v3 as hf
    t, h, dr = 9, 3, CFG.qk_rope_dim
    x = torch.randn(1, t, h, dr, generator=torch.Generator().manual_seed(2))
    pos = torch.arange(t)
    cos, sin = dm.rope_angles(pos, dr, CFG.rope_theta)
    got = dm.rope_interleaved(x, cos, sin)[0]
    _close(got, ref.rope(x[0], M), 1e-6)
    inv = 1.0 / CFG.rope_theta ** (torch.arange(0, dr, 2).float() / dr)
    ang = pos[:, None].float() * inv
    emb = torch.cat([ang, ang], -1)[None]
    q = x.transpose(1, 2)
    want, _ = hf.apply_rotary_pos_emb_interleave(q, q, emb.cos(), emb.sin())
    _close(got, want[0].transpose(0, 1), 1e-6)
    # a rotation of pairs (0, 1): at position 1 they mix with each other
    one = torch.zeros(1, 2, 1, dr)
    one[0, 1, 0, 0] = 1.0
    out = dm.rope_interleaved(one, cos[:2], sin[:2])[0, 1, 0]
    assert out[0] == pytest.approx(float(cos[1, 0, 0]))
    assert out[dr // 2] == pytest.approx(float(sin[1, 0, 0]))


# -- faults ------------------------------------------------------------------

def _bias_dropped(monkeypatch):
    def route(x, p, j, cfg):
        s = torch.sigmoid(x.float() @ p["router"][j].float())
        ids = torch.topk(s, cfg.experts_per_token, dim=-1).indices
        w = s.gather(1, ids)
        return ids, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale
    monkeypatch.setattr(dm, "route", route)


def _bias_in_weights(monkeypatch):
    def route(x, p, j, cfg):
        s = torch.sigmoid(x.float() @ p["router"][j].float()) \
            + p["bias"][j].float()
        ids = torch.topk(s, cfg.experts_per_token, dim=-1).indices
        w = s.gather(1, ids)
        return ids, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale
    monkeypatch.setattr(dm, "route", route)


def _no_routed_scale(monkeypatch):
    inner = dm.route

    def route(x, p, j, cfg):
        ids, w = inner(x, p, j, cfg)
        return ids, w / cfg.routed_scale
    monkeypatch.setattr(dm, "route", route)


def _k_pe_before_rope(monkeypatch):
    """The latent cache takes ``k_pe`` as projected, before its rope (the
    prefill's own attention still ropes it): the port's functions with
    that one expression changed."""
    for name, sound, fault in (
            ("_mla_prefill", "torch.cat([c, k_pe], dim=-1)",
             "torch.cat([c, kva[..., r:]], dim=-1)"),
            ("_mla_step", "torch.cat([c, k_pe], -1)",
             "torch.cat([c, kva[:, r:]], -1)")):
        src = inspect.getsource(getattr(dm, name))
        assert src.count(sound) == 1
        scope = dict(vars(dm))
        exec(src.replace(sound, fault), scope)
        monkeypatch.setattr(dm, name, scope[name])


@pytest.mark.parametrize("fault", [_bias_dropped, _bias_in_weights,
                                   _no_routed_scale, _k_pe_before_rope],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_faulty_step_misses(model, source, fault, monkeypatch):
    want = _want(source)
    fault(monkeypatch)
    got, _ = _step_logits(model, PROMPT, SERVED)
    assert _err(got, want) > 10 * REL


def test_served_logprobs(model, source):
    """``generate_text``'s log-probability of what it served, with the
    repetition penalty, against the reference's; every greedy choice the
    reference's own."""
    res = dm.generate_text(model, torch.tensor([PROMPT]),
                           torch.tensor([len(PROMPT)]), max_new=24,
                           repetition_penalty=1.3)
    n = int(res.length[0])
    served = res.tokens[0, :min(n + 1, 24)].numpy()
    total = float(res.avg_logprob[0]) * (n + 1)
    got = ref.read_rows(source, M, [np.array(PROMPT)], [served], "cpu", 1.3,
                        block=8)[0]
    assert abs(total - got["sum"]) / len(served) < 1e-5
    assert got["lead"] < 1e-4
    # judged without the penalty, the sums part and the choices it made
    # fall short
    plain = ref.read_rows(source, M, [np.array(PROMPT)], [served], "cpu",
                          1.0)[0]
    assert abs(plain["sum"] - got["sum"]) / len(served) > 1e-3
    assert plain["lead"] > 1e-2


def test_reference_is_plain():
    names = set()
    for node in ast.walk(ast.parse(PATH.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "typing", "numpy", "torch"}, names


# -- Hugging Face's implementation and the loader ----------------------------

def _hf_config():
    import transformers
    return transformers.DeepseekV3Config(
        vocab_size=CFG.vocab_size, hidden_size=CFG.d_model,
        intermediate_size=CFG.d_ff, moe_intermediate_size=CFG.moe_d_ff,
        num_hidden_layers=CFG.n_layers, num_attention_heads=CFG.n_heads,
        num_key_value_heads=CFG.n_heads, n_shared_experts=2,
        n_routed_experts=CFG.n_routed_experts,
        routed_scaling_factor=CFG.routed_scale,
        kv_lora_rank=CFG.kv_lora_rank, q_lora_rank=None,
        qk_rope_head_dim=CFG.qk_rope_dim, v_head_dim=CFG.v_head_dim,
        qk_nope_head_dim=CFG.qk_nope_dim, n_group=1, topk_group=1,
        num_experts_per_tok=CFG.experts_per_token, first_k_dense_replace=1,
        norm_topk_prob=True, rope_theta=CFG.rope_theta, rope_interleave=True,
        rms_norm_eps=CFG.rms_eps, max_position_embeddings=32_768,
        tie_word_embeddings=False, bos_token_id=CFG.bos_id,
        eos_token_id=CFG.eos_id, attn_implementation="eager")


@pytest.fixture(scope="module")
def hf_twin(tmp_path_factory):
    """A tiny ``DeepseekV3ForCausalLM`` from a fixed seed, its matrices
    already on the int8 grid (so both sides serve the same numbers), its
    norms and correction bias not trivial, saved to a directory."""
    import transformers
    torch.manual_seed(0)
    hf = transformers.DeepseekV3ForCausalLM(_hf_config()).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "norm" in name:
                p.copy_(1.0 + 0.1 * torch.randn_like(p))
            elif name.endswith("proj.weight") or name.endswith(
                    "proj_with_mqa.weight") or name == "lm_head.weight":
                p.copy_(ref.int8(p.T).T)
        for layer in hf.model.layers[1:]:
            b = layer.mlp.gate.e_score_correction_bias
            b.copy_(0.1 * torch.randn_like(b))
    path = tmp_path_factory.mktemp("dsv3") / "kanana-tiny"
    hf.save_pretrained(str(path))
    return hf, str(path)


def test_load_lm_maps_a_deepseek_v3_checkpoint(hf_twin):
    """``load_lm`` picks the family by ``model_type``; the source gives
    each HF tensor under the port's name, (in, out), experts stacked."""
    hf, path = hf_twin
    cfg, src = qconv.load_lm(path)
    assert dataclasses.replace(cfg, name=CFG.name) == CFG
    sd = hf.state_dict()
    top = src.top()
    assert torch.equal(top["tok_emb"], sd["model.embed_tokens.weight"])
    assert torch.equal(top["lm_head"], sd["lm_head.weight"].T)
    layer = src.layer(1)
    p = "model.layers.1."
    for name, key in (("wkva", "self_attn.kv_a_proj_with_mqa.weight"),
                      ("wkvb", "self_attn.kv_b_proj.weight"),
                      ("router", "mlp.gate.weight"),
                      ("shared_down", "mlp.shared_experts.down_proj.weight")):
        assert torch.equal(layer[name], sd[p + key].T), name
    assert torch.equal(layer["bias"],
                       sd[p + "mlp.gate.e_score_correction_bias"])
    assert torch.equal(layer["w_up"][5],
                       sd[p + "mlp.experts.5.up_proj.weight"].T)
    assert torch.equal(layer["kv_norm"],
                       sd[p + "self_attn.kv_a_layernorm.weight"])
    assert set(src.layer(0)) == {"ln1", "wq", "wkva", "kv_norm", "wkvb",
                                 "wo", "ln2", "w_gate", "w_up", "w_down"}


def test_port_and_reference_match_hugging_face(hf_twin):
    """Hugging Face's forward on the twin, the port's steps through the
    cache and the reference, all from what ``load_lm`` read."""
    hf, path = hf_twin
    cfg, src = qconv.load_lm(path)
    model = dm.place(cfg, src, "cpu")
    ids = PROMPT + SERVED[:-1]
    with torch.no_grad():
        want = hf(torch.tensor([ids])).logits[0, len(PROMPT) - 1:]
        states = ref.hidden(src, M, [torch.tensor(ids)])[0]
        mine = (states @ ref.int8(src.top()["lm_head"]))[len(PROMPT) - 1:]
    _close(mine, want)
    _close(_step_logits(model, PROMPT, SERVED)[0], want)


def test_load_lm_refuses_other_blocks(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "llama", "hidden_size": 64}))
    with pytest.raises(ValueError, match="Qwen3.*DeepSeek-V3"):
        qconv.load_lm(str(tmp_path))


@pytest.mark.parametrize("key,value", [
    ("q_lora_rank", 1536), ("n_group", 8), ("scoring_func", "softmax"),
    ("rope_scaling", {"type": "yarn", "factor": 40})])
def test_config_refuses_what_the_block_lacks(key, value):
    c = json.loads(json.dumps(_hf_config().to_dict()))
    dconv.config_from_hf(c)
    c[key] = value
    with pytest.raises(ValueError, match=key):
        dconv.config_from_hf(c)


# -- the backend and its spans ------------------------------------------------

class _Tokenizer:
    """Characters as ids over the test vocabulary."""

    def encode(self, text):
        return [2 + ord(ch) % (CFG.vocab_size - 2) for ch in text]

    def decode(self, ids):
        return "".join(chr(0x3041 + int(i) % 80) for i in ids)


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
def test_backend_serves_the_family(source, model, monkeypatch, traced):
    """``LocalLMBackend`` places a layer source in int8 and answers as
    ``generate_text`` does; traced, ``translate.prompt`` holds
    ``lm.prefill`` and the shared loop's spans with their counters."""
    from whisperjav_tpu_torch.translate.local_backend import (
        LocalLMBackend, count_cues,
    )
    if traced:
        monkeypatch.setenv("WJAV_TRACE_BATCHES", "1")
    else:
        monkeypatch.delenv("WJAV_TRACE_BATCHES", raising=False)
    backend = LocalLMBackend(params=source, cfg=CFG, tokenizer=_Tokenizer(),
                             max_new_tokens=10, device="cpu")
    assert not backend.qwen
    for name, t in model.state_dict().items():
        assert torch.equal(backend.model.state_dict()[name], t), name
    prompt = "Translate:\n---\n1: こんにちは\n2: ありがとう\n3: はい"
    assert count_cues(prompt) == 3
    text = backend(prompt)
    ids = _Tokenizer().encode(prompt)
    want = dm.generate_text(model, torch.tensor([ids]),
                            torch.tensor([len(ids)]), max_new=10,
                            repetition_penalty=1.05)
    assert text == _Tokenizer().decode(
        want.tokens[0, :int(want.length[0])].tolist())
    got = backend.generate_ids(ids)
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
    if not traced:
        assert backend.recorder is None
        return
    spans = backend.recorder.spans
    names = [s.name for s in spans]
    assert names[:2] == ["translate.prompt", "lm.prefill"]
    (prompt_span,) = [s for s in spans if s.name == "translate.prompt"]
    assert prompt_span.counters == {"prompt_tokens": len(ids), "budget": 10}
    prefill = spans[1]
    assert prefill.parent is prompt_span
    assert prefill.counters["routed_max"] >= prefill.counters["routed_mean"]
    assert prefill.counters["routed_mean"] > 0
    (loop,) = [s for s in spans if s.name == "decode.loop"]
    assert loop.parent is prompt_span
    assert loop.counters["steps"] == 10 and loop.counters["start"] == len(ids)
    assert loop.counters["graph_steps"] == loop.counters["captures"] == 0
    assert names.count("decode.step") == 10
    assert prompt_span.end_ns >= loop.end_ns


def test_the_cache_is_bucketed_and_the_loop_shared(model, monkeypatch):
    """The loop is the Qwen package's ``_decode`` with this family's step,
    over a cache rounded up to ``CACHE_MULTIPLE`` positions."""
    from whisperjav_tpu_torch.models.qwen import model as qm
    seen = {}
    inner = qm._decode

    def decode(model_, cur, cache, start, max_new, *args, **kwargs):
        seen.update(shape=cache.ckv.shape, step=kwargs["step_fn"],
                    start=start)
        return inner(model_, cur, cache, start, max_new, *args, **kwargs)
    monkeypatch.setattr(qm, "_decode", decode)
    dm.generate_text(model, torch.tensor([PROMPT]), torch.tensor([21]),
                     max_new=240)
    assert seen["shape"] == (CFG.n_layers, 1, 512, CFG.latent_dim)
    assert seen["step"] is dm.step_forward and seen["start"] == 21
    assert dm.cache_positions(21, 240) == 512
    assert dm.cache_positions(16, 240) == 256


def test_a_longer_cache_serves_the_same(model, monkeypatch):
    """A cache of more positions than the rounding gives (what a warm-up
    asks for) serves the same tokens: the step's mask hides the unused
    positions; one too short for the prompt and budget is refused."""
    made = []
    inner = dm.LatentCache.__dict__["zeros"]

    def zeros(cfg, b, t_max, dtype, device):
        made.append(t_max)
        return inner.__func__(cfg, b, t_max, dtype, device)
    monkeypatch.setattr(dm.LatentCache, "zeros", staticmethod(zeros))
    args = (model, torch.tensor([PROMPT]), torch.tensor([len(PROMPT)]))
    want = dm.generate_text(*args, max_new=24, repetition_penalty=1.3)
    got = dm.generate_text(*args, max_new=24, repetition_penalty=1.3,
                           cache_len=3 * dm.CACHE_MULTIPLE)
    assert made == [dm.CACHE_MULTIPLE, 3 * dm.CACHE_MULTIPLE]
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.length, want.length)
    assert torch.allclose(got.avg_logprob, want.avg_logprob, rtol=1e-6)
    with pytest.raises(ValueError, match="cannot hold"):
        dm.generate_text(*args, max_new=24, cache_len=len(PROMPT) + 23)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


# Kanana-2-30B-A3B's widths at 4 layers: the dense one and three expert
# layers of 128 experts
SMALL = dataclasses.replace(dm.DSV3_SIZES["kanana-2-30b-a3b"], n_layers=4)


@pytest.mark.cuda
def test_graph_steps_equal_the_eager_steps(cuda_device, monkeypatch):
    """B=1 through ``generate_text``: twice replayed from the graph, then
    run eagerly (no slot): tokens, lengths, ``avg_logprob`` and each
    step's logits equal bit for bit; every step a replay; one capture on
    the first call, none on the second where its cache lies where the
    first's did."""
    from whisperjav_tpu_torch.models.qwen import step_graph as sg
    model = dm.place(SMALL, drawer.Source(
        dataclasses.asdict(SMALL), SEED, "cuda"), "cuda")
    ids = torch.randint(0, SMALL.vocab_size, (1, 300), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))

    def run():
        steps, caches = [], []
        inner_call = sg.StepForward.__call__
        inner_zeros = dm.LatentCache.__dict__["zeros"]

        def call(self, token, pos):
            out = inner_call(self, token, pos)
            steps.append(out.clone())
            return out

        def zeros(*args, **kwargs):
            cache = inner_zeros.__func__(*args, **kwargs)
            caches.append(cache.ckv.data_ptr())
            return cache
        monkeypatch.setattr(sg.StepForward, "__call__", call)
        monkeypatch.setattr(dm.LatentCache, "zeros", staticmethod(zeros))
        rec = tracer.SpanRecorder()
        with rec.span("test"):
            res = dm.generate_text(model, ids, torch.tensor([300]),
                                   max_new=40, repetition_penalty=1.05)
        torch.cuda.synchronize()
        monkeypatch.setattr(sg.StepForward, "__call__", inner_call)
        monkeypatch.setattr(dm.LatentCache, "zeros", inner_zeros)
        (loop,) = [s for s in rec.spans if s.name == "decode.loop"]
        return res, loop.counters, steps, caches[0]

    first, second = run(), run()
    monkeypatch.setattr(sg, "_claim", lambda model, device: None)
    eager = run()
    for got, captures in ((first, 1), (second, int(second[3] != first[3]))):
        res, counters, steps, _ = got
        for name, a, b in zip(res._fields, res, eager[0]):
            assert torch.equal(a, b), name
        assert len(steps) == len(eager[2]) == 40
        for a, b in zip(steps, eager[2]):
            assert torch.equal(a, b)
        assert counters["graph_steps"] == counters["steps"] == 40
        assert counters["captures"] == captures
    assert eager[1]["graph_steps"] == eager[1]["captures"] == 0
