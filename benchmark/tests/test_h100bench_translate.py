"""The translator's LM driver (``drivers/translate_lm.py``) through the
harness on the CPU, at the port's test widths (``data/translate``:
``deepseek-v3-test``, one prompt of four cues a file, 16 new tokens)
with the cell's limits: sound runs are correct; a step that writes its
latent column one slot late is not, nor one whose routing drops the
correction bias (the reference follows the program's choices and reads
how far they fall short of its own), nor one that chooses its token
without the repetition penalty, nor a second serving that is not the
first, nor the program's bf16 path or a bf16 cache alone (their
departures); the driver counts the model's operations as
``roofline/deepseek_v3`` does. The configuration holds the port's
published sizes; the traffic draws each file's cues from its index, so
prompts vary from file to file and every seed serves the same work; the
warm-up reaches every cache length they take; and the cell's metrics
read the device's busy time inside the port's spans."""

import dataclasses
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from h100bench import spec
from h100bench.harness import run_cell
from h100bench.spans import HostSpan
from h100bench.trace import Span, Stretch
from roofline import deepseek_v3 as counts
from whisperjav_tpu_torch.models.deepseek_v3 import model as dm
from roofline.counts import HBM_BYTES_S

DATA = Path(__file__).resolve().parent / "data" / "translate"
SEED = 2 ** 31 + 99
CELL = "kanana2-translate-b1"
METRICS = ("mla_moe.decode_step_ms", "mla_moe.decode_hbm_pct",
           "mla_moe.prefill_ms_per_ktok")


def tiny_cell() -> dict:
    cell = dict(spec.workload(CELL))
    cell.update(name="translate-tiny",
                config=json.loads((DATA / "config.json").read_text()),
                traffic=json.loads((DATA / "traffic.json").read_text()))
    return cell


def _driver():
    return spec.driver("translate_lm")


class _Keep:
    UNIT = ""
    stretch = None

    @classmethod
    def read(cls, stretch):
        cls.stretch = stretch


@pytest.fixture(scope="module")
def traced():
    out = run_cell(tiny_cell(), SEED, 0.0, True, device="cpu",
                   per_layer={**spec.metrics(), "_keep": _Keep})
    return out, _Keep.stretch


def test_sound_traced_run(traced):
    out, stretch = traced
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    # the host-span and FLOP readers read the cell; the device's and the
    # mla_moe.* readers need a card
    assert {"decode.host_ms_per_step", "step_mfu"} <= set(out["metrics"])
    assert not set(METRICS) & set(out["metrics"])
    m = tiny_cell()["config"]["model"]
    # the traced file is the first of the window
    shape = _driver().shape(tiny_cell()["traffic"], 1)
    assert shape.budget == 16 and stretch.rows == 1
    assert stretch.batches == [{"rows": 1, "prefix": [shape.prompt_tokens],
                                "steps": [16]}]
    assert stretch.model_flops == pytest.approx(
        counts.row_flops(m, shape.prompt_tokens, 16))
    assert stretch.decode == {"latent_itemsize": 4}


def test_sound_run_reads_below_the_controls():
    out = run_cell(tiny_cell(), SEED + 2, 0.0, False, device="cpu",
                   reference_control="bf16")
    assert out["correct"] is True, out["checks"]
    low = out["control"]
    assert low["correct"] is False
    assert max(out["readings"]["decoder_gap"]) * 10 \
        < max(low["readings"]["decoder_gap"])


def _late_column(monkeypatch):
    """Each decode step writes its latent column one slot late (on the
    device, so that a graph captures it; the last slot's is zeroed)."""
    import whisperjav_tpu_torch.models.deepseek_v3.model as dm
    inner = dm.step_forward

    def step(model, token, pos, cache):
        logits = inner(model, token, pos, cache)
        at = pos.long()
        late = (at + 1).clamp(max=cache.ckv.shape[2] - 1)
        cache.ckv.index_copy_(2, late, cache.ckv.index_select(2, at))
        cache.ckv.index_fill_(2, at, 0.0)
        return logits
    monkeypatch.setattr(dm, "step_forward", step)


def _bias_dropped(monkeypatch):
    """The routing chooses by the scores alone."""
    import whisperjav_tpu_torch.models.deepseek_v3.model as dm

    def route(x, p, j, cfg):
        s = torch.sigmoid(x.float() @ p["router"][j].float())
        ids = torch.topk(s, cfg.experts_per_token, dim=-1).indices
        w = s.gather(1, ids)
        return ids, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale
    monkeypatch.setattr(dm, "route", route)


def _unpenalised_choice(monkeypatch):
    """Each step chooses the largest logit before the repetition penalty
    (the log-probability still taken after it): the port's shared decode
    loop with that one line changed."""
    import whisperjav_tpu_torch.models.qwen.model as qm
    sound = "tok = torch.argmax(lg, dim=-1)"
    src = inspect.getsource(qm._decode)
    assert src.count(sound) == 1
    scope = dict(vars(qm))
    exec(src.replace(sound, "tok = torch.argmax(cur, dim=-1)"), scope)
    monkeypatch.setattr(qm, "_decode", scope["_decode"])


# the penalty moves a greedy choice only where a token served before is
# near the top of a later step's logits: SEED's first file has no such
# step at the test widths (the unpenalised choice reads 0 there), the
# next seed's has
@pytest.mark.parametrize("fault,number,seed", [
    (_late_column, "decoder_gap", SEED), (_bias_dropped, "route_gap", SEED),
    (_unpenalised_choice, "select_lead", SEED + 1)],
    ids=["late_column", "bias_dropped", "unpenalised_choice"])
def test_fault_is_not_correct(monkeypatch, fault, number, seed):
    fault(monkeypatch)
    out = run_cell(tiny_cell(), seed, 0.0, False, device="cpu")
    assert out["correct"] is False
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_a_rerun_that_parts_is_not_correct(monkeypatch):
    """The choices the check reads are a second serving's: one that does
    not give the first's tokens is counted, and the run not correct."""
    drv = _driver()
    inner = drv.rerun

    def rerun(program, ids):
        res, routes = inner(program, ids)
        return res._replace(tokens=res.tokens + 1), routes
    monkeypatch.setattr(drv, "rerun", rerun)
    out = run_cell(tiny_cell(), SEED, 0.0, False, device="cpu")
    assert out["correct"] is False
    assert out["readings"]["rerun_mismatch"] == [1.0]


def test_the_rerun_keeps_every_choice_and_no_span(monkeypatch):
    """A second serving records each expert layer's choice at every
    position the prefill and the steps ran, leaves the traced recorder
    the latest, and gives the first serving's result."""
    from whisperjav_tpu_torch.utils import tracer
    drv = _driver()
    cell = tiny_cell()
    program = drv.build(cell, SEED, "cpu")
    monkeypatch.setenv("WJAV_TRACE_BATCHES", "1")
    ids = drv.file(program, 1)[1]
    drv.serve(program, (1, ids))
    latest = tracer.latest()
    res, routes = drv.rerun(program, ids)
    assert tracer.latest() is latest
    assert all(torch.equal(a, b) for a, b in zip(res, program.served[1][1]))
    m = cell["config"]["model"]
    n_moe = m["n_layers"] - m["first_dense"]
    assert routes.shape == (n_moe, len(ids) + drv.budget(cell["traffic"]),
                            m["experts_per_token"])


@pytest.mark.cuda
@pytest.mark.parametrize("fault,number", [
    (_late_column, "decoder_gap"), (_unpenalised_choice, "select_lead")],
    ids=["late_column", "unpenalised_choice"])
def test_fault_is_not_correct_on_the_card(monkeypatch, fault, number):
    """The cell itself, at its published widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fault(monkeypatch)
    out = run_cell(spec.workload(CELL), SEED, 0.0, False, device="cuda")
    print(out["checks"])
    assert out["correct"] is False, out["checks"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_bf16_path_departs():
    out = run_cell(tiny_cell(), SEED, 0.0, False, device="cpu",
                   program_control="bf16_weights")
    assert out["correct"] is False
    # the embedding and norms, the router and bias, the cache
    assert out["readings"]["departures"] == [3.0]


def test_bf16_cache_alone_departs(monkeypatch):
    """The cache the backend makes is read, not inferred from the
    embedding's type."""
    import whisperjav_tpu_torch.models.deepseek_v3.model as dm
    inner = dm.LatentCache.zeros

    def zeros(cfg, b, t_max, dtype, device):
        return inner(cfg, b, t_max, torch.bfloat16, device)
    monkeypatch.setattr(dm.LatentCache, "zeros", staticmethod(zeros))
    out = run_cell(tiny_cell(), SEED, 0.0, False, device="cpu")
    assert out["correct"] is False
    assert out["readings"]["departures"] == [1.0]


def test_config_holds_the_published_sizes():
    """The source's keys, read as the port's loader reads a checkpoint's
    config.json, give the port's Kanana-2-30B-A3B row; the served
    penalty and temperature are the backend's defaults; the traffic's
    prompts and budget are the cell's."""
    from whisperjav_tpu_torch.models.deepseek_v3.convert import (
        config_from_hf,
    )
    from whisperjav_tpu_torch.models.deepseek_v3.model import DSV3_SIZES
    from whisperjav_tpu_torch.translate.local_backend import LocalLMBackend
    cfg = spec.config("kanana-2-30b-a3b")
    row = DSV3_SIZES["kanana-2-30b-a3b"]
    assert config_from_hf(cfg, name=row.name) == row
    assert cfg["model"] == dataclasses.asdict(row)
    assert cfg["reduced"] == []
    assert (cfg["hidden_size"], cfg["num_hidden_layers"], cfg["kv_lora_rank"],
            cfg["n_routed_experts"], cfg["num_experts_per_tok"]) == (
        2048, 48, 512, 128, 6)
    assert row.latent_dim == 576
    defaults = inspect.signature(LocalLMBackend).parameters
    serve = cfg["serve"]
    assert serve["repetition_penalty"] == defaults["repetition_penalty"] \
        .default == 1.05
    assert serve["temperature"] == defaults["temperature"].default == 0.0
    drv, traffic = _driver(), spec.traffic("srt-cues-30")
    assert drv.prompt_range(traffic) == (1384, 2464)
    shapes = [drv.shape(traffic, i) for i in range(200)]
    for shape in shapes:
        assert len(shape.durations) == 30 and shape.budget == 480
        assert 1384 <= shape.prompt_tokens <= 2464
        assert all(1.0 <= d <= 6.0 for d in shape.durations)
        assert all(0.2 <= g <= 3.0 for g in shape.gaps)
        assert shape.source_s == pytest.approx(sum(shape.durations)
                                               + sum(shape.gaps))
    # prompts vary as translate_srt's do, over more than one cache length
    lengths = [s.prompt_tokens for s in shapes]
    assert max(lengths) - min(lengths) > 200
    assert len({dm.cache_positions(n, 480) for n in lengths}) > 1
    assert drv.cache_lengths(traffic) == [2048, 2304, 2560, 2816, 3072]


def test_files_repeat_for_a_seed_and_part_across_seeds():
    """A file's prompt is the same for a seed and index, another for
    another seed or index; its length is its index's shape's in every
    seed, and lengths vary over the indices; BOS first."""
    drv = _driver()
    cell = tiny_cell()
    traffic = cell["traffic"]
    progs = [drv.Program(cell["config"], s, torch.device("cpu"), traffic,
                         None, None) for s in (SEED, SEED, 7)]
    for p in progs:
        rng = np.random.default_rng([p.seed, 3])
        p.instruction = rng.integers(0, 512, traffic["instruction_tokens"])
        p.instruction[0] = 0
    a, b, c = (drv.file(p, 3)[1] for p in progs)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert not np.array_equal(a, drv.file(progs[0], 4)[1])
    assert len(a) == len(c) == drv.shape(traffic, 3).prompt_tokens
    assert len({len(drv.file(progs[0], i)[1]) for i in range(20)}) > 1
    assert a[0] == 0


def test_warm_up_reaches_every_cache_length(monkeypatch):
    """The warm-up runs the traffic's longest prompt over the cache its
    whole answer takes, then a short prompt over each cache length the
    traffic reaches, each at a 2-token budget; the window's files find
    their lengths among them. The cache type's probe runs eagerly: it
    claims no graph slot."""
    import whisperjav_tpu_torch.models.deepseek_v3.model as dm_
    from whisperjav_tpu_torch.models.qwen import step_graph
    drv = _driver()
    cell = tiny_cell()
    traffic = cell["traffic"]
    program = drv.build(cell, SEED, "cpu")
    claimed = []
    inner_claim = step_graph._claim

    def claim(model, device):
        claimed.append(device)
        return inner_claim(model, device)
    monkeypatch.setattr(step_graph, "_claim", claim)
    drv.cache_dtype(program)
    assert claimed == []
    calls = []
    inner = dm_.generate_text

    def generate_text(model, ids, n, max_new, **kwargs):
        calls.append((ids.shape[1], max_new, kwargs["cache_len"]))
        return inner(model, ids, n, max_new, **kwargs)
    monkeypatch.setattr(dm_, "generate_text", generate_text)
    drv.warm_up(program)
    lo, hi = drv.prompt_range(traffic)
    lengths = drv.cache_lengths(traffic)
    assert calls[0] == (hi, 2, dm.cache_positions(hi, 16))
    assert [c[2] for c in calls[1:]] == lengths
    assert all(c[1] == 2 and c[0] < lo for c in calls[1:])
    assert all(dm.cache_positions(n, 16) in lengths
               for n in range(lo, hi + 1))
    assert claimed and not program.served


def _span(name, a, b, **counters):
    return HostSpan(a, b, name, counters=counters)


MS = 1_000_000      # ns


def test_the_metrics_read_the_device_inside_the_spans():
    """Device busy [12, 18] ms in the prefill and 480 steps of 8 ms busy,
    2 ms idle each in the loop; a kernel before the prompt is read by
    none."""
    m = spec.config("kanana-2-30b-a3b")["model"]
    loop0 = 20 * MS
    spans = [_span("translate.prompt", 0, 30_000 * MS, prompt_tokens=2000,
                   budget=480, cues=30),
             _span("lm.prefill", 10 * MS, 20 * MS, routed_max=200,
                   routed_mean=94.0),
             _span("decode.loop", loop0, loop0 + 480 * 10 * MS, steps=480,
                   rows=1, start=2000)]
    device = [Span(-5 * MS, -1 * MS, "before", 7),
              Span(12 * MS, 18 * MS, "k", 7)]
    device += [Span(loop0 + (10 * t + 1) * MS, loop0 + (10 * t + 9) * MS,
                    "k", 7) for t in range(480)]
    stretch = Stretch(spans=device, wall_s=30.0, model=m,
                      decode={"latent_itemsize": 4})
    stretch.program_spans = spans
    read = {name: spec.metric(name).read(stretch) for name in METRICS}
    assert read["mla_moe.prefill_ms_per_ktok"] == pytest.approx(3.0)
    assert read["mla_moe.decode_step_ms"] == pytest.approx(8.0)
    least = sum(counts.step_bytes(m, 2000 + t, 4) for t in range(480))
    assert read["mla_moe.decode_hbm_pct"] == pytest.approx(
        100 * least / HBM_BYTES_S / (480 * 0.008))
    assert 0 < read["mla_moe.decode_hbm_pct"] < 100
    # no device trace, or the Qwen generator's loops (no prompt): nothing
    stretch.spans = []
    assert all(spec.metric(n).read(stretch) is None for n in METRICS)
    stretch.spans = device
    stretch.program_spans = [_span("qwen.batch", 0, 100, rows=32),
                             _span("decode.loop", 0, 10, steps=5, rows=4,
                                   start=625)]
    assert all(spec.metric(n).read(stretch) is None for n in METRICS)


def test_least_bytes_and_flops():
    m = spec.config("kanana-2-30b-a3b")["model"]
    # int8 attention 1.26 GB, six routed and the shared experts of 47
    # layers 1.77 GB, the dense layer 0.04 GB, the head 0.26 GB, with
    # scales and the f32 routers
    assert counts.weight_bytes(m) == pytest.approx(3.40e9, rel=0.01)
    assert counts.latent_bytes(m, 1, 4) == 48 * 576 * 4
    # 1,887 prompt tokens and 480 steps: ~20 TFLOP, the prefill most
    assert counts.row_flops(m, 1887, 480) == pytest.approx(2.0e13,
                                                           rel=0.01)
