"""The translator's on-card LM through the port's
``LocalLMBackend.generate_ids``, the call ``translate_srt`` reaches for
every prompt of the ``tpu-local`` provider (``translate/service.py`` ->
``LocalLMBackend.__call__``: the chat encoding, then ``generate_ids``).

The driver draws the configuration's weights on the device from the
seed, a layer at a time, with the benchmark's own drawer
(``h100bench/deepseek_v3_weights.py``), and hands that source to a
``LocalLMBackend``, which places the model as it places a checkpoint:
each matrix quantised to int8 as it reaches the card. The backend keeps
its defaults (greedy, repetition penalty 1.05) and the traffic's budget
of new tokens. A file is one prompt of the traffic's cues, served B=1
by one ``generate_ids`` call, in order, as ``translate_srt`` sends its
batches; its source seconds run from the first cue's start to the last
cue's end.

The traffic (``traffic/<mix>.json``): a file's ``windows_per_file``
cues, their durations (``group_s``, as the one generator draws a
``vad_groups`` file's windows), the gaps between them (``gap_s``) and
each cue's tokens (``cue_tokens``) are drawn uniformly from the
traffic's ``layout_seed`` and the file's index, so prompts differ in
length from file to file as ``translate_srt``'s do, while every seed's
window serves the same work;
a prompt is a fixed block of ``instruction_tokens`` (BOS first: the
instruction and the numbered-line protocol) and then each cue's tokens,
ids drawn from ``--seed`` over the vocabulary (the repository holds no
tokenizer). The budget is ``answer_tokens_per_cue`` a cue: seeded
weights emit no EOS, so every prompt runs its whole budget. The prompts'
lengths reach several cache lengths (``model.cache_positions``); the
warm-up captures the decode step for each.

The check reads ``SAMPLE_FILES`` files drawn from the seed among those
the window served. After the window each is served again through the
same backend with its steps run eagerly (no graph: the forward a replay
runs, which the port's tests hold equal to the replay bit for bit) and
the port's ``route`` wrapped, to keep every expert layer's choice at
every position: float32 rounding flips a few near-ties of the k-th and
the next expert in a long prompt, and what a flip changes reaches every
later position through attention and flips more, so the reference
follows the program's choices and judges them apart. The plain
reference (``reference/deepseek_v3.py``), given the weights drawn again
from the seed a layer at a time, reads each:

- ``decoder_gap``: |the program's summed penalised log-probability of
  the served tokens (``avg_logprob * (length + 1)``) - the reference's,
  reading the same prompt, tokens and choices of experts| over the
  tokens served, nats a token: the prefill, every absorbed step through
  the latent cache, the experts' weights, the penalty and the head;
- ``select_lead``: the widest lead, over the steps, of the reference's
  largest penalised logit over that of the token the program served, in
  nats: the greedy choice under the repetition penalty;
- ``route_gap``: the widest, over expert layers and positions, of how
  far the program's chosen experts fall short of the reference's own
  top choice in ``sigmoid(h W_r) + bias`` (0 where they are its own):
  the choice, the correction bias in it;
- ``rerun_mismatch``: the files whose second serving did not give the
  served tokens and log-probability bit for bit (their choices are then
  not the served path's);
- ``departures``: the precisions the configuration states that the
  built program does not keep (:func:`departures`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from h100bench import deepseek_v3_weights
from reference.deepseek_v3 import CONTROLS, read_rows  # noqa: F401
from roofline import deepseek_v3 as counts
from whisperjav_tpu_torch.models.deepseek_v3 import convert as dconv
from whisperjav_tpu_torch.models.deepseek_v3 import model as dm
from whisperjav_tpu_torch.models.layers import Int8Weight
from whisperjav_tpu_torch.models.qwen import step_graph
from whisperjav_tpu_torch.models.qwen.tokenizer import QwenTokenizer
from whisperjav_tpu_torch.translate.local_backend import LocalLMBackend

# files the check reads, drawn from the seed among those served
SAMPLE_FILES = 2
NUMBERS = ("decoder_gap", "select_lead", "route_gap", "rerun_mismatch",
           "departures")
# the program's own lower path: the embedding, norms, router and latent
# cache at bf16
PROGRAM_CONTROLS = ("bf16_weights",)
MATRICES = {"blocks": ("wq", "wkva", "wkvb", "wo"),
            "dense": ("w_gu", "w_down"),
            "moe": ("w_gu", "w_down", "shared_gu", "shared_down")}


def sizes(cfg: dict) -> dm.DeepseekV3Config:
    """The port's sizes of the configuration's model: its ``model`` row,
    which the source's keys, as ``convert.config_from_hf`` reads them,
    must give."""
    m = cfg["model"]
    row = dm.DSV3_SIZES[m["name"]]
    if dataclasses.asdict(row) != m or dconv.config_from_hf(
            cfg, name=m["name"]) != row:
        raise ValueError(f"the configuration's model is not the port's "
                         f"{m['name']!r}")
    return row


@dataclasses.dataclass(frozen=True)
class Shape:
    """A file's shape: cue durations and gaps (seconds), each cue's
    tokens, the instruction block's tokens and the budget."""
    durations: tuple
    gaps: tuple
    cue_tokens: tuple
    instruction: int
    budget: int

    @property
    def source_s(self) -> float:
        """From the first cue's start to the last cue's end."""
        return float(sum(self.durations) + sum(self.gaps))

    @property
    def prompt_tokens(self) -> int:
        return self.instruction + sum(self.cue_tokens)


def budget(traffic: dict) -> int:
    """New tokens a prompt: ``answer_tokens_per_cue`` a cue."""
    return (int(traffic["windows_per_file"])
            * int(traffic["answer_tokens_per_cue"]))


def shape(traffic: dict, index: int) -> Shape:
    """File ``index``'s shape, drawn from the traffic's ``layout_seed`` and
    the index alone: the same in every seed's window."""
    n = int(traffic["windows_per_file"])
    rng = np.random.default_rng([int(traffic["layout_seed"]), 1, index])
    durations = rng.uniform(*traffic["group_s"], n)
    gaps = rng.uniform(*traffic["gap_s"], n - 1)
    lo, hi = traffic["cue_tokens"]
    tokens = rng.integers(lo, hi + 1, n)
    return Shape(tuple(float(d) for d in durations),
                 tuple(float(g) for g in gaps),
                 tuple(int(t) for t in tokens),
                 int(traffic["instruction_tokens"]), budget(traffic))


def prompt_range(traffic: dict) -> tuple:
    """The shortest and the longest prompt the traffic can draw."""
    n, (lo, hi) = int(traffic["windows_per_file"]), traffic["cue_tokens"]
    head = int(traffic["instruction_tokens"])
    return head + n * int(lo), head + n * int(hi)


def cache_lengths(traffic: dict) -> List[int]:
    """Every latent cache length the traffic's prompts and budget reach
    (``model.cache_positions``), shortest first."""
    lo, hi = prompt_range(traffic)
    return sorted({dm.cache_positions(n, budget(traffic))
                   for n in range(lo, hi + 1)})


@dataclasses.dataclass
class Program:
    """The backend under test and what the driver keeps of its files:
    each file's prompt and result."""
    cfg: dict
    seed: int
    device: torch.device
    traffic: dict
    backend: LocalLMBackend
    instruction: np.ndarray
    served: Dict[int, tuple] = dataclasses.field(default_factory=dict)


def build(cell: dict, seed: int, device,
          control: Optional[str] = None) -> Program:
    """The backend, placed from the seeded draw as the configuration
    serves it (with ``control``, one of PROGRAM_CONTROLS, switched on)."""
    if control not in (None, *PROGRAM_CONTROLS):
        raise ValueError(f"unknown program control {control!r}")
    cfg = cell["config"]
    serve = cfg["serve"]
    dtype = (torch.bfloat16 if control == "bf16_weights"
             else getattr(torch, serve["weights"]))
    traffic = cell["traffic"]
    backend = LocalLMBackend(
        params=deepseek_v3_weights.Source(cfg["model"], seed, device, dtype),
        cfg=sizes(cfg), tokenizer=QwenTokenizer(),
        max_new_tokens=budget(traffic),
        temperature=serve["temperature"],
        repetition_penalty=serve["repetition_penalty"], device=device)
    rng = np.random.default_rng([seed, 3])
    m = cfg["model"]
    instruction = rng.integers(0, m["vocab_size"],
                               int(traffic["instruction_tokens"]))
    instruction[0] = m["bos_id"]
    return Program(cfg, seed, torch.device(device), traffic, backend,
                   instruction)


def cache_dtype(program: Program) -> torch.dtype:
    """The type of the latent cache the backend makes: one eager call (no
    graph captured) on a two-token prompt at a one-token budget, with the
    port's ``LatentCache.zeros`` wrapped to read what it was asked for."""
    made = []
    inner = dm.LatentCache.__dict__["zeros"]
    inner_claim = step_graph._claim

    def zeros(*args, **kwargs):
        cache = inner.__func__(*args, **kwargs)
        made.append(cache.ckv.dtype)
        return cache
    backend = program.backend
    budget = backend.max_new_tokens
    dm.LatentCache.zeros = staticmethod(zeros)
    step_graph._claim = lambda model, device: None
    try:
        backend.max_new_tokens = 1
        backend.generate_ids(program.instruction[:2].tolist())
    finally:
        backend.max_new_tokens = budget
        dm.LatentCache.zeros = inner
        step_graph._claim = inner_claim
    (dtype,) = set(made)
    return dtype


def departures(program: Program) -> int:
    """The precisions the configuration states that the built program
    does not keep: the embedding's and the norms', the router's and the
    correction bias's, the latent cache the backend makes
    (:func:`cache_dtype`), every matrix and the head in int8."""
    serve, model = program.cfg["serve"], program.backend.model
    stated = getattr(torch, serve["weights"])
    router = getattr(torch, serve["router"])
    norms = [model.blocks[n] for n in ("ln1", "ln2", "kv_norm")]
    int8 = serve["matmuls"] == "int8"
    return (int(any(t.dtype != stated for t in [model.tok_emb, model.ln_f,
                                                *norms]))
            + int(any(model.moe[n].dtype != router
                      for n in ("router", "bias")))
            + int(cache_dtype(program)
                  != getattr(torch, serve["latent_cache"]))
            + int(any(isinstance(model[g][n], Int8Weight) != int8
                      for g, names in MATRICES.items() for n in names))
            + int(("lm_head_q" in model) != (serve["lm_head"] == "int8")))


def _cue_ids(program: Program, index: int, n: int) -> np.ndarray:
    rng = np.random.default_rng([program.seed, 4, index])
    return rng.integers(0, program.cfg["model"]["vocab_size"], n)


def file(program: Program, index: int) -> tuple:
    """File ``index``: (index, its prompt's ids): the instruction block,
    then its :func:`shape`'s cue tokens, ids drawn from the seed and the
    index."""
    n = sum(shape(program.traffic, index).cue_tokens)
    return index, np.concatenate([program.instruction,
                                  _cue_ids(program, index, n)])


def warm_up(program: Program) -> None:
    """The traffic's longest prompt at a 2-token budget over the cache
    its whole answer would take, so that the allocator holds the blocks
    the window's prefills and caches take; then, on a short prompt at a
    2-token budget, the decode step captured for every cache length the
    traffic reaches (:func:`cache_lengths`), each cache where a file's
    will lie."""
    traffic, model = program.traffic, program.backend.model
    longest = prompt_range(traffic)[1]
    head = program.instruction
    prompts = [(np.concatenate([head, _cue_ids(program, 0, longest
                                               - len(head))]),
                dm.cache_positions(longest, budget(traffic)))]
    prompts += [(head[:16], n) for n in cache_lengths(traffic)]
    for ids, n in prompts:
        dm.generate_text(model, torch.tensor([ids.tolist()],
                                             device=program.device),
                         torch.tensor([len(ids)]), 2,
                         repetition_penalty=program.backend
                         .repetition_penalty, cache_len=n)


def serve(program: Program, inputs: tuple, timed: bool = False) -> tuple:
    """Generate one :func:`file`'s answer; (its source seconds, prompts
    attempted, prompts answered)."""
    index, ids = inputs
    cues = shape(program.traffic, index)
    res = program.backend.generate_ids(ids.tolist(),
                                       cues=len(cues.durations))
    program.served[index] = (ids, res)
    return cues.source_s, 1, 1


def _steps(program: Program, res) -> int:
    """The steps a result's loop ran: the tokens to the first EOS, that
    included, within the budget."""
    return min(int(res.length[0]) + 1, budget(program.traffic))


def stretch(program: Program) -> dict:
    """The profiled file's :class:`Stretch` fields: the model's sizes, the
    cache's bytes an element, the model's operations
    (``roofline/deepseek_v3.row_flops``) and one row; after a sync."""
    m = program.cfg["model"]
    ids, res = program.served[max(program.served)]
    steps = _steps(program, res)
    itemsize = getattr(torch, program.cfg["serve"]["latent_cache"]).itemsize
    return {"batches": [{"rows": 1, "prefix": [len(ids)],
                         "steps": [steps]}],
            "model": m, "decode": {"latent_itemsize": itemsize},
            "model_flops": counts.row_flops(m, len(ids), steps), "rows": 1}


def rerun(program: Program, ids: np.ndarray) -> tuple:
    """Serve ``ids`` again, its steps eager and the port's ``route``
    wrapped: (the result, each expert layer's choice at every position
    the prefill and the steps ran, (expert layers, positions, k) on the
    host). No spans: the traced file's recorder stays the latest."""
    n_moe = program.backend.cfg.n_moe
    log: List[list] = [[] for _ in range(n_moe)]
    inner_route, inner_claim = dm.route, step_graph._claim
    traced = os.environ.pop("WJAV_TRACE_BATCHES", None)

    def route(x, p, j, cfg):
        ids_, w = inner_route(x, p, j, cfg)
        log[j].append(ids_)
        return ids_, w
    dm.route = route
    step_graph._claim = lambda model, device: None
    try:
        res = program.backend.generate_ids(ids.tolist())
    finally:
        dm.route, step_graph._claim = inner_route, inner_claim
        if traced is not None:
            os.environ["WJAV_TRACE_BATCHES"] = traced
    return res, torch.stack([torch.cat(j) for j in log]).cpu()


def kept(program: Program) -> List[dict]:
    """The files the check reads, on the host; after a sync. Each: its
    prompt, the tokens it served to the first EOS (that included), their
    summed log-probability, the choices of experts of its second serving
    (:func:`rerun`) and whether that serving gave the same tokens and
    log-probability."""
    rng = np.random.default_rng([program.seed, 6])
    served = sorted(program.served)
    pick = sorted(rng.permutation(len(served))[:SAMPLE_FILES])
    out = []
    for i in pick:
        ids, res = program.served[served[i]]
        again, routes = rerun(program, ids)
        n = int(res.length[0])
        out.append({"prompt": ids,
                    "tokens": res.tokens[0, :_steps(program, res)]
                    .cpu().numpy(),
                    "total": float(res.avg_logprob[0]) * (n + 1),
                    "routes": routes,
                    "mismatch": int(not all(torch.equal(a, b) for a, b in
                                            zip(res, again)))})
    return out


def judge(cell: dict, rows: list, seed: int, device, departed: int = 0,
          control: Optional[str] = None) -> tuple:
    """(readings, the control's readings or None) of the files
    :func:`kept` gives; ``departed`` is the program's :func:`departures`.
    With ``control`` (``CONTROLS``) it also reads the reference one
    precision lower in the program's place."""
    cfg = cell["config"]
    source = deepseek_v3_weights.Source(
        cfg["model"], seed, device, getattr(torch, cfg["serve"]["weights"]))
    ref = read_rows(source, cfg["model"], [r["prompt"] for r in rows],
                    [r["tokens"] for r in rows], device,
                    cfg["serve"]["repetition_penalty"], control,
                    routes=[r["routes"] for r in rows])
    readings = {k: [] for k in NUMBERS}
    readings["departures"].append(departed)
    lows = {k: [] for k in NUMBERS}
    lows["departures"].append(0)
    for r, got in zip(rows, ref):
        scored = float(len(r["tokens"]))
        readings["decoder_gap"].append(abs(r["total"] - got["sum"]) / scored)
        readings["select_lead"].append(got["lead"])
        readings["route_gap"].append(got["route_gap"])
        readings["rerun_mismatch"].append(r["mismatch"])
        if control:
            lows["decoder_gap"].append(abs(got["low_sum"] - got["sum"])
                                       / scored)
            lows["select_lead"].append(got["low_lead"])
            lows["route_gap"].append(got["low_route_gap"])
            lows["rerun_mismatch"].append(0)
    return readings, (lows if control else None)
