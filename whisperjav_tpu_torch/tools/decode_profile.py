"""Decode step-time attribution by controlled ablation, on the port.

Each variant changes ONE cost source, and every (variant, budget) cell is
timed end to end (CUDA events around the run, one sync per cell; the
host clock on the CPU). Two token budgets per variant give

    seconds(budget) = intercept + slope * steps

so ``slope`` is the ms/step with the per-batch fixed work (cross-K/V
precompute, prefill) removed, and differences of slopes against ``base``
attribute the per-step cost of the ablated component (cross-K/V stream
length, int8 weight dequant, logit rules, self-cache size, layer count,
q/k/v fusion).

The step budget is ``decode_greedy(..., stop_at=b)``: both budgets of a
slope pair decode with the self cache sized for the variant's
``max_new_tokens``, so the slope is a per-step cost, not a cache-size
difference.

What the variants run on the card. ``base`` holds the int8 decoder
weights with separate q/k/v projections: its steps run the unfused
layers (int8 products in PyTorch, Kernel B's bf16 form for the
cross-attention), because the fused blocks read a fused ``wqkv``.
``fused_qkv`` is the engine's tree (q/k/v fused, then int8): its single
steps run the three fused blocks (Kernel B's terms form inside the cross
block). ``bf16_weights`` runs the unfused bf16 layers. Every row carries
the launches of each kernel wrapper in its run, and the summary the
launches per step of each variant, so the attribution says what it
measured. ``int4_cross_kv`` is not ported: its cells are error rows
carrying the decoder's message.

Timing discipline: after a warm-up sweep (``WARM_STEPS`` steps of each
cell, on its own allocations), the timed runs INTERLEAVE all cells of a
group round-robin for ``--iters`` rounds and take the per-cell median,
so drift biases every variant of a group equally. The
bf16 tree runs in its own phase first and is freed (``del``,
``gc.collect()``, ``torch.cuda.empty_cache()``) before the int8 groups;
each group frees its cells before the next.

Usage:

    python -m whisperjav_tpu_torch.tools.decode_profile [--model large-v2]
        [--batch 64] [--iters 3] [--device cuda] [--json OUT]

Prints one JSON line per cell plus a final attribution summary.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch
from torch import nn

# steps of each cell's warm-up run
WARM_STEPS = 2


def kernel_launches() -> Dict[str, int]:
    """The launch count of every kernel wrapper of the port, by name (the
    kernels inside the fused blocks as ``<name>_in_block``)."""
    from whisperjav_tpu_torch.ops.cuda import decode_attention as da
    from whisperjav_tpu_torch.ops.cuda import fused_decode as fd
    from whisperjav_tpu_torch.ops.cuda.encoder_attention import (
        encoder_attention,
    )
    fns = {"encoder_attention": encoder_attention,
           "decode_cross_attention": da.decode_cross_attention,
           "decode_cross_attention_bf16": da.decode_cross_attention_bf16,
           "decode_cross_attention_terms": da.decode_cross_attention_terms,
           "self_block": fd.self_block, "cross_block": fd.cross_block,
           "mlp_block": fd.mlp_block}
    fns.update({f"{k}_in_block": v for k, v in fd.inner.items()})
    return {name: fn.launches for name, fn in fns.items()}


def _decoder_only(model):
    """``model`` without its encoder (decode reads only the decoder)."""
    model.encoder = nn.Module()
    return model


def _build(model: str, batch: int, device: torch.device):
    from whisperjav_tpu_torch.models.whisper.config import WHISPER_SIZES
    from whisperjav_tpu_torch.models.whisper.quant import (
        fuse_qkv_weights, quantize_decoder_weights,
    )
    from whisperjav_tpu_torch.models.whisper.weights import init_params

    config = WHISPER_SIZES[model]
    gen = torch.Generator(device=device).manual_seed(0)
    params = _decoder_only(init_params(config, gen, dtype=torch.bfloat16,
                                       device=device))
    # the int8 tree with separate q/k/v, and the engine's tree (q/k/v
    # fused, then int8)
    params_q = quantize_decoder_weights(copy.deepcopy(params))
    params_qf = quantize_decoder_weights(
        fuse_qkv_weights(copy.deepcopy(params)))
    # encoder output stand-in: decode cost does not depend on xa values
    gen = torch.Generator(device=device).manual_seed(1)
    xa = (0.1 * torch.randn((batch, config.n_audio_ctx,
                             config.n_audio_state), generator=gen,
                            device=device)).to(torch.bfloat16)
    return config, params, params_q, params_qf, xa


def _sliced(model, config, n_layers: int):
    """A decoder of the first ``n_layers`` layers of ``model`` (views of
    its stacked block tensors; the cross-K/V follows them)."""
    from whisperjav_tpu_torch.models.whisper.model import Int8Weight
    out = copy.copy(model)
    out._modules = dict(model._modules)
    dec = copy.copy(model.decoder)
    dec._modules = dict(model.decoder._modules)
    dec._parameters = dict(model.decoder._parameters)
    blocks = nn.ParameterDict()
    for name, leaf in model.decoder.blocks.items():
        blocks[name] = (Int8Weight(leaf.q[:n_layers], leaf.s[:n_layers])
                        if isinstance(leaf, Int8Weight)
                        else nn.Parameter(leaf[:n_layers],
                                          requires_grad=False))
    dec.blocks = blocks
    out.decoder = dec
    out.config = dataclasses.replace(config, n_text_layer=n_layers)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="large-v2")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--budgets", type=int, nargs=2, default=(32, 128))
    ap.add_argument("--mid-budget", type=int, default=80,
                    help="extra base cell: early (lo→mid) vs late "
                         "(mid→hi) slope difference isolates self-cache "
                         "growth")
    ap.add_argument("--json", default=None)
    ap.add_argument("--group", type=int, default=None,
                    help="run only this phase-2 group index")
    ap.add_argument("--skip-bf16", action="store_true",
                    help="skip the separate bf16-weights phase")
    ap.add_argument("--device", default="cuda",
                    help="device to decode on (default cuda; a missing "
                         "card is an error)")
    args = ap.parse_args(argv)

    from whisperjav_tpu_torch.models.whisper.decode import (
        DecodeOptions, decode_greedy,
    )
    from whisperjav_tpu_torch.pipelines.engine import (
        release_device_memory, resolve_device,
    )

    device = resolve_device(args.device)
    on_cuda = device.type == "cuda"

    def mark(msg):
        print(f"decode_profile: {msg}", file=sys.stderr, flush=True)

    mark(f"building params on {device}")
    config, params, params_q, params_qf, xa = _build(args.model,
                                                     args.batch, device)
    mark("params ready")
    lo, hi = args.budgets

    def opts(budget, **kw):
        # EOT is suppressed in EVERY cell: the greedy loop exits early
        # when all rows finish, and with random weights the timestamp
        # rules drive rows to EOT at trajectory-dependent steps. Banning
        # EOT pins every cell to exactly `budget` steps.
        base = dict(max_new_tokens=budget, cross_kv_int8=True,
                    no_repeat_ngram_size=0,
                    suppress_tokens=(config.eot,))
        base.update(kw)
        if not base.get("suppress_tokens"):
            base["suppress_tokens"] = (config.eot,)   # rules_off too
        return DecodeOptions(**base)

    variants = {
        "base": dict(),
        "bucket448": dict(_slice=448),
        "bucket960": dict(_slice=960),
        # nibble-packed int4 cross-K/V: not ported (an error row)
        "int4_cross_kv": dict(cross_kv_int8=False, cross_kv_int4=True),
        "rules_off": dict(with_timestamps=False, suppress_blank=False,
                          suppress_tokens=()),
        "ngram3": dict(no_repeat_ngram_size=3),
        # greedy decoding draws no noise in the port at temperature 0;
        # the row stays for the table's sake
        "no_gumbel": dict(assume_greedy=True),
        # self-cache T_max ablation: the cache sized for 32 new tokens
        # instead of `hi`; compared against base AT stop_at=lo (same step
        # count), the gap ÷ lo is the per-step cost of the extra
        # (hi - 32) cache positions every layer reads
        "cache32": dict(_max_new=32),
        # layer-count ablation: the stacked block tensors sliced to the
        # first n layers; the extrapolated L→0 intercept is the per-STEP
        # fixed cost (loop, logit head, rules) no stream ablation sees
        "layers16": dict(_layers=16),
        "layers8": dict(_layers=8),
        # the engine's tree: q/k/v fused, then int8 — its single steps run
        # the fused blocks
        "fused_qkv": dict(_tree="fused"),
    }
    variants = {n: kw for n, kw in variants.items()
                if kw.get("_layers", 0) < config.n_text_layer}

    rows: List[Dict] = []
    failed = set()

    def make_variant(p, kw):
        """One variant = one model view and option set; the budget rides
        stop_at, so every (variant, budget) cell shares the cache size."""
        kw = dict(kw)
        t_slice = kw.pop("_slice", None)
        n_layers = kw.pop("_layers", None)
        max_new = kw.pop("_max_new", hi)
        if kw.pop("_tree", None) == "fused":
            p = params_qf
        xa_v = xa[:, :t_slice].contiguous() if t_slice else xa
        if n_layers:
            p = _sliced(p, config, n_layers)
        o = opts(max_new, **kw)

        def run(budget):
            res = decode_greedy(p, xa_v, o, stop_at=min(budget, max_new))
            res.tokens.cpu()
        return run

    def make_run(p, kw, budget):
        v = make_variant(p, kw)
        return lambda steps=budget: v(steps)

    launches: Dict[tuple, Dict[str, int]] = {}

    @torch.inference_mode()
    def timed(key, run):
        """Seconds of one run of the cell; its first timed run also
        records the launches of each kernel in it."""
        before = None if key in launches else kernel_launches()
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            run()
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1000.0
        else:
            t0 = time.perf_counter()
            run()
            sec = time.perf_counter() - t0
        if before is not None:
            after = kernel_launches()
            launches[key] = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}
        return sec

    @torch.inference_mode()
    def warm(run):
        """WARM_STEPS steps of the cell: its first calls and allocations
        (the cache is sized for the variant's max_new_tokens whatever
        the step count)."""
        run(WARM_STEPS)

    def emit(name, budget, sec, key):
        row = {"variant": name, "budget": budget,
               "seconds": round(sec, 4),
               "ms_per_token_naive": round(1000 * sec / budget, 3),
               "launches": launches.get(key, {})}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def error_row(name, budget, e):
        row = {"variant": name, "budget": budget,
               "error": str(e).splitlines()[0][:200]}
        if budget is None:
            del row["budget"]
        rows.append(row)
        print(json.dumps(row), flush=True)

    # ---- phase 1: bf16 weights alone ----
    slopes: Dict[str, float] = {}
    runs = None
    if not args.skip_bf16:
        try:
            runs = {b: make_run(params, {}, b) for b in (lo, hi)}
            for r in runs.values():
                warm(r)
            t = {b: float(np.median([timed(("bf16_weights", b), r)
                                     for _ in range(args.iters)]))
                 for b, r in runs.items()}
            for b in (lo, hi):
                emit("bf16_weights", b, t[b], ("bf16_weights", b))
            slopes["bf16_weights"] = (1000.0 * (t[hi] - t[lo])
                                      / (hi - lo))
        except Exception as e:
            error_row("bf16_weights", None, e)
    del params, runs                 # free the bf16 tree before phase 2
    release_device_memory(device)

    # ---- phase 2: small interleaved groups on the int8 tree ----
    # each group has its own base control (drift cancels group-locally)
    groups = [["bucket448", "bucket960"],
              ["int4_cross_kv", "rules_off"],
              ["ngram3", "no_gumbel", "__mid__"],
              ["layers16", "layers8"],
              ["cache32"],
              ["fused_qkv"]]
    group_base: Dict[int, float] = {}
    med: Dict[tuple, float] = {}
    slope_early = slope_late = None
    cache32_ms = None

    for gi, names in enumerate(groups):
        if args.group is not None and gi != args.group:
            continue
        gcells: Dict[tuple, object] = {}
        for b in (lo, hi):
            gcells[("base", b)] = make_run(params_q, {}, b)
        for name in names:
            if name == "__mid__":
                gcells[("base", args.mid_budget)] = make_run(
                    params_q, {}, args.mid_budget)
            elif name == "cache32":
                # single-budget cell: compared against base at the SAME
                # step count (lo), so the delta is pure cache-size cost
                gcells[(name, lo)] = make_run(params_q,
                                              variants[name], lo)
            elif name in variants:
                for b in (lo, hi):
                    gcells[(name, b)] = make_run(params_q,
                                                 variants[name], b)

        for key in list(gcells):
            try:
                mark(f"warmup {key}")
                warm(gcells[key])
            except Exception as e:
                error_row(key[0], key[1], e)
                failed.add(key)
                del gcells[key]

        samples: Dict[tuple, List[float]] = {k: [] for k in gcells}
        for _ in range(args.iters):                 # round-robin rounds
            for key, run in list(gcells.items()):
                try:
                    samples[key].append(timed(key, run))
                except Exception as e:
                    error_row(key[0], key[1], e)
                    del gcells[key], samples[key]

        gmed = {k: float(np.median(v)) for k, v in samples.items()
                if v}
        for (name, b), sec in gmed.items():
            emit(f"{name}@g{gi}", b, sec, (name, b))
        if ("base", lo) in gmed and ("base", hi) in gmed:
            group_base[gi] = (1000.0 * (gmed[("base", hi)]
                                        - gmed[("base", lo)]) / (hi - lo))
            # self-cache growth (only the group holding the mid cell):
            # late slope (mid→hi) minus early slope (lo→mid), all three
            # cells same-group so drift cancels
            k_mid = ("base", args.mid_budget)
            if k_mid in gmed:
                slope_early = (1000.0 * (gmed[k_mid] - gmed[("base", lo)])
                               / (args.mid_budget - lo))
                slope_late = (1000.0 * (gmed[("base", hi)] - gmed[k_mid])
                              / (hi - args.mid_budget))
        if ("cache32", lo) in gmed and ("base", lo) in gmed:
            cache32_ms = (1000.0 * (gmed[("base", lo)]
                                    - gmed[("cache32", lo)]) / lo)
        for name in names:
            k_lo, k_hi = (name, lo), (name, hi)
            if k_lo in gmed and k_hi in gmed:
                slopes[name] = (1000.0 * (gmed[k_hi] - gmed[k_lo])
                                / (hi - lo))
                slopes[f"base@g{gi}"] = group_base.get(gi)
        med.update(gmed)
        del gcells, samples
        release_device_memory(device)

    # global base slope = median of the per-group base controls
    base_vals = [v for v in group_base.values() if v is not None]
    if base_vals:
        slopes["base"] = float(np.median(base_vals))

    def gdelta(name):
        """variant minus its own group's base control."""
        for gi, names in enumerate(groups):
            if name in names and name in slopes and gi in group_base:
                return slopes[name] - group_base[gi]
        return None

    def _neg(v):
        return -v if v is not None else None

    def r2(v):
        return round(v, 2) if v is not None else None

    # launches per decode step of each variant: the hi cell's less the lo
    # cell's, over the step difference (the prefill cancels)
    per_step: Dict[str, Dict[str, float]] = {}
    for name in ["bf16_weights", "base", *variants]:
        a, b = launches.get((name, hi)), launches.get((name, lo))
        if a is not None and b is not None:
            per_step[name] = {k: round((a.get(k, 0) - b.get(k, 0))
                                       / (hi - lo), 3)
                              for k in sorted(set(a) | set(b))}

    summary = {
        "model": args.model, "batch": args.batch,
        "groups": groups,
        "device": str(device),
        "ms_per_step": {k: round(v, 2) for k, v in slopes.items()
                        if v is not None},
        "ms_per_step_base_early": r2(slope_early),
        "ms_per_step_base_late": r2(slope_late),
        "launches_per_step": per_step,
        "attribution_ms": {
            # every delta is variant minus its OWN group's base control
            "cross_kv_1500_vs_448": r2(_neg(gdelta("bucket448"))),
            "cross_kv_1500_vs_960": r2(_neg(gdelta("bucket960"))),
            # int8 weight stream vs bf16 (phase-boundary: bound only)
            "int8_weight_saving": (
                r2(slopes["bf16_weights"] - slopes["base"])
                if "bf16_weights" in slopes and "base" in slopes
                else None),
            "int4_kv_saving": r2(_neg(gdelta("int4_cross_kv"))),
            "logit_rules": r2(_neg(gdelta("rules_off"))),
            "ngram_ban": r2(gdelta("ngram3")),
            "gumbel_rng": r2(_neg(gdelta("no_gumbel"))),
            # self-cache stream: cost of the (hi − 32) extra cache
            # positions every layer reads, from the cache32 cell
            "self_cache_tmax": r2(cache32_ms),
            # both budgets share the cache size, so early-vs-late slope is
            # a drift check (should be ~0)
            "self_cache_growth": (r2(slope_late - slope_early)
                                  if slope_early is not None else None),
        },
    }
    # affine fit ms/step = a*L + b over the layer ablation: `a` is the
    # per-layer cost, `b` the per-step fixed cost (loop, logit head, rule
    # masks) invisible to stream ablations; all points from the layer
    # group's own cells and control
    layer_gi = next((gi for gi, names in enumerate(groups)
                     if "layers8" in names), None)
    pts = []
    if layer_gi is not None and layer_gi in group_base:
        pts.append((config.n_text_layer, group_base[layer_gi]))
    for n, name in ((16, "layers16"), (8, "layers8")):
        if name in slopes:
            pts.append((n, slopes[name]))
    if len(pts) >= 2:
        a, b = np.polyfit([p[0] for p in pts], [p[1] for p in pts], 1)
        summary["layer_decomposition"] = {
            "ms_per_layer": round(float(a), 3),
            "ms_fixed_per_step": round(float(b), 2),
            "points": {str(n): round(s, 2) for n, s in pts}}

    print(json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
