"""Plain float32 DeepSeek-V3-block LM (Kanana-2-30B-A3B's), teacher-forced
along tokens given to it, with the repetition penalty: their
log-probabilities, and how far each greedy choice falls short of the
reference's own.

The yardstick that decides ``correct`` for the translator's LM. It
imports torch and numpy only (nothing of the port, nothing of JAX),
computes in float32 with TF32 off, with no cache and no batching: one
full causal forward a row, in the full form of latent attention, every
routed expert computed densely under a gate vector that is zero off the
chosen ones. It goes layer by layer over the rows it judges, asking a
``source`` for each layer's weights as drawn (``source.top()``,
``source.layer(i)``: leaves named as the port's ``place`` reads them,
(in, out) matrices, experts stacked first), so that a model larger than
the card's memory in float32 is read a layer at a time.

The block (Hugging Face ``DeepseekV3ForCausalLM``, ``modeling_deepseek_v3
.py``): RMSNorm; ``q = h W_q`` split into ``q_nope`` and ``q_pe`` a head;
``[c~, k_pe] = h W_kva``, ``c = RMSNorm(c~)``, ``[k_nope, v] = c W_kvb``
a head; rotary embeddings (``inv_freq = theta^(-2i/dr)``) on ``q_pe`` and
the one ``k_pe`` shared by every head, interleaved
(``apply_rotary_pos_emb_interleave``: pairs (2i, 2i + 1) reordered into
halves, then ``x cos + rotate_half(x) sin``); causal softmax of
``[q_nope, q_pe] . [k_nope, k_pe] / sqrt(qk_nope + qk_rope)``, times
``v``, then ``W_o``. The leading ``first_dense`` layers a SwiGLU; the
others ``DeepseekV3MoE``: ``s = sigmoid(h W_r)``, the top
``experts_per_token`` of ``s + e_score_correction_bias`` (one group),
weights ``s[ids] / (sum + 1e-20) * routed_scaling_factor``, plus the
shared experts' SwiGLU. A final RMSNorm and the untied head.

Departures, each kept because the program's served path runs it:

- every matrix and the head are int8 per output channel (the scale max
  |w| over the input axis / 127 + 1e-12, codes rounded half to even),
  worked out here from the drawn weights and taken back to float32;
- the choice of experts is the program's where it is given (``routes``):
  float32 rounding moves the k-th largest score past the next at a few
  positions of a long prompt, and a different expert there moves that
  position's states, which every later position attends to, and through
  them further choices; so the reference takes the program's choice and
  reads, as ``route_gap``, how far each chosen expert's score falls
  short of its own top choice (its weights it computes itself);
- the repetition penalty divides the positive logits and multiplies the
  negative ones of every id served before, EOS excepted, before the
  log-softmax (the prompt's ids are not "served");
- the special ids are the port's (``DSV3_SIZES``'s ``eos_id``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# one precision below the configuration's float32, in the program's
# place: every product's operands rounded to bfloat16
CONTROLS = ("bf16",)
# the matrices the configuration serves in int8
INT8 = ("wq", "wkva", "wkvb", "wo", "w_gate", "w_up", "w_down",
        "shared_gate", "shared_up", "shared_down")
# routed experts computed at once
EXPERT_BLOCK = 16


def fp32_only() -> None:
    """Products in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def int8(w: torch.Tensor) -> torch.Tensor:
    """``w`` (..., in, out) in int8 codes per output channel, back in
    float32."""
    w = w.float()
    s = w.abs().amax(dim=-2, keepdim=True) / w.new_tensor(127.0) + 1e-12
    return torch.clamp(torch.round(w / s), -127, 127) * s


def weights(tree: Dict) -> Dict:
    """A part's leaves as the configuration serves them: its matrices
    and head in int8, the rest float32."""
    return {k: int8(v) if k in INT8 or k == "lm_head" else v.float()
            for k, v in tree.items()}


def _low(t: torch.Tensor, low: bool) -> torch.Tensor:
    return t.bfloat16().float() if low else t


def _mm(x: torch.Tensor, w: torch.Tensor, low: bool = False) -> torch.Tensor:
    """x @ w in float32, or with both operands rounded to bfloat16."""
    return _low(x, low) @ _low(w, low)


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope(x: torch.Tensor, m: dict) -> torch.Tensor:
    """x (T, H, dr) at positions 0..T-1, interleaved pairs."""
    t, h, dr = x.shape
    inv = 1.0 / (m["rope_theta"] ** (torch.arange(
        0, dr, 2, dtype=torch.float32, device=x.device) / dr))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    emb = torch.cat([ang, ang], dim=-1)[:, None]
    x = x.reshape(t, h, dr // 2, 2).transpose(-1, -2).reshape(t, h, dr)
    return x * emb.cos() + _rotate_half(x) * emb.sin()


def attention(w: dict, m: dict, h: torch.Tensor, low: bool = False
              ) -> torch.Tensor:
    """Latent attention in the full form over positions (T, d) -> (T, d)."""
    t = h.shape[0]
    H, dn, dr = m["n_heads"], m["qk_nope_dim"], m["qk_rope_dim"]
    r, dv = m["kv_lora_rank"], m["v_head_dim"]
    q = _mm(h, w["wq"], low).reshape(t, H, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    kva = _mm(h, w["wkva"], low)
    c = _rms(kva[:, :r], w["kv_norm"], m["rms_eps"])
    k_pe = kva[:, None, r:]
    kv = _mm(c, w["wkvb"], low).reshape(t, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, rope(q_pe, m)], -1)
    k = torch.cat([k_nope, rope(k_pe, m).expand(t, H, dr)], -1)
    q, k, v = (_low(z, low) for z in (q, k, v))
    logits = torch.einsum("qhd,khd->hqk", q, k) * (dn + dr) ** -0.5
    idx = torch.arange(t, device=h.device)
    logits = logits + torch.where(idx[None, :] <= idx[:, None], 0.0,
                                  float("-inf"))
    o = _low(torch.einsum("hqk,khd->qhd", logits.softmax(-1), v), low)
    return _mm(o.reshape(t, H * dv), w["wo"], low)


def _swiglu(x, gate, up, down, low):
    return _mm(F.silu(_mm(x, gate, low)) * _mm(x, up, low), down, low)


def gates(w: dict, m: dict, x: torch.Tensor, low: bool = False,
          ids: Optional[torch.Tensor] = None) -> tuple:
    """(each position's weight of every routed expert (T, E), zero off
    the chosen ones; the route gap). The choice is the top of the scores
    plus the correction bias, or ``ids`` (T, k) where given; the route
    gap is how far the chosen experts fall short of this reference's own
    top choice in float32, the widest position's: its k-th largest
    ``s + bias`` less the least of the chosen ones' (0 where the choice is
    its own)."""
    exact = torch.sigmoid(x @ w["router"])
    s = torch.sigmoid(_mm(x, w["router"], low)) if low else exact
    k = m["experts_per_token"]
    if ids is None:
        ids = torch.topk(s + w["bias"], k, dim=-1).indices
    biased = exact + w["bias"]
    gap = (torch.topk(biased, k, dim=-1).values[:, -1]
           - biased.gather(1, ids).amin(-1)).clamp(min=0.0)
    chosen = s.gather(1, ids)
    chosen = chosen / (chosen.sum(-1, keepdim=True) + 1e-20) \
        * m["routed_scale"]
    return torch.zeros_like(s).scatter(1, ids, chosen), float(gap.amax())


def ffn(w: dict, m: dict, i: int, x: torch.Tensor, low: bool = False,
        ids: Optional[torch.Tensor] = None, gaps: Optional[list] = None
        ) -> torch.Tensor:
    """Layer ``i``'s feed-forward over positions (T, d): a SwiGLU, or
    every routed expert under its gate (the choice ``ids`` where given,
    see :func:`gates`; its route gap appended to ``gaps``), plus the
    shared experts."""
    if i < m["first_dense"]:
        return _swiglu(x, w["w_gate"], w["w_up"], w["w_down"], low)
    g, gap = gates(w, m, x, low, ids)
    if gaps is not None:
        gaps.append(gap)
    out = _swiglu(x, w["shared_gate"], w["shared_up"], w["shared_down"], low)
    for e0 in range(0, m["n_routed_experts"], EXPERT_BLOCK):
        e = slice(e0, e0 + EXPERT_BLOCK)
        hid = F.silu(_mm(x, w["w_gate"][e], low)) * _mm(x, w["w_up"][e], low)
        y = _mm(hid, w["w_down"][e], low)            # (experts, T, d)
        out = out + torch.einsum("etd,te->td", y, g[:, e])
    return out


def hidden(source, m: dict, rows: Sequence[torch.Tensor], low: bool = False,
           routes: Optional[Sequence[torch.Tensor]] = None,
           gaps: Optional[List[list]] = None) -> List[torch.Tensor]:
    """Each row's final normed states (T, d) over its ids (T,), the rows
    carried layer by layer. ``routes``, where given, holds each row's
    choice of experts (expert layers, positions, k) for every expert
    layer to take; each expert layer's route gap goes to the row's list
    in ``gaps``."""
    top = weights(source.top())
    xs = [top["tok_emb"][ids] for ids in rows]
    for i in range(m["n_layers"]):
        w = weights(source.layer(i))
        for n, x in enumerate(xs):
            x = x + attention(w, m, _rms(x, w["ln1"], m["rms_eps"]), low)
            ids = None
            if routes is not None and i >= m["first_dense"]:
                ids = routes[n][i - m["first_dense"], :x.shape[0]]
            xs[n] = x + ffn(w, m, i, _rms(x, w["ln2"], m["rms_eps"]), low,
                            ids, None if gaps is None else gaps[n])
        del w
    return [_rms(x, top["ln_f"], m["rms_eps"]) for x in xs]


def _penalised(head, m: dict, states: torch.Tensor, served: np.ndarray,
               penalty: float, low: bool, block: int):
    """(positions, the penalised logits before each served token) in
    blocks of ``block`` positions, from the final states before each."""
    dev = states.device
    first = np.full(m["vocab_size"], len(served), np.int64)
    for i, t in reversed(list(enumerate(served))):
        if t != m["eos_id"]:
            first[t] = i
    first = torch.from_numpy(first).to(dev)
    rp = torch.tensor(penalty, device=dev)
    for lo in range(0, len(served), block):
        pos = torch.arange(lo, min(lo + block, len(served)), device=dev)
        lg = _mm(states[pos], head, low)
        seen = first[None, :] < pos[:, None]
        yield pos, torch.where(seen, torch.where(lg > 0, lg / rp, lg * rp),
                               lg)


def read_rows(source, m: dict, prompts: Sequence[np.ndarray],
              served: Sequence[np.ndarray], device, penalty: float,
              control: Optional[str] = None, block: int = 128,
              routes: Optional[Sequence[torch.Tensor]] = None
              ) -> List[Dict]:
    """The reference's readings of rows the program served: each row's
    ``prompt`` ids and the tokens it ``served`` after them (to the first
    EOS, that included); ``routes``, where given, each row's choice of
    experts over those positions (expert layers, positions, k), which
    every expert layer takes (:func:`gates`), as the program made it.
    Returns a dict a row: ``sum``, the served tokens' summed penalised
    log-probability, ``lead``, the widest lead over the positions of the
    largest penalised logit over the served token's, in nats (0 where
    every greedy choice is the reference's), and ``route_gap``, the
    widest route gap over the expert layers; with ``control`` (one of
    CONTROLS) also ``low_sum``, the sum one precision lower, following
    the same choices of experts, ``low_lead``, the lead of this
    reference's logits over the token the lower one would choose, and
    ``low_route_gap``, how far those choices fall short of the float32
    scores of the lower one's own states."""
    fp32_only()
    if control not in (None, *CONTROLS):
        raise ValueError(f"unknown control {control!r}")
    toks = [torch.from_numpy(np.asarray(s, np.int64)).to(device)
            for s in served]
    ids = [torch.cat([torch.from_numpy(np.asarray(p, np.int64)).to(device),
                      t[:-1]]) for p, t in zip(prompts, toks)]
    if routes is not None:
        routes = [torch.as_tensor(r).to(device) for r in routes]
    gaps = [[] for _ in ids]
    low_gaps = [[] for _ in ids]
    with torch.no_grad():
        states = [hidden(source, m, ids, routes=routes, gaps=gaps)]
        if control:
            states.append(hidden(source, m, ids, True, routes=routes,
                                 gaps=low_gaps))
        head = int8(source.top()["lm_head"])
        out = []
        for r, (tok, sv) in enumerate(zip(toks, served)):
            k = len(sv)
            parts = [_penalised(head, m, s[r][-k:], sv, penalty, low, block)
                     for s, low in zip(states, (False, True))]
            row = {"sum": 0.0, "lead": 0.0, "low_sum": 0.0, "low_lead": 0.0,
                   "route_gap": max(gaps[r], default=0.0),
                   "low_route_gap": max(low_gaps[r], default=0.0)}
            for blocks in zip(*parts):
                pos, lg = blocks[0]
                best = lg.amax(-1)
                lp = lg.log_softmax(-1).gather(1, tok[pos, None])[:, 0]
                row["sum"] += float(lp.double().sum())
                mine = lg.gather(1, tok[pos, None])[:, 0]
                row["lead"] = max(row["lead"], float((best - mine).amax()))
                if control:
                    low = blocks[1][1]
                    lp = low.log_softmax(-1).gather(1, tok[pos, None])[:, 0]
                    row["low_sum"] += float(lp.double().sum())
                    pick = lg.gather(1, low.argmax(-1)[:, None])[:, 0]
                    row["low_lead"] = max(row["low_lead"],
                                          float((best - pick).amax()))
            out.append(row)
    return out
