"""The DeepSeek-V3 block's operations (Kanana-2-30B-A3B's) and a decode
step's least bytes, for the work of a stretch.

Operations count two a multiply-add, as the program's algorithm runs
them: the prefill in the full form (every position's projections, its
causal attention over the positions before it and itself, its dense or
expert feed-forward with the router, the experts it was routed to and
the shared ones; the head at the last position only), each decode step
in the absorbed form (``q_nope`` taken into the latent space, scores
over the filled positions and the new one against the 576 cached
values, the context taken back out through ``W_kvb``'s value columns)
with the head. Int8 products count like any other: ``step_mfu`` holds
them to the bf16 peak.

A decode step's least bytes, at B=1: the int8 codes and f32
per-output-channel scales of every attention matrix, of the dense
layer, of the ``experts_per_token`` routed experts and the shared ones
of each expert layer, and of the head, read once; the f32 router and
correction bias; the filled latent positions of every layer at the
cache's precision, read once, and the new column written.
"""

from __future__ import annotations


def _attn_dims(m: dict) -> tuple:
    H = m["n_heads"]
    qk = m["qk_nope_dim"] + m["qk_rope_dim"]
    return (m["d_model"], H, qk, m["kv_lora_rank"] + m["qk_rope_dim"],
            m["kv_lora_rank"], m["qk_nope_dim"], m["v_head_dim"])


def _matrix_bytes(n_in: int, n_out: int) -> int:
    """Int8 codes and f32 scales of one (in, out) matrix."""
    return n_in * n_out + 4 * n_out


def attention_bytes(m: dict) -> int:
    """One layer's attention matrices: W_q, W_kva, W_kvb, W_o."""
    d, H, qk, lat, r, dn, dv = _attn_dims(m)
    return (_matrix_bytes(d, H * qk) + _matrix_bytes(d, lat)
            + _matrix_bytes(r, H * (dn + dv)) + _matrix_bytes(H * dv, d))


def swiglu_bytes(d: int, ff: int) -> int:
    return 2 * _matrix_bytes(d, ff) + _matrix_bytes(ff, d)


def weight_bytes(m: dict) -> int:
    """What one decode step of one row reads of the weights."""
    d, E = m["d_model"], m["n_routed_experts"]
    f = m["moe_d_ff"]
    moe = (m["experts_per_token"] * swiglu_bytes(d, f)
           + swiglu_bytes(d, m["n_shared_experts"] * f)
           + 4 * (d * E + E))
    n_moe = m["n_layers"] - m["first_dense"]
    return (m["n_layers"] * attention_bytes(m)
            + m["first_dense"] * swiglu_bytes(d, m["d_ff"])
            + n_moe * moe + _matrix_bytes(d, m["vocab_size"]))


def latent_bytes(m: dict, positions: int, itemsize: int) -> int:
    """``positions`` latent columns of every layer."""
    return (m["n_layers"] * positions
            * (m["kv_lora_rank"] + m["qk_rope_dim"]) * itemsize)


def step_bytes(m: dict, filled: int, itemsize: int) -> int:
    """One decode step of one row whose cache holds ``filled`` positions:
    the weights, the filled positions, and the new column written."""
    return weight_bytes(m) + latent_bytes(m, filled + 1, itemsize)


def ffn_flops(m: dict, layer: int) -> float:
    """Layer ``layer``'s feed-forward at one position."""
    d = m["d_model"]
    if layer < m["first_dense"]:
        return 6 * d * m["d_ff"]
    f = m["moe_d_ff"]
    return (2 * d * m["n_routed_experts"]
            + 6 * d * f * (m["experts_per_token"] + m["n_shared_experts"]))


def _ffn_all(m: dict) -> float:
    return sum(ffn_flops(m, i) for i in range(m["n_layers"]))


def head_flops(m: dict) -> float:
    return 2 * m["d_model"] * m["vocab_size"]


def prefill_flops(m: dict, n: int) -> float:
    """The full-form prefill of ``n`` positions, the head once."""
    d, H, qk, lat, r, dn, dv = _attn_dims(m)
    proj = 2 * d * H * qk + 2 * d * lat + 2 * r * H * (dn + dv) \
        + 2 * H * dv * d
    # position p attends over p + 1 positions: scores and values
    pairs = n * (n + 1) // 2
    attn = n * proj + pairs * 2 * H * (qk + dv)
    return m["n_layers"] * attn + n * _ffn_all(m) + head_flops(m)


def step_flops(m: dict, pos: int) -> float:
    """One absorbed decode step at position ``pos`` (attending over
    ``pos + 1`` positions), the head included."""
    d, H, qk, lat, r, dn, dv = _attn_dims(m)
    attn = (2 * d * H * qk + 2 * d * lat + 2 * H * dn * r
            + 2 * H * (pos + 1) * (lat + r) + 2 * H * r * dv
            + 2 * H * dv * d)
    return m["n_layers"] * attn + _ffn_all(m) + head_flops(m)


def row_flops(m: dict, prompt: int, steps: int) -> float:
    """One prompt of ``prompt`` tokens and ``steps`` decode steps."""
    return prefill_flops(m, prompt) + sum(
        step_flops(m, prompt + t) for t in range(steps))
