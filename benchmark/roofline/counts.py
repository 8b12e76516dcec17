"""Operations and bytes of the work the program does, and the least time
the card could take for it.

The counts are of the algorithm at the shapes a stretch ran (per layer,
per step, per window, per bucket), never per launch, so a change that
fuses or splits launches leaves them right. Bytes count each input read
once and each output written once; operations count two a
multiply-add. The formulas are those of the port's kernel table
(PERF.md §6, from ``chip_smoke.py``), so the bounds there and here
agree: Kernel A 0.3727 ms at (32, 1500, 20, 64), Kernel B 0.0369 ms at
L=1, B=32, R=2, T=1500, a large-v2 int8 layer-step 0.0538 ms at R=64,
position 100, B=32, T=1500.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published dense rates at its 700 W limit
HBM_BYTES_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12


def least_s(flop: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The larger of the operations at ``peak`` and the bytes at the
    memory rate, in seconds."""
    return max(flop / peak, nbytes / HBM_BYTES_S)


# -- Kernel A: encoder self-attention --------------------------------------

def encoder_attention(b: int, t: int, h: int, hd: int) -> tuple:
    """(flop, bytes) of bidirectional attention over (B, T, H, hd) bf16:
    QK^T and PV, q, k, v read and the output written once."""
    return 4 * b * h * t * t * hd, 4 * b * t * h * hd * 2


def encoder_attention_s(b, t, h, hd) -> float:
    return least_s(*encoder_attention(b, t, h, hd), PEAK_BF16)


# -- Kernel B: decode cross-attention over int8 K/V ------------------------

def cross_attention(b: int, rows: int, t: int, d: int) -> tuple:
    """(flop, bytes) of one layer's cross-attention of ``rows`` queries a
    K/V row (beams and prompt positions folded) over int8 K and V of B
    rows and T frames: the codes read once, f32 queries in and outputs
    out."""
    return 4 * b * rows * d * t, 2 * b * d * t + 2 * 4 * b * rows * d


def cross_attention_s(b, rows, t, d) -> float:
    return least_s(*cross_attention(b, rows, t, d), PEAK_F32)


# -- the fused int8 decode blocks (Kernel B inside the cross block apart) ---

def self_block(rows: int, pos: int, d: int) -> tuple:
    """(flop, bytes) of the self block of one layer-step: LN, the int8
    wqkv GEMV, attention over ``pos`` cached positions and the new one,
    the int8 wo GEMV with the residual."""
    nbytes = (2 * rows * d * 2 + 2 * d * 2 + 4 * d * d + 4 * d * 6
              + 2 * rows * pos * d * 2 + 3 * rows * d * 2)
    return 2 * rows * 4 * d * d * 2 + 4 * rows * pos * d, nbytes


def cross_block(rows: int, b: int, t: int, d: int, h: int) -> tuple:
    """(flop, bytes) of the cross block of one layer-step: LN, the int8
    cwq GEMV, Kernel B over B rows of int8 K/V at T frames, the int8 cwo
    GEMV with the residual."""
    nbytes = (2 * rows * d * 2 + 2 * d * 2 + 2 * d * d + 2 * d * 6
              + 2 * b * d * t + 2 * b * h * 4)
    return 2 * rows * 2 * d * d * 2 + 4 * rows * d * t, nbytes


def mlp_block(rows: int, d: int) -> tuple:
    """(flop, bytes) of the MLP block of one layer-step: LN, the int8 w1
    GEMV with GELU, the int8 w2 GEMV with the residual."""
    return (2 * rows * 8 * d * d * 2,
            2 * rows * d * 2 + 2 * d * 2 + 8 * d * d + 5 * d * 6)


def cross_block_kernel_b(b: int, t: int, d: int, h: int) -> int:
    """The bytes of Kernel B inside the cross block (int8 K/V and their
    scales)."""
    return 2 * b * d * t + 2 * b * h * 4


def layer_step_s(rows, pos, b, t, d, h) -> tuple:
    """Least seconds of the self, cross and MLP blocks of a layer-step."""
    return (least_s(*self_block(rows, pos, d)),
            least_s(*cross_block(rows, b, t, d, h)),
            least_s(*mlp_block(rows, d)))


def fused_without_kernel_b(rows, pos, b, t, d, h) -> tuple:
    """(flop, bytes) of a layer-step's fused blocks less Kernel B: the
    six int8 GEMVs and the self-attention."""
    f1, b1 = self_block(rows, pos, d)
    f2, b2 = cross_block(rows, b, t, d, h)
    f3, b3 = mlp_block(rows, d)
    fb, bb = 4 * rows * d * t, cross_block_kernel_b(b, t, d, h)
    return f1 + f2 - fb + f3, b1 + b2 - bb + b3
