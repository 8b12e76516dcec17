"""Monotonic alignment (Viterbi over a tokens x frames log-prob matrix).

For now this file holds only the port's copy of
``whisperjav_tpu/models/qwen/aligner.py:monotonic_align`` (numpy), which
word alignment shares; the Qwen forced aligner joins it when Qwen mode
is ported.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def monotonic_align(log_probs: np.ndarray) -> List[Tuple[int, int]]:
    """Viterbi monotonic alignment over (N_tokens, T_frames) log-probs.

    Recurrence (MAS): Q[i,j] = lp[i,j] + max(Q[i-1,j-1], Q[i,j-1]).
    Returns per-token (start_frame, end_frame_exclusive).
    """
    n, t = log_probs.shape
    if n == 0 or t == 0:
        return []
    if t < n:   # degenerate: fewer frames than tokens — spread evenly
        bounds = np.linspace(0, t, n + 1).astype(int)
        return [(bounds[i], max(bounds[i + 1], bounds[i] + 1))
                for i in range(n)]
    # column sweep, vectorized over tokens: q[:, j] depends only on
    # q[:, j-1] (stay) and its one-down shift (diag), so the DP runs in
    # T numpy vector ops instead of N*T Python iterations (the scalar
    # loop cost ~0.1 s per frame at N~200 — material at 300+ frames/file)
    neg = -1e30
    lp = np.asarray(log_probs, np.float64)
    q = np.full((n, t), neg, np.float64)
    back = np.zeros((n, t), np.int8)   # 1 = came from i-1 (new token)
    q[0, 0] = lp[0, 0]
    prev = q[:, 0]
    for j in range(1, t):
        diag = np.empty(n, np.float64)
        diag[0] = neg            # row 0 can only stay
        diag[1:] = prev[:-1]
        take_diag = diag >= prev
        col = np.where(take_diag, diag, prev) + lp[:, j]
        col[0] = prev[0] + lp[0, j]      # row 0: stay only
        back[:, j] = take_diag
        back[0, j] = 0
        q[:, j] = col
        prev = col
    # backtrack
    spans = [[0, 0] for _ in range(n)]
    i, j = n - 1, t - 1
    end = t
    while i >= 0:
        if back[i, j] == 1 or j == 0:
            spans[i] = [j, end]
            end = j
            i -= 1
            j = max(j - 1, 0)
        else:
            j -= 1
    spans[0][0] = 0
    return [(int(a), int(b)) for a, b in spans]
