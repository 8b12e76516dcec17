"""Forced aligner (ForcedAligner class, non-autoregressive) in PyTorch.

Counterpart of ``whisperjav_tpu/models/qwen/aligner.py``: an audio tower
(two stride-2 convolutions, 40 ms frames, RMSNorm transformer blocks) and
a bidirectional text tower project into one space; their cosine
similarity times ``temp`` gives a tokens x frames logit matrix, and a
monotonic Viterbi over its masked log-softmax gives each token's
[start, end) frames.

:func:`align_spans` is the whole path on the device for a padded batch
(int16 audio in, mel, similarity, the Viterbi over every row at once,
one column at a time); the backtrack of its decisions runs on the host,
vectorised over rows, and the spans equal those of the host
:func:`monotonic_align` on the same log-probabilities (the same
recurrence and ``diag >= prev`` tie-break, in f32 as the JAX device
path). ``merge_master_with_timestamps`` reconciles the punctuated master
text with the aligner's tokens. Word alignment of the Whisper path
shares :func:`monotonic_align`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from whisperjav_tpu_torch.models.layers import ParamTree, tree_to_torch
from whisperjav_tpu_torch.models.qwen.model import (
    dense, rms_norm, rope, rope_angles,
)
from whisperjav_tpu_torch.ops.mel import log_mel_spectrogram
from whisperjav_tpu_torch.utils.precision import full_f32

FRAME_S = 0.04
_NEG = -1e30


@dataclass(frozen=True)
class AlignerConfig:
    vocab_size: int = 4096
    d_model: int = 192
    n_layers: int = 4
    n_heads: int = 6
    n_mels: int = 128
    rope_theta: float = 10_000.0
    max_audio_s: float = 180.0   # reference limit (qwen_asr.py:215)


class AlignerParams(ParamTree):
    """The aligner's weights under the JAX package's names: ``conv1_w``,
    ``conv2_w`` (OIH), ``audio_blocks``, ``audio_ln``, ``tok_emb``,
    ``text_blocks``, ``text_ln`` and the scalar ``temp``."""

    def __init__(self, config: AlignerConfig, tree: Dict[str, object]):
        super().__init__(tree)
        self.config = config


def params_from_jax(tree: Dict, cfg: AlignerConfig,
                    device="cpu") -> AlignerParams:
    return AlignerParams(cfg, tree_to_torch(tree, device=device))


def init_params(cfg: AlignerConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device="cpu") -> AlignerParams:
    """Random weights with the JAX init's shapes and scales (matrices and
    embedding N(0, 1/d), convolutions N(0, 0.0025), temp 10), drawn from
    ``generator`` on ``device``."""
    d, L = cfg.d_model, cfg.n_layers
    s = d ** -0.5

    def normal(shape, scale=s):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)

    def tower():
        return {"ln1": torch.ones((L, d), dtype=dtype, device=device),
                "wq": normal((L, d, d)), "wk": normal((L, d, d)),
                "wv": normal((L, d, d)), "wo": normal((L, d, d)),
                "ln2": torch.ones((L, d), dtype=dtype, device=device),
                "w1": normal((L, d, 4 * d)), "w2": normal((L, 4 * d, d))}

    zeros = torch.zeros((d,), dtype=dtype, device=device)
    ones = torch.ones((d,), dtype=dtype, device=device)
    return AlignerParams(cfg, {
        "conv1_w": normal((d, cfg.n_mels, 3), 0.05), "conv1_b": zeros,
        "conv2_w": normal((d, d, 3), 0.05), "conv2_b": zeros.clone(),
        "audio_blocks": tower(), "audio_ln": ones,
        "tok_emb": normal((cfg.vocab_size, d)),
        "text_blocks": tower(), "text_ln": ones.clone(),
        "temp": torch.full((), 10.0, dtype=dtype, device=device),
    })


def _block(x: torch.Tensor, p: ParamTree, i: int, n_heads: int,
           theta: float, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Transformer block ``i``; ``mask`` (B, T) True at valid positions
    (padded keys are left out of every softmax)."""
    b, t, d = x.shape
    h = rms_norm(x, p["ln1"][i], 1e-6)
    cos, sin = rope_angles(torch.arange(t, device=x.device), d // n_heads,
                           theta)
    q = rope(dense(h, p["wq"][i]).reshape(b, t, n_heads, -1), cos, sin)
    k = rope(dense(h, p["wk"][i]).reshape(b, t, n_heads, -1), cos, sin)
    v = dense(h, p["wv"][i]).reshape(b, t, n_heads, -1)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k).float()
    if mask is not None:
        scores = torch.where(mask[:, None, None, :], scores, _NEG)
    a = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).to(x.dtype)
    x = x + dense(o.reshape(b, t, d), p["wo"][i])
    h = rms_norm(x, p["ln2"][i], 1e-6)
    return x + dense(F.gelu(dense(h, p["w1"][i])), p["w2"][i])


def similarity(params: AlignerParams, mel: torch.Tensor,
               tokens: torch.Tensor,
               mel_valid: Optional[torch.Tensor] = None,
               tok_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mel (B, n_mels, T_mel), tokens (B, N) -> logits (B, N, T_mel / 4),
    in f32. ``mel_valid`` / ``tok_valid`` (B,) are the true lengths:
    padded frames and tokens are masked out of attention."""
    cfg = params.config
    with full_f32():
        a = F.gelu(F.conv1d(mel, params["conv1_w"].to(mel.dtype),
                            params["conv1_b"].to(mel.dtype), stride=2,
                            padding=1))
        a = F.gelu(F.conv1d(a, params["conv2_w"].to(a.dtype),
                            params["conv2_b"].to(a.dtype), stride=2,
                            padding=1))
        a = a.transpose(1, 2)
        t_frames = a.shape[1]
        dev = mel.device
        amask = (None if mel_valid is None else
                 torch.arange(t_frames, device=dev)[None, :]
                 < ((mel_valid[:, None] + 3) // 4))
        tmask = (None if tok_valid is None else
                 torch.arange(tokens.shape[1], device=dev)[None, :]
                 < tok_valid[:, None])
        for i in range(cfg.n_layers):
            a = _block(a, params["audio_blocks"], i, cfg.n_heads,
                       cfg.rope_theta, amask)
        a = rms_norm(a, params["audio_ln"], 1e-6)
        t = params["tok_emb"][tokens.long()]
        for i in range(cfg.n_layers):
            t = _block(t, params["text_blocks"], i, cfg.n_heads,
                       cfg.rope_theta, tmask)
        t = rms_norm(t, params["text_ln"], 1e-6)
        a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-6)
        t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-6)
        return torch.einsum("bnd,bmd->bnm", t, a).float() \
            * params["temp"].float()


def _viterbi(lp: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """The monotonic Viterbi over every row of lp (B, N, T) f32 at once,
    one column at a time on lp's device: Q[i, j] = lp[i, j] + max(Q[i-1,
    j-1], Q[i, j-1]), the diagonal taken when ``diag >= prev``, row 0 only
    staying; columns at or past a row's ``frames`` leave it as it is.
    Returns the decisions ``back`` (T, B, N) bool (True: token i started
    at column j; column 0 all False)."""
    b, n, t = lp.shape
    neg = torch.full((b, 1), _NEG, device=lp.device)
    prev = torch.full((b, n), _NEG, device=lp.device)
    prev[:, 0] = lp[:, 0, 0]
    back = torch.zeros((t, b, n), dtype=torch.bool, device=lp.device)
    cols = lp.permute(2, 0, 1).contiguous()          # (T, B, N)
    for j in range(1, t):
        diag = torch.cat([neg, prev[:, :-1]], dim=1)
        take = diag >= prev
        take[:, 0] = False               # row 0 can only stay
        col = torch.where(take, diag, prev) + cols[j]
        active = (j < frames)[:, None]
        prev = torch.where(active, col, prev)
        back[j] = take & active
    return back


def _backtrack(back: np.ndarray, frames: np.ndarray, n_tok: np.ndarray,
               n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Spans (starts, ends) (B, N) int32 from the Viterbi decisions, all
    rows at once: from (n_tok - 1, frames - 1), a row ends its token i at
    column j when back[j, row, i] or j == 0 (the token then spans [j,
    end)), else moves one column left. Slots past a row's tokens stay 0."""
    b = back.shape[1]
    starts = np.zeros((b, n), np.int32)
    ends = np.zeros((b, n), np.int32)
    i = n_tok.astype(np.int64) - 1
    j = frames.astype(np.int64) - 1
    end = frames.astype(np.int64).copy()
    rows = np.arange(b)
    live = i >= 0
    while live.any():
        r = rows[live]
        hit = back[j[r], r, i[r]] | (j[r] == 0)
        h = r[hit]
        starts[h, i[h]] = j[h]
        ends[h, i[h]] = end[h]
        end[h] = j[h]
        i[h] -= 1
        j[r] = np.where(hit, np.maximum(j[r] - 1, 0), j[r] - 1)
        live = i >= 0
    starts[:, 0] = 0
    return starts, ends


@torch.inference_mode()
def align_spans(params: AlignerParams, audio: torch.Tensor,
                tokens: torch.Tensor, audio_valid: torch.Tensor,
                tok_valid: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """int16 audio (B, S) + tokens (B, N) on the aligner's device ->
    (starts, ends) (B, N) int32 conv-frame indices on the host: mel,
    similarity, masked log-softmax and the Viterbi on the device; only
    the decisions come back for the backtrack."""
    cfg = params.config
    audio_f = audio.float() / 32767.0
    mel = log_mel_spectrogram(audio_f, n_mels=cfg.n_mels)
    mel_valid = -(-audio_valid.long() // 160)
    logits = similarity(params, mel, tokens, mel_valid, tok_valid)
    t_conv = logits.shape[-1]
    frames = torch.clamp((mel_valid + 3) // 4, min=1)
    fmask = (torch.arange(t_conv, device=logits.device)[None, :]
             < frames[:, None])[:, None, :]
    lp = torch.log_softmax(torch.where(fmask, logits, _NEG), dim=-1)
    lp = torch.where(fmask, lp, _NEG)
    back = _viterbi(lp, frames).cpu().numpy()
    return _backtrack(back, frames.cpu().numpy(),
                      tok_valid.cpu().numpy(), tokens.shape[1])


class TokenSpan(NamedTuple):
    token: int
    start: float
    end: float


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


def _even_spread(row: Sequence[int], frames: int) -> List[TokenSpan]:
    """``monotonic_align``'s rule for fewer frames than tokens."""
    n = len(row)
    bounds = np.linspace(0, frames, n + 1).astype(int)
    return [TokenSpan(int(t), bounds[i] * FRAME_S,
                      max(bounds[i + 1], bounds[i] + 1) * FRAME_S)
            for i, t in enumerate(row)]


class ForcedAligner:
    """Host-facing aligner: tokens + audio -> per-token timestamps, on
    ``device`` (random weights from ``generator`` seeded 0 there unless
    ``params`` are given)."""

    def __init__(self, cfg: Optional[AlignerConfig] = None,
                 params: Optional[AlignerParams] = None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        self.cfg = cfg or AlignerConfig()
        self.device = torch.device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device)
                generator.manual_seed(0)
            params = init_params(self.cfg, generator, device=self.device)
        self.params = params.to(self.device)

    def _padded_tokens(self, token_rows, n_pad):
        counts = [len(t) for t in token_rows]
        n_max = max(max(counts, default=0), n_pad or 0)
        toks = np.zeros((len(token_rows), n_max), np.int32)
        for r, row in enumerate(token_rows):
            toks[r, :len(row)] = row
        return counts, toks

    def _tensor(self, x) -> torch.Tensor:
        return torch.from_numpy(np.array(x)).to(self.device)

    @torch.inference_mode()
    def align(self, mel: np.ndarray, tokens: Sequence[int]
              ) -> List[TokenSpan]:
        """mel (n_mels, T_mel) for one clip; tokens text ids -> spans."""
        if not tokens:
            return []
        toks = self._tensor(np.asarray(tokens, np.int32)[None, :])
        logits = similarity(self.params, self._tensor(mel[None]), toks)
        lp = torch.log_softmax(logits, dim=-1)[0].cpu().numpy()
        spans = monotonic_align(lp)
        return [TokenSpan(int(t), a * FRAME_S, b * FRAME_S)
                for t, (a, b) in zip(tokens, spans)]

    @torch.inference_mode()
    def align_batch(self, mels: np.ndarray,
                    token_rows: Sequence[Sequence[int]],
                    mel_valid: Sequence[int],
                    n_pad: Optional[int] = None) -> List[List[TokenSpan]]:
        """One device call for a batch of clips padded to one bucket:
        mels (B, n_mels, T_mel), ragged token rows, each row's true mel
        length. The log-softmax and the Viterbi run on the host per row
        over its valid slice."""
        if not any(len(t) for t in token_rows):
            return [[] for _ in range(int(mels.shape[0]))]
        counts, toks = self._padded_tokens(token_rows, n_pad)
        logits = similarity(
            self.params, self._tensor(mels), self._tensor(toks),
            self._tensor(np.asarray(mel_valid, np.int64)),
            self._tensor(np.asarray(counts, np.int64)))
        raw = logits.cpu().numpy()
        out: List[List[TokenSpan]] = []
        for r, row in enumerate(token_rows):
            n = counts[r]
            if n == 0:
                out.append([])
                continue
            frames = max(1, (int(mel_valid[r]) + 3) // 4)
            sl = raw[r, :n, :frames].astype(np.float64)
            sl -= sl.max(axis=-1, keepdims=True)
            lp = sl - np.log(np.exp(sl).sum(axis=-1, keepdims=True))
            spans = monotonic_align(lp)
            out.append([TokenSpan(int(t), a * FRAME_S, b_ * FRAME_S)
                        for t, (a, b_) in zip(row, spans)])
        return out

    def align_batch_audio(self, audio: np.ndarray,
                          token_rows: Sequence[Sequence[int]],
                          sample_valid: Sequence[int],
                          n_pad: Optional[int] = None
                          ) -> List[List[TokenSpan]]:
        """The device path: audio (B, S) (float32 in [-1, 1], or int16)
        padded to one bucket, each row's true sample count -> spans
        through :func:`align_spans`. Rows with fewer valid conv frames
        than tokens take ``monotonic_align``'s even-spread rule."""
        if not any(len(t) for t in token_rows):
            return [[] for _ in range(int(audio.shape[0]))]
        counts, toks = self._padded_tokens(token_rows, n_pad)
        a16 = audio if audio.dtype == np.int16 else (
            np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
        starts, ends = align_spans(
            self.params, self._tensor(a16), self._tensor(toks),
            self._tensor(np.asarray(sample_valid, np.int64)),
            self._tensor(np.asarray(counts, np.int64)))
        out: List[List[TokenSpan]] = []
        for r, row in enumerate(token_rows):
            n = counts[r]
            if n == 0:
                out.append([])
                continue
            frames = max(1, (-(-int(sample_valid[r]) // 160) + 3) // 4)
            if frames < n:
                out.append(_even_spread(row, frames))
                continue
            out.append([TokenSpan(int(t), int(starts[r, i]) * FRAME_S,
                                  int(ends[r, i]) * FRAME_S)
                        for i, t in enumerate(row)])
        return out


# ---------------------------------------------------------------------------
# master-text reconciliation
# ---------------------------------------------------------------------------

def merge_master_with_timestamps(
    master_text: str,
    aligned: Sequence[TokenSpan],
    token_texts: Sequence[str],
) -> List[Tuple[str, float, float]]:
    """Reconcile punctuated master text with unpunctuated aligner tokens.

    Walks the master text assigning each aligner token's time span to the
    matching characters; punctuation between matches inherits the previous
    token's end time (reference: qwen_asr.py:33 merge_master step).
    Returns [(text_piece, start, end)] covering the master text in order.
    """
    out: List[Tuple[str, float, float]] = []
    pos = 0
    master = master_text
    last_end = 0.0
    for span, tok_text in zip(aligned, token_texts):
        if not tok_text:
            continue
        idx = master.find(tok_text, pos)
        if idx < 0:
            # token not found (cleaner changed it): attach to timeline order
            out.append((tok_text, span.start, span.end))
            last_end = span.end
            continue
        if idx > pos:
            # intervening punctuation/whitespace rides the previous span
            out.append((master[pos:idx], last_end, span.start))
        out.append((master[idx:idx + len(tok_text)], span.start, span.end))
        pos = idx + len(tok_text)
        last_end = span.end
    if pos < len(master):
        out.append((master[pos:], last_end, last_end))
    return out
