"""Plain float32 Qwen3-ASR: log-mel, the AuT audio tower and the Qwen3
LM, teacher-forced along tokens given to it, with the repetition
penalty: their log-probabilities, and how far each greedy choice falls
short of the reference's own.

The yardstick that decides ``correct`` for Qwen3-ASR. It imports torch
and numpy only (nothing of the port, nothing of JAX), computes in
float32 with TF32 off, with no cache and no batching: one row at a
time, one full causal forward of the LM over the row's positions. It
takes from the benchmark only what both sides are given: the seeded
weight tree as drawn (leaves named and laid out as the port's: (in,
out) matrices and convolutions OIHW, stacked over layers), a row's
audio as the program padded it, the tokens to judge, and, to judge the
LM by itself, the audio embeddings the program decoded from.

Qwen3-ASR (Hugging Face ``Qwen/Qwen3-ASR-1.7B``: the AuT encoder and
the Qwen3-1.7B language model):

- log-mel: Whisper's, at 128 mels (periodic Hann, n_fft 400, hop 160,
  centred reflect padding, the last frame dropped, Slaney mel, log10
  clamped at 1e-10, floored 8 below the row's maximum, (x + 4) / 4);
- AuT: the mel cut into chunks of ``2 * n_window`` frames (1 s), each a
  one-channel image (mels, frames) through three 3x3 stride-2
  convolutions padded by one, each with GELU; a token's features are
  its column of channels x frequencies, channel-major, projected by
  ``conv_out``; sinusoid positions that start again in every chunk;
  pre-LayerNorm layers whose attention is bidirectional inside windows
  of ``n_window_infer`` frames' tokens; ``ln_post``, then ``proj1``,
  GELU, ``proj2`` into the LM's width;
- Qwen3 LM: RMSNorm; q, k, v without biases; RMSNorm over each head of
  q and k; rotary embeddings over half-split pairs (GPT-NeoX), theta
  ``rope_theta``; causal grouped-query attention, query head h reading
  KV group h // (heads / KV groups); SwiGLU; a final RMSNorm and the
  head.

Departures, each kept because the program's served path runs it:

- a row's audio is zero-padded to its batch's padded length, and every
  audio token of it, the padding's included, is the LM's prefix,
  followed by BOS;
- the LM's matmuls and its head are int8 per output channel (the scale
  max |w| over the input axis / 127 + 1e-12, codes rounded half to
  even), worked out here from the tree and taken back to float32;
- the repetition penalty divides the positive logits and multiplies
  the negative ones of every id served before, EOS excepted, before the
  log-softmax;
- the special ids are the port's (``QWEN_SIZES``'s ``bos_id`` and
  ``eos_id``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SR = 16_000
N_FFT = 400
HOP = 160
# one precision below the configuration's float32, in the program's
# place: every product's operands rounded to bfloat16
CONTROLS = ("bf16",)
# the LM's matmuls the configuration serves in int8
INT8 = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def fp32_only() -> None:
    """Products and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# log-mel
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-12) / 1000.0)
                    * (27.0 / np.log(6.4)), 3.0 * f / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0
                                               * (m - 15.0)), 200.0 * m / 3.0)


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney mel filterbank with Slaney area normalisation, (n_mels,
    201)."""
    freqs = np.linspace(0.0, SR / 2.0, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SR / 2.0),
                                n_mels + 2))
    ramps = hz[:, None] - freqs[None, :]
    fdiff = np.diff(hz)
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                   ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]
    return w


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """float32 audio (B, n) -> log-mel (B, n_mels, n // 160)."""
    n = audio.shape[-1] // HOP
    x = F.pad(audio[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)[:, :n]
    window = torch.from_numpy(np.hanning(N_FFT + 1)[:-1].astype(
        np.float32)).to(x.device)
    power = torch.fft.rfft(frames * window, n=N_FFT).abs() ** 2
    fb = torch.from_numpy(mel_filters(n_mels).astype(np.float32)).to(x.device)
    spec = torch.log10(torch.clamp(torch.einsum("mf,btf->bmt", fb, power),
                                   min=1e-10))
    spec = torch.maximum(spec, spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (spec + 4.0) / 4.0


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def _low(t: torch.Tensor, low: bool) -> torch.Tensor:
    return t.bfloat16().float() if low else t


def _mm(x: torch.Tensor, w: torch.Tensor, low: bool = False) -> torch.Tensor:
    """x @ w in float32, or with both operands rounded to bfloat16."""
    return _low(x, low) @ _low(w, low)


def int8(w: torch.Tensor) -> torch.Tensor:
    """``w`` (..., in, out) in int8 codes per output channel, back in
    float32."""
    w = _f(w)
    s = w.abs().amax(dim=-2, keepdim=True) / w.new_tensor(127.0) + 1e-12
    return torch.clamp(torch.round(w / s), -127, 127) * s


def _attend(q, k, v, mask=None, low=False):
    """(Tq, H, hd) x (Tk, H, hd) -> (Tq, H, hd)."""
    q, k, v = (_low(t, low) for t in (q, k, v))
    logits = torch.einsum("qhd,khd->hqk", q, k) * q.shape[-1] ** -0.5
    if mask is not None:
        logits = logits + mask
    return _low(torch.einsum("hqk,khd->qhd", logits.softmax(-1), v), low)


# ---------------------------------------------------------------------------
# the audio tower
# ---------------------------------------------------------------------------

def positions(length: int, channels: int) -> torch.Tensor:
    """Sinusoid positions: sines then cosines of geometric timescales
    from 1 to 10000."""
    inv = np.exp(-np.log(10000.0) / (channels // 2 - 1)
                 * np.arange(channels // 2))
    ang = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(ang), np.cos(ang)],
                                           axis=1).astype(np.float32))


def tower(a: dict, mel: torch.Tensor, m: dict, low: bool = False
          ) -> torch.Tensor:
    """One row's log-mel (n_mels, T) -> audio embeddings (tokens, d_model);
    T a whole number of attention windows."""
    cf = 2 * m["n_window"]
    chunks = mel.shape[-1] // cf
    x = mel.reshape(m["n_mels"], chunks, cf).permute(1, 0, 2)[:, None]
    for i in (1, 2, 3):
        x = F.gelu(F.conv2d(_low(x, low), _low(_f(a[f"conv2d{i}_w"]), low),
                            _f(a[f"conv2d{i}_b"]), stride=2, padding=1))
    n, c, f, t = x.shape
    x = _mm(x.permute(0, 3, 1, 2).reshape(n, t, c * f), _f(a["conv_out_w"]),
            low)
    da = m["d_audio"]
    x = (x + positions(t, da).to(x.device)).reshape(-1, da)
    window = t * (m["n_window_infer"] // cf)
    p = {k: _f(v) for k, v in a["blocks"].items()}
    heads = m["audio_heads"]
    for i in range(m["audio_layers"]):
        h = F.layer_norm(x, (da,), p["ln1_s"][i], p["ln1_b"][i], 1e-5)
        q, k, v = (_mm(h, p[f"w{n}"][i], low) + p[f"b{n}"][i]
                   for n in "qkv")
        o = torch.cat([
            _attend(*(z[s:s + window].reshape(window, heads, -1)
                      for z in (q, k, v)), low=low).reshape(window, da)
            for s in range(0, x.shape[0], window)])
        x = x + _mm(o, p["wo"][i], low) + p["bo"][i]
        h = F.layer_norm(x, (da,), p["ln2_s"][i], p["ln2_b"][i], 1e-5)
        h = F.gelu(_mm(h, p["w1"][i], low) + p["b1"][i])
        x = x + _mm(h, p["w2"][i], low) + p["b2"][i]
    x = F.layer_norm(x, (da,), _f(a["ln_post_s"]), _f(a["ln_post_b"]), 1e-5)
    x = F.gelu(_mm(x, _f(a["proj1_w"]), low) + _f(a["proj1_b"]))
    return _mm(x, _f(a["proj2_w"]), low) + _f(a["proj2_b"])


# ---------------------------------------------------------------------------
# the language model
# ---------------------------------------------------------------------------

def lm_weights(tree: dict) -> dict:
    """The LM as the configuration serves it: its matmuls and head in
    int8 per output channel, the rest float32."""
    blocks = {k: int8(v) if k in INT8 else _f(v)
              for k, v in tree["blocks"].items()}
    return {"blocks": blocks, "tok_emb": _f(tree["tok_emb"]),
            "ln_f": _f(tree["ln_f"]), "head": int8(tree["lm_head"])}


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rope(x, cos, sin):
    """x (T, H, hd): pairs (i, i + hd/2) rotated by their angles."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def lm_hidden(w: dict, m: dict, x: torch.Tensor, low: bool = False
              ) -> torch.Tensor:
    """The LM's causal forward over embedded positions x (T, d) -> the
    final normed states (T, d)."""
    t = x.shape[0]
    nh, nkv = m["n_heads"], m["n_kv_heads"]
    hd = m["lm_head_dim"] or m["d_model"] // nh
    eps = m["rms_eps"]
    dev = x.device
    inv = 1.0 / (m["rope_theta"] ** (torch.arange(
        0, hd, 2, dtype=torch.float32, device=dev) / hd))
    ang = torch.arange(t, dtype=torch.float32, device=dev)[:, None] * inv
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    idx = torch.arange(t, device=dev)
    causal = torch.where(idx[None, :] <= idx[:, None], 0.0, float("-inf"))
    p = w["blocks"]
    for i in range(m["n_layers"]):
        h = _rms(x, p["ln1"][i], eps)
        q = _mm(h, p["wq"][i], low).reshape(t, nh, hd)
        k = _mm(h, p["wk"][i], low).reshape(t, nkv, hd)
        v = _mm(h, p["wv"][i], low).reshape(t, nkv, hd)
        q = _rope(_rms(q, p["q_norm"][i], eps), cos, sin)
        k = _rope(_rms(k, p["k_norm"][i], eps), cos, sin)
        k, v = (z.repeat_interleave(nh // nkv, dim=1) for z in (k, v))
        o = _attend(q, k, v, causal, low).reshape(t, nh * hd)
        x = x + _mm(o, p["wo"][i], low)
        h = _rms(x, p["ln2"][i], eps)
        gate = F.silu(_mm(h, p["w_gate"][i], low))
        x = x + _mm(gate * _mm(h, p["w_up"][i], low), p["w_down"][i], low)
    return _rms(x, w["ln_f"], eps)


def _penalised(w: dict, m: dict, hidden: torch.Tensor, served: np.ndarray,
               penalty: float, low: bool, block: int):
    """(positions, the penalised logits before each served token) in
    blocks of ``block`` positions, from the LM's final states ``hidden``
    before each: the repetition penalty applied to every id served
    before the position (EOS excepted)."""
    dev = hidden.device
    # the first position each id is served at (EOS and unserved ids:
    # never); an id counts as served before position i if that is < i
    first = np.full(m["vocab_size"], len(served), np.int64)
    for i, t in reversed(list(enumerate(served))):
        if t != m["eos_id"]:
            first[t] = i
    first = torch.from_numpy(first).to(dev)
    rp = torch.tensor(penalty, device=dev)
    for lo in range(0, len(served), block):
        pos = torch.arange(lo, min(lo + block, len(served)), device=dev)
        lg = _mm(hidden[pos], w["head"], low)
        seen = first[None, :] < pos[:, None]
        yield pos, torch.where(seen, torch.where(lg > 0, lg / rp, lg * rp),
                               lg)


def _hidden(w: dict, m: dict, prefix: torch.Tensor, tok: torch.Tensor,
            low: bool) -> torch.Tensor:
    """The LM's final states before each served token ``tok``: after
    the audio embeddings ``prefix`` (P, d), BOS and ``tok[:-1]``."""
    dev = prefix.device
    ids = torch.cat([torch.tensor([m["bos_id"]], device=dev), tok[:-1]])
    x = torch.cat([_f(prefix), w["tok_emb"][ids]])
    return lm_hidden(w, m, x, low)[prefix.shape[0]:]


def _tokens(served: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(served, np.int64)).to(dev)


def served_logprob(w: dict, m: dict, prefix: torch.Tensor,
                   served: np.ndarray, penalty: float, low: bool = False,
                   block: int = 128) -> float:
    """The summed log-probability of the ``served`` tokens after the
    audio embeddings ``prefix`` (P, d) and BOS, the repetition penalty
    applied to every id served before each (EOS excepted); the head in
    blocks of ``block`` positions."""
    tok = _tokens(served, prefix.device)
    hidden = _hidden(w, m, prefix, tok, low)
    total = 0.0
    for pos, lg in _penalised(w, m, hidden, served, penalty, low, block):
        lp = lg.log_softmax(-1).gather(1, tok[pos, None])[:, 0]
        total += float(lp.double().sum())
    return total


def read_path(w: dict, m: dict, prefix: torch.Tensor, served: np.ndarray,
              penalty: float, control: bool = False, block: int = 128
              ) -> dict:
    """The served tokens along the LM after ``prefix``: ``sum``, their
    summed penalised log-probability (:func:`served_logprob`), and
    ``lead``, the widest lead over the positions of the largest
    penalised logit over the served token's, in nats: a greedy choice
    reads 0 where the choice is the reference's, and the gap of the
    logits where it is not. With ``control``, also ``low_sum``, the sum
    one precision lower, and ``low_lead``, the lead of this reference's
    logits over the token the lower one would choose at each position
    (its largest)."""
    tok = _tokens(served, prefix.device)
    blocks = [_penalised(w, m, _hidden(w, m, prefix, tok, False), served,
                         penalty, False, block)]
    if control:
        blocks.append(_penalised(w, m, _hidden(w, m, prefix, tok, True),
                                 served, penalty, True, block))
    out = {"sum": 0.0, "lead": 0.0, "low_sum": 0.0, "low_lead": 0.0}
    for parts in zip(*blocks):
        pos, lg = parts[0]
        best = lg.amax(-1)
        lp = lg.log_softmax(-1).gather(1, tok[pos, None])[:, 0]
        out["sum"] += float(lp.double().sum())
        mine = lg.gather(1, tok[pos, None])[:, 0]
        out["lead"] = max(out["lead"], float((best - mine).amax()))
        if control:
            low = parts[1][1]
            lp = low.log_softmax(-1).gather(1, tok[pos, None])[:, 0]
            out["low_sum"] += float(lp.double().sum())
            pick = lg.gather(1, low.argmax(-1)[:, None])[:, 0]
            out["low_lead"] = max(out["low_lead"],
                                  float((best - pick).amax()))
    return out


# ---------------------------------------------------------------------------
# the whole judgement of some rows
# ---------------------------------------------------------------------------

def audio_err(emb: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest token's rms gap between audio embeddings ``emb`` and
    the reference's ``ref`` (T, d), over the rms of ``ref``."""
    gap = (_f(emb) - ref).pow(2).mean(-1).sqrt()
    return float(gap.amax() / ref.pow(2).mean().sqrt())


def judge_rows(tree: dict, m: dict, audio: Sequence[np.ndarray],
               served: Sequence[np.ndarray],
               embeddings: Sequence[torch.Tensor], device, penalty: float,
               control: Optional[str] = None) -> List[Dict]:
    """The reference's readings of rows the program served.

    ``audio`` holds each row's audio as the program padded it, ``served``
    the tokens it served (to the first EOS, that included),
    ``embeddings`` the audio embeddings it decoded them from. Returns a
    dict a row: ``audio_err`` (:func:`audio_err` of the program's
    embeddings against the reference's tower), ``full`` (the served
    tokens' summed log-probability along the reference's whole path
    from the audio), ``decoder`` (the same, the reference's LM reading
    the program's embeddings) and ``lead`` (:func:`read_path`'s, on the
    program's embeddings: how far the program's greedy choices fall
    short of the reference's); with ``control`` (one of CONTROLS) also
    ``control``, the same four computed one precision lower (its
    ``lead``: of the token the lower reference would choose)."""
    fp32_only()
    if control not in (None, *CONTROLS):
        raise ValueError(f"unknown control {control!r}")
    low = control == "bf16"
    w = lm_weights(tree)
    out = []
    with torch.no_grad():
        for pcm, tok, emb in zip(audio, served, embeddings):
            pcm = torch.from_numpy(np.asarray(pcm, np.float32)).to(device)
            mel = log_mel(pcm[None], m["n_mels"])[0]
            emb = _f(torch.as_tensor(emb).to(device))
            ref = tower(tree["audio"], mel, m)
            path = read_path(w, m, emb, tok, penalty, low)
            row = {"audio_err": audio_err(emb, ref),
                   "full": served_logprob(w, m, ref, tok, penalty),
                   "decoder": path["sum"], "lead": path["lead"]}
            if low:
                ref_low = tower(tree["audio"], mel, m, True)
                row["control"] = {
                    "audio_err": audio_err(ref_low, ref),
                    "full": served_logprob(w, m, ref_low, tok, penalty,
                                           True),
                    "decoder": path["low_sum"], "lead": path["low_lead"]}
            out.append(row)
    return out
