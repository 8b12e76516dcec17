"""Plain float32 Whisper: log-mel, encoder, int8 cross-K/V, decoder and
the logit rules, teacher-forced along tokens given to it.

The yardstick that decides ``correct``. It imports torch and numpy only
(nothing of the port, nothing of JAX), computes in float32 with TF32
off, and takes from the benchmark only the inputs both sides are given:
the seeded weight tree (leaves named and laid out as the port's, (in,
out) matrices stacked over layers), the audio, the decode options and
the tokens to judge, and, to judge them stage by stage, the encoder
states the port decoded from. Whatever the port derives at set-up it
works out again here: the int16 upload, log-mel, the cross-K/V bucket,
the int8 cross-K/V codes and scales, and, for a configuration with int8
decoder weights, their codes and scales.

Published Whisper (Radford et al. 2022), with the port's stated
departures, each kept here because the configuration runs them:
encoder states sliced to the cross-K/V bucket that covers the batch's
longest window; cross-K/V quantised symmetrically to int8 per (layer,
row, head); int8 decoder weights per output channel when the
configuration says so; the logit rules of the port's decode options
(suppressed ids, blank and EOT at the first step, the CTranslate2
repetition penalty, the n-gram ban, the timestamp rules).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SR = 16_000
N_FFT = 400
HOP = 160
N_SAMPLES = 30 * SR
N_FRAMES = N_SAMPLES // HOP
BUCKETS = (448, 960, 1500)
FRAMES_PER_SECOND = 50
LANGUAGES = ("en", "zh", "de", "es", "ru", "ko", "fr", "ja")


def fp32_only() -> None:
    """Products and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# ids
# ---------------------------------------------------------------------------

def specials(vocab: int) -> Dict[str, int]:
    """Whisper's special ids (multilingual vocabulary; large-v3 and turbo
    have one more language, which moves the ids after the languages)."""
    v3 = vocab != 51865
    return {"eot": 50257, "sot": 50258, "lang0": 50259,
            "transcribe": 50360 if v3 else 50359,
            "no_speech": 50363 if v3 else 50362,
            "ts_begin": 50365 if v3 else 50364}


def prompt(vocab: int, language: str) -> List[int]:
    sp = specials(vocab)
    return [sp["sot"], sp["lang0"] + LANGUAGES.index(language),
            sp["transcribe"]]


def bucket(max_duration: float) -> int:
    """The cross-K/V frames a batch whose longest window lasts
    ``max_duration`` seconds is decoded against."""
    need = int(np.ceil(max_duration * FRAMES_PER_SECOND)) + 8
    return next((b for b in BUCKETS if b >= need), BUCKETS[-1])


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------

def as_int16(audio: np.ndarray) -> np.ndarray:
    """Float audio in [-1, 1] as the int16 samples of a WAV (truncated
    toward zero), zero-padded to 30 s."""
    out = np.zeros(N_SAMPLES, np.int16)
    x = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    out[:len(x)] = x[:N_SAMPLES]
    return out


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-12) / 1000.0)
                    * (27.0 / np.log(6.4)), 3.0 * f / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0
                                               * (m - 15.0)), 200.0 * m / 3.0)


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney mel filterbank with Slaney area normalisation (librosa's
    default, as openai-whisper ships it), (n_mels, 201)."""
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
    """int16 (B, N_SAMPLES) -> openai-whisper's log-mel (B, n_mels, 3000):
    centred reflect-padded STFT (n_fft 400, hop 160, periodic Hann), the
    last frame dropped, power, mel, log10 clamped at 1e-10, floored 8
    below the window's maximum, (x + 4) / 4."""
    x = audio.float() / 32768.0
    x = F.pad(x[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)[:, :N_FRAMES]
    window = torch.from_numpy(np.hanning(N_FFT + 1)[:-1].astype(
        np.float32)).to(x.device)
    power = torch.fft.rfft(frames * window, n=N_FFT).abs() ** 2
    fb = torch.from_numpy(mel_filters(n_mels).astype(np.float32)).to(x.device)
    mel = torch.einsum("mf,btf->bmt", fb, power)
    spec = torch.log10(torch.clamp(mel, min=1e-10))
    spec = torch.maximum(spec, spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (spec + 4.0) / 4.0


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def quantize(w: torch.Tensor, axis, levels: int = 127,
             eps: float = 1e-12) -> torch.Tensor:
    """Symmetric integer codes of ``w`` over ``axis`` (the scale max |w| /
    ``levels``, codes rounded half to even), back in float32: int8 with
    127 levels, int4 with 7."""
    s = w.abs().amax(dim=axis, keepdim=True) / float(levels) + eps
    return torch.clamp(torch.round(w / s), -levels, levels) * s


def fp8(t: torch.Tensor, axis=-1) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale over ``axis`` (None:
    the whole tensor), back in float32."""
    amax = t.abs().amax() if axis is None else t.abs().amax(
        dim=axis, keepdim=True)
    s = amax.clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _mm(x: torch.Tensor, w: torch.Tensor, low: bool) -> torch.Tensor:
    """x @ w, in float32, or with both operands in float8 (``low``)."""
    if low:
        return fp8(x) @ fp8(w, None)
    return x @ w


def _ln(x, s, b):
    return F.layer_norm(x, (x.shape[-1],), _f(s), _f(b), 1e-5)


def _attend(q, k, v, mask=None, low=False):
    """(B, Tq, H, hd) x (B, Tk, H, hd) -> (B, Tq, H, hd)."""
    if low:
        q, k, v = fp8(q), fp8(k), fp8(v)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if mask is not None:
        logits = logits + mask
    return torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v)


def _heads(x, n_head):
    return x.reshape(*x.shape[:2], n_head, -1)


def encode(enc: dict, mel: torch.Tensor, n_head: int,
           low: bool = False) -> torch.Tensor:
    """Encoder: mel (B, n_mels, 3000) -> states (B, 1500, d); ``low``
    takes every product's operands in float8."""
    x = F.gelu(F.conv1d(mel, _f(enc["conv1_w"]), _f(enc["conv1_b"]),
                        padding=1))
    x = F.gelu(F.conv1d(x, _f(enc["conv2_w"]), _f(enc["conv2_b"]),
                        stride=2, padding=1))
    x = x.transpose(1, 2) + _f(enc["pos"])
    p = enc["blocks"]
    for i in range(p["wq"].shape[0]):
        h = _ln(x, p["ln1_s"][i], p["ln1_b"][i])
        q = _heads(_mm(h, _f(p["wq"][i]), low) + _f(p["bq"][i]), n_head)
        k = _heads(_mm(h, _f(p["wk"][i]), low), n_head)
        v = _heads(_mm(h, _f(p["wv"][i]), low) + _f(p["bv"][i]), n_head)
        a = _attend(q, k, v, low=low).reshape(x.shape)
        x = x + _mm(a, _f(p["wo"][i]), low) + _f(p["bo"][i])
        h = _ln(x, p["ln2_s"][i], p["ln2_b"][i])
        h = F.gelu(_mm(h, _f(p["w1"][i]), low) + _f(p["b1"][i]))
        x = x + _mm(h, _f(p["w2"][i]), low) + _f(p["b2"][i])
    return _ln(x, enc["ln_s"], enc["ln_b"])


def cross_kv(dec: dict, xa: torch.Tensor, n_head: int,
             low: bool = False) -> List[tuple]:
    """Each decoder layer's cross K and V of states ``xa`` (B, T, d),
    quantised to int8 per (row, head) over (T, hd), as float32
    (B, T, H, hd)."""
    p = dec["blocks"]
    out = []
    for i in range(p["cwk"].shape[0]):
        k = _heads(_mm(xa, _f(p["cwk"][i]), low), n_head)
        v = _heads(_mm(xa, _f(p["cwv"][i]), low) + _f(p["cbv"][i]), n_head)
        out.append(tuple(quantize(t, (1, 3), eps=1e-9) for t in (k, v)))
    return out


def decoder_weights(dec: dict, levels: int = 0) -> dict:
    """The decoder's matrices as the configuration runs them: float32
    (``levels`` 0), or integer codes per output channel (127 levels:
    int8, 7: int4) for the products each step reads and the tied head;
    the cross K/V projections stay as they are."""
    p = {k: _f(v) for k, v in dec["blocks"].items()}
    head = _f(dec["tok_emb"]).t()
    if levels:
        for name in ("wq", "wk", "wv", "wo", "cwq", "cwo", "w1", "w2"):
            p[name] = quantize(p[name], -2, levels)
        head = quantize(head, 0, levels)
    return {"blocks": p, "head": head, "tok_emb": _f(dec["tok_emb"]),
            "pos_emb": _f(dec["pos_emb"]), "ln_s": dec["ln_s"],
            "ln_b": dec["ln_b"]}


def decode_logits(w: dict, tokens: torch.Tensor, cross: List[tuple],
                  n_head: int, low: bool = False) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, S) -> logits (B, S, vocab)."""
    s = tokens.shape[1]
    x = w["tok_emb"][tokens] + w["pos_emb"][:s]
    idx = torch.arange(s, device=tokens.device)
    causal = torch.where(idx[None, :] <= idx[:, None], 0.0, float("-inf"))
    p = w["blocks"]
    for i, (ck, cv) in enumerate(cross):
        h = _ln(x, p["ln1_s"][i], p["ln1_b"][i])
        q = _heads(_mm(h, p["wq"][i], low) + p["bq"][i], n_head)
        k = _heads(_mm(h, p["wk"][i], low), n_head)
        v = _heads(_mm(h, p["wv"][i], low) + p["bv"][i], n_head)
        a = _attend(q, k, v, causal, low).reshape(x.shape)
        x = x + _mm(a, p["wo"][i], low) + p["bo"][i]
        h = _ln(x, p["lnx_s"][i], p["lnx_b"][i])
        q = _heads(_mm(h, p["cwq"][i], low) + p["cbq"][i], n_head)
        a = _attend(q, ck, cv, low=low).reshape(x.shape)
        x = x + _mm(a, p["cwo"][i], low) + p["cbo"][i]
        h = _ln(x, p["ln2_s"][i], p["ln2_b"][i])
        h = F.gelu(_mm(h, p["w1"][i], low) + p["b1"][i])
        x = x + _mm(h, p["w2"][i], low) + p["b2"][i]
    return _mm(_ln(x, w["ln_s"], w["ln_b"]), w["head"], low)


# ---------------------------------------------------------------------------
# logit rules, along given tokens
# ---------------------------------------------------------------------------

def rule_logprobs(logits: torch.Tensor, served: np.ndarray,
                  history: np.ndarray, vocab: int,
                  options: dict) -> dict:
    """Log-probabilities after the decode options' logit rules, along
    the served tokens.

    ``logits`` (B, n, V) are the raw logits before each served token;
    ``history`` (B, P + n) the prompt and the served tokens. The last
    rule (text is masked when the timestamps' summed probability beats
    the best text token's) is a threshold on the logits, so both of its
    branches are returned with the margin that decides between them.
    Returns (B, n) arrays: ``margin`` (log of the timestamps' mass less
    the best text token's log-probability; the rule masks text where it
    is above 0), and for each branch (``free``: text kept, ``forced``:
    text masked) the served token's log-probability (-inf where the
    branch forbids it)."""
    sp = specials(vocab)
    eot, ts = sp["eot"], sp["ts_begin"]
    b, n, v = logits.shape
    dev = logits.device
    plen = history.shape[1] - n
    static = torch.zeros(v, device=dev)
    static[list(options["suppress_tokens"])] = float("-inf")
    static[eot + 1:ts] = float("-inf")
    is_ts = torch.arange(v, device=dev) >= ts
    max_init = ts + int(round(options["max_initial_timestamp"]
                              / options["ts_precision"]))
    penalty = options["repetition_penalty"]
    ngram = options["no_repeat_ngram_size"]
    last = np.zeros(b, bool)
    penult = np.ones(b, bool)
    max_ts = np.full(b, ts)
    seen = torch.zeros((b, v), dtype=torch.bool, device=dev)
    out = {k: torch.empty((b, n), device=dev)
           for k in ("margin", "free", "forced")}
    rows = torch.arange(b, device=dev)
    idx = torch.arange(v, device=dev)[None, :]
    for step in range(n):
        x = logits[:, step] + static
        if step == 0:
            x[:, options["blank_token"]] = float("-inf")
            x[:, eot] = float("-inf")
        if penalty != 1.0:
            hit = seen.clone()
            hit[:, eot] = False
            x = torch.where(hit, torch.where(x > 0, x / penalty, x * penalty),
                            x)
        if ngram > 0:
            cur = plen + step
            for r in range(b):
                h = history[r, :cur]
                tail = h[cur - ngram + 1:]
                ban = [int(h[i + ngram - 1]) for i in range(cur - ngram + 1)
                       if np.array_equal(h[i:i + ngram - 1], tail)]
                ban = [t for t in ban if t != eot]
                if ban:
                    x[r, ban] = float("-inf")
        lone = torch.from_numpy(last & ~penult).to(dev)[:, None]
        closed = torch.from_numpy(last & penult).to(dev)[:, None]
        sup = (lone & ~is_ts & (idx != eot)) | (closed & is_ts)
        if step == 0:
            sup = sup | ~is_ts | (idx > max_init)
        else:
            bound = torch.from_numpy(max_ts + (~(last & ~penult))).to(dev)
            sup = sup | (is_ts & (idx < bound[:, None]))
        x = x.masked_fill(sup, float("-inf"))
        lp = x.log_softmax(-1)
        ts_mass = lp.masked_fill(~is_ts, float("-inf")).logsumexp(-1)
        text_best = lp.masked_fill(is_ts, float("-inf")).amax(-1)
        forced = x.masked_fill(~is_ts, float("-inf")).log_softmax(-1)
        tok = torch.from_numpy(served[:, step].astype(np.int64)).to(dev)
        out["margin"][:, step] = ts_mass - text_best
        out["free"][:, step] = lp[rows, tok]
        out["forced"][:, step] = forced[rows, tok]
        tok_np = served[:, step]
        tok_ts = tok_np >= ts
        max_ts = np.where(tok_ts, np.maximum(max_ts, tok_np), max_ts)
        penult, last = last, tok_ts
        if penalty != 1.0:
            seen[rows, tok] = True
    return {k: t.cpu().numpy().astype(np.float64) for k, t in out.items()}


def along(steps: dict, row: int, margin_tol: float) -> dict:
    """A row's reading of :func:`rule_logprobs`' steps: at each step the
    branch the reference's own margin takes, or, where the margin lies
    within ``margin_tol`` of the threshold (rounding of the logits can
    move the program's decision across it), either branch that allows
    the served token. Returns the summed log-probability along the
    reference's choices (``sum``; -inf where no branch allows a served
    token), the change of that sum each open step would make by taking
    its other branch with that step's margin (``open``: (change,
    margin) pairs) and the margins of the steps that had to take the
    other branch (``crossed``)."""
    total, open_, crossed = 0.0, [], []
    for step in range(steps["margin"].shape[1]):
        m = steps["margin"][row, step]
        own = "forced" if m > 0 else "free"
        other = "free" if m > 0 else "forced"
        branches = [own] + ([other] if abs(m) <= margin_tol else [])
        legal = [k for k in branches if np.isfinite(steps[k][row, step])]
        if not legal:
            return {"sum": -np.inf, "open": [], "crossed": crossed}
        if legal[0] != own:
            crossed.append(float(m))
        lp = steps[legal[0]][row, step]
        total += lp
        if len(legal) == 2:
            open_.append((steps[legal[1]][row, step] - lp, float(m)))
    return {"sum": total, "open": open_, "crossed": crossed}


# ---------------------------------------------------------------------------
# the whole judgement of some rows
# ---------------------------------------------------------------------------

# the reference one precision below a configuration, in the program's
# place: float8 products for bfloat16 compute, int4 for int8 weights
CONTROLS = ("fp8", "int4_weights")


def encoder_err(xa: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest frame's rms gap between encoder states ``xa`` and the
    reference's ``ref`` (T, d), over the rms of ``ref``: a frame at a
    time, so one wrong frame shows as plainly as a wrong row."""
    frame = (xa.float() - ref).pow(2).mean(-1).sqrt()
    return float(frame.amax() / ref.pow(2).mean().sqrt())


def judge_rows(tree: dict, model: dict, options: dict,
               audio: Sequence[np.ndarray], buckets: Sequence[int],
               served: Sequence[np.ndarray], states: Sequence[np.ndarray],
               device, int8_weights: bool = False, margin_tol: float = 0.0,
               control: Optional[str] = None, block: int = 8) -> List[dict]:
    """The reference's readings of rows the program decoded.

    ``audio`` holds each row's window audio, ``buckets`` the cross-K/V
    frames of its batch, ``served`` the tokens the program served,
    ``states`` the encoder states the program decoded them from (its
    bucket's frames, a tensor a row, read only to judge them); ``int8_weights`` says whether the configuration
    runs int8 decoder weights, ``margin_tol`` how near its threshold the
    timestamp rule's margin may lie for either branch to stand
    (:func:`along`). Returns a dict a row:

    - ``encoder_err``: :func:`encoder_err` of the program's states
      against the reference's encoder over the row's audio;
    - ``full``: :func:`along`'s reading of the served tokens, the
      reference's whole path from the audio;
    - ``decoder``: the same, the reference's decoder reading the
      program's encoder states (the decoder's stage by itself);

    with ``control`` (one of CONTROLS) also ``control``: the reference
    computed that way, in the program's place: its encoder's
    ``encoder_err``, and the summed log-probabilities its whole path
    (``full``) and its decoder on the program's states (``decoder``)
    give the served tokens."""
    fp32_only()
    if control not in (None, *CONTROLS):
        raise ValueError(f"unknown control {control!r}")
    vocab, n_head = model["vocab_size"], model["attention_heads"]
    pre = prompt(vocab, options["language"])
    levels = 127 if int8_weights else 0
    dec = decoder_weights(tree["decoder"], levels)
    low = control == "fp8"
    dec_low = dec if not control else decoder_weights(
        tree["decoder"], 7 if control == "int4_weights" else levels)

    def read(weights, xa, tok, hist, bucket, low_=False):
        ids = torch.from_numpy(hist[:, :-1].astype(np.int64)).to(device)
        cross = cross_kv(weights, xa[None, :bucket], n_head, low_)
        logits = decode_logits(weights, ids, cross, n_head, low_)
        steps = rule_logprobs(logits[:, len(pre) - 1:], tok[None], hist,
                              vocab, options)
        return along(steps, 0, margin_tol)

    out = [{} for _ in audio]
    with torch.no_grad():
        for lo in range(0, len(audio), block):
            rows = range(lo, min(lo + block, len(audio)))
            pcm = torch.from_numpy(np.stack([as_int16(audio[r])
                                             for r in rows])).to(device)
            mel = log_mel(pcm, model["n_mels"])
            xa = encode(tree["encoder"], mel, n_head)
            xa_low = encode(tree["encoder"], mel, n_head, True) if low \
                else xa
            for j, r in enumerate(rows):
                tok = np.asarray(served[r])
                hist = np.concatenate([pre, tok])[None]
                b = buckets[r]
                prog = torch.as_tensor(states[r]).to(device=device,
                                                     dtype=torch.float32)
                ref = xa[j, :b]
                out[r] = {
                    "encoder_err": encoder_err(prog, ref),
                    "full": read(dec, xa[j], tok, hist, b),
                    "decoder": read(dec, prog, tok, hist, b)}
                if control:
                    out[r]["control"] = {
                        "encoder_err": encoder_err(xa_low[j, :b], ref),
                        "full": read(dec_low, xa_low[j], tok, hist, b,
                                     low)["sum"],
                        "decoder": read(dec_low, prog, tok, hist, b,
                                        low)["sum"]}
            del xa, xa_low
    return out
