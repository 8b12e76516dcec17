"""Batched Whisper decoding in PyTorch: greedy/sampled and beam search.

Counterpart of ``whisperjav_tpu/models/whisper/decode.py`` with the same
options, logit rules, results and segment extraction. The JAX package
runs each loop as one ``lax.while_loop``; here each is a Python loop over
fixed-shape tensors (the whole batch in lockstep, finished rows frozen),
which reads one flag back from the device per step to decide whether to
go on.

Sampling is ``argmax(logits + T * gumbel)``, so temperature 0 is exact
greedy. The gumbel noise comes from a ``torch.Generator``; a ``gumbel``
callable may supply it instead (tests feed it the noise the JAX package
draws, to compare sampled tokens exactly).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from whisperjav_tpu_torch.models.whisper.config import (
    WhisperConfig, language_token,
)
from whisperjav_tpu_torch.models.whisper.tokenizer import (
    DEFAULT_NONSPEECH_TOKENS,
)
from whisperjav_tpu_torch.models.whisper.model import (
    KVCache, Whisper, decode_step, precompute_cross_kv,
)

_BLANK_TOKEN = 220  # GPT-2 BPE " " token; suppressed at the first step
_NEG = float("-inf")


@dataclass(frozen=True)
class DecodeOptions:
    """Decoding configuration; fields and defaults as in the JAX package.

    Only int8 cross-K/V is ported (``cross_kv_int8`` must be True when
    decoding, ``cross_kv_int4`` False). ``assume_greedy`` decodes by
    argmax whatever the temperature, as in the JAX package.
    """
    task: str = "transcribe"
    language: str = "ja"
    max_new_tokens: int = 224
    with_timestamps: bool = True
    max_initial_timestamp: float = 1.0
    suppress_blank: bool = True
    suppress_tokens: Tuple[int, ...] = DEFAULT_NONSPEECH_TOKENS
    blank_token: int = _BLANK_TOKEN
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    beam_size: int = 1
    patience: float = 1.0
    best_of: int = 1
    length_penalty: float = 1.0
    ts_precision: float = 0.02
    cross_kv_int8: bool = False
    cross_kv_int4: bool = False
    assume_greedy: bool = False


class DecodeResult(NamedTuple):
    tokens: torch.Tensor        # (B, max_new) generated ids, eot-padded
    length: torch.Tensor        # (B,) generated tokens before eot
    sum_logprob: torch.Tensor   # (B,)
    avg_logprob: torch.Tensor   # (B,)  sum / (length + 1)
    no_speech_prob: torch.Tensor  # (B,)


def initial_tokens(config: WhisperConfig, options: DecodeOptions,
                   prompt: Sequence[int] = ()) -> np.ndarray:
    """SOT sequence: [prev-prompt] + [sot, lang, task] (+ no_timestamps)."""
    toks = [config.sot_prev, *prompt] if prompt else []
    toks += [config.sot, language_token(config, options.language),
             config.transcribe if options.task == "transcribe"
             else config.translate]
    if not options.with_timestamps:
        toks.append(config.no_timestamps)
    return np.asarray(toks, np.int64)


def _static_suppress_mask(config: WhisperConfig,
                          options: DecodeOptions) -> np.ndarray:
    """(V,) additive mask of always-suppressed ids (specials + non-speech)."""
    mask = np.zeros((config.n_vocab,), np.float32)
    for t in options.suppress_tokens:
        if 0 <= t < config.n_vocab:
            mask[t] = -np.inf
    mask[config.eot + 1: config.timestamp_begin] = -np.inf
    if not options.with_timestamps:
        mask[config.timestamp_begin:] = -np.inf
    return mask


def _check_options(options: DecodeOptions) -> None:
    if options.cross_kv_int4 or not options.cross_kv_int8:
        raise NotImplementedError(
            "only int8 cross-K/V is ported: set cross_kv_int8=True and "
            "cross_kv_int4=False")


@dataclass
class _Rules:
    """Per-step state the logit rules read (rows = B or B*k)."""
    step: int
    tokens: torch.Tensor         # (rows, total_len)
    last_was_ts: torch.Tensor    # (rows,) bool
    penult_was_ts: torch.Tensor  # (rows,) bool
    max_ts: torch.Tensor         # (rows,) highest emitted timestamp id
    seen: torch.Tensor           # (rows, V) bool, ids emitted so far


def _apply_logit_rules(logits: torch.Tensor, s: _Rules,
                       config: WhisperConfig, options: DecodeOptions,
                       static_mask: torch.Tensor,
                       prompt_len: int) -> torch.Tensor:
    """All Whisper logit filters, vectorized over the rows."""
    rows, v = logits.shape
    dev = logits.device
    logits = logits + static_mask[None, :]
    is_first = s.step == 0

    if options.suppress_blank and is_first:
        logits[:, options.blank_token] = _NEG
        logits[:, config.eot] = _NEG

    if options.repetition_penalty != 1.0:
        # CTranslate2-style: penalize every generated id except eot
        penalty = options.repetition_penalty
        seen = s.seen.clone()
        seen[:, config.eot] = False
        penalized = torch.where(logits > 0, logits / penalty,
                                logits * penalty)
        logits = torch.where(seen, penalized, logits)

    if options.no_repeat_ngram_size > 0:
        # ban any token that would complete an n-gram already present
        n = options.no_repeat_ngram_size
        tl = s.tokens.shape[1]
        cur = prompt_len + s.step                 # next write position
        start = min(max(cur - (n - 1), 0), tl - (n - 1))
        suf = s.tokens[:, start:start + n - 1]
        nwin = tl - n + 1
        match = torch.ones((rows, nwin), dtype=torch.bool, device=dev)
        for i in range(n - 1):
            match &= s.tokens[:, i:i + nwin] == suf[:, i:i + 1]
        match &= torch.arange(nwin, device=dev)[None, :] <= cur - n
        completions = s.tokens[:, n - 1:n - 1 + nwin]
        # scatter the completions of matching windows; column v collects
        # the rest and is dropped
        target = torch.where(match, completions, v)
        banned = torch.zeros((rows, v + 1), dtype=torch.bool, device=dev)
        banned.scatter_(1, target, True)
        banned = banned[:, :v]
        banned[:, config.eot] = False             # EOT stays legal
        logits = logits.masked_fill(banned, _NEG)

    if options.with_timestamps:
        ts_begin = config.timestamp_begin
        idx = torch.arange(v, device=dev)[None, :]
        is_ts = idx >= ts_begin
        # pairing: after "text <ts>" only timestamps/EOT may follow; after
        # "<ts> <ts>" another timestamp may not immediately open
        lone_ts = s.last_was_ts & ~s.penult_was_ts
        closed_ts = s.last_was_ts & s.penult_was_ts
        sup = (lone_ts[:, None] & ~is_ts & (idx != config.eot)) \
            | (closed_ts[:, None] & is_ts)
        if not is_first:
            # monotonic: an opening timestamp must exceed the last one, a
            # closing one may equal it
            mono_bound = s.max_ts + (~lone_ts).long()
            sup |= is_ts & (idx < mono_bound[:, None])
        else:
            # the first sampled token is a timestamp <= max_initial
            max_init = ts_begin + int(round(
                options.max_initial_timestamp / options.ts_precision))
            sup |= ~is_ts | (idx > max_init)
        logits = logits.masked_fill(sup, _NEG)

        # force a timestamp when P(any timestamp) > max P(text token)
        lp = torch.log_softmax(logits, dim=-1)
        ts_lse = torch.logsumexp(lp.masked_fill(~is_ts, _NEG), dim=-1)
        max_text = lp.masked_fill(is_ts, _NEG).amax(dim=-1)
        force_ts = ts_lse > max_text
        logits = logits.masked_fill(force_ts[:, None] & ~is_ts, _NEG)

    return logits


def _draw_gumbel(generator: torch.Generator, shape,
                 device) -> torch.Tensor:
    """-log(-log(u)), u uniform on [tiny, 1), as ``jax.random.gumbel``."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _finalize(tokens, prompt_len, max_new, length, sum_lp, no_speech_prob,
              eot) -> DecodeResult:
    gen = tokens[:, prompt_len:prompt_len + max_new]
    is_eot = gen == eot
    cut = torch.where(is_eot.any(dim=1), is_eot.int().argmax(dim=1),
                      torch.full_like(length, max_new))
    pos = torch.arange(max_new, device=gen.device)[None, :]
    gen = torch.where(pos >= cut[:, None], torch.full_like(gen, eot), gen)
    avg_lp = sum_lp / (length.float() + 1.0)
    return DecodeResult(gen, length, sum_lp, avg_lp, no_speech_prob)


def _prefill(model: Whisper, xa: torch.Tensor, options: DecodeOptions,
             prompt: Sequence[int], rows: int):
    """Cross-K/V, the zeroed cache and token buffer for ``rows`` rows, and
    the prefill logits of the SOT sequence."""
    config = model.config
    init = initial_tokens(config, options, prompt)
    prompt_len = len(init)
    total_len = prompt_len + options.max_new_tokens
    dev = xa.device
    init_t = torch.as_tensor(init, device=dev)
    tokens = torch.zeros((rows, total_len), dtype=torch.long, device=dev)
    tokens[:, :prompt_len] = init_t
    cross = precompute_cross_kv(model, xa)
    cache = KVCache.zeros(config, rows, total_len,
                          model.decoder.tok_emb.dtype, dev)
    prefill, cache = decode_step(
        model, init_t[None, :].expand(rows, prompt_len), 0, cache, cross)
    sot_pos = prompt_len - (3 if options.with_timestamps else 4)
    return tokens, prompt_len, cross, cache, prefill[:, -1], \
        prefill[:, sot_pos]


def decode_greedy(
    model: Whisper,
    xa: torch.Tensor,                    # (B, T_audio, d) encoder states
    options: DecodeOptions = DecodeOptions(),
    prompt: Sequence[int] = (),
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[Callable[[int], torch.Tensor]] = None,
    stop_at: Optional[int] = None,
) -> DecodeResult:
    """Greedy (temperature 0) or sampled batched decode of encoded audio.

    At temperature > 0 the noise for step i is ``gumbel(i)`` when given,
    otherwise a draw from ``generator`` (on xa's device). ``stop_at``
    (profiling only) ends the loop after that many steps while the self
    cache and token buffer stay sized for ``max_new_tokens``, so two step
    budgets run on the same allocation.
    """
    _check_options(options)
    config = model.config
    b = xa.shape[0]
    dev = xa.device
    tokens, prompt_len, cross, cache, cur_logits, sot_logits = _prefill(
        model, xa, options, prompt, b)
    max_new = options.max_new_tokens
    static_mask = torch.as_tensor(_static_suppress_mask(config, options),
                                  device=dev)
    no_speech_prob = torch.softmax(sot_logits, dim=-1)[:, config.no_speech]
    sample = temperature > 0.0 and not options.assume_greedy
    if sample and gumbel is None and generator is None:
        raise ValueError("sampling at temperature > 0 needs a generator "
                         "or a gumbel callable")

    sum_lp = torch.zeros((b,), device=dev)
    length = torch.zeros((b,), dtype=torch.long, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    rules = _Rules(
        step=0, tokens=tokens,
        last_was_ts=torch.zeros((b,), dtype=torch.bool, device=dev),
        # a 1-token sequence counts as penultimate-timestamp
        penult_was_ts=torch.ones((b,), dtype=torch.bool, device=dev),
        max_ts=torch.full((b,), config.timestamp_begin, dtype=torch.long,
                          device=dev),
        seen=torch.zeros((b, config.n_vocab), dtype=torch.bool,
                         device=dev))

    steps = max_new if stop_at is None else min(stop_at, max_new)
    step = 0
    while step < steps and not bool(finished.all()):
        rules.step = step
        logits = _apply_logit_rules(cur_logits, rules, config, options,
                                    static_mask, prompt_len)
        if sample:
            noise = (gumbel(step) if gumbel is not None
                     else _draw_gumbel(generator, logits.shape, dev))
            token = torch.argmax(logits + temperature * noise, dim=-1)
        else:
            token = torch.argmax(logits, dim=-1)
        token = torch.where(finished, config.eot, token)

        lp = torch.log_softmax(logits, dim=-1)
        tok_lp = lp.gather(1, token[:, None])[:, 0]
        sum_lp = sum_lp + torch.where(finished, 0.0, tok_lp)
        is_eot = token == config.eot
        length = length + (~(finished | is_eot)).long()
        pos = prompt_len + step
        tokens[:, pos] = token
        is_ts = token >= config.timestamp_begin
        rules.max_ts = torch.where(is_ts, torch.maximum(rules.max_ts, token),
                                   rules.max_ts)
        if options.repetition_penalty != 1.0:
            rules.seen.scatter_(1, token[:, None], True)
        rules.last_was_ts, rules.penult_was_ts = (
            torch.where(finished, rules.last_was_ts, is_ts),
            torch.where(finished, rules.penult_was_ts, rules.last_was_ts))
        finished = finished | is_eot

        next_logits, cache = decode_step(model, token[:, None], pos, cache,
                                         cross)
        cur_logits = next_logits[:, 0]
        step += 1

    return _finalize(tokens, prompt_len, max_new, length, sum_lp,
                     no_speech_prob, config.eot)


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def _length_norm(length: torch.Tensor, alpha: float) -> torch.Tensor:
    """GNMT length penalty ((5+len)/6)^alpha."""
    return torch.pow((5.0 + length.float()) / 6.0, alpha)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, ties to the lower index (as
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def decode_beam(
    model: Whisper,
    xa: torch.Tensor,
    options: DecodeOptions = DecodeOptions(beam_size=2),
    prompt: Sequence[int] = (),
) -> DecodeResult:
    """Patience-aware batched beam search (Kasai et al. 2020 /
    CTranslate2), beams in the batch dimension (B*k rows).

    Live beams never freeze: a candidate ending in EOT moves to a per-row
    pool of ceil(k * patience) finished hypotheses and its slot takes the
    next-best live continuation. The loop stops when every row's pool is
    full or at max_new_tokens; the winner is the best length-normalized
    pooled hypothesis, or the best live beam for a row that never
    finished. All k beams of a row share one cross-K/V row (folded in
    ``cross_attention``).
    """
    k = options.beam_size
    if k <= 1:
        return decode_greedy(model, xa, options, prompt)
    _check_options(options)
    config = model.config
    b = xa.shape[0]
    bk = b * k
    v = config.n_vocab
    dev = xa.device
    max_new = options.max_new_tokens
    n_fin = max(k, int(math.ceil(k * options.patience)))
    tokens, prompt_len, cross, cache, cur_logits, sot_logits = _prefill(
        model, xa, options, prompt, bk)
    total_len = tokens.shape[1]
    static_mask = torch.as_tensor(_static_suppress_mask(config, options),
                                  device=dev)
    no_speech_prob = torch.softmax(
        sot_logits.reshape(b, k, v)[:, 0], dim=-1)[:, config.no_speech]

    # symmetry breaking: only beam 0 is live initially
    cum_lp = torch.tensor([0.0] + [-1e30] * (k - 1),
                          device=dev).repeat(b, 1)
    length = torch.zeros((bk,), dtype=torch.long, device=dev)
    rules = _Rules(
        step=0, tokens=tokens,
        last_was_ts=torch.zeros((bk,), dtype=torch.bool, device=dev),
        penult_was_ts=torch.ones((bk,), dtype=torch.bool, device=dev),
        max_ts=torch.full((bk,), config.timestamp_begin, dtype=torch.long,
                          device=dev),
        seen=torch.zeros((bk, v), dtype=torch.bool, device=dev))
    pool_tokens = torch.zeros((b, n_fin, total_len), dtype=torch.long,
                              device=dev)
    pool_score = torch.full((b, n_fin), _NEG, device=dev)
    pool_sum_lp = torch.zeros((b, n_fin), device=dev)
    pool_len = torch.zeros((b, n_fin), dtype=torch.long, device=dev)
    row_base = (torch.arange(b, device=dev) * k)[:, None]

    step = 0
    while step < max_new and not bool((pool_score > -1e29).all()):
        rules.step = step
        logits = _apply_logit_rules(cur_logits, rules, config, options,
                                    static_mask, prompt_len)
        lp = torch.log_softmax(logits, dim=-1)                 # (B*k, V)
        total = cum_lp.reshape(bk, 1) + lp

        # top 2k candidates per row: each source beam gives at most one
        # EOT candidate, so at least k of them are live continuations
        scores2k, flat_idx = _top_k(total.reshape(b, k * v), 2 * k)
        beam_src = flat_idx // v                               # (B, 2k)
        token2k = flat_idx % v
        is_eot = token2k == config.eot
        pos = prompt_len + step

        # finished candidates -> pool (length-normalized insertion)
        src_len = length.reshape(b, k).gather(1, beam_src)     # (B, 2k)
        cand_norm = scores2k / _length_norm(src_len, options.length_penalty)
        cand_norm = torch.where(is_eot, cand_norm, _NEG)
        cand_tokens = rules.tokens[(row_base + beam_src).reshape(-1)] \
            .reshape(b, 2 * k, total_len)
        cand_tokens[:, :, pos] = config.eot
        all_scores = torch.cat([pool_score, cand_norm], dim=1)
        all_tokens = torch.cat([pool_tokens, cand_tokens], dim=1)
        all_sum = torch.cat([pool_sum_lp, scores2k], dim=1)
        all_len = torch.cat([pool_len, src_len], dim=1)
        pool_score, top_idx = _top_k(all_scores, n_fin)
        pool_tokens = all_tokens.gather(
            1, top_idx[..., None].expand(b, n_fin, total_len))
        pool_sum_lp = all_sum.gather(1, top_idx)
        pool_len = all_len.gather(1, top_idx)

        # live continuations: the best k non-EOT candidates
        live_scores = torch.where(is_eot, _NEG, scores2k)
        cum_lp, sel = _top_k(live_scores, k)                   # (B, k)
        live_src = beam_src.gather(1, sel)
        live_tok = token2k.gather(1, sel)

        gidx = (row_base + live_src).reshape(bk)
        tokens = rules.tokens[gidx]
        cache = KVCache(cache.k[:, gidx], cache.v[:, gidx])
        length = length[gidx] + 1
        last_was_ts = rules.last_was_ts[gidx]
        max_ts = rules.max_ts[gidx]

        tok_flat = live_tok.reshape(bk)
        tokens[:, pos] = tok_flat
        is_ts = tok_flat >= config.timestamp_begin
        seen = rules.seen[gidx]
        if options.repetition_penalty != 1.0:
            seen.scatter_(1, tok_flat[:, None], True)
        rules = _Rules(
            step=step + 1, tokens=tokens, last_was_ts=is_ts,
            penult_was_ts=last_was_ts,
            max_ts=torch.where(is_ts, torch.maximum(max_ts, tok_flat),
                               max_ts),
            seen=seen)

        next_logits, cache = decode_step(model, tok_flat[:, None], pos,
                                         cache, cross)
        cur_logits = next_logits[:, 0]
        step += 1

    # winner: best pooled hypothesis, else the best live beam
    best_pool = pool_score.argmax(dim=1)                       # (B,)
    pool_has = (pool_score > -1e29).any(dim=1)
    pool_tok = pool_tokens[torch.arange(b, device=dev), best_pool]
    pool_sum = pool_sum_lp.gather(1, best_pool[:, None])[:, 0]
    pool_l = pool_len.gather(1, best_pool[:, None])[:, 0]

    live_norm = cum_lp / _length_norm(length.reshape(b, k),
                                      options.length_penalty)
    sel = torch.arange(b, device=dev) * k + live_norm.argmax(dim=1)
    live_tok = rules.tokens[sel]
    live_sum = cum_lp.reshape(bk)[sel]
    live_len = length[sel]

    tokens = torch.where(pool_has[:, None], pool_tok, live_tok)
    sum_lp = torch.where(pool_has, pool_sum, live_sum)
    length = torch.where(pool_has, pool_l, live_len)
    return _finalize(tokens, prompt_len, max_new, length, sum_lp,
                     no_speech_prob, config.eot)


# ---------------------------------------------------------------------------
# host-side segment extraction
# ---------------------------------------------------------------------------

@dataclass
class DecodedSegment:
    start: float           # seconds, relative to window start
    end: float
    tokens: list
    text: str = ""
    avg_logprob: float = 0.0
    no_speech_prob: float = 0.0


def extract_segments(
    token_ids: np.ndarray,
    config: WhisperConfig,
    options: DecodeOptions,
    window_duration: float,
    avg_logprob: float = 0.0,
    no_speech_prob: float = 0.0,
) -> list:
    """Split one row of generated ids into timestamped segments.

    Token stream shape: ``<|t0|> text <|t1|> <|t2|> text <|t3|> ... eot``.
    A trailing open segment is clamped to the window duration.
    """
    ts_begin = config.timestamp_begin
    prec = options.ts_precision
    segments: list = []
    cur_tokens: list = []
    cur_start: Optional[float] = None
    for tid in (int(t) for t in token_ids):
        if tid == config.eot:
            break
        if tid >= ts_begin:
            t = (tid - ts_begin) * prec
            if cur_start is None:
                cur_start = t
            elif cur_tokens:
                segments.append(DecodedSegment(
                    start=cur_start, end=min(t, window_duration),
                    tokens=cur_tokens, avg_logprob=avg_logprob,
                    no_speech_prob=no_speech_prob))
                cur_tokens = []
                cur_start = None
        else:
            if cur_start is None:
                cur_start = 0.0
            cur_tokens.append(tid)
    if cur_tokens:
        segments.append(DecodedSegment(
            start=cur_start or 0.0, end=window_duration,
            tokens=cur_tokens, avg_logprob=avg_logprob,
            no_speech_prob=no_speech_prob))
    return segments
