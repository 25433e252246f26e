"""Autoregressive decoding: greedy / temperature-sampled, plus language ID.

The port of the JAX package's decoding/generate.py greedy path. The decode
loop runs on the host in Python (PyTorch is eager); each step is one
decoder call and a few vectorised filter ops on the device, and the loop
stops once every row has emitted end-of-text.

Whisper's logit rules are those of the JAX package (openai/whisper's
SuppressBlank / SuppressTokens / ApplyTimestampRules): blank suppression at
the first sampled position, a static suppress mask, and the timestamp
grammar tracked with O(1) per-row state (last / penultimate / max
timestamp).

``greedy_decode(..., fused=True)`` runs the steps through the decoder-layer
kernels (ops/decode_layers.py) with the decoder weights packed to int8;
the prompt prefill stays on ``decoder_step`` with the loaded weights, as on
the TPU. Sampling draws Gumbel noise from an explicit ``torch.Generator``,
so sampled rungs are reproducible from their seed but do not reproduce
JAX's random bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from whisper_aries_tpu_torch.models import whisper as W
from whisper_aries_tpu_torch.ops import decode_layers as DL

NEG_INF = float(np.finfo(np.float32).min)


@dataclass(frozen=True)
class DecodeSpecialIds:
    """Token ids the decode loop needs (see tokenizer.SpecialTokens)."""

    eot: int
    sot: int
    no_speech: int
    no_timestamps: int
    timestamp_begin: int
    blank: int  # id of the encoded " " token
    n_vocab: int
    max_initial_timestamp_index: int = 50  # 1.0 s / 0.02

    @classmethod
    def from_tokenizer(cls, tokenizer) -> "DecodeSpecialIds":
        sp = tokenizer.specials
        blank_ids = tokenizer.encode(" ")
        return cls(
            eot=sp.eot, sot=sp.sot, no_speech=sp.no_speech,
            no_timestamps=sp.no_timestamps, timestamp_begin=sp.timestamp_begin,
            blank=blank_ids[0] if blank_ids else 0, n_vocab=sp.n_vocab,
        )


def build_suppress_mask(n_vocab: int, suppress_ids: Sequence[int]) -> np.ndarray:
    """(vocab,) additive mask: NEG_INF at suppressed ids, 0 elsewhere."""
    mask = np.zeros((n_vocab,), np.float32)
    ids = [i for i in suppress_ids if 0 <= i < n_vocab]
    mask[ids] = NEG_INF
    return mask


def apply_repetition_penalty(logits: torch.Tensor, present: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """CTranslate2/HF repetition penalty: logits of previously produced
    tokens are divided by the penalty when positive, multiplied when
    negative."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(present, penalized, logits)


def ngram_banned_mask(tokens: torch.Tensor, pos: int, n: int,
                      n_vocab: int) -> torch.Tensor:
    """(R, V) bool mask of tokens that would complete an n-gram already seen
    in ``tokens`` before ``pos`` (CTranslate2's no_repeat_ngram_size)."""
    R, L = tokens.shape
    n_ctx = n - 1
    banned = torch.zeros((R, n_vocab), dtype=torch.bool, device=tokens.device)
    if pos < n_ctx:
        return banned
    ctx = tokens[:, pos - n_ctx:pos]                        # (R, n-1)
    n_pos = L - n + 1
    idx = (torch.arange(n_pos, device=tokens.device)[:, None]
           + torch.arange(n_ctx, device=tokens.device)[None, :])
    hist = tokens[:, idx]                                   # (R, n_pos, n-1)
    ends = torch.arange(n_pos, device=tokens.device) + n_ctx
    match = (hist == ctx[:, None, :]).all(dim=-1) & (ends[None, :] < pos)
    follow = tokens[:, n_ctx:]                              # (R, n_pos)
    counts = torch.zeros((R, n_vocab), dtype=torch.int32, device=tokens.device)
    counts.scatter_add_(1, follow.long(), match.to(torch.int32))
    return counts > 0


def _apply_filters(logits: torch.Tensor, ids: DecodeSpecialIds,
                   suppress_mask: torch.Tensor, is_first: bool,
                   last_tok: torch.Tensor, penult_tok: torch.Tensor,
                   max_ts_tok: torch.Tensor, with_timestamps: bool
                   ) -> torch.Tensor:
    V = logits.shape[-1]
    vocab_idx = torch.arange(V, device=logits.device)[None, :]
    logits = logits + suppress_mask[None, :]
    logits = torch.where(vocab_idx == ids.no_timestamps, NEG_INF, logits)
    if is_first:  # SuppressBlank: no " " or eot as the first token
        blank = (vocab_idx == ids.blank) | (vocab_idx == ids.eot)
        logits = torch.where(blank, NEG_INF, logits)
    if not with_timestamps:
        return torch.where(vocab_idx >= ids.timestamp_begin, NEG_INF, logits)

    tsb = ids.timestamp_begin
    last_was_ts = last_tok >= tsb
    penult_was_ts = penult_tok >= tsb
    ts_region = vocab_idx >= tsb
    text_region = vocab_idx < ids.eot
    # after a timestamp pair -> text required; after a single timestamp ->
    # text forbidden (close the pair or end)
    suppress_ts = (last_was_ts & penult_was_ts)[:, None]
    suppress_text = (last_was_ts & ~penult_was_ts)[:, None]
    logits = torch.where(suppress_ts & ts_region, NEG_INF, logits)
    logits = torch.where(suppress_text & text_region, NEG_INF, logits)
    # monotonic timestamps: forbid < max so far (<= max once the pair closed)
    has_ts = (max_ts_tok >= tsb)[:, None]
    floor = torch.where(last_was_ts & ~penult_was_ts, max_ts_tok,
                        max_ts_tok + 1)[:, None]
    logits = torch.where(ts_region & (vocab_idx < floor) & has_ts, NEG_INF,
                         logits)
    if is_first:  # must open with a timestamp, capped at the initial max
        init_cap = tsb + ids.max_initial_timestamp_index
        logits = torch.where((vocab_idx < tsb) | (vocab_idx > init_cap),
                             NEG_INF, logits)
    # force a timestamp when the total timestamp probability beats every
    # text token (shift-invariant, so compared on raw logits)
    ts_lp = torch.logsumexp(torch.where(ts_region, logits, NEG_INF), dim=-1)
    max_text = torch.where(ts_region, NEG_INF, logits).amax(dim=-1)
    force = (ts_lp > max_text)[:, None]
    return torch.where(force & ~ts_region, NEG_INF, logits)


def _pack_fused_cache(cache: Dict[str, torch.Tensor], int8: bool
                      ) -> Dict[str, torch.Tensor]:
    """decoder_step's bf16 prefill cache -> the decoder-layer kernels'
    cache (int8: quantized per (row, head) over dh, scales not folding
    1/sqrt(dh); positions never written quantize with scale 1)."""
    if not int8:
        return cache
    q8, sc = DL.quantize_heads(cache["kv"])
    return {"kv8": q8, "ksc": sc}


def greedy_decode(
    params: Dict[str, Any],
    xa: torch.Tensor,
    prompt: torch.Tensor,
    dims: W.WhisperDims,
    ids: DecodeSpecialIds,
    suppress_mask: torch.Tensor,
    sot_index: int,
    temperature: float,
    generator: Optional[torch.Generator] = None,
    sample_len: int = 224,
    with_timestamps: bool = True,
    kv_int8: bool = False,
    self_kv_int8: bool = False,
    repetition_penalty: Optional[float] = None,
    no_repeat_ngram_size: int = 0,
    fused: bool = False,
    wpack: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Batched greedy / sampled decode with a KV cache.

    xa (B, Ta, D) encoded audio, prompt (B, P) int (the sot sequence; the
    left-padded prompts of conditioned decoding come with that slice).
    ``kv_int8`` stores the cross
    K/V as int8 with per-position scales. ``fused=True`` (needs ``kv_int8``)
    runs the steps through the decoder-layer kernels with int8-packed
    weights (``wpack``, from ``DL.pack_layer_weights``; packed here when not
    given); ``self_kv_int8`` then makes the kernels quantize appended K/V.
    Without ``fused``, ``self_kv_int8`` selects decoder_step's int8 cache.

    Returns tokens (B, P+sample_len), n_sampled, sum_logprob, avg_logprob,
    no_speech_prob (B,), and steps (the number of tokens sampled per row,
    including the one from the prefill).
    """
    if fused and not kv_int8:
        raise ValueError("fused decode steps read the int8 cross K/V")
    B, P = prompt.shape
    L = P + sample_len
    dev = xa.device
    cross = (W.precompute_cross_kv_int8(params, xa, dims) if kv_int8
             else W.precompute_cross_kv(params, xa, dims))
    cache = W.init_kv_cache(dims, B, dtype=xa.dtype, max_len=L,
                            int8=self_kv_int8 and not fused, device=dev)
    logits_p = W.decoder_step(params, prompt, 0, cache, cross, dims)
    if fused:
        cache = _pack_fused_cache(cache, self_kv_int8)
        if wpack is None:
            wpack = DL.pack_layer_weights(
                W.fuse_decoder_qkv(params)["decoder"]["blocks"])
    # no-speech probability at the sot position's output
    no_speech_prob = torch.softmax(logits_p[:, sot_index], dim=-1)[:, ids.no_speech]

    tokens = torch.full((B, L), ids.eot, dtype=torch.long, device=dev)
    tokens[:, :P] = prompt
    sum_logprob = torch.zeros((B,), dtype=torch.float32, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    last_tok = prompt[:, -1].long()
    penult_tok = torch.full((B,), -1, dtype=torch.long, device=dev)
    max_ts_tok = torch.full((B,), -1, dtype=torch.long, device=dev)
    present = (torch.zeros((B, ids.n_vocab), dtype=torch.bool, device=dev)
               if repetition_penalty is not None else None)
    rows = torch.arange(B, device=dev)
    dec = params["decoder"]

    logits = logits_p[:, -1]  # predicts the first sampled token
    pos = P
    while True:
        if present is not None:
            logits = apply_repetition_penalty(logits, present,
                                              repetition_penalty)
        if no_repeat_ngram_size >= 2:
            banned = ngram_banned_mask(tokens, pos, no_repeat_ngram_size,
                                       ids.n_vocab)
            logits = torch.where(banned, NEG_INF, logits)
        f = _apply_filters(logits, ids, suppress_mask, pos == P, last_tok,
                           penult_tok, max_ts_tok, with_timestamps)
        logprobs = torch.log_softmax(f, dim=-1)
        if temperature > 0:
            u = torch.rand(f.shape, generator=generator, device=dev)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            next_tok = torch.argmax(f / max(temperature, 1e-6) + gumbel, dim=-1)
        else:
            next_tok = torch.argmax(f, dim=-1)
        next_tok = torch.where(finished, ids.eot, next_tok)
        tok_lp = logprobs[rows, next_tok]
        sum_logprob = sum_logprob + torch.where(finished, 0.0, tok_lp)
        if present is not None:
            present[rows, next_tok] |= ~finished
        finished = finished | (next_tok == ids.eot)
        tokens[:, pos] = next_tok
        is_ts = next_tok >= ids.timestamp_begin
        max_ts_tok = torch.where(is_ts, torch.maximum(max_ts_tok, next_tok),
                                 max_ts_tok)
        penult_tok, last_tok = last_tok, next_tok
        pos += 1
        if pos >= L or bool(finished.all()):
            break
        tok_in = tokens[:, pos - 1:pos]
        if fused:
            x = (dec["tok_emb"][tok_in[:, 0]]
                 + dec["pos_emb"][min(pos - 1, dims.n_text_ctx - 1)])
            x = DL.fused_decoder_layers(x, wpack, cache, cross, 0, pos - 1,
                                        dims.n_text_head)
            logits = W.vocab_logits(dec, x)
        else:
            logits = W.decoder_step(params, tok_in, pos - 1, cache, cross,
                                    dims)[:, 0]

    n_sampled = (tokens[:, P:] != ids.eot).sum(dim=1)
    avg_logprob = sum_logprob / (n_sampled.float() + 1.0)
    return {
        "tokens": tokens,
        "n_sampled": n_sampled,
        "sum_logprob": sum_logprob,
        "avg_logprob": avg_logprob,
        "no_speech_prob": no_speech_prob,
        "steps": torch.tensor(pos - P),
    }


# ---------------------------------------------------------------------------
# Language identification
# ---------------------------------------------------------------------------


def detect_language_batched(params: Dict[str, Any], xa: torch.Tensor,
                            dims: W.WhisperDims, sot: int, lang0: int,
                            n_lang: int) -> torch.Tensor:
    """(B, n_lang) language probabilities for every window, from the
    teacher-forced decoder on the single <|sot|> token."""
    prompt = torch.full((xa.shape[0], 1), sot, dtype=torch.long,
                        device=xa.device)
    logits = W.decoder_forward(params, prompt, xa, dims)
    return torch.softmax(logits[:, 0, lang0:lang0 + n_lang], dim=-1)


def detect_language_logits(params: Dict[str, Any], xa: torch.Tensor,
                           dims: W.WhisperDims, sot: int, lang0: int,
                           n_lang: int) -> torch.Tensor:
    """(B, n_lang) language probabilities from a single cached decode step
    on <|sot|> (faster-whisper's detection from the first window)."""
    B = xa.shape[0]
    cross = W.precompute_cross_kv(params, xa, dims)
    cache = W.init_kv_cache(dims, B, dtype=xa.dtype, max_len=4,
                            device=xa.device)
    prompt = torch.full((B, 1), sot, dtype=torch.long, device=xa.device)
    logits = W.decoder_step(params, prompt, 0, cache, cross, dims)
    return torch.softmax(logits[:, 0, lang0:lang0 + n_lang], dim=-1)
