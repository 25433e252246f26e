"""Autoregressive decoding: greedy / temperature-sampled and beam search,
plus language ID.

The port of the JAX package's decoding/generate.py greedy and beam paths.
The decode loop runs on the host in Python (PyTorch is eager); each step is
one decoder call and a few vectorised ops on the device, and the loop stops
once every row has emitted end-of-text (greedy) or every window's finished
buffer is full (beam).

Whisper's logit rules are those of the JAX package
(decoding/logit_filters.py).

``fused=True`` runs the steps through the decoder-layer kernels
(ops/decode_layers.py) with the decoder weights packed to int8; the prompt
prefill stays on ``decoder_step`` with the loaded weights, as on the TPU.
On the card each decode call captures its step once as a CUDA graph and
replays it every step: the fused layers (``DL.DecodeStepGraph``) or the
whole unfused ``decoder_step`` (``W.UnfusedStepGraph``); the graph dies
with the call.
Rows are window-major over the encoded windows ``xa``: several rows of a
window (best_of samples, beams) share its cross K/V through the grouped
cross-attention. Sampling draws Gumbel noise from an explicit
``torch.Generator``, so sampled rungs are reproducible from their seed but
do not reproduce JAX's random bits.

Beam search (``beam_search_decode``) has one path: its tail (filters,
log_softmax, scores, top-K) is the beam-tail kernel (ops/beam_tail.py) and
its cache reorder the reorder kernel (ops/beam_reorder.py) on the card,
their plain versions on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from whisper_aries_tpu_torch.models import whisper as W
from whisper_aries_tpu_torch.ops import decode_layers as DL
from whisper_aries_tpu_torch.decoding.logit_filters import (
    NEG_INF,
    apply_filters,
)
from whisper_aries_tpu_torch.ops.beam_reorder import permute_cache_rows
from whisper_aries_tpu_torch.ops.beam_tail import beam_tail


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


def _pack_fused_cache(cache: Dict[str, torch.Tensor], int8: bool
                      ) -> Dict[str, torch.Tensor]:
    """decoder_step's bf16 prefill cache -> the decoder-layer kernels'
    cache (int8: quantized per (row, head) over dh, scales not folding
    1/sqrt(dh); positions never written quantize with scale 1)."""
    if not int8:
        return cache
    q8, sc = DL.quantize_heads(cache["kv"])
    return {"kv8": q8, "ksc": sc}


def _prefill(params, xa, prompt, dims, kv_int8, self_kv_int8, fused,
             wpack, max_len, prompt_start=0):
    """Cross K/V for the windows of ``xa``, the self cache of the prompt's
    rows and the prompt's logits (a left-padded prompt's first real token
    at ``prompt_start``). With ``fused`` the cache is repacked for the
    decoder-layer kernels and the weights are packed (when not given)."""
    if fused and not kv_int8:
        raise ValueError("fused decode steps read the int8 cross K/V")
    cross = (W.precompute_cross_kv_int8(params, xa, dims) if kv_int8
             else W.precompute_cross_kv(params, xa, dims))
    cache = W.init_kv_cache(dims, prompt.shape[0], dtype=xa.dtype,
                            max_len=max_len, int8=self_kv_int8 and not fused,
                            device=xa.device)
    logits_p = W.decoder_step(params, prompt, 0, cache, cross, dims,
                              prompt_start)
    if fused:
        cache = _pack_fused_cache(cache, self_kv_int8)
        if wpack is None:
            wpack = DL.pack_layer_weights(
                W.fuse_decoder_qkv(params)["decoder"]["blocks"])
    return cross, cache, logits_p, wpack


def _step_graph(fused, wpack, cache, cross, dims, rows, params=None,
                valid_start=0):
    """The decode step captured as one CUDA graph for this decode call (the
    cache final: later updates are in place): the fused layers
    (``DL.DecodeStepGraph``) or the whole unfused ``decoder_step`` on
    ``params`` (``W.UnfusedStepGraph``); None off the card. The caller
    drops it with the call."""
    if fused:
        if not wpack["wq8"].is_cuda:
            return None
        return DL.DecodeStepGraph(wpack, cache, cross, rows, dims.n_text_head,
                                  valid_start)
    if not any(v.is_cuda for v in cache.values()):
        return None
    return W.UnfusedStepGraph(params, cache, cross, dims, rows, valid_start)


def _step_logits(params, dims, tok, pos, cache, cross, fused, wpack,
                 graph=None, valid_start=0):
    """(R, V) f32 logits of one decode step on tokens ``tok`` (R,) written
    at cache position ``pos``, the positional embedding shifted by
    ``valid_start`` (the first real token of a left-padded prompt); the
    step replays ``graph`` when given."""
    if not fused:
        if graph is not None:
            return graph.run(tok, pos, valid_start)
        return W.decoder_step(params, tok[:, None], pos, cache, cross, dims,
                              valid_start)[:, 0]
    dec = params["decoder"]
    x = (dec["tok_emb"][tok]
         + dec["pos_emb"][min(max(pos - valid_start, 0), dims.n_text_ctx - 1)])
    if graph is not None:
        x = graph.run(x, pos, valid_start)
    else:
        x = DL.fused_decoder_layers(x, wpack, cache, cross, valid_start, pos,
                                    dims.n_text_head)
    return W.vocab_logits(dec, x)


def _no_speech_prob(logits_p, sot_index, ids):
    return torch.softmax(logits_p[:, sot_index], dim=-1)[:, ids.no_speech]


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
    prompt_start: int = 0,
) -> Dict[str, torch.Tensor]:
    """Batched greedy / sampled decode with a KV cache.

    xa (Bw, Ta, D) encoded audio, prompt (B, P) int with B = Bw * G rows,
    window-major: the G rows of a window (the fallback ladder's best_of
    samples) share its cross K/V. The prompt is the sot sequence, or a
    conditioned prompt left-padded with -1 to a fixed width whose first
    real token is at ``prompt_start`` (cache positions before it are
    masked and the positional embeddings shift by it, in the prefill and
    in every step).
    ``kv_int8`` stores the cross K/V as int8 with per-position scales.
    ``fused=True`` (needs ``kv_int8``) runs the steps through the
    decoder-layer kernels with int8-packed weights (``wpack``, from
    ``DL.pack_layer_weights``; packed here when not given); ``self_kv_int8``
    then makes the kernels quantize appended K/V. Without ``fused``,
    ``self_kv_int8`` selects decoder_step's int8 cache.

    Returns tokens (B, P+sample_len), n_sampled, sum_logprob, avg_logprob,
    no_speech_prob (B,), and steps (the number of tokens sampled per row,
    including the one from the prefill).
    """
    B, P = prompt.shape
    L = P + sample_len
    dev = xa.device
    cross, cache, logits_p, wpack = _prefill(params, xa, prompt, dims,
                                             kv_int8, self_kv_int8, fused,
                                             wpack, L, prompt_start)
    no_speech_prob = _no_speech_prob(logits_p, sot_index, ids)
    graph = _step_graph(fused, wpack, cache, cross, dims, B, params,
                        prompt_start)

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
        f = apply_filters(logits, ids, suppress_mask, pos == P, last_tok,
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
        logits = _step_logits(params, dims, tokens[:, pos - 1], pos - 1,
                              cache, cross, fused, wpack, graph,
                              prompt_start)

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
# Beam search
# ---------------------------------------------------------------------------


def beam_search_decode(
    params: Dict[str, Any],
    xa: torch.Tensor,
    prompt: torch.Tensor,
    dims: W.WhisperDims,
    ids: DecodeSpecialIds,
    suppress_mask: torch.Tensor,
    sot_index: int,
    beam_size: int = 5,
    sample_len: int = 224,
    with_timestamps: bool = True,
    length_penalty: float = 1.0,
    suppress_blank: bool = True,
    kv_int8: bool = False,
    self_kv_int8: bool = False,
    patience: float = 1.0,
    repetition_penalty: Optional[float] = None,
    no_repeat_ngram_size: int = 0,
    fused: bool = False,
    wpack: Optional[Dict[str, torch.Tensor]] = None,
    prompt_start: int = 0,
) -> Dict[str, torch.Tensor]:
    """Batched beam search, the K beams of each window flattened into the
    rows (window-major, R = B·K).

    openai-whisper / CTranslate2 semantics, as the JAX package's
    ``beam_search_decode``: each step expands the K live beams; eot
    candidates go to a finished-hypothesis buffer of capacity
    C = round(K·patience) when they outrank the K-th live candidate, and
    the K best non-eot candidates stay live, so finished hypotheses never
    hold a beam slot. The final choice maximises
    sum_logprob / length**length_penalty over the finished buffer (plus the
    live beams of windows whose buffer did not fill). Repetition penalty
    and n-gram bans apply per beam before the tail.

    The prompt is prefilled once per window (xa (B, Ta, D), prompt (B, P))
    and its cache copied to the window's K rows: every beam shares the
    prompt, so these are the values of a prefill on the K repeated prompts.
    A left-padded prompt's first real token is at ``prompt_start``, as in
    ``greedy_decode``.
    The beams share their window's cross K/V. On steps where a beam takes
    another beam's history the self cache is permuted in place; steps
    where every beam keeps its own are skipped.

    Returns tokens (B, P+sample_len), n_sampled, sum_logprob, avg_logprob,
    no_speech_prob (B,), all_tokens (B, C+K, L), all_scores (B, C+K),
    steps (expansions, the first from the prefill's logits) and permuted
    (steps that reordered the cache).
    """
    B, P = prompt.shape
    K = beam_size
    L = P + sample_len
    V = ids.n_vocab
    C = max(1, int(round(K * patience)))
    dev = xa.device
    cross, cache, logits_p, wpack = _prefill(params, xa, prompt, dims,
                                             kv_int8, self_kv_int8, fused,
                                             wpack, L, prompt_start)
    cache = {k: v.repeat_interleave(K, dim=1) for k, v in cache.items()}
    graph = _step_graph(fused, wpack, cache, cross, dims, B * K, params,
                        prompt_start)
    no_speech_prob = _no_speech_prob(logits_p, sot_index, ids)
    logits = logits_p[:, -1].repeat_interleave(K, dim=0)  # (B*K, V)
    del logits_p

    tokens = torch.full((B, K, L), ids.eot, dtype=torch.long, device=dev)
    tokens[:, :, :P] = prompt[:, None, :]
    # only beam 0 is live at first (no K duplicates)
    sum_logprob = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    sum_logprob[:, 0] = 0.0
    last_tok = prompt[:, -1:].long().expand(B, K).clone()
    penult_tok = torch.full((B, K), -1, dtype=torch.long, device=dev)
    max_ts_tok = torch.full((B, K), -1, dtype=torch.long, device=dev)
    # slot C takes the writes that do not fit (dropped at the end)
    fin_tokens = torch.full((B, C + 1, L), ids.eot, dtype=torch.long,
                            device=dev)
    fin_scores = torch.full((B, C + 1), NEG_INF, dtype=torch.float32,
                            device=dev)
    fin_count = torch.zeros((B,), dtype=torch.long, device=dev)
    present = (torch.zeros((B, K, V), dtype=torch.bool, device=dev)
               if repetition_penalty is not None else None)
    b_rows = torch.arange(B, device=dev)[:, None]
    k_rows = torch.arange(K, device=dev)[None, :]
    tsb = ids.timestamp_begin
    init_cap = tsb + ids.max_initial_timestamp_index

    pos, steps, permuted = P, 0, 0
    while True:
        if present is not None:
            logits = apply_repetition_penalty(
                logits, present.reshape(B * K, V), repetition_penalty)
        if no_repeat_ngram_size >= 2:
            banned = ngram_banned_mask(tokens.reshape(B * K, L), pos,
                                       no_repeat_ngram_size, V)
            logits = torch.where(banned, NEG_INF, logits)
        live_score, top_idx, eot_scores = beam_tail(
            logits, sum_logprob, last_tok, penult_tok, max_ts_tok,
            suppress_mask, pos == P, K, tsb, ids.eot, ids.blank,
            ids.no_timestamps, init_cap, with_timestamps, suppress_blank)
        live_src = top_idx // V
        next_tok = top_idx % V

        # eot candidates enter the finished buffer iff they outrank the
        # K-th live candidate (descending order, ties to the lower beam)
        eot_sorted, eot_order = torch.sort(eot_scores, dim=1,
                                           descending=True, stable=True)
        is_fin = ((eot_sorted > live_score[:, -1:])
                  & (eot_sorted > NEG_INF / 2)).long()
        slot = fin_count[:, None] + torch.cumsum(is_fin, dim=1) - is_fin
        write = (is_fin > 0) & (slot < C)
        slot_w = torch.where(write, slot, C)
        fin_tokens[b_rows, slot_w] = tokens[b_rows, eot_order]
        fin_scores[b_rows, slot_w] = eot_sorted
        fin_count = fin_count + write.sum(dim=1)

        tokens = tokens[b_rows, live_src]
        tokens[:, :, pos] = next_tok
        penult_tok = last_tok[b_rows, live_src]
        max_ts = max_ts_tok[b_rows, live_src]
        max_ts_tok = torch.where(next_tok >= tsb,
                                 torch.maximum(max_ts, next_tok), max_ts)
        if present is not None:
            present = present[b_rows, live_src]
            present[b_rows, k_rows, next_tok] = True
        last_tok, sum_logprob = next_tok, live_score
        pos += 1
        steps += 1
        full, identity = torch.stack([
            (fin_count >= C).all(), (live_src == k_rows).all()]).tolist()
        if full or pos >= L:
            break
        if not identity:
            permute_cache_rows(cache, live_src)
            permuted += 1
        logits = _step_logits(params, dims, tokens[:, :, pos - 1].reshape(-1),
                              pos - 1, cache, cross, fused, wpack, graph,
                              prompt_start)

    live_ok = (fin_count < C)[:, None]
    all_tokens = torch.cat([fin_tokens[:, :C], tokens], dim=1)
    all_sum = torch.cat([fin_scores[:, :C],
                         torch.where(live_ok, sum_logprob, NEG_INF)], dim=1)
    n_sampled = (all_tokens[:, :, P:] != ids.eot).sum(dim=2)
    final_score = all_sum / (n_sampled.float() + 1.0) ** length_penalty
    best = torch.argmax(final_score, dim=1)
    rows = torch.arange(B, device=dev)
    best_sum = all_sum[rows, best]
    best_n = n_sampled[rows, best]
    return {
        "tokens": all_tokens[rows, best],
        "n_sampled": best_n,
        "sum_logprob": best_sum,
        "avg_logprob": best_sum / (best_n.float() + 1.0),
        "no_speech_prob": no_speech_prob,
        "all_tokens": all_tokens,
        "all_scores": final_score,
        "steps": torch.tensor(steps),
        "permuted": torch.tensor(permuted),
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
