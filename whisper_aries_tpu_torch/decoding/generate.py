"""Autoregressive decoding: greedy / temperature-sampled and beam search,
plus language ID.

The port of the JAX package's decoding/generate.py greedy and beam paths,
and of its structure: a decode call is a prefill, then one loop whose
state (``LoopState``, ``BeamState``) is a set of static device buffers,
``pos`` among them. The first sampled token comes from the prefill's
logits, outside the loop, as in JAX; then each iteration runs one decoder
step at ``pos - 1`` (its vocab product ``W.vocab_logits_step``: the
vocab kernel on the card) and the body (``greedy_body``: the penalties,
then the choice kernel of ops/decode_choice.py: filters, log_softmax, the
token choice, the bookkeeping; ``beam_body``: the beam tail kernel,
the finished buffer, the beams' gathers), which update the buffers in
place and read ``pos`` only as a device tensor. The loop stops at JAX's
``cond``: every row has emitted end-of-text (greedy) or every window's
finished buffer is full (beam), or ``pos`` reached the buffer's end.

On the card the loop is one CUDA graph (ops/decode_loop.py): a WHILE node
whose body is the iteration captured once, so a decode call makes no host
read between its prefill and its final fetch (the counterpart of
``lax.while_loop``). Off the card the same bodies run in a Python
``while`` whose condition is read on the host: the loop's plain version.
Every read of device data inside a loop goes through one counted helper
(``_Reads``); a call returns the count as ``host_reads`` (0 on the card).

Whisper's logit rules are those of the JAX package
(decoding/logit_filters.py).

``fused=True`` runs the steps through the decoder-layer kernels
(ops/decode_layers.py, ``DL.FusedStep``) with the decoder weights packed
to int8; the prompt prefill stays on ``decoder_step`` with the loaded
weights, as on the TPU. Without it each step is the whole unfused
``decoder_step`` at a device position. Rows are window-major over the
encoded windows ``xa``: several rows of a window (best_of samples, beams)
share its cross K/V through the grouped cross-attention. A sampled rung
draws its Gumbel noise from a counter-based hash of (the generator's
seed, row, position, vocab index) (``decode_loop.uniform_draw``'s bits,
computed inside the choice kernel on the card), so it is reproducible
from its seed but does not reproduce JAX's random bits.

Beam search (``beam_search_decode``) has one path: its tail (filters,
log_softmax, scores, top-K) is the beam-tail kernel (ops/beam_tail.py) and
its cache reorder the reorder kernel (ops/beam_reorder.py) on the card,
launched at every step and returning at once for a window whose beams all
keep their own history; their plain versions on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from whisper_aries_tpu_torch.models import whisper as W
from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.ops import decode_choice as DC
from whisper_aries_tpu_torch.ops import decode_layers as DL
from whisper_aries_tpu_torch.ops import decode_loop as DLP
from whisper_aries_tpu_torch.decoding.logit_filters import (  # noqa: F401
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


def ngram_banned_mask(tokens: torch.Tensor, pos, n: int,
                      n_vocab: int) -> torch.Tensor:
    """(R, V) bool mask of tokens that would complete an n-gram already seen
    in ``tokens`` before ``pos`` (CTranslate2's no_repeat_ngram_size).
    ``pos`` is an int or a 0-d integer tensor on the tokens' device: the
    context is gathered at it and nothing is read back to the host."""
    R, L = tokens.shape
    dev = tokens.device
    n_ctx = n - 1
    pos = torch.as_tensor(pos, device=dev).long()
    ctx_idx = (pos - n_ctx + torch.arange(n_ctx, device=dev)).clamp(min=0)
    ctx = tokens.gather(1, ctx_idx.expand(R, n_ctx))        # (R, n-1)
    n_pos = L - n + 1
    idx = (torch.arange(n_pos, device=dev)[:, None]
           + torch.arange(n_ctx, device=dev)[None, :])
    hist = tokens[:, idx]                                   # (R, n_pos, n-1)
    ends = torch.arange(n_pos, device=dev) + n_ctx
    # an n-gram ending before pos (none while pos < n - 1)
    match = ((hist == ctx[:, None, :]).all(dim=-1) & (ends[None, :] < pos)
             & (pos >= n_ctx))
    follow = tokens[:, n_ctx:].long()                       # (R, n_pos)
    # a left-padded prompt's -1 wraps to the last id, as JAX's index does
    # (those n-grams never match: the context ends in a real token)
    follow = torch.where(follow < 0, follow + n_vocab, follow)
    counts = torch.zeros((R, n_vocab), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, follow, match.to(torch.int32))
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
             wpack, max_len, prompt_start, sot_index):
    """Cross K/V for the windows of ``xa``, the self cache of the prompt's
    rows and the logits (B, 2, V) of two prompt positions, the sot's (the
    no-speech probability) and the last (the first sampled token): the
    only ones read, so the vocab product runs on 2 B rows, not B P (a
    left-padded prompt's first real token at ``prompt_start``). With
    ``fused`` the cache is repacked for the decoder-layer kernels and the
    weights are packed (when not given)."""
    if fused and not kv_int8:
        raise ValueError("fused decode steps read the int8 cross K/V")
    cross = (W.precompute_cross_kv_int8(params, xa, dims) if kv_int8
             else W.precompute_cross_kv(params, xa, dims))
    cache = W.init_kv_cache(dims, prompt.shape[0], dtype=xa.dtype,
                            max_len=max_len, int8=self_kv_int8 and not fused,
                            device=xa.device)
    logits_p = W.decoder_step(params, prompt, 0, cache, cross, dims,
                              prompt_start,
                              logits_at=(sot_index, prompt.shape[1] - 1))
    if fused:
        cache = _pack_fused_cache(cache, self_kv_int8)
        if wpack is None:
            wpack = DL.pack_layer_weights(
                W.fuse_decoder_qkv(params)["decoder"]["blocks"])
    return cross, cache, logits_p, wpack


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
    return W.vocab_logits_step(dec, x)


class _Step:
    """The decoder step of one decode call on its fixed operands: the
    logits (R, V) f32 of tokens (R,) written at one cache position.
    ``eager`` takes the position on the host (direct launches, or the
    plain versions on the CPU: the host loop's step); ``device`` reads it
    from a 0-d int32 on the card, for the loop graph's capture, after
    ``prepare()`` (the fused step's static buffers, or the unfused step's
    warm-up: library loads, plans and kernel attributes, outside any
    capture, at the cache's last position, which no decode step reads
    before writing it). Positions are checked once, at ``prepare``."""

    def __init__(self, params, dims, cache, cross, fused, wpack, rows, L,
                 valid_start=0):
        self.params, self.dims, self.cache, self.cross = (params, dims, cache,
                                                          cross)
        self.fused, self.wpack, self.rows, self.L = fused, wpack, rows, L
        self.valid_start = valid_start
        self.fs = self.vs = None

    def eager(self, tok: torch.Tensor, pos: int) -> torch.Tensor:
        return _step_logits(self.params, self.dims, tok, pos, self.cache,
                            self.cross, self.fused, self.wpack,
                            valid_start=self.valid_start)

    def prepare(self, dev: torch.device) -> None:
        vs, L = self.valid_start, self.L
        if self.fused:
            # x in the parameters' dtype: bf16, or f32 (the f32 residual
            # stream of compute_type "f32")
            self.fs = DL.FusedStep(self.wpack, self.cache, self.cross,
                                   self.rows, self.dims.n_text_head, vs,
                                   L - 1,
                                   self.params["decoder"]["tok_emb"].dtype)
            return
        leaf = self.cache["k8"] if "k8" in self.cache else self.cache["kv"]
        T = leaf.shape[3] if "k8" in self.cache else leaf.shape[4]
        if not 0 <= vs < T or L > T:
            raise ValueError(f"need 0 <= valid_start < {T} and L <= {T}")
        self.vs = torch.full((), vs, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            self.device(torch.zeros((self.rows,), dtype=torch.long,
                                    device=dev),
                        torch.full((), T - 1, dtype=torch.int32, device=dev))
            torch.cuda.synchronize(dev)

    def device(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        dec = self.params["decoder"]
        if self.fused:
            at = torch.clamp(pos - self.valid_start, 0,
                             self.dims.n_text_ctx - 1).long().reshape(1)
            x = dec["tok_emb"][tok] + dec["pos_emb"].index_select(0, at)
            return W.vocab_logits_step(dec, self.fs(x, pos))
        return W.decoder_step(self.params, tok[:, None], pos, self.cache,
                              self.cross, self.dims,
                              valid_start=self.vs)[:, 0]

    def replays(self):
        """The counter of the step's replays (``graph_replays``)."""
        return DL.fused_decoder_layers if self.fused else W.decoder_step


def _no_speech_prob(logits_p, sot_index, ids):
    return torch.softmax(logits_p[:, sot_index], dim=-1)[:, ids.no_speech]


@dataclass(frozen=True)
class _Rules:
    """A decode call's constants, which every iteration applies alike."""

    ids: DecodeSpecialIds
    suppress_mask: torch.Tensor
    with_timestamps: bool
    repetition_penalty: Optional[float]
    no_repeat_ngram_size: int
    temperature: float = 0.0
    seed: int = 0           # the sampled rungs' draws
    beams: int = 1          # K
    capacity: int = 1       # C, the finished buffer's (beam)
    suppress_blank: bool = True


def _penalised(logits, present, tokens, pos, rules: _Rules):
    """The repetition penalty and n-gram bans on (R, V) logits."""
    if present is not None:
        logits = apply_repetition_penalty(logits, present,
                                          rules.repetition_penalty)
    if rules.no_repeat_ngram_size >= 2:
        banned = ngram_banned_mask(tokens, pos, rules.no_repeat_ngram_size,
                                   rules.ids.n_vocab)
        logits = torch.where(banned, NEG_INF, logits)
    return logits


class _Reads:
    """The reads of device data a decode call makes inside its loop: every
    one goes through ``__call__``, which counts it in the call's ``n`` and
    in the process-wide ``_Reads.launches`` (named as the kernels' launch
    counters, so the tools that zero and read those read it alike). A
    synchronising read is allowed there under
    ``torch.cuda.set_sync_debug_mode``."""

    launches = 0

    def __init__(self):
        self.n = 0

    def __call__(self, flag: torch.Tensor) -> bool:
        self.n += 1
        cb.count(_Reads)
        return bool(_fetch(flag))


def _fetch(t: torch.Tensor) -> int:
    """A 0-d tensor's value on the host: the loop's counted reads and a
    call's final fetch, allowed under a sync debug mode."""
    mode = torch.cuda.get_sync_debug_mode() if t.is_cuda else 0
    if mode == 0:
        return int(t)
    torch.cuda.set_sync_debug_mode(0)
    try:
        return int(t)
    finally:
        torch.cuda.set_sync_debug_mode(mode)


# ---------------------------------------------------------------------------
# Greedy / sampled
# ---------------------------------------------------------------------------


@dataclass
class LoopState:
    """The greedy loop's state: static buffers updated in place (rows R,
    buffer length L)."""

    tokens: torch.Tensor        # (R, L) int64
    pos: torch.Tensor           # () int32, the next token's position
    finished: torch.Tensor      # (R,) bool
    sum_logprob: torch.Tensor   # (R,) f32
    last_tok: torch.Tensor      # (R,) int64
    penult_tok: torch.Tensor    # (R,) int64
    max_ts_tok: torch.Tensor    # (R,) int64
    present: Optional[torch.Tensor]  # (R, V) bool (repetition penalty)
    steps: torch.Tensor         # () int32, tokens sampled
    arrived: torch.Tensor       # () int32, the choice kernel's rows done
    #                             in a step (0 between steps)


def greedy_body(st: LoopState, logits: torch.Tensor, rules: _Rules,
                is_first: bool = False) -> None:
    """One greedy / sampled token from (R, V) logits at ``st.pos``, the
    JAX package's ``step``: the penalties, then the choice
    (ops/decode_choice.py: filters, log_softmax, argmax or the Gumbel-max
    draw at a temperature, the bookkeeping; one kernel launch on the card),
    all in place. ``is_first`` (the prefill's logits) is a constant of the
    call, never of an iteration."""
    logits = _penalised(logits, st.present, st.tokens, st.pos, rules)
    DC.greedy_choice(logits, st, rules.ids, rules.suppress_mask, is_first,
                     rules.with_timestamps, rules.suppress_blank,
                     rules.temperature, rules.seed)


def _greedy_iteration(st: LoopState, step_logits: Callable, rules: _Rules,
                      cache=None) -> None:
    """One iteration of the greedy loop (JAX's ``body``): the step on the
    token at pos - 1, then ``greedy_body``."""
    R = st.tokens.shape[0]
    tok = st.tokens.gather(1, (st.pos - 1).long().expand(R, 1))[:, 0]
    greedy_body(st, step_logits(tok), rules)


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


def host_loop(st, iteration, step: _Step, rules: _Rules, cache, P: int,
              L: int, reads: _Reads, **flags) -> None:
    """The loop's plain version: ``iteration`` in a Python while whose
    condition (``DLP.loop_cond_plain`` on ``flags``) is read on the host
    through ``reads``, each step's position kept on the host (P + 1 after
    the first token). Returns None (no loop graph)."""
    pos = P + 1
    while reads(DLP.loop_cond_plain(st.pos, L, **flags)):
        iteration(st, lambda tok, at=pos - 1: step.eager(tok, at), rules,
                  cache)
        pos += 1


def device_loop(st, iteration, step: _Step, rules: _Rules, cache, P: int,
                L: int, reads: _Reads, **flags) -> DLP.DeviceLoop:
    """The loop as one CUDA graph on the state's card (``DLP.DeviceLoop``),
    launched; it reads nothing back. The caller counts its iterations
    (``_count_loop``) and closes it."""
    dev = st.pos.device
    step.prepare(dev)
    loop = DLP.DeviceLoop(
        dev, lambda: iteration(st, lambda tok: step.device(tok, st.pos - 1),
                               rules, cache),
        st.pos, L, **flags)
    try:
        loop.run()
    except BaseException:
        loop.close()
        raise
    return loop


def _decode_loop(st, iteration, step: _Step, rules: _Rules, cache, P: int,
                 L: int, reads: _Reads, **flags) -> Optional[DLP.DeviceLoop]:
    """The device loop for state on the card, the host loop for state on
    the CPU. ``flags``: ``finished`` (greedy) or ``counts`` and ``need``
    (beam), the condition's operands."""
    loop = device_loop if st.pos.is_cuda else host_loop
    return loop(st, iteration, step, rules, cache, P, L, reads, **flags)


def _count_loop(loop: Optional[DLP.DeviceLoop], step: _Step,
                steps: int) -> None:
    """Count a device loop's iterations (every step after the prefill's
    token): the captured launches and the step's replays."""
    if loop is not None:
        loop.finish(steps - 1)
        cb.bump(step.replays(), "graph_replays", steps - 1)


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
    ``self_kv_int8`` selects decoder_step's int8 cache. At a temperature
    the draws are keyed by ``generator``'s seed (``initial_seed()``; 0
    without one).

    Returns tokens (B, P+sample_len), n_sampled, sum_logprob, avg_logprob,
    no_speech_prob (B,), steps (the number of tokens sampled per row,
    including the one from the prefill) and host_reads (the loop's reads
    of device data: 0 on the card).
    """
    B, P = prompt.shape
    L = P + sample_len
    dev = xa.device
    cross, cache, logits_p, wpack = _prefill(params, xa, prompt, dims,
                                             kv_int8, self_kv_int8, fused,
                                             wpack, L, prompt_start,
                                             sot_index)
    no_speech_prob = _no_speech_prob(logits_p, 0, ids)
    rules = _Rules(ids, suppress_mask, with_timestamps, repetition_penalty,
                   no_repeat_ngram_size, float(temperature),
                   generator.initial_seed() if generator is not None else 0)
    tokens = torch.full((B, L), ids.eot, dtype=torch.long, device=dev)
    tokens[:, :P] = prompt
    st = LoopState(
        tokens=tokens,
        pos=torch.full((), P, dtype=torch.int32, device=dev),
        finished=torch.zeros((B,), dtype=torch.bool, device=dev),
        sum_logprob=torch.zeros((B,), dtype=torch.float32, device=dev),
        last_tok=prompt[:, -1].long().clone(),
        penult_tok=torch.full((B,), -1, dtype=torch.long, device=dev),
        max_ts_tok=torch.full((B,), -1, dtype=torch.long, device=dev),
        present=(torch.zeros((B, ids.n_vocab), dtype=torch.bool, device=dev)
                 if repetition_penalty is not None else None),
        steps=torch.zeros((), dtype=torch.int32, device=dev),
        arrived=torch.zeros((), dtype=torch.int32, device=dev))
    # the first sampled token, from the prefill's logits
    greedy_body(st, logits_p[:, -1], rules, is_first=True)
    del logits_p
    step = _Step(params, dims, cache, cross, fused, wpack, B, L, prompt_start)
    reads = _Reads()
    loop = _decode_loop(st, _greedy_iteration, step, rules, cache, P, L,
                        reads, finished=st.finished)
    try:
        n_sampled = (st.tokens[:, P:] != ids.eot).sum(dim=1)
        avg_logprob = st.sum_logprob / (n_sampled.float() + 1.0)
        steps = _fetch(st.steps)
        _count_loop(loop, step, steps)
    finally:
        if loop is not None:
            loop.close()
    return {
        "tokens": st.tokens,
        "n_sampled": n_sampled,
        "sum_logprob": st.sum_logprob,
        "avg_logprob": avg_logprob,
        "no_speech_prob": no_speech_prob,
        "steps": torch.tensor(steps),
        "host_reads": torch.tensor(reads.n),
    }


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------


@dataclass
class BeamState:
    """The beam loop's state: the greedy state's buffers over (B, K) beams
    and the finished buffer, plus the last expansion's source beams
    (``live_src``, applied to the self cache before the next step), the
    count of steps that reordered the cache and the gathers' scratch."""

    tokens: torch.Tensor        # (B, K, L) int64, live beams
    pos: torch.Tensor           # () int32
    sum_logprob: torch.Tensor   # (B, K) f32
    last_tok: torch.Tensor      # (B, K) int64
    penult_tok: torch.Tensor
    max_ts_tok: torch.Tensor
    fin_tokens: torch.Tensor    # (B, C + 1, L); slot C takes the writes
    fin_scores: torch.Tensor    # (B, C + 1)     that do not fit
    fin_count: torch.Tensor     # (B,) int64
    present: Optional[torch.Tensor]  # (B, K, V) bool
    live_src: torch.Tensor      # (B, K) int64
    permuted: torch.Tensor      # () int32
    steps: torch.Tensor         # () int32, expansions
    beam_idx: torch.Tensor      # (K,) arange, the identity map
    tokens_buf: torch.Tensor    # tokens' gather scratch
    present_buf: Optional[torch.Tensor]


def beam_body(st: BeamState, logits: torch.Tensor, rules: _Rules,
              is_first: bool = False) -> None:
    """One beam expansion from (B*K, V) logits at ``st.pos``, the JAX
    package's ``expand``: penalties, the tail (filters, log_softmax,
    scores, eot scores, top-K), eot candidates into the finished buffer
    when they outrank the K-th live candidate, the beams' gathers, all in
    place. The cache reorder by ``st.live_src`` comes before the next
    step (``_beam_iteration``)."""
    ids = rules.ids
    K, C = rules.beams, rules.capacity
    B, _, L = st.tokens.shape
    V = ids.n_vocab
    tsb = ids.timestamp_begin
    logits = _penalised(
        logits, None if st.present is None else st.present.reshape(B * K, V),
        st.tokens.reshape(B * K, L), st.pos, rules)
    live_score, top_idx, eot_scores = beam_tail(
        logits, st.sum_logprob, st.last_tok, st.penult_tok, st.max_ts_tok,
        rules.suppress_mask, is_first, K, tsb, ids.eot, ids.blank,
        ids.no_timestamps, tsb + ids.max_initial_timestamp_index,
        rules.with_timestamps, rules.suppress_blank)
    live_src = top_idx // V
    next_tok = top_idx % V

    # eot candidates enter the finished buffer iff they outrank the K-th
    # live candidate (descending order, ties to the lower beam)
    eot_sorted, eot_order = torch.sort(eot_scores, dim=1, descending=True,
                                       stable=True)
    is_fin = ((eot_sorted > live_score[:, -1:])
              & (eot_sorted > NEG_INF / 2)).long()
    slot = st.fin_count[:, None] + torch.cumsum(is_fin, dim=1) - is_fin
    write = (is_fin > 0) & (slot < C)
    slot_w = torch.where(write, slot, C)
    b_rows = torch.arange(B, device=st.tokens.device)[:, None]
    st.fin_tokens[b_rows, slot_w] = st.tokens[b_rows, eot_order]
    st.fin_scores[b_rows, slot_w] = eot_sorted
    st.fin_count.add_(write.sum(dim=1))

    torch.gather(st.tokens, 1, live_src[:, :, None].expand(B, K, L),
                 out=st.tokens_buf)
    st.tokens.copy_(st.tokens_buf)
    st.tokens.scatter_(2, st.pos.long().expand(B, K, 1), next_tok[:, :, None])
    penult = st.last_tok.gather(1, live_src)
    max_ts = st.max_ts_tok.gather(1, live_src)
    st.max_ts_tok.copy_(torch.where(next_tok >= tsb,
                                    torch.maximum(max_ts, next_tok), max_ts))
    st.penult_tok.copy_(penult)
    if st.present is not None:
        torch.gather(st.present, 1, live_src[:, :, None].expand(B, K, V),
                     out=st.present_buf)
        st.present.copy_(st.present_buf)
        st.present.scatter_(2, next_tok[:, :, None], True)
    st.last_tok.copy_(next_tok)
    st.sum_logprob.copy_(live_score)
    st.live_src.copy_(live_src)
    st.pos.add_(1)
    st.steps.add_(1)


def _beam_iteration(st: BeamState, step_logits: Callable, rules: _Rules,
                    cache) -> None:
    """One iteration of the beam loop (JAX's ``body``): the self cache
    reordered by the last expansion's source beams (a window whose beams
    all keep their own history is left as it is; ``permuted`` counts the
    steps where some window moved), the step on the tokens at pos - 1,
    then ``beam_body``."""
    permute_cache_rows(cache, st.live_src)
    st.permuted.add_((st.live_src != st.beam_idx).any().to(torch.int32))
    B, K, _ = st.tokens.shape
    tok = st.tokens.gather(2, (st.pos - 1).long().expand(B, K, 1))
    beam_body(st, step_logits(tok.reshape(-1)), rules)


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
    The beams share their window's cross K/V. Before each step the self
    cache is permuted in place by the last expansion's source beams; a
    window whose beams all keep their own history is not moved.

    Returns tokens (B, P+sample_len), n_sampled, sum_logprob, avg_logprob,
    no_speech_prob (B,), all_tokens (B, C+K, L), all_scores (B, C+K),
    steps (expansions, the first from the prefill's logits), permuted
    (steps before which some window's cache rows moved) and host_reads
    (the loop's reads of device data: 0 on the card).
    """
    B, P = prompt.shape
    K = beam_size
    L = P + sample_len
    V = ids.n_vocab
    C = max(1, int(round(K * patience)))
    dev = xa.device
    cross, cache, logits_p, wpack = _prefill(params, xa, prompt, dims,
                                             kv_int8, self_kv_int8, fused,
                                             wpack, L, prompt_start,
                                             sot_index)
    cache = {k: v.repeat_interleave(K, dim=1) for k, v in cache.items()}
    no_speech_prob = _no_speech_prob(logits_p, 0, ids)
    logits = logits_p[:, -1].repeat_interleave(K, dim=0)  # (B*K, V)
    del logits_p
    rules = _Rules(ids, suppress_mask, with_timestamps, repetition_penalty,
                   no_repeat_ngram_size, beams=K, capacity=C,
                   suppress_blank=suppress_blank)

    tokens = torch.full((B, K, L), ids.eot, dtype=torch.long, device=dev)
    tokens[:, :, :P] = prompt[:, None, :]
    # only beam 0 is live at first (no K duplicates)
    sum_logprob = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    sum_logprob[:, 0] = 0.0
    present = (torch.zeros((B, K, V), dtype=torch.bool, device=dev)
               if repetition_penalty is not None else None)
    st = BeamState(
        tokens=tokens,
        pos=torch.full((), P, dtype=torch.int32, device=dev),
        sum_logprob=sum_logprob,
        last_tok=prompt[:, -1:].long().expand(B, K).clone(),
        penult_tok=torch.full((B, K), -1, dtype=torch.long, device=dev),
        max_ts_tok=torch.full((B, K), -1, dtype=torch.long, device=dev),
        fin_tokens=torch.full((B, C + 1, L), ids.eot, dtype=torch.long,
                              device=dev),
        fin_scores=torch.full((B, C + 1), NEG_INF, dtype=torch.float32,
                              device=dev),
        fin_count=torch.zeros((B,), dtype=torch.long, device=dev),
        present=present,
        live_src=torch.zeros((B, K), dtype=torch.long, device=dev),
        permuted=torch.zeros((), dtype=torch.int32, device=dev),
        steps=torch.zeros((), dtype=torch.int32, device=dev),
        beam_idx=torch.arange(K, device=dev),
        tokens_buf=torch.empty_like(tokens),
        present_buf=None if present is None else torch.empty_like(present))
    # the first expansion, from the prefill's logits
    beam_body(st, logits, rules, is_first=True)
    del logits
    step = _Step(params, dims, cache, cross, fused, wpack, B * K, L,
                 prompt_start)
    reads = _Reads()
    loop = _decode_loop(st, _beam_iteration, step, rules, cache, P, L, reads,
                        counts=st.fin_count, need=C)
    try:
        live_ok = (st.fin_count < C)[:, None]
        all_tokens = torch.cat([st.fin_tokens[:, :C], st.tokens], dim=1)
        all_sum = torch.cat([st.fin_scores[:, :C],
                             torch.where(live_ok, st.sum_logprob, NEG_INF)],
                            dim=1)
        n_sampled = (all_tokens[:, :, P:] != ids.eot).sum(dim=2)
        final_score = all_sum / (n_sampled.float() + 1.0) ** length_penalty
        best = torch.argmax(final_score, dim=1)
        rows = torch.arange(B, device=dev)
        best_sum = all_sum[rows, best]
        best_n = n_sampled[rows, best]
        steps, permuted = _fetch(st.steps), _fetch(st.permuted)
        _count_loop(loop, step, steps)
    finally:
        if loop is not None:
            loop.close()
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
        "host_reads": torch.tensor(reads.n),
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


# ---------------------------------------------------------------------------
# One decode replica a card
# ---------------------------------------------------------------------------


def beam_search_decode_sharded(
    mesh,
    params,
    xa: torch.Tensor,
    prompt: torch.Tensor,
    dims: W.WhisperDims,
    ids: DecodeSpecialIds,
    suppress_mask: torch.Tensor,
    sot_index: int,
    repetition_penalty: Optional[float] = None,
    prompt_start: Optional[int] = None,
    row_lang: Optional[torch.Tensor] = None,
    **static_kw,
) -> Dict[str, torch.Tensor]:
    """Beam decode with one full replica a mesh entry (the JAX package's
    ``beam_search_decode_sharded``, which runs one under ``shard_map`` a
    device with no collective): ``xa`` and ``prompt`` are cut into the
    mesh's contiguous shards (parallel/mesh.py), each shard decodes by
    ``beam_search_decode`` on its device's copy of ``params`` in its own
    thread under that card's lock, and the outputs join in window order
    on the first entry's device.

    ``params`` is one tree (replicated here) or ``replicate_params``'
    list; a ``wpack`` in ``static_kw`` likewise. ``row_lang`` (B,), each
    window's language token, is written after <|sot|> in its prompt row
    (the JAX function accepts it but drops it). The other keywords go to
    ``beam_search_decode`` as they are."""
    from whisper_aries_tpu_torch.parallel.mesh import (
        join_shards,
        map_shards,
        replicate_params,
    )

    reps = (params if isinstance(params, list)
            else replicate_params(params, mesh))
    wpack = static_kw.pop("wpack", None)
    if wpack is not None and not isinstance(wpack, list):
        wpack = replicate_params(wpack, mesh)
    if row_lang is not None:
        prompt = prompt.clone()
        prompt[:, sot_index + 1] = row_lang.to(prompt)

    def one(i, device, lo, hi):
        return beam_search_decode(
            reps[i], xa[lo:hi].to(device), prompt[lo:hi].to(device), dims,
            ids, suppress_mask.to(device), sot_index,
            repetition_penalty=repetition_penalty,
            prompt_start=prompt_start or 0,
            wpack=wpack[i] if wpack is not None else None, **static_kw)

    return join_shards(map_shards(mesh, int(xa.shape[0]), one), mesh[0])
