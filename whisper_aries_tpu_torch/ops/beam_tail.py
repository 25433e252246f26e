"""The beam-search expansion tail (csrc/beam_tail.cu) and Whisper's logit
filters.

``beam_tail`` computes, for one beam step, what expand() does between the
logits and the beam bookkeeping: the logit filters, the per-row
log_softmax, the accumulated scores, the eot continuation scores and the
top-K of the flat K*V expansion (ties to the lowest flat index). It
replaces the JAX package's Pallas ``beam_tail``
(ops/pallas_beam_tail.py). For CUDA tensors it launches the kernel; the
plain version, ``beam_tail_plain`` (Whisper's logit rules from
decoding/logit_filters.py, log_softmax, the eot column,
``_top_k_unrolled``: expand()'s XLA branch), runs only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import Tuple

import torch

from whisper_aries_tpu_torch.decoding.logit_filters import (
    NEG_INF,
    apply_filters,
)
from whisper_aries_tpu_torch.ops import cuda_build as cb


def _top_k_unrolled(flat: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending top-k over the last axis as k argmax-and-mask passes:
    ties go to the lower index (argmax takes the first maximum), picked
    entries are masked to -inf (below the f32-min padding)."""
    flat = flat.clone()
    rows = torch.arange(flat.shape[0], device=flat.device)
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(flat, dim=-1)
        vals.append(flat[rows, i])
        idxs.append(i)
        flat[rows, i] = -float("inf")
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def beam_tail_plain(logits_flat, sum_logprob, last_tok, penult_tok,
                    max_ts_tok, suppress_mask, is_first, K, tsb, eot, blank,
                    no_ts, init_cap, with_timestamps=True,
                    suppress_blank=True):
    """expand()'s XLA branch: (live_score (B, K) f32, top_idx (B, K) int64
    flat k*V+v, eot_scores (B, K) f32)."""
    BK, V = logits_flat.shape
    B = BK // K
    ids = types.SimpleNamespace(no_timestamps=no_ts, blank=blank, eot=eot,
                                timestamp_begin=tsb,
                                max_initial_timestamp_index=init_cap - tsb)
    f = apply_filters(logits_flat, ids, suppress_mask, bool(is_first),
                      last_tok.reshape(-1), penult_tok.reshape(-1),
                      max_ts_tok.reshape(-1), with_timestamps,
                      suppress_blank)
    logprobs = torch.log_softmax(f, dim=-1).reshape(B, K, V)
    total = sum_logprob[:, :, None] + logprobs
    eot_scores = total[:, :, eot].clone()
    total[:, :, eot] = NEG_INF
    live_score, top_idx = _top_k_unrolled(total.reshape(B, K * V), K)
    return live_score, top_idx, eot_scores


# csrc/beam_tail.cu's chunk plan
BLOCKS_PER_SM, MAX_CHUNKS, MAX_CHUNK = 2, 8, 8192


def chunk_plan(V: int, rows: int, sms: int) -> Tuple[int, int]:
    """(C, W): the kernel's C chunks of W columns over a row of V logits
    for ``rows`` = B*K beam rows on ``sms`` SMs, the mirror of the C
    ``plan`` (about BLOCKS_PER_SM blocks per SM, at least V / MAX_CHUNK and
    at most MAX_CHUNKS chunks, W a multiple of 4)."""
    c = -(-BLOCKS_PER_SM * sms // max(rows, 1))
    c = min(max(c, -(-V // MAX_CHUNK), 1), MAX_CHUNKS)
    cols = -(-V // c)
    w = -(-cols // 4) * 4
    return -(-V // w), w


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cb.library("beam_tail")
    lib.aries_beam_tail.argtypes = [_P] * 6 + [_I] * 12 + [_P] * 5
    lib.aries_beam_tail_plan.argtypes = [_I, _I, _I, _P]
    for fn in (lib.aries_beam_tail, lib.aries_beam_tail_plan):
        fn.restype = ctypes.c_int
    return lib


def kernel_chunk_plan(V: int, rows: int, sms: int) -> Tuple[int, int]:
    """The C chunk plan (the card check of ``chunk_plan``)."""
    out = (ctypes.c_int * 2)()
    _lib().aries_beam_tail_plan(V, rows, sms, out)
    return out[0], out[1]


def beam_tail_kernel(logits_flat, sum_logprob, last_tok, penult_tok,
                     max_ts_tok, suppress_mask, is_first, K, tsb, eot, blank,
                     no_ts, init_cap, with_timestamps=True,
                     suppress_blank=True):
    """The beam-tail kernel: logits (B*K, V) f32 contiguous CUDA, state
    (B, K) (scores f32, tokens any integer type; int64 is read as it is),
    suppress mask (V,) f32. ``chunk_plan``'s C blocks a beam row (one
    cluster each), then one warp a window merging the K x C x K
    candidates: two launches, counted as one call."""
    if not logits_flat.is_cuda:
        raise ValueError("logits_flat must be a CUDA tensor")
    BK, V = logits_flat.shape
    if not 1 <= K <= 8 or BK % K:
        raise ValueError(f"beam tail kernel needs 1 <= K <= 8 dividing "
                         f"{BK} rows, got K={K}")
    B = BK // K
    dev = logits_flat.device
    cb.require(logits_flat, "logits_flat", torch.float32, (BK, V), dev)
    cb.require(sum_logprob, "sum_logprob", torch.float32, (B, K), dev)
    cb.require(suppress_mask, "suppress_mask", torch.float32, (V,), dev)
    toks = []
    for name, t in (("last_tok", last_tok), ("penult_tok", penult_tok),
                    ("max_ts_tok", max_ts_tok)):
        if tuple(t.shape) != (B, K) or t.device != dev:
            raise ValueError(f"{name} must be ({B}, {K}) on {dev}")
        toks.append(t.to(torch.int64).contiguous())
    sms = cb.sm_count(dev)
    C, W = chunk_plan(V, BK, sms)
    if W > MAX_CHUNK:
        raise ValueError(f"beam tail kernel: V {V} exceeds {MAX_CHUNKS} "
                         f"chunks of {MAX_CHUNK}")
    cand = torch.empty((B, K * C * K), dtype=torch.int64, device=dev)
    live = torch.empty((B, K), dtype=torch.float32, device=dev)
    idx = torch.empty((B, K), dtype=torch.int64, device=dev)
    eots = torch.empty((B, K), dtype=torch.float32, device=dev)
    cb.launch(_lib().aries_beam_tail, logits_flat, "beam tail kernel",
              cb.ptr(logits_flat), cb.ptr(sum_logprob),
              *(cb.ptr(t) for t in toks), cb.ptr(suppress_mask), B, K, V, tsb,
              eot, blank, no_ts, init_cap, int(with_timestamps),
              int(suppress_blank), int(bool(is_first)), sms, cb.ptr(cand),
              cb.ptr(live), cb.ptr(idx), cb.ptr(eots))
    beam_tail_kernel.launches += 1
    return live, idx, eots


beam_tail_kernel.launches = 0


def beam_tail(logits_flat, sum_logprob, last_tok, penult_tok, max_ts_tok,
              suppress_mask, is_first, K, tsb, eot, blank, no_ts, init_cap,
              with_timestamps=True, suppress_blank=True):
    """Filters + log_softmax + scores + eot scores + top-K of one beam
    step: (live_score, top_idx, eot_scores), each (B, K). The kernel for
    CUDA tensors, the plain version for CPU tensors."""
    fn = beam_tail_kernel if logits_flat.is_cuda else beam_tail_plain
    return fn(logits_flat, sum_logprob, last_tok, penult_tok, max_ts_tok,
              suppress_mask, is_first, K, tsb, eot, blank, no_ts, init_cap,
              with_timestamps, suppress_blank)
