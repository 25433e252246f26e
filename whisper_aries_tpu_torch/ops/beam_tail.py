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


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    fn = cb.library("beam_tail").aries_beam_tail
    fn.argtypes = [_P] * 6 + [_I] * 11 + [_P] * 4
    fn.restype = ctypes.c_int
    return fn


def beam_tail_kernel(logits_flat, sum_logprob, last_tok, penult_tok,
                     max_ts_tok, suppress_mask, is_first, K, tsb, eot, blank,
                     no_ts, init_cap, with_timestamps=True,
                     suppress_blank=True):
    """The beam-tail kernel: logits (B*K, V) f32 contiguous CUDA, state
    (B, K) (scores f32, tokens any integer type), suppress mask (V,) f32.
    One block per window."""
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
        toks.append(t.to(torch.int32).contiguous())
    live = torch.empty((B, K), dtype=torch.float32, device=dev)
    idx = torch.empty((B, K), dtype=torch.int64, device=dev)
    eots = torch.empty((B, K), dtype=torch.float32, device=dev)
    cb.check(_fn()(cb.ptr(logits_flat), cb.ptr(sum_logprob),
                   *(cb.ptr(t) for t in toks), cb.ptr(suppress_mask), B, K,
                   V, tsb, eot, blank, no_ts, init_cap, int(with_timestamps),
                   int(suppress_blank), int(bool(is_first)), cb.ptr(live),
                   cb.ptr(idx), cb.ptr(eots), cb.stream()),
             "beam tail kernel")
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
