"""The greedy / sampled choice of a decode step (csrc/decode_choice.cu).

``greedy_choice`` does, on a step's (R, V) f32 logits (the repetition
penalty and n-gram bans already applied, where a call sets them), what the
JAX package's ``step`` does after them (decoding/generate.py:341-380):
Whisper's logit rules (decoding/logit_filters.py), the log-softmax of the
chosen token, the choice (argmax at temperature 0; above it the Gumbel-max
draw, u the counter hash of (seed, row, pos, id) of
``decode_loop.uniform_draw``, which stands in for the TPU's own random
bits), and the in-place updates of the loop state (``LoopState``: tokens at
``pos``, finished, sum_logprob, last / penultimate / max timestamp token,
present, ``pos`` and ``steps`` advanced). Rows that had finished take
end-of-text and add 0 to their sum.

For CUDA state it launches the kernel: one launch a step, no (R, V) pass
in torch, no draw written, no host read, no allocation (the state's
``arrived`` counter lets the last row advance ``pos``), so it sits inside
the decode loop's graph. ``greedy_choice_plain``, the torch ops the greedy
loop ran before the kernel, runs for CPU state only.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from whisper_aries_tpu_torch.decoding.logit_filters import apply_filters
from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.ops import decode_loop as DLP

_P, _I, _LL, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_uint)


class _Args(ctypes.Structure):
    """csrc/decode_choice.cu's ``ChoiceArgs``, field for field."""

    _fields_ = [("logits", _P), ("row_stride", _LL), ("V", _I),
                ("mask", _P), ("no_ts", _I), ("blank", _I), ("eot", _I),
                ("tsb", _I), ("init_cap", _I), ("is_first", _I),
                ("with_ts", _I), ("suppress_blank", _I), ("sample", _I),
                ("inv_t", ctypes.c_float), ("seed_lo", _U), ("seed_hi", _U),
                ("finished", _P), ("last_tok", _P), ("penult_tok", _P),
                ("max_ts_tok", _P), ("tokens", _P), ("L", _I), ("pos", _P),
                ("sum_logprob", _P), ("present", _P), ("steps", _P),
                ("arrived", _P)]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cb.library("decode_choice")
    lib.aries_decode_choice.argtypes = [ctypes.POINTER(_Args), _I, _P]
    lib.aries_decode_choice.restype = ctypes.c_int
    return lib


def inverse_temperature(temperature: float) -> float:
    """1 / max(T, 1e-6) in f32, as PyTorch's CUDA division by a host
    scalar computes it (it then multiplies by this reciprocal)."""
    return float(np.float32(1.0) / np.float32(max(temperature, 1e-6)))


def greedy_choice_plain(logits: torch.Tensor, st, ids,
                        suppress_mask: torch.Tensor, is_first: bool,
                        with_timestamps: bool, suppress_blank: bool,
                        temperature: float, seed: int) -> None:
    """The choice in torch ops, in place on ``st``: filters, log_softmax,
    argmax or the Gumbel-max draw, the bookkeeping."""
    R, V = logits.shape
    f = apply_filters(logits, ids, suppress_mask, is_first, st.last_tok,
                      st.penult_tok, st.max_ts_tok, with_timestamps,
                      suppress_blank)
    logprobs = torch.log_softmax(f, dim=-1)
    if temperature > 0:
        u = DLP.uniform_draw_plain(seed, st.pos, R, V)
        gumbel = -torch.log(-torch.log(u))
        next_tok = torch.argmax(f / max(temperature, 1e-6) + gumbel, dim=-1)
    else:
        next_tok = torch.argmax(f, dim=-1)
    next_tok = torch.where(st.finished, ids.eot, next_tok)
    col = next_tok[:, None]
    tok_lp = logprobs.gather(1, col)[:, 0]
    st.sum_logprob.add_(torch.where(st.finished, 0.0, tok_lp))
    if st.present is not None:
        st.present.scatter_(1, col, st.present.gather(1, col)
                            | ~st.finished[:, None])
    st.finished.logical_or_(next_tok == ids.eot)
    st.tokens.scatter_(1, st.pos.long().expand(R, 1), col)
    is_ts = next_tok >= ids.timestamp_begin
    st.max_ts_tok.copy_(torch.where(
        is_ts, torch.maximum(st.max_ts_tok, next_tok), st.max_ts_tok))
    st.penult_tok.copy_(st.last_tok)
    st.last_tok.copy_(next_tok)
    st.pos.add_(1)
    st.steps.add_(1)


def greedy_choice_kernel(logits: torch.Tensor, st, ids,
                         suppress_mask: torch.Tensor, is_first: bool,
                         with_timestamps: bool, suppress_blank: bool,
                         temperature: float, seed: int) -> None:
    """The choice kernel on the state's card: one launch, in place."""
    R, V = logits.shape
    dev = logits.device
    if logits.dtype != torch.float32 or logits.stride(1) != 1:
        raise ValueError("logits must be f32 with contiguous rows")
    L = st.tokens.shape[1]
    cb.require(suppress_mask, "suppress_mask", torch.float32, (V,), dev)
    cb.require(st.finished, "finished", torch.bool, (R,), dev)
    for name in ("last_tok", "penult_tok", "max_ts_tok"):
        cb.require(getattr(st, name), name, torch.int64, (R,), dev)
    cb.require(st.tokens, "tokens", torch.int64, (R, L), dev)
    cb.require(st.pos, "pos", torch.int32, (), dev)
    cb.require(st.steps, "steps", torch.int32, (), dev)
    cb.require(st.arrived, "arrived", torch.int32, (), dev)
    cb.require(st.sum_logprob, "sum_logprob", torch.float32, (R,), dev)
    if st.present is not None:
        cb.require(st.present, "present", torch.bool, (R, V), dev)
    lo, hi = DLP._seed_words(seed)
    sample = temperature > 0
    args = _Args(
        cb.ptr(logits), logits.stride(0), V, cb.ptr(suppress_mask),
        ids.no_timestamps, ids.blank, ids.eot, ids.timestamp_begin,
        ids.timestamp_begin + ids.max_initial_timestamp_index,
        int(is_first), int(with_timestamps), int(suppress_blank),
        int(sample), inverse_temperature(temperature) if sample else 1.0,
        lo, hi, cb.ptr(st.finished), cb.ptr(st.last_tok),
        cb.ptr(st.penult_tok), cb.ptr(st.max_ts_tok), cb.ptr(st.tokens), L,
        cb.ptr(st.pos), cb.ptr(st.sum_logprob),
        cb.ptr(st.present) if st.present is not None else None,
        cb.ptr(st.steps), cb.ptr(st.arrived))
    cb.launch(_lib().aries_decode_choice, logits, "decode choice",
              ctypes.byref(args), R)
    cb.count(greedy_choice_kernel)


greedy_choice_kernel.launches = 0


def greedy_choice(logits: torch.Tensor, st, ids, suppress_mask, is_first,
                  with_timestamps, suppress_blank, temperature, seed) -> None:
    """The step's choice, in place on ``st``: the kernel for logits on the
    card, the plain version for logits on the CPU."""
    fn = greedy_choice_kernel if logits.is_cuda else greedy_choice_plain
    fn(logits, st, ids, suppress_mask, is_first, with_timestamps,
       suppress_blank, temperature, seed)
