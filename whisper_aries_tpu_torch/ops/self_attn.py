"""Decode-step self-attention over the int8 self cache.

The unfused ``decoder_step`` (models/whisper.py) keeps an int8 self cache
with per-position scales when the cross K/V stay in bf16 and the self cache
is int8 (``decode.kv_cache_dtype="bf16"``, ``decode.self_kv_cache_dtype=
"int8"``). Port layout (dh-minor, one layer):

    q: (B, H, S, dh)   k8, v8: (B, H, T, dh) int8   ks, vs: (B, H, T) f32
    mask: (S, T) or (T,) f32 additive (0 where readable, f32 min elsewhere)

with ks folding 1/sqrt(dh). ``self_attention_q8`` launches the kernel
(csrc/self_attn.cu, the port of the JAX package's Pallas
``self_attention_q8_step``; split-KV over thread-block clusters, planned by
``split_plan``) for CUDA tensors at S == 1 and takes the plain version,
``self_attention_q8_plain``, for CPU tensors. The prefill (S > 1)
stays plain on every device, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.ops.cross_attn import _require_rows


def self_attention_q8_plain(q: torch.Tensor, k8: torch.Tensor,
                            ks: torch.Tensor, v8: torch.Tensor,
                            vs: torch.Tensor, mask: torch.Tensor
                            ) -> torch.Tensor:
    """q (B, H, S, dh) -> (B, H, S, dh) f32: logits scaled per position
    plus the mask, f32 softmax, probabilities scaled by vs before the V
    product (the JAX package's ``self_attention_q8_reference``)."""
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k8.float())
    logits = logits * ks[:, :, None, :] + mask
    p = torch.softmax(logits, dim=-1) * vs[:, :, None, :]
    return torch.einsum("bhst,bhtd->bhsd", p, v8.float())


# csrc/self_attn.cu's split plan
BLOCKS_PER_SM, MAX_SPLITS, MAX_KEYS = 2, 8, 128


def split_plan(T: int, pairs: int, sms: int) -> Tuple[int, int]:
    """(S, C): the kernel's S splits of C keys over T keys for ``pairs`` =
    rows x heads on ``sms`` SMs, the mirror of the C ``plan`` (about
    BLOCKS_PER_SM blocks per SM, at most MAX_SPLITS a pair and at least
    T / MAX_KEYS, C a multiple of 32). It never depends on the position."""
    s = BLOCKS_PER_SM * sms // max(pairs, 1)
    s = min(max(s, -(-T // MAX_KEYS), 1), MAX_SPLITS)
    keys = -(-T // s)
    c = max(32, -(-keys // 32) * 32)
    return -(-T // c), c


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cb.library("self_attn")
    lib.aries_self_attn_q8.argtypes = [_P, _I, _L, _L, _P, _P, _L, _L, _P,
                                       _P, _L, _L, _P, _P, _I, _I, _I, _I, _P]
    lib.aries_self_attn_q8_plan.argtypes = [_I, _I, _I, _P]
    for fn in (lib.aries_self_attn_q8, lib.aries_self_attn_q8_plan):
        fn.restype = ctypes.c_int
    return lib


def kernel_split_plan(T: int, pairs: int, sms: int) -> Tuple[int, int]:
    """The C split plan (the card check of ``split_plan``)."""
    out = (ctypes.c_int * 2)()
    _lib().aries_self_attn_q8_plan(T, pairs, sms, out)
    return out[0], out[1]


def self_attention_q8_kernel(q: torch.Tensor, k8: torch.Tensor,
                             ks: torch.Tensor, v8: torch.Tensor,
                             vs: torch.Tensor, mask: torch.Tensor
                             ) -> torch.Tensor:
    """The int8 self-attention step kernel: q (B, H, 1, 64) bf16 or f32
    (any strides with dh contiguous), k8/v8 (B, H, T, 64) int8 and ks/vs
    (B, H, T) f32 (each row's (H, T, ...) block contiguous), mask (T,) or
    (1, T) f32 -> (B, H, 1, 64) f32. One launch for all rows and heads:
    ``split_plan``'s S blocks a (row, head), one cluster each."""
    if not q.is_cuda:
        raise ValueError("q must be a CUDA tensor")
    B, H, S, dh = q.shape
    T = k8.shape[2]
    if S != 1 or dh != 64:
        raise ValueError(f"self-attention kernel needs S 1 and dh 64, got "
                         f"S {S}, dh {dh}")
    if q.dtype not in (torch.bfloat16, torch.float32) or q.stride(3) != 1:
        raise ValueError("q must be bf16 or f32 with dh contiguous")
    for name, t in (("k8", k8), ("v8", v8)):
        _require_rows(t, name, torch.int8, (B, H, T, dh), q.device,
                      (T * dh, dh, 1))
        if t.data_ptr() % 16 or t.stride(0) % 16:
            raise ValueError(f"{name} must be 16-byte aligned, rows too")
    for name, t in (("ks", ks), ("vs", vs)):
        _require_rows(t, name, torch.float32, (B, H, T), q.device, (T, 1))
    if k8.stride(0) != v8.stride(0) or ks.stride(0) != vs.stride(0):
        raise ValueError("k and v operands must share their row strides")
    if mask.numel() != T:
        raise ValueError(f"mask must hold one row of {T}")
    mask = mask.reshape(T)
    cb.require(mask, "mask", torch.float32, (T,), q.device)
    sms = cb.sm_count(q)
    S, C = split_plan(T, B * H, sms)
    if S > MAX_SPLITS or C > MAX_KEYS:
        raise ValueError(f"self-attention kernel: {T} keys exceed "
                         f"{MAX_SPLITS} splits of {MAX_KEYS}")
    out = torch.empty((B, H, 1, dh), dtype=torch.float32, device=q.device)
    cb.launch(_lib().aries_self_attn_q8, q, "self-attention kernel",
              cb.ptr(q), int(q.dtype == torch.bfloat16), q.stride(0),
              q.stride(1), cb.ptr(k8), cb.ptr(v8), k8.stride(0), k8.stride(1),
              cb.ptr(ks), cb.ptr(vs), ks.stride(0), ks.stride(1),
              cb.ptr(mask), cb.ptr(out), B, H, T, sms)
    self_attention_q8_kernel.launches += 1
    return out


self_attention_q8_kernel.launches = 0


def self_attention_q8(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                      v8: torch.Tensor, vs: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
    """One decode step's self-attention, q (B, H, 1, dh) -> (B, H, 1, dh)
    f32: the kernel for CUDA tensors, the plain version for CPU tensors."""
    if not q.is_cuda:
        return self_attention_q8_plain(q, k8, ks, v8, vs, mask)
    return self_attention_q8_kernel(q, k8, ks, v8, vs, mask)
