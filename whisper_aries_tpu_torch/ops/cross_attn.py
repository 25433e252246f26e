"""int8 cross-attention K/V: the per-position grid and grouped attention.

Port layout (dh-minor, unlike the JAX package's time-minor one):
    k8, v8: (B, H, T, dh) int8      ks, vs: (B, H, T) f32
with ks already folding 1/sqrt(dh). The queries are grouped: q (B, H, G, dh)
holds the G queries of each window (its beams, times the prompt positions
in a prefill), which all read that window's K/V.

``cross_attention_q8`` launches the grouped cross-attention kernel
(csrc/cross_attn.cu, the port of the JAX package's Pallas
``cross_attention_q8`` / ``cross_attention_q8_blocked``) for CUDA tensors
and takes the plain version, ``cross_attention_q8_reference``, only for CPU
tensors. The kernel is the decode step's split-KV cross-attention
(csrc/attn_split.cuh) with the step's split plan
(``decode_layers.cross_split``); ``cross_attention_q8_split_plain``
computes the function the way its splits combine.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.ops.decode_layers import (
    ATTN_MAX_SPLITS,
    CROSS_MAX_KEYS,
    cross_split,
    split_attend,
)


def quantize_kv_per_position(k: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., T, dh) -> int8 values (..., T, dh) + (..., T) f32 scales
    (absmax over dh / 127, round half to even, clip to 127)."""
    kf = k.float()
    absmax = kf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(kf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def cross_attention_q8_reference(q: torch.Tensor, k8: torch.Tensor,
                                 ks: torch.Tensor, v8: torch.Tensor,
                                 vs: torch.Tensor) -> torch.Tensor:
    """q (B, H, G, dh) -> (B, H, G, dh) f32: logits scaled per position,
    f32 softmax, probabilities scaled by vs before the V product."""
    logits = torch.einsum("bhgd,bhtd->bhgt", q.float(), k8.float())
    logits = logits * ks[:, :, None, :]
    p = torch.softmax(logits, dim=-1) * vs[:, :, None, :]
    return torch.einsum("bhgt,bhtd->bhgd", p, v8.float())


def cross_attention_q8_split_plain(q: torch.Tensor, k8: torch.Tensor,
                                   ks: torch.Tensor, v8: torch.Tensor,
                                   vs: torch.Tensor, S: int, C: int,
                                   drop: Optional[int] = None
                                   ) -> torch.Tensor:
    """``cross_attention_q8_reference`` computed the way the kernel combines
    S splits of C keys (decode_layers.split_attend: each split's max,
    sum and partial, rescaled to the global max and summed in rank order).
    ``drop`` leaves that split's partial out (a mistake the card checks
    must catch)."""
    T = k8.shape[2]
    logits = torch.einsum("bhgd,bhtd->bhgt", q.float(), k8.float())
    logits = logits * ks[:, :, None, :]
    ranges = [(min(T, s * C), min(T, (s + 1) * C)) for s in range(S)]
    v = v8[:, :, None].expand(logits.shape[:3] + v8.shape[2:])
    return split_attend(logits, vs[:, :, None, :], v, ranges, drop)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cb.library("cross_attn")
    lib.aries_cross_attn_q8.argtypes = [
        _P, _I, _L, _L, _L, _P, _P, _L, _L, _P, _P, _L, _L, _P, _I, _L, _L,
        _L, _I, _I, _I, _I, _I, _P]
    lib.aries_cross_attn_q8.restype = ctypes.c_int
    return lib


def _require_rows(t: torch.Tensor, name: str, dtype, shape, device,
                  inner: Tuple[int, ...]) -> None:
    """A (B, H, T[, dh]) operand whose trailing strides are ``inner`` (the
    window stride may be anything: views of the packed (B, 2, ...) cache
    are taken as they are)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if tuple(t.stride()[1:]) != inner:
        raise ValueError(f"{name} needs strides (*, {inner})")


def cross_attention_q8_kernel(q: torch.Tensor, k8: torch.Tensor,
                              ks: torch.Tensor, v8: torch.Tensor,
                              vs: torch.Tensor,
                              out: torch.Tensor = None) -> torch.Tensor:
    """The grouped int8 cross-attention kernel: q (B, H, G, 64) bf16 or f32
    (any strides with dh contiguous), k8/v8 (B, H, T, 64) int8 and ks/vs
    (B, H, T) f32 (each window's (H, T, ...) block contiguous, k/v alike)
    -> (B, H, G, 64) f32. One launch for all windows: the decode step's
    split plan (``decode_layers.cross_split``), S blocks a (head, window),
    one cluster each.

    ``out``, when given, takes the result in place of a new f32 tensor:
    (B, H, G, 64) f32, or bf16 for a bf16 q, any strides with dh
    contiguous. A bf16 ``out`` over the rows of an (R, d) tensor is the
    decode step's own use of the device code."""
    if not q.is_cuda:
        raise ValueError("q must be a CUDA tensor")
    B, H, G, dh = q.shape
    T = k8.shape[2]
    if dh != 64:
        raise ValueError(f"cross-attention kernel needs dh 64, got {dh}")
    if q.dtype not in (torch.bfloat16, torch.float32) or q.stride(3) != 1:
        raise ValueError("q must be bf16 or f32 with dh contiguous")
    for name, t in (("k8", k8), ("v8", v8)):
        _require_rows(t, name, torch.int8, (B, H, T, dh), q.device,
                      (T * dh, dh, 1))
        if t.data_ptr() % 16 or t.stride(0) % 16:
            raise ValueError(f"{name} must be 16-byte aligned, windows too")
    for name, t in (("ks", ks), ("vs", vs)):
        _require_rows(t, name, torch.float32, (B, H, T), q.device, (T, 1))
    if k8.stride(0) != v8.stride(0) or ks.stride(0) != vs.stride(0):
        raise ValueError("k and v operands must share their window strides")
    if out is None:
        out = torch.empty((B, H, G, dh), dtype=torch.float32,
                          device=q.device)
    elif (out.device != q.device or tuple(out.shape) != (B, H, G, dh)
          or out.dtype not in (torch.float32, q.dtype) or out.stride(3) != 1):
        raise ValueError(f"out must be ({B}, {H}, {G}, {dh}) f32, or bf16 "
                         f"for a bf16 q, on {q.device} with dh contiguous")
    sms = cb.sm_count(q)
    if cross_split(T, B * H, G, sms)[1] > CROSS_MAX_KEYS:
        raise ValueError(f"cross-attention kernel: {T} keys exceed "
                         f"{ATTN_MAX_SPLITS} splits of {CROSS_MAX_KEYS}")
    qs, os_ = q.stride(), out.stride()
    cb.launch(_lib().aries_cross_attn_q8, q, "cross-attention kernel",
              cb.ptr(q), int(q.dtype == torch.bfloat16), qs[0], qs[1], qs[2],
              cb.ptr(k8), cb.ptr(v8), k8.stride(0), k8.stride(1), cb.ptr(ks),
              cb.ptr(vs), ks.stride(0), ks.stride(1), cb.ptr(out),
              int(out.dtype == torch.bfloat16), os_[0], os_[1], os_[2], B, H,
              G, T, sms)
    cb.count(cross_attention_q8_kernel)
    return out


cross_attention_q8_kernel.launches = 0


def cross_attention_q8(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                       v8: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """Grouped int8 cross-attention, q (B, H, G, dh) -> (B, H, G, dh) f32:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if not q.is_cuda:
        return cross_attention_q8_reference(q, k8, ks, v8, vs)
    return cross_attention_q8_kernel(q, k8, ks, v8, vs)
