"""Beam-cache reorder (csrc/beam_reorder.cu).

After a beam step every leaf of the self cache, (L, B*K, ...) with the row
axis second, takes row b*K + o <- row b*K + src[b, o]: beams fork only
within their own window, so the permutation is block-diagonal. This
replaces the JAX package's Pallas ``_permute_leaf``
(ops/pallas_beam_reorder.py). Unlike JAX's functional update the port
permutes IN PLACE (no second cache buffer): the kernel for CUDA tensors,
one launch per leaf; the plain version, a gather along axis 1, only for
CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from whisper_aries_tpu_torch.ops import cuda_build as cb


def permute_rows_plain(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """x (L, B*K, ...) <- the gather of rows b*K + src[b, o], in place."""
    B, K = src.shape
    flat = (torch.arange(B, device=x.device)[:, None] * K
            + src.to(x.device).long()).reshape(-1)
    x.copy_(x.index_select(1, flat))
    return x


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    fn = cb.library("beam_reorder").aries_beam_reorder
    fn.argtypes = [_P, _P, _I, _I, _I, ctypes.c_longlong, _P]
    fn.restype = ctypes.c_int
    return fn


def permute_rows_kernel(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The reorder kernel on one leaf: x (L, B*K, ...) contiguous CUDA of
    any dtype, src (B, K) int32 CUDA with values in [0, K) (a value out of
    range stops the kernel with a device fault). In place; returns x."""
    if not x.is_cuda:
        raise ValueError("x must be a CUDA tensor")
    B, K = src.shape
    if x.dim() < 2 or x.shape[1] != B * K:
        raise ValueError(f"leaf rows {tuple(x.shape[:2])} do not match "
                         f"src ({B}, {K})")
    if not 1 <= K <= 8:
        raise ValueError(f"reorder kernel takes 1 <= K <= 8, got {K}")
    if not x.is_contiguous():
        raise ValueError("leaf must be contiguous")
    cb.require(src, "src", torch.int32, (B, K), x.device)
    L = x.shape[0]
    row_bytes = x[0, 0].numel() * x.element_size()
    cb.launch(_fn(), x, "beam reorder kernel", cb.ptr(x), cb.ptr(src), L, B,
              K, row_bytes)
    permute_rows_kernel.launches += 1
    return x


permute_rows_kernel.launches = 0


def permute_cache_rows(cache: Dict[str, torch.Tensor], src: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
    """Permute the row axis (axis 1) of every cache leaf by the per-window
    map ``src`` (B, K) in place: int8 values, f32 scales or bf16 K/V alike.
    The kernel for CUDA leaves, the plain version for CPU leaves."""
    src32 = None
    for v in cache.values():
        if not v.is_cuda:
            permute_rows_plain(v, src)
            continue
        if src32 is None:
            src32 = src.to(device=v.device, dtype=torch.int32).contiguous()
        permute_rows_kernel(v, src32)
    return cache
