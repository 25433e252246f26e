"""int8 weight quantization (the CTranslate2-equivalent compute path).

The same grid as the JAX package's ops/quant.py: per-output-channel
symmetric absmax scales, values rounded half to even and clipped to
[-127, 127]. A quantized dense layer is {"q": int8 (K, N), "s": f32 (N,),
"b": optional bias}; ``models.layers.dense`` dispatches on "q".

``quant_matmul`` reads ``ARIES_QUANT_IMPL`` at every call, as the JAX
package reads it when it traces:

  * "outscale" (default): bf16 activations times the int8 values (exact in
    bf16), f32 accumulation, the per-channel scale applied to the f32
    result. A plain torch product, as JAX computes it outside any kernel.
  * "pallas": the weight-side dequant product of the JAX package's Pallas
    kernel (``_quant_matmul_pallas``): each weight rounded to bf16 after an
    f32 multiply by its scale, then bf16 x bf16 with f32 sums. The W8A16
    GEMM kernel (csrc/quant_matmul.cu; TMA + wgmma for large M, split-K
    mma.sync for small M, by ``gemm_plan``) for CUDA tensors,
    ``quant_matmul_dequant_plain`` for CPU tensors. (On the CPU the JAX
    package maps "pallas" to "xla"; the port runs what the TPU kernel
    computes.)
  * "xla" (and any other value, as in JAX): weights dequantized in the
    activation dtype, then the product.
  * "native" (JAX's s8 x s8 -> s32 scheme) is not ported and raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Any, Dict, Optional, Tuple

import torch

from whisper_aries_tpu_torch.ops import cuda_build as cb


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K, N) float weights -> (int8 values (..., K, N), f32 scales
    (..., N)). Leading dims (e.g. the stacked-layer axis) are preserved."""
    w = w.float()
    absmax = w.abs().amax(dim=-2)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_bf16(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 (K, N) x f32 scales (N,) -> bf16 weights: an f32 multiply, then
    round to nearest even (the TPU kernel's per-tile dequant)."""
    return (q.float() * s.float()).to(torch.bfloat16)


def quant_matmul_dequant_plain(x: torch.Tensor, q: torch.Tensor,
                               s: torch.Tensor,
                               out_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """x (M, K) @ bf16-dequantized q (K, N) -> (M, N) in ``out_dtype``:
    bf16(x) times the bf16 weights, products exact in f32, f32 sums."""
    w = dequantize_bf16(q, s)
    y = torch.matmul(x.to(torch.bfloat16).float(), w.float())
    return y.to(out_dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cb.library("quant_matmul")
    lib.aries_quant_matmul.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                       _P, _P]
    lib.aries_quant_matmul.restype = _I
    lib.aries_dequant_bf16.argtypes = [_P, _P, _P, _I, _I, _P]
    lib.aries_dequant_bf16.restype = _I
    return lib


# The kernel's two paths (csrc/quant_matmul.cu), by their C codes.
GEMM_PATHS = {"splitk": 0, "wgmma": 1}
# The smallest M x N sent to the TMA + wgmma path. Measured on the H100
# (chip_smoke.py's "quant_matmul crossover" line, PERF.md), the two paths
# cross where the output has about this many elements: M ~420 at N 1280,
# ~150 at N 3840, ~128 at N 5120 (K 1280).
WGMMA_MIN_MN = 512 * 1280
_SPLITK_BK, _SPLITK_MIN_TRIPS = 32, 4


def _splitk_splits(M: int, N: int, K: int, sms: int) -> int:
    """The split-K path's K splits: 1 when its 128 x 128 output tiles alone
    fill the card, else about two blocks per SM, each split a whole number
    (at least 4) of 32-deep K slabs."""
    blocks = -(-N // 128) * -(-M // 128)
    if blocks >= sms:
        return 1
    slabs = K // _SPLITK_BK
    want = -(-2 * sms // blocks)
    best = 1
    for c in range(2, want + 1):
        if c * _SPLITK_MIN_TRIPS > slabs:
            break
        if slabs % c == 0:
            best = c
    return best


@functools.lru_cache(maxsize=None)  # a few shapes, called per layer
def gemm_plan(M: int, N: int, K: int, sms: int) -> Tuple[str, int]:
    """(path, K splits) for an (M, K) x (K, N) product on a card with
    ``sms`` SMs: "wgmma" (TMA + wgmma, one split) from WGMMA_MIN_MN output
    elements up when K % 64 == 0, else "splitk" (mma.sync, split K when the
    tiles do not fill the card)."""
    if M * N >= WGMMA_MIN_MN and K % 64 == 0:
        return "wgmma", 1
    return "splitk", _splitk_splits(M, N, K, sms)


def dequantize_bf16_kernel(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The "wgmma" path's first pass on its own: int8 (K, N) x f32 (N,) CUDA
    tensors, N % 16 == 0 -> bf16 (K, N), bit for bit ``dequantize_bf16``."""
    cb.require(q, "q", torch.int8)
    K, N = q.shape
    cb.require(s, "s", torch.float32, (N,), q.device)
    if N % 16 or q.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError("the dequant kernel needs N % 16 == 0 and 16-byte "
                         "aligned q and s")
    w = torch.empty((K, N), dtype=torch.bfloat16, device=q.device)
    cb.launch(_lib().aries_dequant_bf16, q, "W8A16 dequant", cb.ptr(q),
              cb.ptr(s), cb.ptr(w), K, N)
    return w


def quant_matmul_dequant_kernel(x: torch.Tensor, q: torch.Tensor,
                                s: torch.Tensor,
                                out_dtype: torch.dtype = torch.bfloat16,
                                path: Optional[str] = None) -> torch.Tensor:
    """The W8A16 GEMM kernel (csrc/quant_matmul.cu): x (M, K) bf16,
    q (K, N) int8, s (N,) f32, contiguous CUDA tensors with K % 32 == 0 and
    N % 16 == 0 -> (M, N) bf16 or f32, by the path ``gemm_plan`` picks
    (``path`` names one instead: the crossover measurement). Other shapes
    raise. Counts ``launches`` and ``launches_by_path``."""
    cb.require(x, "x", torch.bfloat16)
    M, K = x.shape
    if q.dim() != 2 or q.shape[0] != K:
        raise ValueError(f"q must be ({K}, N), got {tuple(q.shape)}")
    N = q.shape[1]
    cb.require(q, "q", torch.int8, (K, N), x.device)
    cb.require(s, "s", torch.float32, (N,), x.device)
    if K % 32 or N % 16 or M < 1:
        raise ValueError(f"the W8A16 GEMM kernel needs K % 32 == 0 and "
                         f"N % 16 == 0, got M {M}, K {K}, N {N}")
    for name, t in (("x", x), ("q", q), ("s", s)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("the kernel writes bf16 or f32")
    sms = cb.sm_count(x)
    if path is None:
        path, splits = gemm_plan(M, N, K, sms)
    elif path not in GEMM_PATHS or (path == "wgmma" and K % 64):
        raise ValueError(f"no path {path!r} for K {K} (one of "
                         f"{list(GEMM_PATHS)}; wgmma needs K % 64 == 0)")
    else:
        splits = 1 if path == "wgmma" else _splitk_splits(M, N, K, sms)
    if path == "wgmma":
        scratch = torch.empty((K, N), dtype=torch.bfloat16, device=x.device)
    elif splits > 1:
        scratch = torch.empty((splits, M, N), dtype=torch.float32,
                              device=x.device)
    else:
        scratch = None
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    cb.launch(_lib().aries_quant_matmul, x, "W8A16 GEMM", cb.ptr(x),
              cb.ptr(q), cb.ptr(s), cb.ptr(out),
              int(out_dtype == torch.bfloat16), M, N, K, GEMM_PATHS[path],
              splits, cb.ptr(scratch) if scratch is not None else None)
    quant_matmul_dequant_kernel.launches += 1
    quant_matmul_dequant_kernel.launches_by_path[path] += 1
    return out


quant_matmul_dequant_kernel.launches = 0
quant_matmul_dequant_kernel.launches_by_path = dict.fromkeys(GEMM_PATHS, 0)


def quant_matmul_dequant(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
                         ) -> torch.Tensor:
    """x (M, K) -> (M, N) in x.dtype by the weight-side dequant product:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if not x.is_cuda:
        return quant_matmul_dequant_plain(x, q, s, x.dtype)
    out_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    y = quant_matmul_dequant_kernel(x.to(torch.bfloat16).contiguous(), q, s,
                                    out_dtype)
    return y.to(x.dtype)


def _quant_matmul_outscale(x: torch.Tensor, q: torch.Tensor,
                           s: torch.Tensor) -> torch.Tensor:
    """bf16 x int8 products are exact in f32, so the f32 product of the
    bf16-rounded activations and the int8 values is the bf16 GEMM with f32
    accumulation; the scale goes on the f32 result."""
    y = torch.matmul(x.to(torch.bfloat16).float(), q.float())
    return y * s.float()


def _quant_matmul_xla(x: torch.Tensor, q: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """Weights dequantized in x's dtype (a bf16 product rounds), then the
    product with f32 sums."""
    w = q.to(x.dtype) * s.to(x.dtype)[None, :]
    return torch.matmul(x.float(), w.float())


def quant_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
                 ) -> torch.Tensor:
    """(..., K) @ int8 (K, N) with per-N scales -> (..., N) in x.dtype, by
    the implementation ``ARIES_QUANT_IMPL`` names (module docstring)."""
    impl = os.environ.get("ARIES_QUANT_IMPL", "outscale")
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if impl == "native":
        raise NotImplementedError(
            "ARIES_QUANT_IMPL=native (s8 x s8 -> s32) is not ported yet")
    if impl == "outscale":
        y = _quant_matmul_outscale(x2, q, s)
    elif impl == "pallas":
        y = quant_matmul_dequant(x2, q, s)
    else:
        y = _quant_matmul_xla(x2, q, s)
    return y.reshape(*lead, q.shape[1]).to(x.dtype)


_DENSE_KEYS = ("q", "k", "v", "o", "fc1", "fc2")


def _quantize_dense(p: Dict[str, Any]) -> Dict[str, Any]:
    qv, sv = quantize_int8(p["w"])
    out = {"q": qv, "s": sv}
    if p.get("b") is not None:
        out["b"] = p["b"]
    return out


def quantize_model_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize every transformer dense layer of a Whisper param tree.

    Conv stems, layer norms, embeddings and biases keep their dtype."""

    def convert_block(block: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(block)
        for key in ("attn", "cross", "mlp"):
            if key in block:
                out[key] = {
                    k: _quantize_dense(v) if k in _DENSE_KEYS else v
                    for k, v in block[key].items()
                }
        return out

    out = dict(params)
    for part in ("encoder", "decoder"):
        if part in params and "blocks" in params[part]:
            out[part] = dict(params[part])
            out[part]["blocks"] = convert_block(params[part]["blocks"])
    return out
