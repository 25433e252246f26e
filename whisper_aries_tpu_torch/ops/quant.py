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
    GEMM kernel (csrc/quant_matmul.cu; TMA + wgmma for large M, a cluster
    split-K weight stream for small M, by ``gemm_plan``) for CUDA tensors,
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


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 (..., K, N) x f32 scales (..., N) -> weights in ``dtype``: the
    f32 product, then the cast."""
    return (q.float() * scale[..., None, :].float()).to(dtype)


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
    lib.aries_quant_matmul_plan.argtypes = [_I, _I, _I, _I, _P]
    lib.aries_quant_matmul_plan.restype = _I
    return lib


# The kernel's two paths (csrc/quant_matmul.cu), by their C codes.
GEMM_PATHS = {"splitk": 0, "wgmma": 1}
# The smallest M x N sent to the TMA + wgmma path. Measured on the H100
# against the split-K cluster path (chip_smoke.py's "quant_matmul
# crossover" line, PERF.md): split-K is faster up to M 128 at N 1280, the
# two are within 5% at M 64 for N 3840 and 5120 (K 1280), and wgmma is
# faster from M 192, 128 and 128.
WGMMA_MIN_MN = 192 * 1280
# the "splitk" path's constants (csrc/quant_matmul.cu, S_*): output columns
# a block, K rows a ring stage, ring stages, bytes a staged weight row, the
# largest cluster, blocks an SM aimed at, rows a pass, shared-memory limit
SPLITK_COLS, SPLITK_KC, SPLITK_NST, SPLITK_WLD = 64, 32, 16, 80
SPLITK_MAX_CLUSTER, SPLITK_TARGET_WAVES = 8, 2
SPLITK_MAX_ROWS, SPLITK_MAX_SMEM = 64, 232448
WGMMA_ROWS = 128  # the "wgmma" path's rows an output tile


def splitk_smem(rows: int, kslice: int, S: int) -> int:
    """Shared memory of a "splitk" block: the weight ring, ``rows`` staged
    x rows of a K slice (16 bytes of pad each) and, for a cluster, the
    partial sums its pairs receive."""
    ring = SPLITK_NST * SPLITK_KC * SPLITK_WLD
    red = (rows * SPLITK_COLS + 16) * 4 if S > 1 else 0
    return ring + rows * (2 * kslice + 16) + red


def splitk_plan(M: int, N: int, K: int, sms: int) -> Tuple[int, int]:
    """(cluster size S, rows a pass) of the "splitk" path, as the C plan
    (csrc/quant_matmul.cu, splitk_plan): S is the least divisor s <= 8 of
    K / 32 giving ceil(N / 64) x s >= 2 x sms blocks, else the largest such
    divisor, so each K slice is a whole number of 32-row stages; the rows a
    pass are M rounded up to 8, at most 64, fewer while a block's shared
    memory would pass the opt-in limit. Raises where not even 8 rows fit."""
    if M <= 0 or K % SPLITK_KC or N % 16 or N <= 0:
        raise ValueError(f"no split-K plan for M {M}, N {N}, K {K}")
    cols, units = -(-N // SPLITK_COLS), K // SPLITK_KC
    S = 1
    for s in range(1, SPLITK_MAX_CLUSTER + 1):
        if units % s:
            continue
        S = s
        if cols * s >= SPLITK_TARGET_WAVES * sms:
            break
    rows = min(SPLITK_MAX_ROWS, -(-M // 8) * 8)
    while rows > 8 and splitk_smem(rows, K // S, S) > SPLITK_MAX_SMEM:
        rows -= 8
    if splitk_smem(rows, K // S, S) > SPLITK_MAX_SMEM:
        raise ValueError(f"K {K} is too deep for the split-K path: a "
                         f"{K // S}-row slice of x does not fit")
    return S, rows


@functools.lru_cache(maxsize=None)  # a few shapes, called per layer
def gemm_plan(M: int, N: int, K: int, sms: int) -> Tuple[str, int, int]:
    """(path, K slices, rows an output tile) for an (M, K) x (K, N) product
    on a card with ``sms`` SMs: "wgmma" (TMA + wgmma, one slice, 128-row
    tiles) from WGMMA_MIN_MN output elements up when K % 64 == 0, else
    "splitk" (one launch: the K slices of a column tile one cluster,
    ``splitk_plan``)."""
    if M * N >= WGMMA_MIN_MN and K % 64 == 0:
        return "wgmma", 1, WGMMA_ROWS
    return ("splitk",) + splitk_plan(M, N, K, sms)


def kernel_splitk_plan(M: int, N: int, K: int, sms: int) -> Tuple[int, int]:
    """The C plan of the "splitk" path (the card check of
    ``splitk_plan``)."""
    out = (ctypes.c_int * 2)()
    cb.check(_lib().aries_quant_matmul_plan(M, N, K, sms, out),
             "W8A16 GEMM plan")
    return out[0], out[1]


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
        path = gemm_plan(M, N, K, sms)[0]
    elif path not in GEMM_PATHS or (path == "wgmma" and K % 64):
        raise ValueError(f"no path {path!r} for K {K} (one of "
                         f"{list(GEMM_PATHS)}; wgmma needs K % 64 == 0)")
    elif path == "splitk":
        splitk_plan(M, N, K, sms)  # raises where x's slice cannot fit
    scratch = (torch.empty((K, N), dtype=torch.bfloat16, device=x.device)
               if path == "wgmma" else None)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    cb.launch(_lib().aries_quant_matmul, x, "W8A16 GEMM", cb.ptr(x),
              cb.ptr(q), cb.ptr(s), cb.ptr(out),
              int(out_dtype == torch.bfloat16), M, N, K, GEMM_PATHS[path],
              sms, cb.ptr(scratch) if scratch is not None else None)
    cb.count(quant_matmul_dequant_kernel, path=path)
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
