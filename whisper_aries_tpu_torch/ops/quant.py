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
  * "native": CTranslate2's int8 GEMM (the JAX package's
    ``_quant_matmul_int8io``): each activation row quantized to int8 by its
    own absmax scale (an IEEE division by 127, rounded half to even), an
    s8 x s8 -> s32 product, then ``(f32(acc) * sx[m]) * s[n]``. Two
    kernels for CUDA tensors (csrc/int8_gemm.cu: the row quantization, then
    the tensor-core s8 GEMM with the rescale in its epilogue, by
    ``int8_gemm_plan``), ``quant_matmul_int8io_plain`` for CPU tensors.
    The JAX package's jitted function multiplies by 1/127 where it divides
    (XLA's rewrite); the port divides, as the eager JAX function does.
  * "xla" (and any other value, as in JAX): weights dequantized in the
    activation dtype, then the product.
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


def quantize_rows_plain(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) -> (int8 (M, K), f32 scales (M, 1)): each row divided by
    its own max |x| / 127 (1 for a zero row), rounded half to even and
    clipped to [-127, 127]. Both divisions are by tensors: on the card
    PyTorch multiplies by the reciprocal of a host scalar instead."""
    xf = x.float()
    ax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.where(ax > 0, ax / torch.full_like(ax, 127.0),
                     torch.ones_like(ax))
    x8 = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return x8, sx


def quant_matmul_int8io_plain(x: torch.Tensor, q: torch.Tensor,
                              s: torch.Tensor,
                              out_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """x (M, K) @ int8 (K, N) -> (M, N) in ``out_dtype`` by the native
    scheme: the rows quantized (``quantize_rows_plain``), the integer
    product taken in f64 (exact: |acc| <= 127^2 K < 2^53), then
    (f32(acc) * sx) * s, in that order."""
    x8, sx = quantize_rows_plain(x)
    acc = (x8.double() @ q.double()).float()
    return (acc * sx * s.float()).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _int8_lib():
    lib = cb.library("int8_gemm")
    lib.aries_int8_quantize_rows.argtypes = [_P, _I, _P, _P, _I, _I, _P]
    lib.aries_int8_quantize_rows.restype = _I
    lib.aries_int8_gemm.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _P, _P, _P]
    lib.aries_int8_gemm.restype = _I
    return lib


# csrc/int8_gemm.cu's tiling: output columns a block, K rows a stage, the
# row tiles (a warp's m16 tiles, all the block's rows) and the most K slices
INT8_COLS, INT8_KC, INT8_MAX_SPLITS = 128, 32, 16
INT8_ROW_TILES = (16, 32, 64)
# the least 32-row stages a K slice, by the M it serves: a slice's blocks
# run their stages in series, and each slice adds M x N s32 atomics. Set
# from chip_smoke.py's "int8 GEMM plan sweep" on the H100 (PERF.md): at M
# 6-18 about 10 stages a slice were fastest, at M 64 about 40 (fc2's 160
# stages in 4 slices), at M 227 fc2 in 3 slices; from M 1135 one slice.
INT8_STAGES_A_SLICE = ((32, 10), (64, 40), (256, 48))


@functools.lru_cache(maxsize=None)  # a few shapes, called per layer
def int8_gemm_plan(M: int, N: int, K: int) -> Tuple[int, int]:
    """(rows a tile, K slices) of the native GEMM for an (M, K) x (K, N)
    product: the least row tile that holds M (64 above 32), and K / 32
    stages cut into slices of at least INT8_STAGES_A_SLICE's stages for M
    (at most 16 slices; one above M 256)."""
    if M <= 0 or N <= 0 or K <= 0 or K % INT8_KC or N % 16:
        raise ValueError(f"the int8 GEMM kernel needs K % 32 == 0 and "
                         f"N % 16 == 0, got M {M}, K {K}, N {N}")
    rows = next((r for r in INT8_ROW_TILES if M <= r), INT8_ROW_TILES[-1])
    per = next((n for m, n in INT8_STAGES_A_SLICE if M <= m), None)
    splits = 1 if per is None else min(INT8_MAX_SPLITS, K // INT8_KC // per)
    return rows, max(1, splits)


def _aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def quantize_rows_kernel(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row quantization kernel (csrc/int8_gemm.cu): x (M, K) bf16 or
    f32, a contiguous 16-byte aligned CUDA tensor with K % 32 == 0 ->
    (int8 (M, K), f32 (M, 1)), bit for bit ``quantize_rows_plain``. Other
    shapes raise. Counts ``launches``."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bf16 or f32, got {x.dtype}")
    cb.require(x, "x", x.dtype)
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] % INT8_KC:
        raise ValueError(f"the row quantization kernel needs x (M, K) with "
                         f"K % 32 == 0, got {tuple(x.shape)}")
    _aligned(x=x)
    M, K = x.shape
    x8 = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    cb.launch(_int8_lib().aries_int8_quantize_rows, x,
              "int8 row quantization", cb.ptr(x),
              int(x.dtype == torch.bfloat16), cb.ptr(x8), cb.ptr(sx), M, K)
    cb.count(quantize_rows_kernel)
    return x8, sx


quantize_rows_kernel.launches = 0


def quant_matmul_int8io_kernel(x8: torch.Tensor, sx: torch.Tensor,
                               q: torch.Tensor, s: torch.Tensor,
                               out_dtype: torch.dtype = torch.bfloat16,
                               plan: Optional[Tuple[int, int]] = None
                               ) -> torch.Tensor:
    """The s8 GEMM kernel (csrc/int8_gemm.cu): x8 (M, K) int8 with its row
    scales sx (M, 1) f32, q (K, N) int8, s (N,) f32, contiguous CUDA
    tensors with K % 32 == 0 and N % 16 == 0 -> (f32(x8 @ q) * sx) * s,
    (M, N) in bf16 or f32, by the tiling ``int8_gemm_plan`` picks (``plan``
    names one instead, (rows, K slices): the sweep the plan is set from).
    Other shapes raise. Counts ``launches``."""
    cb.require(x8, "x8", torch.int8)
    if x8.dim() != 2 or q.dim() != 2 or q.shape[0] != x8.shape[1]:
        raise ValueError(f"x8 (M, K) and q (K, N) do not match: "
                         f"{tuple(x8.shape)}, {tuple(q.shape)}")
    (M, K), N = x8.shape, q.shape[1]
    cb.require(sx, "sx", torch.float32, (M, 1), x8.device)
    cb.require(q, "q", torch.int8, (K, N), x8.device)
    cb.require(s, "s", torch.float32, (N,), x8.device)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("the kernel writes bf16 or f32")
    rows, splits = int8_gemm_plan(M, N, K)  # raises on other shapes
    if plan is not None:
        rows, splits = plan
        if rows not in INT8_ROW_TILES or not (
                1 <= splits <= min(INT8_MAX_SPLITS, K // INT8_KC)):
            raise ValueError(f"no plan {plan} for K {K}: rows one of "
                             f"{INT8_ROW_TILES}, 1 to {INT8_MAX_SPLITS} "
                             "slices of at least 32 K rows")
    _aligned(x8=x8, q=q, s=s)
    out = torch.empty((M, N), dtype=out_dtype, device=x8.device)
    acc = arrived = None
    if splits > 1:  # the slices' s32 sums and each tile's arrivals
        acc = torch.zeros((M, N), dtype=torch.int32, device=x8.device)
        arrived = torch.zeros(-(-M // rows) * -(-N // INT8_COLS),
                              dtype=torch.int32, device=x8.device)
    cb.launch(_int8_lib().aries_int8_gemm, x8, "int8 GEMM", cb.ptr(x8),
              cb.ptr(sx), cb.ptr(q), cb.ptr(s), cb.ptr(out),
              int(out_dtype == torch.bfloat16), M, N, K, rows, splits,
              cb.ptr(acc) if acc is not None else None,
              cb.ptr(arrived) if arrived is not None else None)
    cb.count(quant_matmul_int8io_kernel)
    return out


quant_matmul_int8io_kernel.launches = 0


def quant_matmul_int8io(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
                        ) -> torch.Tensor:
    """x (M, K) -> (M, N) in x.dtype by the native scheme: the two kernels
    for CUDA tensors (bf16 activations give a bf16 output, others f32),
    the plain version for CPU tensors."""
    if not x.is_cuda:
        return quant_matmul_int8io_plain(x, q, s, x.dtype)
    xk = x if x.dtype in (torch.bfloat16, torch.float32) else x.float()
    x8, sx = quantize_rows_kernel(xk.contiguous())
    out_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    return quant_matmul_int8io_kernel(x8, sx, q, s, out_dtype).to(x.dtype)


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
        y = quant_matmul_int8io(x2, q, s)
    elif impl == "outscale":
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
