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
    s8 x s8 -> s32 product, then ``(f32(acc) * sx[m]) * s[n]``. For CUDA
    tensors csrc/int8_gemm.cu, by the path ``int8_gemm_plan`` picks from M:
    "wgmma" at large M (the encoder's windows x 1500; bound: operations),
    a preparation launch (the rows quantized, the weights transposed into
    a K-major scratch, made again each call: the weights keep one copy)
    and a TMA + s8 wgmma GEMM with the rescale in its epilogue; "cluster"
    at small M (a decode step's rows; bound: the weights' bytes), one
    launch a product, the K slices of a column tile one thread-block
    cluster that exchanges its slices' row maxima in shared memory,
    quantizes x itself and sums its s32 partials in the owning block.
    ``quant_matmul_int8io_plain`` for CPU tensors. The JAX package's
    jitted function multiplies by 1/127 where it divides (XLA's rewrite);
    the port divides, as the eager JAX function does.
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
    lib.aries_int8_prepare.argtypes = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P]
    lib.aries_int8_prepare.restype = _I
    lib.aries_int8_gemm_wgmma.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                          _I, _I, _P]
    lib.aries_int8_gemm_wgmma.restype = _I
    lib.aries_int8_gemm_cluster.argtypes = [_P, _I, _P, _P, _P, _I, _I, _I,
                                            _I, _I, _I, _P]
    lib.aries_int8_gemm_cluster.restype = _I
    lib.aries_int8_cluster_smem.argtypes = [_I, _I, _I, _I]
    lib.aries_int8_cluster_smem.restype = _I
    return lib


# csrc/int8_gemm.cu's constants: the "cluster" path's output columns a
# block, K rows a ring stage, the most ring stages and a stage's bytes (32
# rows x 80), the largest cluster, the most rows a pass and a block's
# shared-memory limit; the "wgmma" path's rows a tile
INT8_COLS, INT8_KC, INT8_NST, INT8_STAGE = 64, 32, 16, 32 * 80
INT8_MAX_CLUSTER, INT8_MAX_ROWS, INT8_MAX_SMEM = 8, 64, 232448
INT8_WGMMA_ROWS = 128
#: each path's tiles: "wgmma" a 128-row output tile of 128 or 256
#: columns; "cluster" 64 columns a block (its K slice set by S)
INT8_TILES = {"wgmma": ("128x128", "128x256"), "cluster": ("64",)}
#: the plan's choices (chip_smoke.py's "int8 GEMM plan sweep", PERF.md):
#: the cluster path takes every product up to INT8_CLUSTER_ANY_M rows and
#: those with N <= K up to INT8_CLUSTER_MAX_M (on the H100 at M 18, o and
#: fc2 ran faster on it and qkv and fc1 on the wgmma path; at M 32 the
#: wgmma path beat it at the plan's S); its blocks an SM aimed at
INT8_CLUSTER_ANY_M, INT8_CLUSTER_MAX_M = 8, 24
INT8_TARGET_WAVES = 2


def int8_wgmma_tile(M: int, N: int, sms: int) -> str:
    """The wgmma path's tile: 128 x 256 where its tiles give each of the
    ``sms`` SMs one and a half, else 128 x 128 (twice the tiles: on 132
    SMs the wide tile's 135 and 180 tiles at M 1135 were about 10% slower,
    its 250 at M 6400 and 355 at M 9000 4-8% faster)."""
    wide = -(-M // INT8_WGMMA_ROWS) * -(-N // 256)
    return "128x256" if 2 * wide >= 3 * sms else "128x128"


def int8_cluster_smem(rows: int, kslice: int, S: int,
                      x_bytes: int = 2) -> int:
    """Shared memory of a "cluster" block (csrc/int8_gemm.cu,
    cluster_smem): the weight ring (a stage for each 32 rows of the K
    slice, at most 16), ``rows`` rows of its K slice of x as they lie
    (``x_bytes`` a value) and as s8 (16 bytes of pad each), its units' 2 S
    partials (16 bytes a unit), the S ranks' row maxima and the rows'
    scales and their reciprocals."""
    per = -(-rows * (INT8_COLS // 4) // S)
    ring = min(kslice // INT8_KC, INT8_NST) * INT8_STAGE
    return (ring + rows * kslice * x_bytes + rows * (kslice + 16)
            + 2 * S * per * 16 + S * rows * 4 + rows * 8)


def int8_cluster_size(N: int, K: int, sms: int) -> int:
    """The "cluster" path's cluster size S for (K, N) on ``sms`` SMs: the
    least divisor s <= 8 of K / 32 giving ceil(N / 64) x s >= 2 x sms
    blocks, else the largest such divisor (kernel 5's split-K rule), so
    each K slice is a whole number of 32-row stages."""
    cols, units = -(-N // INT8_COLS), K // INT8_KC
    S = 1
    for s in range(1, INT8_MAX_CLUSTER + 1):
        if units % s:
            continue
        S = s
        if cols * s >= INT8_TARGET_WAVES * sms:
            break
    return S


def int8_cluster_rows(M: int, K: int, S: int, x_bytes: int = 2) -> int:
    """Rows a pass of the "cluster" path for x of ``x_bytes`` a value: M
    rounded up to a group of 8 (the mma's n8 operand), at most 64, fewer
    while a block's shared memory would pass the opt-in limit. Raises
    where not even one group fits (a bf16 K slice of about 3,400 or
    more)."""
    rows = min(INT8_MAX_ROWS, -(-M // 8) * 8)
    while rows > 8 and int8_cluster_smem(rows, K // S, S,
                                         x_bytes) > INT8_MAX_SMEM:
        rows -= 8
    if int8_cluster_smem(rows, K // S, S, x_bytes) > INT8_MAX_SMEM:
        raise ValueError(f"K {K} is too deep for the cluster path at S {S}: "
                         f"a {K // S}-row slice of x does not fit")
    return rows


def _int8_shape(M: int, N: int, K: int) -> None:
    if M <= 0 or N <= 0 or K <= 0 or K % INT8_KC or N % 16:
        raise ValueError(f"the int8 GEMM kernels need K % 32 == 0 and "
                         f"N % 16 == 0, got M {M}, K {K}, N {N}")
    if -(-M // INT8_WGMMA_ROWS) > 65535:
        raise ValueError(f"M {M} passes the wgmma grid's 65,535 row tiles")


@functools.lru_cache(maxsize=None)  # a few shapes, called per layer
def int8_gemm_plan(M: int, N: int, K: int, sms: int, x_bytes: int = 2
                   ) -> Tuple[str, str, int]:
    """(path, tile, cluster size S) of the native GEMM for an (M, K) x
    (K, N) product of x with ``x_bytes`` a value (bf16 2, f32 4) on a card
    with ``sms`` SMs: "cluster" (one launch, the row quantization inside,
    S from ``int8_cluster_size``) up to M INT8_CLUSTER_ANY_M, and up to
    INT8_CLUSTER_MAX_M where N <= K, where a row group of the K slice
    fits; else "wgmma" (the preparation launch and
    the TMA + wgmma GEMM, S 1, the tile from ``int8_wgmma_tile``). Raises
    on shapes the kernels do not take."""
    _int8_shape(M, N, K)
    if M <= INT8_CLUSTER_ANY_M or (M <= INT8_CLUSTER_MAX_M and N <= K):
        S = int8_cluster_size(N, K, sms)
        try:
            int8_cluster_rows(M, K, S, x_bytes)
            return "cluster", INT8_TILES["cluster"][0], S
        except ValueError:
            pass  # the slice is too deep: the wgmma path takes any K
    return "wgmma", int8_wgmma_tile(M, N, sms), 1


def _aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _activations(x: torch.Tensor) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bf16 or f32, got {x.dtype}")
    cb.require(x, "x", x.dtype)
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")


def _weights(q: torch.Tensor, K: int, device: torch.device) -> int:
    if q.dim() != 2 or q.shape[0] != K:
        raise ValueError(f"q must be ({K}, N), got {tuple(q.shape)}")
    cb.require(q, "q", torch.int8, device=device)
    return q.shape[1]


def int8_prepare_kernel(x: torch.Tensor, q: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The "wgmma" path's preparation launch (csrc/int8_gemm.cu,
    prepare_kernel): x (M, K) bf16 or f32 and q (K, N) int8, contiguous
    16-byte aligned CUDA tensors with K % 32 == 0 and N % 16 == 0 ->
    (x8 (M, K) int8, sx (M, 1) f32, qt (N, K) int8): ``quantize_rows_plain``
    and ``q.t().contiguous()`` bit for bit. Other shapes raise. Counts
    ``launches``."""
    _activations(x)
    M, K = x.shape
    N = _weights(q, K, x.device)
    _int8_shape(M, N, K)
    _aligned(x=x, q=q)
    x8 = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    qt = torch.empty((N, K), dtype=torch.int8, device=x.device)
    cb.launch(_int8_lib().aries_int8_prepare, x, "int8 GEMM preparation",
              cb.ptr(x), int(x.dtype == torch.bfloat16), cb.ptr(x8),
              cb.ptr(sx), cb.ptr(q), cb.ptr(qt), M, N, K)
    cb.count(int8_prepare_kernel)
    return x8, sx, qt


int8_prepare_kernel.launches = 0


def _out_dtype(out_dtype: torch.dtype) -> None:
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("the kernel writes bf16 or f32")


def int8_gemm_wgmma_kernel(x8: torch.Tensor, sx: torch.Tensor,
                           qt: torch.Tensor, s: torch.Tensor,
                           out_dtype: torch.dtype = torch.bfloat16,
                           tile: Optional[str] = None) -> torch.Tensor:
    """The "wgmma" path's GEMM (csrc/int8_gemm.cu, wgmma_kernel): x8 (M, K)
    int8 with its row scales sx (M, 1) f32, qt (N, K) int8 (the weights
    K-major, from ``int8_prepare_kernel``), s (N,) f32, contiguous 16-byte
    aligned CUDA tensors with K % 32 == 0 and N % 16 == 0 -> (f32(x8 qt^T)
    * sx) * s, (M, N) in bf16 or f32, by the plan's tile (``tile`` names
    one of INT8_TILES["wgmma"] instead: the sweep). Other shapes raise.
    Counts ``launches``."""
    cb.require(x8, "x8", torch.int8)
    if x8.dim() != 2 or qt.dim() != 2 or qt.shape[1] != x8.shape[1]:
        raise ValueError(f"x8 (M, K) and qt (N, K) do not match: "
                         f"{tuple(x8.shape)}, {tuple(qt.shape)}")
    (M, K), N = x8.shape, qt.shape[0]
    cb.require(sx, "sx", torch.float32, (M, 1), x8.device)
    cb.require(qt, "qt", torch.int8, (N, K), x8.device)
    cb.require(s, "s", torch.float32, (N,), x8.device)
    _out_dtype(out_dtype)
    _int8_shape(M, N, K)
    if tile is None:
        tile = int8_wgmma_tile(M, N, cb.sm_count(x8))
    if tile not in INT8_TILES["wgmma"]:
        raise ValueError(f"no wgmma tile {tile!r}: one of "
                         f"{INT8_TILES['wgmma']}")
    _aligned(x8=x8, sx=sx, qt=qt, s=s)
    out = torch.empty((M, N), dtype=out_dtype, device=x8.device)
    cb.launch(_int8_lib().aries_int8_gemm_wgmma, x8, "int8 wgmma GEMM",
              cb.ptr(x8), cb.ptr(sx), cb.ptr(qt), cb.ptr(s), cb.ptr(out),
              int(out_dtype == torch.bfloat16), M, N, K,
              int(tile.split("x")[1]), cb.sm_count(x8))
    cb.count(int8_gemm_wgmma_kernel)
    return out


int8_gemm_wgmma_kernel.launches = 0


def int8_gemm_cluster_kernel(x: torch.Tensor, q: torch.Tensor,
                             s: torch.Tensor,
                             out_dtype: torch.dtype = torch.bfloat16,
                             S: Optional[int] = None) -> torch.Tensor:
    """The "cluster" path (csrc/int8_gemm.cu, cluster_kernel): x (M, K)
    bf16 or f32, q (K, N) int8, s (N,) f32, contiguous 16-byte aligned
    CUDA tensors with K % 32 == 0 and N % 16 == 0 -> (M, N) in bf16 or
    f32, ``quant_matmul_int8io_plain`` bit for bit, in one launch (the row
    quantization inside), by the plan's cluster size S (``S`` names
    another instead: the sweep; it must divide K / 32, at most 8). Other
    shapes raise. Counts ``launches``."""
    _activations(x)
    M, K = x.shape
    N = _weights(q, K, x.device)
    cb.require(s, "s", torch.float32, (N,), x.device)
    _out_dtype(out_dtype)
    _int8_shape(M, N, K)
    S = int8_cluster_size(N, K, cb.sm_count(x)) if S is None else S
    if not (1 <= S <= INT8_MAX_CLUSTER and (K // INT8_KC) % S == 0):
        raise ValueError(f"no cluster plan at S {S} for K {K}: S 1 to "
                         f"{INT8_MAX_CLUSTER} dividing K / 32")
    rows = int8_cluster_rows(M, K, S, x.element_size())  # or raises
    _aligned(x=x, q=q, s=s)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    cb.launch(_int8_lib().aries_int8_gemm_cluster, x, "int8 cluster GEMM",
              cb.ptr(x), int(x.dtype == torch.bfloat16), cb.ptr(q),
              cb.ptr(s), cb.ptr(out), int(out_dtype == torch.bfloat16), M,
              N, K, S, rows)
    cb.count(int8_gemm_cluster_kernel)
    return out


int8_gemm_cluster_kernel.launches = 0


def kernel_cluster_smem(rows: int, kslice: int, S: int,
                        x_bytes: int = 2) -> int:
    """The C side's shared memory of a "cluster" block (the card check of
    ``int8_cluster_smem``)."""
    return int(_int8_lib().aries_int8_cluster_smem(rows, kslice, S,
                                                   x_bytes))


def quant_matmul_int8io_kernel(x: torch.Tensor, q: torch.Tensor,
                               s: torch.Tensor,
                               out_dtype: torch.dtype = torch.bfloat16,
                               plan: Optional[Tuple[str, str, int]] = None
                               ) -> torch.Tensor:
    """The native GEMM on CUDA tensors, x (M, K) bf16 or f32, q (K, N)
    int8, s (N,) f32 -> (M, N) in bf16 or f32, ``quant_matmul_int8io_plain``
    bit for bit, by ``int8_gemm_plan``'s (path, tile, S) (``plan`` names
    one instead). Other shapes raise."""
    _activations(x)
    M, K = x.shape
    N = _weights(q, K, x.device)
    if plan is None:
        _int8_shape(M, N, K)
        plan = int8_gemm_plan(M, N, K, cb.sm_count(x), x.element_size())
    path, tile, S = plan
    if path not in INT8_TILES or tile not in INT8_TILES[path] or (
            path == "wgmma" and S != 1):
        raise ValueError(f"no plan {plan}: ('cluster', '64', S) or "
                         "('wgmma', tile, 1)")
    if path == "cluster":
        return int8_gemm_cluster_kernel(x, q, s, out_dtype, S)
    x8, sx, qt = int8_prepare_kernel(x, q)
    return int8_gemm_wgmma_kernel(x8, sx, qt, s, out_dtype, tile)


def quant_matmul_int8io(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
                        ) -> torch.Tensor:
    """x (M, K) -> (M, N) in x.dtype by the native scheme: the kernels
    for CUDA tensors, by ``int8_gemm_plan`` (bf16 activations give a bf16
    output, others f32), the plain version for CPU tensors."""
    if not x.is_cuda:
        return quant_matmul_int8io_plain(x, q, s, x.dtype)
    xk = x if x.dtype in (torch.bfloat16, torch.float32) else x.float()
    out_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    return quant_matmul_int8io_kernel(xk.contiguous(), q, s,
                                      out_dtype).to(x.dtype)


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
