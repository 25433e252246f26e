"""The vocab product of the decoder (csrc/vocab_gemm.cu).

``vocab_product(x, emb)``: logits (M, V) f32 = x (M, K) . emb (V, K)^T,
the tied token embedding as the model holds it, products exact in f32 and
summed in f32: the JAX package's ``jnp.dot(x, emb.T,
preferred_element_type=f32)`` (models/whisper.py:510), which XLA fuses
with the embedding's read. For bf16 CUDA operands it launches the kernel by
one of two paths, ``vocab_plan`` picking by M: "passes" for a decode step's
rows (the bf16 embedding streamed once a pass of up to 64 rows), "tiles"
above the cut-over (a persistent TMA + wgmma GEMM of 128-row tiles: the
teacher-forced passes, the word pass, larger prefills). The plain version,
``x.float() @ emb.float().T`` (an f32 copy of the embedding, then an f32
GEMM), runs for CPU operands only. f32 CUDA operands (``compute_type
"f32"``) take the counted path "f32", ``vocab_product_f32``: one f32
library product with TF32 off, as the JAX package computes this product
as a plain XLA dot at f32; the kernel itself takes bf16 only. Operands of
mixed or other dtypes raise. Every product without a gradient calls
it through ``models/whisper.py::vocab_logits_step`` (decoding, language
detection, the word pass, the smoke test); only a product autograd must
differentiate (training) keeps ``vocab_logits``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.utils.device import no_tf32

_P, _I = ctypes.c_void_p, ctypes.c_int

#: the kernel's paths, in the C entry's numbering
PATHS = ("passes", "tiles")
#: M above which the plan takes "tiles" (csrc/vocab_gemm.cu's
#: VG_TILES_ABOVE, mirrored so a launch needs no call to the C plan)
TILES_ABOVE = 64


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cb.library("vocab_gemm")
    lib.aries_vocab_gemm.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.aries_vocab_gemm.restype = ctypes.c_int
    lib.aries_vocab_gemm_plan.argtypes = [_I, _I, _I, _I, _I,
                                          ctypes.POINTER(_I)]
    lib.aries_vocab_gemm_plan.restype = ctypes.c_int
    return lib


def vocab_product_plain(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """(M, K) x (V, K) -> (M, V) f32 in torch ops."""
    return torch.matmul(x.float(), emb.float().T)


def vocab_plan(device, M: int, V: int, K: int) -> dict:
    """The kernel's plan on ``device``'s card (the C plan): the path M
    takes, its blocks, ring stages and shared bytes a block, and for
    "passes" rows a pass and passes, for "tiles" the tile ("128x256"), M
    tiles and tiles."""
    out = (_I * 8)()
    cb.check(_lib().aries_vocab_gemm_plan(M, V, K, cb.sm_count(device), -1,
                                          out), "vocab product plan")
    plan = dict(path=PATHS[out[0]], blocks=out[1], stages=out[4],
                smem=out[5])
    if plan["path"] == "tiles":
        plan.update(tile=f"{out[2]}x{out[6]}", m_tiles=out[3], tiles=out[7])
    else:
        plan.update(rows=out[2], passes=out[3])
    return plan


def _path_code(path: Optional[str]) -> int:
    if path is None:
        return -1
    if path not in PATHS:
        raise ValueError(f"no vocab path {path!r} (one of {list(PATHS)})")
    return PATHS.index(path)


def vocab_product_kernel(x: torch.Tensor, emb: torch.Tensor,
                         path: Optional[str] = None) -> torch.Tensor:
    """The kernel: x (M, K) and emb (V, K) bf16 on one card, contiguous,
    K % 64 == 0, by the path ``vocab_plan`` picks (``path`` names one
    instead: the crossover measurement). Counts ``launches`` and
    ``launches_by_path``."""
    M, K = x.shape
    V = emb.shape[0]
    cb.require(x, "x", torch.bfloat16)
    cb.require(emb, "emb", torch.bfloat16, (V, K), x.device)
    if K % 64 or x.data_ptr() % 16 or emb.data_ptr() % 16:
        raise ValueError("the vocab kernel needs K % 64 == 0 and 16-byte "
                         "aligned operands")
    sms = cb.sm_count(x)
    if path is None:
        path = "tiles" if M > TILES_ABOVE else "passes"
    code = _path_code(path)
    out = torch.empty((M, V), dtype=torch.float32, device=x.device)
    cb.launch(_lib().aries_vocab_gemm, x, "vocab product", cb.ptr(x),
              cb.ptr(emb), cb.ptr(out), M, V, K, sms, code)
    cb.count(vocab_product_kernel, path=path)
    return out


vocab_product_kernel.launches = 0
vocab_product_kernel.launches_by_path = dict.fromkeys(PATHS, 0)


def vocab_product_f32(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """The "f32" path: x (M, K) and emb (V, K) f32 on one card -> (M, V)
    f32 as one library product (``torch.matmul``, TF32 off: exact f32
    products and sums). Counts ``launches`` (a call, inside a graph capture
    to the capture's record)."""
    M, K = x.shape
    cb.require(x, "x", torch.float32)
    cb.require(emb, "emb", torch.float32, (emb.shape[0], K), x.device)
    with no_tf32():
        out = torch.matmul(x, emb.T)
    cb.count(vocab_product_f32)
    return out


vocab_product_f32.launches = 0


def launches_by_path() -> dict:
    """The card's vocab products by path: the kernel's "passes" and
    "tiles", and the f32 library path."""
    return dict(vocab_product_kernel.launches_by_path,
                f32=vocab_product_f32.launches)


def vocab_product(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """The logits of rows ``x``: the plain version for CPU operands; on the
    card, by dtype, the kernel for bf16 operands and the "f32" path for f32
    ones. Mixed or other dtypes raise: nothing is cast here."""
    if not x.is_cuda:
        return vocab_product_plain(x, emb)
    if x.dtype == emb.dtype == torch.bfloat16:
        return vocab_product_kernel(x, emb)
    if x.dtype == emb.dtype == torch.float32:
        return vocab_product_f32(x, emb)
    raise ValueError(f"vocab product: x {x.dtype} and embedding {emb.dtype} "
                     "must both be bf16 (the kernel) or both f32")
