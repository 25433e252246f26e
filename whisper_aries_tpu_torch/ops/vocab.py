"""The vocab product of a decode step (csrc/vocab_gemm.cu).

``vocab_product(x, emb)``: logits (M, V) f32 = x (M, K) . emb (V, K)^T,
the tied token embedding as the model holds it, products exact in f32 and
summed in f32: the JAX package's ``jnp.dot(x, emb.T,
preferred_element_type=f32)`` (models/whisper.py:510), which XLA fuses
with the embedding's read. For bf16 CUDA operands it launches the kernel,
which streams the bf16 embedding once a pass of up to 64 rows; the plain
version, ``x.float() @ emb.float().T`` (an f32 copy of the embedding, then
an f32 GEMM), runs for CPU operands only. Decoding calls it through
``models/whisper.py::vocab_logits_step``; training and the teacher-forced
passes keep ``vocab_logits``, which autograd differentiates.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from whisper_aries_tpu_torch.ops import cuda_build as cb

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cb.library("vocab_gemm")
    lib.aries_vocab_gemm.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    lib.aries_vocab_gemm.restype = ctypes.c_int
    lib.aries_vocab_gemm_plan.argtypes = [_I, _I, _I, _I,
                                          ctypes.POINTER(_I)]
    lib.aries_vocab_gemm_plan.restype = ctypes.c_int
    return lib


def vocab_product_plain(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """(M, K) x (V, K) -> (M, V) f32 in torch ops."""
    return torch.matmul(x.float(), emb.float().T)


def vocab_plan(device, M: int, V: int, K: int) -> dict:
    """The kernel's plan on ``device``'s card: blocks, rows a pass, passes,
    ring stages and shared bytes of the first pass (the C plan)."""
    out = (_I * 5)()
    cb.check(_lib().aries_vocab_gemm_plan(M, V, K, cb.sm_count(device),
                                          out), "vocab product plan")
    return dict(zip(("blocks", "rows", "passes", "stages", "smem"), out))


def vocab_product_kernel(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """The kernel: x (M, K) and emb (V, K) bf16 on one card, contiguous,
    K % 64 == 0."""
    M, K = x.shape
    V = emb.shape[0]
    cb.require(x, "x", torch.bfloat16)
    cb.require(emb, "emb", torch.bfloat16, (V, K), x.device)
    if K % 64 or x.data_ptr() % 16 or emb.data_ptr() % 16:
        raise ValueError("the vocab kernel needs K % 64 == 0 and 16-byte "
                         "aligned operands")
    out = torch.empty((M, V), dtype=torch.float32, device=x.device)
    cb.launch(_lib().aries_vocab_gemm, x, "vocab product", cb.ptr(x),
              cb.ptr(emb), cb.ptr(out), M, V, K, cb.sm_count(x))
    cb.count(vocab_product_kernel)
    return out


vocab_product_kernel.launches = 0


def vocab_product(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """The logits of rows ``x``: the kernel for CUDA operands, the plain
    version for CPU ones."""
    if x.is_cuda:
        return vocab_product_kernel(x, emb)
    return vocab_product_plain(x, emb)
