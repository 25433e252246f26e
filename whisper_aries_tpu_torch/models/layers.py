"""Shared neural-net building blocks (plain functions on parameter dicts).

A dense layer is the dict {"w": (K, N), "b": optional (N,)} — or its
int8-quantized form {"q": int8 (K, N), "s": f32 (N,), "b": optional},
produced by ops.quant.quantize_model_params. ``dense`` dispatches on the
presence of "q", as the JAX package's layers module does.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def dense(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ layer params -> (..., N), in x.dtype. The bias is added
    after the cast to x.dtype."""
    if "q" in p:
        from whisper_aries_tpu_torch.ops.quant import quant_matmul

        y = quant_matmul(x, p["q"], p["s"])
    else:
        y = torch.matmul(x, p["w"].to(x.dtype))
    b = p.get("b")
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def layer_norm(p: Dict[str, Any], x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32 (bf16-safe)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def attn_scale(dh: int) -> float:
    """1/sqrt(dh) rounded to f32, as JAX uses it. A Python float would be
    applied in double on the CPU and differ from JAX in the last bit."""
    return float(np.float32(1.0 / np.sqrt(dh)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GeLU."""
    return torch.nn.functional.gelu(x, approximate="none")
