"""int8 weight quantization (the CTranslate2-equivalent compute path).

The same grid as the JAX package's ops/quant.py: per-output-channel
symmetric absmax scales, values rounded half to even and clipped to
[-127, 127]. A quantized dense layer is {"q": int8 (K, N), "s": f32 (N,),
"b": optional bias}; ``models.layers.dense`` dispatches on "q".

``quant_matmul`` is the plain "outscale" product the JAX package uses by
default (``_quant_matmul_outscale``): bf16 activations times the int8
values (exact in bf16), f32 accumulation, the per-channel scale applied to
the f32 result, then a cast to the activation dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K, N) float weights -> (int8 values (..., K, N), f32 scales
    (..., N)). Leading dims (e.g. the stacked-layer axis) are preserved."""
    w = w.float()
    absmax = w.abs().amax(dim=-2)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127)
    return q.to(torch.int8), scale


def quant_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
                 ) -> torch.Tensor:
    """(..., K) @ int8 (K, N) with per-N scales -> (..., N) in x.dtype.

    bf16 x int8 products are exact in f32, so the f32 product of the
    bf16-rounded activations and the int8 values is the bf16 GEMM with f32
    accumulation."""
    y = torch.matmul(x.to(torch.bfloat16).float(), q.float())
    return (y * s.float()).to(x.dtype)


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
