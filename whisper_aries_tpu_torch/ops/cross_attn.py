"""int8 cross-attention K/V: the per-position grid and the plain attention.

Port layout (dh-minor, unlike the JAX package's time-minor one):
    k8, v8: (B, H, T, dh) int8      ks, vs: (B, H, T) f32
with ks already folding 1/sqrt(dh). The decode steps read these through
the decoder-layer kernels (ops/decode_layers.py); the prefill and the CPU
path use ``cross_attention_q8_reference``, the JAX package's reference.
"""

from __future__ import annotations

from typing import Tuple

import torch


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
