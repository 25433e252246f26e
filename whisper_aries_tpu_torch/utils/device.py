"""The port's device rule: entry points run on a CUDA card unless the caller
passes ``device="cpu"``; with no card and no explicit CPU they raise."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str], who: str) -> torch.device:
    """``device`` as a torch.device; None means CUDA. Raises RuntimeError
    naming ``who`` when CUDA is asked for and no card is visible."""
    if device is None or str(device).startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on a CUDA card and none is visible; pass "
                "device='cpu' for the plain CPU path")
        return torch.device(device or "cuda")
    return torch.device(device)
