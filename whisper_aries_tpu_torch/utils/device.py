"""The port's device rule: entry points run on a CUDA card unless the caller
passes ``device="cpu"``; with no card and no explicit CPU they raise. And
the rule for threads: one job's device work at a time on a device
(``on_card``)."""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional, Tuple

import torch


_TF32_LOCK = threading.Lock()
_TF32_HELD = {"n": 0, "prev": None}


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """TF32 off for matmuls and cuDNN inside the block: the VAD's
    convolutions, the train steps and the f32 engine compute f32 as the
    JAX package does; a trainer's backward runs inside it too. The flags
    are the process's: blocks in several threads at once share one hold,
    and the flags the first found are restored when the last leaves."""
    with _TF32_LOCK:
        if _TF32_HELD["n"] == 0:
            _TF32_HELD["prev"] = (torch.backends.cuda.matmul.allow_tf32,
                                  torch.backends.cudnn.allow_tf32)
        _TF32_HELD["n"] += 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        with _TF32_LOCK:
            _TF32_HELD["n"] -= 1
            if _TF32_HELD["n"] == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _TF32_HELD["prev"]


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


_CARD_LOCKS: Dict[Tuple[str, int], threading.RLock] = {}
_CARD_LOCKS_GUARD = threading.Lock()


def card_lock(device: torch.device) -> threading.RLock:
    """The one lock of ``device`` in this process. Every engine and diarizer
    on that device holds it around its device work, weight uploads
    included: a CUDA graph captured by one job must not see another job's
    launches, allocations, copies or synchronisations, and the launch
    counters are module globals. Re-entrant, so a holder may call another
    holder (the engine's constructor runs its smoke test)."""
    key = (device.type, device.index or 0)
    with _CARD_LOCKS_GUARD:
        return _CARD_LOCKS.setdefault(key, threading.RLock())


@contextlib.contextmanager
def on_card(device: torch.device) -> Iterator[None]:
    """Hold ``device``'s lock, with ``device`` the calling thread's current
    CUDA device (a worker thread starts on device 0)."""
    with card_lock(device):
        if device.type == "cuda":
            with torch.cuda.device(device):
                yield
        else:
            yield
