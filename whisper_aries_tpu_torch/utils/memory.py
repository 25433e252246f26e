"""Process and card memory probes, and the out-of-memory test of the
engine's batch-halving ladder (the port's copy of the JAX package's
utils/memory.py, reading the CUDA caching allocator where JAX reads the
TPU's memory stats)."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

#: cudaErrorMemoryAllocation
CUDA_ERROR_MEMORY_ALLOCATION = 2


def get_memory_usage() -> Optional[float]:
    """Current process RSS in MB, or None when psutil is unavailable."""
    try:
        import psutil

        return psutil.Process().memory_info().rss / (1024 * 1024)
    except ImportError:
        return None


def get_device_memory_stats() -> List[Dict[str, Optional[int]]]:
    """Per card: bytes the caching allocator holds for tensors
    (``torch.cuda.memory_stats``' allocated_bytes.all.current), its peak,
    and the card's total memory; an empty list without CUDA."""
    if not torch.cuda.is_available():
        return []
    stats = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats.append({
            "device": f"cuda:{i}",
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return stats


def is_oom_error(e: BaseException) -> bool:
    """Whether ``e`` is a card running out of memory: the caching
    allocator's ``torch.cuda.OutOfMemoryError``, a kernel wrapper's
    ``CudaError`` with cudaErrorMemoryAllocation, or a RuntimeError in one
    of the runtime's and the libraries' spellings ("CUDA out of memory",
    "CUDA error: out of memory", CUBLAS / CUDNN "ALLOC_FAILED")."""
    from whisper_aries_tpu_torch.ops.cuda_build import CudaError

    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    if isinstance(e, CudaError):
        return e.code == CUDA_ERROR_MEMORY_ALLOCATION
    if not isinstance(e, RuntimeError):
        return False
    msg = str(e).lower()
    return ("cuda out of memory" in msg or "cuda error: out of memory" in msg
            or "status_alloc_failed" in msg)
