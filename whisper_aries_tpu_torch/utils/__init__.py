"""Checkpoint files, segment reconciliation and per-call diagnostics."""

from whisper_aries_tpu_torch.utils.segments import (
    align_segments,
    merge_overlapping_segments,
    remove_overlaps_drop,
    segment_overlap,
)
from whisper_aries_tpu_torch.utils.media import extract_audio_if_needed
from whisper_aries_tpu_torch.utils.memory import get_memory_usage

__all__ = [
    "align_segments",
    "segment_overlap",
    "remove_overlaps_drop",
    "merge_overlapping_segments",
    "extract_audio_if_needed",
    "get_memory_usage",
]
