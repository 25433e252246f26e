"""Overlap reconciliation between adjacent fixed chunks (the port's copy of
the JAX package's utils/segments.py ``remove_overlaps_drop`` and
``merge_overlapping_segments``; the transcript-to-speaker alignment there
comes with diarization).

  * ``remove_overlaps_drop``: drop segments that start more than 1 s inside
    the previous chunk's covered region (reference:
    final_optimized_transcriber.py:537-556).
  * ``merge_overlapping_segments``: text-concatenation merge (reference:
    complete_fixed_whisper.py:880-902).
"""

from __future__ import annotations

from typing import Any, Dict, List


def remove_overlaps_drop(
    segments: List[Dict[str, Any]],
    boundary_tolerance_s: float = 1.0,
) -> List[Dict[str, Any]]:
    """Segments sorted by start, each with a ``chunk_id``: a segment of a
    new chunk that starts more than ``boundary_tolerance_s`` before the
    covered-time frontier repeats already-emitted text and is dropped."""
    if not segments:
        return []
    out = [segments[0]]
    frontier = segments[0]["end"]
    last_chunk = segments[0].get("chunk_id", 0)
    for seg in segments[1:]:
        chunk = seg.get("chunk_id", last_chunk)
        if chunk != last_chunk and seg["start"] < frontier - boundary_tolerance_s:
            continue  # duplicate from the overlap region
        out.append(seg)
        frontier = max(frontier, seg["end"])
        last_chunk = chunk
    return out


def merge_overlapping_segments(
    segments: List[Dict[str, Any]],
    overlap_tolerance_s: float = 0.5,
) -> List[Dict[str, Any]]:
    """Adjacent segments overlapping by more than ``overlap_tolerance_s``
    fuse into one spanning both; the later text is appended unless it is
    already contained in the earlier one."""
    if not segments:
        return []
    segs = sorted(segments, key=lambda s: (s["start"], s["end"]))
    out = [dict(segs[0])]
    for seg in segs[1:]:
        prev = out[-1]
        overlap = prev["end"] - seg["start"]
        if overlap > overlap_tolerance_s:
            prev["end"] = max(prev["end"], seg["end"])
            a, b = prev["text"].strip(), seg["text"].strip()
            if b and b.lower() not in a.lower():
                prev["text"] = (a + " " + b).strip()
        else:
            out.append(dict(seg))
    return out
