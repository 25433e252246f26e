"""Segment interval math (the port's copy of the JAX package's
utils/segments.py): transcript-to-speaker alignment and overlap
reconciliation between adjacent fixed chunks.

  * ``segment_overlap`` / ``align_segments``: majority-overlap speaker
    assignment with a confidence threshold; below-threshold or
    non-overlapping segments get ``speaker=None`` (reference:
    utils.py:31-76), as a vectorised numpy sweep over blocks of 512
    transcript segments.
  * ``remove_overlaps_drop``: drop segments that start more than 1 s inside
    the previous chunk's covered region (reference:
    final_optimized_transcriber.py:537-556).
  * ``merge_overlapping_segments``: text-concatenation merge (reference:
    complete_fixed_whisper.py:880-902).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def segment_overlap(seg1: Tuple[float, float], seg2: Tuple[float, float]) -> float:
    """Overlap duration in seconds between two (start, end) intervals; >= 0."""
    start = max(seg1[0], seg2[0])
    end = min(seg1[1], seg2[1])
    return max(0.0, end - start)


def align_segments(
    transcription_segments: List[Dict[str, Any]],
    diarization_segments: List[Dict[str, Any]],
    confidence_threshold: float = 0.5,
) -> List[Dict[str, Any]]:
    """Assign a speaker to each transcript segment by majority overlap.

    For each transcript segment, the overlap duration with every diarization
    turn is accumulated per speaker. The speaker with the largest summed
    overlap wins with confidence = its_overlap / total_overlap; if confidence
    is below ``confidence_threshold`` (or there is no overlap at all) the
    segment gets ``speaker=None`` and the computed (or zero) confidence.

    Output item contract (reference: utils.py:69-75):
        {text, start, end, speaker, confidence}
    """
    if not transcription_segments:
        return []
    if not diarization_segments:
        return [
            {
                "text": t["text"],
                "start": t["start"],
                "end": t["end"],
                "speaker": None,
                "confidence": 0.0,
            }
            for t in transcription_segments
        ]

    t_start = np.asarray([t["start"] for t in transcription_segments], dtype=np.float64)
    t_end = np.asarray([t["end"] for t in transcription_segments], dtype=np.float64)

    d_start = np.asarray([d["start"] for d in diarization_segments], dtype=np.float64)
    d_end = np.asarray([d["end"] for d in diarization_segments], dtype=np.float64)
    speakers = [d["speaker"] for d in diarization_segments]
    uniq_speakers = sorted({s for s in speakers}, key=str)
    spk_index = {s: i for i, s in enumerate(uniq_speakers)}
    d_spk = np.asarray([spk_index[s] for s in speakers], dtype=np.int64)
    n_spk = len(uniq_speakers)

    # Sort turns by start so each transcript segment only inspects a window.
    order = np.argsort(d_start, kind="stable")
    d_start, d_end, d_spk = d_start[order], d_end[order], d_spk[order]
    # Running max of ends lets us bound the left edge of candidate turns.
    d_end_cummax = np.maximum.accumulate(d_end)

    results: List[Dict[str, Any]] = []
    # Blockwise to keep the overlap matrix small even for huge inputs.
    BLOCK = 512
    n_t = len(transcription_segments)
    for b0 in range(0, n_t, BLOCK):
        b1 = min(b0 + BLOCK, n_t)
        ts, te = t_start[b0:b1], t_end[b0:b1]
        # Candidate turns: those with d_start < te.max() and cummax end > ts.min().
        hi = int(np.searchsorted(d_start, te.max(), side="right"))
        lo = int(np.searchsorted(d_end_cummax, ts.min(), side="right"))
        cs, ce, ck = d_start[lo:hi], d_end[lo:hi], d_spk[lo:hi]
        if len(cs) == 0:
            ov_by_spk = np.zeros((b1 - b0, n_spk))
        else:
            ov = np.maximum(
                0.0,
                np.minimum(te[:, None], ce[None, :])
                - np.maximum(ts[:, None], cs[None, :]),
            )
            ov_by_spk = np.zeros((b1 - b0, n_spk))
            np.add.at(ov_by_spk.T, ck, ov.T)
        total = ov_by_spk.sum(axis=1)
        best = ov_by_spk.argmax(axis=1)
        best_ov = ov_by_spk[np.arange(b1 - b0), best]
        with np.errstate(invalid="ignore", divide="ignore"):
            conf = np.where(total > 0, best_ov / np.where(total > 0, total, 1.0), 0.0)
        for i in range(b1 - b0):
            t = transcription_segments[b0 + i]
            c = float(conf[i])
            has_overlap = total[i] > 0
            assigned: Optional[Any]
            if has_overlap and c >= confidence_threshold:
                assigned = uniq_speakers[int(best[i])]
            else:
                assigned = None
            results.append(
                {
                    "text": t["text"],
                    "start": t["start"],
                    "end": t["end"],
                    "speaker": assigned,
                    "confidence": c,
                }
            )
    return results


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
