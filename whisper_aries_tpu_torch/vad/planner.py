"""Window planning: turning a long file into a batch of 30 s decode windows.

This replaces the reference's two-level time-domain chunking (N-minute chunks
with overlap fed to a worker pool, final_optimized_transcriber.py:422-459;
faster-whisper's internal sequential 30 s seek loop; SURVEY §5 "long-context")
with a TPU-first plan: windows are fixed 30 s spans laid out **up front** from
VAD speech segments, so the whole file becomes one batch over the device
mesh — no sequential seek dependency, no worker queue.

``plan_windows`` is VAD-aware: it packs speech segments into <=30 s
windows, bridging small gaps and skipping long silence entirely.
``plan_chunks`` is the fixed chunking mode's plan (coarse chunks with
overlap, each tiled into 30 s windows by the engine).
``windows_to_batch`` slices the float audio into the word-timestamp pass's
batch, as the JAX package's word pass does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

WINDOW_S = 30.0


@dataclass(frozen=True)
class Window:
    """One decode window: ``[start, end)`` seconds within the source file."""

    start: float
    end: float
    chunk_id: int = 0  # which coarse chunk this window belongs to

    @property
    def duration(self) -> float:
        return self.end - self.start


def plan_windows(
    speech_segments: Sequence[Tuple[float, float]],
    total_duration: float,
    window_s: float = WINDOW_S,
    max_gap_bridge_s: float = 3.0,
) -> List[Window]:
    """Pack VAD speech segments into fixed-size decode windows.

    Consecutive speech segments are packed into the same window while they
    fit within ``window_s`` of the window start and the silence gap between
    them is <= ``max_gap_bridge_s`` (bridging keeps sentence context intact);
    larger gaps start a new window (skipping silence entirely). A speech
    segment longer than ``window_s`` is tiled into full windows.
    """
    windows: List[Window] = []
    if not speech_segments:
        return windows

    cur_start: Optional[float] = None
    cur_end = 0.0
    for s, e in speech_segments:
        s, e = max(0.0, s), min(e, total_duration)
        if e <= s:
            continue
        while True:
            if cur_start is None:
                cur_start, cur_end = s, min(e, s + window_s)
            elif (s - cur_end) <= max_gap_bridge_s and (e - cur_start) <= window_s:
                cur_end = e
            elif (s - cur_end) <= max_gap_bridge_s and (s - cur_start) < window_s:
                # segment starts inside the window but overflows it: fill the
                # window, then continue with the remainder.
                cur_end = cur_start + window_s
                windows.append(Window(cur_start, cur_end))
                s = cur_end
                cur_start = None
                if e - s > 1e-6:
                    continue
            else:
                windows.append(Window(cur_start, cur_end))
                cur_start, cur_end = s, min(e, s + window_s)
            # tile over-long single segments
            while cur_end - cur_start >= window_s and cur_end < e:
                windows.append(Window(cur_start, cur_start + window_s))
                cur_start = cur_start + window_s
                cur_end = min(e, cur_start + window_s)
            break
    if cur_start is not None and cur_end - cur_start > 1e-6:
        windows.append(Window(cur_start, cur_end))
    # With no coarse-chunk structure, each window is its own "chunk" for
    # downstream reporting/reconciliation (chunk_id mirrors the reference's
    # per-chunk segment annotation, final_optimized_transcriber.py:331-340).
    return [Window(w.start, w.end, chunk_id=i) for i, w in enumerate(windows)]


def plan_chunks(
    total_duration: float,
    chunk_length_minutes: float = 3.0,
    overlap_seconds: float = 5.0,
) -> List[Window]:
    """The reference's fixed chunk plan: ceil(duration / chunk length)
    chunks, each extended by the overlap (final_optimized_transcriber.py:
    422-426)."""
    chunk_s = chunk_length_minutes * 60.0
    if total_duration <= 0:
        return []
    n = int(np.ceil(total_duration / chunk_s))
    out = []
    for i in range(n):
        start = i * chunk_s
        end = min(total_duration, start + chunk_s + overlap_seconds)
        out.append(Window(start, end, chunk_id=i))
    return out


def windows_to_batch(
    audio: np.ndarray,
    windows: Sequence[Window],
    sample_rate: int = 16_000,
    window_s: float = WINDOW_S,
) -> np.ndarray:
    """Slice + zero-pad windows into a dense (N, window_samples) batch."""
    n_samples = int(window_s * sample_rate)
    batch = np.zeros((len(windows), n_samples), np.float32)
    for i, w in enumerate(windows):
        i0 = int(round(w.start * sample_rate))
        i1 = min(len(audio), int(round(w.end * sample_rate)), i0 + n_samples)
        seg = audio[i0:i1]
        batch[i, : len(seg)] = seg
    return batch
