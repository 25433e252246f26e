"""Speech-segment extraction state machine.

Implements the same segment-collection semantics faster-whisper applies on
top of Silero probabilities (the ``vad_filter``/``vad_parameters`` knobs the
reference exposes: final_optimized_transcriber.py:440,
complete_fixed_whisper.py:744-748 — threshold, min_speech_duration_ms,
min_silence_duration_ms, speech_pad_ms, max_speech_duration_s).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from whisper_aries_tpu_torch.vad.energy import FRAME_SIZE, SAMPLE_RATE


@dataclass(frozen=True)
class VadOptions:
    threshold: float = 0.5
    neg_threshold: Optional[float] = None  # default threshold - 0.15
    min_speech_duration_ms: int = 250
    min_silence_duration_ms: int = 500
    speech_pad_ms: int = 200
    max_speech_duration_s: float = 30.0

    @property
    def neg(self) -> float:
        return self.neg_threshold if self.neg_threshold is not None else max(
            self.threshold - 0.15, 0.01
        )


def collect_speech_segments(
    probs: np.ndarray,
    opts: VadOptions = VadOptions(),
    frame_size: int = FRAME_SIZE,
    sample_rate: int = SAMPLE_RATE,
    total_samples: Optional[int] = None,
) -> List[Tuple[float, float]]:
    """Per-frame speech probs -> [(start_sec, end_sec), ...].

    Hysteresis trigger at ``threshold``/``neg``; a segment only closes after
    ``min_silence_duration_ms`` of quiet; segments shorter than
    ``min_speech_duration_ms`` are dropped; ``speech_pad_ms`` is added on both
    sides; segments longer than ``max_speech_duration_s`` are split at the
    most recent quiet frame.
    """
    frame_s = frame_size / sample_rate
    min_speech_s = opts.min_speech_duration_ms / 1000.0
    min_silence_s = opts.min_silence_duration_ms / 1000.0
    pad_s = opts.speech_pad_ms / 1000.0
    max_speech_s = opts.max_speech_duration_s
    total_s = (
        (total_samples / sample_rate)
        if total_samples is not None
        else len(probs) * frame_s
    )

    segments: List[Tuple[float, float]] = []
    triggered = False
    seg_start = 0.0
    silence_start: Optional[float] = None
    last_quiet: Optional[float] = None

    for i, p in enumerate(probs):
        t = i * frame_s
        if not triggered:
            if p >= opts.threshold:
                triggered = True
                seg_start = t
                silence_start = None
                last_quiet = None
            continue
        # triggered
        if p < opts.neg:
            last_quiet = t
            if silence_start is None:
                silence_start = t
            if t - silence_start >= min_silence_s:
                segments.append((seg_start, silence_start + frame_s))
                triggered = False
                silence_start = None
            continue
        if p >= opts.threshold:
            silence_start = None
        # split over-long segments at the last quiet frame (or hard-split)
        if t - seg_start >= max_speech_s:
            split_at = last_quiet if last_quiet and last_quiet > seg_start else t
            segments.append((seg_start, split_at))
            seg_start = split_at
            silence_start = None
            last_quiet = None

    if triggered:
        segments.append((seg_start, total_s))

    # length filter, then padding clipped at neighbour midpoints so that
    # max-duration splits stay distinct segments.
    kept = [(s, e) for s, e in segments if e - s >= min_speech_s]
    out: List[Tuple[float, float]] = []
    for i, (s, e) in enumerate(kept):
        lo = 0.0 if i == 0 else (kept[i - 1][1] + s) / 2.0
        hi = total_s if i == len(kept) - 1 else (e + kept[i + 1][0]) / 2.0
        out.append((max(lo, s - pad_s), min(hi, e + pad_s)))
    return out
