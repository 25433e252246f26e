"""Host-side parsing of decoded token streams into timestamped segments.

Equivalent of the segment-splitting faster-whisper performs inside its
sliding-window loop (SURVEY §2.3 N2): timestamp-token pairs delimit segments;
text between <|t0|> and <|t1|> becomes one segment with times rebased by the
window's position in the source file (the reference rebases chunk timestamps
at final_optimized_transcriber.py:331-340).
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def compression_ratio(text: str) -> float:
    """zlib compression ratio — the repetition-loop detector thresholded at
    2.4 by the reference (final_optimized_transcriber.py:439)."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def parse_window_tokens(
    tokens: Sequence[int],
    tokenizer,
    window_start: float,
    window_duration: float,
    prompt_len: int = 0,
) -> List[Dict[str, Any]]:
    """Decoded ids (one window) -> [{start, end, text, tokens}].

    ``tokens`` may include the prompt (skipped via ``prompt_len``) and eot
    padding. Timestamp pairs delimit segments; a trailing unpaired timestamp
    (or no trailing timestamp at all) closes the final segment at the window
    end. Times are absolute (window_start + token time), clipped to the
    window.
    """
    sp = tokenizer.specials
    ids = [int(t) for t in tokens[prompt_len:]]
    # strip eot padding
    while ids and ids[-1] == sp.eot:
        ids.pop()

    segments: List[Dict[str, Any]] = []
    cur_tokens: List[int] = []
    cur_start: Optional[float] = None

    def flush(end_time: float):
        nonlocal cur_tokens, cur_start
        if cur_tokens and cur_start is not None and cur_start < window_duration:
            # starts at/after the window's real end live in the zero-padded
            # tail of the 30 s buffer — there is no audio there; drop them.
            text = tokenizer.decode(cur_tokens).strip()
            if text:
                start_abs = window_start + cur_start
                end_abs = window_start + min(end_time, window_duration)
                if end_abs <= start_abs:
                    end_abs = min(window_start + window_duration,
                                  start_abs + 0.02)
                segments.append(
                    {
                        "start": round(start_abs, 3),
                        "end": round(end_abs, 3),
                        "text": text,
                        "tokens": list(cur_tokens),
                    }
                )
        cur_tokens = []
        cur_start = None

    last_ts: Optional[float] = None
    for tid in ids:
        if tid >= sp.timestamp_begin:
            t = sp.timestamp_to_seconds(tid)
            if cur_tokens:
                flush(t)
            cur_start = t
            last_ts = t
        elif tid < sp.eot:
            if cur_start is None:
                cur_start = last_ts if last_ts is not None else 0.0
            cur_tokens.append(tid)
    if cur_tokens:
        flush(window_duration)
    return segments


def window_quality(
    text: str,
    avg_logprob: float,
    no_speech_prob: float,
    log_prob_threshold: Optional[float] = -1.0,
    compression_ratio_threshold: Optional[float] = 2.4,
    no_speech_threshold: Optional[float] = 0.6,
) -> Dict[str, Any]:
    """faster-whisper's fallback policy inputs: did this window's decode pass
    the quality gates, and should it be treated as silence?

    Any threshold may be None = that gate is DISABLED, matching the
    faster-whisper option contract (its transcribe() accepts
    compression_ratio_threshold/log_prob_threshold/no_speech_threshold as
    Optional and skips the corresponding check when None — the reference
    passes these straight through, final_optimized_transcriber.py:310-319).
    """
    cr = compression_ratio(text)
    needs_fallback = (
        (compression_ratio_threshold is not None
         and cr > compression_ratio_threshold)
        or (log_prob_threshold is not None
            and avg_logprob < log_prob_threshold)
    )
    is_silence = (
        no_speech_threshold is not None
        and no_speech_prob > no_speech_threshold
        and (log_prob_threshold is None or avg_logprob < log_prob_threshold)
    )
    return {
        "compression_ratio": cr,
        "needs_fallback": bool(needs_fallback and not is_silence),
        "is_silence": bool(is_silence),
    }
