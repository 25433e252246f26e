"""Frame-level speech-probability scoring.

Stand-in for the Silero VAD ONNX graph that faster-whisper runs through ONNX
Runtime (reference requirements.txt:37, enabled by ``vad_filter=True`` at
final_optimized_transcriber.py:440; SURVEY §2.3 N3). The contract is the
same — a speech probability per 512-sample (32 ms) frame at 16 kHz — so the
downstream segment state machine (vad/segments.py) is model-agnostic and a
learned JAX VAD can drop in (models/vad_net.py provides the architecture).

This implementation is a robust adaptive-energy detector:
  * per-frame band-limited log energy (speech band emphasis via a first-order
    pre-emphasis filter),
  * noise-floor tracking with running percentiles,
  * a soft sigmoid around the adaptive threshold -> probabilities in [0, 1].
"""

from __future__ import annotations

import numpy as np

FRAME_SIZE = 512  # 32 ms @ 16 kHz, matching Silero v4's hop
SAMPLE_RATE = 16_000


def get_speech_probs(audio: np.ndarray, frame_size: int = FRAME_SIZE) -> np.ndarray:
    """Mono float32 16 kHz audio -> per-frame speech probabilities.

    Pure numpy (host): VAD runs once per file at ~0.01% of transcription
    compute; keeping it off-device avoids a host<->device round trip per
    chunk. The learned Silero-replacement scorer (models/vad_net.py, weights
    shipped in whisper_aries_tpu/weights/) replaces this one when
    ``config.vad.backend`` is "auto"/"learned" — see
    AriesTranscriber._make_speech_scorer.
    """
    x = np.asarray(audio, dtype=np.float32)
    n_frames = len(x) // frame_size
    if n_frames == 0:
        return np.zeros((0,), np.float32)
    x = x[: n_frames * frame_size]
    # pre-emphasis boosts the 1-4 kHz speech band against low-frequency hum
    emph = np.empty_like(x)
    emph[0] = x[0]
    emph[1:] = x[1:] - 0.95 * x[:-1]
    frames = emph.reshape(n_frames, frame_size)
    energy = np.log10(np.mean(frames**2, axis=1) + 1e-10)  # (F,)

    # adaptive noise floor / speech ceiling from percentiles
    floor = np.percentile(energy, 10)
    ceil = np.percentile(energy, 95)
    if ceil - floor < 1.0:
        # near-constant energy: either all silence or all speech; decide by
        # absolute level (~ -3.5 log10-mean-square == ~0.018 RMS separates
        # speech at sane recording levels from noise floors)
        return np.where(energy > -3.5, 0.9, 0.05).astype(np.float32)

    mid = floor + 0.45 * (ceil - floor)
    sharp = 6.0 / max(ceil - floor, 1e-3)
    probs = 1.0 / (1.0 + np.exp(-sharp * (energy - mid)))

    # short median smoothing knocks out single-frame clicks
    if len(probs) >= 5:
        padded = np.pad(probs, (2, 2), mode="edge")
        win = np.lib.stride_tricks.sliding_window_view(padded, 5)
        probs = np.median(win, axis=1)
    return probs.astype(np.float32)
