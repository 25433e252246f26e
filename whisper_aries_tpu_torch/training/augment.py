"""Acoustic augmentation for the synthetic speech corpus (training/synth.py;
the port's copy of the JAX package's training/augment.py, bit for bit the
same arrays at one ``np.random.Generator`` seed).

Real recordings carry room reverb, channel band-limiting, codec
quantisation and level distortion — none of which change WHO is speaking
WHEN, so they are the label-preserving transforms to train invariance
against. Every transform is pure numpy, length-preserving (output length
== input length) and deterministic given the Generator, so the augmented
DER battery (eval/diarize_battery.py) is reproducible.

Augmentation lives outside synth.py on purpose: the trained-weight gates
draw their eval audio from the synth generators, so the clean corpus
distribution stays frozen and augmentation composes on top.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

SR = 16_000


# ---------------------------------------------------------------------------
# Individual transforms
# ---------------------------------------------------------------------------


def synthetic_ir(rng: np.random.Generator, rt60_s: Optional[float] = None,
                 dur_s: float = 0.35) -> np.ndarray:
    """A synthetic room impulse response: direct path + a handful of sparse
    early reflections + an exponentially decaying diffuse noise tail whose
    decay matches the requested RT60 (time to -60 dB)."""
    if rt60_s is None:
        rt60_s = float(rng.uniform(0.12, 0.7))
    n = int(dur_s * SR)
    ir = np.zeros(n, np.float32)
    ir[0] = 1.0
    # early reflections in the first ~25 ms, alternating sign
    for _ in range(int(rng.integers(2, 7))):
        d = int(rng.uniform(0.002, 0.025) * SR)
        if d < n:
            ir[d] += rng.uniform(0.1, 0.5) * rng.choice([-1.0, 1.0])
    # diffuse tail: decaying noise, e^{-6.9 t / RT60} ~ -60 dB at RT60
    t = np.arange(n, dtype=np.float32) / SR
    tail = rng.standard_normal(n).astype(np.float32) * np.exp(
        -6.9 * t / rt60_s
    )
    start = int(0.005 * SR)
    ir[start:] += 0.3 * tail[start:]
    return ir / max(np.abs(ir).max(), 1e-6)


def apply_reverb(rng: np.random.Generator, audio: np.ndarray,
                 wet: Optional[float] = None,
                 ir: Optional[np.ndarray] = None) -> np.ndarray:
    """Convolve with a room IR; mix dry/wet so intelligibility survives."""
    if ir is None:
        ir = synthetic_ir(rng)
    if wet is None:
        wet = float(rng.uniform(0.25, 0.9))
    n = len(audio)
    m = int(2 ** np.ceil(np.log2(n + len(ir))))
    rev = np.fft.irfft(
        np.fft.rfft(audio, m) * np.fft.rfft(ir, m), m
    )[:n].astype(np.float32)
    peak = np.abs(rev).max()
    if peak > 1e-6:
        rev *= np.abs(audio).max() / peak  # match dry level
    return ((1.0 - wet) * audio + wet * rev).astype(np.float32)


def band_limit(rng: np.random.Generator, audio: np.ndarray,
               lo: Optional[float] = None,
               hi: Optional[float] = None) -> np.ndarray:
    """Channel band-limiting; default draws span telephone (300-3400 Hz)
    through lightly low-passed wideband."""
    if lo is None:
        lo = float(rng.choice([50.0, 150.0, 300.0]))
    if hi is None:
        hi = float(rng.uniform(3000.0, 7600.0))
    n = len(audio)
    spec = np.fft.rfft(audio)
    f = np.fft.rfftfreq(n, 1.0 / SR)
    # raised-cosine band edges (brick walls ring audibly)
    mask = np.ones_like(f)
    mask[f < lo] = 0.0
    edge = (f >= lo) & (f < lo * 1.5)
    mask[edge] = 0.5 - 0.5 * np.cos(
        np.pi * (f[edge] - lo) / (0.5 * lo + 1e-9)
    )
    mask[f > hi] = 0.0
    edge = (f <= hi) & (f > hi * 0.85)
    mask[edge] *= 0.5 + 0.5 * np.cos(
        np.pi * (f[edge] - 0.85 * hi) / (0.15 * hi)
    )
    return np.fft.irfft(spec * mask, n=n).astype(np.float32)


def channel_eq(rng: np.random.Generator, audio: np.ndarray,
               n_points: int = 6, max_db: float = 8.0) -> np.ndarray:
    """Smooth random EQ curve (mic/room coloration): gains drawn at a few
    log-spaced anchor frequencies, interpolated over the spectrum."""
    n = len(audio)
    f = np.fft.rfftfreq(n, 1.0 / SR)
    anchors = np.geomspace(60.0, 7800.0, n_points)
    gains_db = rng.uniform(-max_db, max_db, n_points)
    curve = np.interp(np.log1p(f), np.log1p(anchors), gains_db)
    return np.fft.irfft(
        np.fft.rfft(audio) * 10.0 ** (curve / 20.0), n=n
    ).astype(np.float32)


def mu_law_roundtrip(audio: np.ndarray, bits: int = 8,
                     mu: float = 255.0) -> np.ndarray:
    """Codec simulation: mu-law companding quantisation round trip (G.711
    telephony; also a fair stand-in for low-bitrate codec noise)."""
    peak = np.abs(audio).max()
    if peak < 1e-6:
        return audio
    x = audio / peak
    comp = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    q = np.round(comp * (2 ** (bits - 1) - 1)) / (2 ** (bits - 1) - 1)
    back = np.sign(q) * (np.expm1(np.abs(q) * np.log1p(mu))) / mu
    return (back * peak).astype(np.float32)


def resample_roundtrip(rng: np.random.Generator, audio: np.ndarray,
                       sr_low: Optional[int] = None) -> np.ndarray:
    """Down/up-sample round trip (transmission at 8/11/22 kHz): linear
    interpolation both ways — intentionally cheap; its aliasing/rolloff IS
    the augmentation."""
    if sr_low is None:
        sr_low = int(rng.choice([8000, 11025, 22050]))
    n = len(audio)
    t_lo = np.arange(int(n * sr_low / SR)) * (SR / sr_low)
    lo = np.interp(t_lo, np.arange(n), audio)
    return np.interp(np.arange(n), t_lo, lo).astype(np.float32)


def clip_distort(rng: np.random.Generator, audio: np.ndarray,
                 drive: Optional[float] = None) -> np.ndarray:
    """Input-gain overload: soft (tanh) clipping at a random drive level."""
    if drive is None:
        drive = float(rng.uniform(1.5, 4.0))
    peak = np.abs(audio).max()
    if peak < 1e-6:
        return audio
    return (np.tanh(audio / peak * drive) / np.tanh(drive) * peak).astype(
        np.float32
    )


def gain_drift(rng: np.random.Generator, audio: np.ndarray,
               max_db: float = 6.0) -> np.ndarray:
    """Slow automatic-gain-control-style level drift over the clip."""
    n = len(audio)
    anchors = rng.uniform(-max_db, max_db, 5)
    curve = 10.0 ** (
        np.interp(np.arange(n), np.linspace(0, n, 5), anchors) / 20.0
    )
    return (audio * curve).astype(np.float32)


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

#: (name, apply_probability-at-strength-1) — order matters: room acoustics,
#: then channel, then codec, then level, like a real recording chain.
_CHAIN = (
    ("reverb", 0.5),
    ("eq", 0.5),
    ("band", 0.4),
    ("resample", 0.3),
    ("mulaw", 0.3),
    ("clip", 0.25),
    ("gain", 0.4),
)


def augment(rng: np.random.Generator, audio: np.ndarray,
            strength: float = 1.0) -> np.ndarray:
    """Random label-preserving recording-chain augmentation.

    ``strength`` scales each stage's apply probability (0 = identity,
    1 = default mix). Peak level is restored afterwards so the speech/noise
    SNR chosen by the corpus generator survives the chain.
    """
    peak_in = np.abs(audio).max()
    out = audio
    for name, p in _CHAIN:
        if rng.uniform() >= p * strength:
            continue
        if name == "reverb":
            out = apply_reverb(rng, out)
        elif name == "eq":
            out = channel_eq(rng, out)
        elif name == "band":
            out = band_limit(rng, out)
        elif name == "resample":
            out = resample_roundtrip(rng, out)
        elif name == "mulaw":
            out = mu_law_roundtrip(out, bits=int(rng.choice([8, 10])))
        elif name == "clip":
            out = clip_distort(rng, out)
        elif name == "gain":
            out = gain_drift(rng, out)
    peak_out = np.abs(out).max()
    if peak_in > 1e-6 and peak_out > 1e-6:
        out = out * (peak_in / peak_out)
    return out.astype(np.float32)
