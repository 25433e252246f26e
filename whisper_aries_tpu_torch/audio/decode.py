"""Audio decode + resample front door (WAV path).

Same contract as the JAX package's audio/decode.py: every public function
returns mono float32 at the requested rate (16 kHz for the ASR contract).
This slice of the port decodes RIFF/WAVE with numpy and resamples with
scipy's polyphase filter (or a windowed-sinc numpy fallback). Compressed
containers (FLAC, MP3, Ogg, video) need the native codecs, which are not
ported yet: they raise ``AudioError`` naming the format.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from whisper_aries_tpu_torch.errors import AudioError

SAMPLE_RATE = 16_000


def _decode_wav_numpy(data: bytes) -> Tuple[np.ndarray, int]:
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AudioError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = int.from_bytes(data[pos + 4 : pos + 8], "little")
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt " and len(body) >= 16:
            tag = int.from_bytes(body[0:2], "little")
            channels = int.from_bytes(body[2:4], "little")
            rate = int.from_bytes(body[4:8], "little")
            bits = int.from_bytes(body[14:16], "little")
            if tag == 0xFFFE and len(body) >= 40:
                tag = int.from_bytes(body[24:26], "little")
            fmt = (tag, channels, rate, bits)
        elif cid == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if fmt is None:
        raise AudioError("missing fmt chunk")
    if pcm is None or len(pcm) == 0:
        raise AudioError("missing data chunk")
    tag, channels, rate, bits = fmt
    if tag == 1 and bits == 16:
        x = np.frombuffer(pcm, dtype="<i2").astype(np.float32) / 32768.0
    elif tag == 1 and bits == 32:
        x = np.frombuffer(pcm, dtype="<i4").astype(np.float32) / 2147483648.0
    elif tag == 1 and bits == 24:
        raw = np.frombuffer(pcm[: len(pcm) - len(pcm) % 3], dtype=np.uint8)
        raw = raw.reshape(-1, 3)
        vals = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        x = vals.astype(np.float32) / 8388608.0
    elif tag == 1 and bits == 8:
        x = (np.frombuffer(pcm, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif tag == 3 and bits == 32:
        x = np.frombuffer(pcm, dtype="<f4").astype(np.float32)
    elif tag == 3 and bits == 64:
        x = np.frombuffer(pcm, dtype="<f8").astype(np.float32)
    else:
        raise AudioError(f"unsupported WAV format tag={tag} bits={bits}")
    if channels > 1:
        n = (x.shape[0] // channels) * channels
        x = x[:n].reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), rate


def _resample_numpy(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Rational resample via scipy's polyphase filter when available, else
    a windowed-sinc numpy filter of the same design."""
    if sr_in == sr_out:
        return x.astype(np.float32, copy=False)
    try:
        from scipy.signal import resample_poly

        g = math.gcd(sr_in, sr_out)
        # scipy's default ('kaiser', 5.0) window only reaches ~50 dB
        # stopband; beta 12.984 reaches >100 dB
        y = resample_poly(
            x.astype(np.float64), sr_out // g, sr_in // g, window=("kaiser", 12.984)
        )
        return y.astype(np.float32)
    except ImportError:
        pass
    g = math.gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    taps = 32  # even, so the L*taps/2 group delay is integral
    h_len = L * taps + 1  # odd length centers the filter exactly on-grid
    cutoff = 0.945 / max(L, M)
    H = (h_len - 1) // 2
    n = np.arange(h_len, dtype=np.float64)
    t = (n - H) * cutoff
    sinc = np.sinc(t)
    beta = 12.984
    w = np.i0(beta * np.sqrt(np.maximum(0.0, 1 - (2 * n / (h_len - 1) - 1) ** 2))) / np.i0(beta)
    h = np.zeros(L * (taps + 1), dtype=np.float64)
    h[:h_len] = L * cutoff * sinc * w
    n_out = (len(x) * L + M - 1) // M
    u = np.arange(n_out, dtype=np.int64) * M + H
    p = u % L
    m = u // L
    k = np.arange(taps + 1, dtype=np.int64)
    idx = m[:, None] - k[None, :]
    valid = (idx >= 0) & (idx < len(x))
    xi = np.where(valid, x[np.clip(idx, 0, len(x) - 1)], 0.0)
    hk = h[p[:, None] + k[None, :] * L]
    return (xi * hk).sum(axis=1).astype(np.float32)


def load_audio(path: str, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Load a WAV file as mono float32 at ``sample_rate``."""
    p = Path(path)
    if not p.exists():
        raise AudioError(f"audio file not found: {path}")
    ext = p.suffix.lower()
    if ext != ".wav":
        raise AudioError(
            f"cannot decode {ext or 'extension-less'} files: this build "
            "decodes WAV only (the native codecs are not ported yet)")
    audio, sr = _decode_wav_numpy(p.read_bytes())
    if sr != sample_rate:
        audio = _resample_numpy(audio, sr, sample_rate)
    return audio


def write_wav(path: str, audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    """Write mono float32 [-1,1] as 16-bit PCM WAV (test/tooling helper)."""
    x = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                 sample_rate * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    with open(path, "wb") as f:
        f.write(hdr + pcm)


class AudioPreloader:
    """Whole-file in-RAM audio: decoded once to mono float32 16 kHz."""

    def __init__(self, path: str, sample_rate: int = SAMPLE_RATE):
        self.path = path
        self.sample_rate = sample_rate
        self.audio: np.ndarray = load_audio(path, sample_rate)
        self.duration = len(self.audio) / sample_rate
