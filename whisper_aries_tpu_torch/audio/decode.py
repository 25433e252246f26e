"""Audio decode + resample front door (the port of the JAX package's
audio/decode.py).

Every public function returns mono float32 at the requested rate (16 kHz
for the ASR contract). Decoding and resampling run in the port's native
library (``audio/_native.py``, its own C++ under ``native/``), as the JAX
package runs them with its native library built: the same WAV decoder and
polyphase resampler, so the samples are the JAX package's to the bit.
``load_audio`` dispatches on the extension as the JAX package does: .wav
to the WAV decoder, .flac to the FLAC decoder, .mp3 over libmpg123,
.ogg / .oga over libvorbisfile, and anything else over libavformat. A codec
whose system library does not resolve raises ``AudioError`` naming it;
what libavformat cannot decode goes to the ffmpeg binary, as in the JAX
package, and without one it raises.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from whisper_aries_tpu_torch.audio import _native
from whisper_aries_tpu_torch.errors import AudioError

SAMPLE_RATE = 16_000

#: extensions with a decoder of their own; every other non-WAV extension
#: goes to libavformat
_CODECS = {".flac": _native.decode_flac, ".mp3": _native.decode_mp3,
           ".ogg": _native.decode_ogg, ".oga": _native.decode_ogg}


def peek_wav_s16_mono(data: bytes, sample_rate: int = SAMPLE_RATE
                      ) -> Optional[np.ndarray]:
    """Raw int16 samples when ``data`` is a plain PCM16 mono WAV already at
    ``sample_rate``, else None: the engine uploads them to the card as they
    are (the reference's pcm_s16le ingest contract) instead of decoding to
    float32 and quantizing back."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        return None
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = int.from_bytes(data[pos + 4 : pos + 8], "little")
        if cid == b"fmt " and size >= 16:
            body = data[pos + 8 : pos + 8 + size]
            tag = int.from_bytes(body[0:2], "little")
            channels = int.from_bytes(body[2:4], "little")
            rate = int.from_bytes(body[4:8], "little")
            bits = int.from_bytes(body[14:16], "little")
            if tag == 0xFFFE and len(body) >= 40:
                tag = int.from_bytes(body[24:26], "little")
            fmt = (tag, channels, rate, bits)
        elif cid == b"data":
            pcm = (pos + 8, size)
        pos += 8 + size + (size & 1)
    if fmt != (1, 1, sample_rate, 16) or pcm is None:
        return None
    off, size = pcm
    size = min(size, len(data) - off) & ~1
    return np.frombuffer(data, dtype="<i2", count=size // 2, offset=off)


def decode_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """WAV bytes -> (mono float32, sample rate)."""
    return _native.decode_wav(data)


def resample(x: np.ndarray, sr_in: int, sr_out: int = SAMPLE_RATE
             ) -> np.ndarray:
    """Mono float32 resample by the native polyphase filter."""
    if sr_in == sr_out:
        return np.asarray(x, dtype=np.float32)
    return _native.resample(np.asarray(x, dtype=np.float32), sr_in, sr_out)


def _ffmpeg_wav(path: Path, sample_rate: int, why: AudioError) -> bytes:
    """The file as a 16-bit mono WAV at ``sample_rate`` by the ffmpeg
    binary; raises ``AudioError`` (naming ``why``) without one."""
    if not shutil.which("ffmpeg"):
        raise AudioError(f"cannot decode {path.suffix} ({why}) and there is "
                         "no ffmpeg binary; install ffmpeg or provide a WAV "
                         "file")
    fd, tmp = tempfile.mkstemp(suffix=".wav")
    os.close(fd)
    try:
        r = subprocess.run(
            ["ffmpeg", "-y", "-i", str(path), "-vn", "-acodec", "pcm_s16le",
             "-ar", str(sample_rate), "-ac", "1", tmp], capture_output=True)
        if r.returncode != 0:
            raise AudioError(f"ffmpeg could not decode {path}: "
                             + r.stderr.decode(errors="ignore")[-2000:])
        return Path(tmp).read_bytes()
    finally:
        os.remove(tmp)


def load_audio(path: str, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Load a media file as mono float32 at ``sample_rate``."""
    p = Path(path)
    if not p.exists():
        raise AudioError(f"audio file not found: {path}")
    ext = p.suffix.lower()
    data = p.read_bytes()
    if ext == ".wav":
        audio, sr = decode_wav_bytes(data)
    elif ext in _CODECS:
        audio, sr = _CODECS[ext](data)
    else:
        _native.require("av")
        try:
            audio, sr = _native.decode_av(data)
        except AudioError as e:
            audio, sr = decode_wav_bytes(_ffmpeg_wav(p, sample_rate, e))
    return resample(audio, sr, sample_rate)


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
    """Whole-file in-RAM audio, decoded once to mono 16 kHz.

    A PCM16 mono WAV at the target rate keeps its raw int16 samples
    (``audio_i16``), which the engine uploads as they are; its float32
    view (``audio``, x / 32768) is made only when asked for. Any other
    file is decoded by ``load_audio``."""

    def __init__(self, path: str, sample_rate: int = SAMPLE_RATE):
        self.path = path
        self.sample_rate = sample_rate
        self.audio_i16: Optional[np.ndarray] = None
        self._audio_f32: Optional[np.ndarray] = None
        if Path(path).suffix.lower() == ".wav" and Path(path).exists():
            # a bytearray, so the int16 view is writable for torch
            self.audio_i16 = peek_wav_s16_mono(
                bytearray(Path(path).read_bytes()), sample_rate)
        if self.audio_i16 is None:
            self._audio_f32 = load_audio(path, sample_rate)
        n = len(self.audio_i16 if self.audio_i16 is not None
                else self._audio_f32)
        self.duration = n / sample_rate

    @property
    def audio(self) -> np.ndarray:
        """Mono float32 samples."""
        if self._audio_f32 is None:
            self._audio_f32 = self.audio_i16.astype(np.float32) / 32768.0
        return self._audio_f32

    def get_chunk(self, start_sec: float, end_sec: float) -> np.ndarray:
        i0 = max(0, int(round(start_sec * self.sample_rate)))
        i1 = min(len(self.audio), int(round(end_sec * self.sample_rate)))
        return self.audio[i0:i1]
