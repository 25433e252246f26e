"""Log-mel spectrogram front-end (Whisper-compatible), plain PyTorch.

Parameters match Whisper exactly: sr=16 kHz, n_fft=400, hop=160, periodic
Hann window, reflect center padding, slaney-scale/slaney-norm mel filterbank
(fmin=0, fmax=8 kHz), log10 with 1e-10 clamp, dynamic-range floor at max-8,
then (x+4)/4.

``log_mel_spectrogram`` is the FFT version of the JAX package's function of
the same name; it is the plain version the mel kernel (ops/mel.py) is held
against, and what the port runs for tensors on the CPU.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH_S = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_LENGTH_S  # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3_000


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(f < min_log_hz, f / f_sp, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m < min_log_mel, m * f_sp, min_log_hz * np.exp(logstep * (m - min_log_mel)))


@functools.lru_cache(maxsize=4)
def mel_filterbank(n_mels: int = 80, sr: int = SAMPLE_RATE, n_fft: int = N_FFT,
                   fmin: float = 0.0, fmax: float = 8000.0) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, shape (n_mels, n_fft//2+1)."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def hann_window(device=None) -> torch.Tensor:
    n = np.arange(N_FFT)
    return torch.as_tensor(
        0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT)), dtype=torch.float32,
        device=device)


def reflect_pad(audio: torch.Tensor) -> torch.Tensor:
    """(B, N) -> (B, N + n_fft): Whisper's reflect center padding."""
    pad = N_FFT // 2
    return torch.nn.functional.pad(audio[:, None], (pad, pad),
                                   mode="reflect")[:, 0]


def finish_log_mel(log_spec: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, F) log10 mel power -> Whisper features: floor at the
    per-example max - 8, then (x + 4) / 4."""
    gmax = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, gmax - 8.0)
    return (log_spec + 4.0) / 4.0


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Batched log-mel: audio (B, N_SAMPLES) -> features (B, n_mels, N_FRAMES),
    float32 end to end (frame gather + rfft + mel product)."""
    if audio.ndim == 1:
        audio = audio[None]
    x = reflect_pad(audio.float())
    n_frames_total = 1 + (x.shape[1] - N_FFT) // HOP_LENGTH
    frames = x.unfold(1, N_FFT, HOP_LENGTH)[:, :n_frames_total]
    spec = torch.fft.rfft(frames * hann_window(x.device), dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, :-1, :]  # drop last frame
    melw = torch.as_tensor(mel_filterbank(n_mels), device=x.device)
    mels = torch.einsum("mf,btf->bmt", melw, power)
    return finish_log_mel(torch.log10(torch.clamp(mels, min=1e-10)))


def pad_or_trim(audio: np.ndarray, length: int = N_SAMPLES) -> np.ndarray:
    """Pad with zeros or trim to exactly ``length`` samples (host-side)."""
    audio = np.asarray(audio, dtype=np.float32)
    if len(audio) >= length:
        return audio[:length]
    return np.pad(audio, (0, length - len(audio)))


def log_mel_spectrogram_np(audio: np.ndarray, n_mels: int = 80) -> np.ndarray:
    """The host (numpy) log-mel of one clip, shape (n_mels, n_frames): the
    diarizer's front end, which runs on the host as in the JAX package."""
    audio = np.asarray(audio, dtype=np.float32)
    pad = N_FFT // 2
    x = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - N_FFT) // HOP_LENGTH
    idx = np.arange(N_FFT)[None, :] + HOP_LENGTH * np.arange(n_frames)[:, None]
    frames = x[idx]
    n = np.arange(N_FFT)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT))
    spec = np.fft.rfft(frames * window[None, :], axis=1)
    power = np.abs(spec[:-1]) ** 2  # drop the final frame like Whisper
    mels = mel_filterbank(n_mels) @ power.T.astype(np.float32)
    log_spec = np.log10(np.maximum(mels, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)
