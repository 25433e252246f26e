"""Log-mel front-end with the hand-written mel kernel (csrc/mel.cu).

Replaces the JAX package's Pallas mel kernel (ops/pallas_mel.py,
``log_mel_pallas``). ``log_mel`` launches the kernel for CUDA audio and
takes the plain FFT version (audio/mel.py ``log_mel_spectrogram``) only
for audio on the CPU. The reflect pad, the max - 8 floor and (x + 4) / 4
run in torch around the kernel, as they run outside pallas_call in JAX.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from whisper_aries_tpu_torch.audio.mel import (
    HOP_LENGTH,
    N_FFT,
    finish_log_mel,
    log_mel_spectrogram,
    mel_filterbank,
    reflect_pad,
)
from whisper_aries_tpu_torch.ops import cuda_build as cb


@functools.lru_cache(maxsize=2)
def dft_table(n_mels: int):
    """(400, 402) f32 Hann*cos | Hann*-sin table and the (201, n_mels)
    filterbank, host numpy."""
    n = np.arange(N_FFT, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT))
    k = np.arange(N_FFT // 2 + 1, dtype=np.float64)
    phase = 2.0 * np.pi * k[:, None] * n[None, :] / N_FFT
    cos_f = (np.cos(phase) * window).astype(np.float32)
    sin_f = (-np.sin(phase) * window).astype(np.float32)
    dft = np.ascontiguousarray(np.concatenate([cos_f.T, sin_f.T], axis=1))
    return dft, np.ascontiguousarray(mel_filterbank(n_mels).T)


_tables = {}


def _device_tables(n_mels: int, device: torch.device):
    key = (n_mels, device)
    if key not in _tables:
        dft, melw = dft_table(n_mels)
        _tables[key] = (torch.as_tensor(dft, device=device),
                        torch.as_tensor(melw, device=device))
    return _tables[key]


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = cb.library("mel")
    fn = lib.aries_mel
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mel_power_kernel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The kernel alone: audio (B, N) f32 CUDA -> log10 mel power
    (B, N // 160, n_mels) f32."""
    cb.require(audio, "audio", torch.float32)
    if audio.ndim != 2:
        raise ValueError(f"audio must be (B, N), got {tuple(audio.shape)}")
    B, n_samples = audio.shape
    n_frames = n_samples // HOP_LENGTH
    x = reflect_pad(audio).contiguous()
    dft, melw = _device_tables(n_mels, audio.device)
    out = torch.empty((B, n_frames, n_mels), dtype=torch.float32,
                      device=audio.device)
    cb.launch(_kernel(), x, "mel kernel", cb.ptr(x), B, x.shape[1],
              cb.ptr(dft), cb.ptr(melw), cb.ptr(out), n_frames, n_mels)
    mel_power_kernel.launches += 1
    return out


mel_power_kernel.launches = 0


def log_mel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio (B, 480000) f32 -> Whisper log-mel features (B, n_mels, 3000)."""
    if audio.ndim == 1:
        audio = audio[None]
    if not audio.is_cuda:
        return log_mel_spectrogram(audio, n_mels=n_mels)
    power = mel_power_kernel(audio.float().contiguous(), n_mels)
    return finish_log_mel(power.transpose(1, 2))

