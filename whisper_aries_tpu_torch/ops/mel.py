"""Log-mel front-end with the hand-written mel kernel (csrc/mel.cu).

Replaces the JAX package's Pallas mel kernel (ops/pallas_mel.py,
``log_mel_pallas``). ``log_mel`` launches the kernel for CUDA audio and
takes the plain FFT version (audio/mel.py ``log_mel_spectrogram``) only
for audio on the CPU. The kernel reads the reflect padding in place; the
max - 8 floor and (x + 4) / 4 run in torch after it, as they run outside
pallas_call in JAX. ``log_mel_fft_plain`` computes the features by the
kernel's own plan (its FFT passes and twiddle table, ``fft_plan_power``,
and its band table, ``band_product``) for the CPU tests.
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
    hann_window,
    log_mel_spectrogram,
    mel_filterbank,
)
from whisper_aries_tpu_torch.ops import cuda_build as cb


@functools.lru_cache(maxsize=1)
def fft_twiddles() -> np.ndarray:
    """(400, 2) f32: W_400^j = (cos, -sin)(2 pi j / 400), computed in f64
    and rounded: the kernel's only twiddles (W_200, W_25, W_8 and W_5 are
    entries of it)."""
    phase = 2.0 * np.pi * np.arange(N_FFT, dtype=np.float64) / N_FFT
    return np.stack([np.cos(phase), -np.sin(phase)], 1).astype(np.float32)


@functools.lru_cache(maxsize=4)
def mel_bands(n_mels: int):
    """The filterbank as bands: (n_mels, 3) int32 rows of (first bin, bins,
    offset into the weights) and the weights f32 of each band's bins from
    its first nonzero to its last, band after band."""
    melw = mel_filterbank(n_mels)
    rows, weights = [], []
    offset = 0
    for m in range(n_mels):
        nz = np.flatnonzero(melw[m])
        first = int(nz[0]) if nz.size else 0
        count = int(nz[-1]) - first + 1 if nz.size else 0
        rows.append((first, count, offset))
        weights.append(melw[m, first:first + count])
        offset += count
    return (np.asarray(rows, np.int32),
            np.ascontiguousarray(np.concatenate(weights), np.float32))


def band_product(power: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(..., 201) power -> (..., n_mels): each band's sum over its own
    bins, in ascending bin order, as the kernel sums it."""
    rows, weights = mel_bands(n_mels)
    w = torch.as_tensor(weights, device=power.device)
    out = []
    for first, count, offset in rows.tolist():
        acc = torch.zeros(power.shape[:-1], dtype=torch.float32,
                          device=power.device)
        for i in range(count):
            acc = acc + power[..., first + i] * w[offset + i]
        out.append(acc)
    return torch.stack(out, -1)


def fft_plan_power(wx: torch.Tensor) -> torch.Tensor:
    """|rfft(wx)|^2 of windowed frames wx (..., 400) f32 -> (..., 201),
    computed by the kernel's plan from its twiddle table: the 200-point
    complex FFT of z[n] = wx[2n] + i wx[2n+1] in passes of 8, 5 and 5
    (n = 25 n1 + 5 m1 + m2) with their twiddles, read out of the kernel's
    slots, then the real-input split."""
    tw = torch.view_as_complex(torch.as_tensor(fft_twiddles(),
                                               device=wx.device))
    lead = wx.shape[:-1]
    z = torch.complex(wx[..., 0::2], wx[..., 1::2]).reshape(*lead, 8, 25)
    i8 = torch.arange(8, device=wx.device)
    i5 = torch.arange(5, device=wx.device)
    d8 = tw[50 * (i8[:, None] * i8[None, :] % 8)]   # W_8^(k1 n1)
    d5 = tw[80 * (i5[:, None] * i5[None, :] % 5)]   # W_5^(j m)
    y = torch.einsum("kn,...nm->...km", d8, z)       # [k1, n2]
    n2 = torch.arange(25, device=wx.device)
    y = y * tw[(2 * n2[None, :] * i8[:, None]) % N_FFT]
    y = torch.einsum("jm,...kmp->...kjp", d5, y.reshape(*lead, 8, 5, 5))
    y = y * tw[(16 * i5[:, None] * i5[None, :]) % N_FFT]  # W_25^(j1 m2)
    y = torch.einsum("jp,...kip->...kij", d5, y)     # [k1, j1, j2]
    # slot k1 * 25 + 5 j1 + j2 holds Z[k1 + 8 j1 + 40 j2]
    slot = lambda kk: (kk % 8) * 25 + 5 * ((kk // 8) % 5) + kk // 40
    zs = y.reshape(*lead, 200)
    k = torch.arange(N_FFT // 2 + 1, device=wx.device)
    a, b = zs[..., slot(k % 200)], zs[..., slot((200 - k) % 200)].conj()
    x = (a + b) / 2 + tw[k] * (-1j * (a - b) / 2)
    return x.real ** 2 + x.imag ** 2


def reflected_index(s: torch.Tensor, n_samples: int) -> torch.Tensor:
    """The audio sample the kernel reads for padded sample ``s``: s - 200
    reflected at both ends (Whisper's center padding, ``reflect_pad``)."""
    j = (s - N_FFT // 2).abs()
    return torch.where(j >= n_samples, 2 * (n_samples - 1) - j, j)


def log_mel_fft_plain(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """audio (B, N) -> Whisper features (B, n_mels, N // 160) as the kernel
    forms them: frames read by ``reflected_index`` times the Hann window,
    ``fft_plan_power``, ``band_product``, log10 with the 1e-10 clamp, then
    ``finish_log_mel``."""
    n_samples = audio.shape[-1]
    n_frames = n_samples // HOP_LENGTH
    s = (HOP_LENGTH * torch.arange(n_frames, device=audio.device)[:, None]
         + torch.arange(N_FFT, device=audio.device)[None, :])
    frames = audio.float()[:, reflected_index(s, n_samples)]
    power = fft_plan_power(frames * hann_window(audio.device))
    mels = band_product(power, n_mels)
    return finish_log_mel(torch.log10(torch.clamp(mels, min=1e-10))
                          .transpose(1, 2))


_tables = {}


def _device_tables(n_mels: int, device: torch.device):
    """Twiddles, Hann window, band rows and weights on ``device``."""
    key = (n_mels, device)
    if key not in _tables:
        rows, weights = mel_bands(n_mels)
        _tables[key] = tuple(torch.as_tensor(a, device=device) for a in (
            fft_twiddles(), hann_window().numpy(), rows, weights))
    return _tables[key]


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = cb.library("mel")
    fn = lib.aries_mel
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mel_power_kernel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The kernel alone: audio (B, N) f32 CUDA, N > 200 -> log10 mel power
    (B, n_mels, N // 160) f32 (Whisper's reflect padding read in place)."""
    cb.require(audio, "audio", torch.float32)
    if audio.ndim != 2 or audio.shape[1] <= N_FFT // 2:
        raise ValueError(f"audio must be (B, N > {N_FFT // 2}), got "
                         f"{tuple(audio.shape)}")
    B, n_samples = audio.shape
    n_frames = n_samples // HOP_LENGTH
    tw, hann, rows, weights = _device_tables(n_mels, audio.device)
    out = torch.empty((B, n_mels, n_frames), dtype=torch.float32,
                      device=audio.device)
    cb.launch(_kernel(), audio, "mel kernel", cb.ptr(audio), B, n_samples,
              cb.ptr(tw), cb.ptr(hann), cb.ptr(rows), cb.ptr(weights),
              cb.ptr(out), n_frames, n_mels)
    cb.count(mel_power_kernel)
    return out


mel_power_kernel.launches = 0


def log_mel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio (B, 480000) f32 -> Whisper log-mel features (B, n_mels, 3000)."""
    if audio.ndim == 1:
        audio = audio[None]
    if not audio.is_cuda:
        return log_mel_spectrogram(audio, n_mels=n_mels)
    return finish_log_mel(mel_power_kernel(audio.float().contiguous(),
                                           n_mels))

