"""The port's log-mel front-end (whisper_aries_tpu_torch.audio.mel and the
mel kernel's wrapper, ops/mel.py) against the JAX package's, on the CPU.

The wrapper takes its plain FFT version for CPU audio; the kernel itself is
held against that plain version on the card (test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_aries_tpu.audio import mel as amel
from whisper_aries_tpu.ops.pallas_mel import log_mel_pallas
from whisper_aries_tpu_torch.audio import mel as tmel
from whisper_aries_tpu_torch.ops import mel as tops


@pytest.fixture(scope="module")
def speechy():
    rng = np.random.default_rng(42)
    t = np.arange(amel.N_SAMPLES) / amel.SAMPLE_RATE
    x = (0.3 * np.sin(2 * np.pi * 220 * t)
         + 0.2 * np.sin(2 * np.pi * 1750 * t + 1.0)
         + 0.05 * rng.standard_normal(amel.N_SAMPLES))
    return (x * 0.5 * (1 + np.sin(2 * np.pi * 2.5 * t))).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_filterbank_identical(n_mels):
    np.testing.assert_array_equal(tmel.mel_filterbank(n_mels),
                                  amel.mel_filterbank(n_mels))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_plain_mel_matches_jax_fft(speechy, n_mels):
    """Both f32 FFT pipelines: tight (atol 1e-3 in feature units)."""
    batch = np.stack([speechy, np.roll(speechy, 4321)])
    want = np.asarray(amel.log_mel_spectrogram(jnp.asarray(batch),
                                               n_mels=n_mels))
    got = tmel.log_mel_spectrogram(torch.from_numpy(batch), n_mels).numpy()
    assert got.shape == want.shape == (2, n_mels, 3000)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_plain_mel_matches_pallas_interpret(speechy):
    """Against the Pallas kernel in interpret mode, with the bounds of
    tests/test_audio.py's Pallas-vs-numpy test (energetic bins 5e-2, mean
    3e-3)."""
    want = np.asarray(log_mel_pallas(jnp.asarray(speechy[None]), n_mels=80,
                                     interpret=True))[0]
    got = tops.log_mel(torch.from_numpy(speechy), n_mels=80).numpy()[0]
    diff = np.abs(got - want)
    strong = want > 0.2
    assert diff[strong].max() < 5e-2
    assert diff.mean() < 3e-3


def test_plain_mel_matches_numpy_reference(speechy):
    """Against the f64 numpy reference (tests/test_audio.py's fft bounds)."""
    want = amel.log_mel_spectrogram_np(speechy, n_mels=80)
    got = tmel.log_mel_spectrogram(torch.from_numpy(speechy), 80).numpy()[0]
    diff = np.abs(got - want)
    strong = want > 0.2
    assert strong.mean() > 0.1
    assert diff[strong].max() < 2e-3
    assert diff.mean() < 5e-4


def test_wrapper_takes_plain_version_on_cpu(speechy):
    before = tops.mel_power_kernel.launches
    a = torch.from_numpy(speechy)[None]
    np.testing.assert_array_equal(tops.log_mel(a, 80).numpy(),
                                  tmel.log_mel_spectrogram(a, 80).numpy())
    assert tops.mel_power_kernel.launches == before


def test_kernel_tables_are_the_pallas_tables():
    """The mel kernel's Hann table is the Pallas kernel's k = 0 column
    (window x cos 0), and its band table rebuilds the Pallas kernel's
    (201, n_mels) filterbank bit for bit."""
    from whisper_aries_tpu.ops.pallas_mel import _filters

    dft3, melw = _filters(128)
    for k in range(3):
        lo, hi = k * 160, min((k + 1) * 160, 400)
        np.testing.assert_array_equal(tmel.hann_window().numpy()[lo:hi],
                                      dft3[k * 256:k * 256 + hi - lo, 0])
    rows, weights = tops.mel_bands(128)
    dense = np.zeros_like(melw)
    for m, (first, count, offset) in enumerate(rows):
        dense[first:first + count, m] = weights[offset:offset + count]
    np.testing.assert_array_equal(dense, melw)
