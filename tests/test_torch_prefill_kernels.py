"""Kernels 6 and 1 as rebuilt for Hopper, held by their plans on the CPU:

  * the grouped int8 cross-attention of the prefills (csrc/cross_attn.cu:
    the decode step's split-KV cross-attention): the Python mirror of its
    split plan (ops/decode_layers.py ``cross_split``), and the split scheme
    (ops/cross_attn.py ``cross_attention_q8_split_plain``) against the
    plain version and the JAX package's Pallas kernels in interpret mode;
  * the mel kernel (csrc/mel.cu): its FFT plan and twiddle table
    (ops/mel.py ``fft_plan_power``) against torch.fft.rfft, its band table
    against the dense filterbank, and the features formed by both and by
    its reflected indices (``log_mel_fft_plain``) against the plain version
    and JAX's ``log_mel_pallas`` in interpret mode.

The kernels themselves are held on the card (tests/test_torch_cuda.py,
chip_smoke.py). Inputs are made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_aries_tpu.audio import mel as amel
from whisper_aries_tpu.ops.pallas_cross_attn import (
    cross_attention_q8 as jax_xattn,
    cross_attention_q8_blocked as jax_xattn_blocked,
)
from whisper_aries_tpu.ops.pallas_mel import log_mel_pallas
from whisper_aries_tpu_torch.audio import mel as tmel
from whisper_aries_tpu_torch.ops import cross_attn as XA
from whisper_aries_tpu_torch.ops import decode_layers as DL
from whisper_aries_tpu_torch.ops import mel as M


# ---------------------------------------------------------------------------
# kernel 6: the split plan and the split scheme
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Ta", [1500, 97, 40, 33, 1])
@pytest.mark.parametrize("pairs", [120, 160, 6])
@pytest.mark.parametrize("G", [3, 15])
def test_cross_plan_covers_every_key_once(Ta, pairs, G):
    """The kernel's splits (the decode step's plan, ``cross_split``) at the
    prefills' 6 and 8 windows x 20 heads and at one window of 6 heads, for
    the block-wide kernel (G 3) and the per-warp one (G 15): every key in
    exactly one split, at most 8 splits of a multiple of 32 keys, only the
    last ragged and none empty, on 132 SMs (the H100) and 114; the plan
    reads shapes only."""
    for sms in (132, 114):
        S, C = DL.cross_split(Ta, pairs, G, sms)
        assert 1 <= S <= DL.ATTN_MAX_SPLITS and C % 32 == 0
        covered = np.zeros(Ta, int)
        for s in range(S):
            covered[s * C:min(Ta, (s + 1) * C)] += 1
        assert (covered == 1).all()
        assert (S - 1) * C < Ta <= S * C


def _xattn_operands(rng, B, H, G, T, dh=64):
    q = (2 * rng.standard_normal((B, H, G, dh))).astype(np.float32)
    k = rng.standard_normal((B, H, T, dh)).astype(np.float32)
    v = rng.standard_normal((B, H, T, dh)).astype(np.float32)
    k8, ks = XA.quantize_kv_per_position(torch.from_numpy(k))
    v8, vs = XA.quantize_kv_per_position(torch.from_numpy(v))
    return torch.from_numpy(q), k8, ks / 8.0, v8, vs


@pytest.mark.parametrize("G", [1, 3, 15, 20])
def test_cross_split_scheme_matches_plain_and_jax(G):
    """The kernel's combine of its splits (per-split max, sums rescaled to
    the global max in rank order, P . V partials summed in rank order) on
    97 keys in the plan's 4 splits of 32 (the last holding one key), and
    in 3 splits of 33: against the plain version within 1e-5 of max |want|
    (the same f32 products summed in another order), and against JAX's
    Pallas kernels (interpret) on their time-minor layout within atol
    2e-4, rtol 1e-3 (tests/test_quant.py's tolerance)."""
    rng = np.random.default_rng(G)
    q, k8, ks, v8, vs = _xattn_operands(rng, 2, 3, G, 97)
    S, C = DL.cross_split(97, 2 * 3, G, 132)
    assert (S, C) == (4, 32)
    want = XA.cross_attention_q8_reference(q, k8, ks, v8, vs)
    t = lambda a: jnp.asarray(np.swapaxes(a.numpy(), -1, -2))
    s = lambda a: jnp.asarray(a.numpy()[:, :, None, :])
    jax_args = (jnp.asarray(q.numpy()), t(k8), s(ks), t(v8), s(vs))
    for splits in ((S, C), (3, 33)):
        got = XA.cross_attention_q8_split_plain(q, k8, ks, v8, vs, *splits)
        assert torch.isfinite(got).all()
        err = float((got - want).abs().max()) / float(want.abs().max())
        assert err < 1e-5
        for fn in (jax_xattn, jax_xattn_blocked):
            np.testing.assert_allclose(
                got.numpy(), np.asarray(fn(*jax_args, interpret=True)),
                atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("drop", [0, 3])
def test_cross_split_dropped_partial_is_far_outside_the_limit(drop):
    """The card checks' named mistake, one split's P . V left out of the
    rank-order sum (the last split holds a single key here), lands far
    outside their limits (max_rel 1e-4, mean_rel 1e-5)."""
    rng = np.random.default_rng(5)
    q, k8, ks, v8, vs = _xattn_operands(rng, 2, 3, 3, 97)
    want = XA.cross_attention_q8_reference(q, k8, ks, v8, vs)
    wrong = XA.cross_attention_q8_split_plain(q, k8, ks, v8, vs, 4, 32,
                                              drop=drop)
    d = (wrong - want).abs()
    assert float(d.max()) / float(want.abs().max()) > 1e-3
    assert float(d.mean()) / float(want.abs().mean()) > 1e-4


# ---------------------------------------------------------------------------
# kernel 1: the FFT plan, the band table, the features
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def speechy():
    rng = np.random.default_rng(42)
    t = np.arange(amel.N_SAMPLES) / amel.SAMPLE_RATE
    x = (0.3 * np.sin(2 * np.pi * 220 * t)
         + 0.2 * np.sin(2 * np.pi * 1750 * t + 1.0)
         + 0.05 * rng.standard_normal(amel.N_SAMPLES))
    return (x * 0.5 * (1 + np.sin(2 * np.pi * 2.5 * t))).astype(np.float32)


def test_twiddle_table_is_w400():
    """W_400^j as (cos, -sin), rounded from f64: the entries the passes
    take as W_8, W_5, W_25 and W_200 are those roots."""
    tw = M.fft_twiddles()
    assert tw.shape == (400, 2) and tw.dtype == np.float32
    j = np.arange(400)
    np.testing.assert_array_equal(
        tw[:, 0], np.cos(2 * np.pi * j / 400).astype(np.float32))
    np.testing.assert_array_equal(
        tw[:, 1], (-np.sin(2 * np.pi * j / 400)).astype(np.float32))
    np.testing.assert_allclose(tw[50], [np.sqrt(0.5), -np.sqrt(0.5)],
                               rtol=1e-7)


@pytest.mark.parametrize("kind", ["noise", "tone", "quiet"])
def test_fft_plan_matches_rfft(kind):
    """The kernel's FFT plan on 64 windowed frames against
    torch.fft.rfft's power (f32) and an f64 reference: within 1e-5 and
    2e-6 of the frame's largest bin. "quiet" scales the frames by 1e-4,
    where the plan's relative error must not grow."""
    rng = np.random.default_rng(len(kind))
    n = np.arange(400)
    if kind == "tone":
        x = np.sin(2 * np.pi * 0.0731 * n[None] + rng.uniform(0, 6, (64, 1)))
    else:
        x = rng.standard_normal((64, 400))
    if kind == "quiet":
        x = 1e-4 * x
    wx = torch.from_numpy(x.astype(np.float32)) * tmel.hann_window()
    got = M.fft_plan_power(wx)
    assert got.shape == (64, 201) and got.dtype == torch.float32
    ref32 = torch.fft.rfft(wx, dim=-1).abs() ** 2
    ref64 = (torch.fft.rfft(wx.double(), dim=-1).abs() ** 2)
    top = ref64.amax(-1, keepdim=True)
    assert float(((got - ref32).abs() / top).max()) < 1e-5
    assert float(((got.double() - ref64).abs() / top).max()) < 2e-6


@pytest.mark.parametrize("n_mels", [80, 128])
def test_band_table_product_is_the_dense_product(n_mels):
    """Each band's first bin, count and weights rebuild the filterbank bit
    for bit (at most 14 bins a band at 80 mels, 9 at 128; none empty), and
    the band product equals the dense one within f32 rounding."""
    rows, weights = M.mel_bands(n_mels)
    melw = tmel.mel_filterbank(n_mels)
    dense = np.zeros_like(melw)
    for m, (first, count, offset) in enumerate(rows):
        dense[m, first:first + count] = weights[offset:offset + count]
    np.testing.assert_array_equal(dense, melw)
    assert rows[:, 1].min() >= 1
    assert rows[:, 1].max() == {80: 14, 128: 9}[n_mels]
    assert len(weights) == {80: 391, 128: 394}[n_mels]
    power = torch.from_numpy(
        np.random.default_rng(n_mels).random((4, 201)).astype(np.float32))
    got = M.band_product(power, n_mels)
    want = power @ torch.from_numpy(melw.T.copy())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_reflected_indices_are_reflect_pad():
    """The kernel reads Whisper's center padding by reflected indices."""
    x = torch.arange(1000, dtype=torch.float32)[None]
    s = torch.arange(1400)
    np.testing.assert_array_equal(
        x[:, M.reflected_index(s, 1000)].numpy(),
        tmel.reflect_pad(x).numpy())


@pytest.mark.parametrize("n_mels", [80, 128])
def test_fft_plan_features_match_plain(speechy, n_mels):
    """The features by the kernel's plan against the plain version (cuFFT
    on the card, here the CPU's FFT) within chip_smoke.py's limits: max
    |d| 5e-4, mean |d| 2e-6 in feature units; also on a clip whose length
    is no multiple of the hop."""
    batch = torch.from_numpy(np.stack([speechy, np.roll(speechy, 4321)]))
    for audio in (batch, batch[:, :48123]):
        got = M.log_mel_fft_plain(audio, n_mels)
        want = tmel.log_mel_spectrogram(audio, n_mels)
        assert got.shape == want.shape == (2, n_mels,
                                           audio.shape[1] // 160)
        d = (got - want).abs()
        assert float(d.max()) < 5e-4 and float(d.mean()) < 2e-6


def test_fft_plan_features_match_pallas_interpret(speechy):
    """Against the Pallas kernel in interpret mode, with the bounds of
    tests/test_audio.py's Pallas-vs-numpy test (energetic bins 5e-2, mean
    3e-3)."""
    want = np.asarray(log_mel_pallas(jnp.asarray(speechy[None]), n_mels=80,
                                     interpret=True))[0]
    got = M.log_mel_fft_plain(torch.from_numpy(speechy)[None], 80).numpy()[0]
    diff = np.abs(got - want)
    strong = want > 0.2
    assert diff[strong].max() < 5e-2
    assert diff.mean() < 3e-3
