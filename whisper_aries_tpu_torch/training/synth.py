"""Synthetic speech corpus for the VAD / diarization trainers (the port's
copy of the JAX package's training/synth.py, kept in step with it: at
one ``np.random.Generator`` seed every function returns the same arrays
bit for bit, which tests/test_torch_synth.py holds).

Formant-synthesised "speakers" (glottal-harmonic source + per-speaker
formant envelope), syllable gating, unvoiced fricative bursts, and
realistic noise (white/pink/hum/babble/music). The generator exposes the
labels the three nets need:

  * VAD: per-512-sample-frame speech flags for noisy mixtures,
  * segmentation: per-20 ms-frame activity of up to 3 local speakers
    (<=2 simultaneously, the pyannote 3.1 powerset constraint),
  * embedding: (speaker, utterance) pairs with per-utterance prosody
    variation but a stable per-speaker vocal tract.

Every function is pure numpy on the host; speakers are fully
parameterised by ``Voice`` so train/val splits draw disjoint speaker sets.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

SR = 16_000


@dataclass(frozen=True)
class Voice:
    """A synthetic speaker: pitch + 3-formant vocal tract + color."""

    f0: float                 # base pitch, Hz
    formants: Tuple[float, float, float]
    bandwidths: Tuple[float, float, float]
    tilt: float               # spectral tilt exponent (harmonic rolloff)
    breathiness: float        # aspiration noise mixed into voicing


def random_voice(rng: np.random.Generator) -> Voice:
    f1 = rng.uniform(300.0, 900.0)
    f2 = rng.uniform(max(f1 + 300, 1000.0), 2600.0)
    f3 = rng.uniform(max(f2 + 300, 2600.0), 3800.0)
    return Voice(
        f0=float(rng.uniform(85.0, 300.0)),
        formants=(float(f1), float(f2), float(f3)),
        bandwidths=(float(rng.uniform(60, 140)), float(rng.uniform(80, 180)),
                    float(rng.uniform(100, 240))),
        tilt=float(rng.uniform(0.8, 1.6)),
        breathiness=float(rng.uniform(0.01, 0.08)),
    )


def perturb_voice(rng: np.random.Generator, base: Voice) -> Voice:
    """A distinct-but-similar speaker: small multiplicative jitters of the
    base voice's parameters (hard negatives for embedding training)."""
    return Voice(
        f0=float(base.f0 * rng.uniform(0.85, 1.18)),
        formants=tuple(float(f * rng.uniform(0.93, 1.08))
                       for f in base.formants),
        bandwidths=tuple(float(b * rng.uniform(0.8, 1.25))
                         for b in base.bandwidths),
        tilt=float(np.clip(base.tilt + rng.uniform(-0.25, 0.25), 0.3, 2.4)),
        breathiness=float(np.clip(
            base.breathiness + rng.uniform(-0.02, 0.02), 0.0, 0.12)),
    )


def _syllable_gate(rng: np.random.Generator, n: int,
                   speech_rate: float = 1.0) -> np.ndarray:
    """(n,) float envelope in [0,1]: syllables grouped into phrases with
    pauses; ~10 ms raised-cosine ramps."""
    gate = np.zeros(n, np.float32)
    t = int(rng.uniform(0, 0.2 * SR))
    while t < n:
        # one phrase: 2-9 syllables
        for _ in range(rng.integers(2, 10)):
            dur = int(rng.uniform(0.08, 0.35) * SR / speech_rate)
            gap = int(rng.uniform(0.01, 0.12) * SR)
            end = min(n, t + dur)
            gate[t:end] = 1.0
            t = end + gap
            if t >= n:
                break
        t += int(rng.uniform(0.15, 0.8) * SR)  # inter-phrase pause
    ramp = int(0.01 * SR)
    if ramp > 1:
        win = np.hanning(2 * ramp + 1).astype(np.float32)
        win /= win.sum()
        gate = np.convolve(gate, win, mode="same")
    return np.clip(gate, 0.0, 1.0)


def _spectral_noise(rng: np.random.Generator, n: int, lo: float, hi: float
                    ) -> np.ndarray:
    """Band-limited noise via rfft masking."""
    x = rng.standard_normal(n).astype(np.float32)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n, 1.0 / SR)
    mask = ((freqs >= lo) & (freqs <= hi)).astype(np.float32)
    y = np.fft.irfft(spec * mask, n=n).astype(np.float32)
    s = y.std()
    return y / max(s, 1e-6)


def synth_utterance(rng: np.random.Generator, voice: Voice, dur_s: float,
                    speech_rate: float = 1.0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """One speaker talking: returns (audio (n,), activity gate (n,))."""
    n = int(dur_s * SR)
    t = np.arange(n, dtype=np.float32) / SR

    # pitch contour: slow wander + vibrato + per-utterance offset
    wander = np.interp(
        np.arange(n), np.linspace(0, n, 12),
        rng.uniform(-0.12, 0.12, 12)
    ).astype(np.float32)
    f0 = voice.f0 * (1.0 + wander + 0.015 * np.sin(2 * np.pi * 5.3 * t))
    phase = 2.0 * np.pi * np.cumsum(f0) / SR  # (n,)

    # formant envelope sampled at harmonic frequencies, slow formant motion
    fmove = 1.0 + 0.08 * np.interp(
        np.arange(n), np.linspace(0, n, 8), rng.uniform(-1, 1, 8)
    ).astype(np.float32)
    k_max = int(min(40, 7600.0 / voice.f0))
    voiced = np.zeros(n, np.float32)
    for k in range(1, k_max + 1):
        fk = k * f0  # (n,)
        amp = np.zeros(n, np.float32)
        for (fc, bw) in zip(voice.formants, voice.bandwidths):
            amp += np.exp(-0.5 * ((fk - fc * fmove) / (1.8 * bw)) ** 2)
        amp = (amp + 0.05) / (k ** voice.tilt)
        voiced += amp * np.sin(k * phase)
    voiced /= max(np.abs(voiced).max(), 1e-6)

    gate = _syllable_gate(rng, n, speech_rate)
    act = (gate > 0.5).astype(np.float32)
    # some syllables are unvoiced fricatives (high-band noise)
    fric = _spectral_noise(rng, n, 2500.0, 7800.0) * 0.35
    fric_sel = (np.interp(
        np.arange(n), np.linspace(0, n, 24), rng.uniform(0, 1, 24)
    ) > 0.8).astype(np.float32)
    asp = voice.breathiness * _spectral_noise(rng, n, 300.0, 6000.0)
    speech = gate * ((1 - fric_sel) * (voiced + asp) + fric_sel * fric)
    level = rng.uniform(0.08, 0.3)
    speech = speech * level
    return speech.astype(np.float32), act


def synth_noise(rng: np.random.Generator, n: int,
                kind: Optional[str] = None) -> np.ndarray:
    """Background noise, unit RMS. Kinds: white, pink, hum, babble —
    plus opt-in "music" (chordal bed with a melody line + percussion
    clicks: a structured, speech-band interferer that energy/VAD nets
    confuse with voicing) — requested explicitly; the random draw keeps
    the original 4-kind distribution so training-gate seeds are stable."""
    if kind is None:
        kind = rng.choice(["white", "pink", "hum", "babble"])
    if kind == "white":
        y = rng.standard_normal(n).astype(np.float32)
    elif kind == "pink":
        spec = np.fft.rfft(rng.standard_normal(n).astype(np.float32))
        f = np.fft.rfftfreq(n, 1.0 / SR)
        spec = spec / np.sqrt(np.maximum(f, 1.0))
        y = np.fft.irfft(spec, n=n).astype(np.float32)
    elif kind == "hum":
        t = np.arange(n, dtype=np.float32) / SR
        y = sum(
            a * np.sin(2 * np.pi * 50.0 * h * t)
            for h, a in ((1, 1.0), (2, 0.4), (3, 0.2))
        ) + 0.2 * rng.standard_normal(n).astype(np.float32)
    elif kind == "music":
        y = synth_music(rng, n)
    else:  # babble: many faint distant speakers
        y = np.zeros(n, np.float32)
        for _ in range(6):
            s, _ = synth_utterance(rng, random_voice(rng), n / SR,
                                   speech_rate=1.3)
            y += s
    y = np.asarray(y, np.float32)
    return y / max(y.std(), 1e-6)


# root-note frequencies of a small chord progression (A minor-ish)
_MUSIC_ROOTS = (110.0, 130.81, 146.83, 164.81, 196.0, 220.0)


def synth_music(rng: np.random.Generator, n: int) -> np.ndarray:
    """A simple music bed: sustained triads changing every ~2 s, a melody
    line an octave up, soft percussion clicks on a steady grid. Heavy
    harmonic energy in the speech band — the condition the reference's
    real-world meeting audio (intro/outro jingles, hold music) exhibits
    and pure white/pink noise does not."""
    t = np.arange(n, dtype=np.float32) / SR
    y = np.zeros(n, np.float32)
    bar = int(SR * float(rng.uniform(1.5, 2.5)))
    for b0 in range(0, n, bar):
        b1 = min(n, b0 + bar)
        root = float(rng.choice(_MUSIC_ROOTS))
        third = root * (2 ** (3 / 12) if rng.uniform() < 0.5
                        else 2 ** (4 / 12))
        fifth = root * 2 ** (7 / 12)
        tb = t[b0:b1] - t[b0]
        env = np.minimum(1.0, tb / 0.05) * np.exp(-tb / 3.0)
        chord = np.zeros(b1 - b0, np.float32)
        for f0 in (root, third, fifth):
            for h, a in ((1, 1.0), (2, 0.5), (3, 0.25), (4, 0.12)):
                chord += a * np.sin(
                    2 * np.pi * f0 * h * tb
                    + float(rng.uniform(0, 2 * np.pi)))
        y[b0:b1] += (env * chord).astype(np.float32)
        # melody: 4 notes per bar an octave up
        step = (b1 - b0) // 4
        for k in range(4):
            m0 = b0 + k * step
            m1 = min(b1, m0 + step)
            if m1 <= m0:
                continue
            fm = root * 2.0 * 2 ** (int(rng.integers(0, 8)) / 12)
            tm = t[m0:m1] - t[m0]
            me = np.minimum(1.0, tm / 0.02) * np.exp(-tm / 0.5)
            y[m0:m1] += 0.6 * (me * np.sin(2 * np.pi * fm * tm)
                               ).astype(np.float32)
    # percussion: short filtered-noise clicks on an 8th-note grid
    beat = bar // 4
    for p0 in range(0, n, max(beat // 2, 1)):
        dur = int(0.03 * SR)
        p1 = min(n, p0 + dur)
        click = rng.standard_normal(p1 - p0).astype(np.float32)
        click *= np.exp(-np.arange(p1 - p0, dtype=np.float32) / (0.005 * SR))
        y[p0:p1] += 0.8 * click
    return y / max(y.std(), 1e-6)


def apply_far_field(rng: np.random.Generator, audio: np.ndarray,
                    rt60_s: float = 0.45, direct_ratio: float = 0.35
                    ) -> np.ndarray:
    """Far-field/room simulation: synthetic exponential-decay RIR
    (sparse early reflections + dense late tail) convolved via FFT, plus
    the level drop and high-frequency rolloff of distance. Label
    -preserving (same time support, energy smeared by < rt60)."""
    n = len(audio)
    rir_n = int(rt60_s * SR)
    rir = np.zeros(rir_n, np.float32)
    rir[0] = 1.0
    # early reflections: 6-12 sparse taps in the first 80 ms
    for _ in range(int(rng.integers(6, 13))):
        d = int(rng.uniform(0.004, 0.08) * SR)
        if d < rir_n:
            rir[d] += float(rng.uniform(0.2, 0.7)) * (
                1.0 if rng.uniform() < 0.5 else -1.0)
    # late tail: decaying gaussian noise
    tail = rng.standard_normal(rir_n).astype(np.float32)
    decay = np.exp(-6.9 * np.arange(rir_n, dtype=np.float32) / rir_n)
    rir += (1.0 - direct_ratio) * 0.5 * tail * decay
    rir[0] = direct_ratio * 2.0
    wet = np.fft.irfft(
        np.fft.rfft(audio, n + rir_n) * np.fft.rfft(rir, n + rir_n),
        n + rir_n)[:n].astype(np.float32)
    # distance high-frequency rolloff (~6 dB/octave above 2 kHz)
    spec = np.fft.rfft(wet)
    f = np.fft.rfftfreq(n, 1.0 / SR)
    spec *= 1.0 / np.sqrt(1.0 + (f / 2000.0) ** 2)
    wet = np.fft.irfft(spec, n).astype(np.float32)
    peak_in = max(np.abs(audio).max(), 1e-6)
    peak_out = max(np.abs(wet).max(), 1e-6)
    return wet * (peak_in / peak_out) * 0.8


# ---------------------------------------------------------------------------
# Labelled examples
# ---------------------------------------------------------------------------

VAD_FRAME = 512  # matches vad/energy.py and models/vad_net.py


def vad_example(rng: np.random.Generator, dur_s: float = 9.92
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(audio (n,), labels (n//512,)) noisy mixture with frame speech flags."""
    n = int(dur_s * SR) // VAD_FRAME * VAD_FRAME
    has_speech = rng.uniform() > 0.2
    if has_speech:
        speech, gate = synth_utterance(rng, random_voice(rng), n / SR)
    else:
        speech, gate = np.zeros(n, np.float32), np.zeros(n, np.float32)
    noise = synth_noise(rng, n)
    snr_db = rng.uniform(-2.0, 30.0)
    sp_rms = speech.std() if has_speech else 0.0
    noise_level = (sp_rms / (10 ** (snr_db / 20.0))) if sp_rms > 0 else \
        rng.uniform(0.005, 0.08)
    audio = speech + noise_level * noise
    labels = gate[: n // VAD_FRAME * VAD_FRAME].reshape(-1, VAD_FRAME)
    labels = (labels.mean(axis=1) > 0.4).astype(np.float32)
    return audio.astype(np.float32), labels


SEG_FRAME_S = 0.02  # segmentation label hop (mel 10ms x conv stride 2)


def diarization_window(rng: np.random.Generator, dur_s: float = 10.0,
                       voices: Optional[List[Voice]] = None,
                       overlap_p: float = 0.3,
                       backchannel_p: float = 0.0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(audio (n,), activity (n_frames, 3)) — a multi-speaker conversation
    window with turn-taking and <=2-way overlap (powerset constraint).

    ``overlap_p``: probability the next turn starts before this one ends
    (the original fixed 0.3). ``backchannel_p``: per-turn probability of
    a short (0.3-1.0 s) interjection by ANOTHER speaker fully inside the
    turn — the real-meeting overlap event turn-start overlap alone does
    not model; defaults OFF so existing training-gate seed distributions
    are unchanged (retrains opt in explicitly)."""
    n = int(dur_s * SR)
    n_frames = int(round(dur_s / SEG_FRAME_S / 2)) * 2  # even, 500 for 10 s
    if voices is None:
        # ~12% zero-speaker windows: the net must stay quiet on pure
        # noise/silence (miscalibration here hallucinated speakers on
        # silence in the first training round)
        n_spk = 0 if rng.uniform() < 0.12 else int(rng.integers(1, 4))
        voices = [random_voice(rng) for _ in range(n_spk)]
    K = len(voices)
    audio = np.zeros(n, np.float32)
    act = np.zeros((n, max(K, 1)), np.float32)

    t = rng.uniform(0.0, 1.0)
    cur = int(rng.integers(0, K)) if K else 0
    while K and t < dur_s:
        turn = rng.uniform(0.8, 3.5)
        i0, i1 = int(t * SR), min(n, int((t + turn) * SR))
        if i1 - i0 > SR // 10:
            # synth_utterance rounds duration*SR down — request a hair more
            # and slice to the exact span
            seg, gate = synth_utterance(rng, voices[cur],
                                        (i1 - i0) / SR + 1e-4)
            audio[i0:i1] += seg[: i1 - i0]
            # pyannote-convention TURN-level activity: the speaker is
            # active across their whole turn, inter-syllable dips
            # included. (Labelling with the syllable envelope `gate`
            # trained a net whose output flickered at ~3 Hz inside every
            # utterance, fragmenting pipeline turns to 0.3 s shards.)
            act[i0:i1, cur] = 1.0
            # back-channel interjection: a short burst by another speaker
            # fully INSIDE this turn (2-way overlap by construction).
            # backchannel_p == 0 must not even DRAW from rng — an extra
            # draw would shift the stream and reroll every training-gate
            # seed distribution (tests/test_training.py gotcha).
            if (K > 1 and backchannel_p > 0.0 and (i1 - i0) > SR
                    and rng.uniform() < backchannel_p):
                other = int(rng.integers(0, K))
                other = other if other != cur else (other + 1) % K
                bdur = float(rng.uniform(0.3, 1.0))
                b0 = int(rng.uniform(i0 / SR + 0.2,
                                     max(i0 / SR + 0.21,
                                         i1 / SR - bdur - 0.1)) * SR)
                b1 = min(i1, b0 + int(bdur * SR))
                if b1 - b0 > SR // 10:
                    bseg, _ = synth_utterance(
                        rng, voices[other], (b1 - b0) / SR + 1e-4,
                        speech_rate=float(rng.uniform(1.0, 1.4)))
                    audio[b0:b1] += bseg[: b1 - b0]
                    act[b0:b1, other] = 1.0
        # overlap: next speaker may start before this turn ends
        if K > 1 and rng.uniform() < overlap_p:
            t = t + turn * rng.uniform(0.6, 0.95)
        else:
            t = t + turn + rng.uniform(0.05, 0.6)
        if K > 1:
            nxt = int(rng.integers(0, K))
            cur = nxt if nxt != cur else (nxt + 1) % K
    # noise floor spans quiet rooms to moderately noisy recordings
    # (log-uniform 0.002..0.05 amplitude vs speech levels 0.08-0.3);
    # silence-only windows get the same range. (A first training round
    # with noise up to 0.12 — sub-0dB SNR vs quiet speakers — collapsed
    # the net to marginal predictions.)
    noise_level = float(np.exp(rng.uniform(np.log(0.002), np.log(0.05))))
    audio += noise_level * synth_noise(rng, n)

    # sample-level activity -> 20 ms frames, pad speaker axis to 3
    K0 = act.shape[1]
    frames = act[: n_frames * int(SEG_FRAME_S * SR)].reshape(
        n_frames, int(SEG_FRAME_S * SR), K0
    ).mean(axis=1)
    frames = (frames > 0.4).astype(np.float32)
    # enforce <=2 simultaneous (drop the weakest when 3 collide)
    over = frames.sum(axis=1) > 2
    if over.any():
        frames[over, 2:] = 0.0
    out = np.zeros((n_frames, 3), np.float32)
    out[:, :K0] = frames
    return audio.astype(np.float32), out


def embedding_batch(rng: np.random.Generator, n_speakers: int, n_utt: int,
                    dur_s: float = 2.0, voices: Optional[List[Voice]] = None,
                    vary_duration: bool = False
                    ) -> Tuple[np.ndarray, List[Voice]]:
    """(audio (n_speakers*n_utt, n), voices): per-speaker utterance groups
    (row-major speaker blocks) for contrastive training.

    ``vary_duration=True`` matches the serving distribution exactly: the
    diarization pipeline embeds FIXED 2 s crops where short activity
    regions are loop-tiled (diarize/pipeline.py:_embed) — so utterances
    here are synthesised at 0.4-3 s and center-cropped / loop-tiled to
    ``dur_s`` the same way.
    """
    if voices is None:
        # ~half the batches contain HARD-NEGATIVE clusters: groups of
        # voices derived from one base by small f0/formant perturbations
        # (distinct speakers with close timbres). Independent sampling
        # alone yields mostly easy negatives, and the embedding net then
        # fails to separate real close-voice pairs at clustering time.
        voices = []
        while len(voices) < n_speakers:
            if rng.uniform() < 0.5 and n_speakers - len(voices) >= 2:
                base = random_voice(rng)
                k = int(min(rng.integers(2, 4), n_speakers - len(voices)))
                for _ in range(k):
                    voices.append(perturb_voice(rng, base))
            else:
                voices.append(random_voice(rng))
    n = int(dur_s * SR)
    rows = []
    for v in voices:
        for _ in range(n_utt):
            raw_dur = (float(rng.uniform(0.4, 3.0)) if vary_duration
                       else dur_s)
            s, _ = synth_utterance(rng, v, raw_dur + 1e-4,
                                   speech_rate=float(rng.uniform(0.8, 1.3)))
            if len(s) >= n:
                mid = len(s) // 2
                s = s[mid - n // 2 : mid - n // 2 + n]
            else:
                s = np.tile(s, int(np.ceil(n / max(len(s), 1))))[:n]
            s = s + rng.uniform(0.002, 0.02) * synth_noise(rng, n)
            rows.append(s[:n])
    return np.stack(rows).astype(np.float32), voices
