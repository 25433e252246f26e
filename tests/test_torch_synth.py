"""The port's synthetic corpus (training/synth.py), its augmentation
(training/augment.py), the trainers' datasets and the DER battery's
scenes are the JAX package's bit for bit: at one np.random.Generator
seed every function returns equal arrays (and leaves the generator in the
same state)."""

import dataclasses

import numpy as np
import pytest

from whisper_aries_tpu.training import augment as JA
from whisper_aries_tpu.training import synth as JS
from whisper_aries_tpu_torch.training import augment as TA
from whisper_aries_tpu_torch.training import synth as TS

SEEDS = (0, 1, 123)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif dataclasses.is_dataclass(a):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    elif isinstance(a, dict):
        assert a == b
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _both(fn_name, module_j, module_t, seed, *args, **kw):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = getattr(module_j, fn_name)(rj, *args, **kw)
    got = getattr(module_t, fn_name)(rt, *args, **kw)
    _equal(got, want)
    assert rj.bit_generator.state == rt.bit_generator.state
    return got


def _voice(seed):
    return JS.random_voice(np.random.default_rng(seed + 1000))


def _port_voice(v):
    return TS.Voice(**dataclasses.asdict(v))


SYNTH_CASES = {
    "random_voice": lambda s: ((), {}),
    "synth_noise": lambda s: ((4000,), {}),
    "synth_music": lambda s: ((4000,), {}),
    "vad_example": lambda s: ((), {"dur_s": 1.5}),
    "diarization_window": lambda s: ((), {"dur_s": 4.0}),
    "embedding_batch": lambda s: ((3, 2), {"dur_s": 0.5}),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(SYNTH_CASES))
def test_synth_functions_bit_for_bit(name, seed):
    args, kw = SYNTH_CASES[name](seed)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = getattr(JS, name)(rj, *args, **kw)
    got = getattr(TS, name)(rt, *args, **kw)
    if name == "embedding_batch":  # (audio, voices)
        _equal(got[0], want[0])
        assert [dataclasses.asdict(v) for v in got[1]] == [
            dataclasses.asdict(v) for v in want[1]]
    else:
        _equal(got, want)
    assert rj.bit_generator.state == rt.bit_generator.state


@pytest.mark.parametrize("seed", SEEDS)
def test_voice_functions_bit_for_bit(seed):
    v = _voice(seed)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    _equal(TS.perturb_voice(rt, _port_voice(v)), JS.perturb_voice(rj, v))
    _equal(TS.synth_utterance(rt, _port_voice(v), 0.8, speech_rate=1.2),
           JS.synth_utterance(rj, v, 0.8, speech_rate=1.2))
    for kind in ("white", "pink", "hum", "babble", "music"):
        _equal(TS.synth_noise(rt, 3000, kind), JS.synth_noise(rj, 3000, kind))
    audio = np.random.default_rng(seed).standard_normal(8000).astype(
        np.float32)
    _equal(TS.apply_far_field(rt, audio), JS.apply_far_field(rj, audio))
    assert rj.bit_generator.state == rt.bit_generator.state


@pytest.mark.parametrize("seed", SEEDS)
def test_augment_functions_bit_for_bit(seed):
    audio = (0.3 * np.random.default_rng(seed).standard_normal(16000)
             ).astype(np.float32)
    for name in ("apply_reverb", "band_limit", "channel_eq",
                 "resample_roundtrip", "clip_distort", "gain_drift"):
        _both(name, JA, TA, seed, audio)
    _both("synthetic_ir", JA, TA, seed)
    _both("synthetic_ir", JA, TA, seed, rt60_s=0.3, dur_s=0.2)
    _both("augment", JA, TA, seed, audio)
    _both("augment", JA, TA, seed, audio, strength=0.5)
    _equal(TA.mu_law_roundtrip(audio), JA.mu_law_roundtrip(audio))
    _equal(TA.mu_law_roundtrip(audio, bits=6), JA.mu_law_roundtrip(audio,
                                                                   bits=6))


@pytest.mark.parametrize("kw", [{}, {"p_aug": 1.0}, {"p_realism": 1.0}])
def test_trainer_datasets_bit_for_bit(kw):
    from whisper_aries_tpu.training import diarize_train as JT
    from whisper_aries_tpu_torch.training import diarize_train as TT

    for name in ("_dataset_vad", "_dataset_seg"):
        _both(name, JT, TT, 5, 2, **kw)
    np.testing.assert_array_equal(TT._POWERSET_LOOKUP, JT._POWERSET_LOOKUP)
    assert TT._PERMS == JT._PERMS


@pytest.mark.parametrize("seed", SEEDS)
def test_conversation_scene_bit_for_bit(seed):
    from whisper_aries_tpu.eval import diarize_battery as JB
    from whisper_aries_tpu_torch.eval import diarize_battery as TB

    _both("conversation_scene", JB, TB, seed, dur_s=8.0)
    _both("conversation_scene", JB, TB, seed, dur_s=8.0, n_speakers=3,
          backchannel_p=0.5, turn_range=(0.5, 1.5))
    audio, ref = TB.conversation_scene(np.random.default_rng(seed),
                                       dur_s=8.0)
    assert TB._overlap_stats(ref, 8.0) == JB._overlap_stats(ref, 8.0)
    for (cj, aj), (ct, at) in zip(JB._conditions(audio, seed, 1.0),
                                  TB._conditions(audio, seed, 1.0)):
        assert cj == ct
        _equal(at, aj)
