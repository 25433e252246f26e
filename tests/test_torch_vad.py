"""The port's VAD (the learned net, the energy scorer, the segment state
machine and the window planner) against the JAX package's, on the CPU."""

import numpy as np
import pytest
import torch

from torch_port_util import speechy_audio
from whisper_aries_tpu.models import vad_net as JV
from whisper_aries_tpu.utils.params_io import default_weights_dir, load_params_into
from whisper_aries_tpu.vad import (
    VadOptions as JOpts,
    collect_speech_segments as j_collect,
    get_speech_probs as j_energy,
    plan_windows as j_plan,
)
from whisper_aries_tpu_torch.models import vad_net as TV
from whisper_aries_tpu_torch.vad import (
    VadOptions as TOpts,
    collect_speech_segments as t_collect,
    get_speech_probs as t_energy,
    plan_windows as t_plan,
)

WEIGHTS = default_weights_dir() / "vad.safetensors"


@pytest.fixture(scope="module")
def audio():
    """45 s: speech-like bursts with silent gaps and a quiet tail."""
    x = speechy_audio(45.0, seed=12)
    sr = 16_000
    for a, b in ((6.0, 9.5), (20.0, 21.0), (30.0, 36.0)):
        x[int(a * sr):int(b * sr)] = 0.0005 * np.random.default_rng(1) \
            .standard_normal(int(b * sr) - int(a * sr))
    return x[: int(44.3 * sr)]  # not a multiple of the 19.2 s chunk


def test_reader_matches_safetensors_package():
    from safetensors.numpy import load_file

    want = load_file(str(WEIGHTS))
    got = TV.read_safetensors(WEIGHTS)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert TV.VAD_WEIGHTS.resolve() == WEIGHTS.resolve()


def test_learned_scorer_matches_jax(audio):
    jscore = JV.make_nn_speech_scorer(load_params_into(JV.init_vad(),
                                                       str(WEIGHTS)))
    tscore = TV.make_nn_speech_scorer(TV.load_vad_params())
    want, got = jscore(audio), tscore(audio)
    assert got.shape == want.shape == (len(audio) // 512,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert 0.1 < (got > 0.5).mean() < 0.95  # the net separates the gaps


def test_vad_forward_batched_valid_len(audio):
    params_j = load_params_into(JV.init_vad(), str(WEIGHTS))
    a = np.stack([audio[:16000 * 10], audio[16000 * 10:16000 * 20]])
    a[1, 16000 * 6:] = 0.0
    want = np.asarray(JV.vad_forward(params_j, a, valid_len=np.array(
        [160000, 96000])))
    got = TV.vad_forward(TV.load_vad_params(), torch.from_numpy(a),
                         torch.tensor([160000, 96000])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_energy_scorer_identical(audio):
    np.testing.assert_array_equal(t_energy(audio), j_energy(audio))


def test_window_plan_identical(audio):
    tscore = TV.make_nn_speech_scorer(TV.load_vad_params())
    jscore = JV.make_nn_speech_scorer(load_params_into(JV.init_vad(),
                                                       str(WEIGHTS)))
    dur = len(audio) / 16_000
    for opts in ({}, {"threshold": 0.6, "min_silence_duration_ms": 300}):
        seg_t = t_collect(tscore(audio), TOpts(**opts), total_samples=len(audio))
        seg_j = j_collect(jscore(audio), JOpts(**opts), total_samples=len(audio))
        assert seg_t == seg_j and seg_t
        plan_t = [(w.start, w.end, w.chunk_id) for w in t_plan(seg_t, dur)]
        plan_j = [(w.start, w.end, w.chunk_id) for w in j_plan(seg_j, dur)]
        assert plan_t == plan_j and plan_t
