"""The port's diarization (models/diarize_nets.py, diarize/, the numpy
log-mel, utils/params_io.py's tree helpers) against the JAX package on the
CPU, with the trained weights that ship with it.

Tolerances: the host log-mel identical; segmentation log-probs within 1e-4
absolute and L2-normalised embeddings within 1e-5 absolute of
``segmentation_forward`` / ``embedding_forward`` on the same mels; the
clustering, powerset decode and classical mode exact; on the two-speaker
scene of tests/test_diarize.py, the same two speakers, every turn edge
within one 0.02 s segmentation frame of JAX's and DER between the two
<= 0.01."""

import numpy as np
import pytest
import torch

from whisper_aries_tpu.audio import mel as JM
from whisper_aries_tpu.diarize import cluster as JC
from whisper_aries_tpu.diarize import DiarizationPipeline as JDiarizer
from whisper_aries_tpu.models import diarize_nets as JN
from whisper_aries_tpu.utils import params_io as JP
from whisper_aries_tpu_torch.audio import mel as TM
from whisper_aries_tpu_torch.diarize import cluster as TC
from whisper_aries_tpu_torch.diarize import DiarizationPipeline as TDiarizer
from whisper_aries_tpu_torch.eval.der import diarization_error_rate
from whisper_aries_tpu_torch.models import diarize_nets as TN
from whisper_aries_tpu_torch.utils import params_io as TP

SR = 16_000


def synth_speaker(f0, formant, spans, total_s, seed):
    """tests/test_diarize.py's voice: a harmonic stack at f0 with a formant
    emphasis and a 3.1 Hz envelope over ``spans``, in low noise."""
    rng = np.random.default_rng(seed)
    n = int(total_s * SR)
    t = np.arange(n) / SR
    x = 0.002 * rng.standard_normal(n).astype(np.float32)
    for s, e in spans:
        m = (t >= s) & (t < e)
        tm = t[m]
        v = sum((1.0 / (1 + abs(k * f0 - formant) / 300.0))
                * np.sin(2 * np.pi * k * f0 * tm + k) for k in range(1, 12))
        env = 0.55 + 0.45 * np.sin(2 * np.pi * 3.1 * tm + seed)
        x[m] += (0.25 * v / 3.0 * env).astype(np.float32)
    return x


@pytest.fixture(scope="module")
def scene():
    """tests/test_diarize.py:131's scene: two voices, four turns."""
    a = synth_speaker(110, 500, [(0.5, 4.0), (8.0, 11.5)], 16.0, seed=1)
    b = synth_speaker(280, 2400, [(4.5, 7.5), (12.0, 15.5)], 16.0, seed=2)
    return a + b


@pytest.fixture(scope="module")
def diarizers():
    return JDiarizer(), TDiarizer(device="cpu")


def test_weights_load_as_in_jax(diarizers):
    jd, td = diarizers
    assert td.seg_net is not None and td.emb_net is not None
    for jtree, net in ((jd.seg_params, td.seg_net), (jd.emb_params,
                                                     td.emb_net)):
        want = JP.flatten_params(jtree)
        got = TP.flatten_params(net.tree())
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert td.clustering_threshold == jd.clustering_threshold


def test_params_round_trip(tmp_path):
    tree = TN.init_segmentation()
    path = tmp_path / "seg.safetensors"
    TP.save_params(path, tree)
    back = TP.load_params_into(TN.init_segmentation(seed=5), path)
    for k, v in TP.flatten_params(tree).items():
        assert torch.equal(TP.flatten_params(back)[k], v)
    # copies: the reader's arrays map the file that is rewritten
    flat = {k: np.array(v) for k, v in TP.read_safetensors(path).items()
            if k != "head.w"}
    TP.write_safetensors(path, flat)
    with pytest.raises(ValueError, match="missing 1"):
        TP.load_params_into(TN.init_segmentation(), path)
    with pytest.raises(FileNotFoundError):
        TP.load_params_into(tree, tmp_path / "none.safetensors")


def test_host_mel_matches_jax(scene):
    np.testing.assert_array_equal(TM.log_mel_spectrogram_np(scene[:SR * 10]),
                                  JM.log_mel_spectrogram_np(scene[:SR * 10]))


def test_nets_match_jax_on_the_scene_mels(diarizers, scene):
    jd, td = diarizers
    import jax.numpy as jnp

    mels = np.stack([JM.log_mel_spectrogram_np(scene[s:s + 10 * SR])
                     for s in (0, 5 * SR)])
    want = np.asarray(JN.segmentation_forward(jd.seg_params,
                                              jnp.asarray(mels)))
    got = td.seg_net(torch.from_numpy(mels)).numpy()
    assert got.shape == want.shape == (2, 500, 7)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(TN.powerset_decode(want),
                                  JN.powerset_decode(want))
    np.testing.assert_array_equal(TN.powerset_to_multilabel(want),
                                  JN.powerset_to_multilabel(want))
    crops = np.stack([JM.log_mel_spectrogram_np(scene[s:s + 2 * SR])
                      for s in (SR, 5 * SR, 9 * SR)])
    want = np.asarray(JN.embedding_forward(jd.emb_params,
                                           jnp.asarray(crops)))
    got = td.emb_net(torch.from_numpy(crops)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(TN.melstats_embedding(crops),
                                  JN.melstats_embedding(crops))


@pytest.mark.parametrize("constraint", [{}, {"min_clusters": 4},
                                        {"max_clusters": 2}])
def test_clustering_is_exact(constraint):
    rng = np.random.default_rng(3)
    centres = rng.standard_normal((3, 16))
    emb = (np.repeat(centres, 7, axis=0)
           + 0.4 * rng.standard_normal((21, 16))).astype(np.float32)
    np.testing.assert_array_equal(TC.cosine_distance_matrix(emb),
                                  JC.cosine_distance_matrix(emb))
    got = TC.agglomerative_cluster(emb, threshold=0.5, **constraint)
    want = JC.agglomerative_cluster(emb, threshold=0.5, **constraint)
    np.testing.assert_array_equal(got, want)
    order = rng.permutation(21)
    np.testing.assert_array_equal(TC.relabel_by_first_appearance(got, order),
                                  JC.relabel_by_first_appearance(want, order))


def test_two_speaker_scene_matches_jax(diarizers, scene):
    jd, td = diarizers
    want = jd(scene)
    got = td(scene)
    assert {t["speaker"] for t in got} == {t["speaker"] for t in want} == {
        "SPEAKER_00", "SPEAKER_01"}
    assert [t["speaker"] for t in got] == [t["speaker"] for t in want]
    edges = lambda turns: np.asarray([(t["start"], t["end"]) for t in turns])
    np.testing.assert_allclose(edges(got), edges(want), atol=0.02 + 1e-9,
                               rtol=0)
    assert diarization_error_rate(want, got)["der"] <= 0.01
    # both against the scene's truth
    truth = ([{"start": s, "end": e, "speaker": "A"}
              for s, e in ((0.5, 4.0), (8.0, 11.5))]
             + [{"start": s, "end": e, "speaker": "B"}
                for s, e in ((4.5, 7.5), (12.0, 15.5))])
    d_got = diarization_error_rate(truth, got)["der"]
    d_want = diarization_error_rate(truth, want)["der"]
    assert abs(d_got - d_want) <= 0.01 and d_got < 0.2


def test_noise_tail_third_speaker_as_in_jax(diarizers):
    """The scene followed by 6 s of its noise alone (0.002 a voice): the
    reference reports the tail as a third speaker (its fault, listed in
    ROADMAP.md); the port reports the same turns."""
    jd, td = diarizers
    total = 15.5 + 6.0
    x = (synth_speaker(110, 500, [(0.5, 4.0), (8.0, 11.5)], total, seed=1)
         + synth_speaker(280, 2400, [(4.5, 7.5), (12.0, 15.5)], total,
                         seed=2))
    want, got = jd(x), td(x)
    assert [t["speaker"] for t in got] == [t["speaker"] for t in want]
    assert {t["speaker"] for t in want} == {
        "SPEAKER_00", "SPEAKER_01", "SPEAKER_02"}
    edges = lambda turns: np.asarray([(t["start"], t["end"]) for t in turns])
    np.testing.assert_allclose(edges(got), edges(want), atol=0.02 + 1e-9,
                               rtol=0)


def test_unfiltered_constraint_and_silence(diarizers, scene):
    jd, td = diarizers
    got, raw = td(scene, return_unfiltered=True)
    assert got == td.dedupe(raw)
    one = td(scene[:8 * SR], num_speakers=1)
    assert {t["speaker"] for t in one} == {"SPEAKER_00"}
    x = 0.001 * np.random.default_rng(0).standard_normal(SR * 4)
    assert td(x.astype(np.float32)) == jd(x.astype(np.float32)) == []


def test_classical_mode_matches_jax(scene, tmp_path):
    """Without checkpoints both run VAD subsegments and mel statistics."""
    jd = JDiarizer(model_dir=str(tmp_path))
    td = TDiarizer(model_dir=str(tmp_path), device="cpu")
    assert td.seg_net is None and td.emb_net is None
    assert td.clustering_threshold == jd.clustering_threshold
    assert td(scene) == jd(scene)
