"""The port's beam search (whisper_aries_tpu_torch.decoding.generate.
beam_search_decode) and the engine's beam path against the JAX package's,
on the CPU in f32, on shared tiny int8-quantized weights and the same
encoder output. The JAX side always runs its permute-mode XLA path, with
beam_reorder, beam_tail and beam_group passed explicitly (the engine reads
them from the environment at trace time)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from torch_port_util import (
    PieceTokenizer,
    random_jax_tree,
    speechy_audio,
    to_jax,
)
from whisper_aries_tpu.decoding import generate as JG
from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.ops.quant import quantize_model_params as jax_quantize
from whisper_aries_tpu_torch.config import load_config
from whisper_aries_tpu_torch.decoding import generate as TG
from whisper_aries_tpu_torch.models import whisper as TW

SP = build_special_tokens(24, 2)  # 24 text pieces, 2 languages
# d 128 = 2 heads x dh 64, 2 layers, 40 audio positions, the real
# timestamp grammar (1501 timestamp tokens)
DIMS_J = JW.WhisperDims(80, 40, 128, 2, 2, SP.n_vocab, 448, 128, 2, 2)
DIMS_T = TW.WhisperDims(*[getattr(DIMS_J, f) for f in
                          DIMS_J.__dataclass_fields__])
IDS = dict(eot=SP.eot, sot=SP.sot, no_speech=SP.no_speech,
           no_timestamps=SP.no_timestamps, timestamp_begin=SP.timestamp_begin,
           blank=20, n_vocab=SP.n_vocab)
K, SAMPLE_LEN = 5, 12


@pytest.fixture(scope="module")
def setup():
    tree = random_jax_tree(DIMS_J, seed=8, weight_std=0.08)
    jparams = JW.fuse_decoder_qkv(jax_quantize(to_jax(tree)))
    tparams = TW.fuse_decoder_qkv(TW.params_from_jax(
        jax.tree.map(np.asarray, jax_quantize(to_jax(tree)))))
    rng = np.random.default_rng(9)
    mel = rng.standard_normal((3, 80, 80)).astype(np.float32)
    xa = np.asarray(JW.encode(to_jax(tree), jnp.asarray(mel), DIMS_J))
    mask = np.zeros(SP.n_vocab, np.float32)
    mask[[SP.sot, SP.sot_prev, SP.no_speech, SP.transcribe]] = TG.NEG_INF
    prompt = np.tile(np.asarray(SP.sot_sequence("en"), np.int32), (3, 1))
    return jparams, tparams, xa, mask, prompt


def _jax_beam(setup, kv_int8, self_int8, tail="xla", rep=None,
              reorder="xla", **kw):
    jparams, _, xa, mask, prompt = setup
    out = JG.beam_search_decode(
        jparams, jnp.asarray(xa), jnp.asarray(prompt), DIMS_J,
        JG.DecodeSpecialIds(**IDS), jnp.asarray(mask), jnp.int32(0),
        beam_size=K, sample_len=SAMPLE_LEN, kv_int8=kv_int8,
        self_kv_int8=self_int8, beam_reorder=reorder, beam_tail=tail,
        beam_group=1,
        repetition_penalty=None if rep is None else jnp.float32(rep), **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _torch_beam(setup, kv_int8, self_int8, rep=None, fused=False, **kw):
    _, tparams, xa, mask, prompt = setup
    out = TG.beam_search_decode(
        tparams, torch.from_numpy(xa.copy()),
        torch.from_numpy(prompt).long(), DIMS_T, TG.DecodeSpecialIds(**IDS),
        torch.from_numpy(mask), 0, beam_size=K, sample_len=SAMPLE_LEN,
        kv_int8=kv_int8, self_kv_int8=self_int8, repetition_penalty=rep,
        fused=fused, **kw)
    return {k: v.numpy() for k, v in out.items()}


CASES = {
    "int8-cross": dict(kv_int8=True, self_int8=False),
    "int8-both-patience2-lp": dict(kv_int8=True, self_int8=True,
                                   patience=2.0, length_penalty=0.6),
    "f32-cross-rep-ngram": dict(kv_int8=False, self_int8=False,
                                rep=1.5, no_repeat_ngram_size=3,
                                length_penalty=0.6),
    "f32-cross-int8-self-patience2-ngram": dict(
        kv_int8=False, self_int8=True, patience=2.0,
        no_repeat_ngram_size=3),
    "int8-cross-jax-tail-kernel": dict(kv_int8=True, self_int8=False,
                                       rep=1.5, tail="kernel"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_beam_search_matches_jax(setup, case):
    """K = 5 with the timestamp grammar: tokens, all_tokens and n_sampled
    identical; sum_logprob, avg_logprob and no_speech_prob within 1e-5;
    every hypothesis's final score within 1e-5 (1e-3 with an int8 cache,
    see below)."""
    kw = dict(CASES[case])
    tail = kw.pop("tail", "xla")
    want = _jax_beam(setup, tail=tail, **kw)
    got = _torch_beam(setup, **kw)
    for k in ("tokens", "all_tokens", "n_sampled"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("sum_logprob", "avg_logprob", "no_speech_prob"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    # every hypothesis's score; with an int8 cache a value on a rounding
    # boundary can land one step apart in the two packages (the JAX
    # package's int8 cross K/V divide by 127 as a product; the two sum the
    # appended self K/V in other orders), which moves a hypothesis that
    # was not chosen by up to ~2e-4
    int8 = kw.get("kv_int8") or kw.get("self_int8")
    live = np.abs(want["all_scores"]) < 1e30
    np.testing.assert_allclose(got["all_scores"][live],
                               want["all_scores"][live],
                               rtol=1e-3 if int8 else 1e-5)
    assert (got["tokens"][:, setup[4].shape[1]] >= SP.timestamp_begin).all()


@pytest.mark.parametrize("self_int8", [False, True])
def test_beam_fused_steps_match_decoder_step(setup, self_int8):
    """The steps through the decoder-layer kernels' plain version (CPU
    tensors, the card's path) give the tokens of the decoder_step path.
    With an int8 self cache the fused path quantizes after the prefill
    (as the card does), decoder_step before the prefill attends, so the
    scores agree to 1e-3 there and 1e-4 else."""
    a = _torch_beam(setup, True, self_int8)
    b = _torch_beam(setup, True, self_int8, fused=True)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_allclose(a["sum_logprob"], b["sum_logprob"],
                               rtol=1e-3 if self_int8 else 1e-4)
    assert int(b["steps"]) >= 2 and 0 <= int(b["permuted"]) < int(b["steps"])


def test_beam_one_equals_greedy_tokens(setup):
    """K = 1 with patience 1 is greedy search: the same tokens."""
    _, tparams, xa, mask, prompt = setup
    common = (tparams, torch.from_numpy(xa.copy()),
              torch.from_numpy(prompt).long(), DIMS_T,
              TG.DecodeSpecialIds(**IDS), torch.from_numpy(mask), 0)
    beam = TG.beam_search_decode(*common, beam_size=1, sample_len=SAMPLE_LEN,
                                 kv_int8=True)
    greedy = TG.greedy_decode(*common, 0.0, sample_len=SAMPLE_LEN,
                              kv_int8=True)
    np.testing.assert_array_equal(beam["tokens"].numpy(),
                                  greedy["tokens"].numpy())


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_pair(tmp_path_factory):
    from whisper_aries_tpu_torch.audio.decode import write_wav

    tok = PieceTokenizer(build_special_tokens)
    dims_j = JW.WhisperDims(80, 1500, 64, 2, 2, tok.specials.n_vocab, 448,
                            64, 2, 2)
    dims_t = TW.WhisperDims(*[getattr(dims_j, f)
                              for f in dims_j.__dataclass_fields__])
    tree = random_jax_tree(dims_j, seed=11, weight_std=0.08)
    path = str(tmp_path_factory.mktemp("torch_beam_engine") / "long.wav")
    write_wav(path, speechy_audio(70.0, seed=5), 16_000)
    return tok, dims_j, dims_t, tree, path


def _segments(res):
    return [(s["text"], s["start"], s["end"]) for s in res["segments"]]


@pytest.mark.parametrize("compute_type", ["bf16", "int8"])
def test_beam_transcribe_file_matches_jax_engine(engine_pair, tmp_path,
                                                 compute_type):
    """config decode.beam_size = 5 in both engines: identical segment text
    and timestamps, and the port's decodes ran beam search. Cross K/V stay
    f32 here: the JAX package's int8 cross K/V differ from the port's in
    values on a rounding boundary (XLA turns the division by 127 into a
    product inside its layer scan), which moves scores by ~1e-4, and over
    a whole file beam search meets hypotheses tied that closely; the int8
    cross K/V are held in test_beam_search_matches_jax."""
    kv = None
    from whisper_aries_tpu.config import load_config as jax_load_config
    from whisper_aries_tpu.pipeline.engine import AriesTranscriber as JEngine
    from whisper_aries_tpu_torch.pipeline.engine import (
        AriesTranscriber as TEngine,
    )

    tok, dims_j, dims_t, tree, wav = engine_pair
    over = {"decode.beam_size": 5}
    kw = dict(windows_per_device=2, compute_type=compute_type,
              kv_cache_dtype=kv, _tokenizer=tok)
    jeng = JEngine(model_size="tiny-torch", _params=to_jax(tree),
                   _dims=dims_j, config=jax_load_config(overrides=over), **kw)
    teng = TEngine(model_size="tiny-torch", device="cpu",
                   _params=TW.params_from_jax(tree), _dims=dims_t,
                   config=load_config(overrides=over), **kw)
    call = dict(temperature=(0.0,), max_new_tokens=16,
                output_formats=("txt", "srt"))
    want = jeng.transcribe_file(wav, output_dir=str(tmp_path / "jax"), **call)
    got = teng.transcribe_file(wav, output_dir=str(tmp_path / "torch"),
                               **call)
    assert got["num_windows"] == want["num_windows"] >= 3
    assert _segments(got) == _segments(want) and got["segments"]
    decodes = teng.last_stats["decodes"]
    assert all(d["beam_size"] == 5 and d["rows"] == 5 * d["windows"]
               for d in decodes)
    for fmt in ("txt", "srt"):
        with open(got["output_files"][fmt], "rb") as a, \
                open(want["output_files"][fmt], "rb") as b:
            assert a.read() == b.read()


def test_transcribe_file_beam_arguments_override_config(engine_pair,
                                                        tmp_path):
    """beam_size / patience / length_penalty None take config.decode's;
    an explicit beam_size=1 decodes greedily."""
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    tok, _, dims_t, tree, wav = engine_pair
    eng = AriesTranscriber(
        model_size="tiny-torch", device="cpu",
        _params=TW.params_from_jax(tree), _dims=dims_t, _tokenizer=tok,
        config=load_config(overrides={"decode.beam_size": 3,
                                      "decode.patience": 2.0}))
    call = dict(temperature=(0.0,), max_new_tokens=6, output_formats=())
    res = eng.transcribe_file(wav, **call)
    assert {d["beam_size"] for d in eng.last_stats["decodes"]} == {3}
    res = eng.transcribe_file(wav, beam_size=1, **call)
    assert {d["beam_size"] for d in eng.last_stats["decodes"]} == {1}


def test_fallback_shared_cross_equals_repeated_windows(engine_pair):
    """The ladder's best_of rows share their window's cross K/V (G =
    best_of): the same sampled tokens as decoding the windows repeated."""
    tok, _, dims_t, tree, _ = engine_pair
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    eng = AriesTranscriber(model_size="tiny-torch", device="cpu",
                           _params=TW.params_from_jax(tree), _dims=dims_t,
                           _tokenizer=tok, kv_cache_dtype="int8")
    rng = np.random.default_rng(2)
    xa = torch.from_numpy(rng.standard_normal((2, 1500, 64)).astype(
        np.float32))
    best_of = 3
    prompt = np.repeat(np.tile(np.asarray(
        tok.specials.sot_sequence("en"), np.int64), (2, 1)), best_of, axis=0)
    shared = eng._decode_batch(xa, prompt, 0.7, 10, seed=5)
    repeated = eng._decode_batch(torch.repeat_interleave(xa, best_of, dim=0),
                                 prompt, 0.7, 10, seed=5)
    np.testing.assert_array_equal(shared["tokens"], repeated["tokens"])
    np.testing.assert_allclose(shared["sum_logprob"],
                               repeated["sum_logprob"], rtol=1e-5)
    assert eng.last_stats["decodes"][0]["windows"] == 2
    assert eng.last_stats["decodes"][0]["rows"] == 6


def test_beam_fused_f32_cache_matches_jax_megakernel(setup):
    """compute_type "f32" without an int8 self cache at beam 5: the port's
    fused steps (plain version, x and the self cache f32) against the JAX
    package's beam search through its Pallas megakernel
    (``beam_reorder="mega"``, interpret mode on the CPU) at f32: tokens,
    all_tokens and n_sampled identical; every score to the int8 cases'
    tolerance (1e-3 relative: the int8 cross K/V)."""
    want = _jax_beam(setup, True, False, reorder="mega")
    got = _torch_beam(setup, True, False, fused=True)
    for k in ("tokens", "all_tokens", "n_sampled"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("sum_logprob", "avg_logprob", "no_speech_prob"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5)
    live = np.abs(want["all_scores"]) < 1e30
    np.testing.assert_allclose(got["all_scores"][live],
                               want["all_scores"][live], rtol=1e-3)
