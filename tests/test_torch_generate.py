"""The port's greedy decode and language ID (whisper_aries_tpu_torch.
decoding.generate) against the JAX package's, on the CPU in f32, on shared
tiny int8-quantized weights and the same encoder output."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import random_jax_tree, to_jax
from whisper_aries_tpu.decoding import generate as JG
from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.ops.quant import quantize_model_params as jax_quantize
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


@pytest.fixture(scope="module")
def setup():
    tree = random_jax_tree(DIMS_J, seed=8, weight_std=0.08)
    jparams = JW.fuse_decoder_qkv(jax_quantize(to_jax(tree)))
    tparams = TW.fuse_decoder_qkv(
        TW.params_from_jax(jax.tree.map(np.asarray, jax_quantize(to_jax(tree)))))
    rng = np.random.default_rng(9)
    mel = rng.standard_normal((3, 80, 80)).astype(np.float32)
    xa = np.asarray(JW.encode(to_jax(tree), jnp.asarray(mel), DIMS_J))
    mask = np.zeros(SP.n_vocab, np.float32)
    mask[[SP.sot, SP.sot_prev, SP.no_speech, SP.transcribe]] = TG.NEG_INF
    prompt = np.tile(np.asarray(SP.sot_sequence("en"), np.int32), (3, 1))
    return jparams, tparams, xa, mask, prompt


def _jax_greedy(jparams, xa, mask, prompt, self_int8, **kw):
    out = JG.greedy_decode(
        jparams, jnp.asarray(xa), jnp.asarray(prompt), DIMS_J,
        JG.DecodeSpecialIds(**IDS), jnp.asarray(mask), jnp.int32(0),
        jnp.float32(0.0), jax.random.PRNGKey(0), sample_len=12,
        kv_int8=True, self_kv_int8=self_int8, **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _torch_greedy(tparams, xa, mask, prompt, self_int8, fused=False,
                  temperature=0.0, generator=None, **kw):
    out = TG.greedy_decode(
        tparams, torch.from_numpy(xa), torch.from_numpy(prompt).long(),
        DIMS_T, TG.DecodeSpecialIds(**IDS), torch.from_numpy(mask), 0,
        temperature, generator, sample_len=12, kv_int8=True,
        self_kv_int8=self_int8, fused=fused, **kw)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("self_int8", [False, True])
def test_greedy_matches_jax(setup, self_int8):
    """Temperature 0 with the timestamp grammar: identical tokens,
    sum_logprob within 1e-4 relative, no_speech_prob within 1e-5."""
    jparams, tparams, xa, mask, prompt = setup
    want = _jax_greedy(jparams, xa, mask, prompt, self_int8)
    got = _torch_greedy(tparams, xa, mask, prompt, self_int8)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["n_sampled"], want["n_sampled"])
    np.testing.assert_allclose(got["sum_logprob"], want["sum_logprob"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["no_speech_prob"], want["no_speech_prob"],
                               atol=1e-5)
    ts = got["tokens"][:, prompt.shape[1]]
    assert (ts >= SP.timestamp_begin).all()  # the grammar opened with a ts


def test_greedy_penalties_match_jax(setup):
    """Repetition penalty and n-gram bans, bf16-layout self cache."""
    jparams, tparams, xa, mask, prompt = setup
    want = _jax_greedy(jparams, xa, mask, prompt, False,
                       repetition_penalty=jnp.float32(1.5),
                       no_repeat_ngram_size=2)
    got = _torch_greedy(tparams, xa, mask, prompt, False,
                        repetition_penalty=1.5, no_repeat_ngram_size=2)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("self_int8", [False, True])
def test_fused_steps_match_decoder_step(setup, self_int8):
    """The steps through the decoder-layer kernels' plain version (on CPU
    tensors) give the tokens of the decoder_step path (the port's mirror
    of the JAX grouped-vs-ungrouped parity test). With an int8 self cache
    the fused path prefills on the unquantized cache and quantizes after
    (as the TPU megakernel path does), while decoder_step quantizes before
    the prefill attends, so the scores agree to 1e-3 there, 1e-4 else."""
    _, tparams, xa, mask, prompt = setup
    a = _torch_greedy(tparams, xa, mask, prompt, self_int8, fused=False)
    b = _torch_greedy(tparams, xa, mask, prompt, self_int8, fused=True)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_allclose(a["sum_logprob"], b["sum_logprob"],
                               rtol=1e-3 if self_int8 else 1e-4)


def test_sampling_reproducible_from_generator(setup):
    _, tparams, xa, mask, prompt = setup
    runs = [_torch_greedy(tparams, xa, mask, prompt, False, temperature=1.0,
                          generator=torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0]["tokens"], runs[1]["tokens"])
    assert not np.array_equal(runs[0]["tokens"], runs[2]["tokens"])


def test_filters_match_jax():
    """The logit filter stack on random logits and grammar states, first
    and later positions, with and without timestamps."""
    rng = np.random.default_rng(1)
    R, V = 6, SP.n_vocab
    logits = rng.standard_normal((R, V)).astype(np.float32) * 3
    mask = np.zeros(V, np.float32)
    mask[[SP.sot, SP.no_speech]] = TG.NEG_INF
    tsb = SP.timestamp_begin
    last = np.array([3, tsb + 5, tsb + 7, 1, tsb, 9], np.int32)
    penult = np.array([-1, tsb + 2, 4, tsb + 1, -1, tsb + 9], np.int32)
    maxts = np.array([-1, tsb + 5, tsb + 7, tsb + 1, tsb, tsb + 9], np.int32)
    for first in (True, False):
        for with_ts in (True, False):
            want = np.asarray(JG._apply_filters(
                jnp.asarray(logits), JG.DecodeSpecialIds(**IDS),
                jnp.asarray(mask), jnp.asarray(first), jnp.asarray(last),
                jnp.asarray(penult), jnp.asarray(maxts), with_ts))
            got = TG.apply_filters(
                torch.from_numpy(logits), TG.DecodeSpecialIds(**IDS),
                torch.from_numpy(mask), first, torch.from_numpy(last).long(),
                torch.from_numpy(penult).long(),
                torch.from_numpy(maxts).long(), with_ts).numpy()
            np.testing.assert_array_equal(got == TG.NEG_INF,
                                          want == JG.NEG_INF)
            np.testing.assert_allclose(got, want, rtol=1e-6)


def test_ngram_mask_matches_jax():
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 6, (4, 20)).astype(np.int32)
    for pos in (0, 1, 5, 13, 19):
        for n in (2, 3):
            want = np.asarray(JG.ngram_banned_mask(jnp.asarray(toks),
                                                   jnp.int32(pos), n, 8))
            got = TG.ngram_banned_mask(torch.from_numpy(toks).long(), pos,
                                       n, 8).numpy()
            np.testing.assert_array_equal(got, want)


def test_language_detection_matches_jax(setup):
    """Both language-ID forms on the encoder output (bf16 params path)."""
    tree = random_jax_tree(DIMS_J, seed=8, weight_std=0.08)
    jp, tp = JW.fuse_decoder_qkv(to_jax(tree)), TW.fuse_decoder_qkv(
        TW.params_from_jax(tree))
    xa = setup[2]
    lang0 = min(SP.language_tokens.values())
    for jfn, tfn in ((JG.detect_language_logits, TG.detect_language_logits),
                     (JG.detect_language_batched, TG.detect_language_batched)):
        want = np.asarray(jfn(jp, jnp.asarray(xa), DIMS_J, SP.sot, lang0, 2))
        got = tfn(tp, torch.from_numpy(xa), DIMS_T, SP.sot, lang0, 2).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_greedy_fused_f32_cache_matches_jax_megakernel(setup):
    """compute_type "f32" without an int8 self cache: the port's fused
    steps (the decoder-layer kernels' plain version, x and the self cache
    f32) against the JAX package's greedy decode through its Pallas
    megakernel (``mega_group``, interpret mode on the CPU) at f32:
    identical tokens; scores to the int8 cases' tolerance (the int8 cross
    K/V: 1e-3 relative), no_speech_prob within 1e-5."""
    jparams, tparams, xa, mask, prompt = setup
    want = _jax_greedy(jparams, xa, mask, prompt, False, mega_group=1)
    got = _torch_greedy(tparams, xa, mask, prompt, False, fused=True)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["n_sampled"], want["n_sampled"])
    np.testing.assert_allclose(got["sum_logprob"], want["sum_logprob"],
                               rtol=1e-3)
    np.testing.assert_allclose(got["no_speech_prob"], want["no_speech_prob"],
                               atol=1e-5)
