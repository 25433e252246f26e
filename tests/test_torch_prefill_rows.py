"""The prefill's vocab product on the rows it is read for
(whisper_aries_tpu_torch.decoding.generate._prefill,
models.whisper.decoder_step's ``logits_at``): greedy and beam-5 decodes of
a conditioned, left-padded prompt (previous text after <|startofprev|>,
then the sot sequence) against the same decodes with the full prefill (the
final LayerNorm and product on every prompt position, then the two read
positions taken: the port before ``logits_at``) and against the JAX
package, on shared tiny int8-quantized weights and the same encoder
output. Tokens are identical; scores are held to the decode parity tests'
tolerances: greedy sum_logprob within 1e-4 relative and no_speech_prob
within 1e-5 (tests/test_torch_generate.py), beam sum_logprob,
avg_logprob and no_speech_prob within 1e-5 and hypothesis scores within
1e-3 with an int8 cross K/V (tests/test_torch_beam.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
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
PAD, SAMPLE_LEN = 5, 10


@pytest.fixture(scope="module")
def setup():
    """(JAX params, port params, xa, mask, prompt, sot_index): three
    windows' conditioned prompts, left-padded by PAD -1s."""
    tree = random_jax_tree(DIMS_J, seed=8, weight_std=0.08)
    jq = jax_quantize(to_jax(tree))
    jparams = JW.fuse_decoder_qkv(jq)
    tparams = TW.fuse_decoder_qkv(TW.params_from_jax(
        jax.tree.map(np.asarray, jq)))
    rng = np.random.default_rng(9)
    mel = rng.standard_normal((3, 80, 80)).astype(np.float32)
    xa = np.asarray(JW.encode(to_jax(tree), jnp.asarray(mel), DIMS_J))
    mask = np.zeros(SP.n_vocab, np.float32)
    mask[[SP.sot, SP.sot_prev, SP.no_speech, SP.transcribe]] = TG.NEG_INF
    prev = rng.integers(0, 24, (3, 6))
    sot = np.asarray(SP.sot_sequence("en"), np.int64)
    prompt = np.concatenate([np.full((3, PAD), -1), np.full((3, 1),
                            SP.sot_prev), prev, np.tile(sot, (3, 1))],
                            axis=1)
    return jparams, tparams, xa, mask, prompt, PAD + 1 + prev.shape[1]


def _full_prefill(monkeypatch):
    """decoder_step with the product on every prompt position, the
    ``logits_at`` positions taken after it; records each prefill's rows."""
    step, rows = TW.decoder_step, []

    def full(*args, logits_at=None, **kw):
        out = step(*args, **kw)
        if logits_at is None:
            return out
        rows.append(out.shape[0] * out.shape[1])
        return out[:, list(logits_at)]

    monkeypatch.setattr(TW, "decoder_step", full)
    return rows


def _rows_of_products(monkeypatch):
    """The row count of every vocab product the port runs."""
    product, rows = TW.vocab_product, []

    def counted(x, emb):
        rows.append(x.shape[0])
        return product(x, emb)

    monkeypatch.setattr(TW, "vocab_product", counted)
    return rows


def _torch_decode(setup, beam):
    _, tparams, xa, mask, prompt, sot_index = setup
    args = (tparams, torch.from_numpy(xa.copy()), torch.from_numpy(prompt),
            DIMS_T, TG.DecodeSpecialIds(**IDS), torch.from_numpy(mask),
            sot_index)
    kw = dict(sample_len=SAMPLE_LEN, kv_int8=True, self_kv_int8=False,
              prompt_start=PAD)
    if beam:
        out = TG.beam_search_decode(*args, beam_size=5, **kw)
    else:
        out = TG.greedy_decode(*args, 0.0, **kw)
    return {k: v.numpy() for k, v in out.items()}


def _jax_decode(setup, beam):
    jparams, _, xa, mask, prompt, sot_index = setup
    args = (jparams, jnp.asarray(xa), jnp.asarray(prompt, jnp.int32),
            DIMS_J, JG.DecodeSpecialIds(**IDS), jnp.asarray(mask),
            jnp.int32(sot_index))
    kw = dict(sample_len=SAMPLE_LEN, kv_int8=True, self_kv_int8=False,
              prompt_start=jnp.int32(PAD))
    if beam:
        out = JG.beam_search_decode(*args, beam_size=5, beam_reorder="xla",
                                    beam_tail="xla", beam_group=1, **kw)
    else:
        out = JG.greedy_decode(*args, jnp.float32(0.0),
                               jax.random.PRNGKey(0), **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _same(got, want, beam):
    keys = ("tokens", "n_sampled") + (("all_tokens",) if beam else ())
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k])
    if beam:
        for k in ("sum_logprob", "avg_logprob", "no_speech_prob"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
        live = np.abs(want["all_scores"]) < 1e30
        np.testing.assert_allclose(got["all_scores"][live],
                                   want["all_scores"][live], rtol=1e-3)
    else:
        np.testing.assert_allclose(got["sum_logprob"], want["sum_logprob"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["no_speech_prob"],
                                   want["no_speech_prob"], atol=1e-5)


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam5"])
def test_last_position_prefill_matches_full_prefill_and_jax(setup, beam,
                                                            monkeypatch):
    """The prefill's product runs on 2 B rows (the sot's and the last
    position), not B P; the decode gives the full prefill's tokens and
    scores and the JAX package's."""
    prompt = setup[4]
    B, P = prompt.shape
    with monkeypatch.context() as m:
        rows = _rows_of_products(m)
        got = _torch_decode(setup, beam)
    # the prefill first, then one product a step (B or B x 5 rows)
    assert rows[0] == 2 * B and P > 2
    assert all(r == B * (5 if beam else 1) for r in rows[1:])
    with monkeypatch.context() as m:
        full_rows = _full_prefill(m)
        full = _torch_decode(setup, beam)
    assert full_rows == [B * P]
    _same(got, full, beam)
    _same(got, _jax_decode(setup, beam), beam)
    assert (got["tokens"][:, :P] == prompt).all()
