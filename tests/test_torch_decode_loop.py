"""The decode loop's bodies (whisper_aries_tpu_torch.decoding.generate:
``greedy_body``, ``beam_body``, run by the loop's plain version, the host
loop, on CPU tensors) against the JAX package's ``greedy_decode`` and
``beam_search_decode`` on shared tiny int8-quantized weights and the same
encoder output, made with numpy from seeds.

Tolerances: tokens, steps and permuted are equal; greedy sum_logprob
within 1e-4 relative, as tests/test_torch_generate.py holds it (the two
packages sum the same f32 log-probabilities of differently ordered
reductions); beam scores within 1e-5 (tests/test_torch_beam.py). The bf16
cases compare bf16 models in both packages, whose steps round at other
places: tokens equal, scores within 1e-2 relative."""

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
from whisper_aries_tpu_torch.ops import decode_loop as DLP

SP = build_special_tokens(24, 2)  # 24 text pieces, 2 languages
# d 128 = 2 heads x dh 64, 2 layers, 40 audio positions
DIMS_J = JW.WhisperDims(80, 40, 128, 2, 2, SP.n_vocab, 448, 128, 2, 2)
DIMS_T = TW.WhisperDims(*[getattr(DIMS_J, f) for f in
                          DIMS_J.__dataclass_fields__])
IDS = dict(eot=SP.eot, sot=SP.sot, no_speech=SP.no_speech,
           no_timestamps=SP.no_timestamps, timestamp_begin=SP.timestamp_begin,
           blank=20, n_vocab=SP.n_vocab)
SAMPLE_LEN = 12


def _bf16(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                        if a.dtype == np.float32 else a, tree)


@pytest.fixture(scope="module")
def models():
    """{dtype: (JAX params, port params, xa)} for f32 and bf16 models of
    the same int8-quantized weights."""
    tree = random_jax_tree(DIMS_J, seed=8, weight_std=0.08)
    mel = np.random.default_rng(9).standard_normal((3, 80, 80)).astype(
        np.float32)
    out = {}
    for name, cast in (("f32", lambda t: t), ("bf16", _bf16)):
        jq = cast(jax_quantize(to_jax(tree)))
        jp = JW.fuse_decoder_qkv(jq)
        tp = TW.fuse_decoder_qkv(TW.params_from_jax(
            jax.tree.map(np.asarray, jq)))
        xa = JW.encode(cast(to_jax(tree)), jnp.asarray(mel).astype(
            jnp.bfloat16 if name == "bf16" else jnp.float32), DIMS_J)
        out[name] = (jp, tp, np.asarray(xa))
    return out


def _mask(eot_bias=0.0):
    m = np.zeros(SP.n_vocab, np.float32)
    m[[SP.sot, SP.sot_prev, SP.no_speech, SP.transcribe]] = TG.NEG_INF
    m[SP.eot] = eot_bias  # the mask is additive: > 0 favours end-of-text
    return m


def _prompt(pad):
    """The sot sequence of 3 windows, left-padded by ``pad`` -1s."""
    sot = np.asarray(SP.sot_sequence("en"), np.int32)
    row = np.concatenate([np.full(pad, -1, np.int32), sot])
    return np.tile(row, (3, 1))


def _torch_xa(xa):
    t = torch.from_numpy(np.asarray(xa, np.float32).copy())
    return t.to(torch.bfloat16) if xa.dtype != np.float32 else t


GREEDY = {
    "f32-bf16cache-rep-ngram3": dict(dtype="f32", self_int8=False, rep=1.5,
                                     ngram=3),
    "f32-int8cache-ngram3-padded": dict(dtype="f32", self_int8=True,
                                        ngram=3, pad=2),
    "bf16-bf16cache-rep": dict(dtype="bf16", self_int8=False, rep=1.5),
    "bf16-int8cache-ngram3-padded": dict(dtype="bf16", self_int8=True,
                                         ngram=3, pad=2),
}


@pytest.mark.parametrize("case", list(GREEDY))
def test_greedy_bodies_match_jax(models, case):
    """The greedy loop (timestamp grammar, int8 cross K/V) with repetition
    penalty, 3-gram bans and a left-padded prompt (``prompt_start`` 2):
    tokens identical to JAX's greedy_decode, sum_logprob within 1e-4
    relative (bf16 models 1e-2); no_speech_prob within 1e-5 (bf16 1e-2)."""
    c = GREEDY[case]
    jp, tp, xa = models[c["dtype"]]
    pad = c.get("pad", 0)
    prompt, mask = _prompt(pad), _mask()
    kw_j, kw_t = {}, {}
    if pad:
        kw_j["prompt_start"], kw_t["prompt_start"] = jnp.int32(pad), pad
    if c.get("rep"):
        kw_j["repetition_penalty"] = jnp.float32(c["rep"])
        kw_t["repetition_penalty"] = c["rep"]
    want = JG.greedy_decode(
        jp, jnp.asarray(xa), jnp.asarray(prompt), DIMS_J,
        JG.DecodeSpecialIds(**IDS), jnp.asarray(mask), jnp.int32(pad),
        jnp.float32(0.0), jax.random.PRNGKey(0), sample_len=SAMPLE_LEN,
        kv_int8=True, self_kv_int8=c["self_int8"],
        no_repeat_ngram_size=c.get("ngram", 0), **kw_j)
    got = TG.greedy_decode(
        tp, _torch_xa(xa), torch.from_numpy(prompt).long(), DIMS_T,
        TG.DecodeSpecialIds(**IDS), torch.from_numpy(mask), pad, 0.0,
        sample_len=SAMPLE_LEN, kv_int8=True, self_kv_int8=c["self_int8"],
        no_repeat_ngram_size=c.get("ngram", 0), **kw_t)
    tol = 1e-2 if c["dtype"] == "bf16" else 1e-4
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["n_sampled"].numpy(),
                                  np.asarray(want["n_sampled"]))
    np.testing.assert_allclose(got["sum_logprob"].numpy(),
                               np.asarray(want["sum_logprob"]), rtol=tol)
    np.testing.assert_allclose(got["no_speech_prob"].float().numpy(),
                               np.asarray(want["no_speech_prob"], np.float32),
                               atol=1e-2 if c["dtype"] == "bf16" else 1e-5)
    # the host loop reads its condition once an iteration and once more
    assert int(got["host_reads"]) == int(got["steps"])


def _jax_beam_counted(monkeypatch, jp, xa, prompt, mask, **kw):
    """JAX's beam_search_decode run op by op (``jax.disable_jit``), its
    ``lax.while_loop`` counted and its permute-or-skip ``lax.cond``
    recorded: (outputs, expansions, each expansion's identity flag)."""
    flags, steps = [], [1]  # the first expansion is outside the loop

    def cond(pred, true_fn, false_fn, *ops):
        flags.append(bool(pred))
        return true_fn(*ops) if bool(pred) else false_fn(*ops)

    def while_loop(cond_fn, body, state):
        while bool(cond_fn(state)):
            state = body(state)
            steps[0] += 1
        return state

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "cond", cond)
        m.setattr(jax.lax, "while_loop", while_loop)
        with jax.disable_jit():
            out = JG.beam_search_decode(
                jp, jnp.asarray(xa), jnp.asarray(prompt), DIMS_J,
                JG.DecodeSpecialIds(**IDS), jnp.asarray(mask), jnp.int32(0),
                beam_size=5, sample_len=SAMPLE_LEN, beam_reorder="xla",
                beam_tail="xla", beam_group=1, **kw)
    return {k: np.asarray(v) for k, v in out.items()}, steps[0], flags


BEAM = {
    "int8cache-patience2": dict(self_int8=True, patience=2.0),
    "bf16cache-rep-ngram3": dict(self_int8=False, rep=1.5, ngram=3,
                                 length_penalty=0.6),
}


@pytest.mark.parametrize("case", list(BEAM))
def test_beam_bodies_match_jax(models, case, monkeypatch):
    """K 5 beam loop (timestamp grammar, int8 cross K/V) against JAX's
    beam_search_decode with beam_reorder "xla", beam_tail "xla" and
    beam_group 1 passed explicitly: tokens, all_tokens, n_sampled and
    the expansions (steps) equal; permuted equal to JAX's count of
    non-identity expansions before its last (the cache is reordered
    before the next step, and the last has none); sum_logprob,
    avg_logprob and every live hypothesis's score within 1e-5 (1e-3 on
    unchosen hypotheses with an int8 self cache, as
    tests/test_torch_beam.py)."""
    c = dict(BEAM[case])
    jp, tp, xa = models["f32"]
    prompt, mask = _prompt(0), _mask()
    rep = c.pop("rep", None)
    kw = dict(self_kv_int8=c["self_int8"],
              no_repeat_ngram_size=c.get("ngram", 0),
              patience=c.get("patience", 1.0),
              length_penalty=c.get("length_penalty", 1.0), kv_int8=True)
    want, steps, flags = _jax_beam_counted(
        monkeypatch, jp, xa, prompt, mask,
        repetition_penalty=None if rep is None else jnp.float32(rep), **kw)
    got = TG.beam_search_decode(
        tp, _torch_xa(xa), torch.from_numpy(prompt).long(), DIMS_T,
        TG.DecodeSpecialIds(**IDS), torch.from_numpy(mask), 0, beam_size=5,
        sample_len=SAMPLE_LEN, repetition_penalty=rep, **kw)
    got = {k: v.numpy() for k, v in got.items()}
    for k in ("tokens", "all_tokens", "n_sampled"):
        np.testing.assert_array_equal(got[k], want[k])
    assert len(flags) == steps == int(got["steps"])
    assert int(got["permuted"]) == flags[:-1].count(False)
    for k in ("sum_logprob", "avg_logprob"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    live = np.abs(want["all_scores"]) < 1e30
    np.testing.assert_allclose(got["all_scores"][live],
                               want["all_scores"][live],
                               rtol=1e-3 if c["self_int8"] else 1e-5)
    assert int(got["host_reads"]) == steps


@pytest.mark.parametrize("beam", [False, True])
def test_overrun_leaves_outputs_unchanged(models, beam, monkeypatch):
    """Bodies run on after the condition turned false (a condition that
    ignores the finished state runs to the buffer's end) leave every
    output unchanged but the steps: finished rows append end-of-text at
    no cost, and full finished buffers take no more hypotheses. With
    end-of-text favoured every row finishes early, so the overrun is
    long."""
    _, tp, xa = models["f32"]
    prompt, mask = _prompt(0), _mask(eot_bias=8.0)
    common = (tp, _torch_xa(xa), torch.from_numpy(prompt).long(), DIMS_T,
              TG.DecodeSpecialIds(**IDS), torch.from_numpy(mask), 0)
    kw = dict(sample_len=SAMPLE_LEN, kv_int8=True, self_kv_int8=True,
              with_timestamps=False)

    def run():
        if beam:
            return TG.beam_search_decode(*common, beam_size=5, **kw)
        return TG.greedy_decode(*common, 0.0, **kw)

    ref = run()
    plain = DLP.loop_cond_plain
    monkeypatch.setattr(DLP, "loop_cond_plain",
                        lambda pos, L, **flags: plain(
                            pos, L, **{k: (torch.zeros_like(v) if
                                           k == "finished" else v * 0
                                           if k == "counts" else v)
                                       for k, v in flags.items()}))
    over = run()
    assert int(ref["steps"]) < SAMPLE_LEN == int(over["steps"])
    keys = ("tokens", "n_sampled", "sum_logprob", "avg_logprob",
            "no_speech_prob")
    for k in keys:
        assert torch.equal(ref[k], over[k]), k
    if beam:  # the finished buffers' hypotheses and scores
        C = 5
        assert torch.equal(ref["all_tokens"][:, :C], over["all_tokens"][:, :C])
        assert torch.equal(ref["all_scores"][:, :C], over["all_scores"][:, :C])


def test_ngram_mask_device_pos_matches_int_and_jax():
    """``ngram_banned_mask`` at a 0-d tensor position equals the int
    position's and JAX's, on buffers with a left-padded (-1) prompt."""
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 6, (4, 20)).astype(np.int32)
    toks[:2, :3] = -1
    for pos in (0, 1, 2, 5, 13, 19):
        for n in (2, 3, 4):
            want = np.asarray(JG.ngram_banned_mask(jnp.asarray(toks),
                                                   jnp.int32(pos), n, 8))
            t = torch.from_numpy(toks).long()
            by_int = TG.ngram_banned_mask(t, pos, n, 8).numpy()
            by_tensor = TG.ngram_banned_mask(
                t, torch.tensor(pos, dtype=torch.int32), n, 8).numpy()
            np.testing.assert_array_equal(by_int, want)
            np.testing.assert_array_equal(by_tensor, want)


def test_sampled_rung_reproducible_from_seed(models):
    """At temperature 1 the draws are keyed by the generator's seed: the
    same seed gives the same tokens twice, another seed other tokens; the
    draws lie in (0, 1) and differ between positions."""
    _, tp, xa = models["f32"]
    prompt = _prompt(0)

    def sample(seed):
        return TG.greedy_decode(
            tp, _torch_xa(xa), torch.from_numpy(prompt).long(), DIMS_T,
            TG.DecodeSpecialIds(**IDS), torch.from_numpy(_mask()), 0, 1.0,
            torch.Generator().manual_seed(seed), sample_len=SAMPLE_LEN,
            kv_int8=True)["tokens"]

    a, b, c = sample(3), sample(3), sample(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    u = DLP.uniform_draw(3, torch.tensor(7, dtype=torch.int32), 3, 1000)
    assert float(u.min()) > 0 and float(u.max()) < 1
    assert not torch.equal(u, DLP.uniform_draw(3, torch.tensor(8), 3, 1000))


def test_uniform_draw_plain_is_the_kernel_hash():
    """The plain draw is the kernel's 32-bit hash (csrc/draw.cuh's
    ``mix32`` chain) in int64 torch ops: checked against the same chain
    in Python integers, where a product wrapping at 2^32 is explicit."""

    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        return x ^ (x >> 16)

    seed, pos = (5 << 32) + 0xDEADBEEF, 300
    u = DLP.uniform_draw_plain(seed, torch.tensor(pos), 2, 70000)
    for r in range(2):
        key = mix(mix(mix((seed & 0xFFFFFFFF) ^ mix(seed >> 32)) ^ r) ^ pos)
        for v in (0, 1, 12345, 69999):
            h = mix(key ^ v)
            assert float(u[r, v]) == ((h >> 9) + 0.5) * 2.0 ** -23
