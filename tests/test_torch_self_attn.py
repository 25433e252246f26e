"""The port's decode-step self-attention over an int8 self cache
(whisper_aries_tpu_torch.ops.self_attn) against the JAX package's on the
CPU: the plain version of the kernel against the Pallas kernel
``self_attention_q8_step`` in interpret mode and its XLA reference (the
port's dh-minor cache transposed to JAX's time-minor layout), then the
unfused int8-self-cache greedy decode and the engine configured for it
(``decode.kv_cache_dtype="bf16"``, ``decode.self_kv_cache_dtype="int8"``).
Inputs are made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import (
    NEG,
    PieceTokenizer,
    random_jax_tree,
    speechy_audio,
    to_jax,
)
from whisper_aries_tpu.decoding import generate as JG
from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.ops import pallas_self_attn as JSA
from whisper_aries_tpu.ops.quant import quantize_model_params as jax_quantize
from whisper_aries_tpu_torch.decoding import generate as TG
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.ops import self_attn as TSA


def _step_operands(B, H, T, pos, valid_start, seed):
    """One layer's int8 cache (port layout (B, H, T, 64), scales (B, H, T),
    K scales folding 1/8), stale random values past ``pos`` that only the
    mask keeps out, and the mask row over [valid_start, pos]."""
    rng = np.random.default_rng(seed)
    dh = 64
    q = rng.standard_normal((B, H, 1, dh)).astype(np.float32)
    k8 = rng.integers(-127, 128, (B, H, T, dh)).astype(np.int8)
    v8 = rng.integers(-127, 128, (B, H, T, dh)).astype(np.int8)
    ks = (rng.uniform(0.5, 2.0, (B, H, T)) / 127 / 8).astype(np.float32)
    vs = (rng.uniform(0.5, 2.0, (B, H, T)) / 127).astype(np.float32)
    t = np.arange(T)
    mask = np.where((t <= pos) & (t >= valid_start), 0.0, NEG).astype(
        np.float32)[None]
    return q, k8, ks, v8, vs, mask


def _jax_layout(q, k8, ks, v8, vs, mask):
    """-> the Pallas kernel's time-minor operands."""
    tm = lambda a: jnp.asarray(np.ascontiguousarray(a.transpose(0, 1, 3, 2)))
    return (jnp.asarray(q), tm(k8), jnp.asarray(ks[:, :, None, :]), tm(v8),
            jnp.asarray(vs[:, :, None, :]), jnp.asarray(mask[None, None]))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("B,H,T,pos,valid_start", [
    (2, 3, 16, 0, 0), (3, 2, 40, 17, 0), (6, 4, 227, 150, 0),
    (2, 2, 64, 63, 5)])
def test_plain_matches_pallas_step_and_reference(B, H, T, pos, valid_start):
    """Within 1e-5 of max |want| (the same f32 products summed in another
    order). Ignoring the mask, or dropping the last written position,
    moves the result far more."""
    ops = _step_operands(B, H, T, pos, valid_start, seed=T + pos)
    got = TSA.self_attention_q8_plain(
        *(torch.from_numpy(np.array(a)) for a in ops)).numpy()
    jops = _jax_layout(*ops)
    want = np.asarray(JSA.self_attention_q8_step(*jops, interpret=True))
    ref = np.asarray(JSA.self_attention_q8_reference(*jops))
    assert got.shape == want.shape == (B, H, 1, 64)
    assert _rel(got, want) <= 1e-5 and _rel(got, ref) <= 1e-5
    q, k8, ks, v8, vs, mask = (torch.from_numpy(np.array(a)) for a in ops)
    unmasked = TSA.self_attention_q8_plain(q, k8, ks, v8, vs,
                                           torch.zeros_like(mask)).numpy()
    assert _rel(unmasked, want) > 1e-2
    if pos > valid_start:
        cut = mask.clone()
        cut[..., pos] = NEG
        dropped = TSA.self_attention_q8_plain(q, k8, ks, v8, vs, cut).numpy()
        assert _rel(dropped, want) > 1e-3


def test_dispatch_takes_the_plain_version_on_the_cpu():
    ops = [torch.from_numpy(np.array(a))
           for a in _step_operands(2, 2, 24, 9, 0, seed=1)]
    n = TSA.self_attention_q8_kernel.launches
    assert torch.equal(TSA.self_attention_q8(*ops),
                       TSA.self_attention_q8_plain(*ops))
    assert TSA.self_attention_q8_kernel.launches == n


SP = build_special_tokens(24, 2)
DIMS_J = JW.WhisperDims(80, 40, 128, 2, 2, SP.n_vocab, 448, 128, 2, 2)
DIMS_T = TW.WhisperDims(*[getattr(DIMS_J, f) for f in
                          DIMS_J.__dataclass_fields__])
IDS = dict(eot=SP.eot, sot=SP.sot, no_speech=SP.no_speech,
           no_timestamps=SP.no_timestamps, timestamp_begin=SP.timestamp_begin,
           blank=20, n_vocab=SP.n_vocab)


@pytest.mark.parametrize("compute", ["f32", "int8"])
def test_unfused_int8_self_cache_greedy_matches_jax(compute):
    """Greedy decode at temperature 0 with bf16-layout cross K/V and an
    int8 self cache, unfused decoder_step steps (S == 1 through the int8
    self-attention), against the JAX package's at the same config on the
    same weights and encoder output: identical tokens, no_speech_prob
    within 1e-5, sum_logprob within 1e-4 relative on f32 weights and 1e-3 on
    int8 ones (the frameworks sum the int8 products in different orders, so
    a K/V value on an int8 rounding boundary of the self cache can land one
    step apart: ROADMAP.md, Queue 3)."""
    tree = random_jax_tree(DIMS_J, seed=12, weight_std=0.08)
    jp = to_jax(tree)
    if compute == "int8":
        jp = jax_quantize(jp)
    jparams = JW.fuse_decoder_qkv(jp)
    tparams = TW.fuse_decoder_qkv(
        TW.params_from_jax(jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(13)
    mel = rng.standard_normal((3, 80, 80)).astype(np.float32)
    xa = np.asarray(JW.encode(to_jax(tree), jnp.asarray(mel), DIMS_J))
    mask = np.zeros(SP.n_vocab, np.float32)
    mask[[SP.sot, SP.sot_prev, SP.no_speech, SP.transcribe]] = TG.NEG_INF
    prompt = np.tile(np.asarray(SP.sot_sequence("en"), np.int32), (3, 1))
    want = JG.greedy_decode(
        jparams, jnp.asarray(xa), jnp.asarray(prompt), DIMS_J,
        JG.DecodeSpecialIds(**IDS), jnp.asarray(mask), jnp.int32(0),
        jnp.float32(0.0), jax.random.PRNGKey(0), sample_len=12,
        kv_int8=False, self_kv_int8=True)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = TG.greedy_decode(
        tparams, torch.from_numpy(xa.copy()), torch.from_numpy(prompt).long(),
        DIMS_T, TG.DecodeSpecialIds(**IDS), torch.from_numpy(mask), 0, 0.0,
        None, sample_len=12, kv_int8=False, self_kv_int8=True, fused=False)
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["sum_logprob"], want["sum_logprob"],
                               rtol=1e-4 if compute == "f32" else 1e-3)
    np.testing.assert_allclose(got["no_speech_prob"], want["no_speech_prob"],
                               atol=1e-5)


def test_engine_self_int8_config_matches_jax_engine(tmp_path):
    """The engine with kv_cache_dtype bf16 and self_kv_cache_dtype int8
    resolves to unfused steps with an int8 self cache, and its transcript
    of a 40 s WAV equals the JAX engine's at the same config."""
    from whisper_aries_tpu.config import load_config as jax_config
    from whisper_aries_tpu.pipeline.engine import AriesTranscriber as JEngine
    from whisper_aries_tpu_torch.audio.decode import write_wav
    from whisper_aries_tpu_torch.config import load_config
    from whisper_aries_tpu_torch.pipeline.engine import (
        AriesTranscriber as TEngine,
    )

    tok = PieceTokenizer(build_special_tokens)
    dims_j = JW.WhisperDims(80, 1500, 64, 2, 2, tok.specials.n_vocab, 448,
                            64, 2, 2)
    dims_t = TW.WhisperDims(*[getattr(dims_j, f)
                              for f in dims_j.__dataclass_fields__])
    tree = random_jax_tree(dims_j, seed=14, weight_std=0.08)
    wav = str(tmp_path / "a.wav")
    write_wav(wav, speechy_audio(40.0, seed=6), 16_000)
    over = {"decode.kv_cache_dtype": "bf16",
            "decode.self_kv_cache_dtype": "int8"}
    kw = dict(windows_per_device=2, compute_type="int8", _tokenizer=tok)
    jeng = JEngine(model_size="tiny-torch", _params=to_jax(tree),
                   _dims=dims_j, config=jax_config(overrides=over), **kw)
    teng = TEngine(model_size="tiny-torch", device="cpu",
                   _params=TW.params_from_jax(tree), _dims=dims_t,
                   config=load_config(overrides=over), **kw)
    assert not teng.kv_int8 and teng.self_kv_int8 and not teng.fused
    call = dict(temperature=(0.0,), max_new_tokens=16, output_formats=())
    want = jeng.transcribe_file(wav, **call)
    got = teng.transcribe_file(wav, **call)
    seg = lambda r: [(s["text"], s["start"], s["end"]) for s in r["segments"]]
    assert got["num_windows"] == want["num_windows"] >= 2
    assert seg(got) == seg(want) and got["segments"]
