"""The port's word timestamps (whisper_aries_tpu_torch.align.word_align and
models.whisper.alignment_forward) against the JAX package's on the CPU, on
tiny random models made with numpy from a seed: the alignment pass on f32
and int8 weights, the wavefront DTW against the row-by-row reference on
costs with planted ties, the host steps, ``add_word_timestamps`` through
stand-in engines carrying the same params, and the engine with
``word_timestamps=True``."""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import (
    PieceTokenizer,
    random_jax_tree,
    speechy_audio,
    to_jax,
)
from whisper_aries_tpu.align import word_align as JA
from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.ops.quant import quantize_model_params as jax_quantize
from whisper_aries_tpu.vad.planner import Window as JWindow
from whisper_aries_tpu.vad.planner import windows_to_batch as jax_batch
from whisper_aries_tpu_torch.align import word_align as TA
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.vad.planner import Window as TWindow
from whisper_aries_tpu_torch.vad.planner import windows_to_batch

TOK = PieceTokenizer(build_special_tokens)


def _dims(n_audio_ctx, d, layers):
    dj = JW.WhisperDims(80, n_audio_ctx, d, 2, layers, TOK.specials.n_vocab,
                        448, d, 2, layers)
    return dj, TW.WhisperDims(*[getattr(dj, f)
                                for f in dj.__dataclass_fields__])


# ---------------------------------------------------------------------------
# alignment_forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compute", ["f32", "int8"])
@pytest.mark.parametrize("pairs", [[(1, 0), (3, 1), (2, 1)], None])
def test_alignment_forward_matches_jax(compute, pairs):
    """f32 weights: sel_qk within atol 2e-4 (tests/test_decode_options.py's
    limit for the JAX pass against its own decoder_forward), token_probs
    within 1e-5. int8 weights: the int8 product rounds its activations to
    bf16, and the frameworks' LayerNorms differ in the last f32 bit, so an
    activation at a bf16 rounding midpoint can land one bf16 step apart and
    move its row downstream (here one element of layer 0's h does); sel_qk
    is then held to one bf16 step of max |want| (2^-7) and token_probs to
    1e-4. None selects the top-half fallback (every head of layers 2, 3)."""
    dj, dt = _dims(48, 128, 4)
    tree = random_jax_tree(dj, seed=21, weight_std=0.08)
    jp = to_jax(tree)
    if compute == "int8":
        jp = jax_quantize(jp)
    jp = JW.fuse_decoder_qkv(jp)
    tp = TW.fuse_decoder_qkv(TW.params_from_jax(jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(22)
    B, S = 3, 10
    xa = rng.standard_normal((B, 48, 128)).astype(np.float32)
    toks = rng.integers(0, 24, (B, S))
    toks[1, 7:] = TOK.specials.eot  # eot padding past a shorter window
    sel, n_sel = JA._alignment_head_onehot(dj, pairs)
    want_qk, want_p = JW.alignment_forward(
        jp, jnp.asarray(toks, jnp.int32), jnp.asarray(xa), jnp.asarray(sel),
        dj)
    got_qk, got_p = TW.alignment_forward(
        tp, torch.from_numpy(toks), torch.from_numpy(xa), sel, dt)
    assert tuple(got_qk.shape) == (n_sel, B, S, 48)
    want_qk = np.asarray(want_qk)
    qk_tol = 2e-4 if compute == "f32" else 2 ** -7 * np.abs(want_qk).max()
    np.testing.assert_allclose(got_qk.numpy(), want_qk, atol=qk_tol)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               atol=1e-5 if compute == "f32" else 1e-4)
    assert (got_p[:, 0] == 1.0).all()


@pytest.mark.parametrize("pairs", [[(0, 1), (5, 1), (3, 0)], [], None,
                                   [(9, 0), (1, 7)]])
def test_alignment_head_onehot_matches_jax(pairs):
    """Published pairs, and the top-half fallback for none or only
    out-of-range ones."""
    dj, dt = _dims(48, 128, 6)
    want, n_want = JA._alignment_head_onehot(dj, pairs)
    got, n_got = TA._alignment_head_onehot(dt, pairs)
    assert n_got == n_want
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# host steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (7, 1), (2, 3), (5, 5),
                                   (12, 60), (37, 211), (60, 12), (31, 400)])
@pytest.mark.parametrize("ties", [False, True])
def test_wavefront_dtw_matches_reference(shape, ties):
    """The anti-diagonal wavefront against the JAX package's row-by-row
    _dtw_path_py: identical paths, on random costs and on costs from
    {0, 1, 2}, where most cells tie with a neighbour (the minima are exact,
    so ties resolve the same way)."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    cost = (rng.integers(0, 3, shape).astype(np.float64) if ties
            else rng.standard_normal(shape))
    want = JA._dtw_path_py(cost)
    for got in (TA.dtw_path(cost), TA._dtw_path_py(cost)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_median_filter_and_token_times_match_jax():
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 3, 9, 50))
    np.testing.assert_array_equal(TA._median_filter(x, 7),
                                  JA._median_filter(x, 7))
    qk = rng.standard_normal((1, 4, 9, 50)).astype(np.float32)
    for heads, layers in ((None, [0]), ([(0, 1), (0, 3)], None)):
        np.testing.assert_array_equal(
            TA.attention_to_token_times(qk, 44, layers, heads),
            JA.attention_to_token_times(qk, 44, layers, heads))


def test_words_and_punctuation_match_jax():
    """Word grouping, punctuation merges and per-word probabilities on a
    token stream with leading and trailing punctuation."""
    sp = TOK.specials
    tokens = [sp.timestamp_begin, 0, 16, 1, 15, 2, 3, 17, 8, 12, 15,
              sp.timestamp_begin + 40]
    rng = np.random.default_rng(24)
    qk = rng.standard_normal((1, 2, len(tokens), 60)).astype(np.float32)
    probs = rng.uniform(0.1, 1.0, len(tokens))
    kw = dict(token_probs=probs, alignment_layers=[0],
              prepend_punctuations=JA.PREPEND_PUNCTUATIONS,
              append_punctuations=JA.APPEND_PUNCTUATIONS, return_groups=True)
    want = JA.find_word_alignments(tokens, qk, TOK, 55, **kw)
    got = TA.find_word_alignments(tokens, qk, TOK, 55, **kw)
    assert got == want and len(got[0]) >= 4
    assert (TA.split_tokens_into_words(tokens, TOK)
            == JA.split_tokens_into_words(tokens, TOK))


def test_windows_to_batch_matches_jax():
    audio = speechy_audio(50.0, seed=3)
    wins = [(0.0, 30.0), (12.5, 20.25), (31.0, 50.0)]
    np.testing.assert_array_equal(
        windows_to_batch(audio, [TWindow(*w) for w in wins]),
        jax_batch(audio, [JWindow(*w) for w in wins]))


# ---------------------------------------------------------------------------
# add_word_timestamps and the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    dj, dt = _dims(1500, 64, 2)
    tree = random_jax_tree(dj, seed=25, weight_std=0.08)
    return dj, dt, tree


def _segments():
    """Segments of two windows as the decode leaves them (text tokens only;
    punctuation pieces included)."""
    def seg(win, start, end, toks):
        return {"start": start, "end": end, "text": TOK.decode(toks),
                "tokens": toks, "window_id": win, "chunk_id": win}
    return [seg(0, 0.5, 9.0, [0, 1, 15, 2, 3]),
            seg(0, 9.0, 27.0, [4, 5, 6, 17, 7, 8, 9, 10, 11]),
            seg(1, 33.0, 41.0, [16, 8, 12, 13, 15]),
            seg(1, 41.0, 49.0, [14, 0, 18])]


@pytest.mark.parametrize("heads", [[(1, 0), (1, 1), (0, 1)], None])
def test_add_word_timestamps_matches_jax(model, heads):
    """The same segments, audio and windows through the JAX package's
    add_word_timestamps and the port's, each with a stand-in engine
    carrying the same params: identical words (text, start, end,
    probability) on every segment, and the same widened segment bounds."""
    dj, dt, tree = model
    audio = speechy_audio(50.0, seed=4)
    wins = [(0.0, 30.0), (32.0, 50.0)]
    jeng = SimpleNamespace(
        params=JW.fuse_decoder_qkv(to_jax(tree)), dims=dj, tokenizer=TOK,
        activation_dtype=jnp.float32, alignment_heads=heads, batch_size=8)
    teng = SimpleNamespace(
        params=TW.fuse_decoder_qkv(TW.params_from_jax(tree)), dims=dt,
        tokenizer=TOK, activation_dtype=torch.float32,
        device=torch.device("cpu"), alignment_heads=heads, batch_size=8)
    want, got = _segments(), _segments()
    JA.add_word_timestamps(jeng, want, audio, [JWindow(*w) for w in wins])
    times = TA.add_word_timestamps(teng, got, audio,
                                   [TWindow(*w) for w in wins])
    assert times["windows"] == 2
    for g, w in zip(got, want):
        assert g["words"] and g["words"] == w["words"]
        assert (g["start"], g["end"]) == (w["start"], w["end"])


def _wav(tmp_path, seconds=40.0):
    from whisper_aries_tpu_torch.audio.decode import write_wav

    wav = str(tmp_path / "a.wav")
    write_wav(wav, speechy_audio(seconds, seed=7), 16_000)
    return wav


def _port_engine(model, **kw):
    from whisper_aries_tpu_torch.pipeline.engine import (
        AriesTranscriber as TEngine,
    )

    _, dt, tree = model
    return TEngine(model_size="tiny-torch", device="cpu",
                   _params=TW.params_from_jax(tree), _dims=dt,
                   windows_per_device=2, compute_type="int8",
                   kv_cache_dtype="int8", _tokenizer=TOK, **kw)


def test_engine_word_timestamps_match_jax_engine(model, tmp_path):
    """transcribe_file(word_timestamps=True) at compute int8 on both
    engines (no alignment heads: the top-half fallback on both): the same
    segments with the same words."""
    from whisper_aries_tpu.pipeline.engine import AriesTranscriber as JEngine

    dj, _, tree = model
    wav = _wav(tmp_path)
    jeng = JEngine(model_size="tiny-torch", _params=to_jax(tree), _dims=dj,
                   windows_per_device=2, compute_type="int8",
                   kv_cache_dtype="int8", _tokenizer=TOK)
    teng = _port_engine(model)
    assert teng.alignment_heads is None and jeng.alignment_heads is None
    call = dict(temperature=(0.0,), max_new_tokens=16, output_formats=(),
                word_timestamps=True)
    want = jeng.transcribe_file(wav, **call)
    got = teng.transcribe_file(wav, **call)
    assert got["segments"] and len(got["segments"]) == len(want["segments"])
    for g, w in zip(got["segments"], want["segments"]):
        assert (g["text"], g["start"], g["end"]) == (w["text"], w["start"],
                                                    w["end"])
        assert g["words"] == w["words"]


def test_engine_attaches_words_to_every_segment(model, tmp_path,
                                                monkeypatch):
    """The port alone, compute int8 with ARIES_QUANT_IMPL=pallas (the
    kernel's plain version on the CPU) and beam 5, outputs written: every
    segment carries words with finite, ordered times inside the file."""
    from whisper_aries_tpu_torch.config import load_config

    wav = _wav(tmp_path)
    eng = _port_engine(
        model, config=load_config(overrides={"decode.beam_size": 5}))
    eng.alignment_heads = [(1, 0), (1, 1)]
    monkeypatch.setenv("ARIES_QUANT_IMPL", "pallas")
    res = eng.transcribe_file(
        wav, temperature=(0.0,), max_new_tokens=16, word_timestamps=True,
        output_formats=("txt", "json", "srt"),
        output_dir=str(tmp_path / "out"))
    assert res["segments"]
    assert res["performance"]["words"]["windows"] == len(
        {s["window_id"] for s in res["segments"]})
    for s in res["segments"]:
        assert s["words"]
        for w in s["words"]:
            assert np.isfinite([w["start"], w["end"], w["probability"]]).all()
            assert 0.0 <= w["start"] < w["end"] <= res["duration"] + 0.02
    for fmt in ("txt", "json", "srt"):
        assert Path(res["output_files"][fmt]).exists()


def test_word_pass_errors_are_not_swallowed(model, tmp_path, monkeypatch):
    """A failure inside the word pass fails the call (the JAX engine logs
    a warning and returns segments without words)."""
    from whisper_aries_tpu_torch.models import whisper as W

    wav = _wav(tmp_path)
    eng = _port_engine(model)

    def broken(*a, **k):
        raise RuntimeError("alignment kernel failed")

    monkeypatch.setattr(W, "alignment_forward", broken)
    with pytest.raises(RuntimeError, match="alignment kernel failed"):
        eng.transcribe_file(wav, temperature=(0.0,), max_new_tokens=8,
                            output_formats=(), word_timestamps=True)
