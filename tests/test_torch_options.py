"""The per-call options of the port's ``transcribe_file`` and its window
planning against the JAX engine on the same tiny random model and WAV, on
the CPU: VAD off and VAD parameters, fixed chunking (with ``chunk_size``)
under both overlap strategies, suppress_tokens (with -1),
without_timestamps, max_initial_timestamp, repetition_penalty,
no_repeat_ngram_size, multilingual (a language per window, greedy and
beam), progress_callback's calls and the per-window diagnostics. The
16 s encoder bucket's tests (``audio_ctx="bucket"``) and the
constructor's options are in tests/test_torch_bucket.py, on this file's
model.

Temperature is pinned to (0.0,): the sampled rungs of the fallback ladder
draw from different generators in the two frameworks."""

import numpy as np
import pytest

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from torch_port_util import PieceTokenizer, random_jax_tree, speechy_audio, to_jax
from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.parallel.mesh import make_mesh
from whisper_aries_tpu.pipeline.engine import AriesTranscriber as JEngine
from whisper_aries_tpu_torch.audio.decode import write_wav
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber as TEngine

SR = 16_000


class NonSpeechPieces(PieceTokenizer):
    """The piece tokenizer with a non-empty non-speech set ("." and ",")."""

    def non_speech_tokens(self, encoder):
        return [15, 16]


@pytest.fixture(scope="module")
def model():
    tok = NonSpeechPieces(build_special_tokens)
    dims_j = JW.WhisperDims(80, 1500, 64, 2, 2, tok.specials.n_vocab, 448,
                            64, 2, 2)
    dims_t = TW.WhisperDims(*[getattr(dims_j, f)
                              for f in dims_j.__dataclass_fields__])
    tree = random_jax_tree(dims_j, seed=11, weight_std=0.08)
    return tok, dims_j, dims_t, tree


def _pair(model, config=None, jax_config=None, **kw):
    """The JAX and port engines on one model; the JAX engine on a one-device
    mesh, so both batch ``windows_per_device`` windows."""
    tok, dims_j, dims_t, tree = model
    kw = dict(dict(windows_per_device=1, _tokenizer=tok), **kw)
    jeng = JEngine(model_size="tiny-torch", _params=to_jax(tree),
                   _dims=dims_j, mesh=make_mesh(1), config=jax_config, **kw)
    teng = TEngine(model_size="tiny-torch", device="cpu",
                   _params=TW.params_from_jax(tree), _dims=dims_t,
                   config=config, **kw)
    return jeng, teng


@pytest.fixture(scope="module")
def engines(model):
    return _pair(model)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_options") / "long.wav")
    write_wav(path, speechy_audio(40.0, seed=5), SR)
    return path


def _segments(res):
    return [(s["text"], list(s["tokens"]), s.get("language"),
             s.get("chunk_id")) for s in res["segments"]]


def _times(res):
    return np.asarray([(s["start"], s["end"]) for s in res["segments"]],
                      np.float64).reshape(-1, 2)


def _assert_same(got, want):
    assert got["num_windows"] == want["num_windows"]
    assert got["language"] == want["language"]
    assert _segments(got) == _segments(want)
    np.testing.assert_allclose(_times(got), _times(want), atol=1e-6, rtol=0)
    assert got["text"] == want["text"]


CASES = {
    "vad_filter off": dict(vad_filter=False),
    "vad_parameters": dict(vad_parameters={"threshold": 0.6,
                                           "min_silence_duration_ms": 300,
                                           "speech_pad_ms": 100}),
    "chunk_size, drop": dict(chunk_size=30, overlap_strategy="drop"),
    "chunk_size, merge": dict(chunk_size=30, overlap_strategy="merge"),
    "fixed, 3 min chunks": dict(chunking_mode="fixed"),
    "suppress_tokens -1": dict(suppress_tokens=[-1]),
    "suppress_tokens ids": dict(suppress_tokens=[2, 3, 4]),
    "without_timestamps": dict(without_timestamps=True),
    "max_initial_timestamp 0": dict(max_initial_timestamp=0.0),
    "max_initial_timestamp 0.5": dict(max_initial_timestamp=0.5),
    "repetition_penalty": dict(repetition_penalty=1.5),
    "no_repeat_ngram_size": dict(no_repeat_ngram_size=2),
    "no_repeat_ngram_size, untimed": dict(no_repeat_ngram_size=2,
                                          without_timestamps=True),
    "multilingual": dict(multilingual=True),
    "multilingual, language given": dict(multilingual=True, language="en"),
    "beam, penalties": dict(beam_size=3, repetition_penalty=1.3,
                            no_repeat_ngram_size=3),
    "beam, multilingual": dict(beam_size=3, multilingual=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_option_matches_jax(engines, wav, case):
    """The same segments (text, tokens, language, chunk) with start and
    end within 1e-6 s, the same progress calls and the same per-window
    diagnostics as the JAX engine."""
    jeng, teng = engines
    calls = {"jax": [], "torch": []}
    kw = dict(temperature=(0.0,), max_new_tokens=12, output_formats=(),
              **CASES[case])
    want = jeng.transcribe_file(
        wav, progress_callback=lambda d, t: calls["jax"].append((d, t)), **kw)
    got = teng.transcribe_file(
        wav, progress_callback=lambda d, t: calls["torch"].append((d, t)),
        **kw)
    _assert_same(got, want)
    assert got["segments"], "the case decoded nothing"
    assert calls["torch"] == calls["jax"]
    assert calls["torch"][-1] == (got["num_windows"], got["num_windows"])
    assert got["diagnostics"] == want["diagnostics"]
    assert got["diagnostics"]["PLANNED"] == got["num_windows"]


def test_options_change_the_decode(engines, wav):
    """Each option moves this model's output, so the parity above is not
    vacuous: its segments differ from those of the same call without it
    (n-gram bans bite only without timestamps here, where a window's
    tokens run on; between timestamps each segment holds one token)."""
    _, teng = engines
    kw = dict(temperature=(0.0,), max_new_tokens=16, output_formats=())
    run = lambda **o: _segments(teng.transcribe_file(wav, **kw, **o))
    base = run()
    for case in ("suppress_tokens ids", "without_timestamps",
                 "max_initial_timestamp 0", "repetition_penalty",
                 "chunk_size, drop", "multilingual"):
        assert run(**CASES[case]) != base, case
    assert run(**CASES["no_repeat_ngram_size, untimed"]) != run(
        without_timestamps=True)


@pytest.mark.parametrize("seed", range(4))
def test_overlap_reconciliation_matches_jax(seed):
    """The port's copies of the overlap strategies against the JAX
    package's on random chunked segment lists with overlaps (the tiny
    model's segments rarely overlap by enough to engage them)."""
    from whisper_aries_tpu.utils import segments as JS
    from whisper_aries_tpu_torch.utils import segments as TS

    rng = np.random.default_rng(seed)
    words = ["hello", "world", "good", "morning", "hello world"]
    segs = []
    for chunk in range(4):
        t = chunk * 25.0
        for _ in range(int(rng.integers(3, 9))):
            start = t + float(rng.uniform(0.0, 4.0))
            end = start + float(rng.uniform(0.2, 6.0))
            segs.append({"start": start, "end": end, "chunk_id": chunk,
                         "text": " " + str(rng.choice(words))})
            t = start + float(rng.uniform(0.5, 5.0))
    segs.sort(key=lambda s: (s["start"], s["end"]))
    for tol in (0.5, 1.0, 2.0):
        assert TS.remove_overlaps_drop(segs, tol) == \
            JS.remove_overlaps_drop(segs, tol)
        assert TS.merge_overlapping_segments(segs, tol) == \
            JS.merge_overlapping_segments(segs, tol)
    assert len(TS.remove_overlaps_drop(segs)) < len(segs)
    assert len(TS.merge_overlapping_segments(segs)) < len(segs)


def test_options_default_to_config(model, wav):
    """Options left None come from config.decode: an engine whose config
    sets them decodes as the default engine called with them."""
    from whisper_aries_tpu_torch.config import load_config

    _, eng = _pair(model)
    _, cfg_eng = _pair(model, config=load_config(overrides={
        "decode.repetition_penalty": 1.5, "decode.no_repeat_ngram_size": 2,
        "decode.max_initial_timestamp": 0.5,
        "decode.suppress_tokens": [2, 3, 4]}))
    kw = dict(temperature=(0.0,), max_new_tokens=16, output_formats=())
    want = eng.transcribe_file(wav, repetition_penalty=1.5,
                               no_repeat_ngram_size=2,
                               max_initial_timestamp=0.5,
                               suppress_tokens=[2, 3, 4], **kw)
    got = cfg_eng.transcribe_file(wav, **kw)
    assert _segments(got) == _segments(want)


def test_multilingual_segments_carry_their_window_language(engines, wav):
    """Every segment carries its window's detected language, one of the
    model's; the prompt rows of a window carry its token."""
    _, teng = engines
    prompts = []
    real = teng._decode_batch

    def spy(xa, prompt, *a, **k):
        prompts.append(np.asarray(prompt))
        return real(xa, prompt, *a, **k)

    teng._decode_batch = spy
    try:
        res = teng.transcribe_file(wav, temperature=(0.0,), max_new_tokens=8,
                                   output_formats=(), multilingual=True,
                                   beam_size=2)
    finally:
        del teng._decode_batch
    sp = teng.tokenizer.specials
    langs = set(sp.language_tokens)
    assert res["segments"] and all(s["language"] in langs
                                   for s in res["segments"])
    lang_ids = set(sp.language_tokens.values())
    for p in prompts:
        assert set(p[:, 1].tolist()) <= lang_ids


def test_fallback_ladder_keeps_the_window_language(engines, wav):
    """log_prob_threshold 0 sends every window up the ladder: every rung's
    prompt rows keep their window's language token."""
    _, teng = engines
    seen = []
    real = teng._decode_batch

    def spy(xa, prompt, temperature, *a, **k):
        seen.append((temperature, np.asarray(prompt)[:, 1].copy()))
        return real(xa, prompt, temperature, *a, **k)

    teng._decode_batch = spy
    try:
        res = teng.transcribe_file(wav, temperature=(0.0, 0.5), best_of=2,
                                   log_prob_threshold=0.0, max_new_tokens=8,
                                   output_formats=(), multilingual=True)
    finally:
        del teng._decode_batch
    assert any(t == 0.0 for t, _ in seen) and any(t > 0.0 for t, _ in seen)
    assert res["diagnostics"]["FALLBACK"] >= 1
    # each rung's rows: best_of samples of the batch's failing windows,
    # each with its window's language token from the first pass
    last = None
    for t, p in seen:
        if t == 0.0:
            last = p
        else:
            assert np.array_equal(p, np.repeat(last, 2))
