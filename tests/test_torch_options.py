"""The per-call options of the port's ``transcribe_file`` and its window
planning against the JAX engine on the same tiny random model and WAV, on
the CPU: VAD off and VAD parameters, fixed chunking (with ``chunk_size``)
under both overlap strategies, suppress_tokens (with -1),
without_timestamps, max_initial_timestamp, repetition_penalty,
no_repeat_ngram_size, multilingual (a language per window, greedy and
beam), progress_callback's calls and the per-window diagnostics; the
16 s encoder bucket (``audio_ctx="bucket"``) encoding at T 800 exactly
where the JAX engine's does; the constructor's mel_backend and audio_ctx.

Temperature is pinned to (0.0,): the sampled rungs of the fallback ladder
draw from different generators in the two frameworks."""

import numpy as np
import pytest
import torch

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


# ---------------------------------------------------------------------------
# audio_ctx="bucket"
# ---------------------------------------------------------------------------


def _bursts_wav(tmp_path_factory, name, bursts, seconds):
    rng = np.random.default_rng(1)
    n = int(SR * seconds)
    t = np.arange(n) / SR
    x = 0.002 * rng.standard_normal(n).astype(np.float32)
    for s, e in bursts:
        m = (t >= s) & (t < e)
        x[m] += (0.3 * np.sin(2 * np.pi * 280 * t[m])
                 * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t[m]))
                 ).astype(np.float32)
    p = tmp_path_factory.mktemp("bucket") / name
    write_wav(str(p), x, SR)
    return str(p)


@pytest.fixture(scope="module")
def sparse_wav(tmp_path_factory):
    """Two short bursts more than the planner's 3 s bridge apart."""
    return _bursts_wav(tmp_path_factory, "sparse.wav",
                       [(1.0, 5.0), (13.0, 17.0)], 24.0)


@pytest.fixture(scope="module")
def mixed_wav(tmp_path_factory):
    """Two short bursts, then one of 20 s (a window over 16 s)."""
    return _bursts_wav(tmp_path_factory, "mixed.wav",
                       [(1.0, 5.0), (13.0, 17.0), (25.0, 45.0)], 48.0)


def _bucket_pair(model, windows_per_device=1):
    from whisper_aries_tpu.config import load_config as jax_load_config
    from whisper_aries_tpu_torch.config import load_config

    over = {"vad.backend": "energy"}
    return _pair(model, config=load_config(overrides=over),
                 jax_config=jax_load_config(overrides=over),
                 windows_per_device=windows_per_device, audio_ctx="bucket")


def _jax_encodes(jeng):
    """Spy on the JAX engine's window gathers: {T: windows gathered for
    encoding at context T} (its padding rows of a short last batch not
    counted; the port pads no batch)."""
    counts = {}
    real = jeng._gather_span

    def spy(uploader, windows, batch_idx, B, win=None):
        T = (win or jeng.WINDOW_SAMPLES) // 320
        counts[T] = counts.get(T, 0) + len(batch_idx)
        return real(uploader, windows, batch_idx, B, win=win)

    jeng._gather_span = spy
    return counts


@pytest.mark.parametrize("windows_per_device,wav_name,language", [
    (1, "sparse", "en"), (1, "sparse", None), (2, "mixed", None),
    (1, "mixed", "en"),
])
def test_bucket_encodes_short_windows_at_800(model, sparse_wav, mixed_wav,
                                             windows_per_device, wav_name,
                                             language):
    """Batches made only of windows of <= 16 s are gathered at 256,000
    samples and encoded at T 800, exactly where the JAX engine's are; the
    segments match the JAX bucket engine's."""
    wav = {"sparse": sparse_wav, "mixed": mixed_wav}[wav_name]
    jeng, teng = _bucket_pair(model, windows_per_device)
    jcounts = _jax_encodes(jeng)
    kw = dict(language=language, temperature=(0.0,), max_new_tokens=12,
              output_formats=())
    want = jeng.transcribe_file(wav, **kw)
    got = teng.transcribe_file(wav, **kw)
    _assert_same(got, want)
    assert teng.last_stats["encodes"] == jcounts
    assert teng.last_stats["encodes"][800] >= 2
    long_windows = 1 if wav_name == "mixed" else 0
    assert teng.last_stats["encodes"].get(1500, 0) == long_windows
    assert {d["audio_ctx"] for d in teng.last_stats["decodes"]} == (
        {800, 1500} if long_windows else {800})
    for s in got["segments"]:
        assert 0.0 <= s["start"] <= s["end"] <= got["duration"] + 0.5


def test_bucket_without_vad_keeps_the_30s_context(model, sparse_wav):
    """vad_filter=False tiles the 24 s file into one window over 16 s: it
    keeps the 30 s context, in both engines."""
    jeng, teng = _bucket_pair(model)
    jcounts = _jax_encodes(jeng)
    kw = dict(language="en", temperature=(0.0,), max_new_tokens=12,
              output_formats=(), vad_filter=False)
    want = jeng.transcribe_file(sparse_wav, **kw)
    got = teng.transcribe_file(sparse_wav, **kw)
    _assert_same(got, want)
    assert teng.last_stats["encodes"] == jcounts == {1500: 1}


def test_bucket_off_encodes_at_1500(model, sparse_wav):
    from whisper_aries_tpu_torch.config import load_config

    _, teng = _pair(model, config=load_config(
        overrides={"vad.backend": "energy"}))
    res = teng.transcribe_file(sparse_wav, language="en", temperature=(0.0,),
                               max_new_tokens=4, output_formats=())
    assert teng.last_stats["encodes"] == {1500: res["num_windows"]}


# ---------------------------------------------------------------------------
# the constructor's options
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mel_backend", ["auto", "pallas", "xla"])
def test_mel_backend_on_the_cpu(model, mel_backend):
    """Every mel_backend runs on the CPU, where the one mel is the plain
    version; so does decode.mel_backend from the config."""
    from whisper_aries_tpu_torch.config import load_config

    _, teng = _pair(model, mel_backend=mel_backend)
    assert teng.mel_backend == mel_backend
    _, teng = _pair(model, config=load_config(
        overrides={"decode.mel_backend": mel_backend}))
    assert teng.mel_backend == mel_backend


@pytest.mark.parametrize("kw,match", [
    (dict(mel_backend="cufft"), "unknown mel_backend"),
    (dict(audio_ctx="short"), "unknown audio_ctx"),
])
def test_constructor_rejects_unknown_values(model, kw, match):
    with pytest.raises(ValueError, match=match):
        _pair(model, **kw)


@pytest.mark.cuda
def test_mel_backend_xla_raises_on_the_card(model):
    """On the card the mel is the kernel: "xla" has no path there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    tok, _, dims_t, tree = model
    with pytest.raises(ValueError, match="mel_backend='xla'"):
        TEngine(model_size="tiny-torch", device="cuda", mel_backend="xla",
                _params=TW.params_from_jax(tree), _dims=dims_t,
                _tokenizer=tok)


def test_constructor_takes_the_jax_engines_chunking(model, wav):
    """chunk_length_minutes and overlap_seconds plan the fixed chunks as
    in the JAX engine; num_workers sizes the batch."""
    jeng, teng = _pair(model, chunk_length_minutes=0.25, overlap_seconds=2.0)
    kw = dict(chunking_mode="fixed", language="en", temperature=(0.0,),
              max_new_tokens=8, output_formats=())
    want = jeng.transcribe_file(wav, **kw)
    got = teng.transcribe_file(wav, **kw)
    assert got["num_windows"] == want["num_windows"] == 3
    _assert_same(got, want)
    tok, _, dims_t, tree = model
    eng = TEngine(model_size="tiny-torch", device="cpu", num_workers=3,
                  _params=TW.params_from_jax(tree), _dims=dims_t,
                  _tokenizer=tok)
    assert eng.batch_size == 3
