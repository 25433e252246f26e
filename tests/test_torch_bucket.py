"""The 16 s encoder bucket (``audio_ctx="bucket"``) of the port's
``transcribe_file`` and the engine constructor's options, against the JAX
engine on the CPU, on the tiny random model of tests/
test_torch_options.py: batches made only of windows of <= 16 s encode at
T 800 exactly where the JAX engine's do, with the same segments; without
VAD, or with the bucket off, the 30 s context stays; mel_backend,
audio_ctx and the JAX engine's chunking arguments in the constructor.

Temperature is pinned to (0.0,): the sampled rungs of the fallback ladder
draw from different generators in the two frameworks."""

import numpy as np
import pytest
import torch

from test_torch_options import (  # noqa: F401  (fixtures)
    SR,
    _assert_same,
    _pair,
    model,
    wav,
)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from whisper_aries_tpu_torch.audio.decode import write_wav
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber as TEngine

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
