"""``ARIES_DEFER_LANG=0`` in the port's ``transcribe_file`` against the JAX
engine's, on the CPU with tests/test_torch_options.py's tiny random model.

With no language given, both engines by default detect it from the first
batch they run (deferred). Under the 16 s bucket the short windows run
first, so the window and the encoder context of that detection depend on
the batching. At ``ARIES_DEFER_LANG=0`` both detect it from window 0's
30 s mel before any batch: on a file whose first window is longer than
16 s, the port's language and probability then equal the JAX engine's,
and the port's deferred run (the knob unset) gives another probability.

Temperature is pinned to (0.0,)."""

import numpy as np
import pytest

from test_torch_options import SR, _assert_same, _pair, model  # noqa: F401
from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from whisper_aries_tpu_torch.audio.decode import write_wav


@pytest.fixture(scope="module")
def long_first_wav(tmp_path_factory):
    """A 20 s burst (a window over 16 s, at 30 s context under the
    bucket), then two short bursts more than the planner's bridge apart."""
    rng = np.random.default_rng(2)
    n = int(SR * 44.0)
    t = np.arange(n) / SR
    x = 0.002 * rng.standard_normal(n).astype(np.float32)
    for s, e in ((1.0, 21.0), (26.0, 30.0), (36.0, 40.0)):
        m = (t >= s) & (t < e)
        x[m] += (0.3 * np.sin(2 * np.pi * 280 * t[m])
                 * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t[m]))
                 ).astype(np.float32)
    p = tmp_path_factory.mktemp("defer_lang") / "long_first.wav"
    write_wav(str(p), x, SR)
    return str(p)


def test_defer_lang_0_detects_from_window_0_at_30s(model, long_first_wav,
                                                    monkeypatch):
    from whisper_aries_tpu.config import load_config as jax_load_config
    from whisper_aries_tpu_torch.config import load_config

    over = {"vad.backend": "energy"}
    jeng, teng = _pair(model, config=load_config(overrides=over),
                       jax_config=jax_load_config(overrides=over),
                       audio_ctx="bucket")
    kw = dict(language=None, temperature=(0.0,), max_new_tokens=8,
              output_formats=())
    monkeypatch.setenv("ARIES_DEFER_LANG", "0")
    want = jeng.transcribe_file(long_first_wav, **kw)
    got = teng.transcribe_file(long_first_wav, **kw)
    # the long window and the detection encoded at 30 s, the short
    # windows at the bucket's 800
    assert teng.last_stats["encodes"].get(800, 0) >= 1
    assert teng.last_stats["encodes"].get(1500, 0) == 2
    assert got["language"] == want["language"]
    assert abs(got["language_probability"]
               - want["language_probability"]) <= 1e-5
    _assert_same(got, want)
    # deferred (the default): detected from the first batch's window at
    # that batch's context, which here is a short window at 800
    monkeypatch.delenv("ARIES_DEFER_LANG")
    deferred = teng.transcribe_file(long_first_wav, **kw)
    assert abs(deferred["language_probability"]
               - want["language_probability"]) > 1e-5
