"""Conditioned decoding in the port's ``transcribe_file`` against the JAX
engine on the same tiny random model and WAV, on the CPU: ``initial_prompt``,
``hotwords``, ``prefix``, ``condition_on_previous_text`` (greedy, beam, with
a prompt and a prefix, multilingual) and ``prompt_reset_on_temperature``.

Tolerances: tokens, text, language and segment times identical;
``avg_logprob`` within 1e-3. Temperature is pinned to (0.0,) in the parity
cases: the sampled rungs draw from different generators in the two
frameworks. The fallback ladder's conditioning state (which prompt each
window gets, which windows reset the context) is held with ``_decode_batch``
stubbed identically on both engines, so the reset on the accepted
temperature is tested without sampling."""

import numpy as np
import pytest

from torch_port_util import PieceTokenizer, random_jax_tree, speechy_audio, to_jax
from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.parallel.mesh import make_mesh
from whisper_aries_tpu.pipeline.engine import AriesTranscriber as JEngine
from whisper_aries_tpu_torch.audio.decode import write_wav
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber as TEngine

SR = 16_000


@pytest.fixture(scope="module")
def engines():
    tok = PieceTokenizer(build_special_tokens)
    dims_j = JW.WhisperDims(80, 1500, 64, 2, 2, tok.specials.n_vocab, 448,
                            64, 2, 2)
    dims_t = TW.WhisperDims(*[getattr(dims_j, f)
                              for f in dims_j.__dataclass_fields__])
    tree = random_jax_tree(dims_j, seed=11, weight_std=0.08)
    kw = dict(windows_per_device=1, _tokenizer=tok)
    jeng = JEngine(model_size="tiny-torch", _params=to_jax(tree),
                   _dims=dims_j, mesh=make_mesh(1), **kw)
    teng = TEngine(model_size="tiny-torch", device="cpu",
                   _params=TW.params_from_jax(tree), _dims=dims_t, **kw)
    return jeng, teng


def _wav(tmp_path_factory, seconds):
    path = str(tmp_path_factory.mktemp("torch_conditioned") / "a.wav")
    write_wav(path, speechy_audio(seconds, seed=5), SR)
    return path


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    """Two windows without VAD (30 s and 10 s)."""
    return _wav(tmp_path_factory, 40.0)


@pytest.fixture(scope="module")
def wav4(tmp_path_factory):
    """Four windows without VAD (the stubbed decode's file)."""
    return _wav(tmp_path_factory, 100.0)


KW = dict(temperature=(0.0,), max_new_tokens=10, output_formats=(),
          vad_filter=False)


@pytest.fixture(scope="module")
def base(engines, wav):
    """The port's segments of the same call without any option."""
    return _segments(engines[1].transcribe_file(wav, **KW))


def _segments(res):
    return [(s["text"], list(s["tokens"]), s.get("language"))
            for s in res["segments"]]


CASES = {
    "initial_prompt": dict(initial_prompt="hello world"),
    "hotwords": dict(hotwords="good morning"),
    "prefix": dict(prefix="the cat sat"),
    "initial_prompt, multilingual": dict(initial_prompt="hello",
                                         multilingual=True),
    "condition": dict(condition_on_previous_text=True),
    "condition, prompt and prefix": dict(condition_on_previous_text=True,
                                         initial_prompt="how are you",
                                         prefix="good"),
    "condition, beam": dict(condition_on_previous_text=True, beam_size=3),
    "condition, multilingual": dict(condition_on_previous_text=True,
                                    multilingual=True),
}


#: the cases whose output must differ from the call without them, so the
#: parity is not vacuous
MOVES = ("initial_prompt", "hotwords", "prefix", "condition")


@pytest.mark.parametrize("case", list(CASES))
def test_conditioned_option_matches_jax(engines, wav, base, case):
    jeng, teng = engines
    kw = dict(KW, **CASES[case])
    want = jeng.transcribe_file(wav, **kw)
    got = teng.transcribe_file(wav, **kw)
    assert got["num_windows"] == want["num_windows"] == 2
    assert got["language"] == want["language"]
    assert _segments(got) == _segments(want) and got["segments"]
    times = lambda r: [(s["start"], s["end"]) for s in r["segments"]]
    np.testing.assert_allclose(times(got), times(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        [s["avg_logprob"] for s in got["segments"]],
        [s["avg_logprob"] for s in want["segments"]], atol=1e-3, rtol=0)
    decodes = got["performance"]["decodes"]
    if CASES[case].get("condition_on_previous_text"):
        # one window a decode call, each at its own left pad over one
        # cache length: 224 + the sot sequence (3) + the prefix + 10
        assert [d["windows"] for d in decodes] == [1, 1]
        assert len({d["cache_len"] for d in decodes}) == 1
        assert any(d["prompt_start"] > 0 for d in decodes)
    elif "prefix" in CASES[case]:
        # the first window alone, its prompt padded by the 224 positions
        # of an absent context
        assert decodes[0]["windows"] == 1 and decodes[0]["prompt_start"] == 224
    if case in MOVES:
        assert _segments(got) != base


# ---------------------------------------------------------------------------
# the conditioning state under a stubbed decode
# ---------------------------------------------------------------------------

#: the temperature each window's decode is accepted at: window 1 recovers
#: at 0.2 (keeps the context), window 2 at 0.8 (resets it), window 3 at 0
ACCEPT = {0: 0.0, 1: 0.2, 2: 0.8, 3: 0.0}


class StubDecode:
    """A deterministic decode: a window's rows get a timestamped run of
    text tokens made from (window, temperature), with avg_logprob -0.1
    where the window is accepted at that temperature and -3 below it. The
    window is the one whose first-pass call came last. Records every
    call's (prompt, temperature, prompt_start, sot_index)."""

    def __init__(self, specials):
        self.sp = specials
        self.calls = []
        self.window = -1

    def __call__(self, prompt, temperature, sample_len, prompt_start,
                 sot_index):
        prompt = np.asarray(prompt)
        if temperature == 0.0:
            self.window += 1
        w = self.window
        self.calls.append((prompt.copy(), float(temperature),
                           int(prompt_start), int(sot_index)))
        R, P = prompt.shape
        tokens = np.full((R, P + sample_len), self.sp.eot, np.int64)
        tokens[:, :P] = prompt
        k = int(round(temperature * 10))
        text = [(3 * w + k + j) % 20 for j in range(4)]
        tb = self.sp.timestamp_begin
        tokens[:, P:P + 6] = [tb] + text + [tb + 50]
        ok = temperature >= ACCEPT[w]
        lp = np.full((R,), -0.1 if ok else -3.0, np.float32)
        return {"tokens": tokens, "n_sampled": np.full((R,), 6),
                "sum_logprob": lp * 7, "avg_logprob": lp,
                "no_speech_prob": np.zeros((R,), np.float32)}


def _stubbed_run(eng, stub, wav, journal, jax_engine):
    if jax_engine:
        def decode(xa, prompt, beam_size, temperature, sample_len,
                   length_penalty, seed=0, repetition_penalty=1.0,
                   sot_index=0, patience=1.0, no_repeat_ngram_size=0,
                   prompt_start=0, opts=None, fetch=True, row_lang=None):
            return stub(prompt, temperature, sample_len, prompt_start,
                        sot_index)
    else:
        def decode(xa, prompt, temperature, sample_len, seed=0, beam_size=1,
                   patience=1.0, length_penalty=1.0, opts=None, sot_index=0,
                   prompt_start=0):
            return stub(prompt, temperature, sample_len, prompt_start,
                        sot_index)
    eng._decode_batch = decode
    try:
        return eng.transcribe_file(
            wav, temperature=(0.0, 0.2, 0.8), max_new_tokens=10,
            output_formats=(), vad_filter=False, language="en",
            condition_on_previous_text=True, initial_prompt="hello",
            prompt_reset_on_temperature=0.5, resume_path=journal)
    finally:
        del eng._decode_batch


def test_context_resets_on_the_accepted_temperature(engines, wav4, tmp_path):
    """Both engines send the same prompts (rows, left pad, sot index,
    temperature) and journal the same reset marks. Window 1, accepted at
    0.2, keeps the context: window 2's prompt carries its accepted text.
    Window 2, accepted at 0.8, resets it: window 3's prompt is the
    initial prompt alone."""
    import json

    jeng, teng = engines
    sp = teng.tokenizer.specials
    runs = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        stub = StubDecode(sp)
        path = str(tmp_path / f"{name}.jsonl")
        res = _stubbed_run(eng, stub, wav4, path, name == "jax")
        recs = [json.loads(l) for l in open(path).read().splitlines()[1:]]
        runs[name] = (stub.calls, res, recs)
    (jc, jres, jrec), (tc, tres, trec) = runs["jax"], runs["torch"]
    assert len(tc) == len(jc) == 4 + 1 + 2
    for (pt, tt, st, ot), (pj, tj, sj, oj) in zip(tc, jc):
        assert (tt, st, ot) == (tj, sj, oj)
        np.testing.assert_array_equal(pt, pj)
    assert _segments(tres) == _segments(jres)
    assert [(r["window_id"], r["reset"]) for r in trec] == \
        [(r["window_id"], r["reset"]) for r in jrec] == \
        [(0, False), (1, False), (2, True), (3, False)]
    first = [c for c in tc if c[1] == 0.0]
    text_of = lambda w, t: [(3 * w + int(round(t * 10)) + j) % 20
                            for j in range(4)]
    hello = teng.tokenizer.encode(" hello")
    for w, (ctx, t) in enumerate([(hello, None), (None, 0.0), (None, 0.2),
                                  (hello, None)]):
        real = first[w][0][0, first[w][2]:]
        assert real[0] == sp.sot_prev
        want = ctx if ctx is not None else text_of(w - 1, t)
        assert list(real[1:1 + len(want)]) == want
        assert real[1 + len(want)] == sp.sot
    # the pad is -1 up to prompt_start and the sot sits at sot_index
    for prompt, _, ps, so in tc:
        assert (prompt[:, :ps] == -1).all() and (prompt[:, ps:] >= 0).all()
        assert (prompt[:, so] == sp.sot).all()


def test_resume_replays_the_context_reset(engines, wav4, tmp_path):
    """A resume from a journal cut after window 2 (the one that reset the
    context) decodes window 3 alone, with the prompt of the full run: the
    journal's reset mark is replayed."""
    _, teng = engines
    sp = teng.tokenizer.specials
    path = str(tmp_path / "j.jsonl")
    full = StubDecode(sp)
    res = _stubbed_run(teng, full, wav4, path, False)
    lines = open(path).read().splitlines()
    with open(path, "w") as f:
        f.write("\n".join(lines[:4]) + "\n")  # header, windows 0, 1, 2
    again = StubDecode(sp)
    again.window = 2  # the stub's window count resumes at window 3
    res2 = _stubbed_run(teng, again, wav4, path, False)
    assert _segments(res2) == _segments(res)
    assert len(again.calls) == 1
    np.testing.assert_array_equal(again.calls[0][0], full.calls[-1][0])
