"""The engine's double-buffered batch loop (``ARIES_PIPELINE``) against the
JAX engine's, on the CPU with a tiny random model:

  * at depth 2 (the default) and depth 1, over a 70 s file of 3 windows at
    one window a batch (3 batches): equal segments (text, tokens, window,
    worker; times within 1e-6 s), equal ``performance`` units, and the
    same sequence of ``last_diagnostics`` events (unit, state), in order.
    At depth 2 both engines log batch k + 1's ENCODING / DECODING before
    batch k's COMPLETED;
  * with the fallback ladder (the port alone; the sampled rungs draw from
    other generators in the two frameworks): depth 2 gives depth 1's
    segments, resume journal and decode calls;
  * one out-of-memory error at the default depth: both engines drop to
    depth 1 and keep the batch (4), with equal segments;
  * the helper thread parses only: card work (encode, decode, ladder) and
    every diagnostics event stay in the calling thread, a window whose
    tokens fail to parse becomes a failed segment as at depth 1, and any
    other error in the helper reaches the caller.

Temperature is pinned to (0.0,) where the JAX engine is compared."""

import json
import threading

import numpy as np
import pytest

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from torch_port_util import PieceTokenizer, random_jax_tree, speechy_audio, to_jax
from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.parallel.mesh import make_mesh as jax_mesh
from whisper_aries_tpu.pipeline.engine import AriesTranscriber as JEngine
from whisper_aries_tpu_torch.audio.decode import write_wav
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.parallel import mesh as TM
from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber as TEngine

SR = 16_000
KW = dict(temperature=(0.0,), max_new_tokens=8, output_formats=(),
          vad_filter=False, language="en")
REPORT = ("completed_units", "completed_audio_s", "per_device_distribution")


@pytest.fixture(scope="module")
def model():
    tok = PieceTokenizer(build_special_tokens)
    dims_j = JW.WhisperDims(80, 1500, 64, 2, 2, tok.specials.n_vocab, 448,
                            64, 2, 2)
    dims_t = TW.WhisperDims(*[getattr(dims_j, f)
                              for f in dims_j.__dataclass_fields__])
    tree = random_jax_tree(dims_j, seed=11, weight_std=0.08)
    return tok, dims_j, dims_t, tree


def _engines(model, n=1, wpd=1):
    """The JAX engine on ``make_mesh(n)`` and the port's over ``n`` CPU
    devices, ``wpd`` windows a device."""
    tok, dims_j, dims_t, tree = model
    kw = dict(windows_per_device=wpd, _tokenizer=tok)
    jeng = JEngine(model_size="tiny-torch", _params=to_jax(tree),
                   _dims=dims_j, mesh=jax_mesh(n), **kw)
    mesh = dict(mesh=TM.make_mesh(devices=["cpu"] * n)) if n > 1 else dict(
        device="cpu")
    teng = TEngine(model_size="tiny-torch", _params=TW.params_from_jax(tree),
                   _dims=dims_t, **mesh, **kw)
    return jeng, teng


@pytest.fixture(scope="module")
def pair(model):
    return _engines(model)


@pytest.fixture(scope="module")
def wav3(tmp_path_factory):
    """70 s with VAD off: windows of 30, 30 and 10 s."""
    path = str(tmp_path_factory.mktemp("engine_pipeline") / "three.wav")
    write_wav(path, speechy_audio(70.0, seed=6), SR)
    return path


def _segments(res):
    return [(s["text"], list(s.get("tokens", [])), s["window_id"],
             s["worker_id"]) for s in res["segments"]]


def _times(res):
    return np.asarray([(s["start"], s["end"]) for s in res["segments"]],
                      np.float64).reshape(-1, 2)


def _events(eng):
    return [(e["unit"], e["state"]) for e in eng.last_diagnostics.events]


def _assert_same(got, want):
    assert got["num_windows"] == want["num_windows"]
    assert _segments(got) == _segments(want) and got["segments"]
    np.testing.assert_allclose(_times(got), _times(want), atol=1e-6, rtol=0)
    for k in REPORT:
        assert got["performance"][k] == pytest.approx(want["performance"][k])


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_batch_loop_matches_the_jax_engine(pair, wav3, monkeypatch,
                                           pipeline):
    """Three batches of one window at depth 2 and 1: the JAX engine's
    segments, units and diagnostics events in its order."""
    monkeypatch.setenv("ARIES_PIPELINE", pipeline)
    jeng, teng = pair
    want = jeng.transcribe_file(wav3, **KW)
    got = teng.transcribe_file(wav3, **KW)
    assert got["num_windows"] == 3
    _assert_same(got, want)
    assert got["performance"]["completed_units"] == 3
    assert _events(teng) == _events(jeng)
    states = [(u, s) for u, s in _events(teng) if s != "PLANNED"]
    if pipeline == "1":
        # batch 1 is dispatched before batch 0 completes
        assert states[:5] == [(0, "ENCODING"), (0, "DECODING"),
                              (1, "ENCODING"), (1, "DECODING"),
                              (0, "COMPLETED")]
    else:
        assert states[:3] == [(0, "ENCODING"), (0, "DECODING"),
                              (0, "COMPLETED")]
    depth = 2 if pipeline == "1" else 1
    assert teng.last_stats["pipeline_depth"] == depth
    parses = teng.last_stats["parses"]
    assert [p["batch"] for p in parses] == [0, 1, 2]
    assert [p["helper"] for p in parses] == (
        [True, True, False] if depth == 2 else [False] * 3)
    assert all(p["seconds"] >= p["overlap_dispatch_s"]
               >= p["overlap_decode_s"] >= 0 for p in parses)


def test_default_depth_is_two(pair, wav3, monkeypatch):
    """Without ARIES_PIPELINE the loop runs at depth 2, as JAX's."""
    monkeypatch.delenv("ARIES_PIPELINE", raising=False)
    _, teng = pair
    teng.transcribe_file(wav3, **KW)
    assert teng.last_stats["pipeline_depth"] == 2
    assert teng.last_stats["parses"][0]["helper"]


def _journal_records(path):
    lines = [json.loads(ln) for ln in open(path, encoding="utf-8")]
    return [(r.get("window_id"), r.get("segments"), r.get("reset"))
            for r in lines]


def test_ladder_at_depth_two_equals_depth_one(pair, wav3, monkeypatch,
                                              tmp_path):
    """Every window fails log_prob_threshold 0 and runs the ladder (best_of
    2): depth 2 and depth 1 give the same segments, journal records in the
    same order, and the same decode calls, in each depth's card order."""
    _, teng = pair
    kw = dict(KW, temperature=(0.0, 0.4, 0.8), log_prob_threshold=0.0,
              best_of=2)
    runs = {}
    for pipeline in ("1", "0"):
        monkeypatch.setenv("ARIES_PIPELINE", pipeline)
        journal = str(tmp_path / f"journal{pipeline}.jsonl")
        res = teng.transcribe_file(wav3, resume_path=journal, **kw)
        decodes = [{k: v for k, v in d.items() if k != "seconds"}
                   for d in teng.last_stats["decodes"]]
        runs[pipeline] = (res, _journal_records(journal), decodes,
                          _events(teng))
    (r2, j2, d2, e2), (r1, j1, d1, e1) = runs["1"], runs["0"]
    assert _segments(r2) == _segments(r1) and r2["segments"]
    np.testing.assert_allclose(_times(r2), _times(r1), atol=0, rtol=0)
    assert j2 == j1 and len(j2) == 4  # the header and 3 windows
    # the same calls, in each depth's card order (depth 2: decode 0,
    # decode 1, ladder 0, decode 2, ladder 1, ladder 2)
    key = lambda d: json.dumps(d, sort_keys=True)
    assert sorted(d2, key=key) == sorted(d1, key=key)
    temps = lambda ds: [d["temperature"] for d in ds]
    assert temps(d1)[:2] == [0.0, 0.4] and temps(d2)[:3] == [0.0, 0.0, 0.4]
    assert sorted(e2) == sorted(e1)
    assert sum(s == "FALLBACK" for _, s in e2) == 3
    # depth 2: batch 1's DECODING before batch 0's FALLBACK is logged
    assert e2.index((1, "DECODING")) < e2.index((0, "FALLBACK"))
    assert e1.index((0, "COMPLETED")) < e1.index((1, "ENCODING"))


@pytest.fixture(scope="module")
def wav5(tmp_path_factory):
    """5 windows of 30 s with VAD off: batches of 4 and 1."""
    path = str(tmp_path_factory.mktemp("engine_pipeline") / "five.wav")
    write_wav(path, speechy_audio(140.0, seed=5), SR)
    return path


def test_oom_at_default_depth_keeps_the_batch(model, wav5, monkeypatch):
    """The first out-of-memory error at depth 2 turns pipelining off and
    keeps the batch: 4 in both engines (the serial loop halved it to 2),
    and the retried batches give the JAX engine's segments."""
    monkeypatch.delenv("ARIES_PIPELINE", raising=False)
    jeng, teng = _engines(model, 4)
    failed = {"jax": 0, "torch": 0}

    def flaky(eng, name, msg):
        real = eng._decode_batch

        def decode(*a, **k):
            if failed[name] < (4 if name == "torch" else 1):
                failed[name] += 1
                raise RuntimeError(msg)
            return real(*a, **k)

        return decode

    monkeypatch.setattr(jeng, "_decode_batch", flaky(
        jeng, "jax", "RESOURCE_EXHAUSTED: Out of memory while trying to "
        "allocate 1.2G"))
    for r in teng.replicas:
        monkeypatch.setattr(r, "_decode_batch", flaky(
            teng, "torch", "CUDA out of memory. Tried to allocate 1.2 GiB"))
    want = jeng.transcribe_file(wav5, **KW)
    got = teng.transcribe_file(wav5, **KW)
    assert failed == {"jax": 1, "torch": 4}
    assert teng.batch_size == jeng.batch_size == 4
    assert teng.last_stats["pipeline_depth"] == 1
    _assert_same(got, want)
    assert got["performance"]["per_device_distribution"] == {0: 1, 1: 1}


def test_oom_after_the_first_batch_restarts_at_the_next(pair, wav3,
                                                        monkeypatch):
    """An out-of-memory error in batch 1's decode at depth 2, while batch
    0 is parsed: batch 0 finishes, batch 1 runs again at depth 1 with the
    batch kept, and the segments are the undisturbed run's."""
    monkeypatch.delenv("ARIES_PIPELINE", raising=False)
    _, teng = pair
    want = teng.transcribe_file(wav3, **KW)
    real, calls = teng._decode_batch, []

    def decode(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("CUDA out of memory. Tried to allocate 2 GiB")
        return real(*a, **k)

    monkeypatch.setattr(teng, "_decode_batch", decode)
    got = teng.transcribe_file(wav3, **KW)
    assert len(calls) == 4 and teng.batch_size == 1
    assert teng.last_stats["pipeline_depth"] == 1
    assert _segments(got) == _segments(want)
    assert got["performance"]["completed_units"] == 3
    assert [p["helper"] for p in teng.last_stats["parses"]] == [
        True, False, False]


def test_card_work_stays_in_the_calling_thread(pair, wav3, monkeypatch):
    """At depth 2 the encodes, decodes and ladder run in the calling
    thread, every parse but the last in one helper thread, and every
    diagnostics event is logged by the calling thread."""
    monkeypatch.setenv("ARIES_PIPELINE", "1")
    _, teng = pair
    seen = {"card": set(), "parse": []}

    def spy(name, key):
        real = getattr(teng, name)

        def call(*a, **k):
            if key == "card":
                seen["card"].add(threading.get_ident())
            else:
                seen["parse"].append(threading.get_ident())
            return real(*a, **k)

        monkeypatch.setattr(teng, name, call)

    for name in ("_encode_windows", "_decode_batch", "_fallback_windows"):
        spy(name, "card")
    spy("_parse_one", "parse")
    teng.transcribe_file(wav3, **dict(KW, temperature=(0.0, 0.5),
                                      log_prob_threshold=0.0, best_of=2))
    me = threading.get_ident()
    assert seen["card"] == {me}
    parse_threads = [t for t in seen["parse"] if t != me]
    assert parse_threads and len(set(parse_threads)) == 1
    assert {e["thread"] for e in teng.last_diagnostics.events} == {me}


def test_parse_error_in_the_helper_fails_its_window(pair, wav3,
                                                    monkeypatch):
    """Tokens that fail to parse in the helper make one failed segment
    for the window (an ERROR event, no journal record), as at depth 1."""
    _, teng = pair
    real = teng._parse_one

    def parse_one(toks, window, *a, **k):
        if window.start == 0.0:
            raise ValueError("a token the tokenizer cannot place")
        return real(toks, window, *a, **k)

    monkeypatch.setattr(teng, "_parse_one", parse_one)
    runs = {}
    for pipeline in ("1", "0"):
        monkeypatch.setenv("ARIES_PIPELINE", pipeline)
        res = teng.transcribe_file(wav3, **KW)
        runs[pipeline] = (_segments(res), _events(teng),
                          [s.get("success", True) for s in res["segments"]])
    assert runs["1"][0] == runs["0"][0]
    assert runs["1"][2] == runs["0"][2] and runs["1"][2][0] is False
    assert (0, "ERROR") in runs["1"][1]
    assert (0, "COMPLETED") not in runs["1"][1]
    assert sorted(runs["1"][1]) == sorted(runs["0"][1])


def test_other_errors_in_the_helper_reach_the_caller(pair, wav3,
                                                     monkeypatch):
    """An error the parse does not catch re-raises in the calling thread
    after the join."""
    monkeypatch.setenv("ARIES_PIPELINE", "1")
    _, teng = pair

    def broken(*a, **k):
        raise KeyError("avg_logprob")

    monkeypatch.setattr(teng, "_parse_or_fail", broken)
    with pytest.raises(KeyError, match="avg_logprob"):
        teng.transcribe_file(wav3, **KW)
