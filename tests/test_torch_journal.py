"""The port's resume journal (pipeline/journal.py) against the JAX engine's,
on the CPU with a tiny random model: the same JSONL file (header signature,
one record a window), a resume after a cut journal in the batched and the
sequential mode decoding exactly the windows it lacks, a changed signature
discarding the journal, a torn tail line skipped, and each engine resuming
from the other's journal.

Tolerances: the plan signature, window ids, reset marks, tokens and text
identical; segment times within 1e-6 s and avg_logprob within 1e-3 between
the engines; a resumed run's segments identical to the uninterrupted run's
(same engine)."""

import json

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
from whisper_aries_tpu_torch.pipeline.journal import ResumeJournal

SR = 16_000
KW = dict(temperature=(0.0,), max_new_tokens=8, output_formats=(),
          vad_filter=False, language="en")
MODES = {"batched": {}, "sequential": {"condition_on_previous_text": True}}


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


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    """Three windows without VAD (30, 30 and 10 s)."""
    path = str(tmp_path_factory.mktemp("torch_journal") / "a.wav")
    write_wav(path, speechy_audio(70.0, seed=5), SR)
    return path


def _segs(segs):
    return [(s["text"], list(s["tokens"]), s["window_id"]) for s in segs]


def _lines(path):
    return open(path, encoding="utf-8").read().splitlines()


def _cut(path, keep, tail=""):
    """Keep the header and the first ``keep`` records, then ``tail``."""
    lines = _lines(path)[:1 + keep]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n" + tail)


def _decoded(res):
    """The windows the run decoded (its decode calls' windows)."""
    return sum(d["windows"] for d in res["performance"].get("decodes", []))


@pytest.fixture(scope="module")
def full_runs(engines, wav, tmp_path_factory):
    """Each engine's uninterrupted run and journal, in each mode."""
    d = tmp_path_factory.mktemp("journals")
    out = {}
    for mode, opts in MODES.items():
        for name, eng in zip(("jax", "torch"), engines):
            path = str(d / f"{name}_{mode}.jsonl")
            out[name, mode] = (eng.transcribe_file(wav, resume_path=path,
                                                   **KW, **opts), path)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_journal_file_matches_jax(full_runs, mode):
    (jres, jpath), (tres, tpath) = full_runs["jax", mode], \
        full_runs["torch", mode]
    jl, tl = _lines(jpath), _lines(tpath)
    assert tl[0] == jl[0] and set(json.loads(tl[0])) == {"plan_sig"}
    assert len(tl) == len(jl) == 1 + tres["num_windows"] == 4
    for a, b in zip(tl[1:], jl[1:]):
        ra, rb = json.loads(a), json.loads(b)
        assert set(ra) == set(rb) == {"window_id", "segments", "reset"}
        assert (ra["window_id"], ra["reset"]) == (rb["window_id"], rb["reset"])
        assert _segs(ra["segments"]) == _segs(rb["segments"])
        for sa, sb in zip(ra["segments"], rb["segments"]):
            assert set(sa) == set(sb)
            np.testing.assert_allclose([sa["start"], sa["end"]],
                                       [sb["start"], sb["end"]], atol=1e-6)
            assert abs(sa["avg_logprob"] - sb["avg_logprob"]) < 1e-3
    assert _segs(tres["segments"]) == _segs(jres["segments"])


@pytest.mark.parametrize("mode", list(MODES))
def test_resume_after_a_cut_journal(engines, wav, full_runs, tmp_path, mode):
    """Cut back to its header and first record, the journal makes a rerun
    decode exactly the other windows, with the uninterrupted run's
    segments; a full journal makes it decode nothing."""
    _, teng = engines
    full, src = full_runs["torch", mode]
    path = str(tmp_path / "j.jsonl")
    open(path, "w").write(open(src).read())
    again = teng.transcribe_file(wav, resume_path=path, **KW, **MODES[mode])
    assert _decoded(again) == 0
    assert _segs(again["segments"]) == _segs(full["segments"])
    _cut(path, 1)
    res = teng.transcribe_file(wav, resume_path=path, **KW, **MODES[mode])
    assert _decoded(res) == full["num_windows"] - 1
    assert _segs(res["segments"]) == _segs(full["segments"])
    assert len(_lines(path)) == 1 + full["num_windows"]


def test_changed_signature_discards_the_journal(engines, wav, full_runs,
                                                tmp_path):
    """Another decode option (here max_new_tokens) signs another plan: the
    stale journal is rewritten and every window decoded."""
    _, teng = engines
    full, src = full_runs["torch", "batched"]
    path = str(tmp_path / "j.jsonl")
    open(path, "w").write(open(src).read())
    res = teng.transcribe_file(wav, resume_path=path,
                               **dict(KW, max_new_tokens=6))
    assert _decoded(res) == res["num_windows"] == 3
    assert _lines(path)[0] != _lines(src)[0]
    assert len(_lines(path)) == 4


def test_torn_tail_line_is_skipped(engines, wav, full_runs, tmp_path):
    _, teng = engines
    full, src = full_runs["torch", "batched"]
    path = str(tmp_path / "j.jsonl")
    open(path, "w").write(open(src).read())
    torn = _lines(src)[2][:25]  # a record cut mid-write
    _cut(path, 1, tail=torn)
    journal = ResumeJournal(path, json.loads(_lines(src)[0])["plan_sig"])
    assert list(journal.done) == [json.loads(_lines(src)[1])["window_id"]]
    res = teng.transcribe_file(wav, resume_path=path, **KW)
    assert _decoded(res) == 2
    assert _segs(res["segments"]) == _segs(full["segments"])


@pytest.mark.parametrize("mode", list(MODES))
def test_each_engine_resumes_from_the_others_journal(engines, wav, full_runs,
                                                     tmp_path, mode):
    """The JAX engine resumes from the port's journal and the port from the
    JAX engine's, decoding nothing, with the journaled segments."""
    jeng, teng = engines
    calls = []

    def no_decode(*a, **k):
        calls.append(1)
        raise AssertionError("a journaled window was decoded")

    for eng, other in ((jeng, "torch"), (teng, "jax")):
        full, src = full_runs[other, mode]
        path = str(tmp_path / f"from_{other}.jsonl")
        open(path, "w").write(open(src).read())
        eng._decode_batch = no_decode
        try:
            res = eng.transcribe_file(wav, resume_path=path, **KW,
                                      **MODES[mode])
        finally:
            del eng._decode_batch
        assert _segs(res["segments"]) == _segs(full["segments"])
    assert not calls
