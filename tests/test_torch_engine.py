"""The port's main path end to end — AriesTranscriber.transcribe_file on a
70 s WAV (learned VAD, log-mel, encoder, greedy decode with the timestamp
grammar, parse, TXT/JSON/SRT) — against the JAX engine on shared tiny
random weights, on the CPU.

Temperature is pinned to (0.0,): the sampled rungs of the fallback ladder
draw from different generators in the two frameworks and cannot match, so
the ladder is tested on the port alone (well-formed output)."""

import json

import numpy as np
import pytest

from torch_port_util import PieceTokenizer, random_jax_tree, speechy_audio, to_jax
from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.pipeline.engine import AriesTranscriber as JEngine
from whisper_aries_tpu_torch.audio.decode import write_wav
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber as TEngine

SR = 16_000


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tok = PieceTokenizer(build_special_tokens)
    dims_j = JW.WhisperDims(80, 1500, 64, 2, 2, tok.specials.n_vocab, 448,
                            64, 2, 2)
    dims_t = TW.WhisperDims(*[getattr(dims_j, f)
                              for f in dims_j.__dataclass_fields__])
    tree = random_jax_tree(dims_j, seed=11, weight_std=0.08)
    path = str(tmp_path_factory.mktemp("torch_engine") / "long.wav")
    write_wav(path, speechy_audio(70.0, seed=5), SR)
    return tok, dims_j, dims_t, tree, path


def _segments(res):
    return [(s["text"], s["start"], s["end"]) for s in res["segments"]]


@pytest.mark.parametrize("compute_type,kv", [("bf16", None), ("int8", "int8")])
def test_transcribe_file_matches_jax_engine(pair, tmp_path, compute_type, kv):
    tok, dims_j, dims_t, tree, wav = pair
    kw = dict(windows_per_device=1, compute_type=compute_type,
              kv_cache_dtype=kv, _tokenizer=tok)
    jeng = JEngine(model_size="tiny-torch", _params=to_jax(tree),
                   _dims=dims_j, **kw)
    teng = TEngine(model_size="tiny-torch", device="cpu",
                   _params=TW.params_from_jax(tree), _dims=dims_t, **kw)
    assert teng.kv_int8 == (kv == "int8") and not teng.fused
    call = dict(temperature=(0.0,), max_new_tokens=24,
                output_formats=("txt", "json", "srt"))
    want = jeng.transcribe_file(wav, output_dir=str(tmp_path / "jax"), **call)
    got = teng.transcribe_file(wav, output_dir=str(tmp_path / "torch"), **call)
    assert got["num_windows"] == want["num_windows"] >= 3
    assert got["language"] == want["language"]
    assert _segments(got) == _segments(want) and got["segments"]
    for fmt in ("txt", "srt"):
        with open(got["output_files"][fmt], "rb") as a, \
                open(want["output_files"][fmt], "rb") as b:
            assert a.read() == b.read()
    with open(got["output_files"]["json"], encoding="utf-8") as f:
        payload = json.load(f)
    assert len(payload["transcription"]) == len(got["segments"])


def test_fallback_ladder_output_well_formed(pair, tmp_path):
    """log_prob_threshold 0 fails every window, so every window climbs the
    ladder: best_of samples per rung, one batch per rung."""
    tok, _, dims_t, tree, wav = pair
    eng = TEngine(model_size="tiny-torch", device="cpu",
                  _params=TW.params_from_jax(tree), _dims=dims_t,
                  _tokenizer=tok, windows_per_device=2)
    res = eng.transcribe_file(wav, temperature=(0.0, 0.5, 1.0), best_of=2,
                              log_prob_threshold=0.0, max_new_tokens=12,
                              output_formats=("txt", "srt"),
                              output_dir=str(tmp_path))
    decodes = res["performance"]["decodes"]
    main = [d for d in decodes if d["temperature"] == 0.0]
    ladder = [d for d in decodes if d["temperature"] > 0.0]
    assert sum(d["rows"] for d in main) == res["num_windows"]
    assert ladder and {d["temperature"] for d in ladder} == {0.5, 1.0}
    assert all(d["rows"] % 2 == 0 for d in ladder)
    segs = res["segments"]
    assert segs
    assert segs == sorted(segs, key=lambda s: (s["start"], s["end"]))
    for s in segs:
        assert 0.0 <= s["start"] < s["end"] <= res["duration"] + 1e-6
        assert s["text"] and np.isfinite(s["avg_logprob"])
    with open(res["output_files"]["txt"], encoding="utf-8") as f:
        assert f.read().splitlines() == [s["text"].strip() for s in segs]
