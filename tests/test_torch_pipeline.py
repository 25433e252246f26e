"""The port's ``run_pipeline`` and the modules it reaches (alignment, the
meeting analysis, media passthrough, DER and WER) against the JAX package
on the CPU.

Tolerances: given the same transcript segments and speaker turns, the
HTML, JSON and SRT files byte for byte and the result dict equal; the
alignment exact; DER and WER within 1e-9; end to end on the CPU with a
tiny engine and the trained diarizer, the files the JAX renderers write
for the run's aligned segments."""

import json
import os

import numpy as np
import pytest
import torch

from torch_port_util import PieceTokenizer, random_jax_tree
from whisper_aries_tpu.analyze import meeting as JMeet
from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
from whisper_aries_tpu.eval import der as JDer
from whisper_aries_tpu.eval.wer import wer as j_wer, word_error_details as j_details
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.pipeline.run import run_pipeline as jax_run
from whisper_aries_tpu.utils import segments as JSeg
from whisper_aries_tpu_torch.analyze import meeting as TMeet
from whisper_aries_tpu_torch.audio.decode import write_wav
from whisper_aries_tpu_torch.diarize import DiarizationPipeline as TDiarizer
from whisper_aries_tpu_torch.errors import AudioError
from whisper_aries_tpu_torch.eval import der as TDer
from whisper_aries_tpu_torch.eval.wer import wer as t_wer, word_error_details as t_details
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.pipeline import run as TRun
from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber as TEngine
from whisper_aries_tpu_torch.pipeline.run import run_pipeline as torch_run
from whisper_aries_tpu_torch.utils import media as TMedia
from whisper_aries_tpu_torch.utils import segments as TSeg

SR = 16_000
#: an environment variable no machine sets: the meeting analysis finds no
#: key and never reaches the network
NO_KEY = "ARIES_TEST_NO_SUCH_KEY"


def _no_key_config(mod, **over):
    return mod.load_config(overrides={"analyze.api_key_env": NO_KEY, **over})


class FixedTranscriber:
    """Returns fixed segments; records the options it was called with."""

    def __init__(self, segments, language):
        self.segments, self.language, self.calls = segments, language, []

    def transcribe_file(self, path, **kw):
        self.calls.append(kw)
        return {"success": True, "segments": [dict(s) for s in self.segments],
                "language": self.language, "real_time_factor": 12.5}


class FixedDiarizer:
    def __init__(self, turns, fail=False):
        self.turns, self.fail = turns, fail

    def __call__(self, path, min_speakers=None, max_speakers=None):
        if self.fail:
            raise RuntimeError("diarizer down")
        return [dict(t) for t in self.turns]


def _random_transcript(seed, n_seg=40, n_turn=9, n_spk=3):
    rng = np.random.default_rng(seed)
    starts = np.cumsum(rng.uniform(0.2, 3.0, n_seg))
    segs = [{"start": round(float(s), 3),
             "end": round(float(s + rng.uniform(0.3, 4.0)), 3),
             "text": f" word{i} «é» \"quoted\" <b>&amp;",
             "avg_logprob": -0.3, "tokens": [1, 2]}
            for i, s in enumerate(starts)]
    edges = np.sort(rng.uniform(0, starts[-1] + 4, 2 * n_turn))
    turns = [{"start": float(edges[2 * i]), "end": float(edges[2 * i + 1]),
              "speaker": f"SPEAKER_{int(rng.integers(n_spk)):02d}"}
             for i in range(n_turn)]
    return segs, turns


@pytest.fixture
def wav(tmp_path):
    path = tmp_path / "meeting.wav"
    write_wav(str(path), np.zeros(SR, np.float32), SR)
    return str(path)


@pytest.mark.parametrize("language,threshold", [("en", 0.7), ("ar", 0.0),
                                                (None, 0.5)])
def test_outputs_match_jax_given_segments_and_turns(wav, tmp_path, language,
                                                    threshold):
    from whisper_aries_tpu import config as JC
    from whisper_aries_tpu_torch import config as TC

    segs, turns = _random_transcript(7)
    out = {}
    for name, run, cfg_mod in (("jax", jax_run, JC), ("torch", torch_run, TC)):
        tr = FixedTranscriber(segs, language)
        res = run(wav, output_dir=str(tmp_path / name),
                  formats=["html", "json", "srt"],
                  confidence_threshold=threshold, chunk_size=60,
                  config=_no_key_config(cfg_mod), transcriber=tr,
                  diarizer=FixedDiarizer(turns), resume_path="j.jsonl")
        out[name] = (res, tr.calls)
    (jres, jcalls), (tres, tcalls) = out["jax"], out["torch"]
    assert tcalls == jcalls
    assert tres["success"] and tres["error"] is None
    assert NO_KEY in tres["llm_analysis_error"]
    assert tres["llm_analysis_error"] == jres["llm_analysis_error"]
    for fmt in ("html", "json", "srt"):
        assert open(tres["outputs"][fmt], "rb").read() == \
            open(jres["outputs"][fmt], "rb").read(), fmt
    drop = lambda r: {k: v for k, v in r.items() if k != "outputs"}
    assert drop(tres) == drop(jres)
    assert {k: os.path.basename(v) for k, v in tres["outputs"].items()} == \
        {k: os.path.basename(v) for k, v in jres["outputs"].items()}


@pytest.mark.parametrize("strict", [False, True])
def test_diarization_failure(wav, tmp_path, strict):
    segs, _ = _random_transcript(2)
    res = torch_run(wav, output_dir=str(tmp_path), formats=["json"],
                    run_llm_analysis=False,
                    transcriber=FixedTranscriber(segs, "en"),
                    diarizer=FixedDiarizer([], fail=True),
                    strict_diarization=strict)
    if strict:
        assert not res["success"] and "diarizer down" in res["error"]
    else:
        assert res["success"] and res["diarization_error"] == "diarizer down"
        assert all(s["speaker"] is None for s in res["aligned_segments"])


# ---------------------------------------------------------------------------
# end to end on the CPU: tiny engines, the trained diarizers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def conversation(tmp_path_factory):
    from test_torch_diarize import synth_speaker

    a = synth_speaker(110, 500, [(0.5, 4.0), (8.0, 11.5)], 16.0, seed=1)
    b = synth_speaker(280, 2400, [(4.5, 7.5), (12.0, 15.5)], 16.0, seed=2)
    p = tmp_path_factory.mktemp("conversation") / "conversation.wav"
    write_wav(str(p), a + b, SR)
    return str(p)


def test_run_pipeline_end_to_end_on_the_cpu(conversation, tmp_path):
    """Conditioned decoding with an initial prompt and a resume journal,
    the trained diarizer, html/json/srt and the meeting analysis without a
    key, on the CPU with both injected: the run succeeds with the scene's
    two speakers, its JSON and SRT are what the JAX renderers write for
    its aligned segments, and a rerun from the full journal decodes
    nothing and aligns the same."""
    from whisper_aries_tpu.render.renderers import render_json, render_srt
    from whisper_aries_tpu_torch import config as TC

    tok = PieceTokenizer(build_special_tokens)
    dims = TW.WhisperDims(80, 1500, 64, 2, 2, tok.specials.n_vocab, 448,
                          64, 2, 2)
    over = {"decode.condition_on_previous_text": True,
            "decode.initial_prompt": "good morning", "decode.language": "en",
            "decode.temperature": (0.0,), "decode.max_new_tokens": 8}
    cfg = _no_key_config(TC, **over)
    teng = TEngine(model_size="tiny-torch", device="cpu",
                   _params=TW.params_from_jax(random_jax_tree(
                       JW.WhisperDims(*[getattr(dims, f) for f in
                                        dims.__dataclass_fields__]),
                       seed=11, weight_std=0.08)),
                   _dims=dims, config=cfg, windows_per_device=1,
                   _tokenizer=tok)
    tdiar = TDiarizer(device="cpu")
    journal = str(tmp_path / "torch.jsonl")
    kw = dict(formats=["html", "json", "srt"], strict_diarization=True,
              config=cfg, transcriber=teng, diarizer=tdiar,
              resume_path=journal)
    got = torch_run(conversation, output_dir=str(tmp_path / "torch"), **kw)
    assert got["success"] and NO_KEY in got["llm_analysis_error"]
    assert teng.last_stats["decodes"][0]["prompt_start"] > 0
    assert got["aligned_segments"], "nothing aligned"
    assert got["stats"]["num_speakers"] >= 2
    assert {s["speaker"] for s in got["aligned_segments"]} <= {
        "SPEAKER_00", "SPEAKER_01", None}
    md = got["metadata"]
    assert open(got["outputs"]["json"], encoding="utf-8").read() == \
        render_json(got["aligned_segments"], None, md)
    assert open(got["outputs"]["srt"], encoding="utf-8").read() == \
        render_srt(got["aligned_segments"], None)
    again = torch_run(conversation, output_dir=str(tmp_path / "again"), **kw)
    assert "decodes" not in teng.last_stats
    assert again["aligned_segments"] == got["aligned_segments"]


# ---------------------------------------------------------------------------
# alignment, analysis, media, metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,threshold", [(1, 0.0), (2, 0.5), (3, 0.7)])
def test_align_segments_is_exact(seed, threshold):
    segs, turns = _random_transcript(seed, n_seg=1200, n_turn=150, n_spk=4)
    assert TSeg.align_segments(segs, turns, threshold) == \
        JSeg.align_segments(segs, turns, threshold)
    assert TSeg.align_segments(segs, [], threshold) == \
        JSeg.align_segments(segs, [], threshold)
    for a, b in zip(segs[:-1], segs[1:]):
        assert TSeg.segment_overlap((a["start"], a["end"]),
                                    (b["start"], b["end"])) == \
            JSeg.segment_overlap((a["start"], a["end"]),
                                 (b["start"], b["end"]))


def test_align_segments_on_the_golden_meeting(golden_dir):
    """The reference's 342-segment meeting, re-aligned against its own
    turns at three thresholds, exactly as the JAX package aligns it."""
    candidates = [p for p in golden_dir.rglob("*.json")
                  if "meeting_summary" not in p.name]
    big = max(candidates, key=lambda p: len(json.loads(
        p.read_text(encoding="utf-8")).get("segments", [])))
    segments = json.loads(big.read_text(encoding="utf-8"))["segments"]
    assert len(segments) >= 300
    diar = [{"start": s["start"], "end": s["end"], "speaker": s["speaker"]}
            for s in segments if s.get("speaker")]
    for th in (0.0, 0.5, 0.7):
        assert TSeg.align_segments(segments, diar, th) == \
            JSeg.align_segments(segments, diar, th)


def test_meeting_analysis_matches_jax(tmp_path):
    segs, turns = _random_transcript(4)
    aligned = TSeg.align_segments(segs, turns, 0.5)
    for name in ("jax", "torch"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "m.json").write_text(
            json.dumps({"segments": aligned}), encoding="utf-8")
    fake = lambda prompt, cfg: f"summary of {len(prompt)} characters"
    want = JMeet.analyze_meeting(str(tmp_path / "jax" / "m.json"), llm=fake)
    got = TMeet.analyze_meeting(str(tmp_path / "torch" / "m.json"), llm=fake)
    for k in ("txt", "html"):
        assert open(got[k], "rb").read() == open(want[k], "rb").read()
    assert TMeet.speaker_stats(aligned) == JMeet.speaker_stats(aligned)
    assert TMeet.build_transcript_text(aligned) == \
        JMeet.build_transcript_text(aligned)
    from whisper_aries_tpu_torch.config import AnalyzeConfig

    with pytest.raises(RuntimeError, match=NO_KEY):
        TMeet.call_llm("x", AnalyzeConfig(api_key_env=NO_KEY))


def test_media_passthrough_and_error(tmp_path, monkeypatch):
    for ext in (".wav", ".mp3", ".flac", ".ogg", ".m4a", ".WAV"):
        assert TMedia.extract_audio_if_needed(f"a{ext}") == f"a{ext}"
    monkeypatch.setattr(TMedia.shutil, "which", lambda name: None)
    with pytest.raises(AudioError, match="ffmpeg is required"):
        TMedia.extract_audio_if_needed(str(tmp_path / "talk.mp4"))


@pytest.mark.parametrize("collar", [0.0, 0.25])
def test_der_matches_jax(collar):
    _, ref = _random_transcript(5, n_turn=30, n_spk=3)
    _, hyp = _random_transcript(6, n_turn=34, n_spk=4)
    got = TDer.diarization_error_rate(ref, hyp, collar_s=collar)
    want = JDer.diarization_error_rate(ref, hyp, collar_s=collar)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k
    many = [dict(t, speaker=f"S{i % 9}") for i, t in enumerate(hyp)]
    assert abs(TDer.diarization_error_rate(ref, many)["der"]
               - JDer.diarization_error_rate(ref, many)["der"]) <= 1e-9


@pytest.mark.parametrize("ref,hyp,lang", [
    ("The cat sat on the mat.", "the cat sat on a mat", "en"),
    ("Hello, world! How are you?", "hello world how you are", "en"),
    ("مرحبا بكم في الاجتماع", "مرحبا بك في اجتماع", "ar"),
    ("", "anything", "en"),
])
def test_wer_matches_jax(ref, hyp, lang):
    assert abs(t_wer(ref, hyp, lang) - j_wer(ref, hyp, lang)) <= 1e-9
    assert t_details(ref, hyp, lang) == j_details(ref, hyp, lang)


def test_get_transcriber_caches_one_engine_per_device():
    a = TRun.get_transcriber("tiny", device="cpu", allow_random=True)
    b = TRun.get_transcriber("tiny", device="cpu", allow_random=True)
    assert a is b and a.device == torch.device("cpu")
    TRun._ENGINE_CACHE.clear()
