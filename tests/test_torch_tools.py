"""The port's repo tools (whisper_aries_tpu_torch/scripts/) against the JAX
repo's scripts run with the same inputs, on the CPU:

  * calibrate_emb_threshold at one seed and 3 speakers x 2 utterances (the
    JAX script's seeds and sizes replaced in its source): the same
    threshold and pair accuracy, the cosines within 1e-4 (the JAX mel is
    held against the port's at 1e-5 elsewhere);
  * sweep_cluster_threshold at 1 scene and one threshold: the same
    speaker counts, each DER within 0.01 (the diarizer tests' limit);
  * make_sample_audio: the JAX script's WAV bytes, which are the
    checked-in examples/sample_audio.wav;
  * setup_environment with install, the builds and verify recorded: the
    JAX script's install arguments and exit code, verify only after a
    successful install;
  * parity_vs_goldens: find_golden_jobs, check_structure and
    match_timestamps on a golden directory the test writes; run_job in
    mock mode given the same transcript and speaker turns (the same
    report); one mock run_job of the port's on a tiny random engine and
    the CPU diarizer; the exit code 1 with no golden job;
  * every tool raises without a card and without --device cpu."""

import argparse
import contextlib
import importlib.util
import io
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from torch_port_util import PieceTokenizer, random_jax_tree

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
WEIGHTS = REPO / "whisper_aries_tpu" / "weights"


def _jax_script(name: str, replace=(), file=None):
    """The JAX repo's scripts/<name>.py as a module, its source with
    ``replace``'s (old, new) pairs applied (each must occur once) and its
    ``__file__`` set to ``file`` when given."""
    path = SCRIPTS / f"{name}.py"
    src = path.read_text(encoding="utf-8")
    for old, new in replace:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    mod = type(sys)(f"jax_script_{name}")
    mod.__file__ = str(file or path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def _stdout(fn, *a):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*a)
    return rc, out.getvalue()


def _numbers(text: str):
    import re

    return [float(x) for x in re.findall(r"=\s*(-?\d+\.\d+)", text)]


# ---------------------------------------------------------------------------
# calibrate_emb_threshold
# ---------------------------------------------------------------------------


def test_calibrate_matches_the_jax_script(monkeypatch):
    from whisper_aries_tpu_torch.scripts import calibrate_emb_threshold as C

    jmod = _jax_script("calibrate_emb_threshold", replace=[
        ("n_spk, n_utt = 10, 6", "n_spk, n_utt = 3, 2"),
        ("for seed in (30_000, 31_000, 32_000, 33_000):",
         "for seed in (30_000,):")])
    monkeypatch.setattr(sys, "argv", ["calibrate_emb_threshold.py",
                                      str(WEIGHTS)])
    rc_j, want = _stdout(jmod.main)
    monkeypatch.setattr(C, "SEEDS", (30_000,))
    monkeypatch.setattr(C, "N_SPK", 3)
    monkeypatch.setattr(C, "N_UTT", 2)
    rc_t, got = _stdout(C.main, [str(WEIGHTS), "--device", "cpu"])
    assert rc_t == rc_j == 0
    # weights=, then same_cos / diff_cos / margin, threshold / accuracy,
    # midpoint
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w) == 4 and g[0] == w[0]
    assert g[2] == w[2]  # the threshold and the pair accuracy
    np.testing.assert_allclose(_numbers(got), _numbers(want), atol=1e-4,
                               rtol=0)
    r = C.calibrate(C.load_embedding(WEIGHTS, "cpu"), (30_000,), 3, 2)
    assert r["sim"].shape == r["same"].shape == (15,)
    assert r["same"].sum() == 3
    assert f"{r['threshold']:.2f}" in g[2]


# ---------------------------------------------------------------------------
# sweep_cluster_threshold
# ---------------------------------------------------------------------------


def test_sweep_matches_the_jax_script(monkeypatch):
    """One threshold over one development scene, cut to 10 s and the clean
    and augmented conditions in both (the JAX script's run_battery call
    given the same two arguments)."""
    import functools

    from whisper_aries_tpu_torch.scripts import sweep_cluster_threshold as S

    short = dict(dur_s=10.0, conditions=["clean", "augmented"])
    jmod = _jax_script("sweep_cluster_threshold", replace=[(
        "run_battery(pipeline, n_scenes=n_scenes, seed=5000)",
        f"run_battery(pipeline, n_scenes=n_scenes, seed=5000, **{short!r})")])
    monkeypatch.setattr(sys, "argv", ["sweep_cluster_threshold.py",
                                      str(WEIGHTS), "0.53", "1"])
    rc_j, want = _stdout(jmod.main)
    monkeypatch.setattr(S, "run_battery",
                        functools.partial(S.run_battery, **short))
    rc_t, got = _stdout(S.main, [str(WEIGHTS), "0.53", "1", "--device",
                                 "cpu"])
    assert rc_t == rc_j == 0
    w = json.loads(want.splitlines()[-1])["0.53"]
    g = json.loads(got.splitlines()[-1])["0.53"]
    assert g["ref"] == w["ref"] and g["hyp_clean"] == w["hyp_clean"]
    assert abs(g["clean"] - w["clean"]) <= 0.01
    assert abs(g["aug"] - w["aug"]) <= 0.01
    assert got.splitlines()[0].startswith("t=0.53: clean=")


# ---------------------------------------------------------------------------
# make_sample_audio
# ---------------------------------------------------------------------------


def test_make_sample_audio_writes_the_jax_scripts_bytes(tmp_path):
    from whisper_aries_tpu_torch.scripts import make_sample_audio as M

    (tmp_path / "jax").mkdir()
    jmod = _jax_script("make_sample_audio",
                       file=tmp_path / "jax" / "scripts" / "x.py")
    _stdout(jmod.main)
    want = (tmp_path / "jax" / "examples" / "sample_audio.wav").read_bytes()
    out = tmp_path / "port" / "sample.wav"
    rc, text = _stdout(M.main, [str(out), "--device", "cpu"])
    assert rc == 0 and f"({len(want)} bytes)" in text
    assert out.read_bytes() == want
    assert want == (REPO / "examples" / "sample_audio.wav").read_bytes()
    assert M.DEFAULT_OUT == REPO / "examples" / "sample_audio.wav"


# ---------------------------------------------------------------------------
# setup_environment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("install_rc", [0, 1])
def test_setup_environment_runs_the_jax_scripts_steps(monkeypatch,
                                                       install_rc):
    import subprocess

    from whisper_aries_tpu.cli import install_packages as JI
    from whisper_aries_tpu.cli import verify_setup as JV
    from whisper_aries_tpu_torch.scripts import setup_environment as SE

    def recorder(log, name, rc=0):
        def call(*a, **k):
            log.append((name, list(a[0]) if a and a[0] is not None else a))
            return rc
        return call

    jlog, tlog = [], []
    monkeypatch.setattr(JI, "main", recorder(jlog, "install", install_rc))
    monkeypatch.setattr(JV, "main", recorder(jlog, "verify", 0))
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd, **k: jlog.append(("build", cmd[:2])) or 0)
    monkeypatch.setattr(sys, "argv", ["setup_environment.py",
                                      "--check-only"])
    with pytest.raises(SystemExit) as exit_j:
        runpy.run_path(str(SCRIPTS / "setup_environment.py"),
                       run_name="__main__")
    monkeypatch.setattr(SE.install_packages, "main",
                        recorder(tlog, "install", install_rc))
    monkeypatch.setattr(SE.verify_setup, "main", recorder(tlog, "verify", 0))
    monkeypatch.setattr(SE._native, "library",
                        lambda: tlog.append(("build", ["native"])))
    monkeypatch.setattr(SE.cuda_build, "build",
                        lambda: tlog.append(("build", ["kernels"])))
    rc = SE.main(["--check-only", "--device", "cpu"])
    assert rc == exit_j.value.code == install_rc
    assert [n for n, _ in tlog] == [n for n, _ in jlog]
    assert tlog[0] == jlog[0] == ("install", ["--check-only"])
    if install_rc == 0:
        assert jlog[1] == ("build", ["make", "-C"])
        # the CPU builds the host library only; verify on the CPU
        assert tlog[1:] == [("build", ["native"]),
                            ("verify", ["--device", "cpu"])]
        assert jlog[2] == ("verify", [])
    else:
        assert len(tlog) == 1


# ---------------------------------------------------------------------------
# parity_vs_goldens
# ---------------------------------------------------------------------------

GOLDEN = {
    "segments": [
        {"text": "hello there", "start": 0.0, "end": 2.5,
         "speaker": "SPEAKER_00", "confidence": 0.9},
        {"text": "general kenobi", "start": 3.0, "end": 5.0,
         "speaker": "SPEAKER_01", "confidence": 0.8},
    ],
    "metadata": {"audio_file": "x.wav", "pipeline_version": "1.0",
                 "confidence_threshold": 0.6, "language": "en",
                 "total_segments": 2},
}


@pytest.fixture()
def goldens(tmp_path):
    """A golden directory: two jobs, a directory without a JSON, a file."""
    root = tmp_path / "goldens"
    for job, stem in (("job_b", "talk"), ("job_a", "meeting")):
        d = root / job
        d.mkdir(parents=True)
        (d / f"{stem}.json").write_text(json.dumps(GOLDEN))
        (d / f"{stem}.srt").write_text("1\n00:00:00,000 --> 00:00:02,500\n"
                                       "hello there\n")
        (d / f"{stem}.html").write_text("<html></html>")
    (root / "empty").mkdir()
    (root / "README").write_text("not a job")
    return root


def _harnesses():
    from whisper_aries_tpu_torch.scripts import parity_vs_goldens as T

    return _jax_script("parity_vs_goldens"), T


def test_parity_helpers_match_the_jax_script(goldens, tmp_path):
    J, T = _harnesses()
    jj, tj = J.find_golden_jobs(goldens), T.find_golden_jobs(goldens)
    assert [j["job_id"] for j in tj] == ["job_a", "job_b"]
    assert [{k: str(v) for k, v in j.items()} for j in tj] == [
        {k: str(v) for k, v in j.items()} for j in jj]
    np.testing.assert_array_equal(T.synth_audio_for(GOLDEN, 4.0),
                                  J.synth_audio_for(GOLDEN, 4.0))
    srt = tmp_path / "o.srt"
    srt.write_text("1\n...\n2\n...\n")
    files = {"json": str(srt), "srt": str(srt), "html": str(srt)}
    bad_seg = dict(GOLDEN, segments=[{"text": "x", "start": 0, "end": 1}])
    cases = [
        (GOLDEN, files),
        (GOLDEN, {"json": str(srt)}),
        (bad_seg, files),
        ({"segments": [], "metadata": {}, "extra": 1}, files),
        (dict(GOLDEN, segments=GOLDEN["segments"] * 2), files),
    ]
    for ours, out_files in cases:
        assert (T.check_structure(GOLDEN, ours, out_files)
                == J.check_structure(GOLDEN, ours, out_files))
    assert T.check_structure(GOLDEN, GOLDEN, files) == []
    ours = [{"start": 0.2, "end": 2.4}, {"start": 2.9, "end": 5.3},
            {"start": 7.0, "end": 8.0}]
    for g, o in ((GOLDEN["segments"], ours), ([], ours),
                 (GOLDEN["segments"], []),
                 (GOLDEN["segments"], [{"start": 9.0, "end": 9.5}])):
        assert T.match_timestamps(g, o) == J.match_timestamps(g, o)
    assert T.match_timestamps(GOLDEN["segments"], ours)["matched"] == 2


def test_parity_exits_non_zero_without_golden_jobs(tmp_path):
    _, T = _harnesses()
    for argv in ([], ["--goldens", str(tmp_path / "absent")],
                 ["--goldens", str(tmp_path)]):
        rc, out = _stdout(T.main, argv + ["--device", "cpu"])
        assert rc == 1 and "error" in json.loads(out.splitlines()[-1])


class FixedTranscriber:
    """Returns fixed segments (a transcript of the golden's span)."""

    def transcribe_file(self, path, **kw):
        return {"success": True, "language": "en", "real_time_factor": 3.0,
                "segments": [
                    {"start": 0.1, "end": 2.6, "text": " hello  there",
                     "avg_logprob": -0.2, "tokens": [1]},
                    {"start": 2.9, "end": 4.7, "text": " general kenobi",
                     "avg_logprob": -0.4, "tokens": [2]},
                    {"start": 5.0, "end": 5.8, "text": " extra",
                     "avg_logprob": -0.9, "tokens": [3]}]}


class FixedDiarizer:
    def __init__(self, *a, **k):
        pass

    def __call__(self, path, min_speakers=None, max_speakers=None):
        return [{"start": 0.0, "end": 2.8, "speaker": "SPEAKER_00"},
                {"start": 2.8, "end": 6.0, "speaker": "SPEAKER_01"}]


def test_parity_run_job_report_matches_the_jax_script(goldens, tmp_path,
                                                      monkeypatch):
    """The same transcript and speaker turns through each harness's
    run_job in mock mode: the same report (structure, WER, timestamp
    deltas)."""
    import tempfile

    import whisper_aries_tpu.diarize as JDiar
    import whisper_aries_tpu_torch.diarize as TDiar
    from whisper_aries_tpu.config import load_config as j_config
    from whisper_aries_tpu_torch.config import load_config as t_config

    J, T = _harnesses()
    # the JAX script leaves its mock WAV in the temporary directory
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(JDiar, "DiarizationPipeline", FixedDiarizer)
    monkeypatch.setattr(TDiar, "DiarizationPipeline", FixedDiarizer)
    args = dict(audio_dir=None, mock_cap_seconds=12.0)
    want = J.run_job(J.find_golden_jobs(goldens)[0], argparse.Namespace(
        out=str(tmp_path / "jax"), **args), FixedTranscriber(), j_config())
    got = T.run_job(T.find_golden_jobs(goldens)[0], argparse.Namespace(
        out=str(tmp_path / "port"), device="cpu", **args),
        FixedTranscriber(), t_config())
    assert got == want
    assert got["pipeline_success"] and got["structure_problems"] == []
    assert got["mock_audio"] is True and 0 < got["wer"] < 1
    assert got["timestamps"]["matched"] == 2
    assert list(tmp_path.glob("*.wav")) == [
        p for p in tmp_path.glob("*.wav") if p.name.startswith("meeting_")]


def test_parity_mock_run_job_on_a_tiny_engine(goldens, tmp_path,
                                              monkeypatch):
    """One mock job end to end through the port's run_pipeline on a tiny
    random engine and the CPU diarizer: every output, no structure
    problem, a WER; the mock WAV removed."""
    import functools
    import tempfile

    from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
    from whisper_aries_tpu_torch.config import load_config
    from whisper_aries_tpu_torch.models import whisper as TW
    from whisper_aries_tpu_torch.pipeline.engine import (
        AriesTranscriber as TEngine,
    )

    _, T = _harnesses()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    tok = PieceTokenizer(build_special_tokens)
    dims = TW.WhisperDims(80, 1500, 64, 2, 2, tok.specials.n_vocab, 448,
                          64, 2, 2)
    cfg = load_config(overrides={"decode.temperature": [0.0]})
    teng = TEngine(model_size="tiny-torch", device="cpu",
                   _params=TW.params_from_jax(random_jax_tree(
                       dims, seed=11, weight_std=0.08)), _dims=dims,
                   windows_per_device=1, _tokenizer=tok, config=cfg)
    # run_pipeline leaves max_new_tokens at the engine's 224: 8 here
    monkeypatch.setattr(teng, "transcribe_file", functools.partial(
        teng.transcribe_file, max_new_tokens=8))
    rep = T.run_job(T.find_golden_jobs(goldens)[0], argparse.Namespace(
        out=str(tmp_path / "port"), device="cpu", audio_dir=None,
        mock_cap_seconds=12.0), teng, cfg)
    assert rep["pipeline_success"] and rep["structure_problems"] == []
    assert rep["mock_audio"] is True and isinstance(rep["wer"], float)
    # random weights transcribe the tone as nothing: no pair to match
    assert rep["timestamps"]["matched"] == 0 and rep["wer"] == 1.0
    outs = sorted(p.suffix for p in (tmp_path / "port" / "job_a").iterdir())
    assert outs == [".html", ".json", ".srt"]
    assert not list(tmp_path.glob("*.wav"))


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,argv", [
    ("calibrate_emb_threshold", []),
    ("sweep_cluster_threshold", [str(WEIGHTS), "0.53", "1"]),
    ("make_sample_audio", ["out.wav"]),
    ("setup_environment", ["--check-only"]),
    ("parity_vs_goldens", ["--goldens", "GOLDENS"]),
])
def test_tools_raise_without_a_card(name, argv, goldens, tmp_path,
                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = importlib.util.find_spec(f"whisper_aries_tpu_torch.scripts.{name}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = [str(goldens) if a == "GOLDENS" else
            str(tmp_path / a) if a == "out.wav" else a for a in argv]
    with pytest.raises(RuntimeError, match="CUDA card"):
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main(argv)
    assert not (tmp_path / "out.wav").exists()
