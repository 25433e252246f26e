"""The port's command-line tools (whisper_aries_tpu_torch/cli/) against the
JAX package's (whisper_aries_tpu/cli/), on the CPU:

  * ``transcribe`` and ``batch_transcribe`` on a tiny HF checkpoint
    directory (written by the port's own writer) and short WAVs: the
    JAX ``main()`` and the port's ``main(..., "--device", "cpu")`` write
    TXT, JSON and SRT with equal segments (the JSON's times within
    1e-6 s); the manifest and a rerun without ``--overwrite`` as in JAX;
  * the diarizer's ``write_outputs`` gives the JAX bytes for the same
    turns;
  * ``meeting`` (no API key), ``demo``, ``verify_setup --device cpu`` and
    ``install_packages --check-only`` / ``--dry-run`` exit as their JAX
    counterparts do, and never run pip;
  * the clients against the port's server on a live port (a faked
    pipeline stage), following tests/test_client_integration.py.

Temperature is pinned to 0: the sampled rungs of the fallback ladder draw
from different generators in the two frameworks. The JAX engine runs on
a one-device mesh, so both batch the same windows. A decode samples at
most 16 tokens (the random model never ends a window)."""

import argparse
import asyncio
import json
import threading
from pathlib import Path

import numpy as np
import pytest

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from torch_port_util import random_jax_tree, speechy_audio
from whisper_aries_tpu.cli import batch_transcribe as jbt
from whisper_aries_tpu.cli import demo as jdemo
from whisper_aries_tpu.cli import diarize as jdz
from whisper_aries_tpu.cli import install_packages as jip
from whisper_aries_tpu.cli import meeting as jmeet
from whisper_aries_tpu.cli import transcribe as jtr
from whisper_aries_tpu.cli import verify_setup as jvs
from whisper_aries_tpu_torch.audio.decode import write_wav
from whisper_aries_tpu_torch.cli import batch_transcribe as tbt
from whisper_aries_tpu_torch.cli import clients as tcl
from whisper_aries_tpu_torch.cli import demo as tdemo
from whisper_aries_tpu_torch.cli import diarize as tdz
from whisper_aries_tpu_torch.cli import install_packages as tip
from whisper_aries_tpu_torch.cli import meeting as tmeet
from whisper_aries_tpu_torch.cli import transcribe as ttr
from whisper_aries_tpu_torch.cli import verify_setup as tvs

SR = 16_000
MAX_TOKENS = 16


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny HF checkpoint directory at the large-v3 vocabulary and 128
    mels, written by the port's writer in HF key names: config.json,
    model.safetensors (torch_port_util's seeded random tree),
    generation_config.json
    with alignment heads, and a byte-level v3 vocabulary (the 256 byte
    symbols, space-led fillers to 50,257 entries, <|endoftext|>; no
    merges)."""
    from whisper_aries_tpu_torch.decoding.tokenizer import _bytes_to_unicode
    from whisper_aries_tpu_torch.models import whisper as TW
    from whisper_aries_tpu_torch.utils.params_io import write_safetensors

    d = tmp_path_factory.mktemp("torch_cli_ckpt") / "whisper-tiny-v3"
    d.mkdir()
    from whisper_aries_tpu.models import whisper as JW

    dims_j = JW.WhisperDims(128, 1500, 32, 2, 2, 51866, 448, 32, 2, 2)
    dims = TW.WhisperDims(*[getattr(dims_j, f)
                            for f in dims_j.__dataclass_fields__])
    tree = TW.params_from_jax(random_jax_tree(dims_j, seed=11,
                                              weight_std=0.08))
    write_safetensors(d / "model.safetensors", TW.hf_state_dict(tree, dims))
    (d / "config.json").write_text(json.dumps({
        "architectures": ["WhisperForConditionalGeneration"],
        "model_type": "whisper", "vocab_size": 51866, "num_mel_bins": 128,
        "d_model": 32, "encoder_layers": 2, "encoder_attention_heads": 2,
        "encoder_ffn_dim": 128, "decoder_layers": 2,
        "decoder_attention_heads": 2, "decoder_ffn_dim": 128,
        "max_source_positions": 1500, "max_target_positions": 448,
        "activation_function": "gelu", "scale_embedding": False}))
    (d / "generation_config.json").write_text(
        json.dumps({"alignment_heads": [[1, 0], [1, 1]]}))
    b2u = _bytes_to_unicode()
    vocab = [b2u[i] for i in range(256)]
    vocab += [f"\u0120w{i}" for i in range(50257 - len(vocab))]
    vocab.append("<|endoftext|>")
    (d / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(vocab)}, ensure_ascii=False),
        encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n", encoding="utf-8")
    return d


@pytest.fixture
def one_device(monkeypatch):
    """The JAX engine's default mesh cut to one device, both engines'
    default config at temperature 0, and every transcribe_file at
    MAX_TOKENS tokens a window."""
    import functools

    from whisper_aries_tpu.config import load_config as jcfg
    from whisper_aries_tpu.parallel.mesh import make_mesh
    from whisper_aries_tpu.pipeline import engine as JE
    from whisper_aries_tpu_torch.config import load_config as tcfg
    from whisper_aries_tpu_torch.pipeline import engine as TE

    monkeypatch.setattr(JE, "make_mesh", lambda *a, **k: make_mesh(1))
    t0 = {"decode.temperature": [0.0]}
    monkeypatch.setattr(JE, "load_config", lambda: jcfg(overrides=t0))
    monkeypatch.setattr(TE, "load_config", lambda: tcfg(overrides=t0))
    for mod in (JE, TE):
        cls = mod.AriesTranscriber
        monkeypatch.setattr(cls, "transcribe_file", functools.partialmethod(
            cls.transcribe_file, max_new_tokens=MAX_TOKENS))


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_audio")
    write_wav(str(d / "a.wav"), speechy_audio(20.0, seed=5), SR)
    write_wav(str(d / "b.wav"), speechy_audio(12.0, seed=6), SR)
    return d


#: the JSON's float fields: times within 1e-6 s; scores within 1e-5 (the
#: frameworks sum the f32 log-probabilities in other orders)
FLOATS = {"start": 1e-6, "end": 1e-6, "avg_logprob": 1e-5,
          "no_speech_prob": 1e-5}


def _json_segments(path):
    rows = json.loads(Path(path).read_text())["transcription"]
    return ([{k: v for k, v in r.items() if k not in FLOATS} for r in rows],
            {k: np.asarray([r[k] for r in rows]) for k in FLOATS})


def _same_outputs(got_dir, want_dir, stem, formats) -> int:
    """The files of ``stem`` in both directories agree; returns the JSON's
    segment count."""
    n = 0
    for fmt in formats:
        got = Path(got_dir) / f"{stem}.{fmt}"
        want = Path(want_dir) / f"{stem}.{fmt}"
        if fmt == "json":
            (g, gf), (w, wf) = _json_segments(got), _json_segments(want)
            assert g == w
            for k, tol in FLOATS.items():
                np.testing.assert_allclose(gf[k], wf[k], atol=tol, rtol=0)
            n = len(g)
        else:
            assert got.read_bytes() == want.read_bytes()
    return n


def test_transcribe_cli_matches_jax(checkpoint, wav_dir, tmp_path,
                                    one_device):
    wav = str(wav_dir / "a.wav")
    args = [wav, "--model", str(checkpoint), "--formats", "txt,json,srt",
            "--temperature", "0.0", "--workers", "2", "--beam-size", "2",
            "--max-new-tokens", str(MAX_TOKENS)]
    assert jtr.main(args + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert ttr.main(args + ["--output-dir", str(tmp_path / "torch"),
                            "--device", "cpu"]) == 0
    assert _same_outputs(tmp_path / "torch", tmp_path / "jax", "a",
                         ("txt", "json", "srt")) > 0


def test_batch_transcribe_cli_matches_jax(checkpoint, wav_dir, tmp_path,
                                          one_device, capsys):
    """Both files through one engine: the same outputs and manifest
    entries; a rerun without --overwrite skips both (no engine is built
    and nothing transcribed); --overwrite transcribes both again."""
    from whisper_aries_tpu_torch.pipeline import engine as TE

    common = [str(wav_dir), "--model", str(checkpoint), "--workers", "2",
              "--formats", "json,txt"]
    runs = {}
    for name, mod, extra in (("jax", jbt, []),
                             ("torch", tbt, ["--device", "cpu"])):
        out = tmp_path / name
        man = tmp_path / f"{name}.json"
        assert mod.main(common + ["--output-dir", str(out), "--manifest",
                                  str(man)] + extra) == 0
        runs[name] = json.loads(man.read_text())
    assert sum(_same_outputs(tmp_path / "torch", tmp_path / "jax", stem,
                             ("json", "txt")) for stem in ("a", "b")) > 0
    keys = ("language", "duration", "segments")
    assert [{k: r[k] for k in keys} for r in runs["torch"]["results"]] == [
        {k: r[k] for k in keys} for r in runs["jax"]["results"]]

    calls, built = [], []
    real, init = TE.AriesTranscriber.transcribe_file, \
        TE.AriesTranscriber.__init__
    TE.AriesTranscriber.transcribe_file = lambda self, *a, **k: (
        calls.append(a), real(self, *a, **k))[1]
    TE.AriesTranscriber.__init__ = lambda self, *a, **k: (
        built.append(k), init(self, *a, **k))[1]
    try:
        capsys.readouterr()
        assert tbt.main(common + ["--output-dir", str(tmp_path / "torch"),
                                  "--device", "cpu"]) == 0
        assert calls == [] and built == []
        assert capsys.readouterr().out.count("skip (exists)") == 2
        assert tbt.main(common + ["--output-dir", str(tmp_path / "torch"),
                                  "--device", "cpu", "--overwrite"]) == 0
        assert len(calls) == 2 and len(built) == 1
    finally:
        TE.AriesTranscriber.transcribe_file = real
        TE.AriesTranscriber.__init__ = init


def test_batch_transcribe_cli_requires_directory(tmp_path):
    assert tbt.main([str(tmp_path / "missing"), "--device", "cpu"]) == \
        jbt.main([str(tmp_path / "missing")]) == 1


def test_diarizer_write_outputs_are_the_jax_bytes(tmp_path):
    turns = [{"start": 0.5, "end": 3.014, "speaker": "SPEAKER_00"},
             {"start": 3.2049, "end": 7.0, "speaker": "SPEAKER_01"},
             {"start": 7.25, "end": 9.126, "speaker": "SPEAKER_00"}]
    unfiltered = turns + [{"start": 9.2, "end": 9.3, "speaker": "SPEAKER_01"}]
    fmts = ["csv", "json", "txt", "unfiltered", "log"]
    outs = {}
    for name, mod in (("jax", jdz), ("torch", tdz)):
        d = tmp_path / name
        d.mkdir()
        outs[name] = mod.write_outputs(turns, d / "talk", fmts,
                                       unfiltered=unfiltered,
                                       audio_file="talk.wav")
    assert set(outs["torch"]) == set(outs["jax"]) == set(fmts)
    for k in fmts:
        assert Path(outs["torch"][k]).read_bytes() == \
            Path(outs["jax"][k]).read_bytes(), k


def test_diarize_cli_takes_the_device(tmp_path, monkeypatch):
    """main() builds the diarizer on --device and writes its turns."""
    from whisper_aries_tpu_torch import diarize as TD

    built = {}

    class FakeDiarizer:
        def __init__(self, model_dir=None, clustering_threshold=None,
                     device=None):
            built.update(device=device, threshold=clustering_threshold)

        def __call__(self, audio, **kw):
            t = [{"start": 0.0, "end": 1.0, "speaker": "SPEAKER_00"}]
            return t, t

    monkeypatch.setattr(TD, "DiarizationPipeline", FakeDiarizer)
    assert tdz.main(["x.wav", "--device", "cpu", "--threshold", "0.6",
                     "--output-dir", str(tmp_path), "--formats",
                     "csv,json"]) == 0
    assert built == {"device": "cpu", "threshold": 0.6}
    assert (tmp_path / "x_diarization.csv").read_text().startswith(
        "start,end,speaker")


def test_conversation_cli_runs_the_port_pipeline(tmp_path, monkeypatch,
                                                 capsys):
    """main() hands its flags and --device to the port's run_pipeline."""
    from whisper_aries_tpu_torch.cli import conversation as tconv
    from whisper_aries_tpu_torch.pipeline import run as TR

    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return {"success": True, "outputs": {"json": "x.json"},
                "stats": {"num_segments": 1, "num_speakers": 2,
                          "total_duration": 3.0}}

    monkeypatch.setattr(TR, "run_pipeline", fake_run)
    assert tconv.main(["talk.wav", "--device", "cpu", "--no-llm",
                       "--formats", "json,srt", "--chunk-size", "60"]) == 0
    assert seen["device"] == "cpu" and seen["run_llm_analysis"] is False
    assert seen["formats"] == ["json", "srt"] and seen["chunk_size"] == 60
    assert "1 segments, 2 speakers" in capsys.readouterr().out


def test_meeting_without_a_key_fails_as_in_jax(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    path = tmp_path / "talk.json"
    path.write_text(json.dumps({"segments": [
        {"text": "hello", "start": 0.0, "end": 1.0,
         "speaker": "SPEAKER_00", "confidence": 1.0}]}))
    errs = []
    for mod in (jmeet, tmeet):
        assert mod.main([str(path)]) == 1
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1]
    assert "analysis failed" in errs[1] and "OPENAI_API_KEY" in errs[1]


def test_demo_exits_as_in_jax(checkpoint, tmp_path, capsys, one_device):
    missing = str(tmp_path / "none.wav")
    assert jdemo.main([missing]) == tdemo.main([missing, "--device",
                                                "cpu"]) == 1
    out = capsys.readouterr().out
    assert out.count("sample audio missing") == 2
    assert tdemo.SAMPLE == jdemo.SAMPLE and tdemo.SAMPLE.exists()
    assert tdemo.main(["--model", str(checkpoint), "--device", "cpu",
                       "--output-dir", str(tmp_path / "demo")]) == 0
    assert (tmp_path / "demo" / "sample_audio.srt").exists()


def test_verify_setup_exits_as_in_jax(capsys, monkeypatch):
    """On the CPU with --device cpu the port reports OK (rc 0), as the JAX
    tool does here; its smoke test builds the engine on the CPU; without
    a card and without --device cpu it reports the card missing and
    exits 1."""
    import torch

    assert jvs.main([]) == 0
    assert tvs.main(["--device", "cpu", "--smoke-test"]) == 0
    out = capsys.readouterr().out
    assert "[ok] engine smoke test: tiny random weights on cpu" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tvs.main([]) == 1
    assert "[FAIL] card: RuntimeError: no CUDA card" in \
        capsys.readouterr().out


def test_install_packages_never_runs_pip_when_asked_not_to(monkeypatch,
                                                           capsys):
    import subprocess

    assert jip.main(["--check-only"]) == tip.main(["--check-only"]) == 0

    def no_pip(*a, **k):
        raise AssertionError("pip was run")

    monkeypatch.setattr(subprocess, "call", no_pip)
    real = tip.probe
    monkeypatch.setattr(tip, "probe", lambda name: None
                        if name == "regex" else real(name))
    capsys.readouterr()
    assert tip.main(["--check-only"]) == 1
    assert "1 required package(s) missing" in capsys.readouterr().out
    assert tip.main(["--dry-run"]) == 0
    assert "Would run: " in capsys.readouterr().out


@pytest.fixture
def live_server(tmp_path):
    """The port's app in a background event-loop thread; yields its URL."""
    from aiohttp import web

    from tests.test_torch_server import _config, fake_pipeline
    from whisper_aries_tpu_torch.serve.server import create_app

    app = create_app(_config(tmp_path), pipeline_fn=fake_pipeline)
    loop = asyncio.new_event_loop()
    started = threading.Event()
    state = {}

    def run():
        asyncio.set_event_loop(loop)

        async def start():
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            state["port"] = runner.addresses[0][1]
            state["runner"] = runner
            started.set()

        loop.run_until_complete(start())
        loop.run_forever()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert started.wait(10)
    yield f"http://127.0.0.1:{state['port']}"
    loop.call_soon_threadsafe(loop.stop)
    t.join(timeout=5)


def test_clients_against_the_port_server(live_server, tmp_path, capsys,
                                         monkeypatch):
    pytest.importorskip("requests")
    monkeypatch.chdir(tmp_path)  # main() downloads into the working dir
    # every status poll 0.2 s apart (quick_test and main poll every 3-5 s)
    wait = tcl.wait_for_job_completion
    monkeypatch.setattr(tcl, "wait_for_job_completion",
                        lambda *a, **k: wait(*a, **dict(k, poll_s=0.2)))
    assert tcl.check_health(live_server)["status"] == "ready"
    wav = tmp_path / "speech.wav"
    wav.write_bytes(b"RIFFfake-but-extension-is-what-matters")
    up = tcl.upload_file_for_analysis(str(wav), live_server, language="en",
                                      formats="json,html",
                                      run_llm_analysis=False)
    assert up["status"] == "queued"
    job = tcl.wait_for_job_completion(up["job_id"], live_server,
                                      timeout_s=15, poll_s=0.2,
                                      progress=None)
    assert job["status"] == "completed"
    dest = str(tmp_path / "result.json")
    tcl.download_result(up["job_id"], "json", dest, live_server)
    assert b"segments" in open(dest, "rb").read()
    assert tcl.quick_test(str(tmp_path / "speech.wav"), live_server,
                          budget_s=15)
    out = capsys.readouterr().out
    assert "job:" in out and "downloaded:" in out
    assert tcl.main([str(wav), "--base-url", live_server, "--no-llm",
                     "--timeout", "15", "--download", "json"]) == 0


def test_cli_modules_run_as_entry_points():
    """Every tool is a module with a main(argv) returning an exit code."""
    import importlib

    for name in ("transcribe", "batch_transcribe", "diarize",
                 "conversation", "meeting", "demo", "verify_setup",
                 "install_packages", "clients"):
        mod = importlib.import_module(f"whisper_aries_tpu_torch.cli.{name}")
        assert callable(mod.main), name
        src = Path(mod.__file__).read_text()
        assert 'if __name__ == "__main__":\n    raise SystemExit(main())' \
            in src, name
    assert isinstance(ttr.build_parser(), argparse.ArgumentParser)
