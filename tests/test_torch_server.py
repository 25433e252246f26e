"""The port's job server (whisper_aries_tpu_torch/serve): the JAX server's
13 cases (tests/test_server.py) against the port's ``create_app`` with a
faked pipeline stage; then, on the CPU, two concurrent jobs on the real
port ``run_pipeline`` (a tiny engine, the trained diarizer) giving what
their serial runs give, the card lock held across ``transcribe_file``,
and a ``.m4a`` upload decoded by the port's libavformat decoder.

Tolerances: none; JSON segments and job fields compared exactly."""

import asyncio
import contextlib
import functools
import json
import os
import threading

import numpy as np
import pytest

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from whisper_aries_tpu_torch.audio.decode import write_wav
from whisper_aries_tpu_torch.config import AriesConfig, load_config
from whisper_aries_tpu_torch.serve.jobstore import JobStore
from whisper_aries_tpu_torch.serve.server import create_app

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

SR = 16_000
NO_KEY = "ARIES_TEST_NO_SUCH_KEY"


def fake_pipeline(audio_file, output_dir, formats, confidence_threshold,
                  language, run_llm_analysis, **kwargs):
    # **kwargs absorbs pass-through knobs like resume_path
    os.makedirs(output_dir, exist_ok=True)
    outputs = {}
    segs = [{"text": "hello", "start": 0.0, "end": 1.0,
             "speaker": "SPEAKER_00", "confidence": 1.0}]
    for fmt in formats:
        p = os.path.join(output_dir, f"out.{fmt}")
        with open(p, "w") as f:
            f.write(json.dumps({"segments": segs}) if fmt == "json" else "x")
        outputs[fmt] = p
    return {
        "success": True,
        "outputs": outputs,
        "metadata": {"language": language or "auto"},
        "stats": {"num_segments": 1},
        "aligned_segments": segs,
    }


def failing_pipeline(**kwargs):
    return {"success": False, "error": "boom"}


def _config(tmp_path, **server):
    cfg = AriesConfig()
    cfg.server.output_root = str(tmp_path / "outputs")
    cfg.server.job_store_path = str(tmp_path / "jobs.json")
    for k, v in server.items():
        setattr(cfg.server, k, v)
    return cfg


@pytest.fixture
def make_client(tmp_path):
    """Async context manager: creates and closes the client in one loop."""

    @contextlib.asynccontextmanager
    async def _make(pipeline=fake_pipeline, cfg=None):
        app = create_app(cfg or _config(tmp_path), pipeline_fn=pipeline)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            yield client
        finally:
            await client.close()

    return _make


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def upload(client, filename="test.wav", body=b"RIFFfake", **form):
    data = aiohttp.FormData()
    data.add_field("file", body, filename=filename)
    for k, v in form.items():
        data.add_field(k, str(v))
    return await client.post("/analyze/", data=data)


async def wait_done(client, job_id, timeout=5.0):
    for _ in range(int(timeout / 0.05)):
        resp = await client.get(f"/status/{job_id}")
        d = await resp.json()
        if d["status"] in ("completed", "failed"):
            return d
        await asyncio.sleep(0.05)
    raise TimeoutError


# ---------------------------------------------------------------------------
# the JAX server's cases (tests/test_server.py), on the port's create_app
# ---------------------------------------------------------------------------


def test_root_health(make_client):
    async def go():
        async with make_client() as client:
            resp = await client.get("/")
            d = await resp.json()
            assert d["status"] == "ready"
            assert d["endpoints"]["upload"] == "/analyze/"
            assert resp.headers["Access-Control-Allow-Origin"] == "*"

    run(go())


def test_upload_and_complete(make_client):
    async def go():
        async with make_client() as client:
            resp = await upload(client, language="en", formats="json,srt",
                                run_llm_analysis="false")
            assert resp.status == 200
            d = await resp.json()
            assert d["status"] == "queued"
            assert d["filename"] == "test.wav"
            job = await wait_done(client, d["job_id"])
            assert job["status"] == "completed"
            assert job["progress"] == 100
            assert set(job["result"]["outputs"]) == {"json", "srt"}

    run(go())


def test_upload_rejects_bad_extension(make_client):
    async def go():
        async with make_client() as client:
            resp = await upload(client, filename="evil.exe")
            assert resp.status == 400
            d = await resp.json()
            assert "Unsupported file type" in d["detail"]

    run(go())


def test_download_roundtrip(make_client):
    async def go():
        async with make_client() as client:
            resp = await upload(client, formats="json")
            d = await resp.json()
            await wait_done(client, d["job_id"])
            dl = await client.get(f"/download/{d['job_id']}/json")
            assert dl.status == 200
            body = await dl.read()
            assert b"segments" in body
            # unknown type -> 404 with available list
            dl2 = await client.get(f"/download/{d['job_id']}/html")
            assert dl2.status == 404

    run(go())


def test_status_unknown_job(make_client):
    async def go():
        async with make_client() as client:
            resp = await client.get("/status/nope")
            assert resp.status == 404

    run(go())


def test_failed_pipeline_reported(make_client):
    async def go():
        async with make_client(pipeline=failing_pipeline) as client:
            resp = await upload(client)
            d = await resp.json()
            job = await wait_done(client, d["job_id"])
            assert job["status"] == "failed"
            assert job["error"] == "boom"

    run(go())


def test_jobs_list_stats_delete(make_client):
    async def go():
        async with make_client() as client:
            r1 = await (await upload(client)).json()
            r2 = await (await upload(client)).json()
            await wait_done(client, r1["job_id"])
            await wait_done(client, r2["job_id"])
            jobs = await (await client.get("/jobs/")).json()
            assert len(jobs["jobs"]) == 2
            stats = await (await client.get("/stats/")).json()
            assert stats["total_jobs"] == 2
            assert stats["completed_jobs"] == 2
            assert stats["success_rate"] == 100
            resp = await client.delete(f"/jobs/{r1['job_id']}")
            assert resp.status == 200
            stats = await (await client.get("/stats/")).json()
            assert stats["total_jobs"] == 1

    run(go())


def test_upload_temp_dir_cleanup(make_client, tmp_path, monkeypatch):
    """Neither rejected nor completed uploads may leak their temp dir
    (reference cleans up in finally, api_server.py:160-164)."""
    import tempfile

    upload_root = tmp_path / "uploads"
    upload_root.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(upload_root))

    async def go():
        async with make_client() as client:
            # rejected extension: dir must be gone immediately
            resp = await upload(client, filename="evil.exe")
            assert resp.status == 400
            assert os.listdir(upload_root) == []
            # missing file part: same (content_type forces multipart)
            data = aiohttp.FormData()
            data.add_field("language", "en", content_type="text/plain")
            resp = await client.post("/analyze/", data=data)
            assert resp.status == 400
            assert os.listdir(upload_root) == []
            # success path: job owns the dir and removes it when done
            resp = await upload(client, formats="json")
            d = await resp.json()
            await wait_done(client, d["job_id"])
            assert os.listdir(upload_root) == []

    run(go())


def test_upload_too_large_cleanup(make_client, tmp_path, monkeypatch):
    import tempfile

    upload_root = tmp_path / "uploads"
    upload_root.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(upload_root))

    async def go():
        async with make_client(cfg=_config(tmp_path,
                                           max_upload_mb=0)) as client:
            resp = await upload(client)
            assert resp.status == 413
            assert os.listdir(upload_root) == []

    run(go())


def test_jobstore_persistence(tmp_path):
    path = str(tmp_path / "jobs.json")
    store = JobStore(path)
    jid = store.create("a.wav")
    store.update(jid, status="completed", progress=100,
                 result={"outputs": {}})
    store2 = JobStore(path)
    job = store2.get(jid)
    assert job is not None
    assert job.status == "completed"
    assert job.filename == "a.wav"


def test_jobstore_crash_recovery(tmp_path):
    path = str(tmp_path / "jobs.json")
    store = JobStore(path)
    jid = store.create("a.wav")
    store.update(jid, status="running", progress=50)
    # simulate restart: the running job must be marked failed, not stuck
    store2 = JobStore(path)
    job = store2.get(jid)
    assert job.status == "failed"
    assert "restarted" in job.error


def test_jobstore_corrupt_file(tmp_path):
    path = tmp_path / "jobs.json"
    path.write_text("{not json")
    store = JobStore(str(path))
    assert store.list_jobs() == []
    jid = store.create("x.wav")
    assert store.get(jid) is not None


def test_jobstore_cleanup_age_gc(tmp_path):
    """cleanup() drops old completed/failed jobs, keeps fresh + active ones."""
    from datetime import datetime, timedelta

    path = str(tmp_path / "jobs.json")
    store = JobStore(path)
    old_done = store.create("old.wav")
    store.update(old_done, status="completed")
    old_failed = store.create("oldfail.wav")
    store.update(old_failed, status="failed", error="x")
    fresh = store.create("fresh.wav")
    store.update(fresh, status="completed")
    active = store.create("active.wav")
    store.update(active, status="running")

    # backdate the two old jobs' completion stamps by 10 days
    past = (datetime.now() - timedelta(days=10)).isoformat()
    store.get(old_done).completed_at = past
    store.get(old_failed).completed_at = past

    removed = store.cleanup(max_age_s=7 * 24 * 3600)
    assert removed == 2
    assert store.get(old_done) is None and store.get(old_failed) is None
    assert store.get(fresh) is not None
    assert store.get(active) is not None
    # persisted: a reloaded store agrees (running -> failed via recovery)
    store2 = JobStore(path)
    assert store2.get(old_done) is None
    assert store2.get(fresh) is not None


def test_jobstore_reads_the_jax_store(tmp_path):
    """The two packages' stores share one file format."""
    from whisper_aries_tpu.serve.jobstore import JobStore as JaxJobStore

    path = str(tmp_path / "jobs.json")
    jax_store = JaxJobStore(path)
    jid = jax_store.create("a.wav")
    jax_store.update(jid, status="completed", result={"outputs": {}})
    assert JobStore(path).get(jid).to_dict() == jax_store.get(jid).to_dict()


def test_server_keeps_the_jax_extensions_and_media_types():
    from whisper_aries_tpu.serve import server as JS
    from whisper_aries_tpu_torch.serve import server as TS

    assert TS.ALLOWED_EXTENSIONS == JS.ALLOWED_EXTENSIONS
    assert TS.MEDIA_TYPE_MAP == JS.MEDIA_TYPE_MAP
    assert TS.CORS_HEADERS == JS.CORS_HEADERS


# ---------------------------------------------------------------------------
# the real port pipeline on the CPU: a tiny engine and the trained diarizer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_engine():
    from torch_port_util import PieceTokenizer, random_jax_tree
    from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
    from whisper_aries_tpu.models import whisper as JW
    from whisper_aries_tpu_torch.models import whisper as TW
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    tok = PieceTokenizer(build_special_tokens)
    dims = TW.WhisperDims(80, 1500, 64, 2, 2, tok.specials.n_vocab, 448,
                          64, 2, 2)
    jdims = JW.WhisperDims(*[getattr(dims, f)
                             for f in dims.__dataclass_fields__])
    return AriesTranscriber(
        model_size="tiny-torch", device="cpu",
        _params=TW.params_from_jax(random_jax_tree(jdims, seed=11,
                                                   weight_std=0.08)),
        _dims=dims, config=_pipeline_config(), windows_per_device=1,
        _tokenizer=tok)


def _pipeline_config():
    return load_config(overrides={
        "analyze.api_key_env": NO_KEY, "decode.language": "en",
        "decode.temperature": (0.0,), "decode.max_new_tokens": 8})


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two short two-voice scenes (tests/test_torch_diarize.py's voices):
    a WAV at 16 kHz and another in a second order of turns."""
    from test_torch_diarize import synth_speaker

    d = tmp_path_factory.mktemp("scenes")
    out = []
    for name, order in (("one", 0), ("two", 1)):
        spans = [[(0.5, 3.5), (7.0, 9.5)], [(4.0, 6.5), (10.0, 11.5)]]
        a = synth_speaker(110, 500, spans[order], 12.0, seed=1)
        b = synth_speaker(280, 2400, spans[1 - order], 12.0, seed=2)
        p = d / f"{name}.wav"
        write_wav(str(p), a + b, SR)
        out.append(str(p))
    return out


def _segments_of(json_text: str):
    data = json.loads(json_text)
    return data["segments"], {k: v for k, v in data["metadata"].items()
                              if k != "audio_file"}


def test_two_concurrent_jobs_equal_their_serial_runs(scenes, tiny_engine,
                                                     tmp_path):
    """Two jobs in flight at once on the real port run_pipeline (one
    resident engine, the trained diarizer): each job's speaker turns, JSON
    segments and metadata, SRT, and its result's aligned segments and
    counts equal a serial run of the same file; both jobs held the
    pipeline at the same time."""
    from whisper_aries_tpu_torch.diarize import DiarizationPipeline
    from whisper_aries_tpu_torch.pipeline.run import run_pipeline

    cfg = _pipeline_config()
    diar = DiarizationPipeline(device="cpu")
    turns = {}

    def diarizer(path, **k):
        out = diar(path, **k)
        turns.setdefault(os.path.basename(path), []).append(out)
        return out

    kw = dict(config=cfg, transcriber=tiny_engine, diarizer=diarizer,
              strict_diarization=True)
    serial = {}
    for path in scenes:
        res = run_pipeline(path, output_dir=str(tmp_path / "serial"),
                           formats=["json", "srt"], run_llm_analysis=False,
                           **kw)
        assert res["success"], res["error"]
        serial[os.path.basename(path)] = (
            res, open(res["outputs"]["json"], encoding="utf-8").read())

    both_in = threading.Barrier(2, timeout=60)

    def job(**call):
        both_in.wait()  # each job waits until the other is in flight too
        return run_pipeline(**call, **kw)

    async def go():
        cfg_srv = _config(tmp_path, max_concurrent_jobs=2)
        async with contextlib.AsyncExitStack() as stack:
            client = TestClient(TestServer(create_app(cfg_srv,
                                                      pipeline_fn=job)))
            await client.start_server()
            stack.push_async_callback(client.close)
            ids = []
            for path in scenes:
                with open(path, "rb") as f:
                    r = await upload(client, os.path.basename(path), f.read(),
                                     formats="json,srt",
                                     run_llm_analysis="false", language="en")
                assert r.status == 200
                ids.append((os.path.basename(path),
                            (await r.json())["job_id"]))
            for name, jid in ids:
                st = await wait_done(client, jid, timeout=300)
                assert st["status"] == "completed", st
                res, want_json = serial[name]
                got = st["result"]
                assert got["aligned_segments"] == res["aligned_segments"]
                same = ("num_segments", "num_speakers", "total_duration")
                assert {k: got["stats"][k] for k in same} == \
                    {k: res["stats"][k] for k in same}
                dl = await client.get(f"/download/{jid}/json")
                assert dl.status == 200
                assert _segments_of(await dl.text()) == \
                    _segments_of(want_json)
                srt = await client.get(f"/download/{jid}/srt")
                assert await srt.text() == open(
                    res["outputs"]["srt"], encoding="utf-8").read()

    run(go())
    for name, (serial_turns, job_turns) in turns.items():
        assert serial_turns and serial_turns == job_turns, name


def test_card_lock_held_across_transcribe_file(scenes, tiny_engine,
                                               monkeypatch):
    """transcribe_file holds the device's lock over its device work (the
    encoder and every decode call) and releases it after; the engine's
    weight upload and smoke test, and the diarizer's weight uploads and
    nets, run under the same lock; another thread cannot take it
    meanwhile."""
    import torch
    from whisper_aries_tpu_torch.diarize import DiarizationPipeline
    from whisper_aries_tpu_torch.diarize import pipeline as DP
    from whisper_aries_tpu_torch.pipeline import engine as EN
    from whisper_aries_tpu_torch.utils.device import card_lock

    eng = tiny_engine
    lock = card_lock(eng.device)
    assert card_lock(torch.device("cpu")) is lock
    seen = []

    def other_thread_takes_it():
        other = []

        def take():
            got = lock.acquire(blocking=False)
            other.append(got)
            if got:  # the lock is re-entrant: give it back in this thread
                lock.release()

        t = threading.Thread(target=take)
        t.start()
        t.join(timeout=30)
        assert other in ([True], [False])
        return other == [True]

    def held():
        return not other_thread_takes_it()

    def spy(name, fn):
        def wrapped(*a, **k):
            seen.append((name, held()))
            return fn(*a, **k)
        return wrapped

    # the constructor's weight upload and the smoke test
    monkeypatch.setattr(EN, "_cast_floats", spy("upload", EN._cast_floats))
    EN.AriesTranscriber(
        model_size="tiny-torch", device="cpu", _params=eng.params,
        _dims=eng.dims, config=eng.config, windows_per_device=1,
        _tokenizer=eng.tokenizer)
    for cls in (DP.SegmentationNet, DP.EmbeddingNet):
        monkeypatch.setattr(cls, "load", spy(cls.__name__, cls.load))

    encode, decode = eng._encode_batch, eng._decode_batch

    def spy_encode(*a, **k):
        seen.append(("encode", held()))
        return encode(*a, **k)

    def spy_decode(*a, **k):
        seen.append(("decode", held()))
        return decode(*a, **k)

    monkeypatch.setattr(eng, "_encode_batch", spy_encode)
    monkeypatch.setattr(eng, "_decode_batch", spy_decode)
    eng.smoke_test()
    assert seen[-1] == ("encode", True)
    res = eng.transcribe_file(scenes[0], output_formats=[])
    assert res["success"] and res["num_windows"] >= 1
    diar = DiarizationPipeline(device="cpu")
    seg_forward, emb_forward = diar.seg_net.forward, diar.emb_net.forward

    def spy_seg(*a, **k):
        seen.append(("segmentation", held()))
        return seg_forward(*a, **k)

    def spy_emb(*a, **k):
        seen.append(("embedding", held()))
        return emb_forward(*a, **k)

    monkeypatch.setattr(diar.seg_net, "forward", spy_seg)
    monkeypatch.setattr(diar.emb_net, "forward", spy_emb)
    assert diar(scenes[0])
    assert {k for k, _ in seen} == {
        "upload", "SegmentationNet", "EmbeddingNet", "encode", "decode",
        "segmentation", "embedding"}
    assert all(ok for _, ok in seen), seen
    assert other_thread_takes_it()
    assert eng.last_stats["card_wait_s"] >= 0.0


def test_on_card_serialises_threads():
    """Many threads doing a read-modify-write under on_card, with the
    interpreter switching threads often, lose no update."""
    import sys

    import torch
    from whisper_aries_tpu_torch.utils.device import on_card

    state = {"n": 0}

    def work():
        for _ in range(200):
            with on_card(torch.device("cpu")):
                n = state["n"]
                for _ in range(20):
                    pass
                state["n"] = n + 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert state["n"] == 16 * 200


def test_m4a_upload_decodes_through_libavformat(scenes, tiny_engine,
                                                tmp_path, monkeypatch):
    """A .m4a upload passes the media step untouched and reaches the
    port's libavformat decoder, in the engine and in the diarizer."""
    from whisper_aries_tpu_torch.audio import _native
    from whisper_aries_tpu_torch.audio.decode import load_audio
    from whisper_aries_tpu_torch.diarize import DiarizationPipeline
    from whisper_aries_tpu_torch.pipeline.run import run_pipeline

    if not _native.codec_available("av"):
        pytest.skip("libavformat does not resolve on this host")
    body = _native.encode_m4a(load_audio(scenes[0]), SR)
    calls = []
    real = _native.decode_av

    def spy(data):
        calls.append(len(data))
        return real(data)

    monkeypatch.setattr(_native, "decode_av", spy)
    pipeline = functools.partial(
        run_pipeline, config=_pipeline_config(), transcriber=tiny_engine,
        diarizer=DiarizationPipeline(device="cpu"), strict_diarization=True)

    async def go():
        async with contextlib.AsyncExitStack() as stack:
            client = TestClient(TestServer(create_app(
                _config(tmp_path), pipeline_fn=pipeline)))
            await client.start_server()
            stack.push_async_callback(client.close)
            r = await upload(client, "scene.m4a", body, formats="json",
                             run_llm_analysis="false")
            st = await wait_done(client, (await r.json())["job_id"],
                                 timeout=300)
            assert st["status"] == "completed", st
            assert st["result"]["metadata"]["audio_file"].endswith(
                "scene.m4a")

    run(go())
    assert calls == [len(body), len(body)]  # the engine, the diarizer
