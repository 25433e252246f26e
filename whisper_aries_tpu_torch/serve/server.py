"""Async job-queue API server (the port of the JAX package's
serve/server.py).

Endpoint- and response-shape-compatible with the reference FastAPI server
(api_server.py:168-345) and with the JAX package's server:

    GET    /                      health + endpoint map
    POST   /analyze/              multipart upload -> queued job
    GET    /status/{job_id}       job status dict
    GET    /jobs/                 last 50 jobs
    GET    /download/{job_id}/{file_type}
    DELETE /jobs/{job_id}         delete job + outputs
    GET    /stats/                success-rate aggregation

Differences (deliberate fixes of reference defects):
  * jobs persist as atomic JSON, with crash recovery, instead of pickle
    (serve/jobstore.py);
  * job concurrency is actually bounded by an asyncio semaphore — the
    reference declares ThreadPoolExecutor(max_workers=2) but never uses it,
    so its BackgroundTasks concurrency is unbounded (api_server.py:75,240);
  * the ASR engine is resident and shared across jobs (one model on the
    card, from ``pipeline/run.py::get_transcriber``) rather than
    re-instantiated per request;
  * pipeline work runs in a worker thread via ``run_in_executor`` so the
    event loop keeps serving status polls during jobs. Up to
    ``server.max_concurrent_jobs`` jobs overlap their host work (upload,
    decode, render); their card work takes turns under the card's lock
    (``utils/device.py::on_card``), held by the engine and the diarizer.

Built on aiohttp (no FastAPI in the image); permissive CORS headers match
the reference's allow-all configuration (api_server.py:38-51).
"""

from __future__ import annotations

import asyncio
import functools
import logging
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, Optional

from whisper_aries_tpu_torch.config import AriesConfig, load_config
from whisper_aries_tpu_torch.serve.jobstore import JobStore

log = logging.getLogger(__name__)

ALLOWED_EXTENSIONS = {
    ".mp3", ".mp4", ".wav", ".m4a", ".avi", ".mov", ".mkv", ".webm", ".flac",
}

MEDIA_TYPE_MAP = {
    "html": "text/html",
    "json": "application/json",
    "srt": "text/plain",
    "txt": "text/plain",
    "meeting_summary_txt": "text/plain",
    "meeting_summary_html": "text/html",
}

CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "*",
    "Access-Control-Allow-Headers": "*",
}


def create_app(
    config: Optional[AriesConfig] = None,
    pipeline_fn: Optional[Callable[..., Dict[str, Any]]] = None,
    job_store: Optional[JobStore] = None,
):
    """Build the aiohttp application (aiohttp is imported here, not with
    the module).

    ``pipeline_fn(audio_file, output_dir, formats, confidence_threshold,
    language, run_llm_analysis, resume_path) -> result dict`` is injectable
    so tests can fake the model stage. ``resume_path`` is the per-job resume journal; accept
    ``**kwargs`` to stay forward-compatible with new pass-through knobs.
    """
    from aiohttp import web

    cfg = config or load_config()
    store = job_store or JobStore(cfg.server.job_store_path)
    output_root = cfg.server.output_root
    os.makedirs(output_root, exist_ok=True)
    sem = asyncio.Semaphore(cfg.server.max_concurrent_jobs)

    if pipeline_fn is None:
        # the resident engine: run_pipeline takes it from get_transcriber
        from whisper_aries_tpu_torch.pipeline.run import run_pipeline

        pipeline_fn = functools.partial(run_pipeline, config=cfg)

    # ------------------------------------------------------------------

    def jsonify(data: Any, status: int = 200):
        return web.json_response(data, status=status, headers=CORS_HEADERS)

    async def root(request):
        return jsonify({
            "message": "AI Conversation Analysis API",
            "version": "2.0.0-cuda",
            "status": "ready",
            "endpoints": {
                "upload": "/analyze/",
                "status": "/status/{job_id}",
                "download": "/download/{job_id}/{file_type}",
                "jobs": "/jobs/",
            },
        })

    async def _process_job(job_id: str, file_path: str,
                           params: Dict[str, Any],
                           temp_dir: Optional[str] = None):
        async with sem:
            store.update(job_id, status="running", progress=10,
                         message="Starting pipeline...")
            output_dir = os.path.join(output_root, job_id)
            os.makedirs(output_dir, exist_ok=True)
            store.update(job_id, progress=20, message="Running transcription...")
            loop = asyncio.get_running_loop()
            try:
                result = await loop.run_in_executor(
                    None,
                    functools.partial(
                        pipeline_fn,
                        audio_file=file_path,
                        output_dir=output_dir,
                        formats=params["formats"],
                        confidence_threshold=params["confidence_threshold"],
                        language=params["language"],
                        run_llm_analysis=params["run_llm_analysis"],
                        # per-window resume: a job killed mid-decode (crash,
                        # restart) resumes without re-decoding finished
                        # windows
                        resume_path=os.path.join(output_dir, "resume.jsonl"),
                    ),
                )
                if result.get("success"):
                    store.update(job_id, status="completed", progress=100,
                                 message="Analysis completed successfully",
                                 result=result)
                else:
                    store.update(job_id, status="failed", progress=0,
                                 message="Pipeline failed",
                                 error=result.get("error"))
            except Exception as e:
                log.exception("job %s crashed", job_id)
                store.update(job_id, status="failed", progress=0,
                             message="Unexpected error", error=str(e))
            finally:
                # remove the whole upload dir, not just the file (the
                # reference cleans its upload in finally, api_server.py:
                # 160-164)
                if temp_dir is not None:
                    shutil.rmtree(temp_dir, ignore_errors=True)
                else:
                    try:
                        os.remove(file_path)
                    except OSError:
                        pass

    async def analyze(request):
        reader = await request.multipart()
        file_path = None
        filename = None
        params = {
            "language": "auto",
            "confidence_threshold": 0.7,
            "formats": ["html", "json", "srt"],
            "run_llm_analysis": True,
        }
        temp_dir = tempfile.mkdtemp()
        launched = False  # once the job is queued, _process_job owns temp_dir
        max_bytes = cfg.server.max_upload_mb * 1024 * 1024
        try:
            async for part in reader:
                if part.name == "file":
                    filename = part.filename
                    if not filename:
                        return jsonify({"detail": "No file provided"}, 400)
                    ext = Path(filename).suffix.lower()
                    if ext not in ALLOWED_EXTENSIONS:
                        return jsonify(
                            {"detail":
                                f"Unsupported file type: {ext}. Supported: "
                                f"{', '.join(sorted(ALLOWED_EXTENSIONS))}"},
                            400,
                        )
                    file_path = os.path.join(
                        temp_dir, os.path.basename(filename))
                    size = 0
                    with open(file_path, "wb") as f:
                        while True:
                            chunk = await part.read_chunk(1 << 20)
                            if not chunk:
                                break
                            size += len(chunk)
                            if size > max_bytes:
                                return jsonify(
                                    {"detail": "Upload too large"}, 413)
                            f.write(chunk)
                elif part.name == "language":
                    params["language"] = (await part.text()).strip()
                elif part.name == "confidence_threshold":
                    params["confidence_threshold"] = float(await part.text())
                elif part.name == "formats":
                    params["formats"] = [
                        s.strip() for s in (await part.text()).split(",")
                        if s.strip()
                    ]
                elif part.name == "run_llm_analysis":
                    params["run_llm_analysis"] = (
                        (await part.text()).strip().lower()
                        in ("1", "true", "yes")
                    )

            if file_path is None:
                return jsonify({"detail": "No file provided"}, 400)

            lang = params["language"]
            params["language"] = None if lang in ("auto", "") else lang

            job_id = store.create(filename)
            asyncio.get_running_loop().create_task(
                _process_job(job_id, file_path, params, temp_dir)
            )
            launched = True
            return jsonify({
                "job_id": job_id,
                "status": "queued",
                "message": "File uploaded successfully. Processing started.",
                "filename": filename,
            })
        finally:
            # rejected/failed uploads must not leak their temp dir (the
            # reference cleans up in finally, api_server.py:160-164)
            if not launched:
                shutil.rmtree(temp_dir, ignore_errors=True)

    async def status(request):
        job = store.get(request.match_info["job_id"])
        if job is None:
            return jsonify({"detail": "Job not found"}, 404)
        return jsonify(job.to_dict())

    async def jobs_list(request):
        return jsonify({"jobs": [j.to_dict() for j in store.list_jobs(50)]})

    async def download(request):
        job_id = request.match_info["job_id"]
        file_type = request.match_info["file_type"]
        job = store.get(job_id)
        if job is None:
            return jsonify({"detail": "Job not found"}, 404)
        if job.status != "completed":
            return jsonify({"detail": "Job not completed yet"}, 400)
        outputs = (job.result or {}).get("outputs", {})
        if not outputs:
            return jsonify({"detail": "No outputs available"}, 404)
        if file_type not in outputs:
            return jsonify(
                {"detail": f"File type '{file_type}' not available. "
                           f"Available types: {list(outputs)}"},
                404,
            )
        file_path = outputs[file_type]
        if not os.path.exists(file_path):
            return jsonify({"detail": "File not found on disk"}, 404)
        return web.FileResponse(
            file_path,
            headers={
                **CORS_HEADERS,
                "Content-Type": MEDIA_TYPE_MAP.get(
                    file_type, "application/octet-stream"
                ),
                "Content-Disposition":
                    f'attachment; filename="{os.path.basename(file_path)}"',
            },
        )

    async def delete_job(request):
        job_id = request.match_info["job_id"]
        if store.get(job_id) is None:
            return jsonify({"detail": "Job not found"}, 404)
        out_dir = os.path.join(output_root, job_id)
        if os.path.exists(out_dir):
            shutil.rmtree(out_dir)
        store.delete(job_id)
        return jsonify({"message": "Job deleted successfully"})

    async def stats(request):
        return jsonify(store.stats())

    async def options_handler(request):
        return web.Response(headers=CORS_HEADERS)

    async def _job_gc(app):
        """Periodic age-based job GC (jobstore.cleanup): completed/failed
        jobs older than ARIES_JOB_TTL_S (default 7 days) are dropped so the
        store doesn't grow forever (the reference's pickle store did)."""
        import asyncio

        ttl = float(os.environ.get("ARIES_JOB_TTL_S", str(7 * 24 * 3600)))
        interval = min(3600.0, max(60.0, ttl / 24))

        async def loop():
            while True:
                await asyncio.sleep(interval)
                try:
                    n = store.cleanup(max_age_s=ttl)
                    if n:
                        log.info("job GC: removed %d expired job(s)", n)
                except Exception as e:  # GC must never kill the server
                    log.warning("job GC failed: %s", e)

        task = asyncio.ensure_future(loop())
        yield
        task.cancel()

    app = web.Application(client_max_size=cfg.server.max_upload_mb * 1024 * 1024)
    app["job_store"] = store
    app.cleanup_ctx.append(_job_gc)
    app.router.add_get("/", root)
    app.router.add_post("/analyze/", analyze)
    app.router.add_get("/status/{job_id}", status)
    app.router.add_get("/jobs/", jobs_list)
    app.router.add_get("/download/{job_id}/{file_type}", download)
    app.router.add_delete("/jobs/{job_id}", delete_job)
    app.router.add_get("/stats/", stats)
    app.router.add_route("OPTIONS", "/{tail:.*}", options_handler)
    return app


def main(argv=None):
    """uvicorn-equivalent dev entry: serve on the config's host and port
    (reference api_server.py:348-364). ``--device cpu`` runs the pipeline
    on the CPU; by default it runs on the card."""
    import argparse

    from aiohttp import web

    parser = argparse.ArgumentParser(description="Conversation analysis API")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--config", default=None, help="JSON config file")
    parser.add_argument("--device", default=None,
                        help="device of the engine and the diarizer "
                             "(default: the CUDA card; 'cpu' for the CPU)")
    args = parser.parse_args(argv)

    cfg = load_config(config_file=args.config)
    if args.host:
        cfg.server.host = args.host
    if args.port:
        cfg.server.port = args.port

    pipeline_fn = None
    if args.device is not None:
        from whisper_aries_tpu_torch.pipeline.run import run_pipeline

        pipeline_fn = functools.partial(run_pipeline, config=cfg,
                                        device=args.device)
    app = create_app(cfg, pipeline_fn=pipeline_fn)
    log.info("starting API server on %s:%d", cfg.server.host, cfg.server.port)
    web.run_app(app, host=cfg.server.host, port=cfg.server.port)


if __name__ == "__main__":
    main()
