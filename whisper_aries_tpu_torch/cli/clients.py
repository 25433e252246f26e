"""Clients of the job server (the port's copy of the JAX package's
cli/clients.py): the reference's manual integration client (test_api.py)
and scripted smoke test (quick_api_test.py) as importable,
non-interactive functions and a CLI, for the port's server
(``python -m whisper_aries_tpu_torch.serve.server``), whose endpoints are
the JAX server's.

    python -m whisper_aries_tpu_torch.cli.clients audio.wav \
        [--base-url http://localhost:8001] [--no-llm] [--download json]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

DEFAULT_BASE = "http://localhost:8001"


def check_health(base_url: str = DEFAULT_BASE) -> Dict[str, Any]:
    import requests

    r = requests.get(base_url + "/", timeout=10)
    r.raise_for_status()
    return r.json()


def upload_file_for_analysis(
    path: str,
    base_url: str = DEFAULT_BASE,
    language: str = "auto",
    formats: str = "html,json,srt",
    confidence_threshold: float = 0.7,
    run_llm_analysis: bool = True,
) -> Dict[str, Any]:
    import requests

    with open(path, "rb") as f:
        r = requests.post(
            base_url + "/analyze/",
            files={"file": (Path(path).name, f)},
            data={
                "language": language,
                "formats": formats,
                "confidence_threshold": str(confidence_threshold),
                "run_llm_analysis": str(run_llm_analysis).lower(),
            },
            timeout=600,
        )
    r.raise_for_status()
    return r.json()


def wait_for_job_completion(
    job_id: str,
    base_url: str = DEFAULT_BASE,
    timeout_s: float = 300.0,
    poll_s: float = 5.0,
    progress=print,
) -> Dict[str, Any]:
    import requests

    deadline = time.time() + timeout_s
    while time.time() < deadline:
        r = requests.get(f"{base_url}/status/{job_id}", timeout=30)
        r.raise_for_status()
        job = r.json()
        if progress:
            progress(f"  {job['status']} {job['progress']}% — {job['message']}")
        if job["status"] in ("completed", "failed"):
            return job
        time.sleep(poll_s)
    raise TimeoutError(f"job {job_id} did not finish within {timeout_s}s")


def download_result(
    job_id: str, file_type: str, dest: str,
    base_url: str = DEFAULT_BASE,
) -> str:
    import requests

    r = requests.get(f"{base_url}/download/{job_id}/{file_type}", timeout=120)
    r.raise_for_status()
    with open(dest, "wb") as f:
        f.write(r.content)
    return dest


def quick_test(audio_path: str, base_url: str = DEFAULT_BASE,
               budget_s: float = 120.0) -> bool:
    """Non-interactive end-to-end smoke test (reference quick_api_test.py:
    upload with run_llm_analysis=False, poll, download HTML)."""
    print(f"health: {check_health(base_url)['status']}")
    up = upload_file_for_analysis(
        audio_path, base_url, run_llm_analysis=False, formats="html,json"
    )
    print(f"job: {up['job_id']}")
    job = wait_for_job_completion(up["job_id"], base_url, timeout_s=budget_s,
                                  poll_s=3.0)
    if job["status"] != "completed":
        print(f"FAILED: {job.get('error')}")
        return False
    dest = str(Path(audio_path).with_name(Path(audio_path).stem
                                          + "_api_result.html"))
    download_result(up["job_id"], "html", dest, base_url)
    print(f"downloaded: {dest}")
    return True


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="api_client")
    p.add_argument("audio", help="file to upload")
    p.add_argument("--base-url", default=DEFAULT_BASE)
    p.add_argument("--language", default="auto")
    p.add_argument("--formats", default="html,json,srt")
    p.add_argument("--no-llm", action="store_true")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--download", default=None,
                   help="file type to download after completion")
    args = p.parse_args(argv)

    print(f"health: {check_health(args.base_url)}")
    up = upload_file_for_analysis(
        args.audio, args.base_url, language=args.language,
        formats=args.formats, run_llm_analysis=not args.no_llm,
    )
    print(f"uploaded: job {up['job_id']}")
    job = wait_for_job_completion(up["job_id"], args.base_url,
                                  timeout_s=args.timeout)
    if job["status"] != "completed":
        print(f"job failed: {job.get('error')}", file=sys.stderr)
        return 1
    outputs = (job.get("result") or {}).get("outputs", {})
    print(f"outputs: {list(outputs)}")
    if args.download and args.download in outputs:
        dest = f"{Path(args.audio).stem}.{args.download}"
        download_result(up["job_id"], args.download, dest, args.base_url)
        print(f"downloaded: {dest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
