"""Durable job store for the API server (the port's copy of the JAX
package's serve/jobstore.py: the same file format, so either server reads
the other's store).

The reference persists jobs by pickling Pydantic objects to ``api_jobs.pkl``
(api_server.py:54-75) — unreadable without importing the server module and
fragile across versions (SURVEY §5 recommends replacing it). This store
keeps the same semantics (survives restarts; jobs keep status/progress/
result) but uses atomic JSON writes, plus recovery marking: jobs left
"running" by a crash are flagged "failed" on reload instead of hanging
"running" forever (the reference's documented gap, SURVEY §5
checkpoint/resume).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import uuid
from dataclasses import asdict, dataclass, field
from datetime import datetime
from typing import Any, Dict, List, Optional


@dataclass
class JobStatus:
    """Same field set as the reference's JobStatus (api_server.py:77-86)."""

    job_id: str
    status: str = "queued"  # queued | running | completed | failed
    progress: int = 0
    message: str = ""
    created_at: str = ""
    started_at: Optional[str] = None
    completed_at: Optional[str] = None
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    filename: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


class JobStore:
    """Thread-safe persistent job registry."""

    def __init__(self, path: str = "api_jobs.json"):
        self.path = path
        self._lock = threading.Lock()
        self._jobs: Dict[str, JobStatus] = {}
        self._load()

    # -- persistence -------------------------------------------------------

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                raw = json.load(f)
            for jid, jd in raw.items():
                known = {k: jd.get(k) for k in JobStatus.__dataclass_fields__}
                job = JobStatus(**known)
                if job.status == "running":
                    # crash recovery: a restarted server can't resume the
                    # in-flight pipeline; surface the interruption.
                    job.status = "failed"
                    job.error = "server restarted while job was running"
                    job.completed_at = datetime.now().isoformat()
                self._jobs[jid] = job
        except Exception:
            # corrupt store: start fresh rather than refusing to boot
            self._jobs = {}

    def _save_locked(self) -> None:
        data = {jid: j.to_dict() for jid, j in self._jobs.items()}
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(data, f)
            os.replace(tmp, self.path)
        except Exception:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    # -- API ---------------------------------------------------------------

    def create(self, filename: Optional[str] = None) -> str:
        job_id = str(uuid.uuid4())
        with self._lock:
            self._jobs[job_id] = JobStatus(
                job_id=job_id,
                status="queued",
                progress=0,
                message="Job created",
                created_at=datetime.now().isoformat(),
                filename=filename,
            )
            self._save_locked()
        return job_id

    def update(
        self,
        job_id: str,
        status: Optional[str] = None,
        progress: Optional[int] = None,
        message: Optional[str] = None,
        result: Optional[Dict[str, Any]] = None,
        error: Optional[str] = None,
    ) -> None:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return
            if status is not None:
                job.status = status
                if status == "running" and job.started_at is None:
                    job.started_at = datetime.now().isoformat()
                elif status in ("completed", "failed"):
                    job.completed_at = datetime.now().isoformat()
            if progress is not None:
                job.progress = progress
            if message is not None:
                job.message = message
            if result is not None:
                job.result = result
            if error is not None:
                job.error = error
            self._save_locked()

    def get(self, job_id: str) -> Optional[JobStatus]:
        with self._lock:
            return self._jobs.get(job_id)

    def delete(self, job_id: str) -> bool:
        with self._lock:
            if job_id not in self._jobs:
                return False
            del self._jobs[job_id]
            self._save_locked()
            return True

    def list_jobs(self, limit: int = 50) -> List[JobStatus]:
        with self._lock:
            jobs = sorted(
                self._jobs.values(), key=lambda j: j.created_at, reverse=True
            )
        return jobs[:limit]

    def cleanup(self, max_age_s: float = 7 * 24 * 3600.0,
                now: Optional[datetime] = None) -> int:
        """Age-based GC: drop completed/failed jobs older than ``max_age_s``
        (measured from completion time). Queued/running jobs are never
        collected. Returns the number of jobs removed.

        The reference's pickle store grows forever (api_server.py:54-75);
        the server calls this periodically (serve/server.py) with
        ``ARIES_JOB_TTL_S`` controlling the horizon."""
        now = now or datetime.now()
        removed = 0
        with self._lock:
            for jid in list(self._jobs):
                job = self._jobs[jid]
                if job.status not in ("completed", "failed"):
                    continue
                stamp = job.completed_at or job.created_at
                try:
                    age = (now - datetime.fromisoformat(stamp)).total_seconds()
                except Exception:
                    continue
                if age > max_age_s:
                    del self._jobs[jid]
                    removed += 1
            if removed:
                self._save_locked()
        return removed

    def stats(self) -> Dict[str, Any]:
        """Success-rate aggregation (reference: api_server.py:331-345)."""
        with self._lock:
            jobs = list(self._jobs.values())
        total = len(jobs)
        completed = sum(1 for j in jobs if j.status == "completed")
        failed = sum(1 for j in jobs if j.status == "failed")
        running = sum(1 for j in jobs if j.status == "running")
        return {
            "total_jobs": total,
            "completed_jobs": completed,
            "failed_jobs": failed,
            "running_jobs": running,
            "success_rate": (completed / total * 100) if total > 0 else 0,
        }
