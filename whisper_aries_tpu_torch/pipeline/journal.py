"""The resume journal: an append-only JSONL file of per-window results.

The port's copy of the JAX engine's ``ResumeJournal`` and
``_plan_signature``, in the same format, so a journal written by one engine
resumes the other: line 1 is a header ``{"plan_sig": ...}``, then one record
``{"window_id", "segments", "reset"}`` per decoded window. A killed run
restarted with the same path decodes only the windows never journaled. A
header whose signature differs (another file, plan or decode option)
discards the journal; a torn tail line is skipped.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, List, Sequence

log = logging.getLogger(__name__)


def plan_signature(windows: Sequence[Any], model_size: str, beam: int,
                   sample_len: int, opts: str = "") -> str:
    """Stable id of (window plan, decode configuration): a journal written
    under another plan or other decode options must not be replayed."""
    h = hashlib.sha1()
    h.update(f"{model_size}|{beam}|{sample_len}|{len(windows)}|{opts}".encode())
    for w in windows:
        h.update(f"{w.start:.3f},{w.end:.3f},{w.chunk_id};".encode())
    return h.hexdigest()


class ResumeJournal:
    """Per-window decode results of one job (``done``: {window id:
    segments}), and the windows whose decode reset cross-window
    conditioning (``reset_ids``: the sequential mode's fallback), which a
    resume replays."""

    def __init__(self, path: str, sig: str):
        self.path = path
        self.sig = sig
        self.done: Dict[int, List[Dict[str, Any]]] = {}
        self.reset_ids: set = set()
        self._load()

    def _load(self) -> None:
        p = Path(self.path)
        if not p.exists():
            self._write_header()
            return
        try:
            lines = p.read_text(encoding="utf-8").splitlines()
            header = json.loads(lines[0]) if lines else {}
            if header.get("plan_sig") != self.sig:
                log.info("resume journal %s: plan changed, starting fresh",
                         self.path)
                self._write_header()
                return
            for line in lines[1:]:
                try:
                    rec = json.loads(line)
                    self.done[int(rec["window_id"])] = rec["segments"]
                    if rec.get("reset"):
                        self.reset_ids.add(int(rec["window_id"]))
                except Exception:
                    continue  # a torn tail write from a crash
            if self.done:
                log.info("resume journal %s: %d windows already decoded",
                         self.path, len(self.done))
        except Exception as e:
            log.warning("resume journal %s unreadable (%s); starting fresh",
                        self.path, e)
            self._write_header()

    def _write_header(self) -> None:
        self.done = {}
        self.reset_ids = set()
        Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "w", encoding="utf-8") as f:
            f.write(json.dumps({"plan_sig": self.sig}) + "\n")

    def record(self, window_id: int, segments: List[Dict[str, Any]],
               reset: bool = False, sync: bool = False) -> None:
        """Append one window's result; ``sync`` fsyncs it at once (the
        sequential mode), else ``flush`` does once a batch."""
        self.done[window_id] = segments
        if reset:
            self.reset_ids.add(window_id)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps({"window_id": window_id,
                                "segments": segments, "reset": reset}) + "\n")
            if sync:
                f.flush()
                os.fsync(f.fileno())

    def flush(self) -> None:
        """fsync the journal (once a batch)."""
        try:
            with open(self.path, "a", encoding="utf-8") as f:
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            log.warning("journal fsync failed: %s", e)
