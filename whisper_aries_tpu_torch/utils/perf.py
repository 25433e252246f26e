"""Performance monitoring and profiling (the port's copy of the JAX
package's utils/perf.py).

``PerformanceMonitor`` is the reference's thread-safe ledger of completed
units (Yasmeen's code/complete_fixed_whisper.py:527-598): rolling speed
factor (audio seconds / wall seconds), ETA, units a minute, the units each
device took and the parallel efficiency; the engine records one unit a
window batch and returns ``final_report()`` as a call's ``performance``.
``WorkerDiagnostics`` is the timestamped activity log (:249-284), and
``profile_trace`` a ``torch.profiler`` context that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional


class PerformanceMonitor:
    """Ledger of completed decode batches / windows with rolling stats."""

    def __init__(self, total_audio_s: float = 0.0,
                 progress_callback: Optional[Callable[[Dict], None]] = None):
        self._lock = threading.Lock()
        self.total_audio_s = total_audio_s
        self.progress_callback = progress_callback
        self.start_time = time.time()
        self.records: List[Dict[str, Any]] = []

    def record(self, unit_id: int, audio_s: float, wall_s: float,
               device: int = 0, kind: str = "window") -> None:
        with self._lock:
            self.records.append({
                "id": unit_id, "audio_s": audio_s, "wall_s": wall_s,
                "device": device, "kind": kind, "t": time.time(),
            })
        if self.progress_callback:
            self.progress_callback(self.snapshot())

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            recs = list(self.records)
        elapsed = max(time.time() - self.start_time, 1e-9)
        done_audio = sum(r["audio_s"] for r in recs)
        speed = done_audio / elapsed
        remaining = max(0.0, self.total_audio_s - done_audio)
        eta = remaining / speed if speed > 0 else None
        per_device: Dict[int, int] = defaultdict(int)
        for r in recs:
            per_device[r["device"]] += 1
        n_devices = max(len(per_device), 1)
        ideal = len(recs) / n_devices if recs else 0
        efficiency = (min(per_device.values()) / ideal
                      if recs and ideal > 0 else 0.0)
        return {
            "elapsed_s": elapsed,
            "completed_units": len(recs),
            "completed_audio_s": done_audio,
            "average_speed_factor": speed,
            "units_per_minute": len(recs) / elapsed * 60.0,
            "eta_s": eta,
            "per_device_distribution": dict(per_device),
            "parallel_efficiency": efficiency,
        }

    def final_report(self) -> Dict[str, Any]:
        snap = self.snapshot()
        snap["performance_tier"] = assess_performance_tier(
            snap["average_speed_factor"])
        return snap


def assess_performance_tier(speed_factor: float) -> str:
    """The reference's self-assessment tiers
    (complete_fixed_whisper.py:941-950)."""
    if speed_factor >= 10:
        return "excellent"
    if speed_factor >= 5:
        return "great"
    if speed_factor >= 2:
        return "good"
    return "below-realtime-target"


class WorkerDiagnostics:
    """Timestamped per-unit state transitions."""

    STATES = ("PLANNED", "ENCODING", "DECODING", "FALLBACK", "COMPLETED",
              "ERROR")

    def __init__(self):
        self._lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []

    def log(self, unit_id: Any, state: str, detail: str = "") -> None:
        with self._lock:
            self.events.append({
                "t": time.time(), "unit": unit_id, "state": state,
                "detail": detail, "thread": threading.get_ident(),
            })

    def summary(self) -> Dict[str, int]:
        """{state: number of transitions}."""
        with self._lock:
            counts: Dict[str, int] = defaultdict(int)
            for e in self.events:
                counts[e["state"]] += 1
            return dict(counts)

    def dump(self) -> List[str]:
        with self._lock:
            return [
                f"{e['t']:.3f} [{e['thread']}] unit={e['unit']} "
                f"{e['state']} {e['detail']}"
                for e in self.events
            ]


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over the block (the host, and the cards when
    CUDA is available); writes ``trace.json``, a Chrome trace that
    Perfetto and chrome://tracing open, into ``log_dir`` (default
    ``aries_profile`` in the temporary directory) and yields the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir or os.path.join(tempfile.gettempdir(),
                                       "aries_profile"))
    out.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
