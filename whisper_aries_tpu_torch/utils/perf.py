"""Per-call activity log of the engine's windows (the port's copy of the
JAX package's utils/perf.py ``WorkerDiagnostics``; reference
complete_fixed_whisper.py:249-284)."""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Any, Dict, List


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
