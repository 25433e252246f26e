"""The legacy engine's class shape (the port's copy of the JAX package's
pipeline/legacy.py).

The reference ships a second, standalone engine ("Yasmeen's code/
complete_fixed_whisper.py"): a JSON config file with defaults written on
first use (:611-636), a progress callback (:687, 803-804), overlapping
fixed chunks merged by text (:880-902), and a result dict with
``parallel_info`` and ``performance`` blocks (:846-873) and the
>=10x / 5x / 2x self-assessment (:941-950). ``FixedUltraFastTranscriber
(config_file).transcribe_ultra_fast(path, ...)`` runs it over the port's
engine: ``parallel_info`` reads the engine's PerformanceMonitor report.
Device: CUDA unless ``device="cpu"``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

from whisper_aries_tpu_torch.utils.perf import assess_performance_tier

DEFAULT_CONFIG = {
    # legacy defaults (complete_fixed_whisper.py:611-636, :684-686)
    "model_size": "large-v3",
    "device": "auto",
    "compute_type": "bf16",
    "chunk_duration": 240,
    "overlap_duration": 10,
    "max_workers": None,
    "language": None,
    "beam_size": 1,
    "vad_filter": True,
    "vad_parameters": {
        "min_silence_duration_ms": 500,
        "speech_pad_ms": 200,
    },
}


class FixedUltraFastTranscriber:
    """Config-file-driven engine facade over AriesTranscriber."""

    def __init__(self, config_file: str = "whisper_config.json",
                 allow_random: bool = False, _engine=None,
                 device: Optional[str] = None):
        self.config_file = config_file
        self.config = dict(DEFAULT_CONFIG)
        p = Path(config_file)
        if p.exists():
            self.config.update(json.loads(p.read_text(encoding="utf-8")))
        else:
            # written with the defaults, as the legacy engine does
            p.write_text(json.dumps(DEFAULT_CONFIG, indent=2),
                         encoding="utf-8")
        if _engine is not None:
            self.engine = _engine
        else:
            from whisper_aries_tpu_torch.pipeline.engine import (
                AriesTranscriber,
            )

            self.engine = AriesTranscriber(
                model_size=self.config["model_size"],
                device=device,
                compute_type=self.config.get("compute_type", "bf16"),
                chunk_length_minutes=self.config["chunk_duration"] / 60.0,
                overlap_seconds=self.config["overlap_duration"],
                num_workers=self.config.get("max_workers"),
                allow_random=allow_random,
            )

    def transcribe_ultra_fast(
        self,
        audio_path: str,
        language: Optional[str] = None,
        progress_callback=None,
        output_formats=("txt", "json"),
        output_dir: Optional[str] = None,
    ) -> Dict[str, Any]:
        """The legacy entry point (complete_fixed_whisper.py:680-873)."""
        t0 = time.time()

        def cb(done, total):
            if progress_callback:
                progress_callback({"completed_chunks": done,
                                   "total_chunks": total})

        res = self.engine.transcribe_file(
            audio_path,
            language=language or self.config.get("language"),
            beam_size=self.config.get("beam_size", 1),
            vad_filter=self.config.get("vad_filter", True),
            vad_parameters=self.config.get("vad_parameters"),
            output_formats=output_formats,
            output_dir=output_dir,
            chunking_mode="fixed",
            overlap_strategy="merge",  # the legacy text-merge strategy
            progress_callback=cb,
        )
        total_time = time.time() - t0
        speed = res["duration"] / total_time if total_time > 0 else 0.0
        perf = res.get("performance") or {}
        return {
            "success": res["success"],
            "text": res["text"],
            "segments": res["segments"],
            "language": res["language"],
            "audio_duration": res["duration"],
            "parallel_info": {
                "workers_used": self.engine.batch_size,
                "chunks_processed": res["num_windows"],
                "parallel_efficiency": perf.get("parallel_efficiency"),
                "chunks_per_minute": perf.get("units_per_minute"),
            },
            "performance": {
                "total_time": total_time,
                "speed_factor": speed,
                "assessment": assess_performance_tier(speed),
            },
            "outputs": res.get("output_files", {}),
        }
