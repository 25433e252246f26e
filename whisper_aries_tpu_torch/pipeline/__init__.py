"""The transcription engine, the full pipeline and Whisper fine-tuning."""

from whisper_aries_tpu_torch.pipeline.engine import (
    AriesTranscriber,
    OptimizedParallelTranscriber,
)
from whisper_aries_tpu_torch.pipeline.run import get_transcriber, run_pipeline

__all__ = [
    "AriesTranscriber",
    "OptimizedParallelTranscriber",
    "get_transcriber",
    "run_pipeline",
]
