"""The transcription engine and the full pipeline."""

from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber
from whisper_aries_tpu_torch.pipeline.run import get_transcriber, run_pipeline

__all__ = ["AriesTranscriber", "get_transcriber", "run_pipeline"]
