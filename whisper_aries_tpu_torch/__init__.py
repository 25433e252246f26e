"""whisper_aries_tpu_torch — the PyTorch / CUDA port of whisper_aries_tpu.

Runs the system — long-form transcription (greedy, beam search, int8,
word timestamps, conditioned decoding with a resume journal), diarization
and the full ``run_pipeline`` (align, render, analyse), and training (the
Whisper fine-tuning step and the diarizer's trainers) — on an NVIDIA
Hopper card, with the JAX package's Pallas kernels rewritten as CUDA
kernels (csrc/). It imports nothing of the JAX package; its tests hold it
against that package on the CPU.
"""

__version__ = "0.1.0"

from whisper_aries_tpu_torch.config import AriesConfig, load_config
from whisper_aries_tpu_torch.errors import (
    AlignmentError,
    AudioError,
    ConversationError,
    DiarizationError,
    ServingError,
    TranscriptionError,
)
