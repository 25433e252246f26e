"""Evaluation metrics: DER and WER."""

from whisper_aries_tpu_torch.eval.der import diarization_error_rate
from whisper_aries_tpu_torch.eval.wer import (
    normalize_text,
    wer,
    word_error_details,
)

__all__ = ["diarization_error_rate", "normalize_text", "wer",
           "word_error_details"]
