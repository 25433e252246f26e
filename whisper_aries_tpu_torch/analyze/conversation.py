"""ConversationAnalyzer (the port's copy of the JAX package's
analyze/conversation.py) — transcript/diarization alignment with a
configurable confidence threshold (reference: conversation_analyzer.py:15-43;
wraps failures in ConversationError the same way)."""

from __future__ import annotations

from typing import Any, Dict, List

from whisper_aries_tpu_torch.errors import AlignmentError
from whisper_aries_tpu_torch.utils.segments import align_segments


class ConversationAnalyzer:
    def __init__(self, confidence_threshold: float = 0.7):
        self.confidence_threshold = confidence_threshold

    def analyze(
        self,
        transcription_segments: List[Dict[str, Any]],
        diarization_segments: List[Dict[str, Any]],
    ) -> List[Dict[str, Any]]:
        try:
            return align_segments(
                transcription_segments,
                diarization_segments,
                confidence_threshold=self.confidence_threshold,
            )
        except Exception as e:
            raise AlignmentError(f"alignment failed: {e}") from e
