"""Transcript-to-speaker alignment and the meeting analysis."""

from whisper_aries_tpu_torch.analyze.conversation import ConversationAnalyzer
from whisper_aries_tpu_torch.analyze.meeting import (
    analyze_meeting,
    build_transcript_text,
    speaker_stats,
)

__all__ = [
    "ConversationAnalyzer",
    "analyze_meeting",
    "build_transcript_text",
    "speaker_stats",
]
