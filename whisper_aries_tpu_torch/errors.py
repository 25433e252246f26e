"""Error taxonomy for the pipeline.

Mirrors the reference's error classes (reference: utils.py:18-28) so callers can
catch the same hierarchy: ConversationError is the base, with stage-specific
subclasses raised by the transcription and diarization stages.
"""

from __future__ import annotations


class ConversationError(Exception):
    """Base error for all pipeline failures."""


class AudioError(ConversationError):
    """Audio decode / extraction / resample failure."""


class TranscriptionError(ConversationError):
    """ASR engine failure."""


class DiarizationError(ConversationError):
    """Speaker-diarization failure."""


class AlignmentError(ConversationError):
    """Transcript <-> speaker alignment failure."""


class ServingError(ConversationError):
    """Job-server failure."""
