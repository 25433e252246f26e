"""The transcription engine."""
