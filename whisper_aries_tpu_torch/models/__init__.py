"""Whisper, VAD and shared layers."""
