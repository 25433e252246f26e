"""Transcript renderers."""
