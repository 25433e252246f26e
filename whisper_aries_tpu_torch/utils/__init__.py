"""Checkpoint files, segment reconciliation and per-call diagnostics."""
