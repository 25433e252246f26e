"""The port's command-line tools: ``python -m
whisper_aries_tpu_torch.cli.<name>`` (transcribe, batch_transcribe,
diarize, conversation, meeting, demo, verify_setup, install_packages,
clients). Each takes its JAX counterpart's flags; the tools that run a
model take ``--device`` (default CUDA; ``--device cpu`` for the CPU)."""
