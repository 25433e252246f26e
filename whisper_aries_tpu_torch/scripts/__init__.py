"""Hardware probes of the card, the counterparts of the TPU probes in the
repository's ``scripts/``: each module asks the H100 what its TPU script
asked the TPU, through a CUDA kernel of ``csrc/``, and holds every answer
against the kernel's plain version. Run one as
``python -m whisper_aries_tpu_torch.scripts.<module>``."""
