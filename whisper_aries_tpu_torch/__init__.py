"""whisper_aries_tpu_torch — the PyTorch / CUDA port of whisper_aries_tpu.

Runs the system's main path — greedy long-form transcription of a WAV file
with the learned VAD, the log-mel front-end, the Whisper encoder and the
int8 decode — on an NVIDIA Hopper card, with the JAX package's three Pallas
kernels on that path rewritten as CUDA kernels (csrc/). It imports nothing
of the JAX package; its tests hold it against that package on the CPU.
"""

__version__ = "0.1.0"
