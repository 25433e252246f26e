from whisper_aries_tpu_torch.vad.energy import get_speech_probs
from whisper_aries_tpu_torch.vad.segments import VadOptions, collect_speech_segments
from whisper_aries_tpu_torch.vad.planner import (
    Window,
    plan_chunks,
    plan_windows,
    windows_to_batch,
)

__all__ = [
    "get_speech_probs",
    "VadOptions",
    "collect_speech_segments",
    "Window",
    "plan_chunks",
    "plan_windows",
    "windows_to_batch",
]
