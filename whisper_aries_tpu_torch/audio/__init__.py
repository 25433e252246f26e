"""Audio decode and the log-mel front-end."""

from whisper_aries_tpu_torch.audio.decode import (
    SAMPLE_RATE,
    AudioPreloader,
    decode_wav_bytes,
    load_audio,
    resample,
    write_wav,
)
from whisper_aries_tpu_torch.audio.mel import (
    HOP_LENGTH,
    N_FFT,
    N_FRAMES,
    N_SAMPLES,
    log_mel_spectrogram,
    log_mel_spectrogram_np,
    mel_filterbank,
    pad_or_trim,
)

__all__ = [
    "SAMPLE_RATE",
    "AudioPreloader",
    "decode_wav_bytes",
    "load_audio",
    "resample",
    "write_wav",
    "HOP_LENGTH",
    "N_FFT",
    "N_FRAMES",
    "N_SAMPLES",
    "log_mel_spectrogram",
    "log_mel_spectrogram_np",
    "mel_filterbank",
    "pad_or_trim",
]
