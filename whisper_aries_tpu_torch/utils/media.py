"""Host-side media handling (the port's copy of the JAX package's
utils/media.py): extracting an ASR-ready audio track from arbitrary
containers.

Container/video demux is genuinely host work, so like the reference
(utils.py:96-130) this shells out to ffmpeg for anything that is not already
a supported audio file, producing a 16 kHz mono pcm_s16le WAV temp file and
validating the output size. When ffmpeg is absent we fail with the same
actionable error the reference raises (utils.py:107-108).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

from whisper_aries_tpu_torch.errors import AudioError

SUPPORTED_AUDIO_EXTS = {".wav", ".mp3", ".flac", ".ogg", ".m4a"}


def extract_audio_if_needed(
    input_path: str,
    preferred_ext: str = ".wav",
    temp_dir: Optional[str] = None,
) -> str:
    """Return a path to a decodable audio file for ``input_path``.

    Already-supported audio extensions pass through unchanged; anything else
    (video containers, exotic codecs) is demuxed+resampled by ffmpeg to a
    16 kHz mono WAV temp file. The caller owns deleting the temp file when the
    returned path differs from the input.
    """
    ext = Path(input_path).suffix.lower()
    if ext in SUPPORTED_AUDIO_EXTS:
        return input_path

    if not shutil.which("ffmpeg"):
        raise AudioError(
            "ffmpeg is required for audio extraction but was not found in PATH."
        )

    temp_dir = temp_dir or tempfile.gettempdir()
    fd, tmp_path = tempfile.mkstemp(suffix=preferred_ext, dir=temp_dir)
    os.close(fd)
    cmd = [
        "ffmpeg", "-y", "-i", input_path,
        "-vn",
        "-acodec", "pcm_s16le",
        "-ar", "16000",
        "-ac", "1",
        tmp_path,
    ]
    try:
        subprocess.run(cmd, capture_output=True, check=True)
        if not os.path.exists(tmp_path) or os.path.getsize(tmp_path) < 1024:
            raise AudioError(f"Audio extraction produced no usable output: {tmp_path}")
        return tmp_path
    except Exception as e:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        stderr = getattr(e, "stderr", b"") or b""
        raise AudioError(
            f"ffmpeg audio extraction failed: {e}\n{stderr.decode(errors='ignore')}"
        ) from e
