"""Transcript renderers."""

from whisper_aries_tpu_torch.render.renderers import (
    render_html,
    render_json,
    render_srt,
    render_txt,
    srt_timestamp,
)

__all__ = ["render_html", "render_json", "render_srt", "render_txt",
           "srt_timestamp"]
