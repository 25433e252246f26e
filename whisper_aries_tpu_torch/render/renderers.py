"""Output renderers: TXT, JSON, SRT, HTML.

A copy of the JAX package's render/renderers.py (the port imports nothing
of that package), byte-compatible with the reference's output contracts:
  * JSON: {"segments": [...], "metadata": {...}}, indent=2, ensure_ascii=False
    (reference: conversation_renderer.py:38-47).
  * SRT: index / "HH:MM:SS,mmm --> HH:MM:SS,mmm" / "[SPEAKER] text" / blank,
    millisecond field truncated not rounded (conversation_renderer.py:50-69);
    the engine-level SRT variant omits the speaker tag
    (final_optimized_transcriber.py:594-597).
  * HTML: 6-colour speaker palette, RTL direction for Arabic segments,
    metadata <pre> block, per-segment "[start-end s, conf=..]" badge
    (conversation_renderer.py:14-33).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

SPEAKER_COLOR_PALETTE = [
    "#4F8EF7",
    "#F78E4F",
    "#4FF78E",
    "#F74F8E",
    "#8E4FF7",
    "#F7F74F",
]


def srt_timestamp(seconds: float) -> str:
    """Format seconds as ``HH:MM:SS,mmm`` with truncating millisecond math
    (matches the goldens: 3.589.. -> 00:00:03,589)."""
    seconds = max(0.0, float(seconds))
    h = int(seconds // 3600)
    m = int((seconds % 3600) // 60)
    s = int(seconds % 60)
    ms = int((seconds - int(seconds)) * 1000)
    return f"{h:02}:{m:02}:{s:02},{ms:03}"


def render_txt(
    segments: List[Dict[str, Any]],
    output_path: Optional[str] = None,
    include_speaker: bool = False,
) -> str:
    """Plain-text transcript, one segment per line."""
    lines = []
    for seg in segments:
        if include_speaker and seg.get("speaker") is not None:
            lines.append(f"[{seg['speaker']}] {seg['text'].strip()}")
        else:
            lines.append(seg["text"].strip())
    text = "\n".join(lines) + ("\n" if lines else "")
    if output_path:
        with open(output_path, "w", encoding="utf-8") as f:
            f.write(text)
    return text


def render_json(
    segments: List[Dict[str, Any]],
    output_path: Optional[str] = None,
    metadata: Optional[Dict[str, Any]] = None,
) -> str:
    """Aligned-conversation JSON: {"segments": [...], "metadata": {...}}."""
    out = {"segments": segments, "metadata": metadata or {}}
    text = json.dumps(out, indent=2, ensure_ascii=False)
    if output_path:
        with open(output_path, "w", encoding="utf-8") as f:
            f.write(text)
    return text


def render_srt(
    segments: List[Dict[str, Any]],
    output_path: Optional[str] = None,
    include_speaker: bool = True,
) -> str:
    """SubRip subtitles. ``include_speaker=True`` emits "[SPEAKER_xx] text"
    payload lines like the pipeline renderer; ``False`` matches the bare
    engine-level SRT."""
    lines: List[str] = []
    for i, seg in enumerate(segments, 1):
        lines.append(str(i))
        lines.append(f"{srt_timestamp(seg['start'])} --> {srt_timestamp(seg['end'])}")
        text = seg["text"].strip()
        if include_speaker:
            # The reference writes the raw value: a missing key renders as
            # "Unknown" but an explicit null speaker renders as "None"
            # (conversation_renderer.py:64; confirmed by the meeting-recording
            # golden SRT which contains "[None]" lines).
            speaker = seg.get("speaker", "Unknown")
            lines.append(f"[{speaker}] {text}")
        else:
            lines.append(text)
        lines.append("")
    body = "\n".join(lines)
    if output_path:
        with open(output_path, "w", encoding="utf-8") as f:
            f.write(body)
    return body


def render_html(
    segments: List[Dict[str, Any]],
    output_path: Optional[str] = None,
    metadata: Optional[Dict[str, Any]] = None,
) -> str:
    """Speaker-colour-coded HTML transcript with RTL support for Arabic."""
    speaker_colors: Dict[Any, str] = {}
    html = [
        "<html><head><meta charset='utf-8'>"
        "<title>Conversation Transcript</title></head><body>"
    ]
    html.append("<h2>Conversation Transcript</h2>")
    if metadata:
        html.append(f"<pre>{json.dumps(metadata, indent=2, ensure_ascii=False)}</pre>")
    for seg in segments:
        speaker = seg.get("speaker", "Unknown")
        if speaker not in speaker_colors:
            speaker_colors[speaker] = SPEAKER_COLOR_PALETTE[
                len(speaker_colors) % len(SPEAKER_COLOR_PALETTE)
            ]
        color = speaker_colors[speaker]
        rtl = "dir='rtl'" if seg.get("lang", "auto") == "ar" else ""
        conf = seg.get("confidence", 1.0)
        html.append(
            f"<div style='margin:8px 0;'>"
            f"<span style='color:{color};font-weight:bold;'>{speaker}</span> "
            f"<span style='font-size:smaller;color:#888;'>"
            f"[{seg['start']:.2f}-{seg['end']:.2f}s, conf={conf:.2f}]</span>"
            f"<br><span {rtl}>{seg['text']}</span></div>"
        )
    html.append("</body></html>")
    text = "\n".join(html)
    if output_path:
        with open(output_path, "w", encoding="utf-8") as f:
            f.write(text)
    return text


RENDERERS = {
    "txt": render_txt,
    "json": render_json,
    "srt": render_srt,
    "html": render_html,
}
