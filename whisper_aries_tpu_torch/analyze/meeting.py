"""LLM meeting analytics: summary, action items, per-speaker stats (the
port's copy of the JAX package's analyze/meeting.py).

Feature-parity port of the reference meeting analyzer
(meeting_analyzer.py:28-113): builds a "[SPEAKER] start-end: text"
transcript, computes per-speaker talk time (seconds + percent), sends a
7-task analysis prompt to an OpenAI-compatible chat API (gpt-4o,
max_tokens=8192, temperature=0.3), and writes ``.meeting_summary.txt`` /
``.meeting_summary.html`` next to the input JSON. Degrades gracefully when
no API key is configured (reference: meeting_analyzer.py:17-26).

Implementation notes: the HTTP call uses ``requests`` directly against the
``/chat/completions`` endpoint (configurable base_url -> works with any
OpenAI-compatible server), so no vendor SDK is required.
"""

from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

from whisper_aries_tpu_torch.config import AnalyzeConfig

log = logging.getLogger(__name__)

SYSTEM_PROMPT = (
    "You are an expert AI meeting and interview assistant. Always provide "
    "detailed, structured, and actionable insights for interviews, business "
    "meetings, and conversations."
)

# Seven analysis tasks, matching the reference prompt's coverage
# (meeting_analyzer.py:28-40): summary, action items, per-speaker stats,
# questions/topics, interview extraction, meeting decisions, structure.
ANALYSIS_PROMPT = """Analyze the conversation transcript below (speaker labels and timestamps included) and produce:
1. A detailed summary covering the key points, decisions made, and important context.
2. A complete list of action items, tasks, and follow-ups that were discussed.
3. Per-speaker talk time (seconds and percentage of the total) together with a summary of each speaker's main contributions and questions.
4. The important questions, issues, and topics that came up.
5. If the conversation is an interview: the candidate's strengths, weaknesses, and a hiring recommendation.
6. If it is a business meeting: the decisions, blockers, and next steps.
7. Structure the whole answer with clear sections and bullet points, as detailed as the transcript supports.

Transcript:
{transcript}
"""


def load_transcript(json_path: str) -> List[Dict[str, Any]]:
    with open(json_path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return data["segments"] if "segments" in data else data


def build_transcript_text(segments: List[Dict[str, Any]]) -> str:
    """"[SPEAKER] start-end: text" lines (meeting_analyzer.py:47-55)."""
    lines = []
    for seg in segments:
        speaker = seg.get("speaker", "Unknown")
        lines.append(
            f"[{speaker}] {seg.get('start', 0):.2f}-{seg.get('end', 0):.2f}: "
            f"{seg.get('text', '')}"
        )
    return "\n".join(lines)


def speaker_stats(segments: List[Dict[str, Any]]) -> Dict[Any, Dict[str, float]]:
    """Per-speaker talk time in seconds and percent
    (meeting_analyzer.py:57-65)."""
    stats: Dict[Any, float] = defaultdict(float)
    total = 0.0
    for seg in segments:
        d = seg.get("end", 0) - seg.get("start", 0)
        stats[seg.get("speaker", "Unknown")] += d
        total += d
    return {
        s: {"seconds": t, "percent": (t / total * 100 if total else 0.0)}
        for s, t in stats.items()
    }


def call_llm(prompt: str, cfg: Optional[AnalyzeConfig] = None,
             api_key: Optional[str] = None) -> str:
    """POST to an OpenAI-compatible /chat/completions endpoint."""
    cfg = cfg or AnalyzeConfig()
    api_key = api_key or os.environ.get(cfg.api_key_env)
    if not api_key:
        raise RuntimeError(
            f"LLM analysis needs an API key in ${cfg.api_key_env}"
        )
    import requests

    resp = requests.post(
        cfg.base_url.rstrip("/") + "/chat/completions",
        headers={"Authorization": f"Bearer {api_key}"},
        json={
            "model": cfg.model,
            "messages": [
                {"role": "system", "content": SYSTEM_PROMPT},
                {"role": "user", "content": prompt},
            ],
            "max_tokens": cfg.max_tokens,
            "temperature": cfg.temperature,
        },
        timeout=120,
    )
    resp.raise_for_status()
    return resp.json()["choices"][0]["message"]["content"]


def save_results(base_path: Path, summary: str,
                 stats: Dict[Any, Dict[str, float]]) -> Dict[str, str]:
    """Write .meeting_summary.txt / .html (meeting_analyzer.py:86-103)."""
    txt_path = base_path.with_suffix(".meeting_summary.txt")
    html_path = base_path.with_suffix(".meeting_summary.html")
    with open(txt_path, "w", encoding="utf-8") as f:
        f.write(summary)
        f.write("\n\nSpeaker Stats:\n")
        for s, v in stats.items():
            f.write(f"{s}: {v['seconds']:.1f}s ({v['percent']:.1f}%)\n")
    html = [
        "<html><head><meta charset='utf-8'><title>Meeting Summary</title>"
        "</head><body>",
        "<h2>Meeting Summary</h2>",
        f"<pre>{summary}</pre>",
        "<h3>Speaker Stats</h3><ul>",
    ]
    for s, v in stats.items():
        html.append(f"<li><b>{s}</b>: {v['seconds']:.1f}s ({v['percent']:.1f}%)</li>")
    html.append("</ul></body></html>")
    with open(html_path, "w", encoding="utf-8") as f:
        f.write("\n".join(html))
    return {"txt": str(txt_path), "html": str(html_path)}


def analyze_meeting(json_path: str, cfg: Optional[AnalyzeConfig] = None,
                    llm=call_llm) -> Dict[str, str]:
    """Full analysis of a pipeline JSON transcript (meeting_analyzer.py:106).

    ``llm`` is injectable for tests/offline use.
    """
    segments = load_transcript(json_path)
    transcript = build_transcript_text(segments)
    stats = speaker_stats(segments)
    summary = llm(ANALYSIS_PROMPT.format(transcript=transcript), cfg)
    return save_results(Path(json_path), summary, stats)
