"""run_pipeline — the full conversation-analysis pipeline (the port of the
JAX package's pipeline/run.py).

Extract audio -> transcribe -> diarize -> align -> render (html/json/srt)
-> optional LLM meeting analysis -> stats, returning the reference
orchestrator's result dict (conversation_transcriber.py:24-184):
``{success, error, outputs, metadata, stats, aligned_segments}`` with
metadata ``{audio_file, pipeline_version, confidence_threshold, language,
total_segments}``; the JSON and SRT it writes are byte for byte the JAX
package's for the same transcript and turns.

The ASR engine and the diarizer are injectable (``transcriber=``,
``diarizer=``) and the engine is cached per process (``get_transcriber``).
A diarization failure degrades to speakerless output unless
``strict_diarization``; the meeting analysis is non-fatal (its error goes
to ``llm_analysis_error``). Device: the engine and the diarizer this
function builds run on CUDA unless ``device="cpu"``; with no card and no
explicit CPU they raise.
"""

from __future__ import annotations

import logging
import os
import threading
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from whisper_aries_tpu_torch.analyze.conversation import ConversationAnalyzer
from whisper_aries_tpu_torch.analyze.meeting import analyze_meeting
from whisper_aries_tpu_torch.config import AriesConfig, load_config
from whisper_aries_tpu_torch.render.renderers import (
    render_html,
    render_json,
    render_srt,
)
from whisper_aries_tpu_torch.utils.device import resolve_device
from whisper_aries_tpu_torch.utils.media import extract_audio_if_needed

log = logging.getLogger(__name__)

_ENGINE_CACHE: Dict[str, Any] = {}
_ENGINE_CACHE_LOCK = threading.Lock()


def get_transcriber(model_size: str = "large-v3",
                    device: Optional[str] = None, **kwargs):
    """Process-wide engine cache: one resident model per (size, device,
    options). ``device`` None means CUDA. Every caller in the process, in
    any thread, gets the same engine; its ``transcribe_file`` runs one call
    at a time on the card (the engine's card lock)."""
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    key = f"{model_size}:{device}:{sorted(kwargs.items())!r}"
    with _ENGINE_CACHE_LOCK:
        if key not in _ENGINE_CACHE:
            _ENGINE_CACHE[key] = AriesTranscriber(model_size=model_size,
                                                  device=device, **kwargs)
        return _ENGINE_CACHE[key]


def run_pipeline(
    audio_file: str,
    output_dir: Optional[str] = None,
    formats: Optional[Sequence[str]] = None,
    confidence_threshold: Optional[float] = None,
    chunk_size: Optional[int] = None,
    language: Optional[str] = None,
    run_llm_analysis: bool = True,
    config: Optional[AriesConfig] = None,
    transcriber=None,
    diarizer=None,
    strict_diarization: bool = False,
    model_size: Optional[str] = None,
    resume_path: Optional[str] = None,
    device: Optional[str] = None,
) -> Dict[str, Any]:
    """Run the pipeline on ``audio_file``; returns the result dict. The
    arguments are the JAX package's, with ``device`` for the engine and the
    diarizer built here (None: CUDA)."""
    if transcriber is None or diarizer is None:
        # the device rule holds before the catch-all below: without a card
        # and without device="cpu" this raises
        resolve_device(device, "run_pipeline")
    cfg = config or load_config()
    output_dir = output_dir or cfg.pipeline.output_dir
    formats = list(formats or cfg.pipeline.output_formats)
    confidence_threshold = (
        confidence_threshold
        if confidence_threshold is not None
        else cfg.pipeline.confidence_threshold
    )
    language = language if language is not None else cfg.decode.language
    if language in ("auto", ""):
        language = None
    os.makedirs(output_dir, exist_ok=True)

    result: Dict[str, Any] = {
        "success": False,
        "error": None,
        "outputs": {},
        "metadata": {},
        "stats": {},
    }

    try:
        # --- [0] audio extraction (video containers etc.) ------------------
        audio_for_processing = extract_audio_if_needed(audio_file)
        temp_created = audio_for_processing != audio_file

        try:
            # --- [1] transcription -----------------------------------------
            if transcriber is None:
                transcriber = get_transcriber(
                    model_size or cfg.model.name,
                    compute_type=cfg.model.compute_type,
                    cache_dir=cfg.model.cache_dir,
                    config=cfg,
                    device=device,
                )
            tres = transcriber.transcribe_file(
                audio_for_processing,
                language=language,
                # reference contract: chunk_size (seconds) selects the
                # fixed-chunk plan at that length (conversation_transcriber
                # .py:24-50 / config.py:25)
                chunk_size=chunk_size,
                beam_size=cfg.decode.beam_size,
                repetition_penalty=cfg.decode.repetition_penalty,
                condition_on_previous_text=cfg.decode.condition_on_previous_text,
                word_timestamps=cfg.decode.word_timestamps,
                initial_prompt=cfg.decode.initial_prompt,
                suppress_tokens=cfg.decode.suppress_tokens,
                without_timestamps=cfg.decode.without_timestamps,
                max_initial_timestamp=cfg.decode.max_initial_timestamp,
                prompt_reset_on_temperature=(
                    cfg.decode.prompt_reset_on_temperature),
                multilingual=cfg.decode.multilingual,
                output_formats=[],
                resume_path=resume_path,
            )
            if not tres.get("success"):
                result["error"] = f"Transcription failed: {tres.get('error')}"
                return result
            transcription_segments = tres["segments"]
            detected_language = tres.get("language") or language

            # --- [2] diarization -------------------------------------------
            diarization_segments: List[Dict[str, Any]] = []
            if diarizer is None:
                from whisper_aries_tpu_torch.diarize import DiarizationPipeline

                diarizer = DiarizationPipeline(
                    clustering_threshold=cfg.diarize.clustering_threshold,
                    device=device,
                )
            try:
                diarization_segments = diarizer(
                    audio_for_processing,
                    min_speakers=cfg.diarize.min_speakers,
                    max_speakers=cfg.diarize.max_speakers,
                )
            except Exception as e:
                if strict_diarization:
                    raise
                log.warning("diarization failed (%s); continuing single-speaker", e)
                result["diarization_error"] = str(e)
        finally:
            if temp_created:
                try:
                    os.remove(audio_for_processing)
                except OSError as e:
                    log.warning("could not remove temp audio: %s", e)

        # --- [3] alignment --------------------------------------------------
        analyzer = ConversationAnalyzer(confidence_threshold=confidence_threshold)
        aligned = analyzer.analyze(transcription_segments, diarization_segments)
        # drop engine-internal keys so the output contract matches the goldens
        aligned = [
            {k: s[k] for k in ("text", "start", "end", "speaker", "confidence")}
            for s in aligned
        ]

        # --- [4] outputs -----------------------------------------------------
        metadata = {
            "audio_file": audio_file,
            "pipeline_version": cfg.pipeline.pipeline_version,
            "confidence_threshold": confidence_threshold,
            "language": detected_language or "auto",
            "total_segments": len(aligned),
        }
        base = Path(audio_file).stem
        output_paths: Dict[str, str] = {}

        if "html" in formats:
            p = os.path.join(output_dir, f"{base}.html")
            # the HTML renderer's RTL support keys off seg['lang'] == 'ar'
            # (conversation_renderer.py:29-30) but the reference pipeline
            # never sets it; inject the detected language here (the JSON
            # contract keeps its exact 5-key segments).
            html_segments = aligned
            if detected_language == "ar":
                html_segments = [{**s, "lang": "ar"} for s in aligned]
            render_html(html_segments, p, metadata)
            output_paths["html"] = p
        if "json" in formats:
            p = os.path.join(output_dir, f"{base}.json")
            render_json(aligned, p, metadata)
            output_paths["json"] = p
            # --- [5] LLM meeting analysis (non-fatal) -----------------------
            if run_llm_analysis:
                try:
                    summary_paths = analyze_meeting(p, cfg.analyze)
                    output_paths["meeting_summary_txt"] = summary_paths["txt"]
                    output_paths["meeting_summary_html"] = summary_paths["html"]
                except Exception as e:
                    log.warning("LLM meeting analysis failed: %s", e)
                    result["llm_analysis_error"] = str(e)
        if "srt" in formats:
            p = os.path.join(output_dir, f"{base}.srt")
            render_srt(aligned, p)
            output_paths["srt"] = p

        # --- stats -----------------------------------------------------------
        speaker_durations: Dict[Any, float] = defaultdict(float)
        total_duration = 0.0
        for seg in aligned:
            d = seg.get("end", 0) - seg.get("start", 0)
            speaker_durations[seg.get("speaker", "Unknown")] += d
            total_duration += d
        stats = {
            "total_duration": total_duration,
            "num_speakers": len(speaker_durations),
            "num_segments": len(aligned),
            "speaker_durations": dict(speaker_durations),
            "real_time_factor": tres.get("real_time_factor"),
        }

        result.update(
            {
                "success": True,
                "outputs": output_paths,
                "metadata": metadata,
                "stats": stats,
                "aligned_segments": aligned,
            }
        )
        return result

    except Exception as e:
        log.exception("pipeline failed")
        result["error"] = str(e)
        return result
