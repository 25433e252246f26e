"""``transcribe`` — single-file transcription on the port's engine (the
JAX package's cli/transcribe.py, with the same flags).

    python -m whisper_aries_tpu_torch.cli.transcribe audio.wav \\
        [--model DIR] [--beam-size 5] [--formats txt,json,srt] \\
        [--word-timestamps] [--device cpu]

``--device`` picks the card (``cuda``, ``cuda:1``; the default is CUDA,
and with no card the engine raises) or ``cpu``.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="transcribe",
        description="Whisper transcription on a CUDA card (single file)",
    )
    p.add_argument("audio", help="audio/video file to transcribe")
    p.add_argument("--model", default="large-v3",
                   help="model preset or checkpoint dir (default: large-v3)")
    p.add_argument("--device", default=None,
                   help="cuda (default), cuda:N or cpu")
    p.add_argument("--compute-type", default="bf16",
                   choices=["bf16", "f32", "int8"])
    p.add_argument("--language", default=None,
                   help="language code (default: auto-detect)")
    p.add_argument("--task", default="transcribe",
                   choices=["transcribe", "translate"])
    p.add_argument("--beam-size", type=int, default=1)
    p.add_argument("--patience", type=float, default=None,
                   help="beam patience (finished-hypothesis budget factor)")
    p.add_argument("--repetition-penalty", type=float, default=1.0)
    p.add_argument("--no-repeat-ngram-size", type=int, default=None)
    p.add_argument("--temperature", default=None,
                   help="comma-separated fallback ladder, e.g. 0.0,0.2,0.4")
    p.add_argument("--max-new-tokens", type=int, default=224)
    p.add_argument("--condition-on-previous-text", action="store_true",
                   help="sequential windows conditioned on previous text")
    p.add_argument("--workers", type=int, default=None,
                   help="windows decoded per device per step (default: "
                        "sized from the card's free memory; 8 on the CPU)")
    p.add_argument("--chunk-minutes", type=float, default=3.0)
    p.add_argument("--formats", default="txt",
                   help="comma-separated: txt,json,srt")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--word-timestamps", action="store_true")
    p.add_argument("--no-vad", action="store_true",
                   help="disable VAD filtering")
    p.add_argument("--initial-prompt", default=None)
    p.add_argument("--prefix", default=None,
                   help="force the transcript to start with this text")
    p.add_argument("--hotwords", default=None,
                   help="bias vocabulary via <|startofprev|> context "
                        "(ignored when --initial-prompt is set)")
    p.add_argument("--audio-ctx", default=None, choices=["full", "bucket"],
                   help="encoder context policy: 'bucket' encodes batches "
                        "of short (<=16s) VAD windows at a 16s context")
    p.add_argument("--model-cache", default="./models")
    p.add_argument("--resume", default=None, metavar="JOURNAL",
                   help="per-window resume journal path; rerunning after a "
                        "crash skips already-decoded windows")
    p.add_argument("--allow-random", action="store_true",
                   help="run with random weights if no checkpoint (perf tests)")
    p.add_argument("--verbose", "-v", action="store_true")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    temperature = None
    if args.temperature is not None:
        try:
            temperature = tuple(float(t) for t in
                                str(args.temperature).split(",") if t.strip())
        except ValueError:
            parser.error(
                f"--temperature must be a comma-separated list of floats, "
                f"got {args.temperature!r}")
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s",
    )
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    engine = AriesTranscriber(
        model_size=args.model,
        device=args.device,
        compute_type=args.compute_type,
        chunk_length_minutes=args.chunk_minutes,
        num_workers=args.workers,
        cache_dir=args.model_cache,
        allow_random=args.allow_random,
        audio_ctx=args.audio_ctx,
    )
    result = engine.transcribe_file(
        args.audio,
        language=args.language,
        task=args.task,
        beam_size=args.beam_size,
        patience=args.patience,
        repetition_penalty=args.repetition_penalty,
        no_repeat_ngram_size=args.no_repeat_ngram_size,
        temperature=temperature,
        max_new_tokens=args.max_new_tokens,
        condition_on_previous_text=args.condition_on_previous_text,
        output_formats=[f.strip() for f in args.formats.split(",")
                        if f.strip()],
        output_dir=args.output_dir,
        vad_filter=not args.no_vad,
        initial_prompt=args.initial_prompt,
        prefix=args.prefix,
        hotwords=args.hotwords,
        word_timestamps=args.word_timestamps,
        resume_path=args.resume,
    )
    if not result.get("success"):
        print(f"transcription failed: {result.get('error')}", file=sys.stderr)
        return 1
    print(
        f"language={result['language']} duration={result['duration']:.1f}s "
        f"wall={result['processing_time']:.1f}s "
        f"rtf={result['real_time_factor']:.1f}x "
        f"segments={len(result['segments'])}"
    )
    for fmt, path in (result.get("output_files") or {}).items():
        print(f"  {fmt}: {path}")
    if not result.get("output_files"):
        print(result["text"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
