"""``conversation`` — the speaker-aware pipeline (transcribe, diarize,
align, render, the meeting analysis) through the port's ``run_pipeline``
(the JAX package's cli/conversation.py, reference
conversation_transcriber.py:187-214, with ``--device``).

    python -m whisper_aries_tpu_torch.cli.conversation audio.wav \\
        [--formats html,json,srt] [--no-llm] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

from whisper_aries_tpu_torch.config import load_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="conversation_transcriber",
        description="Speaker-aware multilingual transcription pipeline",
    )
    p.add_argument("audio_file", help="Path to audio or video file")
    p.add_argument("--output-dir", default=None, help="Directory for outputs")
    p.add_argument("--formats", default=None,
                   help="Output formats (comma-separated: html,json,srt)")
    p.add_argument("--confidence-threshold", type=float, default=None,
                   help="Min confidence for speaker assignment")
    p.add_argument("--chunk-size", type=int, default=None,
                   help="Chunk size in seconds")
    p.add_argument("--language", default=None, help="Language (auto/en/ar)")
    p.add_argument("--model", default=None, help="ASR model preset/dir")
    p.add_argument("--no-llm", action="store_true",
                   help="skip the LLM meeting analysis step")
    p.add_argument("--device", default=None,
                   help="cuda (default), cuda:N or cpu")
    p.add_argument("--verbose", "-v", action="store_true")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)

    from whisper_aries_tpu_torch.pipeline.run import run_pipeline

    cfg = load_config()
    formats = ([f.strip() for f in args.formats.split(",")]
               if args.formats else None)
    result = run_pipeline(
        audio_file=args.audio_file,
        output_dir=args.output_dir,
        formats=formats,
        confidence_threshold=args.confidence_threshold,
        chunk_size=args.chunk_size,
        language=args.language,
        run_llm_analysis=not args.no_llm,
        config=cfg,
        model_size=args.model,
        device=args.device,
    )
    if not result["success"]:
        print(f"Pipeline failed: {result.get('error', 'Unknown error')}")
        return 1
    print("Pipeline completed successfully.")
    for kind, path in result["outputs"].items():
        print(f"  {kind}: {path}")
    st = result["stats"]
    print(f"  {st['num_segments']} segments, {st['num_speakers']} speakers, "
          f"{st['total_duration']:.1f}s speech")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
