"""``batch_transcribe`` — every media file of a directory through one
resident engine (the JAX package's cli/batch_transcribe.py, with its
flags and ``--device``).

    python -m whisper_aries_tpu_torch.cli.batch_transcribe DIR \\
        [--manifest m.json] [--overwrite] [--device cpu]

Outputs land next to the sources (or in ``--output-dir``). A file whose
first output format already exists is skipped unless ``--overwrite``;
``--manifest`` writes every file's result and the aggregate RTF as JSON.
The engine is built at the first file that needs it, so a rerun that
skips every file loads no model and runs nothing on the card.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

AUDIO_EXTS = {".wav", ".mp3", ".flac", ".ogg", ".m4a", ".mp4", ".mov", ".mkv",
              ".webm", ".avi"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="batch_transcribe",
        description="Transcribe every media file in a directory",
    )
    p.add_argument("directory", help="directory (searched recursively)")
    p.add_argument("--model", default="large-v3")
    p.add_argument("--language", default=None)
    p.add_argument("--beam-size", type=int, default=1)
    p.add_argument("--formats", default="txt,json")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--overwrite", action="store_true",
                   help="re-transcribe files with existing outputs")
    p.add_argument("--model-cache", default="./models")
    p.add_argument("--allow-random", action="store_true")
    p.add_argument("--manifest", default=None,
                   help="write a JSON manifest of all results here")
    p.add_argument("--device", default=None,
                   help="cuda (default), cuda:N or cpu")
    p.add_argument("--verbose", "-v", action="store_true")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    root = Path(args.directory)
    if not root.is_dir():
        print(f"not a directory: {root}", file=sys.stderr)
        return 1
    files = sorted(p for p in root.rglob("*")
                   if p.suffix.lower() in AUDIO_EXTS)
    if not files:
        print("no media files found", file=sys.stderr)
        return 1
    formats = [f.strip() for f in args.formats.split(",") if f.strip()]

    engine = None
    t0 = time.time()
    total_audio = 0.0
    manifest = []
    done = skipped = failed = 0
    for i, f in enumerate(files, 1):
        out_dir = Path(args.output_dir) if args.output_dir else f.parent
        primary = out_dir / f"{f.stem}.{formats[0]}"
        if primary.exists() and not args.overwrite:
            skipped += 1
            print(f"[{i}/{len(files)}] skip (exists): {f.name}")
            continue
        if engine is None:
            from whisper_aries_tpu_torch.pipeline.engine import (
                AriesTranscriber,
            )

            engine = AriesTranscriber(
                model_size=args.model,
                device=args.device,
                num_workers=args.workers,
                cache_dir=args.model_cache,
                allow_random=args.allow_random,
            )
        try:
            res = engine.transcribe_file(
                str(f),
                language=args.language,
                beam_size=args.beam_size,
                output_formats=formats,
                output_dir=str(out_dir),
            )
            total_audio += res["duration"]
            done += 1
            manifest.append({
                "file": str(f),
                "language": res["language"],
                "duration": res["duration"],
                "segments": len(res["segments"]),
                "rtf": res["real_time_factor"],
                "outputs": res.get("output_files", {}),
            })
            print(f"[{i}/{len(files)}] {f.name}: {res['duration']:.0f}s audio "
                  f"@ {res['real_time_factor']:.1f}x")
        except Exception as e:
            failed += 1
            manifest.append({"file": str(f), "error": str(e)})
            print(f"[{i}/{len(files)}] FAILED {f.name}: {e}", file=sys.stderr)

    wall = time.time() - t0
    agg_rtf = total_audio / wall if wall > 0 else 0.0
    print(f"\n{done} transcribed, {skipped} skipped, {failed} failed; "
          f"{total_audio:.0f}s audio in {wall:.0f}s = {agg_rtf:.1f}x realtime")
    if args.manifest:
        with open(args.manifest, "w", encoding="utf-8") as mf:
            json.dump({"results": manifest, "aggregate_rtf": agg_rtf}, mf,
                      indent=2)
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
