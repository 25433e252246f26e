"""``diarize`` — standalone speaker diarization on the port's diarizer (the
JAX package's cli/diarize.py, with its flags and ``--device``).

    python -m whisper_aries_tpu_torch.cli.diarize audio.wav \\
        [--num-speakers 2] [--output-dir out] [--device cpu]

Writes the reference's artifacts (speaker_diarizer.py:183-206), byte for
byte the JAX tool's for the same turns: CSV ``start,end,speaker``, JSON
[{start, end, speaker}] rounded to 2 dp, TXT ``12.39s - 14.35s:
SPEAKER_01``, the unfiltered (pre-dedupe) JSON and a timestamped run log.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
from pathlib import Path
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="speaker_diarizer", description="Speaker diarization"
    )
    p.add_argument("audio", help="audio file")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--num-speakers", type=int, default=None)
    p.add_argument("--min-speakers", type=int, default=None)
    p.add_argument("--max-speakers", type=int, default=None)
    p.add_argument("--threshold", type=float, default=None,
                   help="clustering distance threshold (default: per-"
                        "backend — 0.53 neural, 0.7045 classical)")
    p.add_argument("--model-dir", default=None,
                   help="dir with segmentation/embedding safetensors")
    p.add_argument("--formats", default="csv,json,txt,unfiltered,log")
    p.add_argument("--device", default=None,
                   help="cuda (default), cuda:N or cpu")
    p.add_argument("--verbose", "-v", action="store_true")
    return p


def _turns_json(turns) -> list:
    return [{"start": round(t["start"], 2), "end": round(t["end"], 2),
             "speaker": t["speaker"]} for t in turns]


def write_outputs(turns, base: Path, formats, unfiltered=None,
                  audio_file: str = "") -> dict:
    out = {}
    if "csv" in formats:
        p = base.with_name(base.name + "_diarization.csv")
        with open(p, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["start", "end", "speaker"])
            for t in turns:
                w.writerow([f"{t['start']:.2f}", f"{t['end']:.2f}",
                            t["speaker"]])
        out["csv"] = str(p)
    if "json" in formats:
        p = base.with_name(base.name + "_diarization.json")
        with open(p, "w", encoding="utf-8") as f:
            json.dump(_turns_json(turns), f, indent=2)
        out["json"] = str(p)
    if "txt" in formats:
        p = base.with_name(base.name + "_diarization.txt")
        with open(p, "w", encoding="utf-8") as f:
            for t in turns:
                f.write(f"{t['start']:.2f}s - {t['end']:.2f}s: "
                        f"{t['speaker']}\n")
        out["txt"] = str(p)
    if "unfiltered" in formats and unfiltered is not None:
        p = base.with_name(base.name + "_diarization_unfiltered.json")
        with open(p, "w", encoding="utf-8") as f:
            json.dump(_turns_json(unfiltered), f, indent=2)
        out["unfiltered"] = str(p)
    if "log" in formats:
        import datetime

        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        p = base.parent / f"diarization_log_{stamp}.txt"
        speakers = sorted({t["speaker"] for t in turns})
        total = sum(t["end"] - t["start"] for t in turns)
        with open(p, "w", encoding="utf-8") as f:
            f.write(f"Diarization run for: {audio_file}\n")
            f.write(f"Speakers: {len(speakers)}\n")
            f.write(f"Total speech: {total:.2f}s\n")
            f.write(f"Segments: {len(turns)}\n")
            for t in turns:
                f.write(f"{t['start']:.2f}s - {t['end']:.2f}s: "
                        f"{t['speaker']}\n")
        out["log"] = str(p)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)

    from whisper_aries_tpu_torch.diarize import DiarizationPipeline

    pipe = DiarizationPipeline(model_dir=args.model_dir,
                               clustering_threshold=args.threshold,
                               device=args.device)
    turns, unfiltered = pipe(
        args.audio,
        num_speakers=args.num_speakers,
        min_speakers=args.min_speakers,
        max_speakers=args.max_speakers,
        return_unfiltered=True,
    )
    speakers = sorted({t["speaker"] for t in turns})
    print(f"{len(turns)} turns, {len(speakers)} speakers: "
          f"{', '.join(speakers)}")
    for t in turns[:20]:
        print(f"  {t['start']:.2f}s - {t['end']:.2f}s: {t['speaker']}")
    if len(turns) > 20:
        print(f"  ... {len(turns) - 20} more")

    src = Path(args.audio)
    base = ((Path(args.output_dir) / src.stem) if args.output_dir
            else src.with_suffix(""))
    if args.output_dir:
        Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    outs = write_outputs(turns, base,
                         [f.strip() for f in args.formats.split(",")],
                         unfiltered=unfiltered, audio_file=args.audio)
    for kind, path in outs.items():
        print(f"  {kind}: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
