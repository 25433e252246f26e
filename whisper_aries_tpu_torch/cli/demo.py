"""``demo`` — the guided end-to-end demo on the bundled sample audio (the
JAX package's cli/demo.py, with ``--device``).

    python -m whisper_aries_tpu_torch.cli.demo [audio] [--allow-random] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

SAMPLE = Path(__file__).resolve().parents[2] / "examples" / "sample_audio.wav"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="demo")
    p.add_argument("audio", nargs="?", default=str(SAMPLE))
    p.add_argument("--model", default="large-v3")
    p.add_argument("--output-dir", default="demo_outputs")
    p.add_argument("--allow-random", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (default), cuda:N or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not Path(args.audio).exists():
        print(f"sample audio missing: {args.audio} "
              "(run scripts/make_sample_audio.py)")
        return 1

    print(f"== whisper_aries_tpu_torch demo ==\ninput: {args.audio}")
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    engine = AriesTranscriber(model_size=args.model, device=args.device,
                              allow_random=args.allow_random)
    res = engine.transcribe_file(
        args.audio,
        output_formats=("txt", "json", "srt"),
        output_dir=args.output_dir,
    )
    print(f"language: {res['language']} "
          f"({(res['language_probability'] or 0) * 100:.0f}%)")
    print(f"speed: {res['real_time_factor']:.1f}x realtime")
    for seg in res["segments"][:10]:
        print(f"  [{seg['start']:6.2f} - {seg['end']:6.2f}] {seg['text']}")
    print(f"outputs: {res.get('output_files')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
