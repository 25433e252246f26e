"""``meeting`` — the LLM meeting summary of a pipeline JSON transcript
(the JAX package's cli/meeting.py; reference meeting_analyzer.py:115-120).

    python -m whisper_aries_tpu_torch.cli.meeting transcript.json \\
        [--model NAME] [--base-url URL]

The key comes from the variable ``analyze.api_key_env`` names; without
it the analysis fails, the error goes to stderr and the exit code is 1.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="meeting_analyzer",
        description="LLM meeting summary from a pipeline JSON transcript",
    )
    p.add_argument("transcript_json")
    p.add_argument("--model", default=None, help="chat model name")
    p.add_argument("--base-url", default=None,
                   help="OpenAI-compatible API base URL")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from whisper_aries_tpu_torch.analyze.meeting import analyze_meeting
    from whisper_aries_tpu_torch.config import load_config

    cfg = load_config().analyze
    if args.model:
        cfg.model = args.model
    if args.base_url:
        cfg.base_url = args.base_url
    try:
        outs = analyze_meeting(args.transcript_json, cfg)
    except Exception as e:
        print(f"analysis failed: {e}", file=sys.stderr)
        return 1
    for kind, path in outs.items():
        print(f"{kind}: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
