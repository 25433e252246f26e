"""HuggingFace token resolution (the port's copy of the JAX package's
utils/auth.py; reference speaker_diarizer.py:20-67).

The same order: the environment (HF_TOKEN, then HUGGING_FACE_HUB_TOKEN),
then ~/.hf_token, then an interactive prompt only when asked for (a prompt
could block a server mid-job)."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

TOKEN_FILE = Path.home() / ".hf_token"


def get_hf_token(interactive: bool = False, save: bool = True
                 ) -> Optional[str]:
    for env in ("HF_TOKEN", "HUGGING_FACE_HUB_TOKEN"):
        tok = os.environ.get(env)
        if tok:
            return tok.strip()
    if TOKEN_FILE.exists():
        tok = TOKEN_FILE.read_text(encoding="utf-8").strip()
        if tok:
            return tok
    if interactive:
        try:
            tok = input("HuggingFace token (for gated checkpoints): ").strip()
        except EOFError:
            return None
        if tok:
            if save:
                TOKEN_FILE.write_text(tok, encoding="utf-8")
                TOKEN_FILE.chmod(0o600)
            return tok
    return None
