"""Write examples/sample_audio.wav: a small synthetic two-voice clip.

The counterpart of the JAX repo's ``scripts/make_sample_audio.py``: the
same samples and the same WAV bytes (the port's ``audio/decode.py::
write_wav``), so the checked-in file can be made again by either.

    python -m whisper_aries_tpu_torch.scripts.make_sample_audio [out.wav]
        [--device cpu]

``out.wav`` defaults to the repository's examples/sample_audio.wav. The
samples are numpy's float32 arithmetic on the host, as the JAX script's:
nothing here runs on the card, whose sine would round otherwise. It takes
``--device`` as every tool does, and without a card and without
``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from whisper_aries_tpu_torch.audio.decode import write_wav
from whisper_aries_tpu_torch.utils.device import resolve_device

SR = 16000
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "examples" / \
    "sample_audio.wav"


def voice(f0, formant, spans, total_s, seed) -> np.ndarray:
    """A harmonic voice at ``f0`` shaped by one formant, sounding in
    ``spans`` (seconds) over a floor of seeded noise."""
    rng = np.random.default_rng(seed)
    n = int(total_s * SR)
    t = np.arange(n) / SR
    x = 0.002 * rng.standard_normal(n).astype(np.float32)
    for s, e in spans:
        m = (t >= s) & (t < e)
        tm = t[m]
        v = sum(
            (1.0 / (1 + abs(k * f0 - formant) / 300.0))
            * np.sin(2 * np.pi * k * f0 * tm + k)
            for k in range(1, 12)
        )
        env = 0.55 + 0.45 * np.sin(2 * np.pi * 3.0 * tm + seed)
        x[m] += (0.22 * v / 3.0 * env).astype(np.float32)
    return x


def sample_audio() -> np.ndarray:
    """The clip's 12 s: two voices taking turns."""
    a = voice(115, 550, [(0.5, 3.5), (7.0, 9.5)], 12.0, seed=1)
    b = voice(265, 2300, [(4.0, 6.5), (10.0, 11.5)], 12.0, seed=2)
    return a + b


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device, "make_sample_audio")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    write_wav(str(out), sample_audio(), SR)
    print(f"wrote {out} ({out.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
