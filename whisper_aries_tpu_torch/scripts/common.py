"""What the probes share: where a probe runs, how it is timed, how its
answer is held against the plain version, and the card's published peaks.

A probe runs on the CUDA card unless the caller passes ``device="cpu"``,
where every kernel is replaced by its plain version and nothing is timed
(a CPU run measures no device). Without a card and without
``device="cpu"`` it raises.
"""

from __future__ import annotations

import math
import subprocess
from typing import Callable, Dict

import torch

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES = 3.35e12                       # HBM3, bytes/s
PEAK_OPS = {"bf16": 989e12, "s8": 1979e12,  # tensor cores, per second
            "f32": 495e12}                 # f32 operands as TF32


def device_of(device=None) -> torch.device:
    """The device a probe runs on: the card unless ``device`` says CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"a probe runs on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probes measure a CUDA card and none is "
                           "available; pass device='cpu' for the plain "
                           "versions")
    return dev


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them (every
    rate is read beside it), or the device name where there is none."""
    if dev.type != "cuda":
        return "cpu (plain versions; nothing is timed)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        line = out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        line = ""
    return line or torch.cuda.get_device_name(dev)


def launch_ms(fn: Callable[[], object]) -> float:
    """Milliseconds of one call of ``fn`` on the card, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def best_ms(fn: Callable[[], object], reps: int = 3) -> float:
    """The best of ``reps`` timed calls after one untimed call (the TPU
    scripts take the best of three)."""
    fn()
    return min(launch_ms(fn) for _ in range(reps))


def mean_ms(fn: Callable[[], object], reps: int = 8) -> float:
    """Mean milliseconds a call over ``reps`` calls enqueued back to back,
    after one untimed call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def iterations_for(run: Callable[[int], object], n0: int,
                   target_ms: float) -> int:
    """The iteration count that makes one call of ``run(n)`` take about
    ``target_ms`` on the card: scaled from timed calls, again until a
    timed call takes at least half the target (a short call is mostly
    its launch)."""
    run(n0)  # the first call pays for loading and attributes
    n = n0
    for _ in range(4):
        ms = launch_ms(lambda: run(n))
        n_next = max(n0, math.ceil(n * target_ms / max(ms, 1e-3)))
        if ms >= 0.5 * target_ms:
            return n_next
        n = n_next
    return n


def hold(err: float, limit: float, mistakes: Dict[str, float],
         abs_err: float) -> dict:
    """An answer held against its plain version: ``err`` within ``limit``,
    and the limit below the same error of each named mistake (so the
    limit would catch it); ``abs_err`` is max |got - want| beside it."""
    ok = err <= limit and all(m > limit for m in mistakes.values())
    return dict(err=float(err), limit=float(limit),
                mistakes={k: float(v) for k, v in mistakes.items()}, ok=ok,
                abs_err=float(abs_err))


def held_detail(h: dict) -> str:
    """err, limit and each named mistake's error of a hold."""
    return f"err {h['err']:.3g} <= {h['limit']:.3g} < " + ", ".join(
        f"{k} {v:.3g}" for k, v in h["mistakes"].items())


def held_text(h: dict) -> str:
    return f"check {'ok' if h['ok'] else 'FAILED'} ({held_detail(h)})"
