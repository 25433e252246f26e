"""Batched against per-window transposes on the card: the counterpart of
the TPU probe ``scripts/probe_batched_transpose.py`` (``make``: out
(D, KP) f32 = the sum over 64 repetitions of every window's transpose of
x + i, the "batched" variant by one batched swapaxes and a sum over
windows, the "perwin" variant by 36 2-D transposes).

The TPU probe asked whether Mosaic lowers a batched minor-dims transpose
and what it costs against per-window ones. Here (``csrc/probe_transpose.cu``)
a block owns 16 columns of D and reads its slab of x once; each warp
holds one row k of every window as tensor-core fragments and, for its
share of the repetitions, adds i with packed bf16 adds and sums 16
windows at a time in one product by ones (f32 sums). "batched" rounds
each repetition's window sum once to bf16, "perwin" adds every window in
f32. Unlike the TPU probe (whose accumulator scratch is never zeroed) the
accumulator starts at zero.

    python -m whisper_aries_tpu_torch.scripts.probe_batched_transpose
        [--device cpu]

Prints the TPU script's two lines for each variant: the sum of the first
call's output, then ms per call and us per sweep of all 36 windows.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import time
from typing import Dict

import numpy as np
import torch

from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.scripts import common

Bw, KP, D = 36, 8, 3840
REPS = 64   # transposes per call
MAX_REPS = 256  # the kernel's offsets i are exact in bf16 below this
VARIANTS = {"batched": 1, "perwin": 0}


def transpose_sum_plain(x: torch.Tensor, variant: str, reps: int = REPS,
                        windows: int = Bw, start: int = 0) -> torch.Tensor:
    """x (windows * KP', D) bf16 -> (D, KP') f32 from zero: for each
    repetition i in [start, start + reps), h = x + i in bf16; "batched"
    adds bf16(sum over windows of h_w in f32) transposed, "perwin" adds
    each h_w transposed in f32, in window order."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {list(VARIANTS)}")
    kp, d = x.shape[0] // windows, x.shape[1]
    acc = torch.zeros((d, kp), dtype=torch.float32, device=x.device)
    for i in range(start, start + reps):
        h = (x + i).view(windows, kp, d)
        if variant == "batched":
            acc += h.float().sum(0).to(torch.bfloat16).float().T
        else:
            for w in range(windows):
                acc += h[w].float().T
    return acc


def window_sum_steps(x: torch.Tensor, reps: int = REPS,
                     windows: int = Bw) -> torch.Tensor:
    """(D, KP) f32: the sum over repetitions of one bf16 step of the window
    sum |sum over w of (x_w + i)| (the limit of a variant's error: a window
    sum taken in another order may round to the neighbouring bf16 value
    once a repetition)."""
    kp, d = x.shape[0] // windows, x.shape[1]
    out = torch.zeros((d, kp), dtype=torch.float32, device=x.device)
    for i in range(reps):
        s = (x + i).view(windows, kp, d).float().sum(0).abs().T
        exp = torch.frexp(s.clamp_min(2.0 ** -120))[1]
        out += torch.ldexp(torch.ones_like(s), exp - 8)
    return out


def named_mistakes(x: torch.Tensor, variant: str,
                   reps: int = REPS) -> Dict[str, torch.Tensor]:
    """The plain version with a mistake a kernel could make: a window, a
    repetition (the kernel splits them into groups) or the offsets
    (i + 1 for i) wrong."""
    return {
        "last window dropped": transpose_sum_plain(x[:-KP], variant, reps,
                                                   Bw - 1),
        "last repetition dropped": transpose_sum_plain(x, variant, reps - 1),
        "offsets one too high": transpose_sum_plain(x, variant, reps,
                                                    start=1)}


def hold_transpose(got: torch.Tensor, x: torch.Tensor, variant: str,
                   reps: int = REPS) -> dict:
    """The kernel against the plain version, elementwise within one bf16
    step of the window sum a repetition (``window_sum_steps``); the limit
    lies below the error of each of ``named_mistakes``."""
    want = transpose_sum_plain(x, variant, reps)
    steps = window_sum_steps(x, reps)

    def err(y):
        return float(((y - want).abs() / steps).max())

    return common.hold(err(got), 1.0,
                       {k: err(y) for k, y in
                        named_mistakes(x, variant, reps).items()},
                       float((got - want).abs().max()))


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _transpose_fn():
    fn = cb.library("probe_transpose").aries_probe_transpose
    fn.argtypes = [_P, _I, _I, _I, _I, _I, _P, _P]
    fn.restype = _I
    return fn


def transpose_sum_kernel(x: torch.Tensor, variant: str,
                         reps: int = REPS) -> torch.Tensor:
    """The kernel on CUDA x (Bw * KP, D) bf16: (D, KP) f32; 0 < reps <=
    256 (every offset exact in bf16)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {list(VARIANTS)}")
    if not 0 < reps <= MAX_REPS:
        raise ValueError(f"reps must be in 1..{MAX_REPS}, got {reps}")
    cb.require(x, "x", torch.bfloat16, (Bw * KP, D))
    out = torch.empty((D, KP), dtype=torch.float32, device=x.device)
    cb.launch(_transpose_fn(), x, "probe transpose kernel", cb.ptr(x), Bw,
              KP, D, reps, VARIANTS[variant], cb.ptr(out))
    cb.count(transpose_sum_kernel)
    return out


transpose_sum_kernel.launches = 0


def make(variant: str, device=None):
    """scripts/probe_batched_transpose.py's ``make``: a function of x
    (Bw * KP, D) bf16 giving (D, KP) f32."""
    dev = common.device_of(device)
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {list(VARIANTS)}")

    def run(x) -> torch.Tensor:
        x = torch.as_tensor(x).to(dev).contiguous()
        if dev.type == "cpu":
            return transpose_sum_plain(x, variant)
        return transpose_sum_kernel(x, variant)

    return run


def inputs(dev: torch.device, seed: int = 0) -> torch.Tensor:
    """x (Bw * KP, D) bf16, N(0, 1) from numpy, as the TPU script makes it."""
    x = np.random.default_rng(seed).standard_normal((Bw * KP, D))
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).to(dev)


def main(argv=None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    print(f"device={common.card_line(dev)}", flush=True)
    x = inputs(dev)
    results = {}
    for variant in VARIANTS:
        run = make(variant, dev)
        t0 = time.time()
        y = run(x)
        res = dict(variant=variant, sum=float(y.double().sum()))
        print(f"{variant}: first {time.time() - t0:.2f}s sum={res['sum']:.3f}",
              flush=True)
        if dev.type == "cuda":
            ms = common.mean_ms(lambda: run(x))
            res.update(ms=ms, us_per_sweep=ms * 1e3 / REPS,
                       plain_ms=common.launch_ms(
                           lambda: transpose_sum_plain(x, variant)))
            print(f"{variant}: {ms:.3f} ms/call, {res['us_per_sweep']:.2f} us "
                  f"per full-({Bw}x{KP}x{D}) transpose sweep", flush=True)
        res.update(hold_transpose(y, x, variant))
        print(f"{variant}: {common.held_text(res)}", flush=True)
        results[variant] = res
    return results


if __name__ == "__main__":
    main()
