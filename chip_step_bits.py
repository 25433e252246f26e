#!/usr/bin/env python3
"""Hashes of the decoder-layer step's outputs on seeded large-v3 operands,
for showing that a change to row 3's kernels left a mode's bits as they
were: run it on two checkouts in one call on one card and compare the
``bits`` lines.

    python3 chip_step_bits.py CHECKOUT

CHECKOUT is the root of a checkout of this repository; its chip_smoke.py
(``decode_inputs``) and its package are imported from there, and its
decoder-layer library is built there. Each ``bits`` line names a case and
gives the first 16 hex digits of the SHA-256 of the step's output x and
of every leaf of the self cache after the step:
  * the verify step at x bf16, 16 windows x S 2 / 4 / 8 over a 256-position
    cache, pos 30 / valid_start 0 then pos 62 / valid_start 2, both
    self-cache dtypes (int8 and bf16);
  * the one-token step at x f32 (the f32 residual stream), 6 windows over
    a 448-position cache, positions 4, 5 and 116, the int8 and the f32
    self cache.
Needs one CUDA card.
"""

from __future__ import annotations

import hashlib
import importlib.util
import sys
from pathlib import Path


def digest(t) -> str:
    import torch

    raw = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def main() -> None:
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    tree = str(Path(sys.argv[1]).resolve())
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_step_bits.py needs a CUDA card")
    spec = importlib.util.spec_from_file_location(
        "checkout_smoke", f"{tree}/chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    if not DL.__file__.startswith(tree):
        sys.exit(f"imported {DL.__file__}, not the checkout's package")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def show(*case, x, cache):
        print("bits", *case, digest(x),
              *(digest(v) for _, v in sorted(cache.items())), flush=True)

    for int8 in (True, False):
        dims, _, wpack, cross, cache, g = smoke.decode_inputs(
            dev, 16, 256, int8, seed=4, windows=16, T=256)
        H, d = dims.n_text_head, dims.n_text_state
        for S in (2, 4, 8):
            c = smoke.clone(cache)
            for pos, vs in ((30, 0), (62, 2)):
                x = torch.randn((16 * S, d), generator=g, device=dev).to(
                    torch.bfloat16)
                y = DL.fused_decoder_layers(x, wpack, c, cross, vs, pos, H,
                                            queries=S)
                show("bf16 verify", "int8" if int8 else "bf16", S, pos,
                     x=y, cache=c)
        del wpack, cross, cache, c
        dims, _, wpack, cross, cache, g = smoke.decode_inputs(
            dev, 6, 4, int8, windows=6)
        if not int8:
            cache = {"kv": cache["kv"].float()}
        for pos in (4, 5, 116):
            x = torch.randn((6, d), generator=g, device=dev)
            y = DL.fused_decoder_layers(x, wpack, cache, cross, 0, pos, H)
            show("f32 step", "int8" if int8 else "f32", pos, x=y,
                 cache=cache)
        del wpack, cross, cache
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
