"""Does the card run s8 x s8 -> s32 products at twice the bf16 rate? The
counterpart of the TPU probe ``scripts/probe_int8_mxu.py`` (``make_kernel``:
out (8, 128) = the sum over i < REPS of (i mod 3 + 1) (A.B)[:8, :128]
over resident operands; the rotating weight keeps every product live).

The H100's data sheet gives 989 bf16 and 1,979 int8 dense tera-operations
a second. The kernel is ``csrc/probe_mma.cu``'s product loop with the
TPU probe's fold: iteration i accumulates (i mod 3 + 1) whole products
A.B (wgmma m64n256, bf16 -> f32 or s8 -> s32) into the same registers,
over one A (128 x K) and one B (K x 256) tile resident in shared memory,
one block per SM; out[:8, :128] of the result is the TPU fold with K cut
to the tile's depth (256 bytes of operands a row). The third line,
s8 x s8 -> f32, is the s32 sum converted to f32 at the fold. A rate
line's repetitions are sized on the card to ~target_ms of device time
(the TPU script's 400 would take well under a millisecond here). The answer decides whether
an s8 x s8 -> s32 GEMM is worth writing for the encoder (the JAX
package's ``ops/quant.py`` "native" implementation).

    python -m whisper_aries_tpu_torch.scripts.probe_int8_mxu
        [--target-ms 8] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.scripts import common
from whisper_aries_tpu_torch.scripts import probe_mxu as PM

M, N = PM.TM, PM.TN
REPS = 400      # the TPU script's, make_kernel's default
TARGET_MS = PM.TARGET_MS
LABELS = ((torch.bfloat16, torch.float32, "bf16xbf16->f32"),
          (torch.int8, torch.int32, "s8xs8->s32"),
          (torch.int8, torch.float32, "s8xs8->f32"))


def _kind(dtype: torch.dtype) -> str:
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype == torch.int8:
        return "s8"
    raise ValueError(f"the fold probe takes bf16 or int8 operands, not "
                     f"{dtype}")


def mma_fold_kernel(a: torch.Tensor, b: torch.Tensor, n_iter: int,
                    kind: str, blocks: Optional[int] = None
                    ) -> torch.Tensor:
    """``make_kernel``'s kernel: (i mod 3 + 1) products an iteration;
    (blocks, M, N), int32 for s8, else f32."""
    out = PM.launch_mma(a, b, n_iter, kind, True, blocks)
    cb.count(mma_fold_kernel)
    return out


mma_fold_kernel.launches = 0


def make_kernel(dtype: torch.dtype, acc: torch.dtype, reps: int = REPS,
                device=None):
    """scripts/probe_int8_mxu.py's ``make_kernel``, called: a function of
    (a, b) giving out (8, 128) f32, the fold over ``reps`` iterations with
    ``acc`` sums (int32 sums wrap as s32 and are converted at the end). On
    the card a and b must be the tile's shapes, (M, K) and (K, N)."""
    dev = common.device_of(device)
    kind = _kind(dtype)
    if acc not in ((torch.float32,) if kind == "bf16"
                   else (torch.int32, torch.float32)):
        raise ValueError(f"{dtype} operands do not take {acc} sums here")
    def f(a, b) -> torch.Tensor:
        a, b = (torch.as_tensor(t).to(dev).contiguous() for t in (a, b))
        if dev.type == "cpu":
            return PM.mma_plain(a, b, reps, kind, True)[:8, :128].float()
        return mma_fold_kernel(a, b, reps, kind)[0, :8, :128].float()

    return f


def run(dtype: torch.dtype, acc: torch.dtype, label: str,
        reps: Optional[int] = None, target_ms: float = TARGET_MS,
        device=None) -> dict:
    """The TPU script's line for one (operand, sum) pair, over ``reps``
    repetitions or, where not given, ~target_ms of device time."""
    return PM.rate_run(_kind(dtype), label, mma_fold_kernel, True, reps,
                       target_ms, common.device_of(device),
                       out_f32=acc == torch.float32)


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--target-ms", type=float, default=TARGET_MS)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    print(f"device={common.card_line(dev)}", flush=True)
    return [run(dtype, acc, label, target_ms=args.target_ms, device=dev)
            for dtype, acc, label in LABELS]


if __name__ == "__main__":
    main()
