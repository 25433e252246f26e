"""Matrix-unit rate on the card by operand type: the counterpart of the
TPU probe ``scripts/probe_mxu.py`` (``probe``: the sum over i < N of
(A.B)[0, 0] over resident operands, for bf16 -> f32, s8 -> s32 and
f32 -> f32).

On Hopper the matrix units are the tensor cores, fed by ``wgmma`` from
shared memory. The kernel (``csrc/probe_mma.cu``) stages one A tile
(128 x K) and one B tile (K x 256) into shared memory once, one block per
SM, and runs chains of whole products A.B over them: bf16 with f32 sums,
s8 with s32 sums, and f32 operands as TF32 (the tensor cores' answer to
the TPU's f32 dot). K is 256 bytes of operands a row (128 bf16, 256 s8,
64 f32): 227 KB of shared memory cannot hold the TPU's 1024 x 8192
operands. A line gives the rate and its share of the published dense
peak (989 bf16, 1,979 int8, 495 TF32 TFLOP/s) beside one torch.matmul
(torch._int_mm for s8) at 8192^3, with B row-major and column-major, and
holds the result against the plain version.

    python -m whisper_aries_tpu_torch.scripts.probe_mxu [--target-ms 8]
        [--device cpu]

The iterations (the TPU script's N) are sized to ~target_ms of device
time.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
from typing import List, Optional

import numpy as np
import torch

from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.scripts import common

TM, TN, KB = 128, 256, 256   # csrc/probe_mma.cu's tile: rows, columns, K bytes
KSTEPS = KB // 32            # wgmma a product
KINDS = {"bf16": (torch.bfloat16, 0), "s8": (torch.int8, 1),
         "f32": (torch.float32, 2)}
TARGET_MS = 8.0
LIBRARY_DIM = 8192           # the torch.matmul yardstick's M = N = K


def tile_k(kind: str) -> int:
    """K of the resident tile for ``kind``: 256 bytes of operands a row."""
    return KB // torch.tensor([], dtype=KINDS[kind][0]).element_size()


def fold_weight(n_iter: int, fold: bool) -> int:
    """W: the number of products the accumulator takes, n_iter, or with
    the fold sum over i < n_iter of (i mod 3 + 1)."""
    if not fold:
        return n_iter
    q, r = divmod(n_iter, 3)
    return 6 * q + (1 if r >= 1 else 0) + (2 if r >= 2 else 0)


def wrap_s32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 wrapping as a 32-bit two's-complement sum does."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def mma_plain(a: torch.Tensor, b: torch.Tensor, n_iter: int, kind: str,
              fold: bool = False) -> torch.Tensor:
    """The kernel's function: W (A.B) for W = ``fold_weight(n_iter,
    fold)``. s8: int32, the exact sum (products in f64, exact below 2^53)
    times W in int64, wrapped as s32 wraps; bf16 and f32: f32, the
    product in f64 rounded once to f32, times W in f32."""
    W = fold_weight(n_iter, fold)
    p = a.double() @ b.double()
    if kind == "s8":
        return wrap_s32(p.round().long() * W)
    return p.float() * W


def float_limit(n_iter: int, fold: bool) -> float:
    """The bf16 / TF32 limit on max |got - want| / max |want|: the
    accumulator takes KSTEPS x W partial products in f32, each add
    rounding by up to one ulp of the running sum (a truncating
    accumulator's worst case); with 1e-5 for the product's own sums."""
    return KSTEPS * fold_weight(n_iter, fold) * 2.0 ** -23 + 1e-5


def hold_mma(got: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             n_iter: int, kind: str, fold: bool) -> dict:
    """Every block's (TM, TN) result against the plain version: s8 exact,
    bf16 and TF32 within ``float_limit`` of max |want|; each limit below
    the error of a product with its last K slab (32 bytes) dropped."""
    want = mma_plain(a, b, n_iter, kind, fold)
    ks = 32 // a.element_size()
    short = mma_plain(a[:, :-ks], b[:-ks], n_iter, kind, fold)
    if kind == "s8":
        def err(x):
            return float((x.long() - want.long()).abs().max())
        limit = 0.0
    else:
        def err(x):
            return float((x.float() - want).abs().max()
                         / want.abs().max())
        limit = float_limit(n_iter, fold)
    return common.hold(err(got), limit, {"K slab dropped": err(short)},
                       float((got.double() - want.double()).abs().max()))


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _mma_fn():
    fn = cb.library("probe_mma").aries_probe_mma
    fn.argtypes = [_I, _P, _P, _P, _L, _I, _I, _P]
    fn.restype = _I
    return fn


def launch_mma(a: torch.Tensor, b: torch.Tensor, n_iter: int, kind: str,
               fold: bool, blocks: Optional[int] = None) -> torch.Tensor:
    """One launch of the product loop on CUDA a (TM, K), b (K, TN) of
    ``kind``'s type; returns (blocks, TM, TN), int32 for s8, else f32,
    one block per SM unless ``blocks`` is given."""
    dtype, code = KINDS[kind]
    k = tile_k(kind)
    cb.require(a, "a", dtype, (TM, k))
    cb.require(b, "b", dtype, (k, TN), a.device)
    bt = b.t().contiguous()
    blocks = blocks or cb.sm_count(a)
    out = torch.empty((blocks, TM, TN), device=a.device,
                      dtype=torch.int32 if kind == "s8" else torch.float32)
    cb.launch(_mma_fn(), a, "probe mma kernel", code, cb.ptr(a), cb.ptr(bt),
              cb.ptr(out), n_iter, int(fold), blocks)
    return out


def mma_loop_kernel(a: torch.Tensor, b: torch.Tensor, n_iter: int,
                    kind: str, blocks: Optional[int] = None) -> torch.Tensor:
    """``probe``'s kernel: one product A.B an iteration."""
    out = launch_mma(a, b, n_iter, kind, False, blocks)
    cb.count(mma_loop_kernel)
    return out


mma_loop_kernel.launches = 0


def probe(a, b, n_iter: int, kind: str, device=None) -> torch.Tensor:
    """scripts/probe_mxu.py's ``probe``: (1, 1) f32, the sum over
    i < n_iter of (A.B)[0, 0] (the s8 sum as s32, wrapping). On the card a
    and b must be the resident tile's shapes (TM, K) and (K, TN)."""
    dev = common.device_of(device)
    a, b = (torch.as_tensor(t).to(dev) for t in (a, b))
    if dev.type == "cpu":
        return mma_plain(a, b, n_iter, kind)[:1, :1].float()
    return mma_loop_kernel(a.contiguous(), b.contiguous(), n_iter,
                           kind)[0, :1, :1].float()


def operands(kind: str, k: int, dev: torch.device, m: int = TM,
             n: int = TN, seed: int = 0):
    """A (m, k) and B (k, n) from a seed with numpy, as the TPU script
    makes them: s8 in [-127, 127), bf16 N(0, 1); f32 N(0, 1) rounded to
    bf16 values, which TF32 holds exactly (so the check holds the sums,
    and TF32's rounding of the operands does not enter)."""
    rng = np.random.default_rng(seed)
    if kind == "s8":
        mats = [rng.integers(-127, 127, s, dtype=np.int8)
                for s in ((m, k), (k, n))]
        return [torch.from_numpy(x).to(dev) for x in mats]
    mats = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((m, k), (k, n))]
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return [x.to(torch.bfloat16).to(dtype).to(dev) for x in mats]


LAYOUTS = ("B row-major", "B column-major")


def library_operands(kind: str, m: int, k: int, n: int, dev: torch.device,
                     layout: str = LAYOUTS[0]):
    """Random A (m, k) row-major and B (k, n) in ``layout`` (column-major:
    ``b.t().contiguous().t()``, the layout cuBLASLt's int8 kernels take)
    of ``kind``'s type, made on the card."""
    g = torch.Generator(device=dev).manual_seed(1)
    dtype = KINDS[kind][0]
    if kind == "s8":
        a, b = (torch.randint(-127, 127, s, generator=g, device=dev,
                              dtype=dtype) for s in ((m, k), (k, n)))
    else:
        a, b = (torch.randn(s, generator=g, device=dev, dtype=dtype)
                for s in ((m, k), (k, n)))
    if layout == LAYOUTS[1]:
        b = b.t().contiguous().t()
    return a, b


def library_ms(kind: str, a: torch.Tensor, b: torch.Tensor,
               reps: int = 8) -> float:
    """Mean milliseconds of one PyTorch product a @ b on the card:
    torch.matmul for bf16 and f32 (TF32 allowed for this call),
    torch._int_mm for s8; B in whatever layout it lies."""
    if kind == "s8":
        return common.mean_ms(lambda: torch._int_mm(a, b), reps)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = kind == "f32"
    try:
        return common.mean_ms(lambda: torch.matmul(a, b), reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def library_by_layout(kind: str, m: int, k: int, n: int,
                      dev: torch.device) -> dict:
    """{layout: ms} of the PyTorch product at (m, k, n), B row-major and
    column-major."""
    out = {}
    for layout in LAYOUTS:
        a, b = library_operands(kind, m, k, n, dev, layout)
        out[layout] = library_ms(kind, a, b)
        del a, b
    return out


def library_tflops(kind: str, dev: torch.device,
                   dim: int = LIBRARY_DIM) -> dict:
    """{layout: T(FL)OP/s} of the PyTorch product at dim^3."""
    return {layout: 2 * dim ** 3 / ms / 1e9 for layout, ms in
            library_by_layout(kind, dim, dim, dim, dev).items()}


def library_at_ops(kind: str, ops: float, dev: torch.device) -> dict:
    """The PyTorch product at about ``ops`` operations (the kernel's own
    count): n x k x n with n a multiple of 256 near (ops / 2)^(1/3) and k a
    multiple of 64 making 2 n^2 k within 64 / k of ``ops``; the faster
    layout of B. Returns ms, its layout, the shape and its operations."""
    n = max(256, round((ops / 2) ** (1 / 3) / 256) * 256)
    k = max(64, round(ops / 2 / n ** 2 / 64) * 64)
    by = library_by_layout(kind, n, k, n, dev)
    layout = min(by, key=by.get)
    return dict(ms=by[layout], layout=layout, shape=[n, k, n],
                ops=2 * n * n * k, by_layout=by)


def library_tile_ms(kind: str, a: torch.Tensor, b: torch.Tensor) -> float:
    """Milliseconds of one PyTorch product at the tile's shape, B
    column-major for s8."""
    return library_ms(kind, a, b.t().contiguous().t() if kind == "s8" else b)


def rate_run(kind: str, label: str, kernel, fold: bool,
             n_iter: Optional[int], target_ms: float, dev: torch.device,
             out_f32: bool = False) -> dict:
    """One rate line of the product loop (``kernel``: the probe's counted
    wrapper): iterations sized to ~target_ms unless given, the best of
    three launches, every block's result held against the plain version."""
    k = tile_k(kind)
    a, b = operands(kind, k, dev)
    res = dict(label=label, kind=kind, fold=fold, shape=[TM, k, TN])
    if dev.type == "cpu":
        n_iter = n_iter or 3
        got = mma_plain(a, b, n_iter, kind, fold)[None]
        timing = "plain version, untimed"
    else:
        if n_iter is None:
            n_iter = common.iterations_for(lambda n: kernel(a, b, n, kind),
                                           64, target_ms)
        last = {}
        ms = common.best_ms(lambda: last.update(out=kernel(a, b, n_iter,
                                                           kind)))
        got = last["out"]
        blocks = got.shape[0]
        ops = 2 * TM * TN * k * fold_weight(n_iter, fold) * blocks
        rate = ops / ms / 1e9
        peak = common.PEAK_OPS[kind]
        res.update(
            ms=ms, ops=ops, tflops=rate, share=rate * 1e12 / peak,
            blocks=blocks,
            plain_ms=common.launch_ms(lambda: mma_plain(a, b, n_iter, kind,
                                                        fold)),
            library_tile_ms=library_tile_ms(kind, a, b),
            library_tflops=library_tflops(kind, dev))
        lib = ", ".join(f"{v:.1f} ({k})"
                        for k, v in res["library_tflops"].items())
        timing = (f"{ms:8.3f} ms on {blocks} blocks {rate:7.1f} T(FL)OP/s "
                  f"{res['share']:6.1%} of {peak / 1e12:.0f}; torch at "
                  f"{LIBRARY_DIM}^3 {lib}")
    res["n_iter"] = n_iter
    res.update(hold_mma(got, a, b, n_iter, kind, fold))
    fold_txt = "fold" if fold else "loop"
    first = got[0].float() if out_f32 else got[0]
    print(f"{label:15s} {TM}x{k}x{TN} x{n_iter} {fold_txt}: {timing}  "
          f"out[0,0]={float(first[0, 0]):.6g}  {common.held_text(res)}",
          flush=True)
    return res


def run(kind: str, n_iter: Optional[int] = None,
        target_ms: float = TARGET_MS, device=None) -> dict:
    """The TPU script's line for one kind."""
    return rate_run(kind, kind, mma_loop_kernel, False, n_iter, target_ms,
                    common.device_of(device))


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--target-ms", type=float, default=TARGET_MS)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    print(f"device={common.card_line(dev)}", flush=True)
    return [run(kind, target_ms=args.target_ms, device=dev)
            for kind in KINDS]


if __name__ == "__main__":
    main()
