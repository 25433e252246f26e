"""Shared memory a block and a cluster can take on the card: the
counterpart of the TPU probe ``scripts/probe_vmem.py`` (``try_size``: one
copy into a scratch of 8-96 MB, then the sum of its first 128 elements).

The TPU probe asked whether a raised scoped-VMEM limit is accepted. On
Hopper the question is how much shared memory a block may opt into, how
much an SM holds, and whether clusters of blocks at that size launch. The
probe reads the card's attributes, then launches the one-slot copy of
``csrc/probe_copy.cu`` asking for 48, 96, 192 and 227 KB of dynamic shared
memory, and 1 KB above 227 KB, which the card must refuse: each launch
copies a row of ones filling the request and sums its first 128 elements
(128 where it ran). Then one cluster each of 2, 4, 8 and 16 blocks, every
block at the opt-in limit (16 needs the non-portable cluster size), beside
the clusters of that size the card can hold at once
(cudaOccupancyMaxActiveClusters).

    python -m whisper_aries_tpu_torch.scripts.probe_vmem [--device cpu]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
from typing import List

import torch

from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.scripts import common
from whisper_aries_tpu_torch.scripts import probe_dma as PD

HEAD = 128                      # elements summed after the copy
SIZES_KB = (48, 96, 192, 227, 228)
CLUSTERS = (2, 4, 8, 16)


def copy_lanes(smem_bytes: int) -> int:
    """bf16 elements the one-slot copy moves when a launch asks for
    ``smem_bytes``: what is left after the barrier, in 16-byte steps."""
    return (smem_bytes - PD.data_offset(1)) // 16 * 16 // 2


def smem_copy_plain(src: torch.Tensor) -> torch.Tensor:
    """(blocks,) f32: the sum of the first 128 elements of each block's
    row of src (blocks, lanes)."""
    return src[:, :HEAD].double().sum(1).float()


def smem_copy_kernel(src: torch.Tensor, smem_bytes: int,
                     cluster: int = 1) -> torch.Tensor:
    """The one-slot copy: block b copies row b of src (blocks, lanes) bf16
    into a launch asking for exactly ``smem_bytes`` of dynamic shared
    memory, then sums its first 128 elements. Launched as clusters of
    ``cluster`` blocks. Raises with the CUDA error where the card refuses
    the launch."""
    if src.dim() != 2:
        raise ValueError(f"src must be (blocks, lanes), got {tuple(src.shape)}")
    blocks, lanes = src.shape
    out = PD.launch_copy(src[None], 1, lanes, 1, 1, 1, blocks,
                         head=HEAD, cluster=cluster, smem=smem_bytes)[:, 0]
    cb.count(smem_copy_kernel)
    return out


smem_copy_kernel.launches = 0


@functools.lru_cache(maxsize=None)
def _clusters_fn():
    fn = cb.library("probe_copy").aries_probe_copy_max_clusters
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def max_clusters(dev: torch.device, cluster: int, smem_bytes: int) -> int:
    """Clusters of ``cluster`` one-slot copy blocks at ``smem_bytes`` each
    that the card can hold at once."""
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        cb.check(_clusters_fn()(cluster, 32, smem_bytes, ctypes.byref(n)),
                 f"max active clusters of {cluster}")
    return n.value


def try_bytes(smem_bytes: int, cluster: int = 1, device=None) -> dict:
    """One launch (``cluster`` blocks, one cluster) asking for
    ``smem_bytes`` of dynamic shared memory a block, each block copying
    a row of ones that fills it. Returns ok, the blocks' sums (128 each
    where the launch ran) or the card's refusal: its error text, code and
    stage ("attribute": cudaFuncSetAttribute refused the size; "launch":
    the launch was refused). Any other failure raises."""
    dev = common.device_of(device)
    src = torch.ones((cluster, copy_lanes(smem_bytes)), dtype=torch.bfloat16,
                     device=dev)
    res = dict(smem_bytes=smem_bytes, cluster=cluster)
    if dev.type == "cpu":
        return dict(res, ok=True, sums=smem_copy_plain(src).tolist())
    try:
        out = smem_copy_kernel(src, smem_bytes, cluster)
    except cb.CudaError as e:
        return dict(res, ok=False, error=str(e).split(": ", 1)[-1],
                    code=e.code, stage=e.stage)
    torch.cuda.synchronize(dev)
    want = smem_copy_plain(src)
    return dict(res, sums=out.tolist(),
                **common.hold(float((out - want).abs().max()), 0.0,
                              {"copy dropped": float(want.abs().max())},
                              float((out - want).abs().max())))


def try_size(kb: int, device=None) -> dict:
    """scripts/probe_vmem.py's ``try_size`` in KB of shared memory a
    block: prints OK with the sum, or FAIL with the CUDA error."""
    res = try_bytes(kb << 10, device=device)
    what = f"{kb:4d} KB shared"
    if res["ok"]:
        print(f"{what}: OK (sum={res['sums'][0]:.0f})", flush=True)
    else:
        print(f"{what}: FAIL {res['error']}", flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    print(f"device={common.card_line(dev)}", flush=True)
    limits = (PD.smem_limits(dev) if dev.type == "cuda"
              else dict(optin=PD.OPTIN_H100))
    print("shared memory: " + ", ".join(f"{k} {v} B" for k, v in
                                        limits.items()), flush=True)
    optin = limits["optin"]
    sizes = [try_size(kb, device=dev) for kb in SIZES_KB]
    edge = [try_bytes(optin, device=dev), try_bytes(optin + 1, device=dev)]
    print(f"at the limit {optin} B: {'OK' if edge[0]['ok'] else 'FAIL'}; "
          f"{optin + 1} B: "
          f"{'OK' if edge[1]['ok'] else 'FAIL ' + edge[1].get('error', '')}",
          flush=True)
    clusters: List[dict] = []
    for c in CLUSTERS:
        fit = max_clusters(dev, c, optin) if dev.type == "cuda" else None
        res = dict(try_bytes(optin, c, device=dev), max_active=fit)
        state = (f"OK (sums {min(res['sums']):.0f}..{max(res['sums']):.0f})"
                 if res["ok"] else f"FAIL {res['error']}")
        print(f"cluster {c:2d} x {optin} B: {state}; at most {fit} such "
              f"clusters at once", flush=True)
        clusters.append(res)
    return dict(limits=limits, sizes=sizes, edge=edge, clusters=clusters)


if __name__ == "__main__":
    main()
