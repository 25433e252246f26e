"""Copy rate from device memory into shared memory on the card: the
counterpart of the TPU probe ``scripts/probe_dma.py`` (``probe``, a ring
of async copies; ``probe_multi``, several independent rings).

The TPU probe streams ~4 GB through a ring of DMAs into VMEM inside one
kernel and prints the rate by chunk size, ring depth, strided rows and
parallel streams. Here the copies are TMA copies into a ring of
shared-memory slots (``csrc/probe_copy.cu``). A block holds at most 227
KB, so where the TPU's chunk is larger it is cut into bands of rows, and
the (iteration, band) copies are walked by one walker an SM: a block whose
warps are its rings (the TPU's streams), each keeping its slots in flight;
a line names the bytes of one copy, the slots, the streams, the blocks and
the bytes in flight an SM. The
TPU's configurations keep their names, chunks, slots and streams; a
sweep asks the card's own question: the rate by bytes a copy (4, 16, 64,
96 KB), slots (1, 2, 4; one slot, issued and waited in turn, gives a
copy's latency) and blocks (one, so one SM's rate; one per SM; two per
SM, the card's rate), each block copying its own row of every chunk.

The rate runs cycle through a source of which they read 1 GiB a pass (20x
the 50 MB L2, so every copy reads device memory; a strided line's source is
larger by its stride) and size each run to about ``--target-ms`` of device
time. ``--source-mib`` sets the bytes read a pass, to see how far the L2
serves a smaller one. Every run's checksum is held against the plain
version.

    python -m whisper_aries_tpu_torch.scripts.probe_dma [--target-ms 8]
        [--source-mib 1024] [--device cpu]

With ``--device cpu`` the TPU configurations run through the plain
version at 8 chunks and 16 iterations, untimed, and the sweep is left out.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import math
from typing import List, Optional, Tuple

import torch

from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.scripts import common

SOURCE_BYTES = 1 << 30   # what a rate run reads a pass over its source
TARGET_MS = 8.0          # device time of one rate run
OPTIN_H100 = 232448      # shared memory a block may opt into on an H100
SMS_H100 = 132           # an H100's SMs (the blocks of a plain run)
INFLIGHT_MIN = 32 << 10  # bytes in flight an SM that reach 93-96% of the
                         # card's rate with one block an SM (the sweep)
EXACT_INT8 = 1 << 24     # int8 checksums are exact below this sum of |terms|
TOL_BF16 = 1e-5          # of the sum of |terms|: f32 sums in another order
TRACE_ITERS = 64         # reads of the short run held one by one


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def steps_of(n_iter: int, bands: int, blocks: int) -> int:
    """The most steps a walker takes: ceil(n_iter * bands / blocks) (the
    trace's last axis)."""
    return -(-n_iter * bands // blocks)


def walk(C: int, n_iter: int, n_streams: int, blocks: int, bands: int,
         device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What each ring copies at each step (csrc/probe_copy.cu's walk): of
    the ``blocks`` walkers, walker b takes the items b, b + blocks, ...
    below n_iter * bands, item = i * bands + j, and its ring s copies band
    j of chunk (i * n_streams + s) mod C. Returns chunk (blocks, n_streams,
    T) and band (blocks, 1, T) int64 and valid (blocks, 1, T) bool (False
    past a walker's last step), T = ``steps_of``."""
    T = steps_of(n_iter, bands, blocks)
    item = (torch.arange(T, device=device)[None, :] * blocks
            + torch.arange(blocks, device=device)[:, None])[:, None, :]
    valid = item < n_iter * bands
    i, j = item // bands, item % bands
    s = torch.arange(n_streams, device=device)[None, :, None]
    return (i * n_streams + s) % C, j, valid


def band_heads(src: torch.Tensor, band: int, bands: int,
               head: int = 1) -> torch.Tensor:
    """(C, bands) f64: the sum of the first ``head`` elements of each band
    of each chunk (what one copy of it adds)."""
    rows = src[:, 0:bands * band:band, :head]
    return rows.double().sum(-1)


def _reads(heads: torch.Tensor, n_iter: int, n_streams: int, blocks: int,
           bands: int) -> torch.Tensor:
    """(blocks, n_streams, T) f64: heads (C, bands) as each ring reads them,
    zero past a walker's last step."""
    chunk, j, valid = walk(heads.shape[0], n_iter, n_streams, blocks, bands,
                           heads.device)
    return torch.where(valid, heads[chunk, j.expand_as(chunk)],
                       torch.zeros((), dtype=heads.dtype,
                                   device=heads.device))


def checksum_plain(src: torch.Tensor, band: int, n_iter: int,
                   n_streams: int = 1, blocks: int = 1, head: int = 1,
                   bands: Optional[int] = None) -> torch.Tensor:
    """(blocks,) f32: walker b's sum over its rings and steps of the first
    ``head`` elements of the band copied, taken in f64. ``bands`` (the
    bands of each chunk walked) defaults to ``blocks``: walker b copies
    band b of every chunk. With one walker and the whole chunk as the band
    this is the TPU probe's sum over i < n_iter of src[i mod C][0, 0]."""
    bands = bands or blocks
    reads = _reads(band_heads(src, band, bands, head), n_iter, n_streams,
                   blocks, bands)
    return reads.sum((1, 2)).float()


def abs_sum_plain(src: torch.Tensor, band: int, n_iter: int,
                  n_streams: int = 1, blocks: int = 1,
                  bands: Optional[int] = None) -> torch.Tensor:
    """(blocks,) f64: the sum of |terms| of each walker's checksum."""
    bands = bands or blocks
    return _reads(band_heads(src, band, bands).abs(), n_iter, n_streams,
                  blocks, bands).sum((1, 2))


def trace_plain(src: torch.Tensor, band: int, n_iter: int,
                n_streams: int = 1, blocks: int = 1, head: int = 1,
                bands: Optional[int] = None) -> torch.Tensor:
    """(blocks, n_streams, T) f32: what each read of each ring sees, the
    first ``head`` elements of the band it copied (zero past a walker's
    last step)."""
    bands = bands or blocks
    return _reads(band_heads(src, band, bands, head), n_iter, n_streams,
                  blocks, bands).float()


def unwaited_trace_plain(src: torch.Tensor, band: int, n_iter: int,
                         n_slots: int, n_streams: int = 1,
                         blocks: int = 1,
                         bands: Optional[int] = None) -> torch.Tensor:
    """The reads of a ring that never waits on slot 0: at every step
    t = 0 mod n_slots it sees what the slot held, the copy of step
    t - n_slots (zeros before the first). Its checksum differs from the
    right one by the last such read alone (the stale reads telescope), so
    this mistake is held on the reads, not on their sum."""
    bands = bands or blocks
    t = trace_plain(src, band, n_iter, n_streams, blocks, bands=bands).clone()
    idx = torch.arange(0, t.shape[-1], n_slots, device=src.device)
    stale = torch.zeros_like(t[..., idx])
    stale[..., 1:] = t[..., idx[:-1]]
    t[..., idx] = stale
    valid = walk(src.shape[0], n_iter, n_streams, blocks, bands,
                 src.device)[2]
    return t * valid


def _band0_dropped(src: torch.Tensor, band: int, bands: int,
                   head: int = 1) -> torch.Tensor:
    """band_heads with band 0 of every chunk never copied (its reads 0)."""
    heads = band_heads(src, band, bands, head)
    heads[:, 0] = 0.0
    return heads


def hold_trace(got: torch.Tensor, src: torch.Tensor, band: int,
               n_iter: int, n_slots: int, n_streams: int, blocks: int,
               bands: Optional[int] = None) -> dict:
    """Every read of a short run against the plain version, exactly (each
    is a copied value); the limit, 0, lies below a ring that never waits
    on slot 0 and a band that is never copied."""
    bands = bands or blocks
    want = trace_plain(src, band, n_iter, n_streams, blocks, bands=bands)

    def err(x):
        return float((x - want).abs().max())

    dropped = _reads(_band0_dropped(src, band, bands), n_iter, n_streams,
                     blocks, bands).float()
    return common.hold(err(got), 0.0, {
        "slot 0 unwaited": err(unwaited_trace_plain(
            src, band, n_iter, n_slots, n_streams, blocks, bands)),
        "band 0 dropped": err(dropped)}, err(got))


def hold_checksum(got: torch.Tensor, src: torch.Tensor, band: int,
                  n_iter: int, n_streams: int, blocks: int,
                  bands: Optional[int] = None) -> dict:
    """The kernel's checksums (a walker's, or one a ring of it) against
    the plain version. int8 sources:
    exact (every partial sum an integer f32 holds, the sum of |terms|
    staying below 2^24); bf16: within 1e-5 of the block's sum of |terms|
    (f32 sums in another order). Each limit lies below the error of band
    0 of every chunk never copied."""
    bands = bands or blocks
    if got.dim() == 2:  # one sum a ring: a walker's, added in f64
        got = got.double().sum(1)
    want = checksum_plain(src, band, n_iter, n_streams, blocks,
                          bands=bands).double()
    scale = abs_sum_plain(src, band, n_iter, n_streams, blocks, bands)
    exact = src.dtype == torch.int8
    if exact and float(scale.max()) >= EXACT_INT8:
        raise ValueError("int8 checksum too long to be exact in f32: "
                         "fewer iterations")
    if exact:
        scale = torch.ones_like(scale)
    scale = scale.clamp_min(1e-30)  # a walker with no step sums nothing

    def err(x):
        return float(((x.double() - want).abs() / scale).max())

    dropped = _reads(_band0_dropped(src, band, bands), n_iter, n_streams,
                     blocks, bands).sum((1, 2))
    return common.hold(err(got), 0.0 if exact else TOL_BF16,
                       {"band 0 dropped": err(dropped)},
                       float((got.double() - want).abs().max()))


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _copy_fn():
    fn = cb.library("probe_copy").aries_probe_copy
    fn.argtypes = [_P, _I, _I, _I, _I, _I, _I, _I, _L, _I, _I, _I, _I, _I,
                   _I, _P, _P, _P]
    fn.restype = _I
    return fn


def data_offset(n_slots: int) -> int:
    """Dynamic shared memory of a block before its first slot: the
    barriers of its ``n_slots`` slots, 16-byte aligned
    (csrc/probe_copy.cu's data_offset)."""
    return (8 * n_slots + 15) // 16 * 16


def block_smem(copy_bytes: int, n_slots: int, strided: bool,
               n_streams: int = 1) -> int:
    """The dynamic shared memory of a walker's block, ``n_streams`` rings
    of ``n_slots`` slots: slots of a strided copy start on 128-byte
    boundaries."""
    stride = -(-copy_bytes // 128) * 128 if strided else copy_bytes
    slots = n_slots * n_streams
    return data_offset(slots) + (128 if strided else 0) + stride * slots


def launch_copy(src: torch.Tensor, band: int, lanes: int, n_iter: int,
                n_slots: int, n_streams: int, blocks: int, head: int = 1,
                cluster: int = 1, smem: Optional[int] = None,
                trace: Optional[torch.Tensor] = None,
                bands: Optional[int] = None) -> torch.Tensor:
    """One launch of the copy kernel on CUDA ``src`` (C, rows, full_lanes)
    bf16 or int8: ``blocks`` walkers walk the n_iter x ``bands``
    (iteration, band) items (``walk``; ``bands`` defaults to ``blocks``),
    each walker a block whose ``n_streams`` warps are its rings; returns
    (blocks, n_streams) f32 checksums, one a ring. ``smem`` is a block's
    (default: what its rings need). ``trace``, where given,
    (blocks, n_streams, steps_of(n_iter, bands, blocks)) f32 on the same
    card, receives every read."""
    if not src.is_cuda:
        raise ValueError("src must be a CUDA tensor")
    if src.dtype not in (torch.bfloat16, torch.int8) or src.dim() != 3:
        raise ValueError(f"src must be (C, rows, lanes) bf16 or int8, got "
                         f"{tuple(src.shape)} {src.dtype}")
    if not src.is_contiguous():
        raise ValueError("src must be contiguous")
    C, rows, full = src.shape
    bands = bands or blocks
    if smem is None:
        smem = block_smem(band * lanes * src.element_size(), n_slots,
                          lanes != full, n_streams)
    out = torch.empty((blocks, n_streams), dtype=torch.float32,
                      device=src.device)
    if trace is not None:
        cb.require(trace, "trace", torch.float32,
                   (blocks, n_streams, steps_of(n_iter, bands, blocks)),
                   src.device)
    cb.launch(_copy_fn(), src, "probe copy kernel", cb.ptr(src),
              src.element_size(), C, rows, full, band, bands, lanes, n_iter,
              n_slots, n_streams, head, blocks, cluster, smem, cb.ptr(out),
              None if trace is None else cb.ptr(trace))
    return out


def copy_ring_kernel(src: torch.Tensor, band: int, lanes: int, n_iter: int,
                     n_slots: int, blocks: int = 1,
                     trace: Optional[torch.Tensor] = None,
                     bands: Optional[int] = None) -> torch.Tensor:
    """``probe``'s kernel: one ring of ``n_slots`` slots a walker; (blocks,)
    checksums."""
    out = launch_copy(src, band, lanes, n_iter, n_slots, 1, blocks,
                      trace=trace, bands=bands)[:, 0]
    cb.count(copy_ring_kernel)
    return out


copy_ring_kernel.launches = 0


def copy_streams_kernel(src: torch.Tensor, band: int, lanes: int,
                        n_iter: int, n_streams: int, blocks: int = 1,
                        trace: Optional[torch.Tensor] = None,
                        bands: Optional[int] = None) -> torch.Tensor:
    """``probe_multi``'s kernel: ``n_streams`` double-buffered rings a
    walker (each ring a warp of the walker's block), interleaved over the
    chunks; (blocks, n_streams) checksums, one a ring."""
    out = launch_copy(src, band, lanes, n_iter, 2, n_streams, blocks,
                      trace=trace, bands=bands)
    cb.count(copy_streams_kernel)
    return out


copy_streams_kernel.launches = 0


@functools.lru_cache(maxsize=None)
def _occupancy_fn():
    fn = cb.library("probe_copy").aries_probe_copy_occupancy
    fn.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    fn.restype = _I
    return fn


def blocks_per_sm(dev: torch.device, elem: int, threads: int,
                  smem: int) -> int:
    """Copy-kernel blocks of this shape that one SM holds at once."""
    n = _I(0)
    with torch.cuda.device(dev):
        cb.check(_occupancy_fn()(elem, threads, smem, ctypes.byref(n)),
                 "probe copy occupancy")
    return n.value


# ---------------------------------------------------------------------------
# the TPU probe's functions
# ---------------------------------------------------------------------------


def _source(src, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(src).to(dev).contiguous()


def probe(src, rows: int, lanes: int, n_iter: int, n_slots: int,
          full_lanes: int, blocks: int = 1, device=None) -> torch.Tensor:
    """scripts/probe_dma.py's ``probe``: src (C, rows, full_lanes); each of
    ``blocks`` blocks copies its band of rows // blocks rows, ``lanes``
    wide, through a ring of ``n_slots`` slots, n_iter times. Returns
    (blocks, 1) f32; with one block, (1, 1) = sum over i < n_iter of
    src[i mod C][0, 0], the TPU probe's answer."""
    dev = common.device_of(device)
    src = _source(src, dev)
    if tuple(src.shape[1:]) != (rows, full_lanes) or rows % blocks:
        raise ValueError(f"src {tuple(src.shape)} does not hold {blocks} "
                         f"bands of ({rows}, {full_lanes})")
    band = rows // blocks
    if dev.type == "cpu":
        return checksum_plain(src, band, n_iter, 1, blocks)[:, None]
    return copy_ring_kernel(src, band, lanes, n_iter, n_slots, blocks)[:, None]


def probe_multi(src, rows: int, lanes: int, n_iter: int, n_streams: int,
                blocks: int = 1, device=None) -> torch.Tensor:
    """scripts/probe_dma.py's ``probe_multi``: ``n_streams`` independent
    double-buffered rings, ring s copying chunk (i * n_streams + s) mod C
    at iteration i; (blocks, 1) f32 checksums over every ring."""
    dev = common.device_of(device)
    src = _source(src, dev)
    if tuple(src.shape[1:]) != (rows, lanes) or rows % blocks:
        raise ValueError(f"src {tuple(src.shape)} does not hold {blocks} "
                         f"bands of ({rows}, {lanes})")
    band = rows // blocks
    if dev.type == "cpu":
        return checksum_plain(src, band, n_iter, n_streams, blocks)[:, None]
    rings = copy_streams_kernel(src, band, lanes, n_iter, n_streams, blocks)
    return rings.double().sum(1, keepdim=True).float()


# ---------------------------------------------------------------------------
# rate runs
# ---------------------------------------------------------------------------


def band_plan(rows: int, row_bytes: int, n_slots: int, strided: bool,
              n_streams: int = 1,
              smem: int = OPTIN_H100) -> Tuple[int, int]:
    """(band rows, bands a chunk): the largest band of whole rows dividing
    the chunk whose walker's block of ``n_streams`` rings fits ``smem``
    bytes of shared memory (a strided band at most 256 rows: one
    tensor-map box high)."""
    for band in range(rows, 0, -1):
        copy = band * row_bytes
        if (rows % band or copy % 16 or copy >= 1 << 20
                or (strided and band > 256)):
            continue
        if block_smem(copy, n_slots, strided, n_streams) <= smem:
            return band, rows // band
    raise ValueError(f"no band of ({rows} rows x {row_bytes} B) fits "
                     f"{smem} B of shared memory")


@functools.lru_cache(maxsize=None)
def _limits_fn():
    fn = cb.library("probe_copy").aries_probe_smem_limits
    fn.argtypes = [ctypes.POINTER(_I)] * 4
    fn.restype = _I
    return fn


def smem_limits(dev: torch.device) -> dict:
    """The card's shared-memory attributes in bytes: what a block may opt
    into, an SM's, a block's without opting in, and what the system
    reserves a block."""
    vals = [_I(0) for _ in range(4)]
    with torch.cuda.device(dev):
        cb.check(_limits_fn()(*[ctypes.byref(v) for v in vals]),
                 "shared-memory attributes")
    return dict(zip(("optin", "per_sm", "per_block", "reserved"),
                    (v.value for v in vals)))


def optin_smem(dev: torch.device) -> int:
    """The shared memory a block may opt into on this card (the H100's
    where the plain versions run)."""
    return smem_limits(dev)["optin"] if dev.type == "cuda" else OPTIN_H100


def source(dtype: torch.dtype, C: int, rows: int, lanes: int,
           dev: torch.device, seed: int = 0) -> torch.Tensor:
    """(C, rows, lanes) random: int8 in [-127, 127), bf16 N(0, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = C * rows * lanes
    if dtype == torch.int8:
        x = torch.randint(-127, 127, (n,), generator=g, device=dev,
                          dtype=torch.int8)
    else:
        x = torch.randn(n, generator=g, device=dev, dtype=torch.bfloat16)
    return x.view(C, rows, lanes)


def run(name: str, rows: int, lanes: int, dtype: torch.dtype,
        n_slots: int = 2, full_lanes: Optional[int] = None,
        n_streams: int = 1, multi: bool = False, band: Optional[int] = None,
        blocks: Optional[int] = None, n_iter: Optional[int] = None,
        chunks: Optional[int] = None, target_ms: float = TARGET_MS,
        source_bytes: int = SOURCE_BYTES, device=None) -> dict:
    """One configuration: a chunk of (rows, lanes) elements out of rows
    ``full_lanes`` wide, cut into bands by ``band_plan`` unless ``band`` is
    given, the (iteration, band) copies walked by ``blocks`` walkers (unless
    given, one an SM), each a block of ``n_streams`` rings; ``multi`` runs
    ``probe_multi``'s kernel (double-buffered rings). The source holds
    ``chunks`` chunks (unless given, enough that a pass over it reads
    ``source_bytes``). On the card, ``n_iter`` (unless given) is sized to
    ~target_ms and the best of three launches is timed; the checksum is
    held against the plain version. Prints the line; returns its
    numbers."""
    dev = common.device_of(device)
    n_slots = 2 if multi else n_slots
    full_lanes = full_lanes or lanes
    elem = 1 if dtype == torch.int8 else 2
    strided = full_lanes != lanes
    if band is None:
        band = band_plan(rows, lanes * elem, n_slots, strided, n_streams,
                         optin_smem(dev))[0]
    bands = rows // band
    sms = cb.sm_count(dev) if dev.type == "cuda" else SMS_H100
    blocks = blocks or sms
    chunk_bytes = rows * full_lanes * elem
    C = chunks or (max(8, source_bytes // (rows * lanes * elem))
                   if dev.type == "cuda" else 8)
    src = source(dtype, C, rows, full_lanes, dev)
    copy_bytes = band * lanes * elem
    per_iter = copy_bytes * bands * n_streams

    def launch(n, trace=None):
        if multi:
            return copy_streams_kernel(src, band, lanes, n, n_streams, blocks,
                                       trace, bands)
        return copy_ring_kernel(src, band, lanes, n, n_slots, blocks, trace,
                                bands)

    res = dict(name=name, copy_bytes=copy_bytes, chunk_bytes=chunk_bytes,
               slots=n_slots, streams=n_streams, blocks=blocks,
               band=band, bands=bands, chunks=C,
               dtype=str(dtype).replace("torch.", ""),
               inflight_per_sm=copy_bytes * n_slots * n_streams
               * -(-blocks // sms))
    # every read of a short run, held in place (a missed wait shows there)
    n_trace = min(TRACE_ITERS, C)
    if dev.type == "cpu":
        n_iter = n_iter or 16
        got = checksum_plain(src, band, n_iter, n_streams, blocks,
                             bands=bands)
        reads = trace_plain(src, band, n_trace, n_streams, blocks,
                            bands=bands)
        timing = "plain version, untimed"
    else:
        reads = torch.empty((blocks, n_streams,
                             steps_of(n_trace, bands, blocks)), device=dev)
        launch(n_trace, reads)
        if n_iter is None:
            n_iter = common.iterations_for(
                launch, max(16, math.ceil((64 << 20) / per_iter)), target_ms)
        if elem == 1:  # keep the int8 checksum exact in f32
            most = (EXACT_INT8 - 1) // (127 * n_streams)
            n_iter = min(n_iter, most * blocks // bands)
        last = {}
        ms = common.best_ms(lambda: last.update(out=launch(n_iter)))
        got = last["out"]
        plain_ms = common.launch_ms(
            lambda: checksum_plain(src, band, n_iter, n_streams, blocks,
                                   bands=bands))
        gbs = per_iter * n_iter / ms / 1e6
        res.update(ms=ms, gbs=gbs, share=gbs * 1e9 / common.PEAK_BYTES,
                   us_per_copy=ms * 1e3 * blocks / (n_iter * bands),
                   plain_ms=plain_ms, bytes=per_iter * n_iter)
        timing = (f"best={ms:8.3f}ms {gbs:8.1f} GB/s "
                  f"{res['us_per_copy']:7.2f} us/copy "
                  f"{res['share']:6.1%} of 3.35 TB/s")
    res["n_iter"] = n_iter
    res.update(hold_checksum(got, src, band, n_iter, n_streams, blocks,
                             bands))
    res["reads"] = hold_trace(reads, src, band, n_trace, n_slots, n_streams,
                              blocks, bands)
    res["ok"] = res["ok"] and res["reads"]["ok"]
    print(f"{name:36s} {copy_bytes / 1024:7.1f}KB/copy (chunk "
          f"{chunk_bytes / 1024:.0f}KB, {bands} bands) x{n_iter:8d} "
          f"slots={n_slots} streams={n_streams} blocks={blocks:3d} "
          f"{res['inflight_per_sm'] / 1024:.0f}KB in flight/SM {timing}  "
          f"{common.held_text(res)}; reads "
          f"{common.held_text(res['reads'])}", flush=True)
    return res


# the TPU script's configurations, by its names: (name, rows, lanes, dtype,
# slots, full lanes)
TPU_RUNS = (
    ("bf16 64KB contiguous", 8, 4096, torch.bfloat16, 2, None),
    ("bf16 256KB contiguous", 16, 8192, torch.bfloat16, 2, None),
    ("bf16 1MB contiguous", 64, 8192, torch.bfloat16, 2, None),
    ("bf16 4MB contiguous", 256, 8192, torch.bfloat16, 2, None),
    ("selfKV slab (1280,640) bf16", 1280, 640, torch.bfloat16, 2, None),
    ("crossKV strided (1280,512/1536)", 1280, 512, torch.int8, 2, 1536),
    ("crossKV contig (1280,512)", 1280, 512, torch.int8, 2, None),
    ("bf16 256KB contiguous 4slot", 16, 8192, torch.bfloat16, 4, None),
    ("crossKV strided 4slot", 1280, 512, torch.int8, 4, 1536),
)
# probe_multi's: (name, rows, lanes, streams)
TPU_MULTI = (
    ("bf16 1MB x1 stream", 64, 8192, 1),
    ("bf16 1MB x2 streams", 64, 8192, 2),
    ("bf16 1MB x4 streams", 64, 8192, 4),
    ("bf16 4MB x2 streams", 256, 8192, 2),
)
SWEEP_KB = (4, 16, 64, 96)
SWEEP_SLOTS = (1, 2, 4)


def sweep(target_ms: float = TARGET_MS, device=None,
          source_bytes: int = SOURCE_BYTES) -> List[dict]:
    """The card's own question: bf16 copies of 4-96 KB through 1, 2 or 4
    slots, in 1 block, one block per SM and two per SM (where that many
    fit an SM); each block copies its own row of every chunk."""
    dev = common.device_of(device)
    sms = cb.sm_count(dev)
    out = []
    for kb in SWEEP_KB:
        for slots in SWEEP_SLOTS:
            smem = block_smem(kb << 10, slots, False)
            for per_sm in (0, 1, 2):
                name = (f"sweep {kb}KB {slots}slot "
                        + ("1 block" if per_sm == 0 else f"{per_sm}/SM"))
                fit = (smem <= optin_smem(dev) and (
                    per_sm < 2 or blocks_per_sm(dev, 2, 32, smem) >= 2))
                if not fit:
                    print(f"{name:36s} does not fit: {smem} B of shared "
                          f"memory a block", flush=True)
                    continue
                blocks = max(1, per_sm * sms)
                out.append(run(name, blocks, (kb << 10) // 2,
                               torch.bfloat16, n_slots=slots, band=1,
                               blocks=blocks, target_ms=target_ms,
                               source_bytes=source_bytes,
                               device=dev))
    return out


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--target-ms", type=float, default=TARGET_MS)
    ap.add_argument("--source-mib", type=int, default=SOURCE_BYTES >> 20,
                    help="MiB a rate run reads a pass over its source")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = common.device_of(args.device)
    nbytes = args.source_mib << 20
    print(f"device={common.card_line(dev)} target={args.target_ms}ms a "
          f"line, {args.source_mib} MiB read a pass over a source",
          flush=True)
    results = [run(name, rows, lanes, dtype, n_slots=slots, full_lanes=full,
                   target_ms=args.target_ms, source_bytes=nbytes, device=dev)
               for name, rows, lanes, dtype, slots, full in TPU_RUNS]
    results += [run(name, rows, lanes, torch.bfloat16, n_streams=streams,
                    multi=True, target_ms=args.target_ms,
                    source_bytes=nbytes, device=dev)
                for name, rows, lanes, streams in TPU_MULTI]
    if dev.type == "cuda":
        results += sweep(args.target_ms, dev, nbytes)
    return results


if __name__ == "__main__":
    main()
