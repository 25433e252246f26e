"""The on-device decode loop and the sampled rungs' draws
(csrc/decode_loop.cu).

``DeviceLoop`` runs a decode call's steps as one CUDA graph: a kernel
evaluates the loop's condition on the device state, then a WHILE
conditional node repeats the body (one step that PyTorch captured: the
decoder step, the vocab product, the filters or the beam tail and the
state's bookkeeping, ending in the same condition kernel) until the
condition is false. One launch a decode call, no host read per token: the
counterpart of the JAX package's ``lax.while_loop`` (decoding/
generate.py:423 greedy, :948 beam). A loop graph that fails to build,
instantiate or launch raises; nothing falls back to a host loop.

``loop_cond`` is the JAX ``cond`` (greedy ``!all(finished) & pos < L``,
beam ``!all(fin_count >= C) & pos < L``): the kernel for CUDA state, its
plain version for CPU state, where the host loop reads it.

``uniform_draw`` gives the Gumbel draws of a sampled rung at the device
position: u in (0, 1) a counter-based hash of (seed, row, pos, vocab
index), so the same seed gives the same tokens run after run and a
captured step draws new numbers at each position. It replaces the TPU's
own random bits in ``jax.random.categorical`` (generate.py:364) and does
not reproduce them. The kernel for CUDA tensors, the plain version (the
same integer hash in int64 torch ops) for CPU tensors, bit for bit. The
decode loop's greedy choice (ops/decode_choice.py) draws the same bits in
registers inside its own kernel; the standalone draw kernel is the hold of
the hash against the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch

from whisper_aries_tpu_torch.ops import cuda_build as cb

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ULL, _U = ctypes.c_ulonglong, ctypes.c_uint

M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cb.library("decode_loop")
    sig = {
        "aries_loop_cond": [_P, _P, _I, _LL, _P, _I, _ULL, _I, _P, _P],
        "aries_uniform_draw": [_U, _U, _P, _I, _I, _P, _P],
        "aries_loop_create": [ctypes.POINTER(_P), ctypes.POINTER(_ULL)],
        "aries_loop_build": [_P, _P, _P, _P, _I, _LL, _P, _I, _P,
                             ctypes.POINTER(_I)],
        "aries_loop_launch": [_P, _P],
        "aries_loop_destroy": [_P],
        "aries_loop_runtime_version": [],
        "aries_graph_nodes": [_P, ctypes.POINTER(_ULL)],
    }
    for name, args in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# The loop's condition
# ---------------------------------------------------------------------------


def _flags(finished, counts):
    """(finished pointer, counts pointer, n) of the state the condition
    reads: greedy rows' finished flags or beam windows' finished counts."""
    if (finished is None) == (counts is None):
        raise ValueError("give finished (greedy) or counts (beam)")
    if finished is not None:
        cb.require(finished, "finished", torch.bool)
        return cb.ptr(finished), None, finished.numel()
    cb.require(counts, "counts", torch.int64)
    return None, cb.ptr(counts), counts.numel()


def loop_cond_plain(pos: torch.Tensor, L: int,
                    finished: Optional[torch.Tensor] = None,
                    counts: Optional[torch.Tensor] = None,
                    need: int = 0) -> torch.Tensor:
    """The JAX ``cond`` as a 0-d bool tensor: not every row finished
    (``finished``) or not every window's buffer full (``counts >= need``),
    and ``pos < L``."""
    done = (finished.all() if finished is not None
            else (counts >= need).all())
    return ~done & (pos < L)


def loop_cond_kernel(pos: torch.Tensor, L: int, cont: torch.Tensor,
                     finished: Optional[torch.Tensor] = None,
                     counts: Optional[torch.Tensor] = None, need: int = 0,
                     handle: Optional[int] = None) -> torch.Tensor:
    """The condition kernel: writes the JAX ``cond`` into ``cont`` (a 0-d
    int32 on the card) and, with ``handle``, into that WHILE node's
    condition (inside the loop graph's body only). Returns ``cont``."""
    cb.require(pos, "pos", torch.int32, ())
    cb.require(cont, "cont", torch.int32, (), pos.device)
    fin, cnt, n = _flags(finished, counts)
    cb.launch(_lib().aries_loop_cond, pos, "decode loop condition", fin, cnt,
              n, need, cb.ptr(pos), L, handle or 0, int(handle is not None),
              cb.ptr(cont))
    cb.count(loop_cond_kernel)
    return cont


loop_cond_kernel.launches = 0


# ---------------------------------------------------------------------------
# The sampled rungs' draws
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow:
    c's low and high 16 bits multiply separately."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & M32


def _mix32(x):
    """The kernel's ``mix32`` (a 32-bit integer hash) on int64 tensors or
    Python ints holding uint32 values."""
    if isinstance(x, int):
        x = torch.tensor(x, dtype=torch.int64)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _seed_words(seed: int):
    seed &= (1 << 64) - 1
    return seed & M32, seed >> 32


def uniform_draw_plain(seed: int, pos: torch.Tensor, rows: int,
                       n_vocab: int) -> torch.Tensor:
    """(rows, n_vocab) f32 draws in (0, 1) at position ``pos`` (a 0-d
    integer tensor or an int), the kernel's bits."""
    dev = pos.device if isinstance(pos, torch.Tensor) else torch.device("cpu")
    lo, hi = _seed_words(seed)
    h0 = _mix32(torch.tensor(lo, device=dev) ^ _mix32(hi).to(dev))
    r = torch.arange(rows, device=dev, dtype=torch.int64)
    p = torch.as_tensor(pos, device=dev).long() & M32
    key = _mix32(_mix32(h0 ^ r) ^ p)                       # (rows,)
    v = torch.arange(n_vocab, device=dev, dtype=torch.int64)
    h = _mix32(key[:, None] ^ v[None, :])
    # 23 bits: (h >> 9) + 0.5 is exact in f32, so u never rounds to 1
    return ((h >> 9).float() + 0.5) * 2.0 ** -23


def uniform_draw_kernel(seed: int, pos: torch.Tensor, rows: int,
                        n_vocab: int) -> torch.Tensor:
    """The draw kernel: ``pos`` a 0-d int32 on the card."""
    cb.require(pos, "pos", torch.int32, ())
    u = torch.empty((rows, n_vocab), dtype=torch.float32, device=pos.device)
    lo, hi = _seed_words(seed)
    cb.launch(_lib().aries_uniform_draw, pos, "uniform draw", lo, hi,
              cb.ptr(pos), rows, n_vocab, cb.ptr(u))
    cb.count(uniform_draw_kernel)
    return u


uniform_draw_kernel.launches = 0


def uniform_draw(seed: int, pos: torch.Tensor, rows: int,
                 n_vocab: int) -> torch.Tensor:
    """The draws of a sampled step: the kernel for a position on the card,
    the plain version for one on the CPU."""
    if isinstance(pos, torch.Tensor) and pos.is_cuda:
        return uniform_draw_kernel(seed, pos, rows, n_vocab)
    return uniform_draw_plain(seed, pos, rows, n_vocab)


# ---------------------------------------------------------------------------
# The loop graph
# ---------------------------------------------------------------------------

_STAGES = {1: "adding the condition kernel's node",
           2: "adding the WHILE node", 3: "adding the step as its body",
           4: "instantiating the loop graph"}


def _check_build(err: int, stage: int) -> None:
    if err:
        ver = _lib().aries_loop_runtime_version()
        raise cb.CudaError(f"decode loop graph ({_STAGES.get(stage, stage)};"
                           f" CUDA runtime {ver})", err, "launch")


class DeviceLoop:
    """A decode call's loop as one CUDA graph on card ``dev``: the
    condition kernel on the state before the loop, then a WHILE node whose
    body is ``body()`` captured once by PyTorch (a child graph) followed by
    the condition kernel, which sets the node's handle.

    ``body`` updates the loop state in place (static buffers, read and
    written by address at every iteration); ``pos`` (0-d int32), the
    state's flags (``finished`` or ``counts`` with ``need``) and ``L`` are
    the condition's operands. The launches the capture records count at
    ``finish(iterations)``, when the caller has read how many iterations
    ran; ``body_nodes`` is the captured iteration's node count. Keep the
    state alive until ``close()``; the captured graph and its memory pool
    live as long as this object."""

    def __init__(self, dev: torch.device, body: Callable[[], None],
                 pos: torch.Tensor, L: int,
                 finished: Optional[torch.Tensor] = None,
                 counts: Optional[torch.Tensor] = None, need: int = 0):
        if dev.type != "cuda":
            raise ValueError("DeviceLoop needs a CUDA device")
        lib = _lib()
        self.dev = dev
        self.cont = torch.zeros((), dtype=torch.int32, device=dev)
        self._loop = _P()
        handle = _ULL()
        with torch.cuda.device(dev):
            cb.check(lib.aries_loop_create(ctypes.byref(self._loop),
                                           ctypes.byref(handle)),
                     "decode loop graph (creating its WHILE handle)")
        self.keep = (pos, finished, counts)  # the graph reads their memory

        def step():
            body()
            loop_cond_kernel(pos, L, self.cont, finished, counts, need,
                             handle=handle.value)

        try:
            # the body's launches, counted once per iteration at finish()
            with cb.recording() as self.recorded:
                self.graph = cb.capture(dev, step, keep_graph=True)
            nodes = _ULL()
            cb.check(lib.aries_graph_nodes(_P(self.graph.raw_cuda_graph()),
                                           ctypes.byref(nodes)),
                     "decode loop graph (counting its body's nodes)")
            self.body_nodes = nodes.value
            fin, cnt, n = _flags(finished, counts)
            stage = _I(0)
            with torch.cuda.device(dev):
                err = lib.aries_loop_build(
                    self._loop, _P(self.graph.raw_cuda_graph()), fin, cnt, n,
                    need, cb.ptr(pos), L, cb.ptr(self.cont),
                    ctypes.byref(stage))
            _check_build(err, stage.value)
        except BaseException:
            self.close()
            raise

    def run(self) -> None:
        """Launch the loop on the card's current stream (no host read);
        the condition kernel before the loop counts here."""
        cb.launch(_lib().aries_loop_launch, self.dev, "decode loop graph",
                  self._loop)
        cb.count(loop_cond_kernel)
        cb.count(DeviceLoop)

    def finish(self, iterations: int) -> None:
        """Count the body's launches ``iterations`` times over."""
        cb.add_counts(self.recorded, iterations)

    def close(self) -> None:
        """Free the loop graph (the captured step's graph goes with this
        object). Safe to call twice."""
        graph, self.graph = getattr(self, "graph", None), None
        if graph is not None:
            graph.reset()  # its memory pool
        if self._loop:
            with torch.cuda.device(self.dev):
                err = _lib().aries_loop_destroy(self._loop)
            self._loop = _P()
            cb.check(err, "decode loop graph (destroying it)")


DeviceLoop.launches = 0
