"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by nvcc into its own shared library with
a plain C interface and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.so csrc/<name>.cu

The libraries go to ``whisper_aries_tpu_torch/_build/`` (listed in
.gitignore) at first use and are rebuilt when a source is newer. The build
reads only the sources in this package. Processes that start at once (test
workers on one card) build each library once: the staleness check, the
build and the load run under a lock on a file in the build directory
(``audio/_native.py::build_lock``), so no process finds a library it has
loaded replaced behind it. ``build()`` starts one nvcc per
source, all at once, so the kernels build in parallel; ptxas' register and
spill report for each source is kept beside its library as ``<name>.log``.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

from whisper_aries_tpu_torch.audio._native import build_lock

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("mel", "encoder_attn", "encoder_attn_train", "decode_layers",
           "cross_attn", "beam_tail", "beam_reorder", "quant_matmul",
           "int8_gemm", "self_attn", "decode_loop", "decode_choice",
           "vocab_gemm", "probe_copy",
           "probe_mma", "probe_transpose", "probe_qa")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _so(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = _so(name)
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return so.stat().st_mtime < newest


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every stale source, one nvcc process each, all started
    together, under the build directory's lock (the sources are checked
    again once it is held: what another process built meanwhile is not
    built twice). Returns {name: seconds} for the sources built; raises
    with nvcc's output when one fails."""
    names = list(names)
    if not any(_stale(n) for n in names):
        return {}
    with build_lock(BUILD_DIR):
        return _build([n for n in names if _stale(n)])


def _build(todo) -> Dict[str, float]:
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.time()
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.{os.getpid()}.tmp.so"
        log = open(BUILD_DIR / f"{n}.log", "w")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    done: Dict[str, float] = {}
    failed = []
    for n, (p, tmp, log) in procs.items():
        rc = p.wait()
        log.close()
        done[n] = time.time() - t0
        if rc != 0:
            failed.append(n)
            continue
        os.replace(tmp, _so(n))  # atomic: concurrent builders never see
        # a half-written library
    if failed:
        msgs = "\n".join(
            f"--- {n} ---\n" + (BUILD_DIR / f"{n}.log").read_text()[-4000:]
            for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return done


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            with build_lock(BUILD_DIR):  # no rebuild replaces it meanwhile
                lib = ctypes.CDLL(str(_so(name)))
            _libs[name] = lib
        return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _device(t) -> torch.device:
    return t.device if isinstance(t, torch.Tensor) else torch.device(t)


def stream(t) -> ctypes.c_void_p:
    """The current stream of the card that holds ``t`` (a tensor or a
    device), not of the current device: a kernel runs where its operands
    are."""
    return ctypes.c_void_p(torch.cuda.current_stream(_device(t)).cuda_stream)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(t) -> int:
    """The SM count of the card that holds ``t`` (a tensor or a device)."""
    dev = _device(t)
    return _sm_count(dev.index if dev.index is not None
                     else torch.cuda.current_device())


def launch(fn, t, what: str, *args) -> None:
    """Call the C entry ``fn(*args, stream)`` on the card that holds ``t``:
    that card is the current device during the call (so a
    ``cudaGetDevice`` in C answers for it) and ``stream`` is its current
    stream. Raises on the returned error code."""
    with torch.cuda.device(_device(t)):
        check(fn(*args, stream(t)), what)


def capture(dev: torch.device, fn,
            keep_graph: bool = False) -> torch.cuda.CUDAGraph:
    """``fn``'s launches captured as one CUDA graph on card ``dev``, on a
    capture stream of that card, whatever the current device is. Replay it
    under ``torch.cuda.device(dev)``. Raises if the capture fails. The
    capture is thread-local: only this thread's unsafe CUDA calls break
    it, so replicas on other cards go on working in their own threads
    meanwhile. ``keep_graph`` keeps the cudaGraph_t
    (``raw_cuda_graph()``) uninstantiated, for a graph that embeds it."""
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    with torch.cuda.device(dev):
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev),
                              capture_error_mode="thread_local"):
            fn()
    return graph


# launch counters: every wrapper adds to its function's ``launches``
# (and, for the W8A16 GEMM, ``launches_by_path``) through ``count``, under
# one process lock, so the counts stay exact when replicas launch from
# several threads; a thread inside ``recording()`` adds to its own record
_count_lock = threading.Lock()
_count_local = threading.local()


def count(fn, n: int = 1, path: str = None) -> None:
    """Add ``n`` launches to wrapper ``fn`` (to its ``launches_by_path
    [path]`` too where ``path`` is given); inside ``recording()`` to the
    calling thread's record instead."""
    rec = getattr(_count_local, "record", None)
    if rec is not None:
        rec[(fn, path)] = rec.get((fn, path), 0) + n
        if path is not None:
            rec[(fn, None)] = rec.get((fn, None), 0) + n
        return
    with _count_lock:
        fn.launches += n
        if path is not None:
            fn.launches_by_path[path] += n


def bump(fn, attr: str, n: int = 1) -> None:
    """Add ``n`` to counter ``attr`` of ``fn`` (e.g. ``graph_replays``)
    under the counters' lock."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + n)


@contextlib.contextmanager
def recording():
    """The launches this thread counts inside the block, as {(wrapper,
    path or None): n}, kept out of the counters (a graph capture runs no
    kernel: its launches count at each replay)."""
    rec: Dict = {}
    _count_local.record = rec
    try:
        yield rec
    finally:
        _count_local.record = None


def add_counts(rec: Dict, times: int = 1) -> None:
    """Add a ``recording()`` record ``times`` over to the counters."""
    with _count_lock:
        for (fn, path), n in rec.items():
            if path is None:
                fn.launches += n * times
            else:
                fn.launches_by_path[path] += n * times


# csrc/hopper.cuh's codes beside cudaError_t values
ERR_BAD_ARGS, ERR_NO_TENSOR_MAP, ERR_TENSOR_MAP = 8998, 8999, 9000
ERR_ATTRIBUTE = 10000


class CudaError(RuntimeError):
    """A CUDA call in a C entry failed: ``code`` is its cudaError_t,
    ``stage`` "attribute" where cudaFuncSetAttribute refused the kernel's
    shared memory or cluster size, else "launch"."""

    def __init__(self, what: str, code: int, stage: str):
        super().__init__(f"{what}: CUDA {stage} failed with "
                         f"{error_text(code)}")
        self.code, self.stage = code, stage


def error_text(code: int) -> str:
    """A cudaError_t by the runtime's own text and its number (the number
    alone where there is no CUDA runtime to ask)."""
    if not torch.cuda.is_available():
        return f"error {code}"
    try:
        rt = torch.cuda.cudart()
        return f"{rt.cudaGetErrorString(rt.cudaError(code))} (error {code})"
    except (AttributeError, RuntimeError, TypeError, ValueError):
        return f"error {code}"


def check(err: int, what: str) -> None:
    if err == 0:
        return
    if err == ERR_BAD_ARGS:
        raise ValueError(f"{what}: the C entry refused its arguments")
    if err == ERR_NO_TENSOR_MAP:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled was not found")
    if ERR_TENSOR_MAP <= err < ERR_ATTRIBUTE:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a tensor "
                           f"map (CUresult {err - ERR_TENSOR_MAP})")
    if err >= ERR_ATTRIBUTE:
        raise CudaError(what, err - ERR_ATTRIBUTE, "attribute")
    raise CudaError(what, err, "launch")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
            device: torch.device = None) -> None:
    """Validate a CUDA kernel operand before its pointer goes to C."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
