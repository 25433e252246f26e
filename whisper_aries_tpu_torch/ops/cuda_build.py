"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by nvcc into its own shared library with
a plain C interface and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.so csrc/<name>.cu

The libraries go to ``whisper_aries_tpu_torch/_build/`` (listed in
.gitignore) at first use and are rebuilt when a source is newer. The build
reads only the sources in this package. ``build()`` starts one nvcc per
source, all at once, so the kernels build in parallel; ptxas' register and
spill report for each source is kept beside its library as ``<name>.log``.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no nvcc.
"""

from __future__ import annotations

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

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("mel", "encoder_attn", "decode_layers", "cross_attn",
           "beam_tail", "beam_reorder", "quant_matmul", "self_attn")
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
    together. Returns {name: seconds} for the sources built; raises with
    nvcc's output when one fails."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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


def capture(dev: torch.device, fn) -> torch.cuda.CUDAGraph:
    """``fn``'s launches captured as one CUDA graph on card ``dev``, on a
    capture stream of that card, whatever the current device is. Replay it
    under ``torch.cuda.device(dev)``. Raises if the capture fails."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev):
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev)):
            fn()
    return graph


# csrc/hopper.cuh's codes beside cudaError_t values
ERR_NO_TENSOR_MAP, ERR_TENSOR_MAP = 8999, 9000


def check(err: int, what: str) -> None:
    if err == ERR_NO_TENSOR_MAP:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled was not found")
    if err >= ERR_TENSOR_MAP:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a tensor "
                           f"map (CUresult {err - ERR_TENSOR_MAP})")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


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
