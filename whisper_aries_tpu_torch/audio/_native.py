"""ctypes bindings to the port's native host runtime.

The C++ sources are the port's own copies under
``whisper_aries_tpu_torch/native/``: RIFF/WAVE decode and the polyphase
Kaiser-sinc resampler (``ariesaudio.cpp``), FLAC (``ariesflac.cpp``), MP3
over the system libmpg123 (``ariesmp3.cpp``), Ogg/Vorbis over the system
libvorbisfile (``ariesogg.cpp``), m4a/aac/wma and video audio tracks over
the system libavformat / libavcodec (``ariesav.cpp``, compiled in only
where ``<libavformat/avformat.h>`` preprocesses) and the word aligner's
DTW (``ariesdtw.cpp``). The system codec libraries are opened with
``dlopen`` when first used, so the library loads, and WAV and FLAC work,
on a host without them.

``library()`` builds one ``libariesaudio.so`` with g++ into the gitignored
``whisper_aries_tpu_torch/_build/`` at first use, and again whenever a
source is newer than it. Processes that start at once (test workers) build
it once: the check and the build run under a lock on a file beside the
library, so a second process waits for the first build and loads that
file, and no library a process has loaded is replaced behind it. Nothing
falls back: a failed build raises with the
compiler's output, and a codec whose system library does not resolve
raises ``AudioError`` naming that library.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

from whisper_aries_tpu_torch.errors import AudioError

_PKG = Path(__file__).resolve().parents[1]
NATIVE_DIR = _PKG / "native"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libariesaudio.so"
CORE_SOURCES = ("ariesaudio.cpp", "ariesflac.cpp", "ariesmp3.cpp",
                "ariesogg.cpp", "ariesdtw.cpp")
AV_SOURCE = "ariesav.cpp"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

#: the system library each dlopen'd codec needs, as its errors name it
CODEC_LIBRARIES = {"mp3": "libmpg123", "ogg": "libvorbisfile",
                   "av": "libavformat"}

_lock = threading.Lock()
_lib = None

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_ubyte)
_I32P = ctypes.POINTER(ctypes.c_int32)
_DECODE_ARGS = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_F32P),
                ctypes.POINTER(ctypes.c_int64), _I32P]
#: (name, restype, argtypes) of every C entry the core sources export
_CORE_ENTRIES = (
    ("aries_free", None, [ctypes.c_void_p]),
    ("aries_decode_wav", ctypes.c_int32, _DECODE_ARGS),
    ("aries_resample", ctypes.c_int32,
     [_F32P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
      ctypes.POINTER(_F32P), ctypes.POINTER(ctypes.c_int64)]),
    ("aries_decode_flac", ctypes.c_int32, _DECODE_ARGS),
    ("aries_mp3_available", ctypes.c_int32, []),
    ("aries_decode_mp3", ctypes.c_int32, _DECODE_ARGS),
    ("aries_ogg_available", ctypes.c_int32, []),
    ("aries_decode_ogg", ctypes.c_int32, _DECODE_ARGS),
    ("aries_encode_ogg_vorbis", ctypes.c_int32,
     [_F32P, ctypes.c_int64, ctypes.c_int32, ctypes.c_float,
      ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_int64)]),
    ("aries_dtw", ctypes.c_int32,
     [ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int32,
      _I32P, _I32P]),
)
_AV_ENTRIES = (
    ("aries_av_available", ctypes.c_int32, []),
    ("aries_decode_av", ctypes.c_int32, _DECODE_ARGS),
    ("aries_encode_m4a", ctypes.c_int32,
     [_F32P, ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(_U8P),
      ctypes.POINTER(ctypes.c_int64)]),
)

_WAV_ERRORS = {1: "not a RIFF/WAVE file", 2: "missing/invalid fmt chunk",
               3: "missing/empty data chunk", 4: "unsupported sample format",
               5: "allocation failure", 6: "bad arguments"}
_FLAC_ERRORS = {10: "not a FLAC stream", 11: "bad STREAMINFO",
                12: "truncated stream", 13: "bad frame",
                14: "unsupported stream", 15: "allocation failure"}


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


@functools.lru_cache(maxsize=None)
def av_headers() -> bool:
    """Whether ``<libavformat/avformat.h>`` preprocesses: ``ariesav.cpp``
    is compiled in only then (its structs' layouts come from the
    headers)."""
    r = subprocess.run([_cxx(), "-E", "-x", "c++", "-"],
                       input=b"#include <libavformat/avformat.h>\n",
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return r.returncode == 0


def sources():
    """The sources this host's library is built from."""
    names = CORE_SOURCES + ((AV_SOURCE,) if av_headers() else ())
    return [NATIVE_DIR / n for n in names]


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built for s in sources())


def build() -> None:
    """Compile the sources into ``LIB_PATH``: into a file of this process
    first, renamed into place, so concurrent builders never load a
    half-written library. Raises RuntimeError with g++'s output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libariesaudio.{os.getpid()}.tmp.so"
    cmd = [_cxx(), *CXXFLAGS, "-o", str(tmp), *map(str, sources()), "-ldl"]
    r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {LIB_PATH.name} failed ({' '.join(cmd)}):\n"
            + r.stdout.decode(errors="replace")[-8000:])
    os.replace(tmp, LIB_PATH)


@contextlib.contextmanager
def build_lock(build_dir: Path):
    """An exclusive lock across processes on ``build_dir/.build.lock``
    (``flock``: released when the holder exits, however it exits)."""
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".build.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _bind(lib: ctypes.CDLL, entries) -> None:
    for name, restype, argtypes in entries:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def library() -> ctypes.CDLL:
    """The loaded library, built first when missing or stale (checked
    again under the build lock, so processes that found it stale at once
    build it once)."""
    global _lib
    with _lock:
        if _lib is None:
            with build_lock(BUILD_DIR):
                if _stale():
                    build()
                lib = ctypes.CDLL(str(LIB_PATH))
            _bind(lib, _CORE_ENTRIES)
            lib.has_av = hasattr(lib, "aries_av_available")
            if lib.has_av:
                _bind(lib, _AV_ENTRIES)
            _lib = lib
        return _lib


def av_built() -> bool:
    """Whether the library holds the libavformat decoder (built where the
    headers were found)."""
    return library().has_av


def codec_available(kind: str) -> bool:
    """Whether codec ``kind`` ("mp3", "ogg" or "av") has its system library:
    ``dlopen`` resolves every symbol it needs."""
    lib = library()
    if kind == "mp3":
        return bool(lib.aries_mp3_available())
    if kind == "ogg":
        return bool(lib.aries_ogg_available())
    if kind == "av":
        return lib.has_av and bool(lib.aries_av_available())
    raise ValueError(f"unknown codec {kind!r}")


def require(kind: str) -> ctypes.CDLL:
    """The library, once codec ``kind`` is known to have its system
    library; else AudioError naming that library."""
    if not codec_available(kind):
        name = CODEC_LIBRARIES[kind]
        if kind == "av" and not av_built():
            raise AudioError(f"{kind} decode needs the system {name}: its "
                             f"headers were not found when {LIB_PATH.name} "
                             "was built")
        raise AudioError(f"{kind} decode needs the system {name}, which does "
                         "not resolve on this host")
    return library()


def _take(lib, out, n: int) -> np.ndarray:
    """Copy a malloc'd C buffer of ``n`` items out and free it."""
    try:
        return np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.aries_free(out)


def _decode(lib, fn, data: bytes, what: str, errors: dict
            ) -> Tuple[np.ndarray, int]:
    out = _F32P()
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    status = fn(data, len(data), ctypes.byref(out), ctypes.byref(n),
                ctypes.byref(sr))
    if status != 0:
        raise AudioError(f"{what} decode failed: "
                         f"{errors.get(status, f'status {status}')}")
    return _take(lib, out, n.value), int(sr.value)


_DL_ERRORS = {-1: "bad arguments", -2: "system library not found",
               -3: "decoder error"}


def decode_wav(data: bytes) -> Tuple[np.ndarray, int]:
    """WAV bytes -> (mono float32, sample rate): every PCM flavour (u8,
    s16, s24, s32, f32, f64, WAVE_FORMAT_EXTENSIBLE), channels averaged."""
    lib = library()
    return _decode(lib, lib.aries_decode_wav, data, "WAV", _WAV_ERRORS)


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """FLAC bytes -> (mono float32, sample rate)."""
    lib = library()
    return _decode(lib, lib.aries_decode_flac, data, "FLAC", _FLAC_ERRORS)


def decode_mp3(data: bytes) -> Tuple[np.ndarray, int]:
    """MP3 bytes -> (mono float32, sample rate) over the system libmpg123."""
    lib = require("mp3")
    return _decode(lib, lib.aries_decode_mp3, data, "MP3", _DL_ERRORS)


def decode_ogg(data: bytes) -> Tuple[np.ndarray, int]:
    """Ogg/Vorbis bytes -> (mono float32, sample rate) over the system
    libvorbisfile."""
    lib = require("ogg")
    return _decode(lib, lib.aries_decode_ogg, data, "OGG", _DL_ERRORS)


def decode_av(data: bytes) -> Tuple[np.ndarray, int]:
    """Any libavformat container (m4a/aac/wma, the audio track of
    mp4/mkv/webm/avi/mov) -> (mono float32, sample rate)."""
    lib = require("av")
    return _decode(lib, lib.aries_decode_av, data, "AV",
                   {**_DL_ERRORS, -3: "demux/decode error"})


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase Kaiser-windowed-sinc rational resample of mono float32
    (32 taps a phase, beta 12.984, cut-off 0.945 of the lower Nyquist)."""
    lib = library()
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = _F32P()
    n = ctypes.c_int64()
    status = lib.aries_resample(x.ctypes.data_as(_F32P), x.shape[0], sr_in,
                                sr_out, ctypes.byref(out), ctypes.byref(n))
    if status != 0:
        raise AudioError(f"resample {sr_in} -> {sr_out} Hz failed: "
                         f"{_WAV_ERRORS.get(status, status)}")
    return _take(lib, out, n.value)


def _encode(lib, fn, audio: np.ndarray, *args) -> bytes:
    x = np.ascontiguousarray(np.clip(audio, -1.0, 1.0), dtype=np.float32)
    out = _U8P()
    n = ctypes.c_int64()
    status = fn(x.ctypes.data_as(_F32P), len(x), *args, ctypes.byref(out),
                ctypes.byref(n))
    if status != 0:
        raise AudioError(f"encode failed: status {status}")
    return _take(lib, out, n.value).tobytes()


def encode_ogg(audio: np.ndarray, sample_rate: int,
               quality: float = 0.4) -> bytes:
    """Mono float32 -> Ogg/Vorbis bytes over the system libvorbisenc (test
    vectors only)."""
    lib = require("ogg")
    return _encode(lib, lib.aries_encode_ogg_vorbis, audio, sample_rate,
                   ctypes.c_float(quality))


def encode_m4a(audio: np.ndarray, sample_rate: int) -> bytes:
    """Mono float32 -> .m4a (AAC in mp4) bytes over the system libavcodec
    (test vectors only)."""
    lib = require("av")
    return _encode(lib, lib.aries_encode_m4a, audio, sample_rate)


def dtw(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The monotonic DTW path through ``cost`` (n, m), n and m >= 1:
    (text indices, time indices) as int32, from (0, 0) to (n-1, m-1); ties
    go to the first of diagonal, up, left."""
    lib = library()
    n, m = cost.shape
    c = np.ascontiguousarray(cost, dtype=np.float64)
    ti = np.empty((n + m,), np.int32)
    tj = np.empty((n + m,), np.int32)
    k = lib.aries_dtw(c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, m,
                      ti.ctypes.data_as(_I32P), tj.ctypes.data_as(_I32P))
    if k < 0:
        raise ValueError(f"aries_dtw refused a {n} x {m} cost matrix")
    # the C backtrace writes the path end first
    return ti[:k][::-1].copy(), tj[:k][::-1].copy()
