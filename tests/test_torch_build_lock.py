"""Concurrent first builds of the port's native libraries: processes that
start at once on an empty build directory (the suite's workers on a fresh
checkout) compile each library once, under the build directory's lock,
and every one of them maps the same live file.

Each case starts three child processes that point the build module at a
temporary build directory and a stub compiler (a script that logs its run,
waits a second so the children overlap, and builds a one-function
library with the host's g++), load the library, wait until all three have
loaded it, and report the libraries mapped in their address space."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from torch_port_util import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CHILDREN = 3

#: a compiler stand-in: logs the output it is asked for, waits, then
#: compiles the first source argument as C++ into that output
STUB = """#!/bin/sh
out=""
src=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  case "$a" in *.cpp|*.cu) [ -z "$src" ] && src="$a" ;; esac
  prev="$a"
done
if [ -n "$out" ]; then
  echo "$out" >> "{log}"
  sleep 1
  exec g++ -shared -fPIC -x c++ -o "$out" "$src"
fi
exec g++ "$@"
"""

SOURCE = 'extern "C" int aries_probe_answer() { return 42; }\n'

#: the native library's child: the module pointed at the temporary tree
NATIVE_CHILD = """
import json, os, sys, time
from pathlib import Path
from whisper_aries_tpu_torch.audio import _native as tn
tmp = Path(sys.argv[1])
tn.NATIVE_DIR = tmp / "native"
tn.BUILD_DIR = tmp / "build"
tn.LIB_PATH = tn.BUILD_DIR / "libariesaudio.so"
tn.CORE_SOURCES = ("probe.cpp",)
tn._CORE_ENTRIES = (("aries_probe_answer", tn.ctypes.c_int, []),)
tn.av_headers = lambda: False
lib = tn.library()
answer = lib.aries_probe_answer()
"""

#: the CUDA build's child: the stub in place of nvcc
CUDA_CHILD = """
import json, os, sys, time
from pathlib import Path
from whisper_aries_tpu_torch.ops import cuda_build as cb
tmp = Path(sys.argv[1])
cb.CSRC = tmp / "csrc"
cb.BUILD_DIR = tmp / "build"
cb.NVCC_FLAGS = ()
cb.nvcc_path = lambda: str(tmp / "stub.sh")
lib = cb.library("probe")
lib.aries_probe_answer.restype = cb.ctypes.c_int
answer = lib.aries_probe_answer()
"""

#: both children end alike: mark this one loaded, wait for the others,
#: then report what this process maps
REPORT = """
(tmp / f"loaded.{os.getpid()}").touch()
for _ in range(600):
    if len(list(tmp.glob("loaded.*"))) >= int(sys.argv[2]):
        break
    time.sleep(0.1)
with open("/proc/self/maps") as f:
    maps = sorted({l.split(None, 5)[-1].strip() for l in f
                   if str(tmp) in l})
print(json.dumps({"answer": answer, "maps": maps}))
"""


def _tree(tmp_path: Path, src_dir: str, src_name: str) -> Path:
    (tmp_path / src_dir).mkdir()
    (tmp_path / src_dir / src_name).write_text(SOURCE)
    stub = tmp_path / "stub.sh"
    stub.write_text(STUB.format(log=tmp_path / "compiles.log"))
    stub.chmod(0o755)
    return stub


def _run_children(tmp_path: Path, body: str, env: dict):
    code = textwrap.dedent(body) + textwrap.dedent(REPORT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path),
                               str(CHILDREN)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(CHILDREN)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-4000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    compiles = (tmp_path / "compiles.log").read_text().split()
    return outs, compiles


def _env(**extra) -> dict:
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return env


def _held(outs, compiles, lib: Path) -> None:
    assert len(compiles) == 1, compiles          # one build, not one a child
    assert all(o["answer"] == 42 for o in outs)
    for o in outs:                                # the same live file
        assert o["maps"] == [str(lib)], o["maps"]
        assert not any("(deleted)" in m for m in o["maps"])


def test_native_library_builds_once_across_processes(tmp_path, monkeypatch):
    """Three processes load the native library from an empty build
    directory at once: g++ runs once, each maps the one library file (none
    a replaced, deleted one) and the library is not stale afterwards."""
    from whisper_aries_tpu_torch.audio import _native as tn

    stub = _tree(tmp_path, "native", "probe.cpp")
    outs, compiles = _run_children(tmp_path, NATIVE_CHILD,
                                   _env(CXX=str(stub)))
    lib = tmp_path / "build" / "libariesaudio.so"
    _held(outs, compiles, lib)
    monkeypatch.setattr(tn, "NATIVE_DIR", tmp_path / "native")
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tn, "LIB_PATH", lib)
    monkeypatch.setattr(tn, "CORE_SOURCES", ("probe.cpp",))
    monkeypatch.setattr(tn, "av_headers", lambda: False)
    assert not tn._stale()


def test_cuda_libraries_build_once_across_processes(tmp_path, monkeypatch):
    """The same for ops/cuda_build.py, with a stub in place of nvcc (the
    CPU has none): one compile of the source, one library mapped by every
    process, and ``_stale`` false afterwards."""
    from whisper_aries_tpu_torch.ops import cuda_build as cb

    _tree(tmp_path, "csrc", "probe.cu")
    outs, compiles = _run_children(tmp_path, CUDA_CHILD, _env())
    lib = tmp_path / "build" / "libprobe.so"
    _held(outs, compiles, lib)
    monkeypatch.setattr(cb, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path / "build")
    assert not cb._stale("probe")


def test_cuda_build_rechecks_under_the_lock(tmp_path, monkeypatch):
    """A source found stale before the lock but built by another process
    while this one waited for it is not compiled again."""
    from whisper_aries_tpu_torch.audio import _native as tn
    from whisper_aries_tpu_torch.ops import cuda_build as cb

    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "probe.cu").write_text(SOURCE)
    monkeypatch.setattr(cb, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path / "build")
    built = []

    def other_process_built_it(build_dir):
        (build_dir).mkdir(parents=True, exist_ok=True)
        (build_dir / "libprobe.so").write_bytes(b"")
        return tn.build_lock(build_dir)

    monkeypatch.setattr(cb, "build_lock", other_process_built_it)
    monkeypatch.setattr(cb, "_build", lambda todo: built.extend(todo) or {})
    assert cb.build(["probe"]) == {}
    assert built == []


@pytest.mark.parametrize("stale_before", [True, False])
def test_native_library_rechecks_under_the_lock(tmp_path, monkeypatch,
                                                stale_before):
    """``library()`` asks whether the library is stale only once it holds
    the lock, and builds only then."""
    from whisper_aries_tpu_torch.audio import _native as tn

    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path)
    held = []

    def stale():
        held.append(_locked(tmp_path))
        return stale_before

    monkeypatch.setattr(tn, "_stale", stale)
    builds = []
    monkeypatch.setattr(tn, "build", lambda: builds.append(_locked(tmp_path)))
    loaded = []

    class FakeLib:
        def __getattr__(self, name):
            if name.startswith("aries_av"):
                raise AttributeError(name)
            return type("Fn", (), {})()

    monkeypatch.setattr(tn.ctypes, "CDLL",
                        lambda path: loaded.append(path) or FakeLib())
    tn.library()
    assert held == [True]
    assert builds == ([True] if stale_before else [])
    assert loaded == [str(tn.LIB_PATH)]


def _locked(build_dir: Path) -> bool:
    """Whether another process holds ``build_dir``'s build lock now (a
    child's non-blocking attempt on it fails)."""
    code = ("import fcntl, sys\n"
            "f = open(sys.argv[1], 'a')\n"
            "try:\n"
            "    fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)\n"
            "except BlockingIOError:\n"
            "    sys.exit(3)\n")
    r = subprocess.run([sys.executable, "-c", code,
                        str(build_dir / ".build.lock")])
    return r.returncode == 3
