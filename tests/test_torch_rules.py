"""Rules of the PyTorch port (whisper_aries_tpu_torch):

  * no module of the port, and not chip_smoke.py, chip_device_ms.py or
    chip_step_bits.py, imports jax, jaxlib or anything of the JAX package (whisper_aries_tpu)
    — checked on the AST; nor safetensors, transformers, tokenizers or
    huggingface_hub, which the card's machine lacks;
  * the port builds and loads its own native library (its C++ codecs,
    resampler and DTW) from its own sources into its own _build/, and
    reads nothing of the repo's native/;
  * the engine, the diarizer and run_pipeline run on CUDA unless the
    caller asks for the CPU: with no card and no explicit device they
    raise, never carrying on quietly; the port's entry points take every
    parameter of their JAX counterparts;
  * every kernel wrapper takes its plain version only for CPU tensors;
  * every kernel launches on the stream of its operands' card, never on
    the current device's (no ``cb.stream()`` without a device);
  * every file of the repo that reaches ``pl.pallas_call`` is named in
    PERF.md's kernel table;
  * the f32 training attention (csrc/encoder_attn_train.cu) computes in
    exact f32 on the CUDA cores, deterministically: its code (comments
    stripped) has no atomic, no TF32, no tensor-core instruction and no
    fast exponential, nothing is built with fast math, and chip_smoke.py
    bounds it by the f32 rate;
  * no kernel source sets a kernel's function attributes (its shared
    memory opt-in) behind a once-a-process flag: a per-card
    ``std::call_once``, ``aries_decode_init`` or every call.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "whisper_aries_tpu_torch"
#: the root scripts that run the port on the card
CARD_SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "chip_device_ms.py",
                ROOT / "chip_step_bits.py"]
FORBIDDEN = ("jax", "jaxlib", "whisper_aries_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + CARD_SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


#: packages the card's machine does not have: the port reads checkpoints
#: and tokenizer files itself
CHECKPOINT_PACKAGES = ("safetensors", "transformers", "tokenizers",
                       "huggingface_hub")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + CARD_SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_checkpoint_package(path):
    bad = [n for n in _imports(path)
           if n.split(".")[0] in CHECKPOINT_PACKAGES]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _streams_without_a_device(path: Path):
    """Calls of ``cb.stream()`` (ops/cuda_build.py's) or of
    ``torch.cuda.current_stream()`` that name no tensor or device: the
    current device's stream, which need not be the operands' card."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and not node.args
                and not node.keywords
                and isinstance(node.func, ast.Attribute)):
            continue
        f = node.func
        if f.attr == "stream" and getattr(f.value, "id", "") in (
                "cb", "cuda_build"):
            yield f"line {node.lineno}: cb.stream()"
        if f.attr == "current_stream":
            yield f"line {node.lineno}: current_stream()"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + CARD_SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_kernels_launch_on_their_operands_card(path):
    """Every stream a kernel launches on is named by its operand's device
    (``cb.stream(t)``), never taken from whichever card is current."""
    bad = list(_streams_without_a_device(path))
    assert not bad, f"{path.relative_to(ROOT)}: {bad}"


def test_stream_rule_itself(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("cb.stream()\ncb.stream(x)\n"
                   "torch.cuda.current_stream()\n"
                   "torch.cuda.current_stream(t.device)\n")
    assert [b.split(":")[0] for b in _streams_without_a_device(src)] == [
        "line 1", "line 3"]


#: the decode loop's bodies and the step they call (decoding/generate.py):
#: captured once into the loop graph, they must read nothing back
LOOP_BODIES = ("greedy_body", "beam_body", "_greedy_iteration",
               "_beam_iteration", "_penalised", "ngram_banned_mask",
               "apply_repetition_penalty", "device")
HOST_READS = ("item", "tolist", "cpu", "numpy", "nonzero", "synchronize")


def _host_reads(tree, names=LOOP_BODIES):
    """Host reads in the functions (or methods) of ``tree`` named in
    ``names``: a call of ``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``.nonzero()`` or ``synchronize()``, or ``bool()``,
    ``int()`` or ``float()`` of anything but a literal."""
    for fn in ast.walk(tree):
        if not (isinstance(fn, ast.FunctionDef) and fn.name in names):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in HOST_READS:
                yield f"{fn.name} line {node.lineno}: .{f.attr}()"
            if (isinstance(f, ast.Name) and f.id in ("bool", "int", "float")
                    and node.args
                    and not isinstance(node.args[0], ast.Constant)):
                yield f"{fn.name} line {node.lineno}: {f.id}()"


def test_decode_loop_bodies_read_nothing_back():
    """The loop bodies in decoding/generate.py (and the step's device
    form) make no host read: every read of device data inside a decode
    loop goes through the one counted helper, ``_Reads``."""
    path = PORT / "decoding" / "generate.py"
    tree = ast.parse(path.read_text(encoding="utf-8"))
    found = {fn.name for fn in ast.walk(tree)
             if isinstance(fn, ast.FunctionDef)}
    assert set(LOOP_BODIES) <= found
    bad = list(_host_reads(tree))
    assert not bad, bad


@pytest.mark.parametrize("line,found", [
    ("x.item()", True), ("bool(t.all())", True), ("int(pos)", True),
    ("t.tolist()", True), ("t.cpu()", True), ("m.nonzero()", True),
    ("torch.cuda.synchronize()", True), ("bool(1)", False),
    ("t.any()", False), ("max(a, 1e-6)", False)])
def test_decode_loop_read_rule_itself(line, found):
    tree = ast.parse(f"def greedy_body(st):\n    {line}\n")
    assert bool(list(_host_reads(tree))) == found


def test_forbidden_rule_itself():
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert _forbidden("whisper_aries_tpu.models.whisper")
    assert not _forbidden("whisper_aries_tpu_torch.models.whisper")


def test_engine_raises_without_a_card(monkeypatch):
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AriesTranscriber(allow_random=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        AriesTranscriber(device="cuda", allow_random=True)


def _params_of(path: Path, name: str, cls: str = None):
    """The parameter names of function ``name`` (a method of ``cls``) in
    the file at ``path``, read from its AST."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    scope = tree.body
    if cls is not None:
        scope = next(n for n in tree.body
                     if isinstance(n, ast.ClassDef) and n.name == cls).body
    fn = next(n for n in scope
              if isinstance(n, ast.FunctionDef) and n.name == name)
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


@pytest.mark.parametrize("jax_file,port_file,name,cls", [
    ("pipeline/engine.py", "pipeline/engine.py", "transcribe_file",
     "AriesTranscriber"),
    ("pipeline/run.py", "pipeline/run.py", "run_pipeline", None),
    ("pipeline/run.py", "pipeline/run.py", "get_transcriber", None),
    ("diarize/pipeline.py", "diarize/pipeline.py", "__init__",
     "DiarizationPipeline"),
    ("diarize/pipeline.py", "diarize/pipeline.py", "__call__",
     "DiarizationPipeline"),
    ("pipeline/engine.py", "pipeline/engine.py", "__init__",
     "AriesTranscriber"),
    ("pipeline/legacy.py", "pipeline/legacy.py", "__init__",
     "FixedUltraFastTranscriber"),
    ("pipeline/legacy.py", "pipeline/legacy.py", "transcribe_ultra_fast",
     "FixedUltraFastTranscriber"),
    ("decoding/generate.py", "decoding/generate.py",
     "beam_search_decode_sharded", None),
], ids=lambda v: v if isinstance(v, str) else "")
def test_entry_points_take_every_jax_parameter(jax_file, port_file, name,
                                               cls):
    """The port's entry points take every parameter of their JAX
    counterparts, by name (the port adds ``device``)."""
    want = _params_of(ROOT / "whisper_aries_tpu" / jax_file, name, cls)
    got = _params_of(PORT / port_file, name, cls)
    missing = [p for p in want if p not in got]
    assert not missing, f"{port_file}::{name} lacks {missing}"
    assert set(got) - set(want) <= {"device"}


def test_pipeline_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """DiarizationPipeline() and run_pipeline() run on CUDA unless told
    otherwise: with no card and no device="cpu" they raise before doing
    anything; get_transcriber() too."""
    from whisper_aries_tpu_torch.diarize import DiarizationPipeline
    from whisper_aries_tpu_torch.pipeline.run import (
        get_transcriber,
        run_pipeline,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="DiarizationPipeline runs on a CUDA"):
        DiarizationPipeline()
    with pytest.raises(RuntimeError, match="CUDA"):
        DiarizationPipeline(device="cuda:0")
    with pytest.raises(RuntimeError, match="run_pipeline runs on a CUDA"):
        run_pipeline(str(tmp_path / "no-such.wav"),
                     output_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="AriesTranscriber runs on a CUDA"):
        get_transcriber("tiny", allow_random=True)
    assert DiarizationPipeline(device="cpu").device.type == "cpu"


def test_engine_builds_with_multilingual_off():
    """decode.multilingual=False, given explicitly, is the default: the
    engine builds and keeps it."""
    from whisper_aries_tpu_torch.config import load_config
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    cfg = load_config(overrides={"decode.multilingual": False})
    eng = AriesTranscriber(device="cpu", config=cfg, allow_random=True,
                           model_size="tiny")
    assert eng.config.decode.multilingual is False
    assert eng.device.type == "cpu"


def test_cuda_wrappers_reject_cpu_operands_for_kernels():
    """The kernel entry points themselves never accept CPU tensors (the
    plain-version dispatch lives only in the public wrappers)."""
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import decode_layers as DL
    from whisper_aries_tpu_torch.ops import mel as M

    x = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        W.encoder_attention_kernel(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        M.mel_power_kernel(torch.zeros((1, 480000)), 80)
    with pytest.raises(ValueError, match="CUDA"):
        DL.layer_norm_kernel(torch.zeros((2, 64), dtype=torch.bfloat16),
                             torch.ones(64), torch.zeros(64))


def test_beam_kernel_wrappers_reject_cpu_operands():
    """The grouped cross-attention, beam-tail and reorder kernel entry
    points refuse CPU tensors too."""
    from whisper_aries_tpu_torch.ops import beam_reorder as BR
    from whisper_aries_tpu_torch.ops import beam_tail as BT
    from whisper_aries_tpu_torch.ops import cross_attn as XA

    q = torch.zeros((1, 2, 5, 64))
    k8 = torch.zeros((1, 2, 8, 64), dtype=torch.int8)
    s = torch.ones((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        XA.cross_attention_q8_kernel(q, k8, s, k8, s)
    st = torch.zeros((1, 5), dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA"):
        BT.beam_tail_kernel(torch.zeros((5, 16)), torch.zeros((1, 5)), st, st,
                            st, torch.zeros(16), False, 5, 10, 9, 1, 8, 12)
    with pytest.raises(ValueError, match="CUDA"):
        BR.permute_rows_kernel(torch.zeros((2, 5, 3)),
                               torch.zeros((1, 5), dtype=torch.int32))


def test_int8_gemm_and_self_attn_wrappers_reject_cpu_operands():
    """The W8A16 GEMM and int8 self-attention kernel entry points refuse
    CPU tensors too."""
    from whisper_aries_tpu_torch.ops import quant as Q
    from whisper_aries_tpu_torch.ops import self_attn as SA

    with pytest.raises(ValueError, match="CUDA"):
        Q.quant_matmul_dequant_kernel(torch.zeros((6, 64), dtype=torch.bfloat16),
                                      torch.zeros((64, 32), dtype=torch.int8),
                                      torch.ones(32))
    q = torch.zeros((1, 2, 1, 64))
    k8 = torch.zeros((1, 2, 8, 64), dtype=torch.int8)
    s = torch.ones((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        SA.self_attention_q8_kernel(q, k8, s, k8, s, torch.zeros(8))


def test_config_is_a_copy_of_the_jax_config():
    """Same fields and defaults, so config files work for both."""
    from whisper_aries_tpu import config as jc
    from whisper_aries_tpu_torch import config as tc

    assert jc.AriesConfig().to_dict() == tc.AriesConfig().to_dict()
    env = {"ARIES_BEAM_SIZE": "3", "ARIES_MODEL": "tiny"}
    assert (jc.load_config(env=env).to_dict()
            == tc.load_config(env=env).to_dict())


def test_wav_decode_matches_jax(tmp_path):
    """WAV, resampling and MP3 load to the JAX package's samples to the
    bit: both packages decode and resample in their native libraries."""
    from tests.mp3_encoder import encode_mp3, lame_available
    from torch_port_util import jax_native_library
    from whisper_aries_tpu.audio import decode as jd
    from whisper_aries_tpu_torch.audio import _native as tn
    from whisper_aries_tpu_torch.audio import decode as td
    from whisper_aries_tpu_torch.errors import AudioError

    jax_native_library()  # never the JAX package's numpy path
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal(16000)).astype(np.float32)
    path = str(tmp_path / "a.wav")
    jd.write_wav(path, x, 16000)
    np.testing.assert_array_equal(td.load_audio(path), jd.load_audio(path))
    pre = td.AudioPreloader(path)
    assert abs(pre.duration - 1.0) < 1e-3
    # resampling: the port's native polyphase filter is the JAX package's
    np.testing.assert_array_equal(td.resample(x, 22050, 16000),
                                  jd.resample(x, 22050, 16000))
    # MP3 decodes (it raised "WAV only" before the port had its codecs)
    mp3 = tmp_path / "a.mp3"
    if tn.codec_available("mp3") and lame_available():
        mp3.write_bytes(encode_mp3(x, 16000))
        got = td.load_audio(str(mp3))
        assert got.dtype == np.float32 and abs(len(got) - len(x)) < 16000
        np.testing.assert_array_equal(got, jd.load_audio(str(mp3)))
    else:
        # no libmpg123 or no encoder on this host: .mp3 still reaches the
        # MP3 decoder, which names what it lacks or rejects the bytes
        mp3.write_bytes(b"\xff\xfb")
        with pytest.raises(AudioError, match="^MP3 decode failed|libmpg123"):
            td.load_audio(str(mp3))


#: what the child process below does with the port: load every codec it
#: can and a DTW, recording each file it opens and each library it loads
_NATIVE_PROBE = r"""
import json, sys
opened, loaded = [], []
def hook(event, args):
    if event == "open" and isinstance(args[0], str):
        opened.append(args[0])
    elif event == "ctypes.dlopen" and args[0]:
        loaded.append(str(args[0]))
sys.addaudithook(hook)
import numpy as np
from whisper_aries_tpu_torch.audio import _native, decode
from whisper_aries_tpu_torch.align import word_align
from whisper_aries_tpu_torch.serve import server
wav = sys.argv[1]
decode.write_wav(wav, np.zeros(8000, np.float32), 16000)
decode.load_audio(wav, 8000)
word_align.dtw_path(np.random.rand(4, 9))
for kind in ("mp3", "ogg", "av"):
    _native.codec_available(kind)
print(json.dumps({"opened": opened, "loaded": loaded,
                  "modules": sorted(sys.modules)}))
"""


def test_port_reads_no_native_dir_and_loads_only_its_build(tmp_path):
    """The port builds and loads its own libariesaudio.so from
    whisper_aries_tpu_torch/native/ into whisper_aries_tpu_torch/_build/:
    it opens nothing under the repo's native/ (the JAX package's sources),
    loads no library of this repo from anywhere else, and importing its
    server loads nothing of the JAX package."""
    import json
    import subprocess
    import sys

    r = subprocess.run([sys.executable, "-c", _NATIVE_PROBE,
                        str(tmp_path / "a.wav")], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    native = str(ROOT / "native") + "/"
    assert not [p for p in got["opened"] if p.startswith(native)]
    ours = [p for p in got["loaded"] if str(ROOT) in p or "aries" in p]
    assert ours == [str(PORT / "_build" / "libariesaudio.so")]
    assert not [m for m in got["modules"] if _forbidden(m)]


def test_serve_imports_nothing_of_the_jax_package():
    """serve/ is in the import scan above and names only the port."""
    files = sorted((PORT / "serve").glob("*.py"))
    assert [f.name for f in files] == ["__init__.py", "jobstore.py",
                                       "server.py"]
    for f in files:
        names = list(_imports(f))
        assert not [n for n in names if _forbidden(n)], f
    assert "whisper_aries_tpu_torch.pipeline.run" in _imports(
        PORT / "serve" / "server.py")


def _kernel_table() -> str:
    text = (ROOT / "PERF.md").read_text(encoding="utf-8")
    section = text.split("### Kernel table", 1)[1].split("\n### ", 1)[0]
    return "\n".join(l for l in section.splitlines() if l.startswith("|"))


def _pallas_files():
    """The repo's code outside the tests: the root scripts and every
    package and script directory."""
    paths = list(ROOT.glob("*.py"))
    for top in ("whisper_aries_tpu", "whisper_aries_tpu_torch", "scripts",
                "native", "examples"):
        paths += (ROOT / top).rglob("*.py")
    for path in sorted(paths):
        if "pl.pallas_call" in path.read_text(encoding="utf-8",
                                               errors="replace"):
            yield path.relative_to(ROOT).as_posix()


def test_every_pallas_kernel_file_is_in_the_kernel_table():
    table = _kernel_table()
    files = list(_pallas_files())
    assert len(files) >= 16  # 8 in the JAX package, 8 TPU probes in scripts/
    missing = [f for f in files if f"`{f}:" not in table]
    assert not missing, f"PERF.md's kernel table does not name {missing}"


def _table_rows():
    """(TPU functions as path:line, status, route cell) of each kernel-table
    row; a ``:line`` with no path continues the path before it."""
    import re

    for line in _kernel_table().splitlines()[2:]:
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) < 4:
            continue
        funcs, path = [], None
        for item in re.findall(r"`([^`]+)`", cells[1]):
            ref = item.split()[0]
            if ref.startswith(":") and path:
                ref = path + ref
            if re.fullmatch(r"[\w/.]+\.py:\d+", ref):
                path = ref.split(":")[0]
                funcs.append(ref)
        yield funcs, cells[2], cells[3]


def test_ported_kernel_rows_name_built_sources_and_card_checks():
    """Every kernel-table row whose status says "ported" names a csrc/
    source that ops/cuda_build.py builds, and chip_smoke.py holds a kernel
    entry with ``replaces=`` for each of its TPU functions."""
    import re

    from whisper_aries_tpu_torch.ops import cuda_build as cb

    smoke = (ROOT / "chip_smoke.py").read_text(encoding="utf-8")
    replaced = set(re.findall(r'replaces="([^"]+)"', smoke))
    ported = [r for r in _table_rows() if "ported" in r[1]]
    assert len(ported) >= 15  # 8 of the JAX package, 7 rows of scripts/
    for funcs, status, route in ported:
        sources = re.findall(r"(\w+)\.cu\b", route)
        assert funcs and sources, f"row {funcs} {route}"
        assert set(sources) <= set(cb.SOURCES), f"{route} not built"
        missing = [f for f in funcs if f not in replaced]
        assert not missing, f"chip_smoke.py has no replaces= for {missing}"


def test_no_kernel_row_is_left_to_port():
    """Every row of the kernel table has a Hopper counterpart: none still
    says "still to port"."""
    rows = list(_table_rows())
    assert len(rows) >= 15
    left = [funcs for funcs, status, _ in rows if "still to port" in status
            or "ported" not in status]
    assert not left, f"kernel-table rows not ported: {left}"


def test_attention_micro_row_names_the_build_functions():
    """Row 15 names the three attention-micro probes by their ``build``
    lines (the functions whose kernels reach ``pl.pallas_call``)."""
    want = ["scripts/probe_qa_micro.py:36", "scripts/probe_qa_opt.py:39",
            "scripts/probe_qa_bisect.py:36"]
    rows = [funcs for funcs, _, _ in _table_rows()
            if any("probe_qa" in f for f in funcs)]
    assert rows == [want]
    for ref in want:
        path, line = ref.split(":")
        text = (ROOT / path).read_text(encoding="utf-8").splitlines()
        assert text[int(line) - 1].startswith("def build(")


#: the command-line tools, each with its JAX counterpart; the ones that
#: run a model take ``--device`` (the JAX tools have none but transcribe)
CLIS = ("transcribe", "batch_transcribe", "diarize", "conversation",
        "meeting", "demo", "verify_setup", "install_packages", "clients")
DEVICE_CLIS = ("transcribe", "batch_transcribe", "diarize", "conversation",
               "demo", "verify_setup")


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser ``main`` builds, caught at its parse_args."""
    import argparse

    caught = {}

    def grab(self, args=None, namespace=None):
        caught["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        main(["x"])
    monkeypatch.undo()
    return caught["parser"]


def _options(parser):
    """{option string or positional dest: default}."""
    out = {}
    for a in parser._actions:
        if a.dest == "help":
            continue
        for name in a.option_strings or [a.dest]:
            out[name] = a.default
    return out


@pytest.mark.parametrize("name", CLIS)
def test_cli_takes_every_jax_flag_with_its_default(name, monkeypatch):
    """Each port CLI's parser has every option string (and positional) of
    its JAX counterpart with the same default, and ``--device`` where it
    runs a model; nothing else."""
    import importlib

    jax_main = importlib.import_module(f"whisper_aries_tpu.cli.{name}").main
    port_main = importlib.import_module(
        f"whisper_aries_tpu_torch.cli.{name}").main
    want = _options(_parser_of(jax_main, monkeypatch))
    got = _options(_parser_of(port_main, monkeypatch))
    missing = [o for o in want if o not in got]
    assert not missing, f"cli/{name} lacks {missing}"
    assert {o: got[o] for o in want} == want
    extra = set(got) - set(want)
    assert extra == ({"--device"} - set(want) if name in DEVICE_CLIS
                     else set())
    if name in DEVICE_CLIS:
        assert got["--device"] is None  # CUDA unless asked for the CPU


def test_cli_and_parallel_import_nothing_of_jax():
    """The new directories exist with their modules, and none imports
    jax or the JAX package (the scan above covers them too)."""
    cli = sorted(f.stem for f in (PORT / "cli").glob("*.py"))
    assert cli == sorted(CLIS + ("__init__",))
    par = sorted(f.stem for f in (PORT / "parallel").glob("*.py"))
    assert par == ["__init__", "mesh"]
    for f in list((PORT / "cli").glob("*.py")) + list(
            (PORT / "parallel").glob("*.py")):
        names = list(_imports(f))
        assert not [n for n in names if _forbidden(n)], f


def test_training_attention_is_a_second_counterpart_of_kernel_2():
    """The encoder's TPU attention kernel has two Hopper counterparts:
    row 2 (the bf16 serving kernel) and row 2t (the f32 training forward
    and backward), each naming its own built source, and chip_smoke.py
    holds a kernel entry for each of the three wrappers with the same
    ``replaces=``."""
    import re

    from whisper_aries_tpu_torch.ops import cuda_build as cb

    ref = "whisper_aries_tpu/models/whisper.py:337"
    rows = [r for r in _table_rows() if r[0] == [ref]]
    sources = sorted(re.findall(r"(\w+)\.cu\b", r[2])[0] for r in rows)
    assert sources == ["encoder_attn", "encoder_attn_train"]
    assert set(sources) <= set(cb.SOURCES)
    smoke = (ROOT / "chip_smoke.py").read_text(encoding="utf-8")
    names = re.findall(r'name="(encoder_attn\w*)"[^)]*?replaces="'
                       + re.escape(ref) + '"', smoke, re.S)
    assert sorted(set(names)) == ["encoder_attn", "encoder_attn_train",
                                  "encoder_attn_train_bwd"]


def test_training_modules_import_nothing_of_jax():
    """The training slice's modules exist, and none imports jax or the
    JAX package (the scan above covers them too)."""
    files = [PORT / "training" / f for f in ("__init__.py", "synth.py",
                                             "augment.py",
                                             "diarize_train.py")]
    files += [PORT / "pipeline" / "train.py",
              PORT / "pipeline" / "checkpoint.py",
              PORT / "eval" / "diarize_battery.py"]
    for f in files:
        assert f.exists(), f
        assert not [n for n in _imports(f) if _forbidden(n)], f


#: what the training attention's code must not hold: atomics (a sum in an
#: order that changes from run to run), TF32 and tensor-core products
#: (not exact f32), the fast exponential
TRAIN_ATTN_FORBIDDEN = {
    "atomic": r"atomic|\batom\.|\bred\.",
    "tf32": r"tf32",
    "tensor core": r"\bwgmma|\bwmma|\bmma\.|\bmma_|\bhgmma|\bhmma",
    "fast exp": r"__expf|ex2\.approx",
}


def _strip_comments(src: str) -> str:
    """C++ source without its // and /* */ comments (strings kept)."""
    import re

    return re.sub(r'//[^\n]*|/\*.*?\*/|("(?:\\.|[^"\\])*")',
                  lambda m: m.group(1) or " ", src, flags=re.S)


def _train_attn_findings(src: str):
    import re

    code = _strip_comments(src)
    return sorted(name for name, pat in TRAIN_ATTN_FORBIDDEN.items()
                  if re.search(pat, code, re.I))


def test_training_attention_is_exact_f32_without_atomics():
    """csrc/encoder_attn_train.cu, its comments stripped (the header note
    names what the design avoids), has no atomic, no TF32, no wgmma, wmma
    or mma instruction and no __expf; the kernels are built without fast
    math."""
    from whisper_aries_tpu_torch.ops import cuda_build as cb

    src = (PORT / "csrc" / "encoder_attn_train.cu").read_text(
        encoding="utf-8")
    assert "attn_fwd_kernel" in _strip_comments(src)
    assert _train_attn_findings(src) == []
    assert not [f for f in cb.NVCC_FLAGS if "fast" in f.lower()]


@pytest.mark.parametrize("line,found", [
    ("atomicAdd(p, x);", ["atomic"]),
    ('asm("red.global.add.f32 [%0], %1;" :: "l"(p), "f"(x));', ["atomic"]),
    ('asm("atom.global.add.f32 %0, [%1], %2;");', ["atomic"]),
    ('asm("cvt.rna.tf32.f32 %0, %1;");', ["tf32"]),
    ("torch_backend_allow_TF32 = 1;", ["tf32"]),
    ('asm("wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32");',
     ["tensor core", "tf32"]),
    ('asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32");',
     ["tensor core"]),
    ("mma_bf16(c, a, b0, b1);", ["tensor core"]),
    ("wmma::mma_sync(c, a, b, c);", ["tensor core"]),
    ("const float p = __expf(s - m);", ["fast exp"]),
    ('asm("ex2.approx.ftz.f32 %0, %1;");', ["fast exp"]),
    ("const float p = expf(s - m);  // not __expf, no atomicAdd, no tf32",
     []),
    ("/* wgmma and atomics avoided */ float x = expf(y);", []),
])
def test_training_attention_rule_itself(line, found):
    """The rule finds each forbidden form in code and none in comments."""
    assert _train_attn_findings(line) == found


def test_training_attention_bound_is_the_f32_rate():
    """chip_smoke.py divides the training attention's operations by the
    f32 rate of the CUDA cores (PEAK_F32), never a tensor-core rate: no
    design of this kind can read above it."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text(encoding="utf-8"))
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "kernel_encoder_attn_train")
    calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
             and isinstance(c.func, ast.Name) and c.func.id == "bound"]
    assert len(calls) == 2  # the forward's and the backward's
    for c in calls:
        assert isinstance(c.args[2], ast.Name) and c.args[2].id == "PEAK_F32"
    names = [k.value.value for c in ast.walk(fn) if isinstance(c, ast.Call)
             for k in c.keywords if k.arg == "name"
             and isinstance(k.value, ast.Constant)]
    assert names == ["encoder_attn_train", "encoder_attn_train_bwd"]


def _functions(code: str):
    """{name: body} of the functions of a C++ source (comments stripped):
    each top-level brace block (namespace and extern "C" blocks are looked
    through) preceded by a parameter list, named by the identifier before
    it; template and qualified names keep their last identifier."""
    import re

    out, depth, start, head = {}, 0, None, 0
    opens = []  # for each open brace: whether it counts as a level
    for i, ch in enumerate(code):
        if ch == "{":
            before = code[head:i]
            transparent = depth == 0 and re.search(
                r'(namespace\s*\w*|extern\s+"C")\s*$', before)
            opens.append(not transparent)
            if not transparent:
                if depth == 0:
                    start = i
                depth += 1
            else:
                head = i + 1
        elif ch == "}" and opens:
            if opens.pop():
                depth -= 1
                if depth == 0:
                    m = re.search(r"(\w+)\s*\([^;{}]*\)[^;{}()]*$",
                                  code[head:start])
                    if m:
                        out[m.group(1)] = code[start:i + 1]
            if depth == 0:
                head = i + 1
        elif ch == ";" and depth == 0:
            head = i + 1
    return out


def _smem_opt_in_findings(sources):
    """Places where a kernel's shared-memory (or other function-attribute)
    opt-in is kept once a process instead of once a card. ``sources``:
    {file name: C++ text}. A function sets attributes when its body calls
    cudaFuncSetAttribute or a function that does. Such a function must
    hold no ``static bool`` (nor any other static flag); a setter that
    keeps state keeps it in per-card ``std::once_flag`` arrays under
    ``std::call_once`` or ``once_per_card`` (common.cuh); the rest set the
    attribute at every call (on the current card), or are
    ``aries_decode_init``, which the Python side calls once a card."""
    import re

    funcs = {}
    for name, src in sources.items():
        for fn, body in _functions(_strip_comments(src)).items():
            funcs[f"{name}::{fn}"] = (fn, body)
    setters = {k for k, (_, b) in funcs.items()
               if "cudaFuncSetAttribute" in b}
    while True:
        names = {funcs[k][0] for k in setters}
        more = {k for k, (_, b) in funcs.items() if k not in setters and any(
            re.search(rf"\b{n}\b", b) for n in names)}
        if not more:
            break
        setters |= more
    found = []
    for k in sorted(setters):
        fn, body = funcs[k]
        if fn == "aries_decode_init":
            continue
        statics = re.findall(r"\bstatic\s+([\w:<>]+)[^;]*;", body)
        if re.search(r"\bstatic\s+(volatile\s+)?bool\b", body):
            found.append(f"{k}: static bool")
        elif statics and not (
                re.search(r"\bstatic\s+std::once_flag\s+\w+\s*\[", body)
                and re.search(r"\b(std::call_once\s*\(\s*\w+\s*\[|"
                              r"once_per_card\s*\()", body)):
            found.append(f"{k}: static {statics[0]} without a per-card "
                         "std::call_once")
    return found


def test_shared_memory_opt_in_is_set_once_a_card():
    """No kernel source keeps its cudaFuncSetAttribute opt-in behind a
    process-wide flag: the attribute belongs to the current card's
    context, so a second card's first launch would run without it."""
    import re

    sources = {p.name: p.read_text(encoding="utf-8")
               for p in sorted((PORT / "csrc").glob("*.cu*"))}
    assert _smem_opt_in_findings(sources) == []
    # the per-card guards are where the once-a-process flags were
    guarded = {"encoder_attn.cu": 1, "quant_matmul.cu": 2, "probe_qa.cu": 1,
               "cross_attn.cu": 1, "encoder_attn_train.cu": 1}
    for name, n in guarded.items():
        code = _strip_comments(sources[name])
        assert len(re.findall(r"static\s+std::once_flag\s+\w+\s*\[",
                              code)) == n, name
    assert "static bool" not in "".join(map(_strip_comments,
                                            sources.values()))


#: the old pattern (csrc/encoder_attn.cu before the repair), a per-card
#: guard, a per-call opt-in and a helper reached through a flag
OLD_OPT_IN = """
extern "C" int aries_encoder_attn(int B, void* stream) {
  static bool configured = false;  // the attribute is set once a process
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        encoder_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  return 0;
}
"""
PER_CARD = """
namespace {
template <typename QT>
int allow_smem() {
  static std::once_flag once[MAX_CARDS];
  static int status[MAX_CARDS];
  return once_per_card(once, status, [] {
    return (int)cudaFuncSetAttribute(k<QT>, attr, SMEM);
  });
}
}  // namespace
"""
PER_CALL = """
template <int K>
int launch_k(int smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(tail<K>, attr, smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
"""
HELPER_FLAG = """
int cross_allow_smem() {
  return (int)cudaFuncSetAttribute(k, attr, SMEM);  // a helper
}
int allow_smem() {
  static bool ready[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (!ready[dev]) {
    cross_allow_smem();
    ready[dev] = true;
  }
  return 0;
}
"""
ONCE_A_PROCESS = """
int allow() {
  static std::once_flag once;
  static int status;
  std::call_once(once, [] { status = cudaFuncSetAttribute(k, attr, 1); });
  return status;
}
"""


@pytest.mark.parametrize("src,found", [
    (OLD_OPT_IN, ["a.cu::aries_encoder_attn: static bool"]),
    (HELPER_FLAG, ["a.cu::allow_smem: static bool"]),
    (ONCE_A_PROCESS, ["a.cu::allow: static std::once_flag without a "
                      "per-card std::call_once"]),
    (PER_CARD, []),
    (PER_CALL, []),
    ("/* static bool configured; cudaFuncSetAttribute */ int f() "
     "{ return 0; }", []),
])
def test_shared_memory_opt_in_rule_itself(src, found):
    """The rule catches the old once-a-process flag, directly and around
    a helper, and a single once_flag; it passes a per-card guard, a
    per-call opt-in and a comment."""
    assert _smem_opt_in_findings({"a.cu": src}) == found
