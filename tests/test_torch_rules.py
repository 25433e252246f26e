"""Rules of the PyTorch port (whisper_aries_tpu_torch):

  * no module of the port, and not chip_smoke.py or chip_device_ms.py,
    imports jax, jaxlib or anything of the JAX package (whisper_aries_tpu)
    — checked on the AST;
  * the engine runs on CUDA unless the caller asks for the CPU: with no
    card and no explicit device it raises, never carrying on quietly;
  * every kernel wrapper takes its plain version only for CPU tensors;
  * every kernel launches on the stream of its operands' card, never on
    the current device's (no ``cb.stream()`` without a device);
  * every file of the repo that reaches ``pl.pallas_call`` is named in
    PERF.md's kernel table.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "whisper_aries_tpu_torch"
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


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py",
                            ROOT / "chip_device_ms.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
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


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py",
                            ROOT / "chip_device_ms.py"],
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


@pytest.mark.parametrize("key,value", [
    ("decode.audio_ctx", "bucket"),
    ("decode.mel_backend", "pallas"),
    ("decode.multilingual", True),
])
def test_engine_refuses_unported_options(key, value):
    from whisper_aries_tpu_torch.config import load_config
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    cfg = load_config(overrides={key: value})
    with pytest.raises(ValueError, match=f"{key}={value!r} is not ported"):
        AriesTranscriber(device="cpu", config=cfg, allow_random=True,
                         model_size="tiny")


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
    from whisper_aries_tpu.audio import decode as jd
    from whisper_aries_tpu_torch.audio import decode as td
    from whisper_aries_tpu_torch.errors import AudioError

    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal(16000)).astype(np.float32)
    path = str(tmp_path / "a.wav")
    jd.write_wav(path, x, 16000)
    np.testing.assert_array_equal(td.load_audio(path), jd.load_audio(path))
    pre = td.AudioPreloader(path)
    assert abs(pre.duration - 1.0) < 1e-3
    # resampling: the port has the JAX package's numpy path (the native
    # polyphase codec is not ported yet)
    np.testing.assert_array_equal(td._resample_numpy(x, 22050, 16000),
                                  jd._resample_numpy(x, 22050, 16000))
    mp3 = tmp_path / "a.mp3"
    mp3.write_bytes(b"\xff\xfb")
    with pytest.raises(AudioError, match="WAV only"):
        td.load_audio(str(mp3))


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
