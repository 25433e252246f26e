"""The port's attention-micro probes (whisper_aries_tpu_torch/scripts/
probe_qa_micro.py, probe_qa_opt.py, probe_qa_bisect.py) against the TPU
probes of the same names in scripts/, on the CPU.

Each TPU script reads ``REPS = int(sys.argv[1])`` and runs its probe at
import, so it is loaded through ``ast`` (its imports, assignments and
definitions, without the top-level loop) with ``sys.argv`` set first; its
``build(variant)`` kernel body then runs through ``pl.pallas_call`` in
Pallas interpret mode, with the script's own operands (q, k, v, wo and
lgb or rmask) and the script's own call arguments. Nothing in scripts/ is
edited. The port's ``build(variant, reps, device="cpu")`` (the plain
version of the kernel) gets the same operands.

Tolerance of the (8, 128) answer, as a share of max |want|: 1e-3 (the f32
sums of the two frameworks differ in order, and a bf16 rounding of a
probability may flip where its f32 value sits at a midpoint); smonly's
answer is the probabilities themselves, within one bf16 step (2^-8) of
the largest. Each limit lies below the same error of the named mistakes
of the port's plain version: the padded keys scored (0.177), the
normalisation moved across P.V (6.6e-3), the last head's P.V dropped;
for qk, the next head's q. The checksum of everything a micro computes is
held within 1e-5 of the sum of |terms|, below the error of a checksum of
only what the answer reads.

The kernel itself runs on the card only (tests/test_torch_cuda.py,
chip_smoke.py)."""

import ast
import functools
import importlib
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from whisper_aries_tpu_torch.scripts import common
from whisper_aries_tpu_torch.scripts import probe_qa_bisect as PB
from whisper_aries_tpu_torch.scripts import probe_qa_micro as PQ
from whisper_aries_tpu_torch.scripts import probe_qa_opt as PO
from whisper_aries_tpu_torch.scripts import qa_micro as QA

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
CSRC = ROOT / "whisper_aries_tpu_torch" / "csrc"
REPS = 2
MODULES = {"probe_qa_micro": (PQ, "lgb"), "probe_qa_opt": (PO, "rmask"),
           "probe_qa_bisect": (PB, "rmask")}
CASES = [(s, v) for s, (m, _) in MODULES.items() for v in m.VARIANTS]


@functools.lru_cache(maxsize=None)
def _tpu(name: str) -> dict:
    """A TPU script's namespace from its imports, assignments and
    definitions only (the probe loop dropped), with REPS from sys.argv."""
    path = SCRIPTS / f"{name}.py"
    tree = ast.parse(path.read_text(encoding="utf-8"))
    keep = (ast.Import, ast.ImportFrom, ast.Assign, ast.FunctionDef)
    tree.body = [n for n in tree.body if isinstance(n, keep)]
    ns = {"__file__": str(path), "__name__": f"tpu_{name}"}
    argv = sys.argv
    sys.argv = [str(path), str(REPS)]
    try:
        exec(compile(tree, str(path), "exec"), ns)
    finally:
        sys.argv = argv
    assert ns["REPS"] == REPS
    return ns


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pl.pallas_call`` of the test runs in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))


def _tpu_answer(name: str, variant: str) -> np.ndarray:
    """The TPU script's call of ``build(variant)`` on its own operands."""
    ns = _tpu(name)
    f = pl.pallas_call(
        ns["build"](variant),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 5,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        compiler_params=pltpu.CompilerParams(
            vmem_limit_bytes=120 * 1024 * 1024))
    extra = ns["lgb"] if name == "probe_qa_micro" else ns["rmask"]
    return np.asarray(f(ns["q"], ns["k"], ns["v"], ns["wo"], extra))


def _torch(x) -> torch.Tensor:
    a = np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)
    t = torch.from_numpy(a.copy())
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("name", list(MODULES))
def test_inputs_are_the_tpu_scripts_bits(name):
    """The port's inputs carry the TPU script's bits: f64 draws rounded to
    bf16 by torch as by JAX, the same int8 weights and f32 buffers."""
    ns = _tpu(name)
    extra = MODULES[name][1]
    ops = QA.inputs(torch.device("cpu"), extra)
    for key in ("q", "k", "v", "wo", extra):
        want = _torch(ns[key])
        assert ops[key].dtype == want.dtype, key
        assert torch.equal(ops[key], want), key
    assert (ns["H"], ns["dh"], ns["bq"], ns["Tp"], ns["T"], ns["d"]) == (
        QA.H, QA.DH, QA.BQ, QA.TP, QA.T, QA.D)


@pytest.mark.parametrize("name,variant", CASES,
                         ids=[f"{s}-{v}" for s, v in CASES])
def test_variant_matches_the_tpu_probe(interpret, name, variant):
    """Every variant at the scripts' full shapes, REPS 2: the port's plain
    version against the TPU build in interpret mode, within the limit,
    and every named mistake of the port farther from the TPU's answer
    than the limit."""
    module, extra = MODULES[name]
    want = torch.from_numpy(_tpu_answer(name, variant).copy())
    ops = QA.inputs(torch.device("cpu"), extra)
    args = tuple(ops[n] for n in ("q", "k", "v", "wo", extra))
    got = module.build(variant, REPS, device="cpu")(*args)
    assert got.shape == (8, 128) and torch.isfinite(want).all()
    spec = module.VARIANTS[variant]
    limit = QA.LIMIT_SM if spec.phase == "sm" else QA.LIMIT
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    assert err <= limit, (err, limit)
    wrong = QA.mistakes(spec, ops, REPS, extra)
    assert wrong
    for what, x in wrong.items():
        assert float((x - want).abs().max()) / scale > limit, what


@pytest.mark.parametrize("name,variant", CASES,
                         ids=[f"{s}-{v}" for s, v in CASES])
def test_hold_and_checksum(name, variant):
    """The port's hold passes its own plain answer and checksum, catches a
    checksum of only the rows the answer reads, and the checksum is the
    fold weight times the sum of everything the micro computes."""
    module, extra = MODULES[name]
    spec = module.VARIANTS[variant]
    ops = QA.inputs(torch.device("cpu"), extra)
    x, whole = QA.micro_plain(spec, *(ops[n] for n in
                                      ("q", "k", "v", "wo", extra)))
    assert whole.numel() == (QA.D * QA.BQ if spec.phase == "all"
                             else QA.H * QA.BQ * QA.TP)
    want = QA.plain(spec, ops, REPS, extra)
    cs = QA.fold_weight(REPS) * float(whole.double().sum())
    res = QA.hold_variant(spec, ops, REPS, extra, want, cs)
    assert res["ok"] and res["err"] == 0.0 and res["checksum"]["err"] == 0.0
    read = whole[0] if spec.phase != "all" else whole
    only = QA.fold_weight(REPS) * float(read[:8, :128].double().sum())
    bad = QA.hold_variant(spec, ops, REPS, extra, want, only)
    assert not bad["ok"] and not bad["checksum"]["ok"]


def test_fold_is_the_tpu_carry():
    """c = c + X (i mod 3 + 1) in order: at 5 iterations the weights 1, 2,
    3, 1, 2 (fold weight 9), each product rounded before the add."""
    x = torch.tensor([[1.0 / 3.0]]).expand(8, 128)
    c = np.float32(0)
    for i in range(5):
        c = np.float32(c + np.float32(np.float32(1.0 / 3.0) * (i % 3 + 1)))
    assert float(QA.fold(x, 5)[0, 0]) == float(c)
    assert QA.fold_weight(5) == 9


def _table(src: str):
    return re.findall(r"X\((MASK_\w+), (NORM_\w+), (\d), (PV_\w+), "
                      r"(PHASE_\w+), (\d)\)", src)


def test_variant_flags_are_instantiated_in_the_source():
    """Every variant's flags name one instantiation of csrc/probe_qa.cu's
    table, the table holds each distinct tuple once, and the enums'
    orders are the Python mirror's."""
    src = (CSRC / "probe_qa.cu").read_text(encoding="utf-8")
    for names, enum in ((QA.MASKS, "MASK"), (QA.NORMS, "NORM"),
                        (QA.LAYOUTS, "PV"), (QA.PHASES, "PHASE")):
        m = re.search(r"enum \{ (%s_\w+(?:, %s_\w+)*) \};" % (enum, enum), src)
        assert m, enum
        assert len(m.group(1).split(", ")) == len(names)
    enums = {}
    for prefix in ("MASK", "NORM", "PV", "PHASE"):
        m = re.search(r"enum \{ (%s_\w+(?:, %s_\w+)*) \};" % (prefix, prefix),
                      src)
        enums.update({n: i for i, n in enumerate(m.group(1).split(", "))})
    table = {tuple(enums[c] if not c.isdigit() else int(c) for c in row)
             for row in _table(src)}
    assert len(_table(src)) == len(table) == 14
    used = {m.VARIANTS[v].flags() for m, _ in MODULES.values()
            for v in m.VARIANTS}
    assert used == table
    assert sum(len(m.VARIANTS) for m, _ in MODULES.values()) == 17


def test_operation_counts():
    """A full micro is 1.47 GFLOP of products (QK 503 MFLOP, P.V the
    same, the identity product 42, the O-projection 419) and 3.9e6
    exponentials; the normalisation before P.V takes the exponentials
    twice and every two-pass variant QK^T twice."""
    qk = 2 * 20 * 128 * 1536 * 64
    full = QA.micro_ops(PQ.VARIANTS["full"])
    assert full["products"] == 2 * qk + 41943040 + 419430400
    assert abs(full["products"] - 1.47e9) < 0.01e9
    assert full["exps"] == 20 * 128 * 1536 and full["exps_done"] == 2 * full[
        "exps"]
    assert full["done"] == full["products"] + qk
    nolng = QA.micro_ops(PO.VARIANTS["nolng"])
    assert nolng["done"] == nolng["products"] == full["products"] - 41943040
    assert nolng["exps_done"] == nolng["exps"]
    assert QA.micro_ops(PQ.VARIANTS["qk"])["products"] == qk
    assert QA.micro_ops(PQ.VARIANTS["smonly"])["products"] == 0
    b = QA.bound(PQ.VARIANTS["full"], "lgb", 10, 132)
    assert b["bound_by"] == "operations"
    assert abs(b["bound_ms"] - 1320 * full["products"] / 989e12 * 1e3) < 1e-9


def test_importing_the_modules_runs_nothing(monkeypatch, capsys):
    """The three modules and their shared one run nothing and read no
    sys.argv when imported (the TPU scripts read REPS from it)."""
    monkeypatch.setattr(sys, "argv", ["probe", "not-a-number"])
    for m in (QA, PQ, PO, PB):
        importlib.reload(m)
    assert capsys.readouterr().out == ""
    for m in (QA, PQ, PO, PB):
        tree = ast.parse(Path(m.__file__).read_text(encoding="utf-8"))
        for node in tree.body:
            assert not isinstance(node, ast.Expr) or isinstance(
                node.value, ast.Constant), (m.__name__, node.lineno)
            if isinstance(node, ast.If):  # only the __main__ guard
                assert "__main__" in ast.unparse(node.test)
        outside = [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                   and n.attr == "argv"]
        assert not outside, m.__name__


@pytest.mark.parametrize("module", [PQ, PO, PB],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_runs_on_the_cpu(module, capsys):
    """main(--device cpu) runs every variant through the plain version and
    holds each, timing nothing; opt and bisect print rel_vs_base."""
    res = module.main(["--device", "cpu", "--reps", "2"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "FAIL" not in out
    assert [r["variant"] for r in res] == list(module.VARIANTS)
    assert all(r["ok"] and "ms" not in r for r in res)
    assert ("rel_vs_base" in out) == (module is not PQ)


def test_probes_raise_without_a_card(monkeypatch):
    """Each probe runs on the card unless asked for the CPU: with no card
    and no device, build and main raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (PQ, PO, PB):
        with pytest.raises(RuntimeError, match="CUDA card"):
            module.build(next(iter(module.VARIANTS)), 2)
        with pytest.raises(RuntimeError, match="CUDA card"):
            module.main([])


def test_kernel_wrappers_reject_cpu_tensors():
    """The counted kernel wrappers never take CPU tensors and count no
    launch for them."""
    for module, extra in MODULES.values():
        kernel = {PQ: PQ.micro_kernel, PO: PO.opt_kernel,
                  PB: PB.bisect_kernel}[module]
        n = kernel.launches
        with pytest.raises(ValueError, match="CUDA"):
            kernel(next(iter(module.VARIANTS)),
                   QA.inputs(torch.device("cpu"), extra), 2)
        assert kernel.launches == n


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="not one of"):
        PQ.build("fused", 2, device="cpu")
    assert common.device_of("cpu").type == "cpu"


def _f32(x):
    return np.asarray(x, np.float64).astype(np.float32)


def _fma(a, b, c):
    """f32 a * b + c with one rounding: the product of two f32 values is
    exact in f64, and here the sum is too or lands far from a tie."""
    return _f32(a.astype(np.float64) * b.astype(np.float64) +
                c.astype(np.float64))


@pytest.mark.parametrize("seed", range(4))
def test_division_by_a_row_reciprocal_is_ieee_division(seed):
    """csrc/probe_qa.cu's div_by_row: q = a r (r = 1 / b, rounded to
    nearest even) corrected twice by fused multiply-adds equals the IEEE
    quotient a / b bit for bit for a probability's numerator 2^-100 <= a
    <= 1 (or 0) over a row sum 1 <= b <= 4096; a warp holding a smaller
    numerator (div_tiny) divides by IEEE division instead."""
    rng = np.random.default_rng(seed)
    n = 1_000_000
    a = _f32(np.exp(-rng.exponential(2.0, n) * rng.choice([1, 10, 60], n)))
    a[: n // 5] = _f32(rng.uniform(0, 1, n // 5))
    a[n // 5: n // 4] = _f32(rng.uniform(0.999, 1.0, n // 4 - n // 5))
    a[-10:] = 0.0
    b = _f32(np.exp(rng.uniform(0, np.log(4096.0), n)))
    b[: n // 8] = _f32(rng.uniform(1, 2, n // 8))
    a = a[(a >= np.float32(2.0 ** -100)) | (a == 0)]
    b = b[: len(a)]
    r = _f32(np.float32(1.0) / b)
    q = _f32(a * r)
    q = _fma(_fma(-q, b, a), r, q)
    q = _fma(_fma(-q, b, a), r, q)
    want = _f32(a / b)
    assert np.array_equal(q.view(np.int32), want.view(np.int32))
    src = (CSRC / "probe_qa.cu").read_text(encoding="utf-8")
    body = src[src.index("float div_by_row("):]
    body = body[:body.index("\n}\n")]
    assert body.count("__fmaf_rn(__fmaf_rn(-q, b, a)") == 2
    assert "return a != 0.f && a < 0x1p-100f;" in src
