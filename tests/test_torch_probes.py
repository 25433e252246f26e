"""The port's hardware probes (whisper_aries_tpu_torch/scripts/) against the
TPU probes in scripts/, on the CPU.

Each TPU probe runs in Pallas interpret mode: ``pl.pallas_call`` is patched
(for the test's duration) to pass ``interpret=`` before the script's
function is called; nothing in scripts/ is edited. The transpose probe
never zeroes its accumulator scratch, so it runs with
``InterpretParams(uninitialized_memory="zero")`` (uninitialised memory is
NaN otherwise). ``probe_int8_mxu.py`` runs its probe when imported, so it
is loaded through ``ast``: its imports, assignments and definitions,
without the top-level calls. The same numpy-made inputs go through the
TPU probe and the port's function with ``device="cpu"`` (the plain
version of each kernel). Tolerances:

  * copy checksums: int8 exact; bf16 within 1e-5 of the sum of |terms|
    (f32 sums in another order);
  * products: s8 exact; bf16 and f32 within 1e-5 of max |want|;
  * transposes: elementwise within one bf16 step of the window sum a
    repetition (``window_sum_steps``).

The kernels themselves run on the card only (tests/test_torch_cuda.py,
chip_smoke.py)."""

import ast
import functools
import importlib.util
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

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from whisper_aries_tpu_torch.scripts import common
from whisper_aries_tpu_torch.scripts import probe_batched_transpose as PT
from whisper_aries_tpu_torch.scripts import probe_dma as PD
from whisper_aries_tpu_torch.scripts import probe_int8_mxu as PI
from whisper_aries_tpu_torch.scripts import probe_mxu as PM
from whisper_aries_tpu_torch.scripts import probe_vmem as PV

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
CSRC = ROOT / "whisper_aries_tpu_torch" / "csrc"


def _load_tpu(name: str):
    """A TPU probe of scripts/ as a module (scripts/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"tpu_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_without_calls(name: str) -> dict:
    """A TPU probe's namespace from its imports, assignments and
    definitions only: its top-level calls (the probe itself) dropped."""
    path = SCRIPTS / f"{name}.py"
    tree = ast.parse(path.read_text(encoding="utf-8"))
    keep = (ast.Import, ast.ImportFrom, ast.Assign, ast.FunctionDef)
    tree.body = [n for n in tree.body if isinstance(n, keep)]
    ns = {"__file__": str(path), "__name__": f"tpu_{name}"}
    exec(compile(tree, str(path), "exec"), ns)
    return ns


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pl.pallas_call`` of the test runs in interpret mode, with
    uninitialised memory read as zeros."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call,
        interpret=pltpu.InterpretParams(uninitialized_memory="zero")))


def _bf16(rng, shape):
    """(numpy bf16 for JAX, the same values as a torch bf16 tensor)."""
    x = rng.standard_normal(shape).astype(jnp.bfloat16)
    return x, torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _close_checksum(got, want, terms):
    """int8 exact; bf16 within 1e-5 of the sum of |terms|."""
    got, want = float(got), float(want)
    if terms.dtype == torch.int8:
        assert got == want
    else:
        assert abs(got - want) <= 1e-5 * float(terms.double().abs().sum())


# ---------------------------------------------------------------------------
# probe_dma
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,n_slots,full", [
    ("bf16", 2, 256), ("bf16", 4, 256), ("int8", 2, 512), ("int8", 3, 256)])
def test_probe_dma_matches_jax(interpret, dtype, n_slots, full):
    """probe(src (8, 8 or 16, full), lanes 256 or 128) over 20 iterations:
    the port's plain version against the TPU probe in interpret mode, for
    contiguous and strided (lanes < full) chunks."""
    tpu = _load_tpu("probe_dma")
    rng = np.random.default_rng(0)
    rows, lanes = (8, 128) if dtype == "bf16" else (16, 256)
    if dtype == "bf16":
        src_j, src_t = _bf16(rng, (8, rows, full))
    else:
        src_j = rng.integers(-127, 127, (8, rows, full), dtype=np.int8)
        src_t = torch.from_numpy(src_j)
    want = tpu.probe(jnp.asarray(src_j), rows, lanes, 20, n_slots, full)
    got = PD.probe(src_t, rows, lanes, 20, n_slots, full, device="cpu")
    assert got.shape == (1, 1)
    terms = src_t[torch.arange(20) % 8, 0, 0]
    _close_checksum(got[0, 0], np.asarray(want)[0, 0], terms)
    _close_checksum(got[0, 0], terms.double().sum(), terms)


def test_probe_dma_bands_are_the_tpu_probe_of_each_band(interpret):
    """With 4 blocks each block's checksum is the TPU probe run on its
    band of rows alone."""
    tpu = _load_tpu("probe_dma")
    src_j, src_t = _bf16(np.random.default_rng(1), (8, 16, 128))
    got = PD.probe(src_t, 16, 128, 13, 2, 128, blocks=4, device="cpu")
    assert got.shape == (4, 1)
    for b in range(4):
        band = jnp.asarray(src_j[:, 4 * b:4 * b + 4])
        want = np.asarray(tpu.probe(band, 4, 128, 13, 2, 128))[0, 0]
        _close_checksum(got[b, 0], want, src_t[:, 4 * b, 0].repeat(2))


@pytest.mark.parametrize("n_streams", [1, 2, 4])
def test_probe_multi_matches_jax(interpret, n_streams):
    """probe_multi at (16, 8, 128), 5 iterations: the streams' interleaved
    chunks summed, against the TPU probe in interpret mode."""
    tpu = _load_tpu("probe_dma")
    src_j, src_t = _bf16(np.random.default_rng(2), (16, 8, 128))
    want = np.asarray(tpu.probe_multi(jnp.asarray(src_j), 8, 128, 5,
                                      n_streams))[0, 0]
    got = PD.probe_multi(src_t, 8, 128, 5, n_streams, device="cpu")
    idx = (torch.arange(5)[:, None] * n_streams
           + torch.arange(n_streams)[None]).reshape(-1) % 16
    _close_checksum(got[0, 0], want, src_t[idx, 0, 0])


def test_checksum_plain_is_the_ring_loop():
    """The counting form of the plain checksum equals the ring's loop
    written out (blocks, streams, a head of several elements)."""
    src = torch.from_numpy(np.random.default_rng(3).integers(
        -100, 100, (5, 6, 32), dtype=np.int8))
    band, blocks, S, n, head = 2, 3, 2, 7, 4
    want = torch.zeros(blocks, dtype=torch.float64)
    for b in range(blocks):
        for i in range(n):
            for s in range(S):
                want[b] += src[(i * S + s) % 5, b * band, :head].double().sum()
    got = PD.checksum_plain(src, band, n, S, blocks, head)
    assert torch.equal(got.double(), want)


@pytest.mark.parametrize("blocks,bands,S", [(3, 5, 1), (7, 2, 2), (4, 4, 3),
                                            (10, 1, 1), (5, 3, 2)])
def test_walk_is_the_persistent_loop(blocks, bands, S):
    """Blocks walking (iteration, band) items, block b taking items b,
    b + blocks, ...: the plain checksum and reads equal the kernel's loop
    written out, with blocks fewer than, equal to and more than the bands;
    each named mistake is caught."""
    C, band, n, head = 5, 2, 7, 3
    src = torch.from_numpy(np.random.default_rng(4).integers(
        -100, 100, (C, 2 * bands + 1, 32), dtype=np.int8))
    T = PD.steps_of(n, bands, blocks)
    want = torch.zeros((blocks, S, T), dtype=torch.float64)
    for b in range(blocks):
        for t in range(T):
            item = b + t * blocks
            if item >= n * bands:
                continue
            i, j = divmod(item, bands)
            for s in range(S):
                want[b, s, t] = src[(i * S + s) % C, j * band,
                                    :head].double().sum()
    reads = PD.trace_plain(src, band, n, S, blocks, head, bands)
    assert torch.equal(reads.double(), want)
    got = PD.checksum_plain(src, band, n, S, blocks, head, bands)
    assert torch.equal(got.double(), want.sum((1, 2)))
    ones = PD.trace_plain(src, band, n, S, blocks, 1, bands)
    held = PD.hold_trace(ones, src, band, n, 2, S, blocks, bands)
    assert held["ok"] and min(held["mistakes"].values()) > 0, held
    sums = PD.checksum_plain(src, band, n, S, blocks, bands=bands)
    assert PD.hold_checksum(sums, src, band, n, S, blocks, bands)["ok"]
    stale = PD.unwaited_trace_plain(src, band, n, 2, S, blocks, bands)
    assert not PD.hold_trace(stale, src, band, n, 2, S, blocks, bands)["ok"]


@pytest.mark.parametrize("run", PD.TPU_RUNS + tuple(
    (n, r, l, torch.bfloat16, 2, None) for n, r, l, _ in PD.TPU_MULTI),
    ids=lambda r: "-".join(r[0].replace("/", " ").replace(",", " ").split()))
def test_rate_runs_feed_every_sm(run):
    """Every TPU configuration runs one walker's block, all its rings, on
    each of the H100's SMs, each keeping at least the bytes in flight the
    sweep found sufficient; reading the source once (n_iter = chunks /
    streams), the walkers copy every band of every chunk exactly once."""
    name, rows, lanes, dtype, slots, full = run
    streams = next((s for n, _, _, s in PD.TPU_MULTI if n == name), 1)
    elem = 1 if dtype == torch.int8 else 2
    strided = full is not None and full != lanes
    band, bands = PD.band_plan(rows, lanes * elem, slots, strided, streams)
    assert band * lanes * elem * slots * streams >= PD.INFLIGHT_MIN
    walkers = PD.SMS_H100
    C = 12 * streams
    chunk, j, valid = PD.walk(C, C // streams, streams, walkers, bands,
                              "cpu")
    pairs = (chunk * bands + j)[valid.expand_as(chunk)]
    assert torch.equal(torch.bincount(pairs, minlength=C * bands),
                       torch.ones(C * bands, dtype=torch.long))
    steps = valid.sum(-1).flatten()
    assert int(steps.max() - steps.min()) <= 1


@pytest.mark.parametrize("n_slots,n_streams", [(1, 1), (2, 1), (4, 1),
                                               (2, 3)])
def test_unwaited_slot_is_the_stale_slot(n_slots, n_streams):
    """The named mistake: a ring that reads slot 0 without waiting sees
    what the slot held, simulated here copy by copy, in the ring's own
    issue order; its checksum differs by the last stale read alone."""
    src = torch.randn(7, 2, 16).to(torch.bfloat16)
    n = 11
    want = torch.zeros((1, n_streams, n))
    for s in range(n_streams):
        landed = [0.0] * n_slots   # what a read of each slot sees
        pending = [0.0] * n_slots  # the copy issued into it last

        def issue(j):
            pending[j % n_slots] = float(src[(j * n_streams + s) % 7, 0, 0])

        for w in range(min(n_slots - 1, n)):
            issue(w)
        for i in range(n):
            slot = i % n_slots
            if i + n_slots - 1 < n:
                issue(i + n_slots - 1)
            if slot == 0:  # read at once; the copy lands after
                want[0, s, i] = landed[0]
                landed[0] = pending[0]
            else:          # waited on: the copy has landed
                landed[slot] = pending[slot]
                want[0, s, i] = landed[slot]
    got = PD.unwaited_trace_plain(src, 1, n, n_slots, n_streams)
    assert torch.equal(got, want)
    right = PD.trace_plain(src, 1, n, n_streams)
    last = right[0, :, (n - 1) // n_slots * n_slots].double().sum()
    assert abs(float(right.double().sum() - got.double().sum() - last)) < 1e-9


def test_checksum_and_reads_catch_the_named_mistakes():
    """hold_checksum and hold_trace pass the plain answers and fail each
    named mistake. The data come from a seeded generator, and the int8
    source's values are all positive, so band 0's heads never sum to 0
    (where dropping band 0 would change nothing)."""
    g = torch.Generator().manual_seed(260)
    src = torch.randn(64, 4, 32, generator=g).to(torch.bfloat16)
    good = PD.checksum_plain(src, 2, 100, 1, 2)
    assert PD.hold_checksum(good, src, 2, 100, 1, 2)["ok"]
    dropped = good.clone()
    dropped[0] = 0
    assert not PD.hold_checksum(dropped, src, 2, 100, 1, 2)["ok"]
    src8 = torch.randint(1, 127, (64, 4, 32), dtype=torch.int8, generator=g)
    good8 = PD.checksum_plain(src8, 2, 100, 1, 2)
    assert PD.hold_checksum(good8, src8, 2, 100, 1, 2)["ok"]
    assert not PD.hold_checksum(good8 + 1, src8, 2, 100, 1, 2)["ok"]
    reads = PD.trace_plain(src, 2, 40, 2, 2)
    assert PD.hold_trace(reads, src, 2, 40, 2, 2, 2)["ok"]
    stale = PD.unwaited_trace_plain(src, 2, 40, 2, 2, 2)
    assert not PD.hold_trace(stale, src, 2, 40, 2, 2, 2)["ok"]
    assert torch.equal(reads.double().sum(-1).sum(-1),
                       PD.checksum_plain(src, 2, 40, 2, 2).double())


@pytest.mark.parametrize("run", PD.TPU_RUNS + tuple(
    (n, r, l, torch.bfloat16, 2, None) for n, r, l, _ in PD.TPU_MULTI),
    ids=lambda r: "-".join(r[0].replace("/", " ").replace(",", " ").split()))
def test_band_plan_fits_a_block(run):
    """Every TPU configuration's band divides its rows, fits the H100's
    opt-in shared memory as one walker's block of its rings, is at most
    one tensor-map box high when strided, and is the largest band that
    does."""
    name, rows, lanes, dtype, slots, full = run
    streams = next((s for n, _, _, s in PD.TPU_MULTI if n == name), 1)
    elem = 1 if dtype == torch.int8 else 2
    strided = full is not None and full != lanes
    band, bands = PD.band_plan(rows, lanes * elem, slots, strided, streams)
    assert band * bands == rows
    assert PD.block_smem(band * lanes * elem, slots, strided,
                         streams) <= PD.OPTIN_H100
    assert not strided or band <= 256
    bigger = [b for b in range(band + 1, rows + 1) if rows % b == 0]
    assert all(PD.block_smem(b * lanes * elem, slots, strided, streams)
               > PD.OPTIN_H100 or (strided and b > 256) for b in bigger)


def test_ring_layout_mirrors_the_source():
    """data_offset is csrc/probe_copy.cu's; the one-slot copy at the
    opt-in limit moves the limit less the barrier, in 16-byte steps."""
    text = (CSRC / "probe_copy.cu").read_text(encoding="utf-8")
    assert "(8 * n_slots + 15) / 16 * 16" in text
    assert PD.data_offset(1) == 16 and PD.data_offset(2) == 16
    assert PD.data_offset(3) == 32
    # a walker's block: every ring's barriers, then every ring's slots
    assert PD.block_smem(32 << 10, 2, False, 2) == 32 + 4 * (32 << 10)
    assert PD.block_smem(40 << 10, 4, True, 2) == 64 + 128 + 8 * (40 << 10)
    assert PV.copy_lanes(PD.OPTIN_H100) * 2 == PD.OPTIN_H100 - 16
    assert PD.block_smem(PV.copy_lanes(PD.OPTIN_H100) * 2, 1,
                         False) == PD.OPTIN_H100


# ---------------------------------------------------------------------------
# probe_vmem
# ---------------------------------------------------------------------------


def test_probe_vmem_matches_jax(interpret, capsys):
    """try_size(1): the TPU probe copies ones and prints sum=128; so does
    the port's."""
    tpu = _load_tpu("probe_vmem")
    tpu.try_size(1)
    jax_out = capsys.readouterr().out
    res = PV.try_size(1, device="cpu")
    port_out = capsys.readouterr().out
    sums = [re.search(r"sum=(\d+)", o).group(1) for o in (jax_out, port_out)]
    assert sums == ["128", "128"]
    assert res["ok"] and res["sums"] == [128.0]


def test_smem_copy_plain_sums_each_block_head():
    src = torch.arange(4 * 300, dtype=torch.float32).view(4, 300)
    want = torch.tensor([float(sum(range(b * 300, b * 300 + 128)))
                         for b in range(4)])
    assert torch.equal(PV.smem_copy_plain(src.to(torch.bfloat16)),
                       PV.smem_copy_plain(src.to(torch.bfloat16).float()))
    assert torch.equal(PV.smem_copy_plain(src), want)


# ---------------------------------------------------------------------------
# probe_mxu, probe_int8_mxu
# ---------------------------------------------------------------------------


def _mxu_operands(kind, rng, m=64, k=128, n=64):
    if kind == "s8":
        a = rng.integers(-127, 127, (m, k), dtype=np.int8)
        b = rng.integers(-127, 127, (k, n), dtype=np.int8)
        return (a, b), (torch.from_numpy(a), torch.from_numpy(b))
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    if kind == "bf16":
        return ((a.astype(jnp.bfloat16), b.astype(jnp.bfloat16)),
                (torch.from_numpy(a).to(torch.bfloat16),
                 torch.from_numpy(b).to(torch.bfloat16)))
    return (a, b), (torch.from_numpy(a), torch.from_numpy(b))


@pytest.mark.parametrize("kind", ["bf16", "s8", "f32"])
def test_probe_mxu_matches_jax(interpret, monkeypatch, kind):
    """probe at (64, 128) x (128, 64), 3 iterations: s8 exactly 3 (A.B)[0, 0]
    (as the TPU probe gives it), bf16 and f32 within 1e-5. The TPU script
    reads its N from sys.argv when imported."""
    monkeypatch.setattr(sys, "argv", ["probe_mxu.py"])
    tpu = _load_tpu("probe_mxu")
    jx, tx = _mxu_operands(kind, np.random.default_rng(0))
    want = float(np.asarray(tpu.probe(*map(jnp.asarray, jx), 3, kind))[0, 0])
    got = PM.probe(*tx, 3, kind, device="cpu")
    assert got.shape == (1, 1) and got.dtype == torch.float32
    exact = 3 * float(tx[0][0].double() @ tx[1][:, 0].double())
    if kind == "s8":
        assert float(got[0, 0]) == want == exact
    else:
        assert abs(float(got[0, 0]) - want) <= 1e-5 * abs(exact)


@pytest.mark.parametrize("label", [l for _, _, l in PI.LABELS])
def test_probe_int8_mxu_matches_jax(interpret, label):
    """make_kernel at M = N = K = 128, REPS 5 (the TPU script's globals set
    before the call): out (8, 128) = sum of (i mod 3 + 1)(A.B)[:8, :128]."""
    ns = _load_without_calls("probe_int8_mxu")
    ns.update(M=128, N=128, K=128, REPS=5)
    dtype, acc = next((d, a) for d, a, l in PI.LABELS if l == label)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}[dtype]
    jacc = {torch.float32: jnp.float32, torch.int32: jnp.int32}[acc]
    kind = "s8" if dtype == torch.int8 else "bf16"
    jx, tx = _mxu_operands(kind, np.random.default_rng(1), 128, 128, 128)
    f = pl.pallas_call(
        ns["make_kernel"](jdt, jacc),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM))
    want = torch.from_numpy(np.array(f(*map(jnp.asarray, jx))))
    got = PI.make_kernel(dtype, acc, reps=5, device="cpu")(*tx)
    assert got.shape == (8, 128) and got.dtype == torch.float32
    if kind == "s8":
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def test_fold_weight_and_s32_wrap():
    for n in range(12):
        assert PM.fold_weight(n, True) == sum(i % 3 + 1 for i in range(n))
        assert PM.fold_weight(n, False) == n
    # 400 folds of large products wrap as an s32 accumulator does
    a = torch.full((2, 256), 127, dtype=torch.int8)
    b = torch.full((256, 2), 127, dtype=torch.int8)
    got = PM.mma_plain(a, b, 400, "s8", fold=True)
    acc = np.zeros((), np.int32)
    p = np.int32(127 * 127 * 256)
    with np.errstate(over="ignore"):
        for i in range(400):
            for _ in range(i % 3 + 1):
                acc = acc + p
    assert got.dtype == torch.int32 and int(got[0, 0]) == int(acc)


@pytest.mark.parametrize("kind", ["bf16", "s8", "f32"])
def test_mma_limits_catch_a_dropped_k_slab(kind):
    """hold_mma passes the plain result on every block and fails a
    product one K slab short, at the card's tile and a long fold."""
    a, b = PM.operands(kind, PM.tile_k(kind), torch.device("cpu"))
    n = 3000
    good = PM.mma_plain(a, b, n, kind, True)[None].repeat(2, 1, 1)
    assert PM.hold_mma(good, a, b, n, kind, True)["ok"]
    ks = 32 // a.element_size()
    short = PM.mma_plain(a[:, :-ks], b[:-ks], n, kind, True)[None]
    assert not PM.hold_mma(short, a, b, n, kind, True)["ok"]


def test_mma_tile_mirrors_the_source():
    text = (CSRC / "probe_mma.cu").read_text(encoding="utf-8")
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", text))
    assert consts["TN"] == str(PM.TN) and consts["KB"] == str(PM.KB)
    assert consts["TM"] == "64 * WG" and 64 * int(consts["WG"]) == PM.TM
    assert {PM.tile_k(k) for k in PM.KINDS} == {128, 256, 64}


# ---------------------------------------------------------------------------
# probe_batched_transpose
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["batched", "perwin"])
def test_probe_batched_transpose_matches_jax(interpret, variant):
    """make(variant) at the TPU probe's own sizes, (288, 3840) bf16: the
    plain version against the TPU probe (its accumulator read as zeros)
    within one bf16 step of the window sum a repetition."""
    tpu = _load_tpu("probe_batched_transpose")
    x = np.random.default_rng(0).standard_normal((PT.Bw * PT.KP, PT.D))
    xj = jnp.asarray(x, jnp.bfloat16)
    want = torch.from_numpy(np.array(tpu.make(variant)(xj)))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    got = PT.make(variant, device="cpu")(xt)
    assert got.shape == (PT.D, PT.KP) and torch.isfinite(want).all()
    res = PT.hold_transpose(want, xt, variant)
    assert res["ok"], res
    assert PT.hold_transpose(got, xt, variant)["err"] == 0.0


@pytest.mark.parametrize("reps", [1, 2, 7, 64])
@pytest.mark.parametrize("variant", ["batched", "perwin"])
def test_transpose_hold_catches_each_named_mistake(variant, reps):
    """At the repetition counts the card test runs (dividing the kernel's
    repetition groups and not), the right answer holds and each named
    mistake (a window, a repetition, the offsets) reads above the limit."""
    x = PT.inputs(torch.device("cpu"))
    held = PT.hold_transpose(PT.transpose_sum_plain(x, variant, reps), x,
                             variant, reps)
    assert held["ok"] and held["err"] == 0.0, held
    assert set(held["mistakes"]) == {"last window dropped",
                                     "last repetition dropped",
                                     "offsets one too high"}
    for name, y in PT.named_mistakes(x, variant, reps).items():
        res = PT.hold_transpose(y, x, variant, reps)
        assert not res["ok"] and res["err"] > res["limit"], name


def test_transpose_kernel_refuses_offsets_past_bf16():
    """The kernel adds i in bf16, exact only below 256 repetitions."""
    x = torch.zeros((PT.Bw * PT.KP, PT.D), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="reps"):
        PT.transpose_sum_kernel(x, "batched", PT.MAX_REPS + 1)


# ---------------------------------------------------------------------------
# where the probes run
# ---------------------------------------------------------------------------


def _calls_without_device():
    src = torch.zeros((8, 8, 128), dtype=torch.bfloat16)
    a8 = torch.zeros((8, 32), dtype=torch.int8)
    return {
        "probe_dma.probe": lambda: PD.probe(src, 8, 128, 4, 2, 128),
        "probe_dma.probe_multi": lambda: PD.probe_multi(src, 8, 128, 4, 2),
        "probe_vmem.try_size": lambda: PV.try_size(1),
        "probe_mxu.probe": lambda: PM.probe(a8, a8.T, 3, "s8"),
        "probe_int8_mxu.make_kernel": lambda: PI.make_kernel(
            torch.int8, torch.int32)(a8, a8.T),
        "probe_batched_transpose.make": lambda: PT.make("batched")(
            torch.zeros((PT.Bw * PT.KP, PT.D), dtype=torch.bfloat16)),
    }


@pytest.mark.parametrize("name", sorted(_calls_without_device()))
def test_probes_raise_without_a_card(monkeypatch, name):
    """Each probe runs on the card unless asked for the CPU: with no card
    and no device it raises, as does each module's main()."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        _calls_without_device()[name]()
    module = {"probe_dma": PD, "probe_vmem": PV, "probe_mxu": PM,
              "probe_int8_mxu": PI,
              "probe_batched_transpose": PT}[name.split(".")[0]]
    with pytest.raises(RuntimeError, match="CUDA card"):
        module.main([])


def test_probe_kernel_wrappers_reject_cpu_tensors():
    """The kernel entry points never take CPU tensors."""
    src = torch.zeros((8, 8, 128), dtype=torch.bfloat16)
    a = torch.zeros((PM.TM, 128), dtype=torch.bfloat16)
    b = torch.zeros((128, PM.TN), dtype=torch.bfloat16)
    for call in (lambda: PD.copy_ring_kernel(src, 8, 128, 4, 2),
                 lambda: PD.copy_streams_kernel(src, 8, 128, 4, 2),
                 lambda: PV.smem_copy_kernel(src[0], 4096),
                 lambda: PM.mma_loop_kernel(a, b, 3, "bf16"),
                 lambda: PI.mma_fold_kernel(a, b, 3, "bf16"),
                 lambda: PT.transpose_sum_kernel(
                     torch.zeros((PT.Bw * PT.KP, PT.D),
                                 dtype=torch.bfloat16), "batched")):
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("module", [PV, PM, PI, PT],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_probe_main_runs_on_the_cpu(module, capsys):
    """main(--device cpu) runs every configuration through the plain
    versions and holds each, timing nothing."""
    res = module.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "FAIL" not in out
    flat = (res.values() if isinstance(res, dict) else res)
    assert all(r["ok"] for r in flat if isinstance(r, dict) and "ok" in r)
    assert not any("ms" in r for r in flat if isinstance(r, dict))


def test_probe_dma_main_runs_on_the_cpu(capsys):
    res = PD.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(res) == len(PD.TPU_RUNS) + len(PD.TPU_MULTI)
    assert all(r["ok"] and "ms" not in r for r in res)
    assert all(r["blocks"] == PD.SMS_H100
               and r["inflight_per_sm"] >= PD.INFLIGHT_MIN for r in res)
    for name, *_ in PD.TPU_RUNS + PD.TPU_MULTI:
        assert name in out


def test_device_of():
    assert common.device_of("cpu").type == "cpu"
    with pytest.raises(ValueError):
        common.device_of("meta")


@pytest.mark.parametrize("err, raised, code, stage", [
    (8998, ValueError, None, None),
    (9005, RuntimeError, None, None),
    (10001, "CudaError", 1, "attribute"),
    (2, "CudaError", 2, "launch"),
], ids=["own-arguments", "tensor-map", "attribute", "launch"])
def test_launch_errors_say_where_they_came_from(err, raised, code, stage):
    """A C entry's return code tells its own argument checks, a refused
    tensor map, a refused kernel attribute and a refused launch apart, so
    the shared-memory probe records only the card's refusal."""
    from whisper_aries_tpu_torch.ops import cuda_build as cb

    cb.check(0, "nothing")
    raised = cb.CudaError if raised == "CudaError" else raised
    with pytest.raises(raised) as info:
        cb.check(err, "probe copy kernel")
    assert str(info.value).startswith("probe copy kernel: ")
    if code is None:
        assert not isinstance(info.value, cb.CudaError)
    else:
        assert (info.value.code, info.value.stage) == (code, stage)
        assert f"error {code}" in str(info.value)
