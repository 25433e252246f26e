"""The port's native int8 path (ARIES_QUANT_IMPL=native: CTranslate2's
s8 x s8 -> s32 scheme) against the JAX package's ``_quant_matmul_int8io``
on the CPU:

  * the plain version bit for bit against the eager JAX function, f32 and
    bf16 activations, with a zero row and a row whose x / sx lands on
    exact halves (rounded half to even);
  * ``quant_matmul`` under native against the jitted JAX ``quant_matmul``.
    Under ``jax.jit`` XLA turns ``ax / 127.0`` into ``ax * (1 / 127)``;
    the port divides, as the eager function does. The jitted function is
    held bit for bit against that reciprocal form (written here in numpy).
    The two forms' scales differ on some rows; the port's int8 values
    equal the reciprocal form's on f32 activations, and on bf16 ones
    differ by one only on such rows (where x / sx sits at a half). The
    outputs agree within 1e-6 of max |want| (f32), or within one bf16
    step where the int8 values agree and by a flipped value's own weight
    where they do not (bf16);
  * the engine's ``transcribe_file`` at compute int8 under native against
    the JAX engine under native, at temperature 0: the same tokens and
    segments;
  * the plan of the kernels' paths (path, tile, cluster size) at a
    large-v3 layer's products, its refusals, a plain emulation of the
    cluster path's row-maximum exchange by K slices, and the kernel
    wrappers refusing CPU operands (the kernels themselves: ``-m cuda`` in
    tests/test_torch_cuda.py).

Inputs are made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import one_torch_thread  # noqa: F401 (autouse)
from torch_port_util import PieceTokenizer, random_jax_tree, speechy_audio, to_jax
from whisper_aries_tpu.decoding.tokenizer import build_special_tokens
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.ops import quant as JQ
from whisper_aries_tpu.pipeline.engine import AriesTranscriber as JEngine
from whisper_aries_tpu_torch.audio.decode import write_wav
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.ops import quant as TQ
from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber as TEngine

SR = 16_000


def ties_row(K):
    """max |x| 127 (so sx is exactly 1) and every other value k + 1/2:
    x / sx lands on a half, where half-to-even and half-away differ."""
    row = ((np.arange(K) * 37) % 254 - 126.5).astype(np.float32)
    row[0] = 127.0
    return row


def operands(M, K, N, seed):
    """x (M, K) f32 with row 0 the ties row and row 1 zero (M >= 2), and
    an int8 (K, N) grid with per-column scales from the JAX quantizer."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0] = ties_row(K)
    if M > 1:
        x[1] = 0.0
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    q, s = JQ.quantize_int8(w)
    return x, np.asarray(q), np.asarray(s)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M", [1, 6, 37, 300])
def test_plain_is_the_eager_jax_function_bitwise(M, dtype):
    """quant_matmul_int8io_plain, cast to the activation dtype, equals the
    eager ``_quant_matmul_int8io`` cast as JAX's quant_matmul casts it,
    bit for bit (the f64 product of int8 values is exact)."""
    tdt, jdt = DTYPES[dtype]
    x, q, s = operands(M, 256, 384, seed=M)
    xj = jnp.asarray(x).astype(jdt)
    want = JQ._quant_matmul_int8io(xj, jnp.asarray(q), jnp.asarray(s))
    want = np.asarray(want.astype(jdt).astype(jnp.float32)).astype(
        np.float32)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(tdt)
    got = TQ.quant_matmul_int8io_plain(xt, _t(q), _t(s), tdt)
    assert got.dtype == tdt and tuple(got.shape) == (M, 384)
    np.testing.assert_array_equal(_bits(got.float().numpy()), _bits(want))
    x8, sx = TQ.quantize_rows_plain(xt)
    assert x8.dtype == torch.int8 and sx.dtype == torch.float32
    # the ties row: sx exactly 1 and every half rounded to even
    assert float(sx[0, 0]) == 1.0
    np.testing.assert_array_equal(x8[0].numpy(), np.rint(ties_row(256)))
    assert (np.abs(ties_row(256)) % 1 == 0.5).sum() == 255
    if M > 1:  # a zero row: scale 1, zeros out, never NaN
        assert float(sx[1, 0]) == 1.0 and not x8[1].any()
        assert not got[1].any()


def reciprocal_form(x, q, s):
    """What XLA compiles the jitted JAX function to: ``ax * f32(1 / 127)``
    in place of the division. Returns (int8 values, f32 output)."""
    ax = np.abs(x).max(axis=-1, keepdims=True)
    sx = np.where(ax > 0, ax * np.float32(1.0 / 127.0),
                  np.float32(1.0)).astype(np.float32)
    x8 = np.clip(np.rint(x / sx), -127, 127).astype(np.int8)
    acc = (x8.astype(np.int64) @ q.astype(np.int64)).astype(np.float32)
    return x8, (acc * sx * s).astype(np.float32), sx


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_native_matches_jitted_jax(monkeypatch, dtype):
    """quant_matmul under native on (3, 50, 256) activations against the
    JAX package's (its jit cache cleared, so it traces under native)."""
    tdt, jdt = DTYPES[dtype]
    x, q, s = operands(150, 256, 384, seed=3)
    monkeypatch.setenv("ARIES_QUANT_IMPL", "native")
    jax.clear_caches()
    try:
        xj = jnp.asarray(x).astype(jdt)
        want = JQ.quant_matmul(xj.reshape(3, 50, 256), jnp.asarray(q),
                               jnp.asarray(s))
        want = np.asarray(want.astype(jnp.float32)).reshape(150, 384)
    finally:
        jax.clear_caches()
    xf = np.asarray(xj.astype(jnp.float32))
    x8_r, out_r, sx_r = reciprocal_form(xf, q, s)
    out_r = np.asarray(jnp.asarray(out_r).astype(jdt).astype(jnp.float32))
    np.testing.assert_array_equal(_bits(want), _bits(out_r))
    got = TQ.quant_matmul(_t(xf).to(tdt).reshape(3, 50, 256), _t(q), _t(s))
    assert got.dtype == tdt and tuple(got.shape) == (3, 50, 384)
    got = got.float().reshape(150, 384).numpy()
    x8, sx = TQ.quantize_rows_plain(_t(xf))
    x8, sx = x8.numpy(), sx.numpy()
    # the rewrite shows in the scales; in the int8 values only on rows
    # whose scale moved, by one, where a bf16 value's x / sx sits at a half
    moved = (sx != sx_r)[:, 0]
    assert moved.any()
    np.testing.assert_array_equal(x8[~moved], x8_r[~moved])
    d = np.abs(x8.astype(np.int32) - x8_r)
    assert d.max() <= 1 and (d.any() if dtype == "bfloat16" else not d.any())
    err = np.abs(got.astype(np.float64) - want)
    if dtype == "float32":
        assert err.max() <= 1e-6 * np.abs(want).max()
    else:
        # one bf16 step of the value at most where the int8 values agree;
        # a flipped int8 value moves its outputs by its own weight besides
        step = np.ldexp(1.0, np.frexp(want)[1] - 8)
        same = ~d.any(axis=1)
        assert (err[same] <= step[same]).all()
        flip = (d.astype(np.float64) @ np.abs(q.astype(np.float64))
                ) * sx * s
        assert (err <= step + flip * (1 + 2 ** -7)).all()


def test_quant_matmul_native_runs_on_cpu_tensors(monkeypatch):
    """ARIES_QUANT_IMPL=native no longer raises: on CPU tensors it is the
    plain version, cast to the activation dtype."""
    x, q, s = operands(7, 64, 32, seed=6)
    monkeypatch.setenv("ARIES_QUANT_IMPL", "native")
    got = TQ.quant_matmul(_t(x), _t(q), _t(s))
    want = TQ.quant_matmul_int8io_plain(_t(x), _t(q), _t(s))
    assert torch.equal(got, want)


#: a large-v3 decoder layer's four products (K, N) and the native path's
#: row counts (chip_smoke.py's LAYER_PRODUCTS and NATIVE_M), M 1 besides
LAYER_PRODUCTS = {"qkv": (1280, 3840), "o": (1280, 1280),
                  "fc1": (1280, 5120), "fc2": (5120, 1280)}
#: the plan on a 132-SM H100: S by kernel 5's rule (the least divisor of
#: K / 32 up to 8 giving 2 x 132 blocks of 64 columns, else the largest)
CLUSTER_S = {"qkv": 5, "o": 8, "fc1": 4, "fc2": 8}


@pytest.mark.parametrize("what", list(LAYER_PRODUCTS))
@pytest.mark.parametrize("M", [1, 6, 18, 227, 1135, 6400, 9000])
def test_int8_gemm_plan(M, what):
    """The cluster path (64 columns a block, kernel 5's cluster size) up to
    M 8, and up to M 24 where N <= K (o and fc2 at the words prefill's M
    18), the wgmma path (S 1) otherwise, its wide tile at one and a half
    an SM; S
    divides K into whole 32-row stages, at most 8, and a block's shared
    memory at the rows it takes fits under the opt-in limit."""
    K, N = LAYER_PRODUCTS[what]
    path, tile, S = TQ.int8_gemm_plan(M, N, K, 132)
    assert tile in TQ.INT8_TILES[path]
    if M <= 8 or (M <= 24 and N <= K):
        assert (path, tile, S) == ("cluster", "64", CLUSTER_S[what])
        rows = TQ.int8_cluster_rows(M, K, S)
        assert rows >= min(M, 8) and rows <= TQ.INT8_MAX_ROWS
        assert TQ.int8_cluster_smem(rows, K // S, S) <= 232448
    else:
        wide = 2 * -(-M // 128) * -(-N // 256) >= 3 * 132
        assert (path, tile, S) == ("wgmma", "128x256" if wide else
                                   "128x128", 1)
    assert 1 <= S <= 8 and (K // 32) % S == 0 and (K // S) % 32 == 0


@pytest.mark.parametrize("M,N,K", [(6, 100, 64), (6, 128, 48), (0, 128, 64),
                                   (6, 0, 64), (6, 128, 0)])
def test_int8_gemm_plan_refuses_other_shapes(M, N, K):
    with pytest.raises(ValueError, match="K % 32 == 0"):
        TQ.int8_gemm_plan(M, N, K, 132)


def test_int8_gemm_plan_refuses_too_many_row_tiles():
    with pytest.raises(ValueError, match="65,535 row tiles"):
        TQ.int8_gemm_plan(128 * 65535 + 1, 128, 64, 132)


def test_int8_gemm_plan_takes_wgmma_where_no_slice_fits():
    """A K slice too deep for even 8 s8 rows in a block's shared memory
    goes to the wgmma path, which takes any K % 32 == 0."""
    K = 32 * 7 * 1100  # K / 32 = 7,700: its largest divisor up to 8 is 7
    S = TQ.int8_cluster_size(16, K, 132)
    assert S == 7
    with pytest.raises(ValueError, match="too deep"):
        TQ.int8_cluster_rows(6, K, S)
    assert TQ.int8_gemm_plan(6, 16, K, 132) == ("wgmma", "128x128", 1)


@pytest.mark.parametrize("M,K,S,x_bytes,rows", [
    (6, 1280, 8, 2, 8), (18, 1280, 5, 2, 24), (300, 1280, 4, 2, 64),
    (64, 5120, 8, 2, 64), (64, 5120, 8, 4, 48), (64, 1280, 1, 2, 40),
    (64, 1280, 1, 4, 24), (6, 3200, 1, 4, 8)])
def test_int8_cluster_rows(M, K, S, x_bytes, rows):
    """M rounded up to a group of 8, at most 64, fewer where the block's
    shared memory (x's slice as it lies and as s8 among it) would pass the
    limit: f32 x takes fewer rows than bf16."""
    assert TQ.int8_cluster_rows(M, K, S, x_bytes) == rows
    assert TQ.int8_cluster_smem(rows, K // S, S,
                                x_bytes) <= TQ.INT8_MAX_SMEM


def cluster_quantize(x, S):
    """The cluster path's row quantization, emulated by K slices: each of
    the S blocks takes the max |x| of its own slice of every row, the
    blocks exchange them, and each quantizes its slice by the row scale
    from the max of the S partial maxima. Returns (int8 (M, K), f32 scales
    (M, 1))."""
    xf = x.float()
    parts = xf.abs().reshape(x.shape[0], S, -1).amax(dim=-1)  # (M, S)
    ax = parts.amax(dim=1, keepdim=True)  # the exchange: a max of maxima
    sx = torch.where(ax > 0, ax / torch.full_like(ax, 127.0),
                     torch.ones_like(ax))
    x8 = torch.cat([torch.clamp(torch.round(sl / sx), -127, 127)
                    for sl in xf.split(x.shape[1] // S, dim=1)], dim=1)
    return x8.to(torch.int8), sx


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 6, 7, 8])
def test_cluster_max_exchange_is_the_row_quantization(S):
    """For every cluster size, the slices' exchange gives
    quantize_rows_plain's bits, on rows whose max |x| sits in each slice
    in turn (and a zero row, and the ties row); quantizing each slice by
    its own slice's max instead does not."""
    K = 32 * S * 3
    rng = np.random.default_rng(S)
    x = rng.standard_normal((S + 2, K)).astype(np.float32)
    for j in range(S):  # row j's max in slice j
        x[j, j * (K // S) + 5] = 7.5
    x[S] = ties_row(K)
    x[S + 1] = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        xt = _t(x).to(dtype)
        want8, want_sx = TQ.quantize_rows_plain(xt)
        got8, got_sx = cluster_quantize(xt, S)
        assert torch.equal(got8, want8)
        assert torch.equal(got_sx.view(torch.int32),
                           want_sx.view(torch.int32))
        if S > 1:  # the named mistake: a slice by its own max
            own = torch.cat([TQ.quantize_rows_plain(sl)[0] for sl in
                             xt.split(K // S, dim=1)], dim=1)
            assert not torch.equal(own[:S], want8[:S])


def test_native_kernel_wrappers_reject_cpu_operands():
    """The kernels' entry points take CUDA tensors only; the CPU path goes
    to the plain version in quant_matmul_int8io, never through them."""
    x = torch.zeros((6, 64), dtype=torch.bfloat16)
    q = torch.zeros((64, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        TQ.int8_prepare_kernel(x, q)
    with pytest.raises(ValueError, match="CUDA"):
        TQ.int8_gemm_cluster_kernel(x, q, torch.ones(32))
    with pytest.raises(ValueError, match="CUDA"):
        TQ.int8_gemm_wgmma_kernel(
            torch.zeros((6, 64), dtype=torch.int8), torch.ones((6, 1)),
            torch.zeros((32, 64), dtype=torch.int8), torch.ones(32))
    with pytest.raises(ValueError, match="CUDA"):
        TQ.quant_matmul_int8io_kernel(x, q, torch.ones(32))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """tests/test_torch_engine.py's tiny pair: shared random weights, a
    70 s WAV."""
    tok = PieceTokenizer(build_special_tokens)
    dims_j = JW.WhisperDims(80, 1500, 64, 2, 2, tok.specials.n_vocab, 448,
                            64, 2, 2)
    dims_t = TW.WhisperDims(*[getattr(dims_j, f)
                              for f in dims_j.__dataclass_fields__])
    tree = random_jax_tree(dims_j, seed=11, weight_std=0.08)
    path = str(tmp_path_factory.mktemp("torch_native") / "long.wav")
    write_wav(path, speechy_audio(70.0, seed=5), SR)
    return tok, dims_j, dims_t, tree, path


def test_engine_native_matches_jax_engine(pair, tmp_path, monkeypatch):
    """transcribe_file at compute int8 under native (every dense product
    by the s8 scheme) against the JAX engine under native: the same
    windows, language, tokens and segments."""
    tok, dims_j, dims_t, tree, wav = pair
    monkeypatch.setenv("ARIES_QUANT_IMPL", "native")
    kw = dict(windows_per_device=1, compute_type="int8", kv_cache_dtype="int8",
              _tokenizer=tok)
    call = dict(temperature=(0.0,), max_new_tokens=24, output_formats=())
    jax.clear_caches()
    try:
        jeng = JEngine(model_size="tiny-torch", _params=to_jax(tree),
                       _dims=dims_j, **kw)
        want = jeng.transcribe_file(wav, **call)
    finally:
        jax.clear_caches()
    teng = TEngine(model_size="tiny-torch", device="cpu",
                   _params=TW.params_from_jax(tree), _dims=dims_t, **kw)
    got = teng.transcribe_file(wav, **call)
    assert got["num_windows"] == want["num_windows"] >= 3
    assert got["language"] == want["language"]

    def segs(res):
        return [(s["text"], list(s["tokens"]), s["start"], s["end"])
                for s in res["segments"]]

    assert segs(got) == segs(want) and got["segments"]
