"""The port's int8 dense path (whisper_aries_tpu_torch.ops.quant) against the
JAX package's ops/quant.py on the CPU: the plain version of the W8A16 GEMM
kernel against the Pallas kernel ``_quant_matmul_pallas`` in interpret
mode, ``quant_matmul`` under each ``ARIES_QUANT_IMPL`` and ``dense`` under
"pallas". Inputs are made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_aries_tpu.models import layers as JL
from whisper_aries_tpu.ops import quant as JQ
from whisper_aries_tpu_torch.models import layers as TL
from whisper_aries_tpu_torch.ops import quant as TQ


def _operands(M, K, N, seed):
    """x (M, K) f32 and an int8 (K, N) grid with per-column scales, made by
    the JAX package's quantizer from random weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (0.05 * rng.standard_normal((K, N))).astype(np.float32)
    q, s = JQ.quantize_int8(w)
    return x, np.asarray(q), np.asarray(s)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_dequantized_weights_bitwise():
    """bf16(f32(q) * s), rounded to nearest even after an f32 multiply, is
    the TPU kernel's per-tile dequant bit for bit; the outscale product's
    unrounded weights are not."""
    _, q, s = _operands(1, 256, 384, seed=0)
    want = np.asarray((jnp.asarray(q).astype(jnp.float32) * jnp.asarray(s))
                      .astype(jnp.bfloat16).astype(jnp.float32))
    got = TQ.dequantize_bf16(_t(q), _t(s)).float().numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    unrounded = q.astype(np.float32) * s
    assert (unrounded != want).mean() > 0.5


@pytest.mark.parametrize("M", [1, 6, 37, 130, 300])
def test_plain_matches_pallas_interpret(M):
    """The kernel's plain version against the Pallas kernel in interpret
    mode (128 x 128 tiles over K 384, N 256; ragged M pads to the M tile):
    the same bf16 products summed in another order, within 1e-5 of
    max |want|. The outscale product (no bf16 rounding of the weights) is
    far outside that."""
    x, q, s = _operands(M, 384, 256, seed=M)
    want = np.asarray(JQ._quant_matmul_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), block_n=128,
        block_k=128, interpret=True))
    got = TQ.quant_matmul_dequant_plain(_t(x), _t(q), _t(s)).numpy()
    assert got.shape == want.shape == (M, 256)
    assert _rel(got, want) <= 1e-5
    outscale = TQ._quant_matmul_outscale(_t(x), _t(q), _t(s)).numpy()
    assert _rel(outscale, want) > 1e-4


@pytest.mark.parametrize("impl", ["outscale", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_impls_match_jax(monkeypatch, impl, dtype):
    """quant_matmul read under ARIES_QUANT_IMPL against the JAX package's
    (its jit cache cleared, so it traces under the same setting), on
    (2, 7, 256) activations: f32 outputs within 1e-5 of max |want|; bf16
    outputs, rounded from f32 sums taken in another order, within one bf16
    step of each value."""
    x, q, s = _operands(14, 256, 384, seed=3)
    x = x.reshape(2, 7, 256)
    monkeypatch.setenv("ARIES_QUANT_IMPL", impl)
    jax.clear_caches()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = JQ.quant_matmul(jnp.asarray(x).astype(jdt), jnp.asarray(q),
                           jnp.asarray(s))
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = TQ.quant_matmul(_t(x).to(tdt), _t(q), _t(s))
    assert got.dtype == tdt and tuple(got.shape) == (2, 7, 384)
    got = got.float().numpy()
    if dtype == "float32":
        assert _rel(got, want) <= 1e-5
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    jax.clear_caches()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_pallas_is_the_kernel_function(monkeypatch, dtype):
    """Under "pallas" the port computes what the TPU kernel computes (its
    plain version on CPU tensors), cast to the activation dtype, where the
    JAX package on the CPU would run "xla" instead."""
    x, q, s = _operands(21, 256, 128, seed=5)
    monkeypatch.setenv("ARIES_QUANT_IMPL", "pallas")
    tdt = getattr(torch, dtype)
    got = TQ.quant_matmul(_t(x).to(tdt).reshape(3, 7, 256), _t(q), _t(s))
    assert got.dtype == tdt
    want = np.asarray(JQ._quant_matmul_pallas(
        jnp.asarray(x).astype(jnp.float32 if dtype == "float32"
                              else jnp.bfloat16),
        jnp.asarray(q), jnp.asarray(s), block_n=128, block_k=128,
        interpret=True))
    got = got.reshape(21, 128).float().numpy()
    if dtype == "float32":
        assert _rel(got, want) <= 1e-5
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


def test_quant_matmul_native_is_not_ported(monkeypatch):
    x, q, s = _operands(2, 64, 32, seed=6)
    monkeypatch.setenv("ARIES_QUANT_IMPL", "native")
    with pytest.raises(NotImplementedError, match="not ported"):
        TQ.quant_matmul(_t(x), _t(q), _t(s))


def test_dense_pallas_matches_jax(monkeypatch):
    """dense over an int8 layer with a bias under "pallas", against the JAX
    package's dense with its quant_matmul patched to call the Pallas kernel
    in interpret mode (nothing in the JAX package changes): within 1e-5 of
    max |want|, M 45 ragged against the 8-row tile."""
    x, q, s = _operands(45, 256, 256, seed=7)
    b = np.random.default_rng(8).standard_normal(256).astype(np.float32)

    def pallas_qm(xj, qj, sj):
        lead = xj.shape[:-1]
        out = JQ._quant_matmul_pallas(xj.reshape(-1, xj.shape[-1]), qj, sj,
                                      block_n=128, block_k=128,
                                      interpret=True)
        return out.reshape(*lead, qj.shape[1]).astype(xj.dtype)

    monkeypatch.setattr(JQ, "quant_matmul", pallas_qm)
    jax.clear_caches()
    want = np.asarray(JL.dense(
        {"q": jnp.asarray(q), "s": jnp.asarray(s), "b": jnp.asarray(b)},
        jnp.asarray(x).reshape(5, 9, 256)))
    monkeypatch.setenv("ARIES_QUANT_IMPL", "pallas")
    got = TL.dense({"q": _t(q), "s": _t(s), "b": _t(b)},
                   _t(x).reshape(5, 9, 256)).numpy()
    assert _rel(got, want) <= 1e-5
    jax.clear_caches()


@pytest.mark.parametrize("M,N,K,want", [
    (9000, 1280, 1280, ("wgmma", 1)), (9000, 5120, 1280, ("wgmma", 1)),
    (9000, 1280, 5120, ("wgmma", 1)), (4500, 1280, 1280, ("wgmma", 1)),
    (4500, 5120, 1280, ("wgmma", 1)), (4500, 1280, 5120, ("wgmma", 1)),
    (6, 1280, 1280, ("splitk", 10)), (6, 3840, 1280, ("splitk", 8)),
    (6, 5120, 1280, ("splitk", 5)), (6, 1280, 5120, ("splitk", 20))])
def test_gemm_plan_on_the_slices_shapes(M, N, K, want):
    """The encoder's and cross K/V's M (6 or 3 windows x 1500) take the TMA
    + wgmma path; a decode step's M 6 keeps the split-K path with the
    splits the previous C rule gave on 132 SMs (about two blocks per SM,
    each split a whole number of >= 4 32-deep slabs)."""
    assert TQ.gemm_plan(M, N, K, 132) == want


@pytest.mark.parametrize("M", [9000, 4500, 1000])
def test_gemm_plan_sends_k_not_a_multiple_of_64_to_splitk(M):
    """K % 64 != 0 (here K 1312 = 41 x 32) goes to the split-K path by the
    plan, never by an error."""
    path, splits = TQ.gemm_plan(M, 1280, 1312, 132)
    assert path == "splitk" and (1312 // 32) % splits == 0


@pytest.mark.parametrize("N", [1280, 3840, 5120])
def test_gemm_plan_cutover(N):
    """The cut-over is in output elements: fewer rows go to wgmma as N
    grows."""
    cut = -(-TQ.WGMMA_MIN_MN // N)
    assert TQ.gemm_plan(cut - 1, N, 1280, 132)[0] == "splitk"
    assert TQ.gemm_plan(cut, N, 1280, 132)[0] == "wgmma"
    assert 24 <= cut <= 768  # prefill / alignment_forward sizes either way


@pytest.mark.parametrize("sms", [78, 114, 132])
@pytest.mark.parametrize("M,N,K", [(1, 48, 128), (6, 384, 256),
                                   (37, 160, 128), (200, 1280, 1312),
                                   (6, 1280, 5120), (24, 3840, 1280)])
def test_splitk_splits_divide_the_k_slabs(sms, M, N, K):
    """Every split is a whole number of 32-deep slabs, at least 4 of them
    when K is split; one split once the 128 x 128 tiles fill the card."""
    path, splits = TQ.gemm_plan(M, N, K, sms)
    assert path == "splitk"
    slabs = K // 32
    assert slabs % splits == 0
    assert splits == 1 or slabs // splits >= 4
    tiles = -(-M // 128) * -(-N // 128)
    if tiles >= sms:
        assert splits == 1
