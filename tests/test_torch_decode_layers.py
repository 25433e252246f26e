"""The port's decoder-layer step (whisper_aries_tpu_torch.ops.decode_layers)
against the JAX package's golden model of its Pallas megakernel,
``fused_decoder_layers_reference``, on the CPU in f32.

The port decodes one row per window (the JAX reference with beam_k=1 and
Bw=B) in its own dh-minor cache layouts; the test converts layouts, never
the math. The CUDA kernels are held against the same plain version on the
card (test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_util import (
    NEG,
    random_jax_tree,
    self_cache_from_jax,
    self_cache_to_jax,
    to_jax,
)
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.ops import pallas_decode_layers as JDL
from whisper_aries_tpu.ops.quant import quantize_model_params as jax_quantize
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.ops import decode_layers as DL

# d 128 = 2 heads x dh 64 (the kernels' head width), ff 512, 2 layers
DIMS_J = JW.WhisperDims(80, 40, 128, 2, 2, 96, 32, 128, 2, 2)
H, DH, R, T, TA = 2, 64, 3, 12, 40


@pytest.fixture(scope="module")
def tree():
    return random_jax_tree(DIMS_J, seed=21)


@pytest.mark.parametrize("quantized", [False, True])
def test_pack_layer_weights_identical(tree, quantized):
    jp = JW.fuse_decoder_qkv(to_jax(tree))
    tp = TW.fuse_decoder_qkv(TW.params_from_jax(tree))
    if quantized:
        from whisper_aries_tpu_torch.ops.quant import quantize_model_params

        jp, tp = jax_quantize(jp), quantize_model_params(tp)
    want = JDL.pack_layer_weights(jp["decoder"]["blocks"])
    got = DL.pack_layer_weights(tp["decoder"]["blocks"])
    for k in ("wq8", "wf18", "wf28"):
        assert got[k].dtype == torch.int8
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["vecs"].numpy(),
                                  np.asarray(want["vecs"])[:, 0])
    offs_j, vec_j = JDL._vec_offsets(128, 512)
    offs_t, vec_t = DL.vec_offsets(128, 512)
    np.testing.assert_array_equal(offs_t, offs_j)
    assert vec_t == vec_j


def test_erf_as_matches_jax():
    """Same operations in the same order; the two exp implementations may
    differ in the last bit, so within one f32 ulp of 1 (absolute)."""
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    np.testing.assert_allclose(
        DL.erf_as(torch.from_numpy(x)).numpy(),
        np.asarray(JDL._erf_as(jnp.asarray(x))), atol=1.2e-7, rtol=0)


def _operands(tree, self_int8, P=5, seed=0):
    rng = np.random.default_rng(seed)
    tp = TW.fuse_decoder_qkv(TW.params_from_jax(tree))
    wpack = DL.pack_layer_weights(tp["decoder"]["blocks"])
    L = DIMS_J.n_text_layer
    kv = np.zeros((L, R, 2, H, T, DH), np.float32)
    kv[..., :P, :] = 0.5 * rng.standard_normal((L, R, 2, H, P, DH))
    kv = torch.from_numpy(kv)
    if self_int8:
        q8, sc = DL.quantize_heads(kv)
        cache = {"kv8": q8, "ksc": sc}
    else:
        cache = {"kv": kv}
    xa = torch.from_numpy(rng.standard_normal((R, TA, 128)).astype(np.float32))
    dims_t = TW.WhisperDims(*[getattr(DIMS_J, f) for f in
                              DIMS_J.__dataclass_fields__])
    cross = TW.precompute_cross_kv_int8(tp, xa, dims_t)
    return wpack, cache, cross, rng


def _jax_kernel_step(x, jpack, ckv_j, xkv8, xsc, pos, vs, ksc_j):
    """One step of JAX's megakernel itself (``fused_decoder_layers``,
    interpret mode) in its layouts: the self cache's minor padded to the
    256 lanes it needs, the cross keys to a multiple of 128 (zero K/V,
    dead by the cross mask). Returns x and the cache (and scales) cut back
    to the test's T."""
    M, TaP = 256, 128
    lanes = lambda a, n: jnp.pad(a, ((0, 0),) * (a.ndim - 1)
                                 + ((0, n - a.shape[-1]),))
    t = np.arange(M)
    amask = np.where((t >= vs) & (t <= pos), 0.0, NEG).astype(np.float32)
    amask = jnp.asarray(np.broadcast_to(amask, (R, 1, M)))
    cmask = np.where(np.arange(TaP) < TA, 0.0, NEG).astype(np.float32)
    cmask = jnp.asarray(np.broadcast_to(cmask, (8, TaP)))
    out = JDL.fused_decoder_layers(
        jnp.asarray(x), jpack, lanes(ckv_j, M), lanes(xkv8, TaP),
        lanes(xsc, TaP), cmask, amask, jnp.int32(pos), n_head=H, beam_k=1,
        ksc=None if ksc_j is None else lanes(ksc_j, M), interpret=True)
    return (out[0], out[1][..., :T]) + ((out[2][..., :T],)
                                         if ksc_j is not None else ())


# golden "reference": fused_decoder_layers_reference; "kernel": JAX's
# megakernel in interpret mode, at x f32 with an f32 self cache (the
# card's compute_type "f32" without an int8 self cache)
@pytest.mark.parametrize("self_int8,golden",
                         [(False, "reference"), (True, "reference"),
                          (False, "kernel")],
                         ids=["False", "True", "f32-cache-kernel"])
def test_plain_layers_match_jax_reference(tree, self_int8, golden):
    """Four consecutive steps, valid_start 1, f32.

    bf16-layout cache: x within 1e-4, appended K/V within 1e-5. int8 cache:
    the frameworks sum each GEMM in a different order, so the appended K/V
    differ in the last bit before quantization; a value sitting on a
    rounding boundary then lands one int8 step away, and x moves by ~1e-3.
    So int8 values are held to at most one step apart in under 1% of the
    entries, scales to 1e-6 relative, x to 2e-3. Against the megakernel
    (f32 cache) the same limits as against the reference."""
    P, vs = 5, 1
    wpack, cache, cross, rng = _operands(tree, self_int8, P)
    jpack = {"vecs": jnp.asarray(wpack["vecs"].numpy()[:, None]),
             **{k: jnp.asarray(wpack[k].numpy())
                for k in ("wq8", "wf18", "wf28")}}
    ckv_j, ksc_j = self_cache_to_jax(
        cache["kv8" if self_int8 else "kv"], cache.get("ksc"), H)
    ckv_j, ksc_j = jnp.asarray(ckv_j), (None if ksc_j is None
                                        else jnp.asarray(ksc_j))
    # the int8 cross K/V share the self cache's layout in both packages
    xkv8, xsc = map(jnp.asarray,
                    self_cache_to_jax(cross["kv8"], cross["sc"], H))
    for pos in range(P, P + 4):
        x = rng.standard_normal((R, 128)).astype(np.float32)
        t = np.arange(T)
        amask = np.where((t >= vs) & (t <= pos), 0.0, NEG).astype(np.float32)
        amask = jnp.asarray(np.broadcast_to(amask, (R, 1, T)))
        if golden == "kernel":
            out = _jax_kernel_step(x, jpack, ckv_j, xkv8, xsc, pos, vs,
                                   ksc_j)
        else:
            out = JDL.fused_decoder_layers_reference(
                jnp.asarray(x), jpack, ckv_j, xkv8, xsc, amask,
                jnp.int32(pos), n_head=H, beam_k=1, ksc=ksc_j)
        got = DL.fused_decoder_layers(torch.from_numpy(x), wpack, cache,
                                      cross, vs, pos, H)
        np.testing.assert_allclose(got.numpy(), np.asarray(out[0]),
                                   atol=2e-3 if self_int8 else 1e-4, rtol=0)
        ckv_j = out[1]
        ksc_j = out[2] if self_int8 else None
        want_kv, want_sc = self_cache_from_jax(ckv_j, ksc_j, H)
        if self_int8:
            a = cache["kv8"][..., pos, :].numpy().astype(np.int32)
            b = want_kv[..., pos, :].astype(np.int32)
            assert np.abs(a - b).max() <= 1 and (a != b).mean() < 0.01
            np.testing.assert_allclose(cache["ksc"][..., pos].numpy(),
                                       want_sc[..., pos], rtol=1e-6)
        else:
            np.testing.assert_allclose(cache["kv"][..., pos, :].numpy(),
                                       want_kv[..., pos, :], atol=1e-5)


def _dyadic_x(rng, rows):
    """Rows of +-16, half each: mean 0 and variance 256 exactly, so
    256 + eps rounds to 256 and the first LayerNorm's output is
    exactly +-scale + bias."""
    x = np.full((rows, 128), 16.0, np.float32)
    for r in range(rows):
        x[r, rng.permutation(128)[:64]] = -16.0
    return x


@pytest.mark.parametrize("self_int8", [False, True])
def test_appended_self_cache_identical_dyadic(tree, self_int8):
    """With dyadic operands every sum that feeds the append is exact in f32
    whatever the order: the first LayerNorm (see ``_dyadic_x``), the qkv
    product (int8 weights times multiples of 1/16), its power-of-two scales
    and dyadic bias. So the appended K/V are exact in both frameworks and
    the int8 values and scales quantized from them are identical, as is an
    f32 cache; x within 1e-4. Each layer runs alone on a fresh input
    (teacher-forced), four steps, valid_start 1."""
    P, vs = 5, 1
    wpack, cache, cross, rng = _operands(tree, self_int8, P, seed=3)
    offs, _ = DL.vec_offsets(128, 512)
    vecs = wpack["vecs"]
    seg = lambda i: slice(int(offs[i]), int(offs[i + 1]))
    L = vecs.shape[0]
    vecs[:, seg(0)] = torch.from_numpy(rng.integers(-4, 5, (L, 128)) / 4.0)
    vecs[:, seg(1)] = torch.from_numpy(rng.integers(-8, 9, (L, 128)) / 16.0)
    vecs[:, seg(2)] = torch.from_numpy(rng.integers(-8, 9, (L, 384)) / 64.0)
    vecs[:, seg(12)] = torch.from_numpy(
        2.0 ** rng.integers(-8, -5, (L, 384)))
    jpack = {"vecs": jnp.asarray(vecs.numpy()[:, None]),
             **{k: jnp.asarray(wpack[k].numpy())
                for k in ("wq8", "wf18", "wf28")}}
    key = "kv8" if self_int8 else "kv"
    xkv8, xsc = map(jnp.asarray,
                    self_cache_to_jax(cross["kv8"], cross["sc"], H))
    sl = lambda tree_, l: {k: v[l:l + 1] for k, v in tree_.items()}
    for pos in range(P, P + 4):
        t = np.arange(T)
        amask = np.where((t >= vs) & (t <= pos), 0.0, NEG).astype(np.float32)
        amask = jnp.asarray(np.broadcast_to(amask, (R, 1, T)))
        for l in range(L):
            x = _dyadic_x(rng, R)
            ksc_l = cache["ksc"][l:l + 1] if self_int8 else None
            ckv_j, ksc_j = self_cache_to_jax(cache[key][l:l + 1], ksc_l, H)
            out = JDL.fused_decoder_layers_reference(
                jnp.asarray(x), {k: v[l:l + 1] for k, v in jpack.items()},
                jnp.asarray(ckv_j), xkv8[l:l + 1], xsc[l:l + 1], amask,
                jnp.int32(pos), n_head=H, beam_k=1,
                ksc=None if ksc_j is None else jnp.asarray(ksc_j))
            got = DL.fused_decoder_layers(torch.from_numpy(x), sl(wpack, l),
                                          sl(cache, l), sl(cross, l), vs,
                                          pos, H)
            np.testing.assert_allclose(got.numpy(), np.asarray(out[0]),
                                       atol=1e-4, rtol=0)
            want_kv, want_sc = self_cache_from_jax(
                out[1], out[2] if self_int8 else None, H)
            np.testing.assert_array_equal(cache[key][l:l + 1, ..., pos, :],
                                          want_kv[..., pos, :])
            if self_int8:
                np.testing.assert_array_equal(cache["ksc"][l:l + 1, ..., pos],
                                              want_sc[..., pos])


def test_wrapper_takes_plain_version_on_cpu(tree):
    wpack, cache, cross, rng = _operands(tree, True)
    before = DL.fused_decoder_layers.launches
    x = torch.from_numpy(rng.standard_normal((R, 128)).astype(np.float32))
    c2 = {k: v.clone() for k, v in cache.items()}
    a = DL.fused_decoder_layers(x, wpack, cache, cross, 0, 5, H)
    b = DL.fused_decoder_layers_plain(x, wpack, c2, cross, 0, 5, H)
    assert torch.equal(a, b)
    assert DL.fused_decoder_layers.launches == before


def test_quantize_heads_grid():
    """absmax / 127, round half to even, clip 127; all-zero rows get
    scale 1."""
    v = torch.tensor([[0.0] * 4, [127.0, 63.5, -0.5, 1.5],
                      [2.54, -1.27, 0.635, 0.0]])
    q8, sc = DL.quantize_heads(v)
    assert sc.tolist()[0] == 1.0 and sc.tolist()[1] == 1.0
    assert q8[1].tolist() == [127, 64, 0, 2]  # 63.5 -> 64, -0.5 -> -0 ...
    assert q8[2].tolist() == [127, -64, 32, 0]
