"""The decode step's grid plans and split-KV combine
(whisper_aries_tpu_torch.ops.decode_layers), on the CPU.

The CUDA step (csrc/decode_layers.cu, csrc/attn_split.cuh) splits each W8A16
product's K over a cluster of blocks and each attention's keys over a
cluster of blocks. Its plans are mirrored in Python (``gemm_plan``,
``attn_split``, ``cross_split``) and its split-softmax combine in plain torch
(``self_attn_split_plain``, ``cross_attn_split_plain``); here they are held
against what they must cover and against the one-pass plain versions (and
JAX's cross-attention reference). The kernels themselves are held on the
card (test_torch_cuda.py, chip_smoke.py)."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_aries_tpu.ops.pallas_cross_attn import (
    cross_attention_q8_reference as jax_xattn_ref,
)
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.ops import decode_layers as DL
from whisper_aries_tpu_torch.ops.cross_attn import quantize_kv_per_position

LARGE_V3 = TW.PRESETS["large-v3"]


def _gemm_shapes(d, ff):
    """(K, N) of the step's products: qkv, o / cross q / cross o, fc1,
    fc2."""
    return [(d, 3 * d), (d, d), (d, ff), (ff, d)]


SHAPES = sorted(set(
    _gemm_shapes(LARGE_V3.n_text_state, 4 * LARGE_V3.n_text_state)
    + _gemm_shapes(128, 512)   # the tiny test models (d 128, 2 heads)
    + _gemm_shapes(256, 1024)))


@pytest.mark.parametrize("sms", [132, 114, 78, 16])
@pytest.mark.parametrize("K,N", SHAPES)
def test_gemm_plan_covers_k_in_whole_stages(K, N, sms):
    """The K slices are equal, whole multiples of 64 rows, and cover K
    exactly; the slices of a column tile form a legal (portable) cluster."""
    s, kslice = DL.gemm_plan(K, N, sms)
    assert 1 <= s <= DL.GEMM_MAX_CLUSTER
    assert kslice % DL.GEMM_KC == 0 and s * kslice == K
    starts = [i * kslice for i in range(s)]
    covered = np.zeros(K, int)
    for a in starts:
        covered[a:a + kslice] += 1
    assert (covered == 1).all()
    # the least legal split that reaches the target, else the largest
    cols, units = N // DL.GEMM_COLS, K // DL.GEMM_KC
    legal = [c for c in range(1, DL.GEMM_MAX_CLUSTER + 1) if units % c == 0]
    reach = [c for c in legal if cols * c >= DL.GEMM_TARGET_WAVES * sms]
    assert s == (reach[0] if reach else legal[-1])


def test_gemm_plan_at_large_v3_on_an_h100():
    """The plan the card runs (132 SMs): every product at least 100 blocks,
    one launch each."""
    got = {(K, N): DL.gemm_plan(K, N, 132) for K, N in _gemm_shapes(1280, 5120)}
    assert got == {(1280, 3840): (5, 256), (1280, 1280): (5, 256),
                   (1280, 5120): (4, 320), (5120, 1280): (8, 640)}


def test_gemm_plan_refuses_shapes_off_the_grid():
    with pytest.raises(ValueError, match="multiples"):
        DL.gemm_plan(1280, 1296, 132)
    with pytest.raises(ValueError, match="multiples"):
        DL.gemm_plan(1300, 1280, 132)


@pytest.mark.parametrize("T", [1, 16, 31, 32, 33, 96, 200, 227, 256, 257,
                               448, 1500, 2048])
def test_attn_split_covers_every_key_once(T):
    """Every key in exactly one split, at most 8 splits of a multiple of 32
    keys (at most 256), only the last split ragged, none empty."""
    S, C = DL.attn_split(T)
    assert 1 <= S <= DL.ATTN_MAX_SPLITS
    assert C % 32 == 0 and C <= DL.ATTN_MAX_KEYS
    covered = np.zeros(T, int)
    for s in range(S):
        covered[s * C:min(T, (s + 1) * C)] += 1
    assert (covered == 1).all()
    assert (S - 1) * C < T <= S * C


@pytest.mark.parametrize("Ta", [40, 97, 1500, 2048])
@pytest.mark.parametrize("pairs", [2, 40, 120, 160, 640, 5000])
def test_cross_split_covers_every_key_once(Ta, pairs):
    """The cross-attention plan: every key in exactly one split, at most 8
    splits, only the last ragged, and as many splits as keep the grid one
    wave of 3 blocks per SM (132 SMs)."""
    S, C = DL.cross_split(Ta, pairs, 1, 132)
    assert 1 <= S <= DL.ATTN_MAX_SPLITS and C % 32 == 0
    assert (S - 1) * C < Ta <= S * C
    want = min(DL.ATTN_MAX_SPLITS, max(1, 3 * 132 // pairs))
    assert S <= want and (S == want or C == 32 or -(-Ta // want) <= C)


def test_cross_split_at_the_slices_shapes():
    """8 windows x 20 heads (beam 5 over a full batch) take 2 splits of
    768 keys, the slices' 6 windows 3 of 512 (2 of 768 for the per-warp
    kernel's 15 queries a window): more than one block per (head, window),
    one wave. The plan reads shapes, never the position."""
    assert DL.cross_split(1500, 8 * 20, 5, 132) == (2, 768)
    assert DL.cross_split(1500, 6 * 20, 1, 132) == (3, 512)
    assert DL.cross_split(1500, 6 * 20, 15, 132) == (2, 768)
    params = inspect.signature(DL.cross_split).parameters
    assert list(params) == ["Ta", "pairs", "G", "sms"]


def test_attn_split_does_not_depend_on_the_position():
    """One grid for every step of a decode call: the plan takes T alone,
    and the split ranges of a self cache are the same at every position."""
    assert list(inspect.signature(DL.attn_split).parameters) == ["T"]
    assert DL.attn_split(227) == (8, 32)   # 3 prompt + 224 sampled
    assert DL.attn_split(448) == (7, 64)   # n_text_ctx
    ranges = DL._split_ranges(227, None)
    assert ranges[-1] == (224, 227)       # ragged


def _self_case(rng, R, H, T, P, int8):
    d = 64 * H
    qkv = torch.from_numpy(rng.standard_normal((R, 3 * d)).astype(np.float32))
    kv = np.zeros((R, 2, H, T, 64), np.float32)
    kv[..., :P, :] = rng.standard_normal((R, 2, H, P, 64))
    kv = torch.from_numpy(kv)
    if int8:
        q8, sc = DL.quantize_heads(kv)
        return qkv, {"kv8": q8, "ksc": sc}
    return qkv, {"kv": kv}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8, None])
@pytest.mark.parametrize("vs,pos", [(0, 9), (0, 39), (17, 30), (26, 26)])
def test_self_split_combine_matches_plain(int8, splits, vs, pos):
    """The split-softmax combine against one softmax over [vs, pos], f32 on
    the CPU (no bf16 rounding: the sums differ only in order), within 1e-5
    of max |want|. With 40 keys in 8 splits of 5, [17, 30] leaves splits
    0-2 and 7 empty and [26, 26] all but one: no NaN, nothing added. The
    appended cache is the plain version's."""
    rng = np.random.default_rng(7)
    qkv, cache = _self_case(rng, 3, 2, 40, 27, int8)
    cp = {k: v.clone() for k, v in cache.items()}
    got = DL.self_attn_split_plain(qkv, cache, pos, vs, 2, splits)
    want = DL.self_attn_plain(qkv, cp, pos, vs, 2)
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err < 1e-5
    for k in cache:
        assert torch.equal(cache[k], cp[k])


def test_self_split_combine_empty_split_adds_nothing():
    """A split with no live key has max -inf: its weight is exactly 0, so
    the output equals the same combine with that split's keys moved into
    no split at all (the live keys in one split)."""
    rng = np.random.default_rng(8)
    qkv, cache = _self_case(rng, 2, 2, 64, 40, False)
    a = DL.self_attn_split_plain(qkv, {k: v.clone() for k, v in cache.items()},
                                 35, 33, 2, 8)     # splits of 8: one live
    b = DL.self_attn_split_plain(qkv, {k: v.clone() for k, v in cache.items()},
                                 35, 33, 2, 1)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _cross_case(rng, Bw, G, H, Ta):
    kv = torch.from_numpy(
        rng.standard_normal((Bw, 2, H, Ta, 64)).astype(np.float32))
    kv8, sc = quantize_kv_per_position(kv)
    sc[:, 0] /= 8.0
    cq = torch.from_numpy(
        (2 * rng.standard_normal((Bw * G, 64 * H))).astype(np.float32))
    return cq, kv8, sc


@pytest.mark.parametrize("splits", [1, 2, 4, 6, 7, 8, None])
@pytest.mark.parametrize("Bw,G,Ta", [(2, 1, 40), (2, 5, 97), (1, 3, 1500)])
def test_cross_split_combine_matches_plain(splits, Bw, G, Ta):
    """Against cross_attn_plain (one softmax over all Ta keys), f32, within
    1e-5 of max |want|; 97 keys in 7 splits leave a ragged last split, in
    8 splits of 13 an empty one."""
    rng = np.random.default_rng(Ta + G)
    cq, kv8, sc = _cross_case(rng, Bw, G, 2, Ta)
    got = DL.cross_attn_split_plain(cq, kv8, sc, 2, splits)
    want = DL.cross_attn_plain(cq, kv8, sc, 2)
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err < 1e-5


@pytest.mark.parametrize("splits", [None, 3])
def test_cross_split_combine_matches_jax_reference(splits):
    """Against the JAX package's cross_attention_q8_reference on its
    time-minor layout: atol 2e-4, rtol 1e-3 (tests/test_quant.py's
    tolerance)."""
    rng = np.random.default_rng(11)
    Bw, G, H, Ta = 2, 5, 2, 96
    cq, kv8, sc = _cross_case(rng, Bw, G, H, Ta)
    got = DL.cross_attn_split_plain(cq, kv8, sc, H, splits).numpy()
    q = cq.numpy().reshape(Bw, G, H, 64).transpose(0, 2, 1, 3)
    t = lambda a: jnp.asarray(np.swapaxes(a.numpy(), -1, -2))
    s = lambda a: jnp.asarray(a.numpy()[:, :, None, :])
    want = np.asarray(jax_xattn_ref(jnp.asarray(q), t(kv8[:, 0]), s(sc[:, 0]),
                                    t(kv8[:, 1]), s(sc[:, 1])))
    want = want.transpose(0, 2, 1, 3).reshape(Bw * G, H * 64)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_decode_graph_only_on_the_card():
    """On CPU operands the decode loop takes no graph: the fused step of
    the loop graph and the step graph refuse to be built."""
    wpack = {"wq8": torch.zeros((1, 128, 768), dtype=torch.int8)}
    with pytest.raises(ValueError, match="CUDA"):
        DL.FusedStep(wpack, {}, {}, 2, 2, 0, 4)
    with pytest.raises(ValueError, match="CUDA"):
        DL.DecodeStepGraph(wpack, {}, {}, 2, 2)
