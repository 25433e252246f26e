"""The plain versions of the port's beam-path kernels against the JAX
package's Pallas kernels (interpret mode) and their XLA references, on the
CPU:

  * the beam tail (ops/beam_tail.py vs ops/pallas_beam_tail.py and
    expand()'s XLA math, tests/test_beam_tail.py's ``xla_tail``);
  * the beam-cache reorder (ops/beam_reorder.py vs
    ops/pallas_beam_reorder.py), bit for bit;
  * the grouped int8 cross-attention (ops/cross_attn.py vs
    ops/pallas_cross_attn.py; the port's K/V are dh-minor, JAX's
    time-minor, so the test transposes), the grouped decoder-layer step and
    decoder_step on B*K rows over B windows.

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import random_jax_tree, to_jax
from whisper_aries_tpu.decoding import generate as JG
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.ops.pallas_beam_reorder import (
    permute_cache_rows as jax_permute,
)
from whisper_aries_tpu.ops.pallas_beam_tail import beam_tail as jax_beam_tail
from whisper_aries_tpu.ops.pallas_cross_attn import (
    cross_attention_q8 as jax_xattn,
    cross_attention_q8_blocked as jax_xattn_blocked,
    cross_attention_q8_reference as jax_xattn_ref,
)
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.ops import beam_reorder as BR
from whisper_aries_tpu_torch.ops import beam_tail as BT
from whisper_aries_tpu_torch.ops import cross_attn as XA
from whisper_aries_tpu_torch.ops import decode_layers as DL

NEG = float(np.finfo(np.float32).min)

# ---------------------------------------------------------------------------
# beam tail
# ---------------------------------------------------------------------------

V = 1000
IDS = JG.DecodeSpecialIds(eot=800, sot=801, no_speech=806, no_timestamps=807,
                          timestamp_begin=808, blank=220, n_vocab=V,
                          max_initial_timestamp_index=50)
TAIL = dict(tsb=IDS.timestamp_begin, eot=IDS.eot, blank=IDS.blank,
            no_ts=IDS.no_timestamps,
            init_cap=IDS.timestamp_begin + IDS.max_initial_timestamp_index)


def _tail_state(rng, B, K, ts_mix=True):
    """tests/test_beam_tail.py's state mix: fresh rows, open-pair rows,
    closed-pair rows, rows with a monotonic floor, dead beams (f32 min)."""
    tsb = IDS.timestamp_begin
    logits = rng.standard_normal((B * K, V)).astype(np.float32) * 3.0
    sum_lp = np.where(rng.random((B, K)) < 0.2, NEG,
                      rng.standard_normal((B, K)) * 2.0).astype(np.float32)
    if ts_mix:
        last = rng.choice([100, 221, tsb + 3, tsb + 40], (B, K))
        pen = rng.choice([-1, 50, tsb + 2, tsb + 39], (B, K))
        mts = rng.choice([-1, tsb + 5, tsb + 90], (B, K))
    else:
        last = np.full((B, K), 100)
        pen = np.full((B, K), -1)
        mts = np.full((B, K), -1)
    return (logits, sum_lp, last.astype(np.int32), pen.astype(np.int32),
            mts.astype(np.int32))


def _xla_tail(logits, sum_lp, last, pen, mts, sup, is_first, B, K, with_ts,
              suppress_blank):
    """expand()'s XLA branch in the JAX package (test_beam_tail.xla_tail)."""
    f = JG._apply_filters(jnp.asarray(logits), IDS, jnp.asarray(sup),
                          jnp.bool_(is_first), jnp.asarray(last).reshape(-1),
                          jnp.asarray(pen).reshape(-1),
                          jnp.asarray(mts).reshape(-1), with_ts,
                          suppress_blank)
    lp = jax.nn.log_softmax(f, axis=-1).reshape(B, K, V)
    total = jnp.asarray(sum_lp)[:, :, None] + lp
    eot_scores = total[:, :, IDS.eot]
    flat = total.at[:, :, IDS.eot].set(NEG).reshape(B, K * V)
    live, idx = JG._top_k_unrolled(flat, K)
    return [np.asarray(a) for a in (live, idx, eot_scores)]


def _port_tail(logits, sum_lp, last, pen, mts, sup, is_first, K, with_ts,
               suppress_blank):
    got = BT.beam_tail(torch.from_numpy(logits), torch.from_numpy(sum_lp),
                       torch.from_numpy(last).long(),
                       torch.from_numpy(pen).long(),
                       torch.from_numpy(mts).long(), torch.from_numpy(sup),
                       is_first, K, with_timestamps=with_ts,
                       suppress_blank=suppress_blank, **TAIL)
    return [t.numpy() for t in got]


def _assert_tail(got, want):
    """top_idx identical; scores within 1e-6 of max |want| (live scores of
    dead beams are f32 min, so the scale is taken over the finite ones)."""
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        finite = np.abs(w[np.abs(w) < 1e30])
        scale = finite.max() if finite.size else 1.0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("with_ts", [True, False])
@pytest.mark.parametrize("is_first", [False, True])
@pytest.mark.parametrize("suppress_blank", [True, False])
def test_beam_tail_plain_matches_jax(with_ts, is_first, suppress_blank):
    """The port's plain tail against JAX's Pallas beam_tail (interpret) and
    its XLA expand() tail, over the grammar state mix."""
    B, K = 3, 5
    rng = np.random.default_rng(11)
    logits, sum_lp, last, pen, mts = _tail_state(rng, B, K)
    sup = np.where(rng.random(V) < 0.01, NEG, 0.0).astype(np.float32)
    args = (logits, sum_lp, last, pen, mts, sup, is_first)
    got = _port_tail(*args, K, with_ts, suppress_blank)
    want_xla = _xla_tail(*args, B, K, with_ts, suppress_blank)
    want_pallas = [np.asarray(a) for a in jax_beam_tail(
        jnp.asarray(logits), jnp.asarray(sum_lp), jnp.asarray(last),
        jnp.asarray(pen), jnp.asarray(mts), jnp.asarray(sup),
        jnp.asarray(is_first), K=K, with_timestamps=with_ts,
        suppress_blank=suppress_blank, interpret=True, **TAIL)]
    _assert_tail(got, want_xla)
    _assert_tail(got, want_pallas)


def test_beam_tail_fully_masked_row():
    """A row whose every entry is masked (all f32 min) has log-probs
    -log(V), not 0: the max is subtracted before the log-sum-exp."""
    B, K = 2, 3
    rng = np.random.default_rng(4)
    logits, sum_lp, last, pen, mts = _tail_state(rng, B, K, ts_mix=False)
    sum_lp[:] = 0.0
    sup = np.zeros(V, np.float32)
    logits[1] = NEG  # window 0, beam 1: fully masked
    got = _port_tail(logits, sum_lp, last, pen, mts, sup, False, K, False,
                     True)
    want = _xla_tail(logits, sum_lp, last, pen, mts, sup, False, B, K, False,
                     True)
    _assert_tail(got, want)
    np.testing.assert_allclose(got[2][0, 1], -np.log(V), rtol=1e-6)


def test_beam_tail_planted_tie_takes_lowest_flat_index():
    """Two beams with identical logits and scores: every candidate of
    beam 2 ties one of beam 0, and the tie goes to the lower flat index."""
    B, K = 1, 4
    rng = np.random.default_rng(5)
    logits, sum_lp, last, pen, mts = _tail_state(rng, B, K, ts_mix=False)
    logits[2] = logits[0]
    sum_lp[0, :] = [0.5, -9.0, 0.5, -9.0]
    sup = np.zeros(V, np.float32)
    got = _port_tail(logits, sum_lp, last, pen, mts, sup, False, K, True,
                     True)
    want = _xla_tail(logits, sum_lp, last, pen, mts, sup, False, B, K, True,
                     True)
    _assert_tail(got, want)
    beams = got[1][0] // V
    assert list(beams[:2]) == [0, 2]  # each tie: beam 0 before beam 2
    assert got[0][0, 0] == got[0][0, 1]


def test_top_k_unrolled_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 997)).astype(np.float32)
    x[0, :] = NEG
    x[1, 100:] = NEG
    x[2, 10] = x[2, 20] = x[2, 30] = 7.5
    wv, wi = JG._top_k_unrolled(jnp.asarray(x), 5)
    gv, gi = BT._top_k_unrolled(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


# ---------------------------------------------------------------------------
# beam-cache reorder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int8", "float32", "bfloat16"])
def test_reorder_plain_matches_jax_bitwise(dtype):
    """Every leaf type of the fused cache (int8 values, f32 scales, bf16
    K/V): the in-place plain gather equals JAX's Pallas row permutation
    (interpret) bit for bit."""
    rng = np.random.default_rng(1)
    B, K = 3, 5
    src = rng.integers(0, K, (B, K)).astype(np.int32)
    shape = (4, B * K, 2, 3, 7, 8)
    if dtype == "int8":
        x = rng.integers(-127, 128, shape).astype(np.int8)
        xj, xt = jnp.asarray(x), torch.from_numpy(x.copy())
    elif dtype == "float32":
        x = rng.standard_normal(shape[:-1]).astype(np.float32)
        xj, xt = jnp.asarray(x), torch.from_numpy(x.copy())
    else:
        x = rng.standard_normal(shape).astype(np.float32)
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
            torch.bfloat16)
    want = jax_permute({"a": xj}, jnp.asarray(src), interpret=True)["a"]
    before = BR.permute_rows_kernel.launches
    out = BR.permute_cache_rows({"a": xt}, torch.from_numpy(src))["a"]
    assert out is xt  # in place
    assert BR.permute_rows_kernel.launches == before
    got = xt.float().numpy() if dtype == "bfloat16" else xt.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(want.astype(jnp.float32) if dtype == "bfloat16"
                        else want))


# ---------------------------------------------------------------------------
# grouped int8 cross-attention
# ---------------------------------------------------------------------------


def _xattn_operands(rng, B, H, G, T, dh=64):
    q = rng.standard_normal((B, H, G, dh)).astype(np.float32)
    k = rng.standard_normal((B, H, T, dh)).astype(np.float32)
    v = rng.standard_normal((B, H, T, dh)).astype(np.float32)
    k8, ks = XA.quantize_kv_per_position(torch.from_numpy(k))
    v8, vs = XA.quantize_kv_per_position(torch.from_numpy(v))
    return q, k8, ks / 8.0, v8, vs


@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("blocked", [False, True])
def test_grouped_cross_attention_plain_matches_jax(G, blocked):
    """q (B, H, G, dh) over shared int8 K/V: the port's plain version
    against JAX's Pallas kernels (interpret) on the transposed time-minor
    layout; atol 2e-4, rtol 1e-3 (tests/test_quant.py's tolerance)."""
    rng = np.random.default_rng(G)
    q, k8, ks, v8, vs = _xattn_operands(rng, 2, 3, G, 40)
    fn = jax_xattn_blocked if blocked else jax_xattn
    t = lambda a: jnp.asarray(np.swapaxes(a.numpy(), -1, -2))
    s = lambda a: jnp.asarray(a.numpy()[:, :, None, :])
    want = np.asarray(fn(jnp.asarray(q), t(k8), s(ks), t(v8), s(vs),
                         interpret=True))
    before = XA.cross_attention_q8_kernel.launches
    got = XA.cross_attention_q8(torch.from_numpy(q), k8, ks, v8, vs).numpy()
    assert XA.cross_attention_q8_kernel.launches == before
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    ref = np.asarray(jax_xattn_ref(jnp.asarray(q), t(k8), s(ks), t(v8),
                                   s(vs)))
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_grouped_cross_attention_rows_are_independent():
    """Each of a window's G queries gets what it would get alone."""
    rng = np.random.default_rng(3)
    q, k8, ks, v8, vs = _xattn_operands(rng, 2, 2, 5, 30)
    qt = torch.from_numpy(q)
    got = XA.cross_attention_q8(qt, k8, ks, v8, vs)
    for g in range(5):
        one = XA.cross_attention_q8(qt[:, :, g:g + 1], k8, ks, v8, vs)
        torch.testing.assert_close(got[:, :, g:g + 1], one, rtol=1e-6,
                                   atol=1e-6)


DIMS_J = JW.WhisperDims(80, 40, 128, 2, 2, 96, 32, 128, 2, 2)
DIMS_T = TW.WhisperDims(*[getattr(DIMS_J, f) for f in
                          DIMS_J.__dataclass_fields__])


@pytest.fixture(scope="module")
def tree():
    return random_jax_tree(DIMS_J, seed=21)


@pytest.mark.parametrize("self_int8", [False, True])
def test_fused_plain_grouped_equals_replicated(tree, self_int8):
    """The decoder-layer step's plain version with G = 5 rows per window
    over Bw = 2 windows equals the same step at G = 1 over the cross K/V
    replicated to every row."""
    rng = np.random.default_rng(6)
    tp = TW.fuse_decoder_qkv(TW.params_from_jax(tree))
    wpack = DL.pack_layer_weights(tp["decoder"]["blocks"])
    Bw, G, T, P = 2, 5, 12, 4
    R = Bw * G
    xa = torch.from_numpy(rng.standard_normal((Bw, 40, 128)).astype(
        np.float32))
    cross = TW.precompute_cross_kv_int8(tp, xa, DIMS_T)
    rep = {k: v.repeat_interleave(G, dim=1) for k, v in cross.items()}
    kv = torch.zeros((2, R, 2, 2, T, 64))
    kv[..., :P, :] = torch.from_numpy(
        0.5 * rng.standard_normal((2, R, 2, 2, P, 64)).astype(np.float32))
    if self_int8:
        q8, sc = DL.quantize_heads(kv)
        cache = {"kv8": q8, "ksc": sc}
    else:
        cache = {"kv": kv}
    c1 = {k: v.clone() for k, v in cache.items()}
    c2 = {k: v.clone() for k, v in cache.items()}
    x = torch.from_numpy(rng.standard_normal((R, 128)).astype(np.float32))
    got = DL.fused_decoder_layers(x, wpack, c1, cross, 0, P, 2)
    want = DL.fused_decoder_layers_plain(x, wpack, c2, rep, 0, P, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    for k in c1:
        torch.testing.assert_close(c1[k], c2[k], rtol=0, atol=1e-6)


@pytest.mark.parametrize("cross_int8", [False, True])
def test_decoder_step_on_beam_rows_matches_jax(tree, cross_int8):
    """decoder_step on B*K window-major rows over B windows' cross K/V
    (the prefill on K repeated prompts, then one step with a different
    token per beam) against JAX's grouped decoder_step."""
    B, K, T = 2, 3, 8
    rng = np.random.default_rng(8)
    jp = JW.fuse_decoder_qkv(to_jax(tree))
    tp = TW.fuse_decoder_qkv(TW.params_from_jax(tree))
    xa = rng.standard_normal((B, 40, 128)).astype(np.float32)
    xa_j, xa_t = jnp.asarray(xa), torch.from_numpy(xa)
    if cross_int8:
        cj = JW.precompute_cross_kv_int8(jp, xa_j, DIMS_J)
        ct = TW.precompute_cross_kv_int8(tp, xa_t, DIMS_T)
    else:
        cj = JW.precompute_cross_kv(jp, xa_j, DIMS_J)
        ct = TW.precompute_cross_kv(tp, xa_t, DIMS_T)
    prompt = np.repeat(np.array([[5, 9, 1], [7, 3, 3]], np.int32), K, axis=0)
    cache_j = JW.init_kv_cache(DIMS_J, B * K, max_len=T)
    cache_t = TW.init_kv_cache(DIMS_T, B * K, max_len=T)
    lj, cache_j = JW.decoder_step(jp, jnp.asarray(prompt), jnp.int32(0),
                                  cache_j, cj, DIMS_J)
    lt = TW.decoder_step(tp, torch.from_numpy(prompt).long(), 0, cache_t, ct,
                         DIMS_T)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
    step = rng.integers(0, 90, (B * K, 1)).astype(np.int32)
    lj, _ = JW.decoder_step(jp, jnp.asarray(step), jnp.int32(3), cache_j, cj,
                            DIMS_J)
    lt = TW.decoder_step(tp, torch.from_numpy(step).long(), 3, cache_t, ct,
                         DIMS_T)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)


def test_cross_attention_step_groups_three_rows_per_window(tree):
    """rows = 3 * Bw: each row's cross-attention equals the ungrouped call
    on its own window's K/V."""
    rng = np.random.default_rng(9)
    tp = TW.fuse_decoder_qkv(TW.params_from_jax(tree))
    Bw = 2
    xa = torch.from_numpy(rng.standard_normal((Bw, 40, 128)).astype(
        np.float32))
    cross = TW.precompute_cross_kv_int8(tp, xa, DIMS_T)
    kv0 = TW.layer_slice(cross, 0)
    cp = TW.layer_slice(tp["decoder"]["blocks"]["cross"], 0)
    h = torch.from_numpy(rng.standard_normal((3 * Bw, 2, 128)).astype(
        np.float32))
    got = TW._cross_attention_step(cp, h, kv0, 2)
    rep = {k: v.repeat_interleave(3, dim=0) for k, v in kv0.items()}
    want = TW._cross_attention_step(cp, h, rep, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="windows"):
        TW._cross_attention_step(cp, h[:5], kv0, 2)
