"""The speculative verify step of the port (``decoder_step_fused_multi``,
``fused_decoder_layers(..., queries=S)``) on the CPU, where it runs the
plain version.

  * against the JAX package's ``decoder_step_fused_multi`` (its Pallas
    megakernel in interpret mode, windows grouped in pairs), over two
    consecutive verify steps (the second reads lanes the first appended),
    S 3 and 4, both self-cache dtypes;
  * against S consecutive one-token steps of the same plain version;
  * the split-KV combine of S queries a cache row against the one-pass
    plain version, over split boundaries;
  * lanes a rejected draft left behind are rewritten before they are read;
  * S = 1 computes what the one-token step computed before the verify mode.

Tiny dims (d 128 = 2 heads of 64, 2 layers, 40 audio positions). The
kernels themselves are held on the card (test_torch_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import random_jax_tree, to_jax
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.ops import pallas_decode_layers as JDL
from whisper_aries_tpu.ops.quant import quantize_model_params as jax_quantize
from whisper_aries_tpu_torch.decoding import generate as TG
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.models.layers import attn_scale
from whisper_aries_tpu_torch.ops import decode_layers as DL

DIMS_J = JW.WhisperDims(80, 40, 128, 2, 2, 96, 32, 128, 2, 2)
DIMS_T = TW.WhisperDims(*[getattr(DIMS_J, f) for f in
                          DIMS_J.__dataclass_fields__])
H, B, P, GROUP = 2, 4, 2, 2
# the JAX runs: S drafted tokens a window x self-cache dtype (int8 or not)
RUNS = [(3, False), (3, True), (4, False), (4, True)]


@pytest.fixture(scope="module")
def model():
    tree = random_jax_tree(DIMS_J, seed=19, weight_std=0.08)
    qtree = jax_quantize(to_jax(tree))
    jparams = JW.fuse_decoder_qkv(qtree)
    tparams = TW.fuse_decoder_qkv(
        TW.params_from_jax(jax.tree.map(np.asarray, qtree)))
    rng = np.random.default_rng(5)
    xa = rng.standard_normal((B, DIMS_J.n_audio_ctx, 128)).astype(np.float32)
    prompt = rng.integers(3, 90, (B, P)).astype(np.int32)
    drafts = rng.integers(3, 90, (B, 8)).astype(np.int32)
    return jparams, tparams, xa, prompt, drafts


def _max_len(S):
    return P + 2 * S + 2


def _torch_prefill(tparams, xa, prompt, S, self_int8):
    """The port's prefill of the prompt, repacked for the decoder-layer
    step (generate.py's fused path), its int8 cross K/V and weight pack."""
    xa_t = torch.from_numpy(xa)
    cross = TW.precompute_cross_kv_int8(tparams, xa_t, DIMS_T)
    cache = TW.init_kv_cache(DIMS_T, B, max_len=_max_len(S))
    TW.decoder_step(tparams, torch.from_numpy(prompt).long(), 0, cache,
                    cross, DIMS_T)
    cache = TG._pack_fused_cache(cache, self_int8)
    wpack = DL.pack_layer_weights(tparams["decoder"]["blocks"])
    return cross, cache, wpack


@pytest.fixture(scope="module")
def jax_runs(model):
    """Each run of RUNS: the JAX logits of two consecutive verify steps at
    pos P and P + S (decoder_step_fused_multi, interpret mode)."""
    jparams, _, xa, prompt, drafts = model
    xa_j = jnp.asarray(xa)
    cross_mega = JW.precompute_cross_kv_int8_packed(jparams, xa_j, DIMS_J)
    cross_g = JW.group_cross_mega(cross_mega, GROUP)
    cache0 = JW.init_kv_cache(DIMS_J, B, dtype=xa_j.dtype, max_len=P)
    _, cache0 = JW.decoder_step(
        jparams, jnp.asarray(prompt), jnp.int32(0), cache0,
        JW.cross_views_from_packed(cross_mega, H, DIMS_J.n_audio_ctx),
        DIMS_J)
    wpack = JDL.pack_layer_weights(jparams["decoder"]["blocks"])
    out = {}
    for S, self_int8 in RUNS:
        packed = JW.pack_greedy_prefill_cache(cache0, GROUP, _max_len(S),
                                              int8=self_int8, n_head=H)
        logits = []
        for i in range(2):
            lg, packed = JW.decoder_step_fused_multi(
                jparams, wpack, jnp.asarray(drafts[:, i * S:(i + 1) * S]),
                jnp.int32(P + i * S), packed, cross_g, DIMS_J, group=GROUP,
                interpret=True)
            logits.append(np.asarray(lg))
        out[S, self_int8] = logits
    return out


@pytest.mark.parametrize("S,self_int8", RUNS)
def test_verify_step_matches_jax(model, jax_runs, S, self_int8):
    """Two consecutive verify steps: the same argmax at every drafted
    position, and logits within 1e-4 of their max |want|, both cache
    dtypes. The frameworks sum each GEMM in another order (f32 here), so
    the logits differ in their last bits: 1.0e-5 to 1.7e-5 at the first
    step, under 3e-6 at the second, on these seeds. An int8 value on a
    rounding boundary could land one step away and move x by ~1e-3 a layer
    (test_torch_decode_layers.py); none does here. The limit sits far
    below a verify step whose drafted queries each see the key one past
    their own position (0.58 of max |want|, held in the same test)."""
    _, tparams, xa, prompt, drafts = model
    want = jax_runs[S, self_int8]
    cross, cache, wpack = _torch_prefill(tparams, xa, prompt, S, self_int8)
    tol = 1e-4
    for i in range(2):
        tok = torch.from_numpy(drafts[:, i * S:(i + 1) * S]).long()
        got, cache = TW.decoder_step_fused_multi(tparams, wpack, tok,
                                                 P + i * S, cache, cross,
                                                 DIMS_T)
        assert got.dtype == torch.float32 and got.shape == (B, S, 96)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      want[i].argmax(-1))
        err = np.abs(got.numpy() - want[i]).max() / np.abs(want[i]).max()
        assert err < tol, (i, err)
    # the named mistake: each query also sees the key one past its own
    # position (its neighbour's draft), on the second step
    cross, cache, wpack = _torch_prefill(tparams, xa, prompt, S, self_int8)
    tok = torch.from_numpy(drafts[:, :S]).long()
    TW.decoder_step_fused_multi(tparams, wpack, tok, P, cache, cross, DIMS_T)
    with _one_key_past():
        wrong, _ = TW.decoder_step_fused_multi(
            tparams, wpack, torch.from_numpy(drafts[:, S:2 * S]).long(),
            P + S, cache, cross, DIMS_T)
    assert np.abs(wrong.numpy() - want[1]).max() / np.abs(want[1]).max() > tol


class _one_key_past:
    """Within the block, query s of the plain verify step attends over
    [vs, pos + s + 1] (the last query's extra key is its own stale lane)."""

    def __enter__(self):
        self.right = TW.multi_token_mask

        def shifted(group, n_draft, pos, vs, Tmax, minor, n_groups):
            m = self.right(group, n_draft, pos + 1, vs, Tmax, minor,
                           n_groups).clone()
            m[..., pos + n_draft:] = TW.NEG  # never past the block
            return m

        TW.multi_token_mask = shifted

    def __exit__(self, *exc):
        TW.multi_token_mask = self.right


def _step_inputs(S, self_int8, seed=0, T=20, prefix=6, windows=3):
    rng = np.random.default_rng(seed)
    tree = random_jax_tree(DIMS_J, seed=23)
    tp = TW.fuse_decoder_qkv(TW.params_from_jax(tree))
    wpack = DL.pack_layer_weights(tp["decoder"]["blocks"])
    L = DIMS_J.n_text_layer
    kv = np.zeros((L, windows, 2, H, T, 64), np.float32)
    kv[..., :prefix, :] = 0.5 * rng.standard_normal(
        (L, windows, 2, H, prefix, 64))
    kv = torch.from_numpy(kv)
    if self_int8:
        q8, sc = DL.quantize_heads(kv)
        cache = {"kv8": q8, "ksc": sc}
    else:
        cache = {"kv": kv}
    xa = torch.from_numpy(rng.standard_normal(
        (windows, DIMS_J.n_audio_ctx, 128)).astype(np.float32))
    cross = TW.precompute_cross_kv_int8(tp, xa, DIMS_T)
    x = torch.from_numpy(
        rng.standard_normal((windows * S, 128)).astype(np.float32))
    return tp, wpack, cache, cross, x


def _clone(c):
    return {k: v.clone() for k, v in c.items()}


@pytest.mark.parametrize("self_int8", [False, True])
@pytest.mark.parametrize("S,vs", [(2, 0), (4, 2), (5, 0)])
def test_plain_verify_equals_one_token_steps(S, vs, self_int8):
    """The plain verify step at pos against S consecutive one-token plain
    steps at pos .. pos + S - 1 (query s's x as the step's input): x, the
    appended lanes and the logits within 1e-5 of max |want| (the CPU's
    GEMM may sum R = windows x S rows in another order than R = windows;
    attention is computed query by query, as the one-token step does).
    The int8 lanes: the same values, or one step off where a value sits on
    a rounding boundary."""
    pos = 6
    tp, wpack, cache, cross, x = _step_inputs(S, self_int8, seed=S)
    c1 = _clone(cache)
    got = DL.fused_decoder_layers(x, wpack, c1, cross, vs, pos, H, queries=S)
    c2 = _clone(cache)
    xs = x.reshape(-1, S, 128)
    want = torch.stack([
        DL.fused_decoder_layers(xs[:, s].contiguous(), wpack, c2, cross, vs,
                                pos + s, H) for s in range(S)], dim=1)
    want = want.reshape(-1, 128)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    dec = tp["decoder"]
    lg_got, lg_want = TW.vocab_logits(dec, got), TW.vocab_logits(dec, want)
    assert (float((lg_got - lg_want).abs().max())
            <= 1e-5 * float(lg_want.abs().max()))
    lanes = slice(pos, pos + S)
    if self_int8:
        a = c1["kv8"][..., lanes, :].int()
        b = c2["kv8"][..., lanes, :].int()
        assert (a - b).abs().max() <= 1 and (a != b).float().mean() < 0.01
        torch.testing.assert_close(c1["ksc"][..., lanes],
                                   c2["ksc"][..., lanes], rtol=1e-5, atol=0)
    else:
        a, b = c1["kv"][..., lanes, :], c2["kv"][..., lanes, :]
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    # nothing else of the cache moved
    for k in c1:
        keep = torch.ones(c1[k].shape[4], dtype=torch.bool)
        keep[lanes] = False
        assert torch.equal(c1[k][:, :, :, :, keep], cache[k][:, :, :, :, keep])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("splits", [1, 3, 8, None])
@pytest.mark.parametrize("S,vs,pos", [(4, 0, 3), (4, 5, 6), (3, 0, 37),
                                      (8, 17, 26)])
def test_self_split_multi_matches_plain(int8, splits, S, vs, pos):
    """S queries a cache row, the split-softmax combine against the
    one-pass plain version, f32, within 1e-5 of max |want|. 40 keys: in 8
    splits of 5, pos 3 .. 6 (S 4) crosses from split 0 into 1, 6 .. 9 ends
    a split, 26 .. 33 spans two; in 3 splits of 14, 37 .. 39 end the
    cache. Each query's output equals the one-query call at its position
    (the same function), and the appended lanes are the plain version's."""
    from test_torch_decode_step import _self_case

    rng = np.random.default_rng(7 + S + pos)
    qkv, cache = _self_case(rng, 2 * S, 2, 40, 27, int8)
    cp = {k: v.clone() for k, v in cache.items()}
    cache = {k: v[::S].clone() for k, v in cache.items()}
    cp = {k: v[::S].clone() for k, v in cp.items()}
    got = DL.self_attn_split_plain(qkv, cache, pos, vs, 2, splits, queries=S)
    want = DL.self_attn_plain(qkv, cp, pos, vs, 2, queries=S)
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err < 1e-5
    for k in cache:
        assert torch.equal(cache[k], cp[k])
    # query s alone, one query a row, at pos + s, after the lanes before it
    for s in range(S):
        c1 = {k: v.clone() for k, v in cp.items()}
        one = DL.self_attn_plain(qkv[s::S].contiguous(), c1, pos + s, vs, 2)
        torch.testing.assert_close(one, want[s::S], rtol=0, atol=0)


@pytest.mark.parametrize("self_int8", [False, True])
def test_stale_lanes_are_rewritten(self_int8):
    """A verify at pos whose drafts are all rejected but the first, then a
    verify at pos + 1: lanes pos + 1 .. pos + 3 still hold the rejected
    drafts' K/V. The second verify gives the bits it gives over a cache
    whose lanes there were never written (zeros), and leaves the same
    cache up to pos + 4."""
    S, pos = 4, 6
    _, wpack, cache, cross, x = _step_inputs(S, self_int8, seed=11)
    stale = _clone(cache)
    DL.fused_decoder_layers(x, wpack, stale, cross, 0, pos, H, queries=S)
    fresh = _clone(stale)
    for k in fresh:
        fresh[k][:, :, :, :, pos + 1:] = 0
        assert not torch.equal(fresh[k], stale[k])
    x2 = x.flip(0).contiguous()
    a = DL.fused_decoder_layers(x2, wpack, stale, cross, 0, pos + 1, H,
                                queries=S)
    b = DL.fused_decoder_layers(x2, wpack, fresh, cross, 0, pos + 1, H,
                                queries=S)
    assert torch.equal(a, b)
    for k in fresh:
        assert torch.equal(stale[k][:, :, :, :, :pos + 1 + S],
                           fresh[k][:, :, :, :, :pos + 1 + S])


def _self_attn_before(qkv, cache_l, pos, vs, n_head):
    """The one-token plain self-attention as it stood before the verify
    mode (append at pos, attend over [vs, pos])."""
    R, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_head
    q, k, v = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
    new_kv = torch.stack([k.reshape(R, n_head, dh),
                          v.reshape(R, n_head, dh)], dim=1)
    ksc = None
    if "kv8" in cache_l:
        ckv, ksc = cache_l["kv8"], cache_l["ksc"]
        q8, sc = DL.quantize_heads(new_kv)
        ckv[:, :, :, pos] = q8
        ksc[:, :, :, pos] = sc
    else:
        ckv = cache_l["kv"]
        ckv[:, :, :, pos] = new_kv.to(ckv.dtype)
    qw = (q.float() * attn_scale(dh)).to(q.dtype).reshape(R, n_head, dh)
    t = torch.arange(ckv.shape[3])
    live = (t >= vs) & (t <= pos)
    lg = torch.einsum("rhd,rhtd->rht", qw.float(), ckv[:, 0].float())
    if ksc is not None:
        lg = lg * ksc[:, 0]
    pr = torch.softmax(torch.where(live, lg, float("-inf")), dim=-1)
    if ksc is not None:
        pr = pr * ksc[:, 1]
    att = torch.einsum("rht,rhtd->rhd", pr.to(qkv.dtype).float(),
                       ckv[:, 1].float())
    return att.reshape(R, d).to(qkv.dtype)


@pytest.mark.parametrize("self_int8", [False, True])
def test_one_query_step_is_unchanged(self_int8, monkeypatch):
    """queries=1 (every decode step) computes, bit for bit, what the plain
    layer stack computed before the verify mode: x and the whole cache,
    over three positions at valid_start 1."""
    _, wpack, cache, cross, x = _step_inputs(1, self_int8, seed=4)
    c_new, c_old = _clone(cache), _clone(cache)
    for pos in (6, 7, 8):
        a = DL.fused_decoder_layers_plain(x, wpack, c_new, cross, 1, pos, H)
        with monkeypatch.context() as m:
            m.setattr(DL, "self_attn_plain",
                      lambda qkv, c, p, vs, h, queries=1:
                      _self_attn_before(qkv, c, p, vs, h))
            b = DL.fused_decoder_layers_plain(x, wpack, c_old, cross, 1, pos,
                                              H)
        assert torch.equal(a, b)
        assert all(torch.equal(c_new[k], c_old[k]) for k in c_new)
        x = a


def test_verify_refuses_positions_past_the_cache():
    """pos + S - 1 must lie inside the cache, and R must split into cache
    rows of S queries."""
    _, wpack, cache, cross, x = _step_inputs(4, False, T=12)
    with pytest.raises(ValueError, match="exceed"):
        DL.fused_decoder_layers(x, wpack, cache, cross, 0, 9, H, queries=4)
    with pytest.raises(ValueError, match="split"):
        DL.fused_decoder_layers(x[:-1], wpack, cache, cross, 0, 2, H,
                                queries=4)
