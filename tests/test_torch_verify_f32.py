"""The speculative verify step at compute_type "f32" on the CPU, where the
port runs the plain version: f32 params, the f32 residual stream through
``decoder_step_fused_multi``, f32 logits.

  * against the JAX package's ``decoder_step_fused_multi`` at f32 (its
    Pallas megakernel in interpret mode, windows grouped in pairs), over
    two consecutive verify steps (the second reads lanes the first
    appended), at S 2 and S 8 (the kernel's most queries a cache row),
    after a left-padded prompt (valid_start > 0) and at valid_start 0,
    both self-cache dtypes (int8, and f32 where it is not int8);
  * ``bench_speculative.verify_traffic`` at the f32 activation width and
    with an f32 self cache.

tests/test_torch_verify_step.py holds S 3 and 4 at valid_start 0. Tiny
dims (d 128 = 2 heads of 64, 2 layers, 40 audio positions). The f32
kernels themselves are held on the card (test_torch_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401
from torch_port_util import random_jax_tree, to_jax
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.ops import pallas_decode_layers as JDL
from whisper_aries_tpu.ops.quant import quantize_model_params as jax_quantize
from whisper_aries_tpu_torch.decoding import generate as TG
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.ops import decode_layers as DL
from whisper_aries_tpu_torch.scripts import bench_speculative as BS

DIMS_J = JW.WhisperDims(80, 40, 128, 2, 2, 96, 32, 128, 2, 2)
DIMS_T = TW.WhisperDims(*[getattr(DIMS_J, f) for f in
                          DIMS_J.__dataclass_fields__])
H, B, P, GROUP = 2, 4, 4, 2
# the JAX runs: S drafted tokens a window, self-cache dtype (int8 or
# not), valid_start (2: the prompt's first two positions are left padding)
RUNS = [(2, False, 2), (2, True, 2), (8, False, 2), (8, True, 2),
        (8, False, 0)]


@pytest.fixture(scope="module")
def model():
    tree = random_jax_tree(DIMS_J, seed=27, weight_std=0.08)
    qtree = jax_quantize(to_jax(tree))
    jparams = JW.fuse_decoder_qkv(qtree)
    tparams = TW.fuse_decoder_qkv(
        TW.params_from_jax(jax.tree.map(np.asarray, qtree)))
    assert tparams["decoder"]["tok_emb"].dtype == torch.float32
    rng = np.random.default_rng(8)
    xa = rng.standard_normal((B, DIMS_J.n_audio_ctx, 128)).astype(np.float32)
    prompt = rng.integers(3, 90, (B, P)).astype(np.int32)
    drafts = rng.integers(3, 90, (B, 16)).astype(np.int32)
    return jparams, tparams, xa, prompt, drafts


def _max_len(S):
    return P + 2 * S + 2


def _padded(prompt, vs):
    """The prompt with its first ``vs`` positions left padding (-1)."""
    out = prompt.copy()
    out[:, :vs] = -1
    return out


def _prefill(model, vs):
    """The JAX package's prefill of the prompt at valid_start ``vs``
    (decoder_step, left padding -1): its cache {"k", "v"} (L, B, H, dh, P).
    Both frameworks' verify steps start from these values, so the test
    holds the verify step alone (an f32 prefill's products round their
    inputs to bf16 from sums taken in each framework's order, and on this
    seed one row of the left-padded prompt lands a bf16 step apart there:
    test_torch_decode_step.py holds the prefill)."""
    jparams, _, xa, prompt, _ = model
    cross_mega = JW.precompute_cross_kv_int8_packed(
        jparams, jnp.asarray(xa), DIMS_J)
    cache0 = JW.init_kv_cache(DIMS_J, B, dtype=jnp.float32, max_len=P)
    _, cache0 = JW.decoder_step(
        jparams, jnp.asarray(_padded(prompt, vs)), jnp.int32(0), cache0,
        JW.cross_views_from_packed(cross_mega, H, DIMS_J.n_audio_ctx),
        DIMS_J, valid_start=jnp.int32(vs))
    return cache0


def _torch_operands(model, cache0, S, self_int8):
    """The prefill's cache in the decoder-layer step's layout (an int8
    cache quantized as generate.py packs it, or the f32 one as it is), the
    port's int8 cross K/V and weight pack."""
    _, tparams, xa, _, _ = model
    cross = TW.precompute_cross_kv_int8(tparams, torch.from_numpy(xa),
                                        DIMS_T)
    cache = TW.init_kv_cache(DIMS_T, B, max_len=_max_len(S))
    for i, k in enumerate(("k", "v")):
        cache["kv"][:, :, i, :, :P] = torch.from_numpy(
            np.array(cache0[k])).transpose(-1, -2)
    cache = TG._pack_fused_cache(cache, self_int8)
    assert all(v.dtype in (torch.int8, torch.float32) for v in cache.values())
    wpack = DL.pack_layer_weights(tparams["decoder"]["blocks"])
    return cross, cache, wpack


@pytest.fixture(scope="module")
def jax_runs(model):
    """Each run of RUNS: the prefill's cache and the JAX logits of two
    consecutive verify steps at pos P and P + S (decoder_step_fused_multi
    at f32, interpret mode)."""
    jparams, _, xa, _, drafts = model
    cross_mega = JW.precompute_cross_kv_int8_packed(
        jparams, jnp.asarray(xa), DIMS_J)
    cross_g = JW.group_cross_mega(cross_mega, GROUP)
    wpack = JDL.pack_layer_weights(jparams["decoder"]["blocks"])
    out = {}
    for S, self_int8, vs in RUNS:
        cache0 = _prefill(model, vs)
        packed = JW.pack_greedy_prefill_cache(cache0, GROUP, _max_len(S),
                                              int8=self_int8, n_head=H)
        logits = []
        for i in range(2):
            lg, packed = JW.decoder_step_fused_multi(
                jparams, wpack, jnp.asarray(drafts[:, i * S:(i + 1) * S]),
                jnp.int32(P + i * S), packed, cross_g, DIMS_J, group=GROUP,
                valid_start=jnp.int32(vs), interpret=True)
            logits.append(np.asarray(lg))
        out[S, self_int8, vs] = cache0, logits
    return out


def _row_errs(got, want):
    """Each drafted position's max |got - want| over max |want|."""
    return np.abs(got - want).max(-1).ravel() / np.abs(want).max()


@pytest.mark.parametrize("S,self_int8,vs", RUNS)
def test_f32_verify_step_matches_jax(model, jax_runs, S, self_int8, vs):
    """Two consecutive f32 verify steps: the same argmax at every drafted
    position; logits within 1e-5 of max |want| at the median position and
    within 5e-3 at every one.

    The frameworks sum in other orders, so their f32 values differ in the
    last bits (the median position: ~3e-7 on this seed). The megakernel at
    f32 rounds every product's input to bf16 (LayerNorm outputs, the
    attentions' outputs, the MLP's hidden), and where an f32 value sits at
    a bf16 rounding midpoint the two land a step apart: that position's
    logits move by up to ~3e-3 of max |want| (2.2e-3 measured here, at 1
    to 14 of a run's 16 or 64 positions), and later queries of its window
    read its appended K/V. The limits sit far below a verify step whose
    drafted queries each see the key one past their own position (the
    neighbour's draft), held in the same test."""
    from test_torch_verify_step import _one_key_past

    tparams, drafts = model[1], model[4]
    cache0, want = jax_runs[S, self_int8, vs]
    cross, cache, wpack = _torch_operands(model, cache0, S, self_int8)
    tols = {"median": 1e-5, "max": 5e-3}
    errs = []
    for i in range(2):
        tok = torch.from_numpy(drafts[:, i * S:(i + 1) * S]).long()
        got, cache = TW.decoder_step_fused_multi(tparams, wpack, tok,
                                                 P + i * S, cache, cross,
                                                 DIMS_T, valid_start=vs)
        assert got.dtype == torch.float32 and got.shape == (B, S, 96)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      want[i].argmax(-1))
        errs.append(_row_errs(got.numpy(), want[i]))
    errs = np.concatenate(errs)
    assert np.median(errs) < tols["median"], np.median(errs)
    assert errs.max() < tols["max"], errs.max()
    cross, cache, wpack = _torch_operands(model, cache0, S, self_int8)
    TW.decoder_step_fused_multi(tparams, wpack,
                                torch.from_numpy(drafts[:, :S]).long(), P,
                                cache, cross, DIMS_T, valid_start=vs)
    with _one_key_past():
        wrong, _ = TW.decoder_step_fused_multi(
            tparams, wpack, torch.from_numpy(drafts[:, S:2 * S]).long(),
            P + S, cache, cross, DIMS_T, valid_start=vs)
    wrong = _row_errs(wrong.numpy(), want[1])
    assert np.median(wrong) > tols["median"] and wrong.max() > tols["max"]


@pytest.mark.parametrize("S,vs", [(1, 0), (4, 0), (8, 2)])
def test_verify_traffic_at_f32(S, vs):
    """bench_speculative.verify_traffic at the f32 residual stream: x in
    and out at 4 bytes an activation, and, where the self cache is not
    int8, its live lanes at 4 bytes a value with no scales; the operations
    do not depend on the dtype."""
    dims, Bw, pos = TW.PRESETS["large-v3"], 16, 128
    L, d, H = dims.n_text_layer, dims.n_text_state, dims.n_text_head
    lanes = L * Bw * 2 * H * (pos + S - vs)
    bf = BS.verify_traffic(dims, Bw, S, pos, vs)
    f32 = BS.verify_traffic(dims, Bw, S, pos, vs, act=4)
    f32c = BS.verify_traffic(dims, Bw, S, pos, vs, act=4, self_int8=False)
    assert f32["ops"] == bf["ops"] == f32c["ops"]
    assert f32["bytes"] - bf["bytes"] == 2 * Bw * S * d * 2
    assert f32c["bytes"] - f32["bytes"] == lanes * (64 * 4 - 68)
    bfc = BS.verify_traffic(dims, Bw, S, pos, vs, self_int8=False)
    assert bfc["bytes"] - bf["bytes"] == lanes * (64 * 2 - 68)
    assert BS.bound_ms(f32c) > BS.bound_ms(f32) > BS.bound_ms(bf)


@pytest.mark.parametrize("flag", ["bf16", "f32"])
def test_bench_speculative_cpu_rehearsal_names_compute_type(flag, capsys):
    """``--compute-type`` sets the card's model dtype; the CPU rehearsal's
    model is f32 whichever is asked, and its line says so. No sweep runs
    off the card."""
    out = BS.main(["--device", "cpu", "--compute-type", flag])
    assert out["bench"]["compute_type"] == "f32"
    assert "sweep" not in out
    assert out["bench"]["verified_tokens_per_s_spec"] > 0
    assert '"compute_type": "f32"' in capsys.readouterr().out
