"""The unfused decode step's device-side positions, the fused step's
``valid_start``, the plans of the split-KV int8 self-attention kernel and of
the multi-block beam tail, and the rule that a kernel launches on its
operands' card -- on the CPU.

``decoder_step`` takes ``pos`` / ``valid_start`` as ints or as 0-d device
tensors (the form a CUDA graph of the step replays); both forms give the
same bits, and both agree with the JAX package's ``decoder_step``. The
CUDA graphs themselves, and the kernels against their plans, are held on
the card (tests/test_torch_cuda.py, chip_smoke.py). Inputs are made with
numpy from a seed."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_util import random_jax_tree, to_jax
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu.ops.quant import quantize_model_params as jax_quantize
from whisper_aries_tpu_torch.decoding import generate as TG
from whisper_aries_tpu_torch.models import whisper as TW
from whisper_aries_tpu_torch.ops import beam_tail as BT
from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.ops import decode_layers as DL
from whisper_aries_tpu_torch.ops import self_attn as SA

CSRC = Path(TW.__file__).resolve().parents[1] / "csrc"
# d 128 = 2 heads x dh 64, 2 layers, 40 audio positions, vocab 96
DIMS_J = JW.WhisperDims(80, 40, 128, 2, 2, 96, 32, 128, 2, 2)
DIMS_T = TW.WhisperDims(*[getattr(DIMS_J, f) for f in
                          DIMS_J.__dataclass_fields__])
T = 12
# bf16 model and cache: the frameworks round bf16 products and sums in
# other places, ~0.027 measured on logits up to ~2.7 (one bf16 step of 2.7
# is 0.0156)
TOL_BF16 = 5e-2


@pytest.fixture(scope="module")
def model():
    tree = random_jax_tree(DIMS_J, seed=31, weight_std=0.08)
    rng = np.random.default_rng(32)
    xa = rng.standard_normal((2, 40, 128)).astype(np.float32)
    return tree, xa


def _prompt(vs):
    """Two rows of a 5-token prompt, the first ``vs`` positions left
    padding."""
    p = np.array([[7, 5, 9, 1, 4], [8, 7, 3, 3, 2]], np.int32)
    p[:, :vs] = -1
    return p


@pytest.mark.parametrize("vs", [0, 2])
@pytest.mark.parametrize("self_cache", ["int8", "bf16"])
def test_decoder_step_device_positions_equal_ints(model, self_cache, vs):
    """After the same prefill, three S = 1 steps with ``pos`` and
    ``valid_start`` as 0-d int32 tensors give the logits and the cache of
    the int steps bit for bit; both agree with the JAX package's
    decoder_step: the int8 self cache (f32 model) to 2e-3, a value on an
    int8 rounding boundary landing one step apart as in
    test_torch_whisper.py; the bf16 self cache (bf16 model, as the card
    runs it) to TOL_BF16, the two frameworks rounding bf16 products and
    sums in other places."""
    tree, xa = model
    int8 = self_cache == "int8"
    if not int8:
        tree = jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)
        xa = xa.astype(jnp.bfloat16)
    jp = JW.fuse_decoder_qkv(to_jax(tree))
    tp = TW.fuse_decoder_qkv(TW.params_from_jax(tree))
    cj = JW.precompute_cross_kv(jp, jnp.asarray(xa), DIMS_J)
    xa_t = TW.params_from_jax(np.asarray(xa))
    ct = TW.precompute_cross_kv(tp, xa_t, DIMS_T)
    prompt = _prompt(vs)
    cache_j = JW.init_kv_cache(DIMS_J, 2, dtype=jnp.asarray(xa).dtype,
                               max_len=T, int8=int8)
    cache_i = TW.init_kv_cache(DIMS_T, 2, dtype=xa_t.dtype, max_len=T,
                               int8=int8)
    vs_j = jnp.int32(vs)
    _, cache_j = JW.decoder_step(jp, jnp.asarray(prompt), jnp.int32(0),
                                 cache_j, cj, DIMS_J, valid_start=vs_j)
    TW.decoder_step(tp, torch.from_numpy(prompt).long(), 0, cache_i, ct,
                    DIMS_T, valid_start=vs)
    cache_d = {k: v.clone() for k, v in cache_i.items()}
    for pos in range(5, 8):
        tok = np.array([[pos + 10], [pos + 20]], np.int32)
        lj, cache_j = JW.decoder_step(jp, jnp.asarray(tok), jnp.int32(pos),
                                      cache_j, cj, DIMS_J, valid_start=vs_j)
        tok_t = torch.from_numpy(tok).long()
        li = TW.decoder_step(tp, tok_t, pos, cache_i, ct, DIMS_T,
                             valid_start=vs)
        ld = TW.decoder_step(tp, tok_t, torch.tensor(pos, dtype=torch.int32),
                             cache_d, ct, DIMS_T,
                             valid_start=torch.tensor(vs, dtype=torch.int32))
        assert torch.equal(li, ld), pos
        for k in cache_i:
            assert torch.equal(cache_i[k], cache_d[k]), (pos, k)
        np.testing.assert_allclose(ld.float().numpy(), np.asarray(lj),
                                   atol=2e-3 if int8 else TOL_BF16, rtol=0)


def test_step_logits_fused_valid_start_matches_jax(model):
    """The fused step (its kernels' plain version on CPU tensors) shifts
    the positional embedding by ``valid_start``, as the JAX package's
    decoder_step does: after a prompt left-padded by 2, four steps of
    ``_step_logits(fused=True, valid_start=2)`` match
    JW.decoder_step(..., valid_start=2) on the same int8 weights and int8
    cross K/V within 2e-2 (the fused layers round activations to bf16;
    ~6e-3 measured on logits up to ~2.7), while the embedding at the
    unshifted position moves them past 0.5 (~2 measured)."""
    tree, xa = model
    jq = jax_quantize(to_jax(tree))
    jp = JW.fuse_decoder_qkv(jq)
    tp = TW.fuse_decoder_qkv(TW.params_from_jax(jax.tree.map(np.asarray,
                                                            jq)))
    wpack = DL.pack_layer_weights(tp["decoder"]["blocks"])
    cj = JW.precompute_cross_kv_int8(jp, jnp.asarray(xa), DIMS_J)
    ct = TW.precompute_cross_kv_int8(tp, torch.from_numpy(xa), DIMS_T)
    vs = 2
    prompt = _prompt(vs)
    cache_j = JW.init_kv_cache(DIMS_J, 2, max_len=T)
    cache_t = TW.init_kv_cache(DIMS_T, 2, max_len=T)
    _, cache_j = JW.decoder_step(jp, jnp.asarray(prompt), jnp.int32(0),
                                 cache_j, cj, DIMS_J,
                                 valid_start=jnp.int32(vs))
    TW.decoder_step(tp, torch.from_numpy(prompt).long(), 0, cache_t, ct,
                    DIMS_T, valid_start=vs)
    worst = wrong = 0.0
    for pos in range(5, 9):
        tok = np.array([pos + 10, pos + 20], np.int32)
        lj, cache_j = JW.decoder_step(jp, jnp.asarray(tok[:, None]),
                                      jnp.int32(pos), cache_j, cj, DIMS_J,
                                      valid_start=jnp.int32(vs))
        lj = np.asarray(lj)[:, 0]
        tok_t = torch.from_numpy(tok).long()
        # the mistake: the embedding of position pos, not pos - vs
        x = tp["decoder"]["tok_emb"][tok_t] + tp["decoder"]["pos_emb"][pos]
        mis = TW.vocab_logits(tp["decoder"], DL.fused_decoder_layers(
            x, wpack, {k: v.clone() for k, v in cache_t.items()}, ct, vs,
            pos, DIMS_T.n_text_head)).numpy()
        got = TG._step_logits(tp, DIMS_T, tok_t, pos, cache_t, ct, True,
                              wpack, valid_start=vs).numpy()
        worst = max(worst, float(np.abs(got - lj).max()))
        wrong = max(wrong, float(np.abs(mis - lj).max()))
    assert worst < 2e-2 and wrong > 0.5, (worst, wrong)


def _c_constant(source, name):
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_self_attention_split_plan():
    """The Python mirror of csrc/self_attn.cu's plan: its constants are
    the source's; S splits of C keys cover T (the last ragged, none
    empty), C a multiple of 32 and at most 128, at most 8 splits, about 2
    blocks per SM (2 splits of 128 at the self_int8 slice's 6 rows x 20
    heads over 227 positions on 132 SMs); the plan never sees a position.
    The card test holds it equal to the C plan."""
    for name, value in (("BLOCKS_PER_SM", SA.BLOCKS_PER_SM),
                        ("MAX_SPLITS", SA.MAX_SPLITS),
                        ("MAX_KEYS", SA.MAX_KEYS)):
        assert _c_constant("self_attn.cu", name) == value
    assert SA.split_plan(227, 120, 132) == (2, 128)
    assert SA.split_plan(448, 20, 132) == (7, 64)
    assert SA.split_plan(448, 800, 132) == (4, 128)
    assert SA.split_plan(16, 6, 132) == (1, 32)
    for T in (1, 16, 33, 200, 227, 448, 1000):
        for pairs in (1, 6, 120, 160, 640, 5000):
            for sms in (16, 114, 132):
                S, C = SA.split_plan(T, pairs, sms)
                assert C % 32 == 0 and 1 <= S <= SA.MAX_SPLITS
                assert (S - 1) * C < T <= S * C
                assert C <= SA.MAX_KEYS


def test_beam_tail_chunk_plan():
    """The Python mirror of csrc/beam_tail.cu's plan: its constants are
    the source's; C chunks of W columns cover V (none empty), W a multiple
    of 4 and at most MAX_CHUNK, at most 8 chunks, about 2 blocks per SM
    (8 chunks of 6484 at 6 windows x 5 beams of large-v3's 51866 on 132
    SMs: 240 blocks). The card test holds it equal to the C plan."""
    for name, value in (("BLOCKS_PER_SM", BT.BLOCKS_PER_SM),
                        ("MAX_CHUNKS", BT.MAX_CHUNKS),
                        ("MAX_CHUNK", BT.MAX_CHUNK)):
        assert _c_constant("beam_tail.cu", name) == value
    assert BT.chunk_plan(51866, 30, 132) == (8, 6484)
    assert BT.chunk_plan(51866, 40, 132) == (7, 7412)
    assert BT.chunk_plan(1000, 15, 132) == (8, 128)
    for V in (7, 1000, 51865, 51866, 65536):
        for rows in (1, 5, 30, 40, 64, 400):
            for sms in (16, 132):
                C, W = BT.chunk_plan(V, rows, sms)
                assert W % 4 == 0 and 1 <= C <= BT.MAX_CHUNKS
                assert (C - 1) * W < V <= C * W and W <= BT.MAX_CHUNK


def test_stream_and_sm_count_read_the_operands_device(monkeypatch):
    """A wrapper's stream is the current stream of its operand's card, not
    of the current device: cb.stream hands torch.cuda.current_stream the
    device it is given (a tensor's, or a device)."""
    seen = []

    class FakeStream:
        cuda_stream = 1234

    def current_stream(device=None):
        seen.append(device)
        return FakeStream()

    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    assert cb.stream(torch.device("cuda:3")).value == 1234
    t = torch.zeros(2)
    cb.stream(t)
    assert seen == [torch.device("cuda:3"), t.device]
    with pytest.raises(TypeError):
        cb.stream()  # pylint: disable=no-value-for-parameter
    props = []
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: props.append(i) or type(
                            "P", (), {"multi_processor_count": 100 + i})())
    cb._sm_count.cache_clear()
    try:
        assert cb.sm_count(torch.device("cuda:2")) == 102
        assert props == [2]
    finally:
        cb._sm_count.cache_clear()


def test_step_graphs_are_card_only(model):
    """Off the card no step is captured: a decode on CPU state takes the
    host loop, and the loop graph and the unfused step graph refuse CPU
    operands."""
    from whisper_aries_tpu_torch.ops import decode_loop as DLP

    tree, xa = model
    tp = TW.fuse_decoder_qkv(TW.params_from_jax(tree))
    ct = TW.precompute_cross_kv(tp, torch.from_numpy(xa), DIMS_T)
    cache = TW.init_kv_cache(DIMS_T, 2, max_len=T, int8=True)
    pos = torch.zeros((), dtype=torch.int32)
    state = type("S", (), {"pos": pos})()
    picked = []
    TG._decode_loop(state, None, None, None, cache, 0, 0, TG._Reads(),
                    finished=torch.ones(2, dtype=torch.bool)) or picked.append(
        "host")
    assert picked == ["host"]
    with pytest.raises(ValueError, match="CUDA"):
        DLP.DeviceLoop(torch.device("cpu"), lambda: None, pos, T,
                       finished=torch.zeros(2, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        TW.UnfusedStepGraph(tp, cache, ct, DIMS_T, 2)
