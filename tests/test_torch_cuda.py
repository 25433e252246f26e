"""Card-only tests: each CUDA kernel of the PyTorch port against its plain
version at small shapes, on an NVIDIA card. Marked ``cuda``; without a
card they skip (the decision is made in a fixture, at run time). Run them
on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The full-size checks at the main path's shapes are chip_smoke.py's."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    """max |a - b| / max |b|."""
    return float((a.float() - b.float()).abs().max()) / float(
        b.float().abs().max())


def _mean_rel(a, b, base=None):
    """mean |a - b| / mean |b - base|."""
    ref = b.float() if base is None else b.float() - base.float()
    return float((a.float() - b.float()).abs().mean()) / float(
        ref.abs().mean())


def _steps(a, b):
    """(largest |a - b| in bf16 steps of b, share of elements that differ):
    a kernel summing in another order than the plain version (cuBLAS, torch
    reductions), then rounding to bf16, is one step off where the f32 sum
    sat near a rounding midpoint."""
    w = b.float()
    d = (a.float() - w).abs()
    step = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
    return float((d / step).max()), float((d > 0).float().mean())


def _bf16_close(a, b):
    steps, share = _steps(a, b)
    return steps <= 1 and share < 2e-2


def test_mel_kernel(dev):
    from whisper_aries_tpu_torch.audio.mel import log_mel_spectrogram
    from whisper_aries_tpu_torch.ops import mel as M

    rng = np.random.default_rng(0)
    t = np.arange(480000) / 16000
    audio = np.stack([0.3 * np.sin(2 * np.pi * 440 * t) * np.sin(t)
                      + 0.05 * rng.standard_normal(480000)] * 2)
    a = torch.as_tensor(audio, dtype=torch.float32, device=dev)
    n = M.mel_power_kernel.launches
    got, want = M.log_mel(a, 80), log_mel_spectrogram(a, 80)
    assert M.mel_power_kernel.launches == n + 1
    diff = (got - want).abs()
    assert float(diff.max()) < 5e-4 and float(diff.mean()) < 5e-6


def test_mel_kernel_ragged_clip_at_128_mels(dev):
    """128 mels over clips of 48123 samples: 300 frames (the last tile of
    8 holds 4), both padded edges read by reflected indices, the spans
    between them copied as 16-byte words."""
    from whisper_aries_tpu_torch.audio.mel import log_mel_spectrogram
    from whisper_aries_tpu_torch.ops import mel as M

    rng = np.random.default_rng(1)
    audio = rng.standard_normal((3, 48123)) * np.linspace(0.01, 1, 48123)
    a = torch.as_tensor(audio, dtype=torch.float32, device=dev)
    got, want = M.log_mel(a, 128), log_mel_spectrogram(a, 128)
    assert got.shape == want.shape == (3, 128, 300)
    diff = (got - want).abs()
    assert float(diff.max()) < 5e-4 and float(diff.mean()) < 5e-6


@pytest.mark.parametrize("shape", [(1, 2, 200, 64), (2, 3, 1500, 64)])
def test_encoder_attention_kernel(dev, shape):
    from whisper_aries_tpu_torch.models import whisper as W

    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    # unit q: near-flat softmax rows, where scored pad keys would show;
    # q x 4: peaked rows, where a dropped tail tile or a wrong scale would
    for q_scale in (1, 4):
        qs = (q.float() * q_scale).to(torch.bfloat16)
        got = W.encoder_attention(qs, k, v)
        want = W.attention_plain(qs, k, v)
        # bf16 outputs of differently ordered f32 sums: one step apart in
        # many elements (mean ~2e-3); scored pad keys or a dropped tail
        # tile move the mean by > 1.4e-2
        assert _rel(got, want) < 1e-2 and _mean_rel(got, want) < 5e-3


def _next_head_keys(t, pad):
    """(B, H, T, dh) -> (B, H, T + pad, dh): each head followed by the next
    head's first ``pad`` rows (flattened over B H, wrapping at the end) --
    what a 2D (B H T, 64) map would read past a head's last key."""
    B, H, T, dh = t.shape
    flat = t.reshape(B * H, T, dh)
    nxt = torch.roll(flat, -1, 0)[:, :pad]
    return torch.cat([flat, nxt], 1).reshape(B, H, T + pad, dh)


def test_encoder_attention_kernel_head_boundary(dev):
    """T 200 is no multiple of the 128-key tile: the last tile's 56 rows
    past T belong to the next head in memory. With each head's first 56
    keys made large, scoring them there (the next head's keys) moves the
    output far past the limit; the kernel stays within it. Three fresh
    inputs."""
    from whisper_aries_tpu_torch.models import whisper as W

    B, H, T, dh = 2, 3, 200, 64
    pad = -T % 128
    for rep in range(3):
        g = torch.Generator(device=dev).manual_seed(100 + rep)
        q, k, v = (torch.randn((B, H, T, dh), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        k[:, :, :pad] *= 4
        n = W.encoder_attention_kernel.launches
        got = W.encoder_attention(q, k, v)
        assert W.encoder_attention_kernel.launches == n + 1
        want = W.attention_plain(q, k, v)
        wrong = W.attention_plain(q, _next_head_keys(k, pad),
                                  _next_head_keys(v, pad))
        assert _rel(got, want) < 1e-2 and _mean_rel(got, want) < 5e-3
        assert _rel(wrong, want) > 1e-2 and _mean_rel(wrong, want) > 5e-3


@pytest.fixture(scope="module")
def small(dev):
    """d 128 (2 heads x dh 64), ff 512, 2 layers, Ta 96, T 16."""
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    dims = W.WhisperDims(80, 96, 128, 2, 2, 512, 64, 128, 2, 2)
    params = W.fuse_decoder_qkv(W.init_params(dims, seed=3, device=dev,
                                              dtype=torch.bfloat16))
    wpack = DL.pack_layer_weights(params["decoder"]["blocks"])
    g = torch.Generator(device=dev).manual_seed(1)
    wpack["vecs"][:, :1280] += 0.05 * torch.randn(
        (2, 1280), generator=g, device=dev)
    return dims, params, wpack, g


@pytest.mark.parametrize("R", [3, 20, 70])
def test_decoder_layer_parts(small, R):
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    dims, params, wpack, g = small
    dev = wpack["wq8"].device
    offs, _ = DL.vec_offsets(128, 512)
    vec = wpack["vecs"][0]
    seg = lambda i: vec[int(offs[i]):int(offs[i + 1])].contiguous()
    x = torch.randn((R, 128), generator=g, device=dev).to(torch.bfloat16)
    # every part within one bf16 step, in a small share of elements
    assert _bf16_close(DL.layer_norm_kernel(x, seg(0), seg(1)),
                       DL.layer_norm_plain(x, seg(0), seg(1)))
    w = wpack["wq8"][0][:, :384]
    assert _bf16_close(DL.w8a16_gemm_kernel(x, w, seg(12), seg(2)),
                       DL.w8a16_gemm_plain(x, w, seg(12), seg(2)).to(
                           torch.bfloat16))
    w1 = wpack["wf18"][0]
    assert _bf16_close(
        DL.w8a16_gemm_kernel(x, w1, seg(16), seg(10), DL.EPI_GELU),
        DL.gelu_as(DL.w8a16_gemm_plain(x, w1, seg(16), seg(10))).to(
            torch.bfloat16))
    h1 = torch.randn((R, 512), generator=g, device=dev).to(torch.bfloat16)
    w2 = wpack["wf28"][0]
    res = (0.01 * x.float()).to(torch.bfloat16)  # the product dominates
    want = res + DL.w8a16_gemm_plain(h1, w2, seg(17), seg(11)).to(
        torch.bfloat16)
    got = DL.w8a16_gemm_kernel(h1, w2, seg(17), seg(11), DL.EPI_RESIDUAL,
                               out=res.clone())
    assert _bf16_close(got, want)
    qkv = torch.randn((R, 384), generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn((R, 2, 2, 16, 64), generator=g, device=dev).to(
        torch.bfloat16)
    q8, sc = DL.quantize_heads(kv)
    for cache in ({"kv": kv}, {"kv8": q8, "ksc": sc}):
        ck = {k: v.clone() for k, v in cache.items()}
        cp = {k: v.clone() for k, v in cache.items()}
        got = DL.self_attn_kernel(qkv, ck, 9, 2, 2)
        want = DL.self_attn_plain(qkv, cp, 9, 2, 2)
        assert _bf16_close(got, want)
        for k in ck:
            assert torch.equal(ck[k], cp[k])
    xa = torch.randn((R, 96, 128), generator=g, device=dev).to(torch.bfloat16)
    cross = W.precompute_cross_kv_int8(params, xa, dims)
    assert _bf16_close(
        _step_cross_kernel(x, cross["kv8"][0], cross["sc"][0], 2),
        DL.cross_attn_plain(x, cross["kv8"][0], cross["sc"][0], 2))


def _step_cross_kernel(cq, kv8_l, sc_l, H):
    """The decode step's cross-attention (bf16 out, rows window-major over
    one layer's packed (Bw, 2, H, Ta, 64) cross K/V) through the grouped
    kernel's entry."""
    from whisper_aries_tpu_torch.ops import cross_attn as XA

    R, d = cq.shape
    Bw = kv8_l.shape[0]
    heads = lambda t: t.view(Bw, R // Bw, H, d // H).transpose(1, 2)
    att = torch.empty_like(cq)
    XA.cross_attention_q8_kernel(heads(cq), kv8_l[:, 0], sc_l[:, 0],
                                 kv8_l[:, 1], sc_l[:, 1], out=heads(att))
    return att


@pytest.mark.parametrize("self_int8", [False, True])
def test_decoder_layers_stack(small, self_int8):
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    dims, params, wpack, g = small
    dev = wpack["wq8"].device
    R = 4
    xa = torch.randn((R, 96, 128), generator=g, device=dev).to(torch.bfloat16)
    cross = W.precompute_cross_kv_int8(params, xa, dims)
    kv = torch.zeros((2, R, 2, 2, 16, 64), dtype=torch.bfloat16, device=dev)
    kv[..., :3, :] = torch.randn((2, R, 2, 2, 3, 64), generator=g,
                                 device=dev).to(torch.bfloat16)
    if self_int8:
        q8, sc = DL.quantize_heads(kv)
        cache = {"kv8": q8, "ksc": sc}
    else:
        cache = {"kv": kv}
    ck = {k: v.clone() for k, v in cache.items()}
    cp = {k: v.clone() for k, v in cache.items()}
    n = DL.fused_decoder_layers.launches
    for pos in (3, 4, 5):
        x = torch.randn((R, 128), generator=g, device=dev).to(torch.bfloat16)
        got = DL.fused_decoder_layers(x, wpack, ck, cross, 1, pos, 2)
        want = DL.fused_decoder_layers_plain(x, wpack, cp, cross, 1, pos, 2)
        # one-step bf16 flips at rounding midpoints cascade through the
        # layers: a step or two at the largest |x|, on average far under
        # the layers' update
        assert _rel(got, want) < 3e-2
        assert _mean_rel(got, want, x) < 1e-2
    assert DL.fused_decoder_layers.launches == n + 3
    key = "kv8" if self_int8 else "kv"
    a, b = ck[key][..., 3:6, :], cp[key][..., 3:6, :]
    assert float((a != b).float().mean()) < 5e-3
    if self_int8:
        assert int((a.int() - b.int()).abs().max()) <= 1
    else:
        assert _rel(a, b) < 8e-3


def test_engine_runs_the_kernels(dev, tmp_path):
    """A tiny engine on the card goes through all three kernels."""
    from whisper_aries_tpu_torch.audio.decode import write_wav
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import decode_layers as DL
    from whisper_aries_tpu_torch.ops import mel as M
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    dims = W.WhisperDims(80, 1500, 128, 2, 2, 51866, 448, 128, 2, 2)
    eng = AriesTranscriber("tiny-card", _params=W.init_params(dims, seed=0),
                           _dims=dims)
    assert eng.fused and eng.self_kv_int8
    t = np.arange(16000 * 40) / 16000
    x = 0.3 * np.sin(2 * np.pi * 200 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
    path = str(tmp_path / "a.wav")
    write_wav(path, x.astype(np.float32))
    counters = (M.mel_power_kernel, W.encoder_attention_kernel,
                DL.fused_decoder_layers)
    before = [c.launches for c in counters]
    res = eng.transcribe_file(path, temperature=(0.0,), max_new_tokens=8)
    assert res["num_windows"] >= 1
    assert all(c.launches > b for c, b in zip(counters, before))


# ---------------------------------------------------------------------------
# the beam path's kernels: grouped int8 cross-attention, beam tail, reorder
# ---------------------------------------------------------------------------


def _hold_grouped_cross(dev, B, H, G, T, qdtype):
    """G queries per window over shared int8 K/V, as views of the packed
    (B, 2, H, T, 64) cross layout. f32 output, sums in another order than
    the plain version's: within 1e-5 of max |want|; the last 28 keys
    dropped move it by far more."""
    from whisper_aries_tpu_torch.ops import cross_attn as XA

    g = torch.Generator(device=dev).manual_seed(G)
    kv = torch.randn((B, 2, H, T, 64), generator=g, device=dev)
    kv8, sc = XA.quantize_kv_per_position(kv)
    sc[:, 0] /= 8.0
    q = (4 * torch.randn((B, G, H, 64), generator=g, device=dev)).to(
        qdtype).transpose(1, 2)  # strided, as the model hands it over
    args = (kv8[:, 0], sc[:, 0], kv8[:, 1], sc[:, 1])
    n = XA.cross_attention_q8_kernel.launches
    got = XA.cross_attention_q8(q, *args)
    assert XA.cross_attention_q8_kernel.launches == n + 1
    want = XA.cross_attention_q8_reference(q, *args)
    assert _rel(got, want) < 1e-5
    if T > 28:
        cut = [a[:, :, :T - 28] for a in args]
        wrong = XA.cross_attention_q8_reference(q, *cut)
        assert _rel(wrong, want) > 1e-3


@pytest.mark.parametrize("G,T,qdtype", [(1, 40, torch.float32),
                                        (5, 1500, torch.float32),
                                        (5, 1500, torch.bfloat16),
                                        (12, 97, torch.float32),
                                        (20, 300, torch.bfloat16),
                                        (3, 1500, torch.bfloat16),
                                        (15, 1500, torch.bfloat16),
                                        (15, 1500, torch.float32),
                                        (20, 1500, torch.float32)])
def test_grouped_cross_attention_kernel(dev, G, T, qdtype):
    """3 windows x 2 heads: G up to 8 runs the block-wide kernel (one
    chunk of G queries; bf16 q: tensor-core logits, f32 q: f32 FMAs), 12
    and 15 the per-warp kernel in one chunk of 16, 20 in chunks of 16 and
    4 (f32 q: three exact bf16 parts); the keys are cut into the plan's
    splits (8 of 192 at T 1500 on an H100, 4 of 32 at T 97, 2 of 32 at
    T 40)."""
    _hold_grouped_cross(dev, 3, 2, G, T, qdtype)


@pytest.mark.parametrize("Bw,G", [(6, 3), (6, 15), (8, 5)])
def test_grouped_cross_attention_split_plan(dev, Bw, G):
    """The kernel runs the decode step's split plan (its C plan equals the
    Python mirror ``cross_split``): at the prefills' shapes over large-v3's
    1500 keys (6 windows x 20 heads: 3 splits of 512 on an H100, 2 of 768
    at G 15; 8 x 20: 2 of 768) it equals the plain version within 1e-5 of
    max |want|,
    twice with the same bits, while dropping the last split's P . V moves
    it by far more."""
    from whisper_aries_tpu_torch.ops import cross_attn as XA
    from whisper_aries_tpu_torch.ops import cuda_build as cb
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    sms = cb.sm_count(dev)
    S, C = DL.cross_split(1500, Bw * 20, G, sms)
    assert DL.kernel_cross_split(1500, Bw * 20, G, sms) == (S, C)
    g = torch.Generator(device=dev).manual_seed(Bw * G)
    kv = torch.randn((Bw, 2, 20, 1500, 64), generator=g, device=dev)
    kv8, sc = XA.quantize_kv_per_position(kv)
    sc[:, 0] /= 8.0
    q = (4 * torch.randn((Bw, G, 20, 64), generator=g, device=dev)).to(
        torch.bfloat16).transpose(1, 2)
    args = (kv8[:, 0], sc[:, 0], kv8[:, 1], sc[:, 1])
    got = XA.cross_attention_q8_kernel(q, *args)
    again = XA.cross_attention_q8_kernel(q, *args)
    want = XA.cross_attention_q8_reference(q, *args)
    wrong = XA.cross_attention_q8_split_plain(q, *args, S, C, drop=S - 1)
    assert S > 1 and _rel(got, want) < 1e-5 and _rel(wrong, want) > 1e-3
    assert torch.equal(got, again)


def test_grouped_cross_attention_in_the_step(small):
    """The decode step's cross-attention (bf16 out) at G = 5 rows per
    window over Bw = 2 windows, and the whole step against its plain
    version on grouped rows."""
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    dims, params, wpack, g = small
    dev = wpack["wq8"].device
    Bw, G = 2, 5
    R = Bw * G
    xa = torch.randn((Bw, 96, 128), generator=g, device=dev).to(torch.bfloat16)
    cross = W.precompute_cross_kv_int8(params, xa, dims)
    cq = torch.randn((R, 128), generator=g, device=dev).to(torch.bfloat16)
    assert _bf16_close(
        _step_cross_kernel(cq, cross["kv8"][0], cross["sc"][0], 2),
        DL.cross_attn_plain(cq, cross["kv8"][0], cross["sc"][0], 2))
    kv = torch.zeros((2, R, 2, 2, 16, 64), dtype=torch.bfloat16, device=dev)
    kv[..., :3, :] = torch.randn((2, R, 2, 2, 3, 64), generator=g,
                                 device=dev).to(torch.bfloat16)
    q8, sc = DL.quantize_heads(kv)
    ck = {"kv8": q8.clone(), "ksc": sc.clone()}
    cp = {"kv8": q8.clone(), "ksc": sc.clone()}
    x = torch.randn((R, 128), generator=g, device=dev).to(torch.bfloat16)
    got = DL.fused_decoder_layers(x, wpack, ck, cross, 0, 3, 2)
    want = DL.fused_decoder_layers_plain(x, wpack, cp, cross, 0, 3, 2)
    assert _rel(got, want) < 3e-2 and _mean_rel(got, want, x) < 1e-2


# ---------------------------------------------------------------------------
# the decode step's rebuilt parts: the one-launch cluster split-K GEMM, the
# split-KV attention, the step replayed as a CUDA graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,N", [(128, 384), (1280, 1280), (512, 128)])
@pytest.mark.parametrize("R", [1, 6, 17, 40, 64, 70])
def test_step_gemm_every_epilogue(dev, K, N, R):
    """The W8A16 GEMM at each epilogue against its plain version (cuBLAS
    sums in another order): bf16 outputs a step apart in under 2% of the
    elements and within 2^-7 of max |want| (a residual sum that cancels to
    near 0 is many of its own steps off, so not held in steps);
    (1280, 1280) runs 5 K slices of 4 ring stages as one cluster,
    (512, 128) 8 slices of one stage; 70 rows take two passes. One launch
    each, and two calls give the same bits."""
    from whisper_aries_tpu_torch.ops import decode_layers as DL
    from whisper_aries_tpu_torch.ops.quant import quantize_int8

    g = torch.Generator(device=dev).manual_seed(R + K)
    x = torch.randn((R, K), generator=g, device=dev).to(torch.bfloat16)
    w8, s = quantize_int8(0.05 * torch.randn((K, N), generator=g, device=dev))
    b = 0.1 * torch.randn((N,), generator=g, device=dev)
    y = DL.w8a16_gemm_plain(x, w8, s, b)
    res = (0.01 * torch.randn((R, N), generator=g, device=dev)).to(
        torch.bfloat16)
    cases = {DL.EPI_STORE: (None, y.to(torch.bfloat16)),
             DL.EPI_GELU: (None, DL.gelu_as(y).to(torch.bfloat16)),
             DL.EPI_RESIDUAL: (res, res + y.to(torch.bfloat16))}
    for mode, (out, want) in cases.items():
        n = DL.w8a16_gemm_kernel.launches
        got = DL.w8a16_gemm_kernel(x, w8, s, b, mode,
                                   None if out is None else out.clone())
        again = DL.w8a16_gemm_kernel(x, w8, s, b, mode,
                                     None if out is None else out.clone())
        assert DL.w8a16_gemm_kernel.launches == n + 2
        share = _steps(got, want)[1]
        assert share < 2e-2 and _rel(got, want) < 2 ** -7, (mode, share)
        assert torch.equal(got, again)


def test_step_plans_equal_their_python_mirrors(dev):
    """The C grid plans are the ones the CPU tests hold in Python."""
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    for sms in (132, 114, 16):
        for K, N in ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280),
                     (128, 384), (512, 128)):
            assert DL.kernel_gemm_plan(K, N, sms) == DL.gemm_plan(K, N, sms)[0]
        for pairs in (2, 120, 160, 640):
            for Ta in (40, 97, 1500):
                for G in (1, 5, 15):
                    assert (DL.kernel_cross_split(Ta, pairs, G, sms)
                            == DL.cross_split(Ta, pairs, G, sms))
    for T in (1, 16, 33, 200, 227, 448, 2048):
        assert DL.kernel_attn_split(T) == DL.attn_split(T)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("T,vs,pos", [(16, 2, 9), (200, 0, 150),
                                      (200, 100, 150), (227, 0, 226),
                                      (97, 64, 64)])
def test_split_self_attention(dev, int8, T, vs, pos):
    """Split-KV self-attention with append against its plain version:
    T 200 runs 7 splits of 32 (valid_start 100 leaves splits 0-2 and 5-6
    without a live key), T 227 8 with a ragged last one holding pos, T 97
    a lone live key; the appended cache is the plain version's bit for
    bit."""
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    g = torch.Generator(device=dev).manual_seed(T + pos)
    R, H = 5, 3
    qkv = torch.randn((R, 3 * 64 * H), generator=g, device=dev).to(
        torch.bfloat16)
    kv = torch.zeros((R, 2, H, T, 64), dtype=torch.bfloat16, device=dev)
    kv[..., :pos, :] = torch.randn((R, 2, H, pos, 64), generator=g,
                                   device=dev).to(torch.bfloat16)
    if int8:
        q8, sc = DL.quantize_heads(kv)
        cache = {"kv8": q8, "ksc": sc}
    else:
        cache = {"kv": kv}
    ck = {k: v.clone() for k, v in cache.items()}
    cp = {k: v.clone() for k, v in cache.items()}
    got = DL.self_attn_kernel(qkv, ck, pos, vs, H)
    want = DL.self_attn_plain(qkv, cp, pos, vs, H)
    assert torch.isfinite(got.float()).all()
    assert _bf16_close(got, want)
    for k in ck:
        assert torch.equal(ck[k], cp[k])


@pytest.mark.parametrize("Bw,G,Ta", [(3, 1, 1500), (2, 5, 1500), (2, 3, 97),
                                     (1, 12, 300)])
def test_split_cross_attention(dev, Bw, G, Ta):
    """Split-KV int8 cross-attention (bf16 out) against its plain version:
    1500 keys in 8 splits of 192 (ragged last), 97 in 4 of 32, G 12 in two
    chunks of 8 queries; the last 28 keys dropped must move it further."""
    from whisper_aries_tpu_torch.ops import cross_attn as XA
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    g = torch.Generator(device=dev).manual_seed(Ta + G)
    H = 2
    kv = torch.randn((Bw, 2, H, Ta, 64), generator=g, device=dev)
    kv8, sc = XA.quantize_kv_per_position(kv)
    sc[:, 0] /= 8.0
    cq = (2 * torch.randn((Bw * G, 64 * H), generator=g, device=dev)).to(
        torch.bfloat16)
    n = DL.cross_attn_kernel.launches
    got = DL.cross_attn_kernel(cq, kv8, sc, H)
    assert DL.cross_attn_kernel.launches == n + 1
    want = DL.cross_attn_plain(cq, kv8, sc, H)
    assert _bf16_close(got, want)
    cut = kv8.clone()
    cut[..., Ta - 28:, :] = 0
    wrong = DL.cross_attn_plain(cq, cut, sc, H)
    assert _steps(wrong, want)[1] > 2e-2


def test_step_graph_replay_equals_direct_launch(small):
    """The step replayed from one CUDA graph equals direct launches bit for
    bit over several positions, including after an in-place beam reorder
    of the cache; two direct runs are bitwise equal too."""
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import beam_reorder as BR
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    dims, params, wpack, g = small
    dev = wpack["wq8"].device
    Bw, K = 2, 3
    R = Bw * K
    xa = torch.randn((Bw, 96, 128), generator=g, device=dev).to(torch.bfloat16)
    cross = W.precompute_cross_kv_int8(params, xa, dims)
    kv = torch.zeros((2, R, 2, 2, 40, 64), dtype=torch.bfloat16, device=dev)
    kv[..., :3, :] = torch.randn((2, R, 2, 2, 3, 64), generator=g,
                                 device=dev).to(torch.bfloat16)
    q8, sc = DL.quantize_heads(kv)
    graph_cache = {"kv8": q8.clone(), "ksc": sc.clone()}
    direct_cache = {"kv8": q8.clone(), "ksc": sc.clone()}
    graph = DL.DecodeStepGraph(wpack, graph_cache, cross, R, 2)
    replays = DL.fused_decoder_layers.graph_replays
    src = torch.tensor([[1, 0, 2], [0, 0, 1]], dtype=torch.int32, device=dev)
    for pos in range(3, 9):
        x = torch.randn((R, 128), generator=g, device=dev).to(torch.bfloat16)
        a = graph.run(x, pos).clone()
        b = DL.fused_decoder_layers(x, wpack, direct_cache, cross, 0, pos, 2)
        assert torch.equal(a, b), pos
        for k in graph_cache:
            assert torch.equal(graph_cache[k], direct_cache[k])
        if pos == 5:
            BR.permute_cache_rows(graph_cache, src)
            BR.permute_cache_rows(direct_cache, src)
    assert DL.fused_decoder_layers.graph_replays == replays + 6
    c1 = {k: v.clone() for k, v in direct_cache.items()}
    c2 = {k: v.clone() for k, v in direct_cache.items()}
    x = torch.randn((R, 128), generator=g, device=dev).to(torch.bfloat16)
    assert torch.equal(DL.fused_decoder_layers(x, wpack, c1, cross, 0, 9, 2),
                       DL.fused_decoder_layers(x, wpack, c2, cross, 0, 9, 2))


def _verify_case(small, S, int8, T=64, Bw=3):
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    dims, params, wpack, g = small
    dev = wpack["wq8"].device
    xa = torch.randn((Bw, 96, 128), generator=g, device=dev).to(torch.bfloat16)
    cross = W.precompute_cross_kv_int8(params, xa, dims)
    kv = torch.randn((2, Bw, 2, 2, T, 64), generator=g, device=dev).to(
        torch.bfloat16)  # every lane written: stale drafts past pos too
    if int8:
        q8, sc = DL.quantize_heads(kv)
        cache = {"kv8": q8, "ksc": sc}
    else:
        cache = {"kv": kv}
    x = torch.randn((Bw * S, 128), generator=g, device=dev).to(torch.bfloat16)
    return wpack, cross, cache, x


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("pos,vs", [(3, 0), (4, 2), (30, 0), (29, 5)])
@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
def test_verify_step_kernel(small, S, pos, vs, int8):
    """The verify step (S drafted queries a cache row, one launch a part)
    on 3 windows over a 64-position self cache (2 splits of 32): pos 3 /
    4 keep the drafted block in split 0, 30 / 29 cross into split 1; every
    lane past pos holds a stale value. Against its plain version (as the
    stack test); bit for bit against S one-token steps at pos .. pos + S -
    1 (x of each query, the whole cache); a graph replay equals a direct
    launch bit for bit."""
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    wpack, cross, cache, x = _verify_case(small, S, int8)
    H, Bw = 2, 3
    ck, cp, c1 = (_clone(cache) for _ in range(3))
    n = DL.VERIFY.launches
    got = DL.fused_decoder_layers(x, wpack, ck, cross, vs, pos, H, queries=S)
    assert DL.VERIFY.launches == n + (S > 1)
    want = DL.fused_decoder_layers_plain(x, wpack, cp, cross, vs, pos, H,
                                         queries=S)
    assert _rel(got, want) < 3e-2
    assert _mean_rel(got, want, x) < 1e-2
    xs = x.view(Bw, S, 128)
    one = torch.stack([DL.fused_decoder_layers(
        xs[:, s].contiguous(), wpack, c1, cross, vs, pos + s, H)
        for s in range(S)], dim=1).view(Bw * S, 128)
    assert torch.equal(got, one)
    for k in ck:
        assert torch.equal(ck[k], c1[k]), k
    cg_, cd = _clone(cache), _clone(cache)
    graph = DL.DecodeStepGraph(wpack, cg_, cross, Bw * S, H, vs, queries=S)
    for p in (pos, pos + 1):
        a = graph.run(x, p).clone()
        b = DL.fused_decoder_layers(x, wpack, cd, cross, vs, p, H, queries=S)
        assert torch.equal(a, b)
        assert all(torch.equal(cg_[k], cd[k]) for k in cd)


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def test_greedy_decode_replays_every_step(small):
    """A fused greedy decode on the card replays its graph on every step
    after the prefill's."""
    from whisper_aries_tpu_torch.decoding import generate as G
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    dims, params, wpack, g = small
    dev = wpack["wq8"].device
    xa = torch.randn((2, 96, 128), generator=g, device=dev).to(torch.bfloat16)
    ids = G.DecodeSpecialIds(eot=511, sot=500, no_speech=510,
                             no_timestamps=509, timestamp_begin=512, blank=1,
                             n_vocab=512)
    prompt = torch.full((2, 1), 500, dtype=torch.long, device=dev)
    n = DL.fused_decoder_layers.graph_replays
    out = G.greedy_decode(params, xa, prompt, dims, ids,
                          torch.zeros(512, device=dev), 0, 0.0,
                          sample_len=8, with_timestamps=False, kv_int8=True,
                          self_kv_int8=True, fused=True, wpack=wpack)
    assert DL.fused_decoder_layers.graph_replays - n == int(out["steps"]) - 1


F32_MIN = float(np.finfo(np.float32).min)  # the masked logit


def _tail_inputs(dev, B, K, V, tsb, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = 3 * torch.randn((B * K, V), generator=g, device=dev)
    sum_lp = 2 * torch.randn((B, K), generator=g, device=dev)
    sum_lp[torch.rand((B, K), generator=g, device=dev) < 0.2] = F32_MIN
    pick = lambda vals: torch.as_tensor(vals, device=dev)[
        torch.randint(0, len(vals), (B, K), generator=g, device=dev)]
    last = pick([100, 221, tsb + 3, tsb + 40])
    pen = pick([-1, 50, tsb + 2, tsb + 39])
    mts = pick([-1, tsb + 5, tsb + 90])
    sup = torch.where(torch.rand((V,), generator=g, device=dev) < 0.01,
                      F32_MIN, 0.0)
    return logits, sum_lp, last, pen, mts, sup


@pytest.mark.parametrize("V,with_ts,is_first,K", [
    (1000, True, False, 5), (1000, True, True, 5), (1000, False, False, 5),
    (51866, True, False, 5), (51866, False, True, 5), (1000, True, False, 1),
    (1000, False, True, 8), (51866, True, True, 1), (51866, True, False, 8),
    (51866, False, False, 8)])
def test_beam_tail_kernel(dev, V, with_ts, is_first, K):
    """The multi-block tail kernel against its plain version on the card
    over the grammar state mix, K 1 / 5 / 8: identical top-K indices,
    scores within 1e-5 of max |want|; a planted tie across two beams goes
    to the lower index; two runs give the same bits."""
    from whisper_aries_tpu_torch.ops import beam_tail as BT

    B = 3
    tsb = V - 1501 if V > 2000 else 808
    ids = dict(tsb=tsb, eot=tsb - 8, blank=220, no_ts=tsb - 1,
               init_cap=tsb + 50)
    logits, sum_lp, last, pen, mts, sup = _tail_inputs(dev, B, K, V, tsb, V)
    if K >= 4:
        logits[3] = logits[1]  # window 0: beams 1 and 3 tie exactly
        sum_lp[0, 1] = sum_lp[0, 3] = 5.0
        for state, fresh in ((last, 100), (pen, -1), (mts, -1)):
            state[0, 1] = state[0, 3] = fresh  # the same (text) state
    args = (logits, sum_lp, last, pen, mts, sup, is_first, K)
    n = BT.beam_tail_kernel.launches
    got = BT.beam_tail(*args, with_timestamps=with_ts, **ids)
    assert BT.beam_tail_kernel.launches == n + 1
    again = BT.beam_tail(*args, with_timestamps=with_ts, **ids)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = BT.beam_tail_plain(*args, with_timestamps=with_ts, **ids)
    assert torch.equal(got[1], want[1])
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        fin = b.abs() < 1e30  # masked scores are f32 min or -inf
        assert torch.equal(a[~fin], b[~fin])
        if bool(fin.any()):
            scale = float(b[fin].abs().max())
            assert float((a - b)[fin].abs().max()) <= 1e-5 * scale
    if K >= 4:
        beams = (got[1][0] // V).tolist()
        assert beams[:2] == [1, 3]


def test_tail_and_self_attention_plans_equal_their_python_mirrors(dev):
    """The C plans of the multi-block beam tail and of the split-KV int8
    self-attention are the ones the CPU tests hold in Python."""
    from whisper_aries_tpu_torch.ops import beam_tail as BT
    from whisper_aries_tpu_torch.ops import self_attn as SA

    for sms in (132, 114, 16):
        for V in (7, 1000, 51866, 65536):
            for rows in (1, 5, 30, 40, 400):
                assert (BT.kernel_chunk_plan(V, rows, sms)
                        == BT.chunk_plan(V, rows, sms))
        for T in (1, 16, 33, 227, 448, 1000):
            for pairs in (1, 20, 120, 800):
                assert (SA.kernel_split_plan(T, pairs, sms)
                        == SA.split_plan(T, pairs, sms))


@pytest.mark.parametrize("dtype,tail", [(torch.int8, (2, 3, 7, 64)),
                                        (torch.float32, (2, 3, 7)),
                                        (torch.bfloat16, (2, 3, 7, 64)),
                                        (torch.int8, (3, 5)),
                                        (torch.bfloat16, (1, 3))])
def test_reorder_kernel_bitwise(dev, dtype, tail):
    """In place, every leaf type and row length (16-, 4- and 1-byte
    moves): bit for bit the plain gather."""
    from whisper_aries_tpu_torch.ops import beam_reorder as BR

    B, K = 3, 5
    g = torch.Generator(device=dev).manual_seed(0)
    src = torch.randint(0, K, (B, K), generator=g, device=dev)
    src[1] = torch.arange(K, device=dev)  # one window keeps its order
    x = torch.randn((4, B * K) + tail, generator=g, device=dev)
    x = (x * 50).to(dtype) if dtype == torch.int8 else x.to(dtype)
    want = BR.permute_rows_plain(x.cpu(), src.cpu())
    n = BR.permute_rows_kernel.launches
    ptr = x.data_ptr()
    BR.permute_cache_rows({"a": x}, src)
    torch.cuda.synchronize()
    assert BR.permute_rows_kernel.launches == n + 1 and x.data_ptr() == ptr
    assert torch.equal(x.cpu(), want)


def test_engine_beam_runs_the_kernels(dev, tmp_path):
    """A tiny engine with beam 5 on the card goes through the grouped
    cross-attention, beam-tail and reorder kernels."""
    from whisper_aries_tpu_torch.audio.decode import write_wav
    from whisper_aries_tpu_torch.config import load_config
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import beam_reorder as BR
    from whisper_aries_tpu_torch.ops import beam_tail as BT
    from whisper_aries_tpu_torch.ops import cross_attn as XA
    from whisper_aries_tpu_torch.ops import decode_layers as DL
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    dims = W.WhisperDims(80, 1500, 128, 2, 2, 51866, 448, 128, 2, 2)
    eng = AriesTranscriber(
        "tiny-card", _params=W.init_params(dims, seed=0), _dims=dims,
        config=load_config(overrides={"decode.beam_size": 5}))
    assert eng.fused and eng.self_kv_int8
    t = np.arange(16000 * 40) / 16000
    x = 0.3 * np.sin(2 * np.pi * 200 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
    path = str(tmp_path / "a.wav")
    write_wav(path, x.astype(np.float32))
    counters = (XA.cross_attention_q8_kernel, BT.beam_tail_kernel,
                BR.permute_rows_kernel, DL.fused_decoder_layers)
    before = [c.launches for c in counters]
    res = eng.transcribe_file(path, temperature=(0.0,), max_new_tokens=12)
    assert res["num_windows"] >= 1
    assert all(c.launches > b for c, b in zip(counters, before))
    assert all(d["beam_size"] == 5 for d in eng.last_stats["decodes"])



# ---------------------------------------------------------------------------
# the int8 paths' kernels: W8A16 GEMM (weight-side dequant), int8 self-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,K,N", [(6, 256, 384), (1, 128, 48),
                                   (37, 128, 160), (300, 512, 256),
                                   (1000, 256, 1024)])
def test_quant_matmul_kernel(dev, M, K, N):
    """The kernel against its plain version: f32 out within 1e-5 of
    max |want| (the same bf16 products summed in another order); bf16 out
    within one bf16 step of max |want| and one step off in under 1% of the
    elements; the outscale product (weights not rounded to bf16) is far
    outside the f32 limit. Covers split K (M 1, 6), an N tail (160, 48),
    M tails (37, 300, 1000) and several M tiles."""
    from whisper_aries_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(M + N)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    q8, s = Q.quantize_int8(0.05 * torch.randn((K, N), generator=g,
                                                device=dev))
    n = Q.quant_matmul_dequant_kernel.launches
    got = Q.quant_matmul_dequant_kernel(x, q8, s, torch.float32)
    got16 = Q.quant_matmul_dequant(x, q8, s)
    assert Q.quant_matmul_dequant_kernel.launches == n + 2
    want = Q.quant_matmul_dequant_plain(x, q8, s)
    assert _rel(got, want) <= 1e-5
    want16 = want.to(torch.bfloat16)
    assert got16.dtype == torch.bfloat16 and _rel(got16, want16) <= 2 ** -7
    assert float((got16 != want16).float().mean()) < 1e-2
    assert _rel(Q._quant_matmul_outscale(x, q8, s), want) > 1e-4


def _wgmma_cases():
    from whisper_aries_tpu_torch.ops import quant as Q

    cut = Q.WGMMA_MIN_MN // 1280
    return [(4500, 1280, 1280), (9000, 1280, 1280), (4500, 5120, 1280),
            (9000, 1280, 5120), (4500, 1280, 1296), (cut - 1, 1280, 1280),
            (cut, 1280, 1280), (cut + 37, 1280, 1296)]


@pytest.mark.parametrize("M,K,N", _wgmma_cases())
def test_quant_matmul_paths_at_encoder_shapes(dev, M, K, N):
    """The encoder's and word pass's M (6 and 3 windows x 1500) at K 1280 /
    5120, an N tail (1296), and M on either side of the plan's cut-over:
    the call takes the path ``gemm_plan`` names (``launches_by_path``
    moves there), f32 out within 1e-5 of max |want|, bf16 out one step off
    in under 1% of the elements. Three fresh inputs each."""
    from whisper_aries_tpu_torch.ops import quant as Q

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    path = Q.gemm_plan(M, N, K, sms)[0]
    assert path == ("wgmma" if M * N >= Q.WGMMA_MIN_MN else "splitk")
    for rep in range(3):
        g = torch.Generator(device=dev).manual_seed(M + K + N + rep)
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        q8, s = Q.quantize_int8(0.02 * torch.randn((K, N), generator=g,
                                                   device=dev))
        by_path = dict(Q.quant_matmul_dequant_kernel.launches_by_path)
        got = Q.quant_matmul_dequant_kernel(x, q8, s, torch.float32)
        got16 = Q.quant_matmul_dequant_kernel(x, q8, s)
        after = Q.quant_matmul_dequant_kernel.launches_by_path
        assert after[path] == by_path[path] + 2
        assert sum(after.values()) == sum(by_path.values()) + 2
        want = Q.quant_matmul_dequant_plain(x, q8, s)
        assert _rel(got, want) <= 1e-5
        want16 = want.to(torch.bfloat16)
        assert _rel(got16, want16) <= 2 ** -7
        assert float((got16 != want16).float().mean()) < 1e-2
        del x, q8, s, got, got16, want, want16


def _splitk_cases():
    from whisper_aries_tpu_torch.ops import quant as Q

    cases = []
    for K, N in ((1280, 1280), (1280, 3840), (1280, 5120), (5120, 1280),
                 (1312, 1296)):
        cut = -(-Q.WGMMA_MIN_MN // N)
        for M in (1, 6, 8, 9, 30, 64, 65, 200, cut - 1):
            cases.append((M, K, N))
    return cases


@pytest.mark.parametrize("M,K,N", _splitk_cases())
def test_quant_matmul_splitk_path(dev, M, K, N):
    """The small-M path (one launch, the K slices of a column tile one
    cluster reduced in distributed shared memory), forced, at M 1 .. the
    cut-over - 1 and the decode step's N / K, with the K 1312 / N 1296
    tails: f32 out
    within 1e-5 of max |want|, bf16 out one step off in under 1% of the
    elements; ``launches_by_path`` counts one "splitk" launch a call."""
    from whisper_aries_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    q8, s = Q.quantize_int8(0.02 * torch.randn((K, N), generator=g,
                                               device=dev))
    before = dict(Q.quant_matmul_dequant_kernel.launches_by_path)
    got = Q.quant_matmul_dequant_kernel(x, q8, s, torch.float32,
                                        path="splitk")
    got16 = Q.quant_matmul_dequant_kernel(x, q8, s, path="splitk")
    after = Q.quant_matmul_dequant_kernel.launches_by_path
    assert after["splitk"] == before["splitk"] + 2
    assert after["wgmma"] == before["wgmma"]
    want = Q.quant_matmul_dequant_plain(x, q8, s)
    assert _rel(got, want) <= 1e-5
    steps, share = _steps(got16, want.to(torch.bfloat16))
    assert share < 1e-2


@pytest.mark.parametrize("M,K,N", [(6, 1280, 3840), (1, 5120, 1280),
                                   (200, 1312, 1296)])
def test_quant_matmul_splitk_is_one_kernel(dev, M, K, N):
    """A small-M product is one kernel on the card (the profiler sees one
    device kernel a call: no partial-sum pass, no dequant pass)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from whisper_aries_tpu_torch.ops import quant as Q

    x = torch.randn((M, K), device=dev).to(torch.bfloat16)
    q8, s = Q.quantize_int8(0.02 * torch.randn((K, N), device=dev))
    Q.quant_matmul_dequant_kernel(x, q8, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        Q.quant_matmul_dequant_kernel(x, q8, s)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.events()
               if getattr(ev, "device_type", None) == DeviceType.CUDA
               and "splitk" in ev.name]
    others = [ev.name for ev in prof.events()
              if getattr(ev, "device_type", None) == DeviceType.CUDA
              and "splitk" not in ev.name and ev.device_time_total > 0]
    assert len(kernels) == 1 and not others, others


def test_quant_matmul_splitk_plan_is_the_c_plan(dev):
    """``splitk_plan`` (Python) equals the C plan the launch uses."""
    from whisper_aries_tpu_torch.ops import quant as Q

    for sms in (66, 114, 132):
        for M in (1, 6, 9, 64, 65, 300):
            for N, K in ((1280, 1280), (3840, 1280), (5120, 1280),
                         (1280, 5120), (1296, 1312), (48, 128)):
                assert Q.kernel_splitk_plan(M, N, K, sms) == \
                    Q.splitk_plan(M, N, K, sms), (M, N, K, sms)


@pytest.mark.parametrize("K,N", [(1280, 1280), (5120, 1296), (64, 16)])
def test_dequant_scratch_bitwise(dev, K, N):
    """The wgmma path's first pass equals ``dequantize_bf16`` (an f32
    multiply, then round to nearest even) bit for bit. Three fresh
    inputs."""
    from whisper_aries_tpu_torch.ops import quant as Q

    for rep in range(3):
        g = torch.Generator(device=dev).manual_seed(K + N + rep)
        q8, s = Q.quantize_int8(torch.randn((K, N), generator=g, device=dev))
        got = Q.dequantize_bf16_kernel(q8, s)
        want = Q.dequantize_bf16(q8, s)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_quant_matmul_forced_paths_agree(dev):
    """Either path on the same operands (the crossover measurement's
    calls): f32 outputs within 1e-5 of max |want| of each other. Three
    fresh inputs."""
    from whisper_aries_tpu_torch.ops import quant as Q

    for rep in range(3):
        g = torch.Generator(device=dev).manual_seed(5 + rep)
        x = torch.randn((200, 1280), generator=g, device=dev).to(
            torch.bfloat16)
        q8, s = Q.quantize_int8(0.02 * torch.randn((1280, 1280), generator=g,
                                                   device=dev))
        a = Q.quant_matmul_dequant_kernel(x, q8, s, torch.float32,
                                          path="wgmma")
        b = Q.quant_matmul_dequant_kernel(x, q8, s, torch.float32,
                                          path="splitk")
        assert _rel(a, b) <= 1e-5
    with pytest.raises(ValueError, match="K % 64"):
        Q.quant_matmul_dequant_kernel(x[:, :96].contiguous(),
                                      q8[:96].contiguous(), s, path="wgmma")


def test_quant_matmul_kernel_rejects_shapes_it_does_not_take(dev):
    from whisper_aries_tpu_torch.ops import quant as Q

    x = torch.zeros((4, 40), dtype=torch.bfloat16, device=dev)
    q8 = torch.zeros((40, 32), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="K % 32"):
        Q.quant_matmul_dequant_kernel(x, q8, torch.ones(32, device=dev))


@pytest.mark.parametrize("B,H,T,pos,qdtype", [(2, 3, 16, 0, torch.float32),
                                              (6, 20, 227, 100, torch.bfloat16),
                                              (3, 2, 40, 39, torch.float32),
                                              (140, 2, 227, 5, torch.bfloat16)])
def test_self_attention_q8_kernel(dev, B, H, T, pos, qdtype):
    """The int8 self-attention step against its plain version: within 1e-5
    of max |want|; stale values past ``pos`` stay masked (the unmasked
    version differs), and the last written position counts. 140 rows x 2
    heads takes the two-blocks-per-SM instantiation."""
    from whisper_aries_tpu_torch.ops import self_attn as SA

    g = torch.Generator(device=dev).manual_seed(T + pos)
    q = torch.randn((B, 1, H, 64), generator=g, device=dev).to(
        qdtype).transpose(1, 2)  # strided, as decoder_step hands it over
    k8, v8 = (torch.randint(-127, 128, (B, H, T, 64), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks = torch.rand((B, H, T), generator=g, device=dev) / 127 / 8
    vs = torch.rand((B, H, T), generator=g, device=dev) / 127
    t = torch.arange(T, device=dev)
    mask = torch.where(t <= pos, 0.0, F32_MIN).float()[None]
    n = SA.self_attention_q8_kernel.launches
    got = SA.self_attention_q8(q, k8, ks, v8, vs, mask)
    assert SA.self_attention_q8_kernel.launches == n + 1
    want = SA.self_attention_q8_plain(q, k8, ks, v8, vs, mask)
    assert _rel(got, want) <= 1e-5
    if pos < T - 1:
        assert _rel(SA.self_attention_q8_plain(q, k8, ks, v8, vs,
                                               torch.zeros_like(mask)),
                    want) > 1e-3
    if pos > 0:
        cut = mask.clone()
        cut[..., pos] = F32_MIN
        assert _rel(SA.self_attention_q8_plain(q, k8, ks, v8, vs, cut),
                    want) > 1e-4


@pytest.mark.parametrize("T,vs,pos", [(16, 0, 5), (16, 3, 15),
                                      (227, 0, 127), (227, 0, 128),
                                      (227, 150, 200), (448, 0, 255),
                                      (448, 0, 256), (448, 300, 447)])
def test_self_attention_q8_split_kernel(dev, T, vs, pos):
    """The split-KV kernel at the slice's 6 rows x 20 heads (2 splits of
    128 keys at T 227, 4 at T 448 on 132 SMs), with the position on both
    sides of a split boundary and valid_start > 0 (whole splits masked):
    within 1e-4 max and 1e-5 mean of max |want|, two runs bitwise equal;
    the split holding ``pos`` dropped from P . V moves it past both
    limits."""
    from whisper_aries_tpu_torch.ops import cuda_build as cb
    from whisper_aries_tpu_torch.ops import self_attn as SA

    B, H = 6, 20
    S, C = SA.split_plan(T, B * H, cb.sm_count(dev))
    g = torch.Generator(device=dev).manual_seed(T + pos + vs)
    q = torch.randn((B, 1, H, 64), generator=g, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    k8, v8 = (torch.randint(-127, 128, (B, H, T, 64), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks = torch.rand((B, H, T), generator=g, device=dev) / 127 / 8
    vs_ = torch.rand((B, H, T), generator=g, device=dev) / 127
    t = torch.arange(T, device=dev)
    mask = torch.where((t <= pos) & (t >= vs), 0.0, F32_MIN).float()[None]
    got = SA.self_attention_q8_kernel(q, k8, ks, v8, vs_, mask)
    assert torch.equal(got, SA.self_attention_q8_kernel(q, k8, ks, v8, vs_,
                                                         mask))
    want = SA.self_attention_q8_plain(q, k8, ks, v8, vs_, mask)
    assert _rel(got, want) <= 1e-4 and _mean_rel(got, want) <= 1e-5
    lo = pos // C * C
    p = torch.softmax(torch.einsum("bhsd,bhtd->bhst", q.float(), k8.float())
                      * ks[:, :, None] + mask, dim=-1) * vs_[:, :, None]
    p[..., lo:lo + C] = 0
    wrong = torch.einsum("bhst,bhtd->bhsd", p, v8.float())
    assert _rel(wrong, want) > 1e-4 and _mean_rel(wrong, want) > 1e-5


def _unfused_rows(small, R, Bw, self_int8, T=16):
    """The small model's bf16 cross K/V for Bw windows and a self cache of
    R rows (int8 or bf16) prefilled with a 3-token prompt."""
    from whisper_aries_tpu_torch.models import whisper as W

    dims, params, wpack, g = small
    dev = wpack["wq8"].device
    xa = torch.randn((Bw, 96, 128), generator=g, device=dev).to(torch.bfloat16)
    cross = W.precompute_cross_kv(params, xa, dims)
    cache = W.init_kv_cache(dims, R, dtype=torch.bfloat16, max_len=T,
                            int8=self_int8, device=dev)
    prompt = torch.randint(0, 500, (R, 3), generator=g, device=dev)
    W.decoder_step(params, prompt, 0, cache, cross, dims)
    return dims, params, cross, cache, g


@pytest.mark.parametrize("self_int8", [False, True])
def test_unfused_step_graph_replay_equals_direct_steps(small, self_int8):
    """decoder_step replayed from one CUDA graph (UnfusedStepGraph) gives
    the logits and the self cache of direct calls bit for bit over six
    positions, on 2 windows x 3 beam rows with an in-place beam reorder
    between steps; every replay counts."""
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import beam_reorder as BR

    R = 6
    dims, params, cross, cache, g = _unfused_rows(small, R, 2, self_int8)
    dev = cross["k"].device
    graph = W.UnfusedStepGraph(params, cache, cross, dims, R)
    direct = {k: v.clone() for k, v in cache.items()}
    n = W.decoder_step.graph_replays
    src = torch.tensor([[1, 0, 2], [0, 0, 1]], dtype=torch.int32, device=dev)
    for pos in range(3, 9):
        tok = torch.randint(0, 500, (R,), generator=g, device=dev)
        a = graph.run(tok, pos).clone()
        b = W.decoder_step(params, tok[:, None], pos, direct, cross,
                           dims)[:, 0]
        assert torch.equal(a, b), pos
        for k in cache:
            assert torch.equal(cache[k], direct[k]), (pos, k)
        if pos == 5:
            BR.permute_cache_rows(cache, src)
            BR.permute_cache_rows(direct, src)
    assert W.decoder_step.graph_replays == n + 6


def test_greedy_decode_unfused_replays_every_step(small, monkeypatch):
    """An unfused greedy decode on the card (int8 self cache, bf16 cross
    K/V) replays its decoder_step graph on every step after the prefill's,
    and its tokens and scores are those of the same steps called
    directly."""
    from whisper_aries_tpu_torch.decoding import generate as G
    from whisper_aries_tpu_torch.models import whisper as W

    dims, params, wpack, g = small
    dev = wpack["wq8"].device
    xa = torch.randn((2, 96, 128), generator=g, device=dev).to(torch.bfloat16)
    ids = G.DecodeSpecialIds(eot=511, sot=500, no_speech=510,
                             no_timestamps=509, timestamp_begin=512, blank=1,
                             n_vocab=512)
    prompt = torch.full((2, 1), 500, dtype=torch.long, device=dev)
    kw = dict(sample_len=8, with_timestamps=False, kv_int8=False,
              self_kv_int8=True, fused=False)
    n = W.decoder_step.graph_replays
    out = G.greedy_decode(params, xa, prompt, dims, ids,
                          torch.zeros(512, device=dev), 0, 0.0, **kw)
    assert W.decoder_step.graph_replays - n == int(out["steps"]) - 1 > 0
    monkeypatch.setattr(G, "_step_graph", lambda *a, **k: None)
    eager = G.greedy_decode(params, xa, prompt, dims, ids,
                            torch.zeros(512, device=dev), 0, 0.0, **kw)
    for k in ("tokens", "sum_logprob"):
        assert torch.equal(out[k], eager[k])


def _int8_engine(dev, tmp_path, overrides):
    from whisper_aries_tpu_torch.audio.decode import write_wav
    from whisper_aries_tpu_torch.config import load_config
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    dims = W.WhisperDims(80, 1500, 128, 2, 2, 51866, 448, 128, 2, 2)
    eng = AriesTranscriber("tiny-card", _params=W.init_params(dims, seed=0),
                           _dims=dims, compute_type="int8",
                           config=load_config(overrides=overrides))
    t = np.arange(16000 * 40) / 16000
    x = 0.3 * np.sin(2 * np.pi * 200 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
    path = str(tmp_path / "a.wav")
    write_wav(path, x.astype(np.float32))
    return eng, path


def test_engine_words_runs_the_kernels(dev, tmp_path, monkeypatch):
    """compute int8 under ARIES_QUANT_IMPL=pallas, beam 5, word timestamps:
    the W8A16 GEMM runs beside the beam path's kernels, and every segment
    carries words."""
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import beam_reorder as BR
    from whisper_aries_tpu_torch.ops import beam_tail as BT
    from whisper_aries_tpu_torch.ops import cross_attn as XA
    from whisper_aries_tpu_torch.ops import decode_layers as DL
    from whisper_aries_tpu_torch.ops import mel as M
    from whisper_aries_tpu_torch.ops import quant as Q

    monkeypatch.setenv("ARIES_QUANT_IMPL", "pallas")
    eng, path = _int8_engine(dev, tmp_path, {"decode.beam_size": 5})
    assert eng.fused and eng.self_kv_int8
    eng.alignment_heads = [(1, 0), (1, 1)]
    counters = (M.mel_power_kernel, W.encoder_attention_kernel,
                Q.quant_matmul_dequant_kernel, DL.fused_decoder_layers,
                XA.cross_attention_q8_kernel, BT.beam_tail_kernel,
                BR.permute_rows_kernel)
    before = [c.launches for c in counters]
    res = eng.transcribe_file(path, temperature=(0.0,), max_new_tokens=12,
                              word_timestamps=True)
    assert res["num_windows"] >= 1 and res["segments"]
    assert all(c.launches > b for c, b in zip(counters, before))
    assert all(s["words"] for s in res["segments"])


def test_engine_self_int8_runs_the_kernels(dev, tmp_path, monkeypatch):
    """kv_cache_dtype bf16 with self_kv_cache_dtype int8: unfused steps,
    their self-attention through the int8 self-attention kernel and their
    dense layers through the W8A16 GEMM, every step after a prefill a
    replay of its decode call's graph."""
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import decode_layers as DL
    from whisper_aries_tpu_torch.ops import quant as Q
    from whisper_aries_tpu_torch.ops import self_attn as SA

    monkeypatch.setenv("ARIES_QUANT_IMPL", "pallas")
    eng, path = _int8_engine(dev, tmp_path, {
        "decode.kv_cache_dtype": "bf16",
        "decode.self_kv_cache_dtype": "int8"})
    assert not eng.fused and not eng.kv_int8 and eng.self_kv_int8
    counters = (SA.self_attention_q8_kernel, Q.quant_matmul_dequant_kernel)
    before = [c.launches for c in counters]
    fused = DL.fused_decoder_layers.launches
    replays = W.decoder_step.graph_replays
    res = eng.transcribe_file(path, temperature=(0.0,), max_new_tokens=12)
    assert res["num_windows"] >= 1
    assert all(c.launches > b for c, b in zip(counters, before))
    assert DL.fused_decoder_layers.launches == fused
    decodes = eng.last_stats["decodes"]
    assert W.decoder_step.graph_replays - replays == sum(
        d["steps"] - 1 for d in decodes)


# ---------------------------------------------------------------------------
# the hardware probes (whisper_aries_tpu_torch/scripts/)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "dtype,rows,lanes,full,slots,streams,blocks,bands", [
        (torch.bfloat16, 8, 4096, 4096, 2, 1, 1, 1),    # the TPU's 64 KB chunk
        (torch.bfloat16, 16, 8192, 8192, 4, 1, 8, 8),   # banded, 4 slots
        (torch.int8, 1280, 512, 1536, 2, 1, 8, 8),      # strided: two boxes
        (torch.int8, 1280, 512, 512, 1, 1, 16, 16),     # one slot
        (torch.bfloat16, 64, 8192, 8192, 2, 4, 64, 64),  # four rings a block
        # one block an SM walking the items: fewer bands than blocks, more,
        # strided, several rings
        (torch.bfloat16, 8, 4096, 4096, 2, 1, 132, 1),
        (torch.bfloat16, 256, 8192, 8192, 2, 1, 132, 64),
        (torch.int8, 1280, 512, 1536, 2, 1, 132, 8),
        (torch.bfloat16, 256, 8192, 8192, 2, 2, 132, 128),
        (torch.bfloat16, 16, 8192, 8192, 4, 1, 3, 8),
    ])
def test_probe_copy_kernel(dev, dtype, rows, lanes, full, slots, streams,
                           blocks, bands):
    from whisper_aries_tpu_torch.scripts import probe_dma as PD

    src = PD.source(dtype, 8, rows, full, dev)
    band = rows // bands
    slots = 2 if streams > 1 else slots
    for n in (1, 37):
        reads = torch.empty((blocks, streams, PD.steps_of(n, bands, blocks)),
                            device=dev)
        if streams == 1:
            got = PD.copy_ring_kernel(src, band, lanes, n, slots, blocks,
                                      reads, bands)
        else:
            got = PD.copy_streams_kernel(src, band, lanes, n, streams, blocks,
                                         reads, bands)
        torch.cuda.synchronize()
        held = PD.hold_checksum(got, src, band, n, streams, blocks, bands)
        assert held["ok"], held
        assert float((reads - PD.trace_plain(src, band, n, streams, blocks,
                                             bands=bands)
                      ).abs().max()) == 0.0


def test_probe_smem_limit_and_clusters(dev):
    """One-slot copies at the opt-in limit run (sum 128 a block) and one
    byte above it is refused by cudaFuncSetAttribute with
    cudaErrorInvalidValue (1); a cluster of 2 at the limit runs."""
    from whisper_aries_tpu_torch.scripts import probe_dma as PD
    from whisper_aries_tpu_torch.scripts import probe_vmem as PV

    optin = PD.smem_limits(dev)["optin"]
    n = PV.smem_copy_kernel.launches
    at = PV.try_bytes(optin, device=dev)
    above = PV.try_bytes(optin + 1, device=dev)
    assert at["ok"] and at["sums"] == [128.0]
    assert not above["ok"]
    assert (above["code"], above["stage"]) == (1, "attribute"), above
    assert PV.smem_copy_kernel.launches == n + 1  # the refusal is no launch
    pair = PV.try_bytes(optin, 2, device=dev)
    assert pair["ok"] and pair["sums"] == [128.0, 128.0]
    assert PV.max_clusters(dev, 2, optin) >= 1


def test_probe_copy_refuses_its_own_arguments_apart(dev):
    """A launch asking for less shared memory than its ring needs is
    refused by the C entry itself, as a ValueError, not as the card's
    refusal (which the shared-memory probe records)."""
    from whisper_aries_tpu_torch.scripts import probe_dma as PD

    src = PD.source(torch.bfloat16, 2, 4, 1024, dev)
    need = PD.block_smem(4 * 1024 * 2, 2, False)
    with pytest.raises(ValueError, match="refused its arguments"):
        PD.launch_copy(src, 4, 1024, 4, 2, 1, 1, smem=need - 16)
    # one checksum a ring: (blocks, rings)
    assert PD.launch_copy(src, 4, 1024, 4, 2, 1, 1,
                          smem=need).shape == (1, 1)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("kind", ["bf16", "s8", "f32"])
def test_probe_mma_kernel(dev, kind, fold):
    from whisper_aries_tpu_torch.scripts import probe_int8_mxu as PI
    from whisper_aries_tpu_torch.scripts import probe_mxu as PM

    a, b = PM.operands(kind, PM.tile_k(kind), dev)
    kernel = PI.mma_fold_kernel if fold else PM.mma_loop_kernel
    for n in (1, 11):
        got = kernel(a, b, n, kind, blocks=3)
        torch.cuda.synchronize()
        held = PM.hold_mma(got, a, b, n, kind, fold)
        assert held["ok"], held


def test_probe_mma_s32_wraps(dev):
    """400 folds of 127 x 127 x 256 products pass 2^31: the kernel's s32
    sums wrap exactly as the plain version's."""
    from whisper_aries_tpu_torch.scripts import probe_int8_mxu as PI
    from whisper_aries_tpu_torch.scripts import probe_mxu as PM

    a = torch.full((PM.TM, 256), 127, dtype=torch.int8, device=dev)
    b = torch.full((256, PM.TN), 127, dtype=torch.int8, device=dev)
    got = PI.mma_fold_kernel(a, b, 400, "s8", blocks=1)[0]
    want = PM.mma_plain(a, b, 400, "s8", fold=True)
    assert torch.equal(got, want)
    assert int(want[0, 0]) != 127 * 127 * 256 * PM.fold_weight(400, True)


@pytest.mark.parametrize("variant", ["batched", "perwin"])
def test_probe_transpose_kernel(dev, variant):
    from whisper_aries_tpu_torch.scripts import probe_batched_transpose as PT

    x = PT.inputs(dev)
    for reps in (1, 2, 7, PT.REPS):  # the kernel splits them into 2 groups
        got = PT.transpose_sum_kernel(x, variant, reps)
        torch.cuda.synchronize()
        held = PT.hold_transpose(got, x, variant, reps)
        assert held["ok"], held


def test_probe_entries_launch_their_kernels(dev):
    """Each TPU probe's function, called on the card, launches its kernel
    once."""
    from whisper_aries_tpu_torch.scripts import probe_batched_transpose as PT
    from whisper_aries_tpu_torch.scripts import probe_dma as PD
    from whisper_aries_tpu_torch.scripts import probe_int8_mxu as PI
    from whisper_aries_tpu_torch.scripts import probe_mxu as PM
    from whisper_aries_tpu_torch.scripts import probe_vmem as PV

    src = PD.source(torch.bfloat16, 8, 8, 128, dev)
    a, b = PM.operands("s8", 256, dev)
    calls = [
        (PD.copy_ring_kernel, lambda: PD.probe(src, 8, 128, 20, 2, 128)),
        (PD.copy_streams_kernel, lambda: PD.probe_multi(src, 8, 128, 5, 2)),
        (PV.smem_copy_kernel, lambda: PV.try_size(48)),
        (PM.mma_loop_kernel, lambda: PM.probe(a, b, 3, "s8")),
        (PI.mma_fold_kernel,
         lambda: PI.make_kernel(torch.int8, torch.int32, reps=5)(a, b)),
        (PT.transpose_sum_kernel, lambda: PT.make("perwin")(PT.inputs(dev))),
    ]
    for kernel, call in calls:
        n = kernel.launches
        call()
        assert kernel.launches == n + 1, kernel.__name__
    want = float(src[torch.arange(20) % 8, 0, 0].double().sum())
    assert abs(float(PD.probe(src, 8, 128, 20, 2, 128)) - want) < 1e-4
    assert float(PM.probe(a, b, 3, "s8")) == 3 * float(
        a[0].double() @ b[:, 0].double())


# the attention-micro probes (probe_qa_micro, probe_qa_opt, probe_qa_bisect)
def _qa_module(name):
    import importlib

    mod = importlib.import_module(f"whisper_aries_tpu_torch.scripts.{name}")
    kernel = {"probe_qa_micro": "micro_kernel", "probe_qa_opt": "opt_kernel",
              "probe_qa_bisect": "bisect_kernel"}[name]
    return mod, getattr(mod, kernel), "lgb" if name == "probe_qa_micro" \
        else "rmask"


QA_CASES = [(n, v) for n in ("probe_qa_micro", "probe_qa_opt",
                              "probe_qa_bisect")
            for v in _qa_module(n)[0].VARIANTS]


@pytest.mark.parametrize("name,variant", QA_CASES,
                         ids=[f"{n}-{v}" for n, v in QA_CASES])
def test_probe_qa_kernel(dev, name, variant):
    """Every variant's kernel on 3 blocks at 1 and 4 iterations against
    its plain version: the (8, 128) answer and the checksum of all the
    micro computes, every block equal, one launch counted a call."""
    from whisper_aries_tpu_torch.scripts import qa_micro as QA

    mod, kernel, extra = _qa_module(name)
    ops = QA.inputs(dev, extra)
    spec = mod.VARIANTS[variant]
    for reps in (1, 4):
        n = kernel.launches
        out, cs = kernel(variant, ops, reps, blocks=3)
        torch.cuda.synchronize()
        assert kernel.launches == n + 1
        assert out.shape == (3, 8, 128) and cs.shape == (3,)
        assert bool((out == out[0]).all()) and bool((cs == cs[0]).all())
        held = QA.hold_variant(spec, ops, reps, extra, out[0], float(cs[0]))
        assert held["ok"], held


def test_probe_qa_build_runs_the_kernel(dev):
    """build(variant, reps) on the card launches the kernel once a call on
    every SM and gives block 0's answer."""
    from whisper_aries_tpu_torch.ops import cuda_build as cb
    from whisper_aries_tpu_torch.scripts import qa_micro as QA

    for name in ("probe_qa_micro", "probe_qa_opt", "probe_qa_bisect"):
        mod, kernel, extra = _qa_module(name)
        ops = QA.inputs(dev, extra)
        variant = next(iter(mod.VARIANTS))
        n = kernel.launches
        got = mod.build(variant, 2)(*(ops[k] for k in
                                      ("q", "k", "v", "wo", extra)))
        assert kernel.launches == n + 1
        out, _ = kernel(variant, ops, 2, blocks=cb.sm_count(dev))
        assert torch.equal(got, out[0])


def test_probe_qa_refusals_raise(dev):
    """A flag tuple the source does not instantiate, or a launch without
    its buffer, is refused by the C entry (ValueError), never run."""
    from whisper_aries_tpu_torch.scripts import qa_micro as QA

    ops = QA.inputs(dev, "rmask")
    with pytest.raises(ValueError, match="refused its arguments"):
        QA.launch(QA.Spec(norm="rcp", layout="vmajor"), ops, "rmask", 1, 1)
    with pytest.raises(ValueError, match="refused its arguments"):
        QA.launch(QA.Spec(phase="sm"), ops, "rmask", 1, 1)
    with pytest.raises(ValueError, match="refused its arguments"):
        QA.launch(QA.Spec(), ops, "rmask", 1, 0)


def test_probe_qa_build_failure_raises(dev, tmp_path, monkeypatch):
    """A source nvcc refuses raises with nvcc's output; nothing runs in
    its place."""
    from whisper_aries_tpu_torch.ops import cuda_build as cb

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in cb.CSRC.glob("*.cuh"):
        (csrc / p.name).write_text(p.read_text())
    (csrc / "probe_qa.cu").write_text(
        (cb.CSRC / "probe_qa.cu").read_text() + "\nnot C++;\n")
    monkeypatch.setattr(cb, "CSRC", csrc)
    monkeypatch.setattr(cb, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cb.build(["probe_qa"])


# ---------------------------------------------------------------------------
# the native int8 GEMM (ARIES_QUANT_IMPL=native): row quantization and the
# s8 tensor-core GEMM, each bit for bit its plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N", [(1, 64, 32), (6, 256, 384), (17, 96, 144),
                                   (70, 1280, 128), (300, 160, 1280)])
def test_native_int8_kernels_bitwise(dev, M, K, N, dtype):
    """quantize_rows_kernel and quant_matmul_int8io_kernel against
    quantize_rows_plain and quant_matmul_int8io_plain, bit for bit (every
    step exact or one IEEE operation), with a zero row and a row of exact
    halves; the GEMM both with and without K slices (the plan's), in bf16
    and f32 out, one launch each, two runs the same bits."""
    from whisper_aries_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(M * 7 + K)
    x = torch.randn((M, K), generator=g, device=dev)
    x[0] = torch.arange(K, device=dev).float() * 37 % 254 - 126.5
    x[0, 0] = 127.0
    if M > 1:
        x[1] = 0
    x = x.to(dtype)
    q8, s = Q.quantize_int8(0.05 * torch.randn((K, N), generator=g,
                                               device=dev))
    n = Q.quantize_rows_kernel.launches
    x8, sx = Q.quantize_rows_kernel(x)
    x8_p, sx_p = Q.quantize_rows_plain(x)
    assert Q.quantize_rows_kernel.launches == n + 1
    assert torch.equal(x8, x8_p) and torch.equal(sx.view(torch.int32),
                                                 sx_p.view(torch.int32))
    for out_dtype in (torch.bfloat16, torch.float32):
        n = Q.quant_matmul_int8io_kernel.launches
        got = Q.quant_matmul_int8io_kernel(x8, sx, q8, s, out_dtype)
        again = Q.quant_matmul_int8io_kernel(x8, sx, q8, s, out_dtype)
        torch.cuda.synchronize()
        assert Q.quant_matmul_int8io_kernel.launches == n + 2
        want = Q.quant_matmul_int8io_plain(x, q8, s, out_dtype)
        assert torch.equal(got, want), float((got.float() - want.float())
                                             .abs().max())
        assert torch.equal(got, again)


def test_native_int8_wrappers_refuse_other_shapes(dev):
    from whisper_aries_tpu_torch.ops import quant as Q

    with pytest.raises(ValueError, match="K % 32"):
        Q.quantize_rows_kernel(torch.zeros((4, 48), device=dev))
    x8 = torch.zeros((4, 64), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="N % 16"):
        Q.quant_matmul_int8io_kernel(
            x8, torch.ones((4, 1), device=dev),
            torch.zeros((64, 40), dtype=torch.int8, device=dev),
            torch.ones(40, device=dev))


def test_unfused_step_graph_capture_failure_raises(small, monkeypatch):
    """A step that reads a value back to the host cannot be captured: the
    decode raises, and no step runs eagerly in its place. (Last in the
    file: the failed capture is the final use of the card here.)"""
    from whisper_aries_tpu_torch.decoding import generate as G
    from whisper_aries_tpu_torch.models import whisper as W

    dims, params, wpack, g = small
    dev = wpack["wq8"].device
    logits = W.vocab_logits
    monkeypatch.setattr(W, "vocab_logits",
                        lambda dec, x: logits(dec, x) + float(x.sum() * 0))
    xa = torch.randn((2, 96, 128), generator=g, device=dev).to(torch.bfloat16)
    ids = G.DecodeSpecialIds(eot=511, sot=500, no_speech=510,
                             no_timestamps=509, timestamp_begin=512, blank=1,
                             n_vocab=512)
    prompt = torch.full((2, 1), 500, dtype=torch.long, device=dev)
    calls = []
    step = W.decoder_step
    monkeypatch.setattr(W, "decoder_step",
                        lambda *a, **k: calls.append(a[2]) or step(*a, **k))
    with pytest.raises(RuntimeError):
        G.greedy_decode(params, xa, prompt, dims, ids,
                        torch.zeros(512, device=dev), 0, 0.0, sample_len=8,
                        with_timestamps=False, kv_int8=False,
                        self_kv_int8=True, fused=False)
    # the prefill, the warm-up and the capture; no eager step after it
    assert len(calls) == 3 and isinstance(calls[2], torch.Tensor)
