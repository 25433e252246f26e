"""Decoder-layer kernels for one decode step (csrc/decode_layers.cu).

Replaces the JAX package's Pallas decode megakernel
(ops/pallas_decode_layers.py, ``fused_decoder_layers``; its golden model is
``fused_decoder_layers_reference``). The TPU layout work does not come
over: no KP=8 row padding, no x128 fetch buckets, no one-hot placement
append. The port decodes R rows, window-major: G = R / Bw rows per window
(its beams; G = 1 for greedy), one self-cache slot per row, the window's
cross K/V shared by its G rows, with dh-minor caches:

    self cache, bf16:  {"kv":  (L, R, 2, H, T, dh) bf16}
    self cache, int8:  {"kv8": (L, R, 2, H, T, dh) int8,
                        "ksc": (L, R, 2, H, T) f32}  (scales NOT folding
                                                      1/sqrt(dh); q is
                                                      pre-scaled)
    cross K/V:         {"kv8": (L, Bw, 2, H, Ta, dh) int8,
                        "sc":  (L, Bw, 2, H, Ta) f32}  (K scales fold
                                                        1/sqrt(dh))

``fused_decoder_layers`` launches the kernels for CUDA tensors (one C call
runs all L layers: LayerNorm, a one-launch cluster split-K W8A16 GEMM per
product, split-KV self- and cross-attention) and takes the plain version,
``fused_decoder_layers_plain``, only for CPU tensors. ``DecodeStepGraph``
captures the step once per decode call as a CUDA graph and replays it each
step. The kernel parts are also bound one by one (``layer_norm_kernel``,
``w8a16_gemm_kernel``, ``self_attn_kernel``, ``cross_attn_kernel``) so each
can be held against its plain counterpart on the card. ``gemm_plan`` and
``attn_split`` mirror the kernels' grid plans, and ``self_attn_split_plain``
/ ``cross_attn_split_plain`` their split-softmax combine, for the CPU
tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from whisper_aries_tpu_torch.models.layers import attn_scale
from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.ops.quant import quantize_int8

SQRT2 = float(np.sqrt(2.0))
# GEMM epilogues (csrc/decode_layers.cu)
EPI_STORE, EPI_GELU, EPI_RESIDUAL = 0, 1, 2


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c with IEEE division on every device: PyTorch's CUDA division by
    a host scalar multiplies by its reciprocal instead, which can differ in
    the last bit and flip an int8 rounding."""
    return x / x.new_tensor(c)


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 erf approximation (|error| < 1.5e-7), the
    TPU kernel's erf, operation for operation."""
    xf = x.float()
    a = xf.abs()
    t = 1.0 / (1.0 + np.float32(0.3275911) * a)
    poly = t * (np.float32(0.254829592) + t * (
        np.float32(-0.284496736) + t * (np.float32(1.421413741) + t * (
            np.float32(-1.453152027) + t * np.float32(1.061405429)))))
    y = 1.0 - poly * torch.exp(-a * a)
    return torch.sign(xf) * y


def gelu_as(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + erf_as(_div(h, SQRT2)))


# ---------------------------------------------------------------------------
# Weight packing
# ---------------------------------------------------------------------------

def vec_offsets(d: int, ff: int):
    """Offsets of the packed per-layer vector:
    [ln1.s, ln1.b, qkv.b, o.b, lnc.s, lnc.b, cq.b, co.b, ln2.s, ln2.b,
     fc1.b, fc2.b, s_qkv, s_o, s_cq, s_co, s_f1, s_f2]."""
    sizes = [d, d, 3 * d, d, d, d, d, d, d, d, ff, d,
             3 * d, d, d, d, ff, d]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    return offs, int(offs[-1])


def pack_layer_weights(blocks: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Stacked fused-qkv decoder blocks -> the kernels' int8 weight pack.

    Takes quantized ({"q","s","b"}) or float ({"w","b"}) dense layers; the
    float ones are quantized here with the ops/quant.py grid. Layout:
    wq8 (L, d, 6d) int8 = [qkv | o | cq | co]; wf18 (L, d, ff);
    wf28 (L, ff, d); vecs (L, VEC) f32 (``vec_offsets``)."""
    attn, cross, mlp = blocks["attn"], blocks["cross"], blocks["mlp"]
    if "qkv" not in attn:
        raise ValueError("pack_layer_weights needs the fused-qkv tree")

    def as_q8(p):
        if "q" in p:
            return p["q"], p["s"].float()
        return quantize_int8(p["w"])

    q_qkv, s_qkv = as_q8(attn["qkv"])
    q_o, s_o = as_q8(attn["o"])
    q_cq, s_cq = as_q8(cross["q"])
    q_co, s_co = as_q8(cross["o"])
    q_f1, s_f1 = as_q8(mlp["fc1"])
    q_f2, s_f2 = as_q8(mlp["fc2"])
    f = lambda t: t.float()
    vecs = torch.cat([
        f(blocks["ln1"]["scale"]), f(blocks["ln1"]["bias"]),
        f(attn["qkv"]["b"]), f(attn["o"]["b"]),
        f(blocks["ln_cross"]["scale"]), f(blocks["ln_cross"]["bias"]),
        f(cross["q"]["b"]), f(cross["o"]["b"]),
        f(blocks["ln2"]["scale"]), f(blocks["ln2"]["bias"]),
        f(mlp["fc1"]["b"]), f(mlp["fc2"]["b"]),
        s_qkv, s_o, s_cq, s_co, s_f1, s_f2,
    ], dim=-1)
    return {
        "vecs": vecs.contiguous(),
        "wq8": torch.cat([q_qkv, q_o, q_cq, q_co], dim=-1).contiguous(),
        "wf18": q_f1.contiguous(),
        "wf28": q_f2.contiguous(),
    }


def quantize_heads(kv: torch.Tensor):
    """(..., dh) -> int8 values + (...) f32 scales: absmax over dh / 127,
    round half to even, clip to 127 (the in-kernel append grid)."""
    nf = kv.float()
    am = nf.abs().amax(dim=-1)
    sc = torch.where(am > 0, _div(am, 127.0), torch.ones_like(am))
    q8 = torch.clamp(torch.round(nf / sc[..., None]), -127, 127)
    return q8.to(torch.int8), sc


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def layer_norm_plain(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor
                     ) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-5) * s + b).to(x.dtype)


def w8a16_gemm_plain(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """bf16(x) . int8 W in f32 (exact products), then * scale + bias on the
    f32 result: the JAX package's ``_quant_matmul_outscale`` plus a bias."""
    y = torch.matmul(x.to(torch.bfloat16).float(), w8.float())
    return y * scale + bias


def _append_self(qkv: torch.Tensor, cache_l: Dict[str, torch.Tensor],
                 pos: int, n_head: int):
    """Write this step's K/V at ``pos`` into one layer's self cache (in
    place; quantized when the cache is int8). Returns the scaled queries
    (R, H, dh), the cache values and the int8 cache's scales (or None)."""
    R, d3 = qkv.shape
    d = d3 // 3
    H, dh = n_head, d // n_head
    q, k, v = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
    new_kv = torch.stack([k.reshape(R, H, dh), v.reshape(R, H, dh)], dim=1)
    ksc = None
    if "kv8" in cache_l:
        ckv, ksc = cache_l["kv8"], cache_l["ksc"]
        q8, sc = quantize_heads(new_kv)
        ckv[:, :, :, pos] = q8
        ksc[:, :, :, pos] = sc
    else:
        ckv = cache_l["kv"]
        ckv[:, :, :, pos] = new_kv.to(ckv.dtype)
    qw = (q.float() * attn_scale(dh)).to(q.dtype).reshape(R, H, dh)
    return qw, ckv, ksc


def self_attn_plain(qkv: torch.Tensor, cache_l: Dict[str, torch.Tensor],
                    pos: int, vs: int, n_head: int) -> torch.Tensor:
    """Append this step's K/V at ``pos`` to one layer's self cache (in
    place), then attend over [vs, pos]. qkv (R, 3d) -> att (R, d)."""
    R, d3 = qkv.shape
    d = d3 // 3
    qw, ckv, ksc = _append_self(qkv, cache_l, pos, n_head)
    T = ckv.shape[3]
    t = torch.arange(T, device=qkv.device)
    live = (t >= vs) & (t <= pos)
    lg = torch.einsum("rhd,rhtd->rht", qw.float(), ckv[:, 0].float())
    if ksc is not None:
        lg = lg * ksc[:, 0]
    lg = torch.where(live, lg, float("-inf"))
    pr = torch.softmax(lg, dim=-1)
    if ksc is not None:
        pr = pr * ksc[:, 1]
    pr = pr.to(qkv.dtype)
    att = torch.einsum("rht,rhtd->rhd", pr.float(), ckv[:, 1].float())
    return att.reshape(R, d).to(qkv.dtype)


def cross_attn_plain(cq: torch.Tensor, kv8_l: torch.Tensor,
                     sc_l: torch.Tensor, n_head: int) -> torch.Tensor:
    """cq (R, d), R = Bw * G rows window-major, over the Bw windows' int8
    cross K/V (Bw, 2, H, Ta, dh) -> att (R, d)."""
    R, d = cq.shape
    Bw = kv8_l.shape[0]
    H, dh = n_head, d // n_head
    qx = cq.float().reshape(Bw, R // Bw, H, dh)
    lg = (torch.einsum("wghd,whtd->wght", qx, kv8_l[:, 0].float())
          * sc_l[:, 0][:, None])
    px = torch.softmax(lg, dim=-1) * sc_l[:, 1][:, None]
    att = torch.einsum("wght,whtd->wghd", px, kv8_l[:, 1].float())
    return att.reshape(R, d).to(cq.dtype)


# ---------------------------------------------------------------------------
# The kernels' plans and the split-KV combine, in plain torch
# ---------------------------------------------------------------------------

# csrc/decode_layers.cu: output columns per GEMM block, K rows per ring
# stage, the largest cluster, blocks per SM the plan aims at
GEMM_COLS, GEMM_KC, GEMM_MAX_CLUSTER, GEMM_TARGET_WAVES = 64, 64, 8, 2
# csrc/attn_split.cuh: splits per (row, head) / (head, window), keys a
# self-attention split, blocks per SM the cross plan fills (the block-wide
# cross kernel's, up to 8 queries a window; the per-warp one's), keys the
# cross-attention takes
ATTN_MAX_SPLITS, ATTN_MAX_KEYS = 8, 256
CROSS_BLOCKS_PER_SM, FLASH_BLOCKS_PER_SM, CROSS_MAX_KEYS = 3, 2, 2048


def gemm_plan(K: int, N: int, sms: int) -> Tuple[int, int]:
    """(K slices s, rows per slice) of the step's W8A16 GEMM for a (K, N)
    weight on a card of ``sms`` SMs, as csrc/decode_layers.cu's gemm_plan:
    the least divisor s <= 8 of K / 64 with N / 64 x s >= 2 x sms blocks,
    else the largest such divisor. The s blocks of a column tile are one
    cluster; the plan does not depend on the rows."""
    if K % GEMM_KC or N % GEMM_COLS:
        raise ValueError(f"GEMM shape ({K}, {N}) must be multiples of "
                         f"({GEMM_KC}, {GEMM_COLS})")
    cols, units = N // GEMM_COLS, K // GEMM_KC
    best = 1
    for s in range(1, GEMM_MAX_CLUSTER + 1):
        if units % s:
            continue
        best = s
        if cols * s >= GEMM_TARGET_WAVES * sms:
            break
    return best, K // best


def attn_split(T: int) -> Tuple[int, int]:
    """(splits S, keys per split C) of the split-KV self-attention over a
    cache of T positions, as csrc/attn_split.cuh's split_plan: C the least
    multiple of 32 giving at most 8 splits, S = ceil(T / C) (the last split
    may be ragged). It depends on T alone, never on the decode position."""
    c = -(-T // ATTN_MAX_SPLITS)
    c = max(32, -(-c // 32) * 32)
    return -(-T // c), c


def cross_split(Ta: int, pairs: int, G: int, sms: int) -> Tuple[int, int]:
    """(splits S, keys per split C) of the split-KV cross-attention over Ta
    keys for ``pairs`` = windows x heads with G queries a window on ``sms``
    SMs, as csrc/attn_split.cuh's cross_plan: as many splits (at most 8) as
    keep the grid one wave of 3 blocks per SM (the block-wide kernel, G up
    to 8) or 2 (the per-warp kernel), C a multiple of 32, the last split
    ragged. Fixed for a decode call: never the decode position."""
    per_sm = FLASH_BLOCKS_PER_SM if G > 8 else CROSS_BLOCKS_PER_SM
    s = min(ATTN_MAX_SPLITS, max(1, per_sm * sms // max(pairs, 1)))
    c = -(-Ta // s)
    c = max(32, -(-c // 32) * 32)
    return -(-Ta // c), c


def _split_ranges(T: int, splits: Optional[int]) -> List[Tuple[int, int]]:
    """Key ranges of the splits: attn_split's for ``splits`` None, else
    ``splits`` ranges of ceil(T / splits) keys (trailing ones may be
    empty)."""
    if splits is None:
        S, C = attn_split(T)
    else:
        S, C = splits, -(-T // splits)
    return [(min(T, s * C), min(T, (s + 1) * C)) for s in range(S)]


def _split_softmax(lg: torch.Tensor, ranges) -> torch.Tensor:
    """exp(lg - M) / sum over the key axis (last) as the split-KV kernels
    form it: each split's max (-inf when it holds no live key), M the max
    of those, each split's sum of exp(lg - M), the total the sum of the
    splits' sums in split order."""
    neg = torch.full(lg.shape[:-1], float("-inf"), dtype=lg.dtype,
                     device=lg.device)
    maxes = [lg[..., a:b].amax(-1) if b > a else neg for a, b in ranges]
    M = torch.stack(maxes).amax(0)
    e = torch.exp(lg - M[..., None])
    total = torch.zeros_like(M)
    for a, b in ranges:
        total = total + e[..., a:b].sum(-1)
    return e / total[..., None]


def _split_pv(p: torch.Tensor, v: torch.Tensor, ranges) -> torch.Tensor:
    """sum_t p_t v_t as the sum, in split order, of each split's partial."""
    out = torch.zeros(p.shape[:-1] + v.shape[-1:], dtype=torch.float32,
                      device=p.device)
    for a, b in ranges:
        out = out + torch.einsum("...t,...td->...d", p[..., a:b].float(),
                                 v[..., a:b, :].float())
    return out


def self_attn_split_plain(qkv: torch.Tensor, cache_l: Dict[str, torch.Tensor],
                          pos: int, vs: int, n_head: int,
                          splits: Optional[int] = None) -> torch.Tensor:
    """``self_attn_plain`` computed the way the split-KV kernel combines
    its splits (the keys of each (row, head) cut as ``_split_ranges``):
    the same function, its sums in another order."""
    R = qkv.shape[0]
    qw, ckv, ksc = _append_self(qkv, cache_l, pos, n_head)
    T = ckv.shape[3]
    t = torch.arange(T, device=qkv.device)
    live = (t >= vs) & (t <= pos)
    lg = torch.einsum("rhd,rhtd->rht", qw.float(), ckv[:, 0].float())
    if ksc is not None:
        lg = lg * ksc[:, 0]
    lg = torch.where(live, lg, float("-inf"))
    ranges = _split_ranges(T, splits)
    pr = _split_softmax(lg, ranges)
    if ksc is not None:
        pr = pr * ksc[:, 1]
    pr = pr.to(qkv.dtype)
    att = _split_pv(pr, ckv[:, 1], ranges)
    return att.reshape(R, -1).to(qkv.dtype)


def split_attend(lg: torch.Tensor, vsc: torch.Tensor, v: torch.Tensor,
                 ranges, drop: Optional[int] = None) -> torch.Tensor:
    """sum_t softmax(lg)_t vsc_t v_t over the key axis (lg's last, v's
    second to last) as the split-KV cross-attention combines its splits:
    each split's max m_r, its sum l_r of exp(lg - m_r) and its partial
    o_r = sum of exp(lg - m_r) vsc v; with M the max of the m_r, the output
    is sum_r e^(m_r - M) o_r / sum_r e^(m_r - M) l_r, in split order.
    ``drop`` leaves that split's partial out of the output (a mistake the
    card checks must catch)."""
    ms, ls, outs = [], [], []
    for a, b in ranges:
        if b <= a:
            continue
        m = lg[..., a:b].amax(-1)
        e = torch.exp(lg[..., a:b] - m[..., None])
        ms.append(m)
        ls.append(e.sum(-1))
        outs.append(torch.einsum("...t,...td->...d", e * vsc[..., a:b],
                                 v[..., a:b, :].float()))
    M = torch.stack(ms).amax(0)
    f = [torch.exp(m - M) for m in ms]
    den = torch.zeros_like(M)
    for fr, lr in zip(f, ls):
        den = den + fr * lr
    out = torch.zeros_like(outs[0])
    for r, (fr, o) in enumerate(zip(f, outs)):
        if r != drop:
            out = out + (fr / den)[..., None] * o
    return out


def cross_attn_split_plain(cq: torch.Tensor, kv8_l: torch.Tensor,
                           sc_l: torch.Tensor, n_head: int,
                           splits: Optional[int] = None) -> torch.Tensor:
    """``cross_attn_plain`` computed the way the split-KV kernel combines
    the splits of each (head, window)'s Ta keys (``split_attend``;
    ``splits`` None cuts them as ``attn_split``; the kernel's own cut is
    ``cross_split``'s)."""
    R, d = cq.shape
    Bw, Ta = kv8_l.shape[0], kv8_l.shape[3]
    H, dh = n_head, d // n_head
    qx = cq.float().reshape(Bw, R // Bw, H, dh)
    lg = (torch.einsum("wghd,whtd->wght", qx, kv8_l[:, 0].float())
          * sc_l[:, 0][:, None])
    v = kv8_l[:, 1][:, None].expand(Bw, R // Bw, H, Ta, dh)
    att = split_attend(lg, sc_l[:, 1][:, None], v, _split_ranges(Ta, splits))
    return att.reshape(R, d).to(cq.dtype)


def fused_decoder_layers_plain(x: torch.Tensor, wpack: Dict[str, torch.Tensor],
                               self_cache: Dict[str, torch.Tensor],
                               cross: Dict[str, torch.Tensor],
                               valid_start: int, pos: int,
                               n_head: int) -> torch.Tensor:
    """All L decoder layers of one step in plain torch (the math of the
    JAX package's ``fused_decoder_layers_reference``). x (R, d) -> x (R, d),
    R = Bw * G rows window-major over the Bw windows of ``cross``; the self
    cache gets this step's K/V."""
    L = wpack["wq8"].shape[0]
    R, d = x.shape
    ff = wpack["wf18"].shape[-1]
    offs, _ = vec_offsets(d, ff)

    for l in range(L):
        vec = wpack["vecs"][l]
        seg = lambda i: vec[int(offs[i]):int(offs[i + 1])]
        wq = wpack["wq8"][l]

        def gemm(h, w8, si, bi):
            return w8a16_gemm_plain(h, w8, seg(si), seg(bi))

        h = layer_norm_plain(x, seg(0), seg(1))
        qkv = gemm(h, wq[:, :3 * d], 12, 2).to(h.dtype)
        cache_l = {k: c[l] for k, c in self_cache.items()}
        att = self_attn_plain(qkv, cache_l, pos, valid_start, n_head)
        x = x + gemm(att, wq[:, 3 * d:4 * d], 13, 3).to(x.dtype)

        h = layer_norm_plain(x, seg(4), seg(5))
        cq = gemm(h, wq[:, 4 * d:5 * d], 14, 6).to(h.dtype)
        atx = cross_attn_plain(cq, cross["kv8"][l], cross["sc"][l], n_head)
        x = x + gemm(atx, wq[:, 5 * d:6 * d], 15, 7).to(x.dtype)

        h = layer_norm_plain(x, seg(8), seg(9))
        h1 = gelu_as(gemm(h, wpack["wf18"][l], 16, 10)).to(h.dtype)
        x = x + gemm(h1, wpack["wf28"][l], 17, 11).to(h1.dtype)
    return x


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# launch each kernel of the step as a programmatic dependent of the one
# before (csrc/decode_layers.cu); a measurement may turn it off
PDL = True


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cb.library("decode_layers")
    sigs = {
        "aries_decode_init": [],
        "aries_gemm_plan": [_I, _I, _I],
        "aries_attn_split": [_I, _P],
        "aries_cross_split": [_I, _I, _I, _I, _P],
        "aries_layer_norm": [_P, _I, _I, _P, _P, _P, _P],
        "aries_w8a16_gemm": [_P, _I, _I, _I, _P, _I, _I, _P, _P, _I, _P, _I,
                             _I, _P],
        "aries_self_attn": [_P, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P],
        "aries_cross_attn": [_P, _I, _I, _I, _P, _P, _I, _I, _P, _I, _P],
        "aries_decode_layers": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                                _P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P,
                                _P, _P, _I, _I, _P],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _set_up(index: int) -> None:
    with torch.cuda.device(index):
        cb.check(_lib().aries_decode_init(), "decoder-layer kernels' set-up")


def _kernels(t) -> ctypes.CDLL:
    """The library, with its kernels' attributes set on the card that
    holds ``t`` (a tensor or a device): they are set per card."""
    dev = t.device if isinstance(t, torch.Tensor) else torch.device(t)
    _set_up(dev.index if dev.index is not None
            else torch.cuda.current_device())
    return _lib()


def kernel_gemm_plan(K: int, N: int, sms: int) -> int:
    """The C plan's K slices (the card check of ``gemm_plan``)."""
    return _lib().aries_gemm_plan(K, N, sms)


def kernel_attn_split(T: int) -> Tuple[int, int]:
    """The C self-attention split plan (the card check of ``attn_split``)."""
    out = (ctypes.c_int * 2)()
    _lib().aries_attn_split(T, out)
    return out[0], out[1]


def kernel_cross_split(Ta: int, pairs: int, G: int,
                       sms: int) -> Tuple[int, int]:
    """The C cross-attention split plan (the card check of
    ``cross_split``)."""
    out = (ctypes.c_int * 2)()
    _lib().aries_cross_split(Ta, pairs, G, sms, out)
    return out[0], out[1]


def _self_operands(self_cache: Dict[str, torch.Tensor]):
    if "kv8" in self_cache:
        ckv, ksc = self_cache["kv8"], self_cache["ksc"]
        cb.require(ksc, "ksc", torch.float32, ckv.shape[:-1], ckv.device)
        return ckv, ksc, 1
    return self_cache["kv"], None, 0


def _step_scalars(pos: int, vs: int, dev: torch.device) -> torch.Tensor:
    """The device {pos, valid_start} the self-attention kernel reads."""
    return torch.tensor([pos, vs], dtype=torch.int32, device=dev)


def layer_norm_kernel(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor
                      ) -> torch.Tensor:
    R, d = x.shape
    cb.require(x, "x", torch.bfloat16)
    cb.require(s, "scale", torch.float32, (d,), x.device)
    cb.require(b, "bias", torch.float32, (d,), x.device)
    if d % 8:
        raise ValueError(f"LayerNorm kernel needs d % 8 == 0, got {d}")
    y = torch.empty_like(x)
    cb.launch(_kernels(x).aries_layer_norm, x, "layer norm", cb.ptr(x), R,
              d, cb.ptr(s), cb.ptr(b), cb.ptr(y))
    cb.count(layer_norm_kernel)
    return y


def w8a16_gemm_kernel(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, mode: int = EPI_STORE,
                      out: torch.Tensor = None) -> torch.Tensor:
    """x (R, K) bf16 . w8 (K, N) int8 (a column block of a wider matrix is
    fine: rows may be strided) with the chosen epilogue -> (R, N) bf16, one
    launch (``gemm_plan``'s K slices as one cluster per column tile).
    EPI_RESIDUAL adds into ``out`` in place."""
    R, K = x.shape
    N = w8.shape[1]
    cb.require(x, "x", torch.bfloat16)
    if w8.dtype != torch.int8 or w8.stride(1) != 1 or not w8.is_cuda:
        raise ValueError("w8 must be a row-major int8 CUDA matrix")
    if (K % GEMM_KC or N % GEMM_COLS or w8.shape[0] != K or w8.stride(0) % 16
            or any(t.data_ptr() % 16 for t in (w8, x, scale, bias))):
        raise ValueError(f"GEMM shape ({K}, {N}) must be multiples of "
                         f"({GEMM_KC}, {GEMM_COLS}) with 16-byte aligned rows")
    cb.require(scale, "scale", torch.float32, (N,), x.device)
    cb.require(bias, "bias", torch.float32, (N,), x.device)
    if out is None:
        if mode == EPI_RESIDUAL:
            raise ValueError("the residual epilogue needs `out`")
        out = torch.empty((R, N), dtype=torch.bfloat16, device=x.device)
    cb.require(out, "out", torch.bfloat16, (R, N), x.device)
    if out.data_ptr() % 8:
        raise ValueError("out must be 8-byte aligned")
    cb.launch(_kernels(x).aries_w8a16_gemm, x, "w8a16 gemm", cb.ptr(x), K,
              R, K, cb.ptr(w8), w8.stride(0), N, cb.ptr(scale), cb.ptr(bias),
              mode, cb.ptr(out), N, cb.sm_count(x))
    cb.count(w8a16_gemm_kernel)
    return out


def _check_splits(T: int, what: str) -> None:
    S, C = attn_split(T)
    if S > ATTN_MAX_SPLITS or C > ATTN_MAX_KEYS:
        raise ValueError(f"{what}: {T} keys exceed {ATTN_MAX_SPLITS} splits "
                         f"of {ATTN_MAX_KEYS}")


def _check_cross(Ta: int) -> None:
    if not 1 <= Ta <= CROSS_MAX_KEYS:
        raise ValueError(f"cross K/V: the kernels take 1..{CROSS_MAX_KEYS} "
                         f"keys, got {Ta}")


def self_attn_kernel(qkv: torch.Tensor, cache_l: Dict[str, torch.Tensor],
                     pos: int, vs: int, n_head: int) -> torch.Tensor:
    """One layer's split-KV self-attention with append; cache_l holds that
    layer's (R, 2, H, T, dh) cache [and (R, 2, H, T) scales]."""
    R, d3 = qkv.shape
    d = d3 // 3
    cb.require(qkv, "qkv", torch.bfloat16)
    ckv, ksc, int8 = _self_operands(cache_l)
    T = ckv.shape[3]
    cb.require(ckv, "self cache", torch.int8 if int8 else torch.bfloat16,
               (R, 2, n_head, T, d // n_head), qkv.device)
    if not 0 <= vs <= pos < T:
        raise ValueError(f"need 0 <= valid_start <= pos < {T}")
    _check_splits(T, "self cache")
    att = torch.empty((R, d), dtype=torch.bfloat16, device=qkv.device)
    step = _step_scalars(pos, vs, qkv.device)
    cb.launch(_kernels(qkv).aries_self_attn, qkv, "self attention",
              cb.ptr(qkv), R, d, n_head, cb.ptr(ckv),
              cb.ptr(ksc) if int8 else None, int8, T, cb.ptr(step),
              cb.ptr(att))
    cb.count(self_attn_kernel)
    return att


def cross_attn_kernel(cq: torch.Tensor, kv8_l: torch.Tensor,
                      sc_l: torch.Tensor, n_head: int) -> torch.Tensor:
    """One layer's split-KV int8 cross-attention: cq (R, d) bf16, rows
    window-major over the Bw windows of kv8_l (Bw, 2, H, Ta, dh) int8 and
    sc_l (Bw, 2, H, Ta) f32 -> att (R, d) bf16."""
    R, d = cq.shape
    cb.require(cq, "cq", torch.bfloat16)
    Bw, _, H, Ta, dh = kv8_l.shape
    cb.require(kv8_l, "cross kv8", torch.int8, (Bw, 2, n_head, Ta, d // n_head),
               cq.device)
    cb.require(sc_l, "cross scales", torch.float32, (Bw, 2, n_head, Ta),
               cq.device)
    _cross_windows(R, kv8_l)
    _check_cross(Ta)
    att = torch.empty_like(cq)
    cb.launch(_kernels(cq).aries_cross_attn, cq, "cross attention",
              cb.ptr(cq), R, d, n_head, cb.ptr(kv8_l), cb.ptr(sc_l), Ta, Bw,
              cb.ptr(att), cb.sm_count(cq))
    cb.count(cross_attn_kernel)
    return att


def _cross_windows(R: int, kv8: torch.Tensor) -> int:
    Bw = kv8.shape[-5]
    if Bw < 1 or R % Bw:
        raise ValueError(f"{R} rows do not split over {Bw} cross windows")
    return Bw


for _f in (layer_norm_kernel, w8a16_gemm_kernel, self_attn_kernel,
           cross_attn_kernel):
    _f.launches = 0


class _StepOperands:
    """The validated operands of one fused step and its scratch (owned
    here, so a captured graph's pointers stay alive with it)."""

    def __init__(self, wpack, self_cache, cross, R, n_head, dev):
        L, d, _ = wpack["wq8"].shape
        ff = wpack["wf18"].shape[-1]
        H, dh = n_head, d // n_head
        _, VEC = vec_offsets(d, ff)
        cb.require(wpack["wq8"], "wq8", torch.int8, (L, d, 6 * d), dev)
        cb.require(wpack["wf18"], "wf18", torch.int8, (L, d, ff), dev)
        cb.require(wpack["wf28"], "wf28", torch.int8, (L, ff, d), dev)
        cb.require(wpack["vecs"], "vecs", torch.float32, (L, VEC), dev)
        ckv, ksc, int8 = _self_operands(self_cache)
        T = ckv.shape[4]
        cb.require(ckv, "self cache", torch.int8 if int8 else torch.bfloat16,
                   (L, R, 2, H, T, dh), dev)
        Ta = cross["kv8"].shape[4]
        Bw = _cross_windows(R, cross["kv8"])
        cb.require(cross["kv8"], "cross kv8", torch.int8,
                   (L, Bw, 2, H, Ta, dh), dev)
        cb.require(cross["sc"], "cross scales", torch.float32,
                   (L, Bw, 2, H, Ta), dev)
        if dh != 64 or d % GEMM_COLS or ff % GEMM_COLS:
            raise ValueError("decoder-layer kernels need dh 64 and d, ff % 64")
        _check_splits(T, "self cache")
        _check_cross(Ta)
        bf = dict(dtype=torch.bfloat16, device=dev)
        self.h = torch.empty((R, d), **bf)
        self.qkv = torch.empty((R, 3 * d), **bf)
        self.att = torch.empty((R, d), **bf)
        self.h1 = torch.empty((R, ff), **bf)
        self.keep = (wpack, self_cache, cross)
        self.args = (R, d, ff, H, L, cb.ptr(wpack["wq8"]),
                     cb.ptr(wpack["wf18"]), cb.ptr(wpack["wf28"]),
                     cb.ptr(wpack["vecs"]), VEC, cb.ptr(ckv),
                     cb.ptr(ksc) if int8 else None, int8, T,
                     cb.ptr(cross["kv8"]), cb.ptr(cross["sc"]), Ta, Bw)
        self.T = T
        self.sms = cb.sm_count(dev)

    def launch(self, x: torch.Tensor, step: torch.Tensor) -> None:
        cb.launch(_kernels(x).aries_decode_layers, x, "decoder-layer kernels",
                  cb.ptr(x), *self.args, cb.ptr(step), cb.ptr(self.h),
                  cb.ptr(self.qkv), cb.ptr(self.att), cb.ptr(self.h1),
                  self.sms, int(PDL))


def _fused_cuda(x, wpack, self_cache, cross, valid_start, pos, n_head):
    R, d = x.shape
    cb.require(x, "x", torch.bfloat16, (R, d))
    ops = _StepOperands(wpack, self_cache, cross, R, n_head, x.device)
    if not 0 <= valid_start <= pos < ops.T:
        raise ValueError(f"need 0 <= valid_start <= pos < {ops.T}")
    x = x.clone()
    ops.launch(x, _step_scalars(pos, valid_start, x.device))
    cb.count(fused_decoder_layers)
    return x


def fused_decoder_layers(x: torch.Tensor, wpack: Dict[str, torch.Tensor],
                         self_cache: Dict[str, torch.Tensor],
                         cross: Dict[str, torch.Tensor], valid_start: int,
                         pos: int, n_head: int) -> torch.Tensor:
    """All L decoder layers of one decode step: x (R, d) -> x (R, d), with
    this step's K/V appended to ``self_cache`` at ``pos`` in place. The rows
    are window-major over the Bw windows of ``cross`` (R / Bw beams each).
    The kernels for CUDA tensors (launched directly; ``DecodeStepGraph``
    replays them as one graph); the plain version for CPU tensors."""
    if not x.is_cuda:
        return fused_decoder_layers_plain(x, wpack, self_cache, cross,
                                          valid_start, pos, n_head)
    return _fused_cuda(x, wpack, self_cache, cross, valid_start, pos, n_head)


fused_decoder_layers.launches = 0
fused_decoder_layers.graph_replays = 0


class DecodeStepGraph:
    """One decode step (all L layers, 11 launches a layer) captured once as
    a CUDA graph over fixed operands: the weight pack, the self cache (which
    must be updated only in place, as the beam reorder does), the cross K/V
    and ``valid_start``; ``pos`` is a device scalar written before each
    replay. Make one per decode call and drop it with the call: the graph
    holds references to its operands, never replays on freed memory, and
    raises if capture or replay fails (it never falls back to launching the
    kernels directly or to the plain version)."""

    def __init__(self, wpack: Dict[str, torch.Tensor],
                 self_cache: Dict[str, torch.Tensor],
                 cross: Dict[str, torch.Tensor], rows: int, n_head: int,
                 valid_start: int = 0):
        dev = wpack["wq8"].device
        if dev.type != "cuda":
            raise ValueError("DecodeStepGraph needs CUDA operands")
        self.ops = _StepOperands(wpack, self_cache, cross, rows, n_head, dev)
        if not 0 <= valid_start < self.ops.T:
            raise ValueError(f"need 0 <= valid_start < {self.ops.T}")
        d = wpack["wq8"].shape[1]
        self.dev = dev
        self.valid_start = valid_start
        self.x = torch.zeros((rows, d), dtype=torch.bfloat16, device=dev)
        self.step = _step_scalars(valid_start, valid_start, dev)
        _kernels(dev)  # built, loaded and set up before the capture
        self.graph = cb.capture(dev, lambda: self.ops.launch(self.x,
                                                              self.step))

    def run(self, x: torch.Tensor, pos: int,
            valid_start: Optional[int] = None) -> torch.Tensor:
        """Replay the step on x (R, d) at ``pos``; returns the graph's
        output buffer (valid until the next replay). ``valid_start`` must
        be the one the graph was made with (None: that one)."""
        if valid_start is not None and valid_start != self.valid_start:
            raise ValueError(f"graph made for valid_start {self.valid_start},"
                             f" got {valid_start}")
        if not self.valid_start <= pos < self.ops.T:
            raise ValueError(f"need {self.valid_start} <= pos < {self.ops.T}")
        self.x.copy_(x)
        self.step[0].fill_(pos)
        with torch.cuda.device(self.dev):
            self.graph.replay()
        cb.count(fused_decoder_layers)
        cb.bump(fused_decoder_layers, "graph_replays")
        return self.x
