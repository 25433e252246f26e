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

The step's cross-attention is the grouped int8 cross-attention kernel's
device code (csrc/cross_attn.cuh) with a bf16 output; on its own it is
reached through ops/cross_attn.py (``cross_attention_q8_kernel`` with a bf16
``out``), and ``cross_attn_plain`` is its plain counterpart here.

``fused_decoder_layers`` launches the kernels for CUDA tensors (one C call
runs all L layers) and takes the plain version,
``fused_decoder_layers_plain``, only for CPU tensors. The other kernel parts
are also bound one by one (``layer_norm_kernel``, ``w8a16_gemm_kernel``,
``self_attn_kernel``) so each can be held against its plain counterpart on
the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict

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


def self_attn_plain(qkv: torch.Tensor, cache_l: Dict[str, torch.Tensor],
                    pos: int, vs: int, n_head: int) -> torch.Tensor:
    """Append this step's K/V at ``pos`` to one layer's self cache (in
    place), then attend over [vs, pos]. qkv (R, 3d) -> att (R, d)."""
    R, d3 = qkv.shape
    d = d3 // 3
    H, dh = n_head, d3 // 3 // n_head
    q, k, v = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
    new_kv = torch.stack([k.reshape(R, H, dh), v.reshape(R, H, dh)], dim=1)
    self_int8 = "kv8" in cache_l
    if self_int8:
        ckv, ksc = cache_l["kv8"], cache_l["ksc"]
        q8, sc = quantize_heads(new_kv)
        ckv[:, :, :, pos] = q8
        ksc[:, :, :, pos] = sc
    else:
        ckv = cache_l["kv"]
        ckv[:, :, :, pos] = new_kv.to(ckv.dtype)
    T = ckv.shape[3]
    t = torch.arange(T, device=qkv.device)
    live = (t >= vs) & (t <= pos)
    qw = (q.float() * attn_scale(dh)).to(q.dtype).reshape(R, H, dh)
    lg = torch.einsum("rhd,rhtd->rht", qw.float(), ckv[:, 0].float())
    if self_int8:
        lg = lg * ksc[:, 0]
    lg = torch.where(live, lg, float("-inf"))
    pr = torch.softmax(lg, dim=-1)
    if self_int8:
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


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cb.library("decode_layers")
    sigs = {
        "aries_gemm_splits": [_I, _I],
        "aries_layer_norm": [_P, _I, _I, _P, _P, _P, _P],
        "aries_w8a16_gemm": [_P, _I, _I, _I, _P, _I, _I, _P, _P, _I, _P, _I,
                             _P, _P],
        "aries_self_attn": [_P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P],
        "aries_decode_scratch_floats": [_I, _I, _I],
        "aries_decode_layers": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                                _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P,
                                _P, _P, _P, _P, _P],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = (ctypes.c_longlong if name == "aries_decode_scratch_floats"
                      else ctypes.c_int)
    return lib


def _self_operands(self_cache: Dict[str, torch.Tensor]):
    if "kv8" in self_cache:
        ckv, ksc = self_cache["kv8"], self_cache["ksc"]
        cb.require(ksc, "ksc", torch.float32, ckv.shape[:-1], ckv.device)
        return ckv, ksc, 1
    return self_cache["kv"], None, 0


def layer_norm_kernel(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor
                      ) -> torch.Tensor:
    R, d = x.shape
    cb.require(x, "x", torch.bfloat16)
    cb.require(s, "scale", torch.float32, (d,), x.device)
    cb.require(b, "bias", torch.float32, (d,), x.device)
    y = torch.empty_like(x)
    cb.check(_lib().aries_layer_norm(cb.ptr(x), R, d, cb.ptr(s), cb.ptr(b),
                                     cb.ptr(y), cb.stream()), "layer norm")
    layer_norm_kernel.launches += 1
    return y


def w8a16_gemm_kernel(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, mode: int = EPI_STORE,
                      out: torch.Tensor = None) -> torch.Tensor:
    """x (R, K) bf16 . w8 (K, N) int8 (a column block of a wider matrix is
    fine: rows may be strided) with the chosen epilogue -> (R, N) bf16.
    EPI_RESIDUAL adds into ``out`` in place."""
    R, K = x.shape
    N = w8.shape[1]
    cb.require(x, "x", torch.bfloat16)
    if w8.dtype != torch.int8 or w8.stride(1) != 1 or not w8.is_cuda:
        raise ValueError("w8 must be a row-major int8 CUDA matrix")
    if K % 64 or N % 32 or w8.stride(0) % 4 or w8.shape[0] != K:
        raise ValueError(f"GEMM shape ({K}, {N}) must be multiples of "
                         "(64, 32)")
    cb.require(scale, "scale", torch.float32, (N,), x.device)
    cb.require(bias, "bias", torch.float32, (N,), x.device)
    if out is None:
        if mode == EPI_RESIDUAL:
            raise ValueError("the residual epilogue needs `out`")
        out = torch.empty((R, N), dtype=torch.bfloat16, device=x.device)
    cb.require(out, "out", torch.bfloat16, (R, N), x.device)
    lib = _lib()
    part = torch.empty(lib.aries_gemm_splits(K, N) * R * N,
                       dtype=torch.float32, device=x.device)
    cb.check(lib.aries_w8a16_gemm(cb.ptr(x), K, R, K, cb.ptr(w8), w8.stride(0),
                                  N, cb.ptr(scale), cb.ptr(bias), mode,
                                  cb.ptr(out), N, cb.ptr(part), cb.stream()),
             "w8a16 gemm")
    w8a16_gemm_kernel.launches += 1
    return out


def self_attn_kernel(qkv: torch.Tensor, cache_l: Dict[str, torch.Tensor],
                     pos: int, vs: int, n_head: int) -> torch.Tensor:
    """One layer's self-attention with append; cache_l holds that layer's
    (R, 2, H, T, dh) cache [and (R, 2, H, T) scales]."""
    R, d3 = qkv.shape
    d = d3 // 3
    cb.require(qkv, "qkv", torch.bfloat16)
    ckv, ksc, int8 = _self_operands(cache_l)
    T = ckv.shape[3]
    cb.require(ckv, "self cache", torch.int8 if int8 else torch.bfloat16,
               (R, 2, n_head, T, d // n_head), qkv.device)
    if not 0 <= vs <= pos < T:
        raise ValueError(f"need 0 <= valid_start <= pos < {T}")
    att = torch.empty((R, d), dtype=torch.bfloat16, device=qkv.device)
    cb.check(_lib().aries_self_attn(
        cb.ptr(qkv), R, d, n_head, cb.ptr(ckv),
        cb.ptr(ksc) if int8 else None, int8, T, pos, vs, cb.ptr(att),
        cb.stream()), "self attention")
    self_attn_kernel.launches += 1
    return att


def _cross_windows(R: int, kv8: torch.Tensor) -> int:
    Bw = kv8.shape[-5]
    if Bw < 1 or R % Bw:
        raise ValueError(f"{R} rows do not split over {Bw} cross windows")
    return Bw


for _f in (layer_norm_kernel, w8a16_gemm_kernel, self_attn_kernel):
    _f.launches = 0


def _fused_cuda(x, wpack, self_cache, cross, valid_start, pos, n_head):
    R, d = x.shape
    L, _, d6 = wpack["wq8"].shape
    ff = wpack["wf18"].shape[-1]
    H, dh = n_head, d // n_head
    dev = x.device
    _, VEC = vec_offsets(d, ff)
    cb.require(x, "x", torch.bfloat16, (R, d))
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
    cb.require(cross["kv8"], "cross kv8", torch.int8, (L, Bw, 2, H, Ta, dh),
               dev)
    cb.require(cross["sc"], "cross scales", torch.float32, (L, Bw, 2, H, Ta),
               dev)
    if dh != 64 or d % 64 or ff % 64:
        raise ValueError("decoder-layer kernels need dh 64 and d, ff % 64")
    if not 0 <= valid_start <= pos < T:
        raise ValueError(f"need 0 <= valid_start <= pos < {T}")
    lib = _lib()
    bf = dict(dtype=torch.bfloat16, device=dev)
    h = torch.empty((R, d), **bf)
    qkv = torch.empty((R, 3 * d), **bf)
    att = torch.empty((R, d), **bf)
    h1 = torch.empty((R, ff), **bf)
    part = torch.empty(lib.aries_decode_scratch_floats(R, d, ff),
                       dtype=torch.float32, device=dev)
    x = x.clone()
    cb.check(lib.aries_decode_layers(
        cb.ptr(x), R, d, ff, H, L, cb.ptr(wpack["wq8"]), cb.ptr(wpack["wf18"]),
        cb.ptr(wpack["wf28"]), cb.ptr(wpack["vecs"]), VEC, cb.ptr(ckv),
        cb.ptr(ksc) if int8 else None, int8, T, cb.ptr(cross["kv8"]),
        cb.ptr(cross["sc"]), Ta, Bw, pos, valid_start, cb.ptr(h), cb.ptr(qkv),
        cb.ptr(att), cb.ptr(h1), cb.ptr(part), cb.stream()),
        "decoder-layer kernels")
    fused_decoder_layers.launches += 1
    return x


def fused_decoder_layers(x: torch.Tensor, wpack: Dict[str, torch.Tensor],
                         self_cache: Dict[str, torch.Tensor],
                         cross: Dict[str, torch.Tensor], valid_start: int,
                         pos: int, n_head: int) -> torch.Tensor:
    """All L decoder layers of one decode step: x (R, d) -> x (R, d), with
    this step's K/V appended to ``self_cache`` at ``pos`` in place. The rows
    are window-major over the Bw windows of ``cross`` (R / Bw beams each).
    The kernels for CUDA tensors; the plain version for CPU tensors."""
    if not x.is_cuda:
        return fused_decoder_layers_plain(x, wpack, self_cache, cross,
                                          valid_start, pos, n_head)
    return _fused_cuda(x, wpack, self_cache, cross, valid_start, pos, n_head)


fused_decoder_layers.launches = 0
