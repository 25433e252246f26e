"""Whisper encoder-decoder in PyTorch (the port of models/whisper.py).

Parameters are plain nested dicts of tensors with the JAX package's tree
and layouts: every per-layer weight is stacked into one (L, ...) tensor,
dense weights are (in, out), conv stems keep torch's (out, in, k).
``params_from_jax`` therefore only converts leaves, and both packages
compute the same function from the same numbers.

Caches (port layouts, dh-minor; updated IN PLACE, unlike JAX's functional
updates, so a decode step allocates nothing per layer):
  * self cache, bf16/f32: {"kv": (L, B, 2, H, T, dh)} — [.., 0] = K, 1 = V;
    int8 (``decoder_step`` only): {"k8", "v8": (L, B, H, T, dh) int8,
    "ks", "vs": (L, B, H, T) f32}, ks folding 1/sqrt(dh) as in JAX.
  * cross K/V, bf16/f32: {"k", "v": (L, B, H, Ta, dh)}; int8:
    {"kv8": (L, B, 2, H, Ta, dh) int8, "sc": (L, B, 2, H, Ta) f32}, the
    K scales folding 1/sqrt(dh) — the layout the decoder-layer kernels read.
    B counts windows; decoder rows may be a multiple of it (beams), and the
    rows of a window share its cross K/V (grouped cross-attention).

The encoder's attention goes through the hand-written encoder-attention
kernel (csrc/encoder_attn.cu) in bf16 and through the training kernels
(csrc/encoder_attn_train.cu, forward and backward) in f32, the int8 cross-attention of a prefill
through the grouped cross-attention kernel (csrc/cross_attn.cu), and a
decode step's self-attention over an int8 self cache through the int8
self-attention kernel (csrc/self_attn.cu), for CUDA tensors; CPU tensors
take the plain versions. ``decoder_step`` takes its positions as ints or as
device tensors, so one captured step serves every position (a decode
call's loop graph, decoding/generate.py; ``UnfusedStepGraph``). Dense layers go through ops/quant.py when int8
(the W8A16 GEMM kernel under ARIES_QUANT_IMPL=pallas, the row quantization
and the s8 GEMM under =native); float dense layers,
the conv stem and the attention of the teacher-forced passes stay torch
products, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from whisper_aries_tpu_torch.models.layers import (
    attn_scale,
    dense,
    gelu,
    layer_norm,
)
from whisper_aries_tpu_torch.ops import cuda_build as cb
from whisper_aries_tpu_torch.ops.cross_attn import (
    cross_attention_q8,
    quantize_kv_per_position,
)
from whisper_aries_tpu_torch.ops.self_attn import (
    self_attention_q8,
    self_attention_q8_plain,
)
from whisper_aries_tpu_torch.ops.vocab import vocab_product

NEG = float(np.finfo(np.float32).min)


@dataclass(frozen=True)
class WhisperDims:
    """Model hyperparameters (openai/whisper ModelDimensions field order)."""

    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int


#: published checkpoint families (openai/whisper + HF mirrors)
PRESETS: Dict[str, WhisperDims] = {
    "tiny": WhisperDims(80, 1500, 384, 6, 4, 51865, 448, 384, 6, 4),
    "tiny.en": WhisperDims(80, 1500, 384, 6, 4, 51864, 448, 384, 6, 4),
    "base": WhisperDims(80, 1500, 512, 8, 6, 51865, 448, 512, 8, 6),
    "base.en": WhisperDims(80, 1500, 512, 8, 6, 51864, 448, 512, 8, 6),
    "small": WhisperDims(80, 1500, 768, 12, 12, 51865, 448, 768, 12, 12),
    "small.en": WhisperDims(80, 1500, 768, 12, 12, 51864, 448, 768, 12, 12),
    "medium": WhisperDims(80, 1500, 1024, 16, 24, 51865, 448, 1024, 16, 24),
    "medium.en": WhisperDims(80, 1500, 1024, 16, 24, 51864, 448, 1024, 16, 24),
    "large": WhisperDims(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large-v1": WhisperDims(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large-v2": WhisperDims(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large-v3": WhisperDims(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 32),
    "large-v3-turbo": WhisperDims(128, 1500, 1280, 20, 32, 51866, 448, 1280,
                                  20, 4),
    "turbo": WhisperDims(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 4),
}


def sinusoids(length: int, channels: int, max_timescale: float = 10_000.0
              ) -> np.ndarray:
    """openai/whisper's fixed sinusoidal positional table (length, channels)."""
    assert channels % 2 == 0
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(dims: WhisperDims, seed: int = 0, device="cpu",
                dtype=torch.float32) -> Dict[str, Any]:
    """Seeded random parameter tree (random-weight runs and tests): N(0,
    0.02) weights, zero biases, unit LayerNorms, sinusoidal encoder
    positions. Drawn with a torch.Generator on ``device`` so a full-size
    model is made on the card without a host round trip."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def normal(shape, std):
        return (std * torch.randn(shape, generator=g, device=device,
                                  dtype=torch.float32)).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def dense_p(k_in, n_out, layers, bias=True):
        p = {"w": normal((layers, k_in, n_out), 0.02)}
        if bias:
            p["b"] = zeros((layers, n_out))
        return p

    def ln_p(layers, d):
        return {"scale": ones((layers, d)), "bias": zeros((layers, d))}

    def blocks(layers, d, cross):
        b = {
            "ln1": ln_p(layers, d),
            "attn": {"q": dense_p(d, d, layers),
                     "k": dense_p(d, d, layers, bias=False),
                     "v": dense_p(d, d, layers),
                     "o": dense_p(d, d, layers)},
            "ln2": ln_p(layers, d),
            "mlp": {"fc1": dense_p(d, 4 * d, layers),
                    "fc2": dense_p(4 * d, d, layers)},
        }
        if cross:
            b["ln_cross"] = ln_p(layers, d)
            b["cross"] = {"q": dense_p(d, d, layers),
                          "k": dense_p(d, d, layers, bias=False),
                          "v": dense_p(d, d, layers),
                          "o": dense_p(d, d, layers)}
        return b

    da, dt = dims.n_audio_state, dims.n_text_state
    return {
        "encoder": {
            "conv1": {"w": normal((da, dims.n_mels, 3), 0.02),
                      "b": zeros((da,))},
            "conv2": {"w": normal((da, da, 3), 0.02), "b": zeros((da,))},
            "pos_emb": torch.as_tensor(sinusoids(dims.n_audio_ctx, da),
                                       device=device).to(dtype),
            "blocks": blocks(dims.n_audio_layer, da, cross=False),
            "ln_post": {"scale": ones((da,)), "bias": zeros((da,))},
        },
        "decoder": {
            "tok_emb": normal((dims.n_vocab, dt), 0.02),
            "pos_emb": normal((dims.n_text_ctx, dt), 0.01),
            "blocks": blocks(dims.n_text_layer, dt, cross=True),
            "ln": {"scale": ones((dt,)), "bias": zeros((dt,))},
        },
    }


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch view
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_jax(tree: Any, device="cpu") -> Any:
    """The JAX package's parameter tree, leaves as numpy arrays
    (``jax.tree.map(np.asarray, params)``: stacked (L, ...) leaves, dense
    {"w","b"} or quantized {"q","s","b"} dicts), as the port's tree. The
    layouts are shared, so leaves convert one to one."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    if tree is None:
        return None
    return _to_torch(tree, device)


def dims_from_hf_config(cfg) -> WhisperDims:
    """An HF WhisperConfig (object or the dict of config.json) ->
    WhisperDims."""
    get = (cfg.get if isinstance(cfg, dict)
           else lambda k, d=None: getattr(cfg, k, d))
    return WhisperDims(
        n_mels=int(get("num_mel_bins")),
        n_audio_ctx=int(get("max_source_positions")),
        n_audio_state=int(get("d_model")),
        n_audio_head=int(get("encoder_attention_heads")),
        n_audio_layer=int(get("encoder_layers")),
        n_vocab=int(get("vocab_size")),
        n_text_ctx=int(get("max_target_positions")),
        n_text_state=int(get("d_model")),
        n_text_head=int(get("decoder_attention_heads")),
        n_text_layer=int(get("decoder_layers")),
    )


_HF_PROJ = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "out_proj"}


def _hf_entries(dims: WhisperDims, enc: str = "model.encoder",
                dec: str = "model.decoder"):
    """Every leaf of the parameter tree as (tree path, HF key, layers,
    transposed): a key with "{i}" is one layer's slice of a stacked (L,
    ...) leaf (layers = L, else 0); dense weights are stored (out, in) by
    HF and (in, out) here."""
    out = []
    for conv in ("conv1", "conv2"):
        out += [(("encoder", conv, "w"), f"{enc}.{conv}.weight", 0, False),
                (("encoder", conv, "b"), f"{enc}.{conv}.bias", 0, False)]
    out += [(("encoder", "pos_emb"), f"{enc}.embed_positions.weight", 0,
             False),
            (("decoder", "tok_emb"), f"{dec}.embed_tokens.weight", 0, False),
            (("decoder", "pos_emb"), f"{dec}.embed_positions.weight", 0,
             False)]
    for side, pre, ln_top in (("encoder", enc, "ln_post"),
                              ("decoder", dec, "ln")):
        out += [((side, ln_top, "scale"), f"{pre}.layer_norm.weight", 0,
                 False),
                ((side, ln_top, "bias"), f"{pre}.layer_norm.bias", 0, False)]
    for side, pre, n in (("encoder", enc, dims.n_audio_layer),
                         ("decoder", dec, dims.n_text_layer)):
        lp = f"{pre}.layers.{{i}}"
        norms = [("ln1", "self_attn_layer_norm"), ("ln2", "final_layer_norm")]
        dense = [(("attn", k), f"self_attn.{h}", k != "k")
                 for k, h in _HF_PROJ.items()]
        dense += [(("mlp", "fc1"), "fc1", True), (("mlp", "fc2"), "fc2", True)]
        if side == "decoder":
            norms.append(("ln_cross", "encoder_attn_layer_norm"))
            dense += [(("cross", k), f"encoder_attn.{h}", k != "k")
                      for k, h in _HF_PROJ.items()]
        for name, hf in norms:
            out += [((side, "blocks", name, "scale"), f"{lp}.{hf}.weight", n,
                     False),
                    ((side, "blocks", name, "bias"), f"{lp}.{hf}.bias", n,
                     False)]
        for path, hf, bias in dense:
            out.append(((side, "blocks") + path + ("w",), f"{lp}.{hf}.weight",
                        n, True))
            if bias:
                out.append(((side, "blocks") + path + ("b",),
                            f"{lp}.{hf}.bias", n, False))
    return out


def convert_hf_state_dict(sd: Dict[str, Any], dims: WhisperDims,
                          device="cpu", dtype=torch.float32
                          ) -> Dict[str, Any]:
    """An HF WhisperForConditionalGeneration state dict (or a bare
    WhisperModel's, keys without "model.") -> the port's layer-stacked
    tree, the layout of ``init_params`` and ``params_from_jax``. Values are
    torch tensors or numpy arrays (e.g. ``read_safetensors_torch``'s views
    of a mapped file); each is put on ``device`` in its stored dtype and
    cast there, tensor by tensor, into a stacked leaf made on ``device``,
    so no float32 host copy of the model is made."""
    device = torch.device(device)
    enc, dec = "model.encoder", "model.decoder"
    if f"{enc}.conv1.weight" not in sd and "encoder.conv1.weight" in sd:
        enc, dec = "encoder", "decoder"

    def leaf(key: str) -> torch.Tensor:
        v = sd[key]
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))
        moved = t.to(device)
        # never a view of the caller's (mapped) tensor
        return moved.to(dtype, copy=moved is t)

    params: Dict[str, Any] = {}
    for path, key, n, transposed in _hf_entries(dims, enc, dec):
        if n:
            first = leaf(key.format(i=0))
            first = first.T if transposed else first
            out = torch.empty((n,) + tuple(first.shape), dtype=dtype,
                              device=device)
            out[0] = first
            for i in range(1, n):
                t = leaf(key.format(i=i))
                out[i] = t.T if transposed else t
        else:
            out = leaf(key)
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = out
    return params


def hf_state_dict(params: Dict[str, Any], dims: WhisperDims
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_hf_state_dict``: an unfused parameter tree
    -> {WhisperForConditionalGeneration key: tensor}, views of the tree's
    leaves (dense weights transposed back to (out, in))."""
    sd: Dict[str, torch.Tensor] = {}
    for path, key, n, transposed in _hf_entries(dims):
        v = params
        for p in path:
            v = v[p]
        if n:
            for i in range(n):
                sd[key.format(i=i)] = v[i].T if transposed else v[i]
        else:
            sd[key] = v
    return sd


def layer_slice(tree: Any, l: int) -> Any:
    """Layer ``l`` of a stacked (L, ...) subtree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, l) for k, v in tree.items()}
    return tree[l]


def fuse_decoder_qkv(params: Dict[str, Any]) -> Dict[str, Any]:
    """Concatenate the DECODER self-attention q/k/v projections into one
    (d, 3d) layer "qkv" (bit-exact: each output column's product is
    unchanged). Works on {"w","b"} and {"q","s","b"} layers; the k
    projection has no bias, so zeros fill its slot."""
    params = dict(params)
    params["decoder"] = dict(params["decoder"])
    blocks = dict(params["decoder"]["blocks"])
    attn = dict(blocks["attn"])
    if "qkv" in attn:
        return params
    q, k, v = attn.pop("q"), attn.pop("k"), attn.pop("v")
    wkey = "q" if "q" in q else "w"
    fused = {wkey: torch.cat([q[wkey], k[wkey], v[wkey]], dim=-1)}
    if "s" in q:
        fused["s"] = torch.cat([q["s"], k["s"], v["s"]], dim=-1)
    kb = k.get("b")
    if kb is None:
        kb = torch.zeros_like(q["b"])
    fused["b"] = torch.cat([q["b"], kb, v["b"]], dim=-1)
    attn["qkv"] = fused
    blocks["attn"] = attn
    params["decoder"]["blocks"] = blocks
    return params


def _self_qkv(attn: Dict[str, Any], h: torch.Tensor
              ) -> Tuple[torch.Tensor, ...]:
    if "qkv" in attn:
        qkv = dense(attn["qkv"], h)
        d = qkv.shape[-1] // 3
        return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    return (dense(attn["q"], h), dense(attn["k"], h), dense(attn["v"], h))


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    B, T, d = x.shape
    return x.reshape(B, T, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, T, dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * dh)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _conv1d_shifted(p: Dict[str, Any], x: torch.Tensor, stride: int
                    ) -> torch.Tensor:
    """K=3, pad=1 conv1d as K shifted products: x (B, T, Cin), weights
    (Cout, Cin, K) -> (B, T // stride, Cout)."""
    w, b = p["w"], p["b"]
    K = w.shape[2]
    pad = (K - 1) // 2
    t_out = x.shape[1] // stride
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad))
    y = None
    for k in range(K):
        xk = xp[:, k:k + stride * (t_out - 1) + 1:stride]
        yk = torch.matmul(xk, w[:, :, k].T.to(x.dtype))
        y = yk if y is None else y + yk
    return y + b.to(y.dtype)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """(B, H, T, dh) full attention; logits and softmax in f32, probs cast
    to V's dtype (the JAX package's ``_attention_xla``)."""
    dh = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", (q * attn_scale(dh)).float(),
                          k.float())
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


@functools.lru_cache(maxsize=None)
def _attn_fn():
    fn = cb.library("encoder_attn").aries_encoder_attn
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def encoder_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """The encoder-attention kernel (csrc/encoder_attn.cu, TMA + wgmma):
    q, k, v (B, H, T, 64) bf16 contiguous 16-byte-aligned CUDA ->
    (B, H, T, 64) bf16."""
    B, H, T, dh = q.shape
    if dh != 64:
        raise ValueError(f"encoder attention kernel needs dh 64, got {dh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        cb.require(t, name, torch.bfloat16, (B, H, T, dh), q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    cb.launch(_attn_fn(), q, "encoder attention kernel", cb.ptr(q), cb.ptr(k),
              cb.ptr(v), cb.ptr(out), B, H, T)
    cb.count(encoder_attention_kernel)
    return out


encoder_attention_kernel.launches = 0


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The row log-sum-exp (B, H, T) f32 of ``attention_plain``'s logits:
    the plain version of the training forward's second output."""
    dh = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", (q * attn_scale(dh)).float(),
                          k.float())
    return torch.logsumexp(logits, dim=-1)


def attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, dout: torch.Tensor
                             ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of ``attention_plain`` given d(out) ``dout``, by its
    autograd: the plain version of the training backward."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_plain(*leaves)
        return torch.autograd.grad(out, leaves, dout)


@functools.lru_cache(maxsize=None)
def _train_fns():
    lib = cb.library("encoder_attn_train")
    fwd, bwd = lib.aries_attn_train_fwd, lib.aries_attn_train_bwd
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    lib.aries_attn_train_key_tile.argtypes = []
    lib.aries_attn_train_key_tile.restype = ctypes.c_int
    return fwd, bwd, lib.aries_attn_train_key_tile()


#: the training kernels' device kernels, in launch order (csrc/
#: encoder_attn_train.cu ``aries_attn_train_attrs``)
TRAIN_DEVICE_KERNELS = ("attn_fwd_kernel", "attn_delta_kernel",
                        "attn_dkdv_kernel", "attn_dq_sum_kernel")


def encoder_attn_train_attrs(device, B: int, H: int, T: int
                             ) -> Dict[str, Dict[str, int]]:
    """Each training device kernel's compiled attributes on ``device``'s
    card: registers and local (spilled) bytes a thread, static and dynamic
    shared bytes, threads a block, blocks resident an SM, and the blocks of
    the grid it launches at q, k, v (B, H, T, 64)."""
    lib = cb.library("encoder_attn_train")
    fn = lib.aries_attn_train_attrs
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    keys = ("registers", "local_bytes", "static_shared_bytes",
            "dynamic_shared_bytes", "threads", "blocks_an_sm", "blocks")
    n, w = len(TRAIN_DEVICE_KERNELS), len(keys)
    buf = (ctypes.c_int * (w * n))()
    with torch.cuda.device(device):
        got = fn(B, H, T, buf, n)
    if got < 0:
        cb.check(-got, "training attention attributes")
    return {name: dict(zip(keys, buf[w * i: w * i + w]))
            for i, name in enumerate(TRAIN_DEVICE_KERNELS)}


def _require_train(tensors, like: torch.Tensor) -> None:
    B, H, T, dh = like.shape
    if dh != 64:
        raise ValueError(f"training attention kernel needs dh 64, got {dh}")
    for name, t in tensors:
        cb.require(t, name, torch.float32, (B, H, T, dh), like.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def encoder_attn_train_fwd_kernel(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward (csrc/encoder_attn_train.cu): q, k, v (B, H, T,
    64) f32 contiguous CUDA -> out (B, H, T, 64) f32 and the row
    log-sum-exp (B, H, T) f32 its backward reads."""
    _require_train((("q", q), ("k", k), ("v", v)), q)
    B, H, T, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    cb.launch(_train_fns()[0], q, "training attention forward", cb.ptr(q),
              cb.ptr(k), cb.ptr(v), cb.ptr(out), cb.ptr(lse), B, H, T,
              attn_scale(64))
    cb.count(encoder_attn_train_fwd_kernel)
    return out, lse


encoder_attn_train_fwd_kernel.launches = 0


def encoder_attn_train_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, dout: torch.Tensor
                                  ) -> Tuple[torch.Tensor, ...]:
    """The training backward (csrc/encoder_attn_train.cu; one C call, three
    device kernels: D = rowsum(dO * out), dK/dV and each key tile's partial
    dQ by key tiles, then the partials summed in key-tile order) -> (dq,
    dk, dv), each (B, H, T, 64) f32. The partials' scratch is (B H,
    ceil(T / keys a block), T, 64) f32."""
    _require_train((("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)), q)
    B, H, T, _ = q.shape
    cb.require(lse, "lse", torch.float32, (B, H, T), q.device)
    _, bwd, key_tile = _train_fns()
    delta = torch.empty_like(lse)
    part = torch.empty((B * H, -(-T // key_tile), T, 64),
                       dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    cb.launch(bwd, q, "training attention backward", cb.ptr(q), cb.ptr(k),
              cb.ptr(v), cb.ptr(out), cb.ptr(lse), cb.ptr(dout),
              cb.ptr(delta), cb.ptr(part), cb.ptr(dq), cb.ptr(dk),
              cb.ptr(dv), B, H, T, attn_scale(64))
    cb.count(encoder_attn_train_bwd_kernel)
    return dq, dk, dv


encoder_attn_train_bwd_kernel.launches = 0


class EncoderAttentionTrain(torch.autograd.Function):
    """f32 encoder attention on the card with a gradient: the training
    forward saves (q, k, v, out, lse); the backward launches the training
    backward. Nothing falls back to the plain version."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = encoder_attn_train_fwd_kernel(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return encoder_attn_train_bwd_kernel(*ctx.saved_tensors,
                                             dout.contiguous())


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                      ) -> torch.Tensor:
    """The plain version for CPU tensors. On the card: f32 through the
    training kernels (with a gradient), or through the training forward
    alone (compute_type "f32" at inference: no autograd context, no saved
    tensors); bf16 through the encoder-attention kernel, which has no
    backward: a bf16 call that needs a gradient raises."""
    if not q.is_cuda:
        return attention_plain(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if q.dtype == torch.float32:
        if grad:
            return EncoderAttentionTrain.apply(q, k, v)
        return encoder_attn_train_fwd_kernel(q, k, v)[0]
    if grad:
        raise RuntimeError("the bf16 encoder-attention kernel has no "
                           "backward: train with f32 params")
    return encoder_attention_kernel(q, k, v)


def encode(params: Dict[str, Any], mel: torch.Tensor, dims: WhisperDims
           ) -> torch.Tensor:
    """mel (B, n_mels, 2*n_audio_ctx) -> encoded audio (B, n_audio_ctx, D):
    conv stem, sinusoidal positions, pre-LN blocks, final LayerNorm."""
    enc = params["encoder"]
    if mel.ndim == 2:
        mel = mel[None]
    x = mel.transpose(1, 2)
    x = gelu(_conv1d_shifted(enc["conv1"], x, stride=1))
    x = gelu(_conv1d_shifted(enc["conv2"], x, stride=2))
    x = x + enc["pos_emb"][: x.shape[1]].to(x.dtype)
    H = dims.n_audio_head
    for l in range(dims.n_audio_layer):
        p = layer_slice(enc["blocks"], l)
        h = layer_norm(p["ln1"], x)
        q = _split_heads(dense(p["attn"]["q"], h), H)
        k = _split_heads(dense(p["attn"]["k"], h), H)
        v = _split_heads(dense(p["attn"]["v"], h), H)
        att = encoder_attention(q, k, v)
        x = x + dense(p["attn"]["o"], _merge_heads(att).to(x.dtype))
        h = layer_norm(p["ln2"], x)
        x = x + dense(p["mlp"]["fc2"], gelu(dense(p["mlp"]["fc1"], h)))
    return layer_norm(enc["ln_post"], x)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def vocab_logits(dec: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Final LayerNorm + tied-embedding product -> f32 logits (bf16 values
    multiply exactly in f32, so this is the bf16 product with f32
    accumulation), in torch ops that autograd differentiates: the product
    of training. Every product without a gradient goes through
    ``vocab_logits_step`` (``final_logits`` picks)."""
    x = layer_norm(dec["ln"], x)
    return torch.matmul(x.float(), dec["tok_emb"].float().T)


def vocab_logits_step(dec: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """``vocab_logits`` without a gradient: the final LayerNorm, then the
    product with the tied embedding by the vocab kernel (ops/vocab.py: f32
    sums of bf16 products, by the path its plan picks from the row count)
    for bf16 CUDA tensors, by the "f32" library path for f32 ones, its
    plain version for CPU ones (``vocab_logits``'s bits). Decoding,
    language detection, the word pass and the smoke test call it;
    training keeps ``vocab_logits``."""
    emb = dec["tok_emb"]
    if torch.is_grad_enabled() and (x.requires_grad or emb.requires_grad):
        raise RuntimeError("vocab_logits_step has no gradient: "
                           "differentiate vocab_logits")
    h = layer_norm(dec["ln"], x)
    lead = h.shape[:-1]
    return vocab_product(h.reshape(-1, h.shape[-1]), emb).reshape(*lead, -1)


def final_logits(dec: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The teacher-forced passes' logits: ``vocab_logits`` where autograd
    needs the product (grad enabled and x or the embedding requiring it:
    training), else ``vocab_logits_step``, the vocab kernel on the card."""
    if torch.is_grad_enabled() and (x.requires_grad
                                    or dec["tok_emb"].requires_grad):
        return vocab_logits(dec, x)
    return vocab_logits_step(dec, x)


def _teacher_forced(params: Dict[str, Any], tokens: torch.Tensor,
                    xa: torch.Tensor, dims: WhisperDims, on_cross_qk=None
                    ) -> torch.Tensor:
    """The decoder blocks over tokens (B, S) with cross-attention reading
    ``xa`` directly (no cached K/V) -> the last block's x (B, S, D).
    ``on_cross_qk(l, cqk)`` sees each layer's scaled cross-attention logits
    (B, H, S, Ta) f32."""
    dec = params["decoder"]
    B, S = tokens.shape
    H = dims.n_text_head
    dh = dims.n_text_state // H
    x = (dec["tok_emb"][tokens.clamp(min=0)] + dec["pos_emb"][:S]).to(xa.dtype)
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                   device=tokens.device))
    for l in range(dims.n_text_layer):
        p = layer_slice(dec["blocks"], l)
        h = layer_norm(p["ln1"], x)
        qp, kp, vp = _self_qkv(p["attn"], h)
        q, k, v = (_split_heads(t, H) for t in (qp, kp, vp))
        logits = torch.einsum("bhqd,bhkd->bhqk", (q * attn_scale(dh)).float(),
                              k.float())
        logits = torch.where(causal, logits, NEG)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        att = torch.matmul(probs, v)
        x = x + dense(p["attn"]["o"], _merge_heads(att).to(x.dtype))

        h = layer_norm(p["ln_cross"], x)
        q = _split_heads(dense(p["cross"]["q"], h), H)
        ck = _split_heads(dense(p["cross"]["k"], xa), H)
        cv = _split_heads(dense(p["cross"]["v"], xa), H)
        cqk = torch.einsum("bhqd,bhkd->bhqk", (q * attn_scale(dh)).float(),
                           ck.float())
        if on_cross_qk is not None:
            on_cross_qk(l, cqk)
        probs = torch.softmax(cqk, dim=-1).to(cv.dtype)
        att = torch.matmul(probs, cv)
        x = x + dense(p["cross"]["o"], _merge_heads(att).to(x.dtype))

        h = layer_norm(p["ln2"], x)
        x = x + dense(p["mlp"]["fc2"], gelu(dense(p["mlp"]["fc1"], h)))
    return x


def decoder_forward(params: Dict[str, Any], tokens: torch.Tensor,
                    xa: torch.Tensor, dims: WhisperDims) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, S) -> logits (B, S, n_vocab) f32.
    Cross-attention reads ``xa`` directly (no cached K/V)."""
    return final_logits(params["decoder"],
                        _teacher_forced(params, tokens, xa, dims))


def alignment_forward(params: Dict[str, Any], tokens: torch.Tensor,
                      xa: torch.Tensor, head_onehot, dims: WhisperDims
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced pass returning only the alignment heads' cross-
    attention logits and per-position token probabilities (the word-
    timestamp pass, align/word_align.py).

    tokens (B, S) eot-padded past each window; head_onehot (L, N_sel, H)
    one-hot head selectors (numpy or tensor). Returns sel_qk
    (N_sel, B, S, Ta) f32, each selected (layer, head)'s scaled cross-
    attention logits, and token_probs (B, S) f32, p(token_i | tokens_<i)
    with position 0 at 1.0. Layers with no selected head add nothing and
    are skipped; only the (N_sel, B, S, Ta) accumulator outlives a layer."""
    sel = torch.as_tensor(head_onehot, dtype=torch.float32)
    used = (sel.abs().sum(dim=(1, 2)) > 0).tolist()
    sel = sel.to(xa.device)
    B, S = tokens.shape
    acc = torch.zeros((sel.shape[1], B, S, xa.shape[1]), dtype=torch.float32,
                      device=xa.device)

    def take(l, cqk):
        if used[l]:
            acc.add_(torch.einsum("nh,bhqk->nbqk", sel[l], cqk))

    x = _teacher_forced(params, tokens, xa, dims, take)
    logits = final_logits(params["decoder"], x)
    lp = torch.log_softmax(logits, dim=-1)
    nxt = lp[:, :-1].gather(2, tokens[:, 1:, None].long())[..., 0]
    token_probs = torch.cat([torch.ones((B, 1), dtype=torch.float32,
                                        device=xa.device), torch.exp(nxt)],
                            dim=1)
    return acc, token_probs


def init_kv_cache(dims: WhisperDims, batch: int, dtype=torch.float32,
                  max_len: Optional[int] = None, int8: bool = False,
                  device="cpu") -> Dict[str, torch.Tensor]:
    """Self-attention cache for ``decoder_step`` (module docstring)."""
    T = max_len if max_len is not None else dims.n_text_ctx
    H = dims.n_text_head
    dh = dims.n_text_state // H
    L = dims.n_text_layer
    if int8:
        z8 = lambda: torch.zeros((L, batch, H, T, dh), dtype=torch.int8,
                                 device=device)
        zs = lambda: torch.zeros((L, batch, H, T), dtype=torch.float32,
                                 device=device)
        return {"k8": z8(), "ks": zs(), "v8": z8(), "vs": zs()}
    return {"kv": torch.zeros((L, batch, 2, H, T, dh), dtype=dtype,
                              device=device)}


def _quant_slab(x: torch.Tensor, fold: float = 1.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H, dh) -> int8 (B, H, S, dh) + scales (B, H, S) f32
    (multiplied by ``fold``, e.g. 1/sqrt(dh) for K)."""
    q, scale = quantize_kv_per_position(x)           # (B,S,H,dh), (B,S,H)
    return q.transpose(1, 2), (scale * fold).transpose(1, 2)


def precompute_cross_kv(params: Dict[str, Any], xa: torch.Tensor,
                        dims: WhisperDims) -> Dict[str, torch.Tensor]:
    """Cross-attention K/V for every layer, (L, B, H, Ta, dh)."""
    H = dims.n_text_head
    cross = params["decoder"]["blocks"]["cross"]
    ks, vs = [], []
    for l in range(dims.n_text_layer):
        cp = layer_slice(cross, l)
        ks.append(_split_heads(dense(cp["k"], xa), H))
        vs.append(_split_heads(dense(cp["v"], xa), H))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def precompute_cross_kv_int8(params: Dict[str, Any], xa: torch.Tensor,
                             dims: WhisperDims) -> Dict[str, torch.Tensor]:
    """int8 cross K/V with per-position scales, in the layout the
    decoder-layer kernels read: kv8 (L, B, 2, H, Ta, dh) int8, sc
    (L, B, 2, H, Ta) f32, K scales folding 1/sqrt(dh). Filled layer by
    layer, so only one layer's float K/V exists at a time."""
    H = dims.n_text_head
    dh = dims.n_text_state // H
    L = dims.n_text_layer
    B, T, _ = xa.shape
    rsq = attn_scale(dh)
    kv8 = torch.empty((L, B, 2, H, T, dh), dtype=torch.int8, device=xa.device)
    sc = torch.empty((L, B, 2, H, T), dtype=torch.float32, device=xa.device)
    cross = params["decoder"]["blocks"]["cross"]
    for l in range(L):
        cp = layer_slice(cross, l)
        k8, ks = quantize_kv_per_position(_split_heads(dense(cp["k"], xa), H))
        v8, vs = quantize_kv_per_position(_split_heads(dense(cp["v"], xa), H))
        kv8[l, :, 0], kv8[l, :, 1] = k8, v8
        sc[l, :, 0], sc[l, :, 1] = ks * rsq, vs
    return {"kv8": kv8, "sc": sc}


def _cross_attention_step(cp: Dict[str, Any], h: torch.Tensor,
                          kv: Dict[str, torch.Tensor], n_head: int
                          ) -> torch.Tensor:
    """Grouped cross-attention for one decode step or the prefill.

    h (rows, S, D) with rows = Bw * G_beams window-major (the beams of a
    window contiguous) over the Bw windows' cross K/V; the beams and the S
    positions (cross-attention has no causal structure) fold into the
    query group axis, so each window's K/V is read once. int8 K/V go
    through the grouped cross-attention kernel on CUDA tensors."""
    rows, S, D = h.shape
    dh = D // n_head
    Bw = (kv["kv8"] if "kv8" in kv else kv["k"]).shape[0]
    if rows % Bw:
        raise ValueError(f"{rows} rows do not split over {Bw} windows")
    G = (rows // Bw) * S
    q4 = dense(cp["q"], h).reshape(Bw, G, n_head, dh).transpose(1, 2)
    if "kv8" in kv:
        att = cross_attention_q8(q4, kv["kv8"][:, 0], kv["sc"][:, 0],
                                 kv["kv8"][:, 1], kv["sc"][:, 1])
    else:
        logits = torch.einsum("bhgd,bhtd->bhgt", (q4 * attn_scale(dh)).float(),
                              kv["k"].float())
        probs = torch.softmax(logits, dim=-1).to(kv["v"].dtype)
        att = torch.matmul(probs, kv["v"])
    out = att.transpose(1, 2).reshape(rows, S, D).to(h.dtype)
    return dense(cp["o"], out)


def decoder_step(params: Dict[str, Any], tokens: torch.Tensor,
                 pos: Union[int, torch.Tensor],
                 cache: Dict[str, torch.Tensor],
                 cross_kv: Dict[str, torch.Tensor], dims: WhisperDims,
                 valid_start: Union[int, torch.Tensor, None] = None,
                 logits_at: Optional[Sequence[int]] = None
                 ) -> torch.Tensor:
    """One KV-cached decoder call (prefill S>1 or step S=1) on B rows.

    The rows are window-major over the cross K/V's windows: B may be a
    multiple of them (B·K beam rows over B windows), and each window's rows
    share its cross K/V. The cache holds one slot per row
    (``init_kv_cache(dims, B, ...)``).

    tokens (B, S), -1 = left padding; ``pos`` is the cache index of
    tokens[:, 0]. ``valid_start``: index of the first real token of a
    left-padded prompt — cache positions before it are masked and the
    positional embeddings shift by it. Each is an int or a 0-d integer
    tensor on the tokens' device; with tensors the call reads nothing back
    to the host (positions, mask and cache writes are built on the device),
    so it can be captured as a CUDA graph (``UnfusedStepGraph``) and
    replayed at any position. Writes the S new K/V into ``cache`` in place
    and returns logits (B, S, n_vocab) f32, or with ``logits_at`` (indices
    into the S tokens) only those positions' (B, len(logits_at), n_vocab):
    the final LayerNorm and the vocab product run on those rows alone."""
    dec = params["decoder"]
    B, S = tokens.shape
    H = dims.n_text_head
    dh = dims.n_text_state // H
    dev = tokens.device
    int8_cache = "k8" in cache
    Tmax = cache["k8"].shape[3] if int8_cache else cache["kv"].shape[4]
    vs = 0 if valid_start is None else valid_start
    at = pos + torch.arange(S, device=dev)       # cache index of each token
    pos_idx = torch.clamp(at - vs, 0, dims.n_text_ctx - 1)
    x = dec["tok_emb"][tokens.clamp(min=0)] + dec["pos_emb"][pos_idx]
    key_idx = torch.arange(Tmax, device=dev)
    mask = (key_idx[None, :] <= at[:, None]) & (key_idx[None, :] >= vs)
    maskf = torch.where(mask, 0.0, NEG).float()
    rsq = attn_scale(dh)
    blocks = dec["blocks"]
    for l in range(dims.n_text_layer):
        p = layer_slice(blocks, l)
        kv_l = layer_slice(cross_kv, l)
        h = layer_norm(p["ln1"], x)
        qp, kp, vp = _self_qkv(p["attn"], h)
        q = _split_heads(qp, H)                                # (B,H,S,dh)
        k = kp.reshape(B, S, H, dh)
        v = vp.reshape(B, S, H, dh)
        if int8_cache:
            k8s, kss = _quant_slab(k, fold=rsq)
            v8s, vss = _quant_slab(v)
            for key, slab in (("k8", k8s), ("ks", kss), ("v8", v8s),
                              ("vs", vss)):
                cache[key][l].index_copy_(2, at, slab)
            args = (q, cache["k8"][l], cache["ks"][l], cache["v8"][l],
                    cache["vs"][l], maskf)
            # a step goes through the int8 self-attention kernel on the
            # card; the prefill (S > 1) stays plain, as in the JAX package
            att = (self_attention_q8(*args) if S == 1
                   else self_attention_q8_plain(*args))
        else:
            kvc = cache["kv"]
            kvc[l, :, 0].index_copy_(2, at, k.transpose(1, 2).to(kvc.dtype))
            kvc[l, :, 1].index_copy_(2, at, v.transpose(1, 2).to(kvc.dtype))
            logits = torch.einsum("bhsd,bhtd->bhst",
                                  (q * attn_scale(dh)).float(),
                                  kvc[l, :, 0].float()) + maskf
            probs = torch.softmax(logits, dim=-1).to(kvc.dtype)
            att = torch.matmul(probs, kvc[l, :, 1])
        x = x + dense(p["attn"]["o"], _merge_heads(att).to(x.dtype))

        h = layer_norm(p["ln_cross"], x)
        x = x + _cross_attention_step(p["cross"], h, kv_l, H)

        h = layer_norm(p["ln2"], x)
        x = x + dense(p["mlp"]["fc2"], gelu(dense(p["mlp"]["fc1"], h)))
    if logits_at is not None:
        x = x[:, list(logits_at)]
    return vocab_logits_step(dec, x)


decoder_step.graph_replays = 0


class UnfusedStepGraph:
    """One unfused decode step, ``decoder_step`` at S = 1 with its vocab
    product, captured once as a CUDA graph over fixed operands: the
    parameters, the self cache (updated only in place afterwards, as the
    beam reorder does), the cross K/V and ``valid_start``. The tokens and
    the device int32 pair {pos, valid_start} are static buffers written
    before each replay, so no step reads a position on the host.

    A warm-up call runs first, outside the capture (library loads, SM-count
    queries, plans, kernel attributes), at the cache's last position, which
    no decode step reads before writing it. (A decode call's loop graph
    captures the same step inside its iteration, decoding/generate.py;
    this graph replays the step alone, for the checks and profiles.) A
    failed capture or replay raises; nothing falls
    back to eager launches or to the plain versions. The kernels the graph
    records count their launches at each replay (the capture itself runs
    nothing), and ``decoder_step.graph_replays`` counts the replays."""

    def __init__(self, params: Dict[str, Any], cache: Dict[str, torch.Tensor],
                 cross_kv: Dict[str, torch.Tensor], dims: WhisperDims,
                 rows: int, valid_start: int = 0):
        int8_cache = "k8" in cache
        leaf = cache["k8"] if int8_cache else cache["kv"]
        dev = leaf.device
        if dev.type != "cuda":
            raise ValueError("UnfusedStepGraph needs CUDA operands")
        self.T = leaf.shape[3] if int8_cache else leaf.shape[4]
        if not 0 <= valid_start < self.T:
            raise ValueError(f"need 0 <= valid_start < {self.T}")
        self.dev, self.valid_start = dev, valid_start
        self.keep = (params, cache, cross_kv)  # the graph reads their memory
        self.tok = torch.zeros((rows, 1), dtype=torch.long, device=dev)
        self.step = torch.tensor([self.T - 1, valid_start], dtype=torch.int32,
                                 device=dev)

        def step():
            self.logits = decoder_step(params, self.tok, self.step[0], cache,
                                       cross_kv, dims,
                                       valid_start=self.step[1])[:, 0]

        with torch.cuda.device(dev):
            step()  # the warm-up
            torch.cuda.synchronize()
        # the kernels the capture records, counted at each replay (in this
        # thread's record: replicas may launch in other threads meanwhile)
        with cb.recording() as self.launches:
            self.graph = cb.capture(dev, step)

    def run(self, tok: torch.Tensor, pos: int,
            valid_start: Optional[int] = None) -> torch.Tensor:
        """Replay the step on tokens (R,) at ``pos``; returns the graph's
        (R, n_vocab) f32 logits buffer (valid until the next replay).
        ``valid_start`` must be the one the graph was made with (None: that
        one)."""
        if valid_start is not None and valid_start != self.valid_start:
            raise ValueError(f"graph made for valid_start {self.valid_start},"
                             f" got {valid_start}")
        if not self.valid_start <= pos < self.T:
            raise ValueError(f"need {self.valid_start} <= pos < {self.T}")
        self.tok.copy_(tok.reshape(-1, 1))
        self.step[0].fill_(pos)
        with torch.cuda.device(self.dev):
            self.graph.replay()
        cb.add_counts(self.launches)
        cb.bump(decoder_step, "graph_replays")
        return self.logits


# ---------------------------------------------------------------------------
# Speculative verify step
# ---------------------------------------------------------------------------


def multi_token_mask(group: int, n_draft: int, pos, vs, Tmax: int,
                     minor: int, n_groups: int) -> torch.Tensor:
    """(G, S*group, minor) additive f32 mask of the S-token verify step over
    a group-minor cache (m = t*group + j), the JAX package's function: row
    r = s*group + j may attend to window j's positions t <= pos + s (causal
    through the drafted block, appended before it is read), t >= vs,
    t < Tmax. The port's cache is one row a window (group 1); its plain
    self-attention takes each query's live keys from this mask at group 1."""
    S, Kg = n_draft, group
    r = torch.arange(S * Kg)
    m = torch.arange(minor)
    r_s, r_j = (r // Kg)[:, None], (r % Kg)[:, None]
    m_t, m_j = (m // Kg)[None, :], (m % Kg)[None, :]
    ok = (m_j == r_j) & (m_t <= pos + r_s) & (m_t >= vs) & (m_t < Tmax)
    out = torch.where(ok, 0.0, NEG).to(torch.float32)
    return out[None].expand(n_groups, S * Kg, minor)


def decoder_step_fused_multi(params: Dict[str, Any],
                             wpack: Dict[str, torch.Tensor],
                             tokens: torch.Tensor, pos: int,
                             cache: Dict[str, torch.Tensor],
                             cross: Dict[str, torch.Tensor],
                             dims: WhisperDims,
                             valid_start: Optional[int] = None
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The S-token verify step of speculative decode: score S drafted
    tokens a window in one decoder-layer step (the JAX package's
    ``decoder_step_fused_multi``).

    tokens (B, S) int, the drafts of the B windows of ``cross`` (int8 cross
    K/V, ``precompute_cross_kv_int8``); ``pos`` the cache position of
    tokens[:, 0]; ``cache`` the decoder-layer kernels' self cache, one row a
    window ({"kv"} or {"kv8", "ksc"}, (L, B, 2, H, T, dh)), which gets the
    drafts' K/V at pos .. pos + S - 1 in place; ``wpack`` from
    ``ops.decode_layers.pack_layer_weights``. Token s attends over
    [valid_start, pos + s]. Lanes left by drafts an earlier verify rejected
    are rewritten before they are read. Returns (logits (B, S, n_vocab)
    f32, cache). x takes the embedding's dtype: with f32 params (the
    ``compute_type="f32"`` model) the step runs the f32 residual stream (a
    non-int8 cache then f32) and the logits the vocab product's "f32"
    path, as the JAX function's einsum at f32; operands of mixed dtypes
    raise (nothing is cast).

    The JAX function's ``group`` (windows packed into one kernel window
    with a group-minor cache) and ``interpret`` (Pallas interpret mode) are
    TPU layout and TPU mode: the port's kernels take S queries a cache row
    directly (``fused_decoder_layers(..., queries=S)``), on CUDA tensors,
    and the plain version on CPU tensors."""
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    dec = params["decoder"]
    B, S = tokens.shape
    vs = 0 if valid_start is None else int(valid_start)
    at = pos + torch.arange(S, device=tokens.device)
    pos_idx = torch.clamp(at - vs, 0, dims.n_text_ctx - 1)
    x = (dec["tok_emb"][tokens.clamp(min=0)] + dec["pos_emb"][pos_idx][None]
         ).to(dec["tok_emb"].dtype)
    # rows window-major: row b S + s is window b's draft s
    x = DL.fused_decoder_layers(x.reshape(B * S, -1), wpack, cache, cross,
                                vs, pos, dims.n_text_head, queries=S)
    return vocab_logits_step(dec, x).reshape(B, S, -1), cache
