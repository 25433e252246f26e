"""Speaker segmentation and embedding nets (the port of the JAX package's
models/diarize_nets.py), at the shipped widths.

  * ``SegmentationNet``: log-mel (B, 80, F) -> per-20 ms-frame log-probs
    over the 7 powerset classes of <= 2 simultaneously active local speakers
    (pyannote 3.1's output space): a conv stem (stride 2), sinusoidal
    positions and 3 pre-LN transformer blocks (d 128, 4 heads, FFN 512).
  * ``EmbeddingNet``: log-mel of a 2 s crop -> an L2-normalised 192-d
    speaker vector: convs 64 / 128 / 256 (strides 2, 2, 1), attentive
    statistics pooling, a projection.
  * ``melstats_embedding``: the classical long-term mel-statistics
    signature used when no checkpoint loads.

The trained weights are the JAX package's flat safetensors files
(``utils/params_io.py::default_weights_dir``), read by path. The JAX nets
run plain XLA (no Pallas kernel), so these are plain PyTorch ops on the
card: the Whisper model's shifted-product conv, LayerNorm, dense and GeLU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from whisper_aries_tpu_torch.models.layers import dense, gelu, layer_norm
from whisper_aries_tpu_torch.models.whisper import (
    _conv1d_shifted,
    _merge_heads,
    _split_heads,
    attention_plain,
    layer_slice,
    sinusoids,
)
from whisper_aries_tpu_torch.utils.params_io import (
    flatten_params,
    load_params_into,
    unflatten_into,
)

#: the 7 powerset classes over 3 local speakers with <= 2 active
#: (pyannote 3.1's constraint): index -> active-speaker tuple
POWERSET: Tuple[Tuple[int, ...], ...] = (
    (), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2),
)


@dataclass(frozen=True)
class SegDims:
    n_mels: int = 80
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 3
    ffn: int = 512
    n_classes: int = len(POWERSET)


@dataclass(frozen=True)
class EmbDims:
    n_mels: int = 80
    channels: Tuple[int, int, int] = (64, 128, 256)
    kernel: int = 3
    emb_dim: int = 192


def _normal(g: torch.Generator, shape, std: float) -> torch.Tensor:
    return std * torch.randn(shape, generator=g)


def init_segmentation(dims: SegDims = SegDims(), seed: int = 1
                      ) -> Dict[str, Any]:
    """A seeded random segmentation tree in the checkpoint's layout (its
    structure is the template the weights load into)."""
    g = torch.Generator().manual_seed(seed)
    d, L = dims.d_model, dims.n_layers

    def dense_i(k_in, n_out, bias=True):
        p = {"w": _normal(g, (L, k_in, n_out), 0.05)}
        if bias:
            p["b"] = torch.zeros((L, n_out))
        return p

    ln = lambda: {"scale": torch.ones((L, d)), "bias": torch.zeros((L, d))}
    return {
        "conv1": {"w": _normal(g, (d, dims.n_mels, 3), 0.1),
                  "b": torch.zeros((d,))},
        "conv2": {"w": _normal(g, (d, d, 3), 0.1), "b": torch.zeros((d,))},
        "blocks": {
            "ln1": ln(),
            "attn": {"q": dense_i(d, d), "k": dense_i(d, d, bias=False),
                     "v": dense_i(d, d), "o": dense_i(d, d)},
            "ln2": ln(),
            "mlp": {"fc1": dense_i(d, dims.ffn), "fc2": dense_i(dims.ffn, d)},
        },
        "ln_out": {"scale": torch.ones((d,)), "bias": torch.zeros((d,))},
        "head": {"w": _normal(g, (d, dims.n_classes), 0.05),
                 "b": torch.zeros((dims.n_classes,))},
    }


def segmentation_forward(params: Dict[str, Any], mel: torch.Tensor,
                         dims: SegDims = SegDims()) -> torch.Tensor:
    """log-mel (B, n_mels, F) -> per-frame class log-probs (B, F // 2, 7),
    in f32 on the parameters' device."""
    x = mel.float().transpose(1, 2)  # (B, F, n_mels)
    x = gelu(_conv1d_shifted(params["conv1"], x, stride=1))
    x = gelu(_conv1d_shifted(params["conv2"], x, stride=2))
    x = x + torch.as_tensor(sinusoids(x.shape[1], dims.d_model),
                            device=x.device)
    blocks = params["blocks"]
    for l in range(dims.n_layers):
        p = layer_slice(blocks, l)
        h = layer_norm(p["ln1"], x)
        q, k, v = (_split_heads(dense(p["attn"][n], h), dims.n_heads)
                   for n in ("q", "k", "v"))
        x = x + dense(p["attn"]["o"], _merge_heads(attention_plain(q, k, v)))
        h = layer_norm(p["ln2"], x)
        x = x + dense(p["mlp"]["fc2"], gelu(dense(p["mlp"]["fc1"], h)))
    x = layer_norm(params["ln_out"], x)
    return torch.log_softmax(dense(params["head"], x), dim=-1)


def _members() -> np.ndarray:
    members = np.zeros((len(POWERSET), 3), np.float32)
    for ci, ms in enumerate(POWERSET):
        for m in ms:
            members[ci, m] = 1.0
    return members


def powerset_to_multilabel(logp) -> np.ndarray:
    """(B, F, 7) class log-probs -> (B, F, 3) per-speaker activity
    probabilities: a speaker's is the summed probability of the classes
    that contain it."""
    return np.exp(np.asarray(logp)) @ _members()


def powerset_decode(logp, marginal_floor: float = 0.4) -> np.ndarray:
    """(..., 7) class log-probs -> (..., 3) binary per-speaker activity: the
    argmax class's members (pyannote 3.1's rule), united with speakers
    whose summed marginal probability exceeds ``marginal_floor``."""
    logp = np.asarray(logp)
    members = _members()
    hard = members[np.argmax(logp, axis=-1)]
    marginals = np.exp(logp) @ members
    return np.maximum(hard, (marginals > marginal_floor).astype(np.float32))


def init_embedding(dims: EmbDims = EmbDims(), seed: int = 2
                   ) -> Dict[str, Any]:
    """A seeded random embedding tree in the checkpoint's layout."""
    g = torch.Generator().manual_seed(seed)
    convs, c_in = [], dims.n_mels
    for c_out in dims.channels:
        convs.append({"w": _normal(g, (c_out, c_in, dims.kernel), 0.1),
                      "b": torch.zeros((c_out,))})
        c_in = c_out
    c = dims.channels[-1]
    return {
        "convs": convs,
        "proj": {"w": _normal(g, (c, c), 0.1), "b": torch.zeros((c,))},
        "att": {"w": _normal(g, (c, 1), 0.1), "b": torch.zeros((1,))},
        "emb": {"w": _normal(g, (2 * c, dims.emb_dim), 0.1),
                "b": torch.zeros((dims.emb_dim,))},
    }


def embedding_forward(params: Dict[str, Any], mel: torch.Tensor
                      ) -> torch.Tensor:
    """log-mel (B, n_mels, T) -> L2-normalised speaker vectors (B, 192):
    conv frame features (strides 2, 2, 1), attentive statistics pooling
    (attention-weighted mean ++ std), a projection."""
    x = mel.float().transpose(1, 2)  # (B, T, n_mels)
    for i, p in enumerate(params["convs"]):
        x = gelu(_conv1d_shifted(p, x, stride=2 if i < 2 else 1))
    g = torch.tanh(dense(params["proj"], x))
    a = torch.softmax(dense(params["att"], g), dim=1)      # (B, T', 1)
    mu = torch.sum(a * x, dim=1)
    ex2 = torch.sum(a * x * x, dim=1)
    sd = torch.sqrt(torch.relu(ex2 - mu * mu) + 1e-6)
    emb = dense(params["emb"], torch.cat([mu, sd], dim=-1))
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


def melstats_embedding(mel: np.ndarray) -> np.ndarray:
    """The classical speaker signature: (B, n_mels, T) -> (B, 2 * n_mels)
    L2-normalised [mean ++ std] of the log-mel (no learned weights)."""
    m = np.asarray(mel, np.float32)
    emb = np.concatenate([m.mean(axis=2), m.std(axis=2)], axis=1)
    norm = np.linalg.norm(emb, axis=1, keepdims=True)
    return emb / np.maximum(norm, 1e-8)


class _TreeNet(torch.nn.Module):
    """A parameter tree held as the module's (frozen) parameters, so
    ``.parameters()`` and ``.to()`` see it; ``tree()`` gives the nested
    dict the forward functions read."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        flat = flatten_params(tree)
        self._keys = list(flat)
        self._template = tree
        self.weights = torch.nn.ParameterDict({
            k.replace(".", "__"): torch.nn.Parameter(v, requires_grad=False)
            for k, v in flat.items()})

    def tree(self) -> Dict[str, Any]:
        flat = {k: self.weights[k.replace(".", "__")] for k in self._keys}
        return unflatten_into(self._template, flat, convert=lambda t: t)

    @classmethod
    def load(cls, path, device="cpu"):
        """The net with a flat safetensors file's weights on ``device``."""
        return cls(load_params_into(cls.init(), path, device))


class SegmentationNet(_TreeNet):
    init = staticmethod(init_segmentation)

    def __init__(self, tree: Optional[Dict[str, Any]] = None,
                 dims: SegDims = SegDims()):
        super().__init__(tree if tree is not None else init_segmentation(dims))
        self.dims = dims

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return segmentation_forward(self.tree(), mel, self.dims)


class EmbeddingNet(_TreeNet):
    init = staticmethod(init_embedding)

    def __init__(self, tree: Optional[Dict[str, Any]] = None):
        super().__init__(tree if tree is not None else init_embedding())

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return embedding_forward(self.tree(), mel)
