"""Learned voice-activity detector (the port of models/vad_net.py).

Same contract as vad/energy.py: one speech probability per 512-sample
(32 ms) frame at 16 kHz. Architecture (the shipped vad.safetensors):
  * stem — three strided 1-D convs (stride 8 each), kernel 15, channels
    1 -> 16 -> 32 -> 64, on the RMS-normalised waveform;
  * ctx — three dilated (1, 2, 4) kernel-3 residual convs at frame rate;
  * head — per-frame logistic regression on the 64-d features.

The weights are the JAX package's trained file, read by path with the
port's safetensors reader (utils/params_io.py ``read_safetensors``). The
convolutions run as torch ops with TF32 off: TF32 moves probabilities
across the threshold and changes the window plan.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from whisper_aries_tpu_torch.utils.device import no_tf32
from whisper_aries_tpu_torch.utils.params_io import read_safetensors

FRAME = 512  # samples per probability frame
# Absolute silence gate for the (level-invariant) learned scorer: frames
# quieter than this RMS (~-56 dBFS) are never speech.
SILENCE_RMS_FLOOR = 1.5e-3
#: the trained weights shipped with the JAX package
VAD_WEIGHTS = (Path(__file__).resolve().parents[2] / "whisper_aries_tpu"
               / "weights" / "vad.safetensors")


@dataclass(frozen=True)
class VadDims:
    stem_channels: Tuple[int, int, int] = (16, 32, 64)
    stem_kernel: int = 15
    stem_stride: int = 8
    ctx_layers: int = 3
    ctx_kernel: int = 3
    hidden: int = 64


def init_vad(dims: VadDims = VadDims(), seed: int = 0) -> Dict[str, Any]:
    """A seeded random VAD tree in the checkpoint's layout (the trainer's
    start): N(0, 0.2) stem, N(0, 0.1) context and head weights, zero
    biases, drawn with a torch.Generator on the CPU."""
    g = torch.Generator().manual_seed(seed)
    normal = lambda shape, std: std * torch.randn(shape, generator=g)
    stem, c_in = [], 1
    for c_out in dims.stem_channels:
        stem.append({"w": normal((c_out, c_in, dims.stem_kernel), 0.2),
                     "b": torch.zeros((c_out,))})
        c_in = c_out
    h = dims.hidden
    ctx = [{"w": normal((h, h, dims.ctx_kernel), 0.1),
            "b": torch.zeros((h,))} for _ in range(dims.ctx_layers)]
    head = {"w": normal((h, 1), 0.1), "b": torch.zeros((1,))}
    return {"stem": stem, "ctx": ctx, "head": head}


def load_vad_params(path=VAD_WEIGHTS, device="cpu") -> Dict[str, Any]:
    """vad.safetensors (flat "stem.0.w"-style keys) -> the nested tree."""
    flat = read_safetensors(path)
    t = lambda k: torch.as_tensor(flat[k], device=device)
    n_stem = len({k.split(".")[1] for k in flat if k.startswith("stem.")})
    n_ctx = len({k.split(".")[1] for k in flat if k.startswith("ctx.")})
    return {
        "stem": [{"w": t(f"stem.{i}.w"), "b": t(f"stem.{i}.b")}
                 for i in range(n_stem)],
        "ctx": [{"w": t(f"ctx.{i}.w"), "b": t(f"ctx.{i}.b")}
                for i in range(n_ctx)],
        "head": {"w": t("head.w"), "b": t("head.b")},
    }


def _conv1d(x: torch.Tensor, p: Dict[str, torch.Tensor], stride: int = 1,
            dilation: int = 1) -> torch.Tensor:
    """x (B, C_in, T), weights (C_out, C_in, K), SAME padding."""
    k = p["w"].shape[2]
    span = (k - 1) * dilation
    x = torch.nn.functional.pad(x, (span // 2, span - span // 2))
    return torch.nn.functional.conv1d(x, p["w"], p["b"], stride=stride,
                                      dilation=dilation)


def vad_forward(params: Dict[str, Any], audio: torch.Tensor,
                valid_len: Optional[torch.Tensor] = None,
                stem_stride: int = 8) -> torch.Tensor:
    """audio (B, T) f32 -> speech probabilities (B, T // 512).

    Per-example RMS normalisation; ``valid_len`` (B,) counts the real
    samples of a zero-padded example so the padding does not dilute the
    RMS."""
    x = audio.float()
    if x.ndim == 1:
        x = x[None]
    T = (x.shape[1] // FRAME) * FRAME
    x = x[:, :T]
    denom = (torch.clamp(valid_len.float(), max=T)[:, None]
             if valid_len is not None else torch.tensor(float(T)))
    rms = torch.sqrt((x * x).sum(dim=1, keepdim=True)
                     / torch.clamp(denom, min=1.0))
    x = x / torch.clamp(rms, min=1e-3)
    h = x[:, None, :]
    with no_tf32():
        for p in params["stem"]:
            h = torch.relu(_conv1d(h, p, stride=stem_stride))
        for i, p in enumerate(params["ctx"]):
            h = h + torch.relu(_conv1d(h, p, dilation=2 ** i))
    feats = h.transpose(1, 2)
    logit = feats @ params["head"]["w"] + params["head"]["b"]
    return torch.sigmoid(logit[..., 0])


#: chunk shape of the engine-facing scorer (19.2 s)
_CHUNK_FRAMES = 600
_CHUNK = _CHUNK_FRAMES * FRAME


def make_nn_speech_scorer(params: Dict[str, Any], device="cpu"):
    """Adapter with the vad/energy.py::get_speech_probs contract:
    fn(mono float32 numpy audio) -> (n_frames,) float32 numpy probabilities.
    The file is scored in 19.2 s chunks batched into one call."""
    device = torch.device(device)

    def scorer(audio: np.ndarray) -> np.ndarray:
        a = np.asarray(audio, np.float32)
        n_frames = len(a) // FRAME
        if n_frames == 0:
            return np.zeros((0,), np.float32)
        a = a[: n_frames * FRAME]
        n_chunks = int(np.ceil(len(a) / _CHUNK))
        padded = np.zeros((n_chunks * _CHUNK,), np.float32)
        padded[: len(a)] = a
        valid = np.full((n_chunks,), _CHUNK, np.int32)
        valid[-1] = len(a) - (n_chunks - 1) * _CHUNK
        with torch.no_grad():
            probs = vad_forward(
                params,
                torch.as_tensor(padded.reshape(n_chunks, _CHUNK), device=device),
                torch.as_tensor(valid, device=device))
        probs = probs.reshape(-1)[:n_frames].cpu().numpy().astype(np.float32)
        # the net is level-invariant, so near-digital silence is gated with
        # an absolute per-frame floor
        frame_rms = np.sqrt(
            (a.reshape(n_frames, FRAME).astype(np.float64) ** 2).mean(axis=1)
        ).astype(np.float32)
        return np.where(frame_rms > SILENCE_RMS_FLOOR, probs, 0.0)

    return scorer
