"""Whisper fine-tuning: the loss and a data-parallel train step (the port
of the JAX package's pipeline/train.py).

The JAX step shards the batch on its mesh's "data" axis, replicates the
params, and XLA sums the gradients over the devices. Here the mesh is the
port's list of devices (parallel/mesh.py): each replica computes the sum
of its shard's masked target log-probabilities and backpropagates it over
the global mask count, so the replicas' gradients sum to the gradient of
the JAX loss, -(sum of masked log-probs) / max(count, 1), over the whole
batch. The sum goes to the mesh's first device, where one AdamW update
(``adamw_update``: optax.adamw's arithmetic, written out) runs; every other
device's copy of the params is then overwritten with the result, so all
replicas end with the same bits.

Everything is f32, as the JAX step is (``init_params``' default). On the
card the encoder's attention runs the hand-written training kernels
(csrc/encoder_attn_train.cu, forward and backward); the dense layers, the
conv stem, the decoder's attention and the vocab product are torch
products, with TF32 switched off for the step.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from whisper_aries_tpu_torch.models import whisper as W
from whisper_aries_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    map_shards,
    replicate_params,
)
from whisper_aries_tpu_torch.parallel.mesh import shard_batch as _shard
from whisper_aries_tpu_torch.utils.device import no_tf32
from whisper_aries_tpu_torch.utils.params_io import flatten_params


def masked_logprob_sum(params: Dict[str, Any], mel: torch.Tensor,
                       tokens_in: torch.Tensor, tokens_tgt: torch.Tensor,
                       mask: torch.Tensor, dims: W.WhisperDims
                       ) -> torch.Tensor:
    """sum(log p(target) * mask) over a batch, f32 (the numerator of
    ``cross_entropy_loss``)."""
    xa = W.encode(params, mel, dims)
    logits = W.decoder_forward(params, tokens_in, xa, dims)
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    tgt = logprobs.gather(-1, tokens_tgt.long()[..., None])[..., 0]
    return (tgt * mask).sum()


def cross_entropy_loss(params: Dict[str, Any], mel: torch.Tensor,
                       tokens_in: torch.Tensor, tokens_tgt: torch.Tensor,
                       mask: torch.Tensor, dims: W.WhisperDims
                       ) -> torch.Tensor:
    """The masked mean of -log p(target): mel (B, n_mels, T), tokens_in /
    tokens_tgt (B, S) decoder inputs and shifted targets, mask (B, S) 1.0
    on real positions."""
    s = masked_logprob_sum(params, mel, tokens_in, tokens_tgt, mask, dims)
    return -s / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# AdamW, as optax computes it
# ---------------------------------------------------------------------------


def adamw_init(params: Any) -> Dict[str, Any]:
    """optax.scale_by_adam's state for ``params``: count 0, zero moments,
    each moment leaf on its param's device."""
    flat = flatten_params(params)
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in flat.items()},
            "nu": {k: torch.zeros_like(v) for k, v in flat.items()}}


def adamw_update(params: Any, grads: Dict[str, torch.Tensor],
                 state: Dict[str, Any], learning_rate: float,
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8) -> None:
    """One optax.adamw step (optax.adam at ``weight_decay`` 0) in place on
    ``params`` and ``state``; ``grads`` maps the params' dotted keys to
    their gradients. Per leaf, in optax's order and f32 rounding:
    mu = (1 - b1) g + b1 mu; nu = (1 - b2) g² + b2 nu; count + 1;
    u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps);
    u = u + weight_decay · p (the params before this update);
    p = p + (-learning_rate) · u."""
    count = state["count"] + 1
    c = np.float32(count)
    bc1 = float(np.float32(1) - np.float32(b1) ** c)
    bc2 = float(np.float32(1) - np.float32(b2) ** c)
    with torch.no_grad():
        for k, p in flatten_params(params).items():
            g = grads[k]
            mu, nu = state["mu"][k], state["nu"][k]
            mu.copy_(g * (1 - b1) + mu * b1)
            nu.copy_((g * g) * (1 - b2) + nu * b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            if weight_decay:
                u = u + p * weight_decay
            p.add_(u * -learning_rate)
    state["count"] = count


def opt_state_from_optax(state: Any, device="cpu") -> Dict[str, Any]:
    """An optax ``adamw`` / ``adam`` state (its leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, opt_state)``) -> the port's AdamW state,
    its moments keyed by the params' dotted keys. The state is a chain's
    tuple whose ScaleByAdamState carries count, mu and nu; the others are
    empty."""
    adam = next(s for s in (state if isinstance(state, tuple) else (state,))
                if hasattr(s, "mu") and hasattr(s, "nu"))
    conv = lambda a: torch.tensor(np.asarray(a), device=device)
    return {"count": int(np.asarray(adam.count)),
            "mu": {k: conv(v) for k, v in flatten_params(adam.mu).items()},
            "nu": {k: conv(v) for k, v in flatten_params(adam.nu).items()}}


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_train_step(dims: W.WhisperDims, mesh: Optional[Mesh] = None,
                    learning_rate: float = 1e-5, weight_decay: float = 0.01,
                    timing: bool = False
                    ) -> Tuple[Callable, Callable, Callable]:
    """(init_opt_state, train_step, shard_batch) over ``mesh`` (default:
    every visible card; raises without one).

    train_step(params, opt_state, batch) -> (params, opt_state, loss):
    ``params`` is one tree or ``replicate_params``' list of copies (one a
    mesh entry) and comes back the same, updated in place; ``batch`` is
    {mel, tokens_in, tokens_tgt, mask} (numpy or tensors, cut over the
    mesh here) or ``shard_batch``'s list of shards. ``loss`` is a 0-d f32
    tensor on the mesh's first device. With ``timing`` the step waits for
    the card at its phase boundaries and leaves
    ``train_step.last_stats`` = {forward_s, backward_s, update_s, step_s}
    (the replicas' phases summed)."""
    mesh = make_mesh() if mesh is None else list(mesh)
    home = mesh[0]

    def home_tree(params):
        return params[0] if isinstance(params, list) else params

    def init_opt_state(params):
        return adamw_init(home_tree(params))

    def shard_batch(batch: Dict[str, Any]) -> List[Dict[str, torch.Tensor]]:
        return _shard({k: torch.as_tensor(np.asarray(v)) if not isinstance(
            v, torch.Tensor) else v for k, v in batch.items()}, mesh)

    def train_step(params, opt_state, batch):
        t_step = time.perf_counter()
        replicas = (params if isinstance(params, list)
                    else replicate_params(params, mesh))
        shards = batch if isinstance(batch, list) else shard_batch(batch)
        count = torch.clamp(sum(s["mask"].float().sum().to(home)
                                for s in shards), min=1.0)

        def replica(i, device, lo, hi):
            tree, sh = replicas[i], shards[i]
            if not len(sh["mask"]):
                return None
            flat = flatten_params(tree)
            leaves = list(flat.values())
            for t in leaves:
                t.requires_grad_(True)
            try:
                t0 = time.perf_counter()
                s = masked_logprob_sum(tree, sh["mel"], sh["tokens_in"],
                                       sh["tokens_tgt"], sh["mask"], dims)
                if timing:
                    _sync(device)
                t1 = time.perf_counter()
                grads = torch.autograd.grad(
                    -s / count.to(device), leaves, allow_unused=True,
                    materialize_grads=True)
                if timing:
                    _sync(device)
                times = (t1 - t0, time.perf_counter() - t1)
            finally:
                for t in leaves:
                    t.requires_grad_(False)
            return s.detach(), dict(zip(flat, grads)), times

        with no_tf32():
            # one block a replica: the shards are cut already
            outs = [o for o in map_shards(mesh, len(mesh), replica)
                    if o is not None]
            t2 = time.perf_counter()
            stats = {"forward_s": sum(o[2][0] for o in outs),
                     "backward_s": sum(o[2][1] for o in outs)}
            total = sum(o[0].to(home) for o in outs)
            grads = outs[0][1]
            for o in outs[1:]:
                grads = {k: v + o[1][k].to(home) for k, v in grads.items()}
            del outs
            tree = home_tree(replicas)
            adamw_update(tree, grads, opt_state, learning_rate, weight_decay)
            del grads
            # every other device's copy takes the home copy's bits
            done, new = {home}, flatten_params(tree)
            with torch.no_grad():
                for d, rep in zip(mesh, replicas):
                    if d not in done:
                        done.add(d)
                        for k, p in flatten_params(rep).items():
                            p.copy_(new[k].to(d))
            loss = -total / count
            if timing:
                _sync(home)
        stats["update_s"] = time.perf_counter() - t2
        stats["step_s"] = time.perf_counter() - t_step
        train_step.last_stats = stats
        return params, opt_state, loss

    train_step.last_stats = {}
    return init_opt_state, train_step, shard_batch
