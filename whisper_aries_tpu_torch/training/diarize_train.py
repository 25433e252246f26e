"""Training loops for the VAD / speaker-segmentation / speaker-embedding nets
(the port of the JAX package's training/diarize_train.py).

Zero-egress training: the corpus is formant-synthesised speech
(training/synth.py, bit for bit the JAX package's at one seed) with
disjoint train/validation speaker draws.

Models + losses:
  * VAD (models/vad_net.py): per-frame BCE on noisy mixtures.
  * SegmentationNet (models/diarize_nets.py): powerset cross-entropy with
    permutation-invariant training (``pit_loss``: min over the 6
    local-speaker permutations — pyannote 3.1's PIT objective on its
    powerset classes), after ``seg_augment`` (random gain, extra noise,
    label-aligned circular 20 ms shifts), drawn from a seeded
    torch.Generator where the JAX step draws from jax.random.
  * EmbeddingNet: GE2E-style softmax contrastive loss over
    (speaker, utterance) batches with exclusive centroids (``ge2e_loss``).

The optimizers are optax's, written out (pipeline/train.py
``adamw_update``): Adam for the VAD and the embedding net, AdamW (weight
decay 1e-4) for the segmentation net. The segmentation and embedding
steps take the log-mels of each batch through ops/mel.py ``log_mel``: the
mel kernel (csrc/mel.cu) on the card, its plain version on the CPU (no
gradient: the audio is data). Every step runs with TF32 off, the VAD's
cuDNN convolutions' backward included.

Run:  python -m whisper_aries_tpu_torch.training.diarize_train \\
          [--target vad|segmentation|embedding|all] [--steps N] [--out DIR]
          [--device cpu]

Checkpoints land as flat safetensors (utils/params_io.py) in the port's
own ``whisper_aries_tpu_torch/trained_weights/`` by default (listed in
.gitignore). The shipped weights the diarizer reads
(``default_weights_dir()``) are never written.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from whisper_aries_tpu_torch.models.diarize_nets import (
    POWERSET,
    EmbDims,
    SegDims,
    embedding_forward,
    init_embedding,
    init_segmentation,
    powerset_to_multilabel,
    segmentation_forward,
)
from whisper_aries_tpu_torch.models.vad_net import (
    VadDims,
    init_vad,
    vad_forward,
)
from whisper_aries_tpu_torch.ops.mel import log_mel
from whisper_aries_tpu_torch.pipeline.train import adamw_init, adamw_update
from whisper_aries_tpu_torch.training import synth
from whisper_aries_tpu_torch.utils.device import no_tf32, resolve_device
from whisper_aries_tpu_torch.utils.params_io import (
    flatten_params,
    read_safetensors,
    save_params,
)

log = logging.getLogger(__name__)

#: the trainer's default output directory (never the shipped weights')
DEFAULT_OUT = Path(__file__).resolve().parents[1] / "trained_weights"

# powerset class index for every (a0, a1, a2) activity triple (<=2 active)
_POWERSET_LOOKUP = np.zeros((2, 2, 2), np.int32)


def _init_lookup():
    for ci, members in enumerate(POWERSET):
        a = [0, 0, 0]
        for m in members:
            a[m] = 1
        _POWERSET_LOOKUP[a[0], a[1], a[2]] = ci


_init_lookup()

_PERMS = list(itertools.permutations(range(3)))  # 6 local-speaker perms


def _maybe_augment(rng: np.random.Generator, audio: np.ndarray,
                   p_aug: float) -> np.ndarray:
    """Recording-chain augmentation (training/augment.py) on a fraction
    ``p_aug`` of examples at full strength; label-preserving, so activity
    targets pass through unchanged."""
    if p_aug <= 0.0 or rng.uniform() >= p_aug:
        return audio
    from whisper_aries_tpu_torch.training.augment import augment

    return augment(rng, audio, strength=1.0)


def _dataset_vad(rng: np.random.Generator, n: int, p_aug: float = 0.0,
                 p_realism: float = 0.0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """``p_realism``: fraction of examples with a music bed mixed in at
    2-20 dB SNR (label-preserving). 0.0 reproduces the original
    distribution draw for draw."""
    xs, ys = [], []
    for _ in range(n):
        a, l = synth.vad_example(rng)
        if p_realism > 0.0 and rng.uniform() < p_realism:
            snr_db = rng.uniform(2.0, 20.0)
            mus = synth.synth_noise(rng, len(a), "music")
            a = (a + (max(a.std(), 1e-4) / 10 ** (snr_db / 20.0)) * mus
                 ).astype(np.float32)
        xs.append(_maybe_augment(rng, a, p_aug))
        ys.append(l)
    return np.stack(xs), np.stack(ys)


def _dataset_seg(rng: np.random.Generator, n: int, p_aug: float = 0.0,
                 p_realism: float = 0.0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """``p_realism``: fraction of windows from the realism mix (boosted
    turn-start overlap + back-channel interjections, a third of them with
    a music bed or far-field reverb). 0.0 reproduces the original
    distribution draw for draw."""
    xs, ys = [], []
    for _ in range(n):
        if p_realism > 0.0 and rng.uniform() < p_realism:
            a, act = synth.diarization_window(
                rng, overlap_p=0.5, backchannel_p=0.35)
            deg = rng.uniform()
            if deg < 0.18:
                a = (a + 0.06 * synth.synth_noise(rng, len(a), "music")
                     ).astype(np.float32)
            elif deg < 0.33:
                a = synth.apply_far_field(rng, a)
        else:
            a, act = synth.diarization_window(rng)
        xs.append(_maybe_augment(rng, a, p_aug))
        ys.append(act)
    return np.stack(xs), np.stack(ys)


def _on(tree: Any, device) -> Any:
    """A tree of dicts and lists of tensors, moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on(v, device) for v in tree)
    return tree.to(device)


def _adam_step(params: Any, opt: Dict[str, Any],
               loss_fn: Callable[[Any], torch.Tensor], lr: float,
               weight_decay: float = 0.0) -> torch.Tensor:
    """loss_fn(params), its gradient for every leaf, one optax-order
    Adam(W) update in place; returns the loss (detached)."""
    flat = flatten_params(params)
    leaves = list(flat.values())
    for t in leaves:
        t.requires_grad_(True)
    try:
        with no_tf32():
            loss = loss_fn(params)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    adamw_update(params, dict(zip(flat, grads)), opt, lr, weight_decay)
    return loss.detach()


def _mels(audio: torch.Tensor) -> torch.Tensor:
    """80-mel Whisper features of audio (B, N) on its device: the mel
    kernel on the card, the plain version on the CPU."""
    with torch.no_grad():
        return log_mel(audio, n_mels=80)


# ---------------------------------------------------------------------------
# VAD
# ---------------------------------------------------------------------------


def vad_loss(params: Dict[str, Any], audio: torch.Tensor,
             labels: torch.Tensor, dims: VadDims = VadDims()
             ) -> torch.Tensor:
    """Per-frame BCE of the clipped speech probabilities."""
    probs = vad_forward(params, audio, stem_stride=dims.stem_stride)
    probs = torch.clamp(probs, 1e-6, 1 - 1e-6)
    bce = -(labels * torch.log(probs) + (1 - labels) * torch.log(1 - probs))
    return bce.mean()


def _vad_probs(params, X: np.ndarray, device) -> np.ndarray:
    with torch.no_grad(), no_tf32():
        return vad_forward(params, torch.as_tensor(X, device=device)
                           ).cpu().numpy()


def train_vad(steps: int = 600, batch: int = 32, lr: float = 1e-3,
              seed: int = 0, n_train: int = 768, n_val: int = 128,
              log_every: int = 50, p_aug: float = 0.0,
              p_realism: float = 0.0, device=None
              ) -> Tuple[Dict[str, Any], Dict[str, float]]:
    device = resolve_device(device, "train_vad")
    rng = np.random.default_rng(seed)
    rng_val = np.random.default_rng(10_000 + seed)
    log.info("VAD: generating %d train / %d val examples (p_aug=%.2f, "
             "p_realism=%.2f)...", n_train, n_val, p_aug, p_realism)
    X, Y = _dataset_vad(rng, n_train, p_aug=p_aug, p_realism=p_realism)
    Xv, Yv = _dataset_vad(rng_val, n_val)  # gate val stays clean
    Xa, Ya = _dataset_vad(np.random.default_rng(40_000 + seed), n_val,
                          p_aug=1.0)  # augmented robustness battery
    Xm, Ym = _dataset_vad(np.random.default_rng(70_000 + seed), n_val,
                          p_realism=1.0)  # music-bed validation draw

    dims = VadDims()
    params = _on(init_vad(dims), device)
    opt = adamw_init(params)
    Xd, Yd = torch.as_tensor(X, device=device), torch.as_tensor(Y, device=device)
    losses: List[float] = []
    t0 = time.time()
    for s in range(steps):
        idx = torch.as_tensor(rng.integers(0, n_train, batch), device=device)
        l = _adam_step(params, opt, lambda p: vad_loss(p, Xd[idx], Yd[idx],
                                                       dims), lr)
        losses.append(float(l))
        if s % log_every == 0 or s == steps - 1:
            log.info("vad step %d loss %.4f (%.1fs)", s, losses[-1],
                     time.time() - t0)

    # validation: frame accuracy vs the classical energy scorer
    from whisper_aries_tpu_torch.vad.energy import get_speech_probs

    probs = _vad_probs(params, Xv, device)
    acc_nn = float((((probs > 0.5) == (Yv > 0.5))).mean())
    acc_energy = float(np.mean([
        ((get_speech_probs(Xv[i]) > 0.5) == (Yv[i] > 0.5)).mean()
        for i in range(n_val)
    ]))
    acc_aug = float((((_vad_probs(params, Xa, device) > 0.5)
                      == (Ya > 0.5))).mean())
    acc_mus = float((((_vad_probs(params, Xm, device) > 0.5)
                      == (Ym > 0.5))).mean())
    metrics = {"val_acc": acc_nn, "val_acc_energy_baseline": acc_energy,
               "val_acc_augmented": acc_aug, "val_acc_music": acc_mus,
               "p_aug": p_aug, "p_realism": p_realism, "losses": losses}
    log.info("VAD val acc: nn=%.4f energy=%.4f augmented=%.4f music=%.4f",
             acc_nn, acc_energy, acc_aug, acc_mus)
    return params, metrics


# ---------------------------------------------------------------------------
# Segmentation (powerset + PIT)
# ---------------------------------------------------------------------------

HOP = 320  # samples per 20 ms label frame


def seg_augment(audio: torch.Tensor, act: torch.Tensor,
                gen: torch.Generator, gain=(0.5, 1.6), noise=(0.0, 0.015)
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augmentation against memorising the fixed corpus, the JAX step's
    distributions: a gain U(gain) and a noise level U(noise) an example,
    Gaussian noise at that level, and a circular shift of k ~ U{0..F-1}
    label frames (audio by k * 320 samples, labels by k frames), drawn
    from ``gen`` (on the audio's device)."""
    B, N = audio.shape
    F = act.shape[1]
    dev = audio.device
    g = gain[0] + (gain[1] - gain[0]) * torch.rand((B, 1), generator=gen,
                                                   device=dev)
    n = noise[0] + (noise[1] - noise[0]) * torch.rand((B, 1), generator=gen,
                                                      device=dev)
    audio = audio * g + n * torch.randn(audio.shape, generator=gen,
                                        device=dev)
    k = torch.randint(0, F, (B,), generator=gen, device=dev)
    # jnp.roll(x, s)[i] = x[(i - s) mod n]
    ia = (torch.arange(N, device=dev)[None] - k[:, None] * HOP) % N
    ic = (torch.arange(F, device=dev)[None] - k[:, None]) % F
    audio = audio.gather(1, ia)
    act = act.gather(1, ic[:, :, None].expand(-1, -1, act.shape[2]))
    return audio, act


def pit_loss(params: Dict[str, Any], audio: torch.Tensor, act: torch.Tensor,
             dims: SegDims = SegDims()) -> torch.Tensor:
    """The powerset cross-entropy of each example under its best local
    speaker permutation, averaged: audio (B, 160000) 10 s windows (already
    augmented), act (B, 500, 3) activity."""
    mel = _mels(audio)                            # (B, 80, 1000)
    logp = segmentation_forward(params, mel, dims)  # (B, 500, 7)
    a = act.long()
    lookup = torch.as_tensor(_POWERSET_LOOKUP, device=audio.device).long()
    ces = []
    for perm in _PERMS:
        ap = a[:, :, list(perm)]
        cls = lookup[ap[..., 0], ap[..., 1], ap[..., 2]]   # (B, F)
        ces.append(-logp.gather(-1, cls[..., None])[..., 0].mean(dim=1))
    return torch.stack(ces).min(dim=0).values.mean()


def train_segmentation(steps: int = 2500, batch: int = 16, lr: float = 3e-4,
                       seed: int = 1, n_train: int = 1536, n_val: int = 96,
                       log_every: int = 100, p_aug: float = 0.0,
                       p_realism: float = 0.0, device=None
                       ) -> Tuple[Dict[str, Any], Dict[str, float]]:
    device = resolve_device(device, "train_segmentation")
    rng = np.random.default_rng(seed)
    rng_val = np.random.default_rng(20_000 + seed)
    log.info("SEG: generating %d train / %d val windows (p_aug=%.2f, "
             "p_realism=%.2f)...", n_train, n_val, p_aug, p_realism)
    X, Y = _dataset_seg(rng, n_train, p_aug=p_aug, p_realism=p_realism)
    Xv, Yv = _dataset_seg(rng_val, n_val)      # gate val stays clean
    Xa, Ya = _dataset_seg(np.random.default_rng(50_000 + seed), n_val,
                          p_aug=1.0)           # augmented robustness battery
    Xo, Yo = _dataset_seg(np.random.default_rng(60_000 + seed), n_val,
                          p_realism=1.0)       # overlap-heavy draw

    dims = SegDims()
    params = _on(init_segmentation(dims), device)
    opt = adamw_init(params)
    gen = torch.Generator(device=device).manual_seed(seed)
    Xd, Yd = torch.as_tensor(X, device=device), torch.as_tensor(Y, device=device)
    losses: List[float] = []
    t0 = time.time()
    for s in range(steps):
        idx = torch.as_tensor(rng.integers(0, n_train, batch), device=device)
        audio, act = seg_augment(Xd[idx], Yd[idx], gen)
        l = _adam_step(params, opt, lambda p: pit_loss(p, audio, act, dims),
                       lr, weight_decay=1e-4)
        losses.append(float(l))
        if s % log_every == 0 or s == steps - 1:
            log.info("seg step %d loss %.4f (%.1fs)", s, losses[-1],
                     time.time() - t0)

    metrics = _seg_val_metrics(params, Xv, Yv, dims)
    aug = _seg_val_metrics(params, Xa, Ya, dims)
    over = _seg_val_metrics(params, Xo, Yo, dims)
    metrics["val_frame_acc_augmented"] = aug["val_frame_acc"]
    metrics["val_f1_augmented"] = aug["val_f1"]
    metrics["val_frame_acc_overlap"] = over["val_frame_acc"]
    metrics["val_f1_overlap"] = over["val_f1"]
    metrics["p_aug"] = p_aug
    metrics["p_realism"] = p_realism
    metrics["losses"] = losses
    log.info("SEG val best-perm frame acc: %.4f  active-frame F1: %.4f  "
             "(augmented: acc %.4f F1 %.4f; overlap: acc %.4f F1 %.4f)",
             metrics["val_frame_acc"], metrics["val_f1"],
             aug["val_frame_acc"], aug["val_f1"],
             over["val_frame_acc"], over["val_f1"])
    return params, metrics


def _seg_val_metrics(params, Xv, Yv, dims) -> Dict[str, float]:
    """Best-permutation frame accuracy and active-frame F1 (plain frame
    accuracy is dominated by empty slots; F1 over active frames catches a
    collapsed net)."""
    device = flatten_params(params)["head.w"].device
    accs, f1s = [], []
    for i in range(0, len(Xv), 16):
        mel = _mels(torch.as_tensor(Xv[i: i + 16], device=device))
        with torch.no_grad(), no_tf32():
            logp = segmentation_forward(params, mel, dims)
        ml = powerset_to_multilabel(logp.cpu().numpy()) > 0.5
        want = Yv[i: i + 16] > 0.5
        for b in range(ml.shape[0]):
            best_acc, best_f1 = 0.0, 0.0
            for p in _PERMS:
                pred = ml[b][:, list(p)]
                acc = (pred == want[b]).mean()
                tp = (pred & want[b]).sum()
                denom = pred.sum() + want[b].sum()
                f1 = (2.0 * tp / denom) if denom else 1.0
                if acc > best_acc:
                    best_acc, best_f1 = acc, f1
            accs.append(best_acc)
            f1s.append(best_f1)
    return {"val_frame_acc": float(np.mean(accs)),
            "val_f1": float(np.mean(f1s))}


# ---------------------------------------------------------------------------
# Embedding (GE2E-style)
# ---------------------------------------------------------------------------


def ge2e_loss(params: Dict[str, Any], audio: torch.Tensor, n_spk: int,
              n_utt: int, scale: float = 10.0, bias: float = -5.0
              ) -> torch.Tensor:
    """GE2E softmax loss of (S * U, N) utterances, speaker-major: cosine
    similarity to each speaker's centroid (the own speaker's exclusive of
    the utterance), scaled and biased, cross-entropy to the speaker."""
    emb = embedding_forward(params, _mels(audio))   # (S*U, D) L2-normed
    e = emb.reshape(n_spk, n_utt, -1)
    cent = e.mean(dim=1)
    cent = cent / torch.linalg.vector_norm(cent, dim=-1, keepdim=True)
    excl = (e.sum(dim=1, keepdim=True) - e) / (n_utt - 1)
    excl = excl / torch.linalg.vector_norm(excl, dim=-1, keepdim=True)
    sim = torch.einsum("sud,kd->suk", e, cent)      # (S, U, S)
    own = torch.einsum("sud,sud->su", e, excl)      # (S, U)
    eye = torch.eye(n_spk, dtype=torch.bool, device=audio.device)
    sim = torch.where(eye[:, None, :], own[:, :, None], sim)
    logp = torch.log_softmax(scale * sim + bias, dim=-1)
    labels = torch.arange(n_spk, device=audio.device)[:, None].expand(
        n_spk, n_utt)
    return -logp.gather(-1, labels[..., None]).mean()


def train_embedding(steps: int = 700, n_spk: int = 12, n_utt: int = 4,
                    lr: float = 3e-4, seed: int = 2, log_every: int = 50,
                    n_batches: int = 48, p_aug: float = 0.0, device=None
                    ) -> Tuple[Dict[str, Any], Dict[str, float]]:
    device = resolve_device(device, "train_embedding")
    rng = np.random.default_rng(seed)
    log.info("EMB: generating %d contrastive batches (%dx%d utts)...",
             n_batches, n_spk, n_utt)
    # channel augmentation applies per utterance (each row its own chain)
    batches = []
    for _ in range(n_batches):
        rows = synth.embedding_batch(rng, n_spk, n_utt)[0]
        if p_aug > 0.0:
            rows = np.stack([_maybe_augment(rng, r, p_aug) for r in rows])
        batches.append(torch.as_tensor(rows, device=device))

    params = _on(init_embedding(EmbDims()), device)
    opt = adamw_init(params)
    losses: List[float] = []
    t0 = time.time()
    for s in range(steps):
        audio = batches[int(rng.integers(0, len(batches)))]
        l = _adam_step(params, opt, lambda p: ge2e_loss(p, audio, n_spk,
                                                        n_utt), lr)
        losses.append(float(l))
        if s % log_every == 0 or s == steps - 1:
            log.info("emb step %d loss %.4f (%.1fs)", s, losses[-1],
                     time.time() - t0)

    metrics = _emb_val_metrics(params, seed=30_000 + seed)
    metrics["losses"] = losses
    log.info("EMB val: same=%.3f diff=%.3f margin=%.3f",
             metrics["same_cos"], metrics["diff_cos"], metrics["margin"])
    return params, metrics


def _emb_val_metrics(params, seed: int, n_spk: int = 10, n_utt: int = 6
                     ) -> Dict[str, float]:
    device = flatten_params(params)["emb.w"].device
    rng = np.random.default_rng(seed)
    audio, _ = synth.embedding_batch(rng, n_spk, n_utt)
    with torch.no_grad(), no_tf32():
        emb = embedding_forward(params, _mels(torch.as_tensor(
            audio, device=device))).cpu().numpy().reshape(n_spk, n_utt, -1)
    sims = emb.reshape(n_spk * n_utt, -1) @ emb.reshape(n_spk * n_utt, -1).T
    same_mask = np.kron(np.eye(n_spk, dtype=bool),
                        np.ones((n_utt, n_utt), bool))
    np.fill_diagonal(sims, np.nan)
    same = np.nanmean(np.where(same_mask, sims, np.nan))
    diff = np.nanmean(np.where(~same_mask, sims, np.nan))
    return {"same_cos": float(same), "diff_cos": float(diff),
            "margin": float(same - diff)}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _save_verified(path: str, params) -> None:
    """save_params + a byte-level read-back check: a host copy of every leaf
    (C order, a deep copy) is written, read back with the port's reader and
    compared byte for byte; a mismatch retries the copy and the write, and
    raises after 3 attempts."""
    last_err = "unknown"
    for attempt in range(3):
        host = {k: np.array(v.detach().cpu().numpy(), copy=True, order="C")
                for k, v in flatten_params(params).items()}
        save_params(path, host)
        back = read_safetensors(path)
        if set(back) != set(host):
            last_err = "key mismatch"
            continue
        ok = True
        for k, a in host.items():
            b = back[k]
            # byte compare, not array_equal: NaN != NaN would false-alarm
            if a.dtype != b.dtype or a.shape != b.shape \
                    or a.tobytes() != b.tobytes():
                last_err = (f"{k}: dtype {a.dtype}/{b.dtype} shape "
                            f"{a.shape}/{b.shape}")
                log.warning("checkpoint read-back mismatch (attempt %d) "
                            "for %s — %s; retrying", attempt, path, last_err)
                ok = False
                break
        if ok:
            return
    raise RuntimeError(
        f"checkpoint read-back mismatch for {path} after 3 attempts: "
        f"{last_err}")


def _without_losses(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """A trainer's metrics as TRAINING.json keeps them (the JAX keys; the
    per-step losses stay with the caller)."""
    return {k: v for k, v in metrics.items() if k != "losses"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Train the VAD / diarization nets on synthetic speech"
    )
    p.add_argument("--target", default="all",
                   choices=["vad", "segmentation", "embedding", "all"])
    p.add_argument("--steps", type=int, default=None,
                   help="override per-model default step counts")
    p.add_argument("--out", default=None,
                   help="output dir (default: whisper_aries_tpu_torch/"
                        "trained_weights/)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--augment", type=float, default=0.0, metavar="P",
                   help="fraction of train examples passed through the "
                        "recording-chain augmentation (training/augment.py)")
    p.add_argument("--realism", type=float, default=0.0, metavar="P",
                   help="fraction of train examples from the realism mix "
                        "(seg: overlap/backchannel/music/far-field; vad: "
                        "music beds)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for "
                        "the CPU)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device, "diarize_train")
    out = args.out or str(DEFAULT_OUT)

    all_metrics: Dict[str, Dict[str, float]] = {}
    if args.target in ("vad", "all"):
        params, m = train_vad(steps=args.steps or 600, seed=args.seed,
                              p_aug=args.augment, p_realism=args.realism,
                              device=device)
        _save_verified(f"{out}/vad.safetensors", params)
        all_metrics["vad"] = _without_losses(m)
    if args.target in ("segmentation", "all"):
        params, m = train_segmentation(steps=args.steps or 800,
                                       seed=args.seed + 1,
                                       p_aug=args.augment,
                                       p_realism=args.realism, device=device)
        _save_verified(f"{out}/segmentation.safetensors", params)
        all_metrics["segmentation"] = _without_losses(m)
    if args.target in ("embedding", "all"):
        params, m = train_embedding(steps=args.steps or 700,
                                    seed=args.seed + 2, p_aug=args.augment,
                                    device=device)
        _save_verified(f"{out}/embedding.safetensors", params)
        all_metrics["embedding"] = _without_losses(m)

    mpath = Path(out) / "TRAINING.json"
    existing = {}
    if mpath.exists():
        existing = json.loads(mpath.read_text())
    existing.update(all_metrics)
    mpath.parent.mkdir(parents=True, exist_ok=True)
    mpath.write_text(json.dumps(existing, indent=2))
    print(json.dumps(all_metrics, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
