"""Calibrate the diarizer's clustering threshold to the embedding weights.

The counterpart of the JAX repo's ``scripts/calibrate_emb_threshold.py``.
``DiarizationPipeline.NEURAL_THRESHOLD`` (diarize/pipeline.py, 0.53) is
the agglomerative clustering's stopping cosine distance, a property of the
embedding net's cosine geometry, so a retrain can move it. This tool
recomputes it the way the 0.53 was derived: same / different-speaker
pairs of utterances from the synthetic validation batches
(``training/synth.py::embedding_batch`` at seeds 30,000-33,000, 10
speakers x 6 utterances a seed; the trainer's ``_emb_val_metrics``
geometry), their 80-mel log-mels through ``ops/mel.py::log_mel`` (the mel
kernel on the card), the embedding net, then the pairs' cosine distances
swept over 0.05-1.50 in steps of 0.01 for pair-classification accuracy.
It calibrates on this validation set, not on eval/diarize_battery.py,
which stays an untouched test set.

    python -m whisper_aries_tpu_torch.scripts.calibrate_emb_threshold
        [weights_dir] [--device cpu]

``weights_dir`` defaults to the shipped weights (whisper_aries_tpu/
weights/, read by path). It runs on the card unless ``--device cpu``;
without a card and without ``--device cpu`` it raises. The embedding net
runs in f32 with TF32 off.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from whisper_aries_tpu_torch.models.diarize_nets import (
    EmbDims,
    embedding_forward,
    init_embedding,
)
from whisper_aries_tpu_torch.ops.mel import log_mel
from whisper_aries_tpu_torch.training import synth
from whisper_aries_tpu_torch.utils.device import no_tf32, resolve_device
from whisper_aries_tpu_torch.utils.params_io import (
    default_weights_dir,
    load_params_into,
)

#: several disjoint validation scenes for a stable estimate
SEEDS = (30_000, 31_000, 32_000, 33_000)
N_SPK, N_UTT = 10, 6


def load_embedding(weights_dir, device) -> Dict[str, Any]:
    """The embedding net's parameters from ``weights_dir`` on ``device``."""
    return load_params_into(init_embedding(EmbDims()),
                            Path(weights_dir) / "embedding.safetensors",
                            device)


def utterances(seed: int, n_spk: int = N_SPK, n_utt: int = N_UTT
               ) -> np.ndarray:
    """One seed's validation batch: (n_spk * n_utt, samples) f32, speaker
    major."""
    return synth.embedding_batch(np.random.default_rng(seed), n_spk,
                                 n_utt)[0]


def similarities(params: Dict[str, Any], audio: np.ndarray, n_spk: int,
                 n_utt: int, mel_dtype: torch.dtype = torch.float32):
    """(cosine similarities, same-speaker mask) of every pair of the
    utterances ``audio``, upper triangle, row-major. ``mel_dtype`` rounds
    the log-mel before the net (float32: no rounding)."""
    device = params["emb"]["w"].device
    with torch.no_grad(), no_tf32():
        mel = log_mel(torch.as_tensor(audio, device=device), n_mels=80)
        emb = embedding_forward(params, mel.to(mel_dtype).float())
    emb = emb.cpu().numpy().reshape(n_spk * n_utt, -1)
    sims = emb @ emb.T
    same = np.kron(np.eye(n_spk, dtype=bool), np.ones((n_utt, n_utt), bool))
    iu = np.triu_indices(n_spk * n_utt, k=1)
    return sims[iu], same[iu]


def calibrate(params: Dict[str, Any], seeds: Sequence[int] = SEEDS,
              n_spk: int = N_SPK, n_utt: int = N_UTT) -> Dict[str, Any]:
    """The threshold of best pair accuracy over ``seeds``, with the pairs'
    similarities (``sim``, ``same``) and the mean same / different-speaker
    cosines."""
    parts = [similarities(params, utterances(s, n_spk, n_utt), n_spk, n_utt)
             for s in seeds]
    sim = np.concatenate([p[0] for p in parts])
    same = np.concatenate([p[1] for p in parts])
    dist = 1.0 - sim
    best_t, best_acc = 0.0, 0.0
    for t in np.arange(0.05, 1.51, 0.01):
        acc = float(((dist < t) == same).mean())
        if acc > best_acc:
            best_t, best_acc = float(t), acc
    same_cos = float(sim[same].mean())
    diff_cos = float(sim[~same].mean())
    return {"sim": sim, "same": same, "threshold": best_t,
            "accuracy": best_acc, "same_cos": same_cos,
            "diff_cos": diff_cos, "margin": same_cos - diff_cos,
            "midpoint": 1.0 - 0.5 * (same_cos + diff_cos)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("weights_dir", nargs="?", default=None,
                    help="default: the shipped weights")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "calibrate_emb_threshold")
    wdir = args.weights_dir or str(default_weights_dir())
    r = calibrate(load_embedding(wdir, device), SEEDS, N_SPK, N_UTT)
    print(f"weights={wdir}")
    print(f"same_cos={r['same_cos']:.4f} diff_cos={r['diff_cos']:.4f} "
          f"margin={r['margin']:.4f}")
    print(f"calibrated threshold (cosine DISTANCE) = {r['threshold']:.2f} "
          f"pair accuracy = {r['accuracy']:.4f}")
    print(f"midpoint estimate = {r['midpoint']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
