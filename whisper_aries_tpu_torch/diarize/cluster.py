"""Agglomerative clustering of speaker embeddings (the port's copy of the
JAX package's diarize/cluster.py; numpy on the host, as there).

Host-side equivalent of the clustering stage inside pyannote.audio 3.1
(reference SURVEY §2.3 N4: segmentation -> embeddings -> agglomerative
clustering -> SPEAKER_xx labels). Average-linkage AHC on cosine distance
with a stopping threshold, plus optional min/max speaker-count constraints
(reference exposes none, pyannote exposes both).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def cosine_distance_matrix(emb: np.ndarray) -> np.ndarray:
    """(N, D) L2-normalised-safe cosine distance matrix (N, N)."""
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    unit = emb / np.maximum(norms, 1e-10)
    sim = unit @ unit.T
    return 1.0 - np.clip(sim, -1.0, 1.0)


def agglomerative_cluster(
    embeddings: np.ndarray,
    threshold: float = 0.7,
    min_clusters: Optional[int] = None,
    max_clusters: Optional[int] = None,
) -> np.ndarray:
    """Average-linkage AHC; returns int labels (N,).

    Merging stops when the closest pair's average cosine distance exceeds
    ``threshold``, unless constraints force further merging (max_clusters)
    or earlier stopping (min_clusters).
    """
    n = len(embeddings)
    if n == 0:
        return np.zeros((0,), np.int64)
    if n == 1:
        return np.zeros((1,), np.int64)

    dist = cosine_distance_matrix(embeddings)
    # active clusters: mapping cluster -> member indices
    clusters: List[List[int]] = [[i] for i in range(n)]
    # cluster-to-cluster average distances, maintained incrementally
    cd = dist.copy().astype(np.float64)
    np.fill_diagonal(cd, np.inf)
    sizes = np.ones(n)
    active = np.ones(n, bool)

    def n_active() -> int:
        return int(active.sum())

    min_c = max(1, min_clusters or 1)
    max_c = max_clusters or n

    while n_active() > 1:
        masked = np.where(active[:, None] & active[None, :], cd, np.inf)
        i, j = np.unravel_index(np.argmin(masked), masked.shape)
        best = masked[i, j]
        if n_active() <= max_c and (best > threshold and n_active() >= min_c):
            break
        if n_active() <= min_c:
            break
        # merge j into i (average linkage update)
        wi, wj = sizes[i], sizes[j]
        cd[i, :] = (wi * cd[i, :] + wj * cd[j, :]) / (wi + wj)
        cd[:, i] = cd[i, :]
        cd[i, i] = np.inf
        sizes[i] = wi + wj
        active[j] = False
        clusters[i].extend(clusters[j])
        clusters[j] = []

    labels = np.zeros(n, np.int64)
    # stable label order: by earliest member index (=> SPEAKER_00 speaks first)
    live = [c for c in clusters if c]
    live.sort(key=lambda c: min(c))
    for lab, members in enumerate(live):
        for m in members:
            labels[m] = lab
    return labels


def relabel_by_first_appearance(labels: np.ndarray,
                                order: np.ndarray) -> np.ndarray:
    """Renumber labels so SPEAKER_00 is the first to appear in time
    (``order`` = indices sorted by segment start)."""
    mapping = {}
    out = np.zeros_like(labels)
    nxt = 0
    for idx in order:
        lab = labels[idx]
        if lab not in mapping:
            mapping[lab] = nxt
            nxt += 1
    for i, lab in enumerate(labels):
        out[i] = mapping[lab]
    return out
