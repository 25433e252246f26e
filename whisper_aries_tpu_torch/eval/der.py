"""Diarization Error Rate (DER) — the standard NIST RT metric (the port's
copy of the JAX package's eval/der.py).

DER = (missed speech + false-alarm speech + speaker confusion) / total
reference speech time, computed frame-wise with an optimal one-to-one
mapping between reference and hypothesis speakers (pyannote.metrics'
DiarizationErrorRate semantics — the metric the reference's pyannote 3.1
stack is scored with). A no-score collar around reference turn boundaries
(NIST default 0.25 s; we default 0.0 for the synthetic battery where
boundaries are exact) is supported.

Inputs are turn lists ``[{"start": s, "end": e, "speaker": name}]`` — the
exact shape DiarizationPipeline returns (diarize/pipeline.py:135-137) and
the golden CSVs use.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Sequence

import numpy as np

FRAME_S = 0.01  # 10 ms scoring frames


def _rasterize(turns: Sequence[Dict[str, Any]], n_frames: int
               ) -> Dict[Any, np.ndarray]:
    """speaker -> (n_frames,) bool activity."""
    out: Dict[Any, np.ndarray] = {}
    for t in turns:
        spk = t["speaker"]
        i0 = max(0, int(round(float(t["start"]) / FRAME_S)))
        i1 = min(n_frames, int(round(float(t["end"]) / FRAME_S)))
        if i1 <= i0:
            continue
        if spk not in out:
            out[spk] = np.zeros(n_frames, bool)
        out[spk][i0:i1] = True
    return out


def _best_mapping(ref: Dict[Any, np.ndarray], hyp: Dict[Any, np.ndarray]
                  ) -> Dict[Any, Any]:
    """Optimal 1:1 ref->hyp speaker assignment (maximum total overlap).

    Exhaustive over permutations up to 7x7 (7! = 5040 — instant, and real
    meetings rarely exceed that); greedy matching beyond.
    """
    rk, hk = list(ref), list(hyp)
    if not rk or not hk:
        return {}
    overlap = np.array([[int((ref[r] & hyp[h]).sum()) for h in hk]
                        for r in rk], np.int64)
    if max(len(rk), len(hk)) <= 7:
        best, best_score = {}, -1
        small, big = (rk, hk) if len(rk) <= len(hk) else (hk, rk)
        for perm in itertools.permutations(range(len(big)), len(small)):
            score = sum(
                overlap[i, perm[i]] if len(rk) <= len(hk)
                else overlap[perm[i], i]
                for i in range(len(small))
            )
            if score > best_score:
                best_score = score
                best = ({rk[i]: hk[perm[i]] for i in range(len(rk))}
                        if len(rk) <= len(hk)
                        else {rk[perm[i]]: hk[i] for i in range(len(hk))})
        return best
    mapping: Dict[Any, Any] = {}
    flat = [(-overlap[i, j], i, j) for i in range(len(rk))
            for j in range(len(hk))]
    used_r, used_h = set(), set()
    for neg, i, j in sorted(flat):
        if neg == 0 or i in used_r or j in used_h:
            continue
        mapping[rk[i]] = hk[j]
        used_r.add(i)
        used_h.add(j)
    return mapping


def diarization_error_rate(
    reference: Sequence[Dict[str, Any]],
    hypothesis: Sequence[Dict[str, Any]],
    collar_s: float = 0.0,
) -> Dict[str, float]:
    """DER + its components for one recording.

    Returns {"der", "miss", "false_alarm", "confusion", "ref_speech_s"} —
    component rates are fractions of total reference speech time, as NIST
    md-eval reports them.
    """
    dur = max(
        [float(t["end"]) for t in reference] +
        [float(t["end"]) for t in hypothesis] + [0.0]
    )
    n = int(np.ceil(dur / FRAME_S)) + 1
    ref = _rasterize(reference, n)
    hyp = _rasterize(hypothesis, n)

    score = np.ones(n, bool)
    if collar_s > 0:
        c = int(round(collar_s / FRAME_S))
        for t in reference:
            for edge in (float(t["start"]), float(t["end"])):
                i = int(round(edge / FRAME_S))
                score[max(0, i - c): i + c] = False

    mapping = _best_mapping(ref, hyp)

    ref_stack = (np.stack(list(ref.values())) if ref
                 else np.zeros((0, n), bool))
    hyp_stack = (np.stack(list(hyp.values())) if hyp
                 else np.zeros((0, n), bool))
    n_ref = ref_stack.sum(axis=0)   # reference speakers active per frame
    n_hyp = hyp_stack.sum(axis=0)
    # frame-wise correct = ref speakers matched to an active mapped hyp
    correct = np.zeros(n, np.int64)
    for r, h in mapping.items():
        correct += (ref[r] & hyp[h]).astype(np.int64)

    n_ref = np.where(score, n_ref, 0)
    n_hyp = np.where(score, n_hyp, 0)
    correct = np.where(score, correct, 0)

    total_ref = float(n_ref.sum()) * FRAME_S
    miss = float(np.maximum(n_ref - n_hyp, 0).sum()) * FRAME_S
    fa = float(np.maximum(n_hyp - n_ref, 0).sum()) * FRAME_S
    conf = float((np.minimum(n_ref, n_hyp) - correct).clip(0).sum()) * FRAME_S
    der = (miss + fa + conf) / total_ref if total_ref > 0 else (
        0.0 if fa == 0 else float("inf")
    )
    return {
        "der": der,
        "miss": miss / total_ref if total_ref else 0.0,
        "false_alarm": fa / total_ref if total_ref else 0.0,
        "confusion": conf / total_ref if total_ref else 0.0,
        "ref_speech_s": total_ref,
    }
