"""Synthetic DER battery for the diarization stack (the port of the JAX
package's eval/diarize_battery.py; its scenes are bit for bit the JAX
package's at one seed).

Generates multi-speaker conversation scenes with exact reference turns
(training/synth.py voices, disjoint from any training draw by seed
offset), optionally passes the audio through the recording-chain
augmentation (training/augment.py — reverb, band-limiting, codec, level;
all label-preserving) and the babble / music / far-field interferers, runs
a diarization pipeline (the port's ``DiarizationPipeline``, on the card
unless ``--device cpu``), and scores DER (eval/der.py).

Run:  python -m whisper_aries_tpu_torch.eval.diarize_battery \
          [--scenes N] [--strength 1.0] [--seed 7000] [--collar 0.25]
          [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from whisper_aries_tpu_torch.eval.der import diarization_error_rate
from whisper_aries_tpu_torch.training import synth

SR = synth.SR


def conversation_scene(
    rng: np.random.Generator,
    dur_s: float = 45.0,
    n_speakers: Optional[int] = None,
    overlap_p: float = 0.25,
    backchannel_p: float = 0.0,
    turn_range: Tuple[float, float] = (1.2, 6.0),
) -> Tuple[np.ndarray, List[Dict[str, Any]]]:
    """(audio, reference turns) — a turn-taking conversation with known
    speaker times. Turn/overlap statistics mirror training's
    diarization_window but at scene scale; adjacent same-speaker turns are
    merged in the reference (matching the pipeline's min_duration_off
    bridging semantics). ``backchannel_p`` adds short in-turn
    interjections by another speaker (real-meeting overlap events) —
    referenced as their own turns, so DER scores them. ``turn_range``
    (0.5, 1.5) measures the short-region embedding weakness
    (ROADMAP: regions < the 2 s embed crop are loop-tiled)."""
    if n_speakers is None:
        n_speakers = int(rng.integers(2, 4))
    voices = [synth.random_voice(rng) for _ in range(n_speakers)]
    n = int(dur_s * SR)
    audio = np.zeros(n, np.float32)
    turns: List[Dict[str, Any]] = []

    t = float(rng.uniform(0.2, 1.5))
    cur = int(rng.integers(0, n_speakers))
    while t < dur_s - 1.0:
        turn = float(rng.uniform(*turn_range))
        i0, i1 = int(t * SR), min(n, int((t + turn) * SR))
        if i1 - i0 > SR // 5:
            seg, _ = synth.synth_utterance(rng, voices[cur],
                                           (i1 - i0) / SR + 1e-4)
            audio[i0:i1] += seg[: i1 - i0]
            turns.append({"start": round(i0 / SR, 3),
                          "end": round(i1 / SR, 3),
                          "speaker": f"REF_{cur}"})
            if (n_speakers > 1 and backchannel_p > 0.0
                    and (i1 - i0) > SR and rng.uniform() < backchannel_p):
                other = int(rng.integers(0, n_speakers))
                other = other if other != cur else (other + 1) % n_speakers
                bdur = float(rng.uniform(0.3, 1.0))
                b0 = int(rng.uniform(i0 / SR + 0.2,
                                     max(i0 / SR + 0.21,
                                         i1 / SR - bdur - 0.1)) * SR)
                b1 = min(i1, b0 + int(bdur * SR))
                if b1 - b0 > SR // 5:
                    bseg, _ = synth.synth_utterance(
                        rng, voices[other], (b1 - b0) / SR + 1e-4,
                        speech_rate=float(rng.uniform(1.0, 1.4)))
                    audio[b0:b1] += bseg[: b1 - b0]
                    turns.append({"start": round(b0 / SR, 3),
                                  "end": round(b1 / SR, 3),
                                  "speaker": f"REF_{other}"})
        if n_speakers > 1 and rng.uniform() < overlap_p:
            t = t + turn * float(rng.uniform(0.7, 0.95))  # overlap
        else:
            t = t + turn + float(rng.uniform(0.2, 1.2))
        if n_speakers > 1:
            nxt = int(rng.integers(0, n_speakers))
            cur = nxt if nxt != cur else (nxt + 1) % n_speakers

    noise_level = float(np.exp(rng.uniform(np.log(0.002), np.log(0.05))))
    audio += noise_level * synth.synth_noise(rng, n)

    # merge adjacent same-speaker turns separated by < 0.2 s
    turns.sort(key=lambda d: d["start"])
    merged: List[Dict[str, Any]] = []
    for t_ in turns:
        if (merged and merged[-1]["speaker"] == t_["speaker"]
                and t_["start"] - merged[-1]["end"] < 0.2):
            merged[-1]["end"] = max(merged[-1]["end"], t_["end"])
        else:
            merged.append(dict(t_))
    return audio.astype(np.float32), merged


def _overlap_stats(ref: List[Dict[str, Any]], dur_s: float
                   ) -> Dict[str, float]:
    """Fraction of reference speech time with >= 2 simultaneous speakers."""
    n = int(dur_s / 0.01)
    count = np.zeros(n, np.int32)
    for t in ref:
        i0 = max(0, int(float(t["start"]) / 0.01))
        i1 = min(n, int(float(t["end"]) / 0.01))
        count[i0:i1] += 1
    speech = count > 0
    over = count >= 2
    return {
        "speech_s": round(float(speech.sum()) * 0.01, 2),
        "overlap_s": round(float(over.sum()) * 0.01, 2),
        "overlap_frac": round(float(over.sum()) / max(speech.sum(), 1), 4),
    }


def _conditions(audio: np.ndarray, k: int, strength: float):
    """The degradation battery: the recording-chain augmentation plus the
    three real-meeting interferers the round-4 review called out as
    missing — babble bed, music bed, far-field/reverb."""
    from whisper_aries_tpu_torch.training.augment import augment

    n = len(audio)
    rng = np.random.default_rng(90_000 + k)
    yield "clean", audio
    yield "augmented", augment(rng, audio, strength=strength)
    bab = synth.synth_noise(np.random.default_rng(91_000 + k), n, "babble")
    yield "babble", (audio + 0.08 * bab).astype(np.float32)
    mus = synth.synth_noise(np.random.default_rng(92_000 + k), n, "music")
    yield "music", (audio + 0.06 * mus).astype(np.float32)
    yield "far_field", synth.apply_far_field(
        np.random.default_rng(93_000 + k), audio)


def run_battery(
    pipeline,
    n_scenes: int = 8,
    seed: int = 7000,
    strength: float = 1.0,
    collar_s: float = 0.25,
    dur_s: float = 45.0,
    backchannel_p: float = 0.0,
    conditions: Optional[List[str]] = None,
    turn_range: Tuple[float, float] = (1.2, 6.0),
) -> Dict[str, Any]:
    """Score ``pipeline`` over the condition battery (clean / recording
    -chain augmented / babble / music / far-field), same scenes (same
    seeds) in every condition so per-condition deltas isolate the
    degradation. ``backchannel_p`` > 0 generates OVERLAPPED scenes
    (in-turn interjections); overlap statistics and overlap-aware DER
    (frame-wise with optimal mapping — eval/der.py) are reported either
    way."""
    reports: List[Dict[str, Any]] = []
    for k in range(n_scenes):
        rng = np.random.default_rng(seed + k)
        audio, ref = conversation_scene(rng, dur_s=dur_s,
                                        backchannel_p=backchannel_p,
                                        turn_range=turn_range)
        row: Dict[str, Any] = {"scene": k,
                               "n_ref_speakers":
                               len({t['speaker'] for t in ref}),
                               "overlap": _overlap_stats(ref, dur_s)}
        for cond, wav in _conditions(audio, k, strength):
            if conditions is not None and cond not in conditions:
                continue
            hyp = pipeline(wav)
            m = diarization_error_rate(ref, hyp, collar_s=collar_s)
            m["n_hyp_speakers"] = len({t["speaker"] for t in hyp})
            row[cond] = m
        reports.append(row)
    conds = [c for c in ("clean", "augmented", "babble", "music",
                         "far_field") if c in reports[0]]
    out: Dict[str, Any] = {
        "scenes": reports,
        "collar_s": collar_s,
        "strength": strength,
        "backchannel_p": backchannel_p,
        "mean_overlap_frac": float(np.mean(
            [r["overlap"]["overlap_frac"] for r in reports])),
    }
    for c in conds:
        out[f"{c}_der"] = float(np.mean([r[c]["der"] for r in reports]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--strength", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=7000)
    ap.add_argument("--collar", type=float, default=0.25)
    ap.add_argument("--duration", type=float, default=45.0)
    ap.add_argument("--backchannel", type=float, default=0.0,
                    help="per-turn in-turn interjection probability "
                         "(overlapped-scene battery; try 0.5)")
    ap.add_argument("--short-turns", dest="short_turns",
                    action="store_true",
                    help="0.5-1.5 s turns (short-region embedding battery)")
    ap.add_argument("--conditions", default=None,
                    help="comma list from clean,augmented,babble,music,"
                         "far_field (default: all)")
    ap.add_argument("--classical", action="store_true",
                    help="score the classical (non-neural) pipeline")
    ap.add_argument("--weights", default=None,
                    help="checkpoint dir (default: shipped weights) — lets "
                         "a retrain be battery-scored before shipping")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for "
                         "the CPU)")
    args = ap.parse_args(argv)

    from whisper_aries_tpu_torch.diarize.pipeline import DiarizationPipeline

    if args.classical:
        # an empty model dir loads no nets -> the classical fallback path
        import tempfile

        pipeline = DiarizationPipeline(model_dir=tempfile.mkdtemp(),
                                       device=args.device)
    else:
        pipeline = DiarizationPipeline(model_dir=args.weights,
                                       device=args.device)
    rep = run_battery(
        pipeline, n_scenes=args.scenes, seed=args.seed,
        strength=args.strength, collar_s=args.collar,
        dur_s=args.duration, backchannel_p=args.backchannel,
        conditions=(args.conditions.split(",") if args.conditions else None),
        turn_range=((0.5, 1.5) if args.short_turns else (1.2, 6.0)))
    print(json.dumps(rep, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
