"""Speaker diarization: audio -> [{start, end, speaker: SPEAKER_xx}].

The port of the JAX package's diarize/pipeline.py (itself the replacement
of the pyannote.audio 3.1 pipeline the reference runs at
conversation_transcriber.py:85-98), with the same output contract and the
same (start, end, speaker) dedupe (speaker_diarizer.py:143-162).

Two modes, chosen by what loads:
  * **Neural** (segmentation.safetensors / embedding.safetensors, by
    default the trained files that ship with the JAX package): the
    segmentation net finds per-frame speaker activity in 10 s windows, the
    embedding net embeds each active region, average-linkage clustering
    merges local speakers into global ones. Both nets run on the device, a
    batch of windows and all regions' crops at once; the 80-mel front end
    runs on the host (numpy), as in the JAX package.
  * **Classical** (no checkpoint): VAD speech regions cut into 2 s
    subsegments, embedded with long-term mel statistics, clustered the
    same way.

Device: CUDA unless the caller passes ``device="cpu"``; with no card and no
explicit CPU the constructor raises. The nets' uploads and forward calls
hold the device's lock (``utils/device.py::on_card``), which the engines hold
around their card work, so jobs in threads take turns on the card.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from whisper_aries_tpu_torch.audio.decode import SAMPLE_RATE, load_audio
from whisper_aries_tpu_torch.audio.mel import log_mel_spectrogram_np
from whisper_aries_tpu_torch.diarize.cluster import (
    agglomerative_cluster,
    relabel_by_first_appearance,
)
from whisper_aries_tpu_torch.models.diarize_nets import (
    EmbeddingNet,
    SegmentationNet,
    melstats_embedding,
    powerset_decode,
)
from whisper_aries_tpu_torch.utils.device import on_card, resolve_device
from whisper_aries_tpu_torch.utils.params_io import default_weights_dir
from whisper_aries_tpu_torch.vad import (
    VadOptions,
    collect_speech_segments,
    get_speech_probs,
)

log = logging.getLogger(__name__)

SUBSEG_S = 2.0     # embedding subsegment length
SUBSEG_HOP_S = 1.0


class DiarizationPipeline:
    """Callable like pyannote's ``Pipeline``: ``pipeline(audio)`` -> turns."""

    #: agglomerative-clustering thresholds (cosine distance) per embedding
    #: space: the trained net's (calibrated on the JAX package's synthetic
    #: battery) and pyannote's WeSpeaker value for the classical signature
    NEURAL_THRESHOLD = 0.53
    CLASSICAL_THRESHOLD = 0.7045654963945799
    #: centroid-refinement iterations after clustering (0: off, the JAX
    #: package's default)
    REFINE_ITERS = 0
    #: segmentation windows a forward call (bounds the attention's memory)
    SEG_BATCH = 64

    def __init__(
        self,
        model_dir: Optional[str] = None,
        clustering_threshold: Optional[float] = None,
        vad_options: Optional[VadOptions] = None,
        refine_iters: Optional[int] = None,
        device: Optional[str] = None,
    ):
        self.device = resolve_device(device, "DiarizationPipeline")
        self.refine_iters = (refine_iters if refine_iters is not None
                             else self.REFINE_ITERS)
        self.clustering_threshold = clustering_threshold
        self.vad_options = vad_options or VadOptions(min_silence_duration_ms=300)
        self.seg_net: Optional[SegmentationNet] = None
        self.emb_net: Optional[EmbeddingNet] = None
        self._try_load(Path(model_dir) if model_dir is not None
                       else default_weights_dir())
        if self.clustering_threshold is None:
            self.clustering_threshold = (
                self.NEURAL_THRESHOLD if self.emb_net is not None
                else self.CLASSICAL_THRESHOLD)

    def _try_load(self, model_dir: Path) -> None:
        """The segmentation and embedding nets from their flat safetensors
        files onto the device; a file that is absent or does not load
        leaves its net out (the classical mode), as in the JAX package."""
        for attr, cls, name in (("seg_net", SegmentationNet,
                                 "segmentation.safetensors"),
                                ("emb_net", EmbeddingNet,
                                 "embedding.safetensors")):
            f = model_dir / name
            if not f.exists():
                continue
            try:
                with on_card(self.device):  # the upload is card work too
                    setattr(self, attr, cls.load(f, self.device).eval())
            except (OSError, ValueError, KeyError) as e:
                log.warning("could not load %s: %s", f, e)

    # ------------------------------------------------------------------

    def __call__(
        self,
        audio: Union[str, np.ndarray],
        min_speakers: Optional[int] = None,
        max_speakers: Optional[int] = None,
        num_speakers: Optional[int] = None,
        return_unfiltered: bool = False,
    ) -> Any:
        if isinstance(audio, str):
            wav = load_audio(audio)
        else:
            wav = np.asarray(audio, np.float32)
        if num_speakers is not None:
            min_speakers = max_speakers = num_speakers

        empty: Any = ([], []) if return_unfiltered else []
        if self.seg_net is not None:
            subsegs = self._neural_active_regions(wav)
        else:
            speech = collect_speech_segments(
                get_speech_probs(wav), self.vad_options, total_samples=len(wav)
            )
            if not speech:
                return empty
            subsegs = self._subsegment(speech)
        if not subsegs:
            return empty
        embeddings = self._embed(wav, subsegs)
        labels = agglomerative_cluster(
            embeddings,
            threshold=self.clustering_threshold,
            min_clusters=min_speakers,
            max_clusters=max_speakers,
        )
        labels = self._refine_labels(labels, embeddings,
                                     iters=self.refine_iters,
                                     min_clusters=min_speakers)
        labels = self._absorb_tiny_clusters(labels, embeddings, subsegs,
                                            floor=min_speakers)
        order = np.argsort([s for s, _ in subsegs], kind="stable")
        labels = relabel_by_first_appearance(labels, order)
        turns = self._merge_turns(subsegs, labels)
        if return_unfiltered:
            # the pre-dedupe turns are the reference's "unfiltered" output
            return self.dedupe(turns), turns
        return self.dedupe(turns)

    # ------------------------------------------------------------------
    # Neural segmentation mode (pyannote-3.1-equivalent flow)
    # ------------------------------------------------------------------

    SEG_WINDOW_S = 10.0
    SEG_HOP_S = 5.0
    SEG_FRAME_S = 0.02  # mel hop 10 ms x conv stride 2

    def _segmentation_multilabel(self, wav: np.ndarray
                                 ) -> Tuple[np.ndarray, List[float]]:
        """The segmentation net over sliding 10 s windows (hop 5 s), on the
        device in batches of SEG_BATCH windows. Returns (binary activity
        (n_windows, frames, 3), window starts)."""
        sr = SAMPLE_RATE
        win = int(self.SEG_WINDOW_S * sr)
        hop = int(self.SEG_HOP_S * sr)
        starts: List[float] = []
        mels: List[np.ndarray] = []
        t = 0
        while t == 0 or t + 1 < len(wav):
            seg = wav[t : t + win]
            if len(seg) < sr // 2 and starts:
                break
            seg = np.pad(seg, (0, win - len(seg)))
            mels.append(log_mel_spectrogram_np(seg))
            starts.append(t / sr)
            if t + win >= len(wav):
                break
            t += hop
        batch = np.stack(mels)  # (B, 80, 1000)
        with on_card(self.device), torch.no_grad():
            logp = torch.cat([
                self.seg_net(torch.from_numpy(batch[i:i + self.SEG_BATCH])
                             .to(self.device))
                for i in range(0, len(batch), self.SEG_BATCH)]).cpu().numpy()
        # hard powerset-argmax decode (pyannote 3.1): binary activity
        return powerset_decode(logp), starts

    def _neural_active_regions(self, wav: np.ndarray,
                               threshold: float = 0.5,
                               min_dur_s: float = 0.25,
                               silence_floor: float = 1.5e-3
                               ) -> List[Tuple[float, float]]:
        """Local speaker-activity intervals from the segmentation net.

        Each (window, local-speaker) activity run becomes one region to be
        embedded + clustered — the pyannote 3.1 stitching scheme. Regions
        are clipped to the window's unique half-overlap span so sliding
        windows don't double-count.

        ``silence_floor``: absolute per-frame RMS below which activity is
        ignored (~ -56 dBFS). Whisper's log-mel normalises each window to
        its own max, so near-digital silence renormalises into structure
        the net can mistake for speech; no intelligible speech lives below
        this floor."""
        probs, starts = self._segmentation_multilabel(wav)
        clip_points = set()  # window half-overlap clip boundaries
        # physical energy per 20 ms frame of the whole file
        hop = int(self.SEG_FRAME_S * SAMPLE_RATE)
        n_fr = len(wav) // hop
        frame_rms = np.sqrt(
            (wav[: n_fr * hop].reshape(n_fr, hop) ** 2).mean(axis=1)
        ) if n_fr else np.zeros((0,), np.float32)
        # dilate by ~0.24 s so inter-syllable micro-pauses inside a turn are
        # not re-fragmented; only sustained silence is gated
        if len(frame_rms) >= 25:
            frame_rms = np.max(
                np.lib.stride_tricks.sliding_window_view(
                    np.pad(frame_rms, (12, 12), mode="edge"), 25
                ),
                axis=1,
            )
        total_s = len(wav) / SAMPLE_RATE
        regions: List[Tuple[float, float]] = []
        for b, w_start in enumerate(starts):
            # unique span: avoid double counting the window overlap
            lo = w_start if b == 0 else w_start + self.SEG_HOP_S / 2
            hi = (w_start + self.SEG_WINDOW_S
                  if b == len(starts) - 1
                  else w_start + self.SEG_WINDOW_S - self.SEG_HOP_S / 2)
            clip_points.add(round(lo, 3))
            clip_points.add(round(hi, 3))
            # frames of this window in file-frame coordinates
            f0 = int(round(w_start / self.SEG_FRAME_S))
            n_f = probs.shape[1]
            energy_ok = np.zeros((n_f,), bool)
            span = frame_rms[f0 : f0 + n_f]
            energy_ok[: len(span)] = span > silence_floor
            for k in range(probs.shape[2]):
                active = (probs[b, :, k] > threshold) & energy_ok
                i = 0
                F = len(active)
                while i < F:
                    if not active[i]:
                        i += 1
                        continue
                    j = i
                    while j < F and active[j]:
                        j += 1
                    s = w_start + i * self.SEG_FRAME_S
                    e = w_start + j * self.SEG_FRAME_S
                    s, e = max(s, lo), min(e, hi, total_s)
                    if e - s >= min_dur_s:
                        regions.append((round(s, 3), round(e, 3)))
                    i = j
        regions.sort()
        # An activity run crossing the half-overlap clip boundary is split
        # into two regions by construction; the sliver side embeds badly
        # (too little audio) and seeds spurious clusters. Re-join regions
        # that abut AT A CLIP BOUNDARY only (the same run, stitched back
        # together) — overlapping regions are simultaneous speakers and
        # must stay separate.
        def at_clip(t: float) -> bool:
            return any(abs(t - c) <= 2 * self.SEG_FRAME_S for c in clip_points)

        merged: List[Tuple[float, float]] = []
        for s, e in regions:
            gap = s - merged[-1][1] if merged else 1e9
            if merged and 0.0 <= gap <= 0.06 and at_clip(s):
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    @staticmethod
    def _subsegment(speech: Sequence[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for s, e in speech:
            if e - s <= SUBSEG_S:
                out.append((s, e))
                continue
            t = s
            while t < e - 0.25:
                out.append((t, min(e, t + SUBSEG_S)))
                t += SUBSEG_HOP_S
        return out

    EMB_CROP_S = 2.0  # the embedding net's training utterance length

    def _embed(self, wav: np.ndarray,
               subsegs: Sequence[Tuple[float, float]]) -> np.ndarray:
        """(N, D) embeddings of the regions: the net on 2 s crops (long
        regions cropped around their centre, short ones loop-tiled, the
        training distribution), every crop in one batch on the device; or,
        without the net, long-term mel statistics."""
        if self.emb_net is not None:
            n_crop = int(self.EMB_CROP_S * SAMPLE_RATE)
            crops = []
            for s, e in subsegs:
                i0, i1 = int(s * SAMPLE_RATE), int(e * SAMPLE_RATE)
                seg = wav[i0:max(i1, i0 + 1)]
                if len(seg) >= n_crop:
                    mid = len(seg) // 2
                    seg = seg[mid - n_crop // 2 : mid - n_crop // 2 + n_crop]
                else:
                    reps = int(np.ceil(n_crop / max(len(seg), 1)))
                    seg = np.tile(seg, reps)[:n_crop]
                crops.append(seg)
            batch = np.stack([log_mel_spectrogram_np(c) for c in crops])
            with on_card(self.device), torch.no_grad():
                return self.emb_net(torch.from_numpy(batch).to(
                    self.device)).cpu().numpy()
        # classical fallback: long-term mel statistics
        mels = []
        for s, e in subsegs:
            i0, i1 = int(s * SAMPLE_RATE), int(e * SAMPLE_RATE)
            seg = wav[i0:i1]
            if len(seg) < 400:
                seg = np.pad(seg, (0, 400 - len(seg)))
            mels.append(log_mel_spectrogram_np(seg))
        T = max(m.shape[1] for m in mels)
        batch = np.stack([
            np.pad(m, ((0, 0), (0, T - m.shape[1])), mode="edge") for m in mels
        ])
        return melstats_embedding(batch)

    @staticmethod
    def _refine_labels(labels: np.ndarray, embeddings: np.ndarray,
                       iters: int = 2,
                       min_clusters: Optional[int] = None) -> np.ndarray:
        """Centroid-reassignment refinement after AHC (k-means style, the
        cluster count fixed by AHC): recompute L2-normalised centroids
        from the current assignment and move each region to its nearest
        centroid. Short (<2 s crop) regions embed noisily — their AHC
        merge order is unreliable, but the centroid average over a whole
        cluster denoises the target they're compared against
        (short-turns battery: DER 0.56 before this). Refinement stops
        early if it would drop the cluster count below ``min_clusters``
        (a caller-pinned speaker floor)."""
        labels = np.asarray(labels).copy()
        floor = max(1, min_clusters or 1)
        for _ in range(max(0, iters)):
            uniq = np.unique(labels)
            cents = {}
            for l in uniq:
                c = embeddings[labels == l].mean(axis=0)
                cents[int(l)] = c / max(np.linalg.norm(c), 1e-8)
            sims = np.stack([embeddings @ cents[int(l)] for l in uniq],
                            axis=1)                       # (N, C)
            new = uniq[np.argmax(sims, axis=1)]
            if len(np.unique(new)) < max(floor, 2) and len(uniq) >= 2:
                break  # refinement collapsed a needed cluster — keep AHC
            if (new == labels).all():
                break
            labels = new
        return labels

    @staticmethod
    def _absorb_tiny_clusters(labels: np.ndarray, embeddings: np.ndarray,
                              subsegs: Sequence[Tuple[float, float]],
                              min_total_s: float = 0.75,
                              floor: Optional[int] = None) -> np.ndarray:
        """Reassign clusters with < ``min_total_s`` of total speech to the
        nearest substantial cluster's centroid.

        Sub-second slivers (end-of-file tails, clipped onsets) embed poorly
        and otherwise seed phantom speakers; a real extra speaker talks for
        longer than this in any meeting.
        """
        labels = np.asarray(labels).copy()
        durs: Dict[int, float] = {}
        for (s, e), lab in zip(subsegs, labels):
            durs[int(lab)] = durs.get(int(lab), 0.0) + (e - s)
        big = [l for l, d in durs.items() if d >= min_total_s]
        keep_at_least = max(1, floor or 1)
        if len(big) < keep_at_least or len(big) == len(durs):
            return labels
        cents = {
            l: embeddings[labels == l].mean(axis=0) for l in big
        }
        for l in cents:
            cents[l] = cents[l] / max(np.linalg.norm(cents[l]), 1e-8)
        for i, lab in enumerate(labels):
            if int(lab) in big:
                continue
            sims = {l: float(embeddings[i] @ c) for l, c in cents.items()}
            labels[i] = max(sims, key=sims.get)
        return labels

    @staticmethod
    def _merge_turns(subsegs: Sequence[Tuple[float, float]],
                     labels: np.ndarray,
                     min_duration_off: float = 0.5) -> List[Dict[str, Any]]:
        """Overlapping same-label subsegments merge into turns; at label
        changes the boundary is the midpoint of the overlap.

        ``min_duration_off``: same-speaker turns separated by a shorter
        silence are bridged into one turn (pyannote's segmentation
        min_duration_off knob — intra-turn pauses are not speaker
        changes)."""
        order = np.argsort([s for s, _ in subsegs], kind="stable")
        turns: List[Dict[str, Any]] = []
        for idx in order:
            s, e = subsegs[idx]
            lab = f"SPEAKER_{int(labels[idx]):02d}"
            if (turns and turns[-1]["speaker"] == lab
                    and s <= turns[-1]["end"] + min_duration_off):
                turns[-1]["end"] = max(turns[-1]["end"], e)
            elif turns and s < turns[-1]["end"]:
                mid = (s + turns[-1]["end"]) / 2.0
                turns[-1]["end"] = round(mid, 3)
                turns.append({"start": round(mid, 3), "end": e, "speaker": lab})
            else:
                turns.append({"start": round(s, 3), "end": round(e, 3),
                              "speaker": lab})
        return [t for t in turns if t["end"] - t["start"] > 0.05]

    @staticmethod
    def dedupe(turns: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Drop exact duplicate (start, end, speaker) rows — same dedupe the
        reference applies over pyannote's itertracks
        (speaker_diarizer.py:143-162)."""
        seen = set()
        out = []
        for t in turns:
            key = (round(t["start"], 3), round(t["end"], 3), t["speaker"])
            if key in seen:
                continue
            seen.add(key)
            out.append(t)
        return out
