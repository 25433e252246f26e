"""AriesTranscriber — the long-form ASR engine on one CUDA card.

The port of the JAX package's pipeline/engine.py main path:

    WAV -> learned VAD -> window plan -> [batch of 30 s windows]
        -> log-mel (mel kernel) -> encoder (encoder-attention kernel)
        -> int8 cross K/V -> greedy or beam decode (decoder-layer kernels,
           grouped cross-attention kernel; beam: beam-tail and reorder
           kernels) -> temperature-fallback ladder -> parse
        -> [word timestamps: re-encode, alignment_forward, host DTW]
        -> TXT/JSON/SRT

The whole file is uploaded to the card once as int16 and windows are
gathered on the device. Each decode row has its own self-cache slot; the
rows of one window (its beams, or the fallback ladder's best_of samples)
share the window's cross K/V. The TPU's grouped-window layouts are a TPU
workaround and are not ported; their tokens equal this decode's.

Device: CUDA unless the caller passes ``device="cpu"``; with no card and
no explicit CPU the constructor raises. Activations are bf16 on CUDA and
f32 on the CPU. "auto" config values resolve to the card's path: int8
cross K/V, decode steps through the decoder-layer kernels with in-kernel
int8 self-cache quantization. On the CPU the plain versions run. The
decode options the JAX engine takes per call (suppress tokens, timestamps
off, initial-timestamp cap, n-gram bans, repetition penalty) come from
``config.decode`` here. A batch decodes by beam search when the beam size
is above 1 and the temperature is 0; the fallback ladder's rungs sample
with ``best_of``.

``compute_type="int8"`` quantizes every transformer dense layer; with
``ARIES_QUANT_IMPL=pallas`` their products go through the W8A16 GEMM
kernel on the card. ``decode.kv_cache_dtype="bf16"`` with
``decode.self_kv_cache_dtype="int8"`` decodes by unfused steps with an
int8 self cache (the int8 self-attention kernel on the card).
``word_timestamps=True`` attaches DTW word times to every segment
(align/word_align.py); a failure there fails the call. With no checkpoint
loading there are no published alignment heads: ``alignment_heads`` is
None (the top-half fallback) unless the caller sets it.

Not ported yet (ROADMAP.md): checkpoint loading, conditioned / sequential
decode and the resume journal, fixed chunking, prefix / initial prompt /
hotwords, the short audio_ctx bucket; the constructor refuses
``decode.multilingual=True`` (a language per window), ``decode.audio_ctx``
other than "full" and ``decode.mel_backend`` other than "auto".
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from whisper_aries_tpu_torch.audio.decode import AudioPreloader
from whisper_aries_tpu_torch.config import AriesConfig, load_config
from whisper_aries_tpu_torch.decoding import generate as G
from whisper_aries_tpu_torch.decoding.segments_parse import (
    parse_window_tokens,
    window_quality,
)
from whisper_aries_tpu_torch.decoding.tokenizer import (
    LANGUAGES,
    build_special_tokens,
)
from whisper_aries_tpu_torch.errors import TranscriptionError
from whisper_aries_tpu_torch.models import whisper as W
from whisper_aries_tpu_torch.ops.decode_layers import pack_layer_weights
from whisper_aries_tpu_torch.ops.mel import log_mel
from whisper_aries_tpu_torch.render.renderers import srt_timestamp
from whisper_aries_tpu_torch.vad import (
    VadOptions,
    Window,
    collect_speech_segments,
    get_speech_probs,
    plan_windows,
)

log = logging.getLogger(__name__)

SR = 16_000


class DummyTokenizer:
    """Tokenizer stand-in for random-weight runs."""

    def __init__(self, n_vocab: int):
        if n_vocab == 51864:  # English-only .en layout
            self.specials = build_special_tokens(50257, 99, english=True)
        else:
            num_lang = max(1, n_vocab - 51766)
            self.specials = build_special_tokens(
                n_vocab - num_lang - 1509, num_lang
            )

    def decode(self, ids, skip_special=True):
        return " ".join(f"<{int(i)}>" for i in ids)

    def encode(self, text):
        # " " -> 220 mirrors the GPT-2 byte-BPE table
        return [220] if text == " " else [0]

    def non_speech_tokens(self, encoder):
        return []


def _resolve_device(device: Optional[str]) -> torch.device:
    if device is None or str(device).startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "AriesTranscriber runs on a CUDA card and none is visible; "
                "pass device='cpu' for the plain CPU path")
        return torch.device(device or "cuda")
    return torch.device(device)


def _cast_floats(tree: Any, device: torch.device, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _cast_floats(v, device, dtype) for k, v in tree.items()}
    if tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device)


class AriesTranscriber:
    """Long-form transcription engine on one CUDA card (or the CPU)."""

    WINDOW_SAMPLES = 480_000  # 30 s @ 16 kHz
    #: max failing windows per fallback dispatch
    FALLBACK_GROUP = 16

    def __init__(
        self,
        model_size: str = "large-v3",
        device: Optional[str] = None,
        compute_type: str = "bf16",
        config: Optional[AriesConfig] = None,
        allow_random: bool = False,
        windows_per_device: Optional[int] = None,
        kv_cache_dtype: Optional[str] = None,  # "auto" | "int8" | "bf16"
        _params=None,
        _dims: Optional[W.WhisperDims] = None,
        _tokenizer=None,
    ):
        self.config = config or load_config()
        self.model_size = model_size
        self.device = _resolve_device(device)
        on_cuda = self.device.type == "cuda"
        dc = self.config.decode
        for name, val, ok in (("audio_ctx", dc.audio_ctx, ("full",)),
                              ("mel_backend", dc.mel_backend, ("auto",)),
                              ("multilingual", dc.multilingual, (False,))):
            if val not in ok:
                raise ValueError(f"decode.{name}={val!r} is not ported yet")
        if compute_type in ("f32", "float32"):
            if on_cuda:
                raise ValueError("the CUDA path runs bf16 activations")
            dtype = torch.float32
        else:
            dtype = torch.bfloat16 if on_cuda else torch.float32
        self.activation_dtype = dtype

        if _params is not None:
            self.dims = _dims
            params = _cast_floats(_params, self.device, dtype)
        elif allow_random:
            self.dims = W.PRESETS[model_size]
            params = W.init_params(self.dims, seed=0, device=self.device,
                                   dtype=dtype)
        else:
            raise TranscriptionError(
                "checkpoint loading is not ported yet: pass allow_random=True "
                "(seeded random weights) or _params")
        if compute_type == "int8":
            from whisper_aries_tpu_torch.ops.quant import quantize_model_params

            params = quantize_model_params(params)
        self.params = W.fuse_decoder_qkv(params)
        self.tokenizer = (_tokenizer if _tokenizer is not None
                          else DummyTokenizer(self.dims.n_vocab))
        self.ids = dataclasses.replace(
            G.DecodeSpecialIds.from_tokenizer(self.tokenizer),
            max_initial_timestamp_index=max(
                0, int(round(dc.max_initial_timestamp / 0.02))))
        self.suppress_mask = self._make_suppress_mask(dc.suppress_tokens)
        self.batch_size = max(1, windows_per_device or 8)

        kvd = kv_cache_dtype or dc.kv_cache_dtype
        self.kv_int8 = kvd == "int8" or (kvd == "auto" and on_cuda)
        # decode steps go through the decoder-layer kernels on the card;
        # they read int8 cross K/V and int8 weights (packed once here)
        self.fused = on_cuda and self.kv_int8
        skvd = dc.self_kv_cache_dtype
        self.self_kv_int8 = self.fused if skvd == "auto" else skvd == "int8"
        self.wpack = (pack_layer_weights(self.params["decoder"]["blocks"])
                      if self.fused else None)
        # per-checkpoint DTW alignment heads [(layer, head), ...]; None
        # falls back to the top half of the decoder layers
        self.alignment_heads: Optional[List[Tuple[int, int]]] = None
        self._speech_scorer = self._make_speech_scorer()
        self.last_stats: Dict[str, Any] = {}

    # ------------------------------------------------------------------

    def _make_suppress_mask(self, suppress_tokens) -> torch.Tensor:
        """(vocab,) additive logit mask; -1 expands to the non-speech set
        and the special tokens are always suppressed."""
        sp = self.tokenizer.specials
        ids: List[int] = []
        for t in suppress_tokens:
            if int(t) == -1:
                ids += list(self.tokenizer.non_speech_tokens(
                    self.tokenizer.encode))
            elif int(t) >= 0:
                ids.append(int(t))
        ids += [sp.sot, sp.sot_lm, sp.sot_prev, sp.no_speech,
                sp.translate, sp.transcribe]
        return torch.as_tensor(G.build_suppress_mask(self.dims.n_vocab, ids),
                               device=self.device)

    def _make_speech_scorer(self):
        """The learned VAD net when its weights are present, else the
        adaptive-energy detector (config: vad.backend)."""
        backend = self.config.vad.backend
        if backend in ("auto", "learned"):
            from whisper_aries_tpu_torch.models.vad_net import (
                VAD_WEIGHTS,
                load_vad_params,
                make_nn_speech_scorer,
            )

            if VAD_WEIGHTS.exists():
                log.info("VAD: learned scorer (%s)", VAD_WEIGHTS)
                return make_nn_speech_scorer(
                    load_vad_params(VAD_WEIGHTS, self.device), self.device)
            if backend == "learned":
                raise FileNotFoundError(str(VAD_WEIGHTS))
            log.info("VAD: energy scorer (no learned weights)")
        return get_speech_probs

    def _mel(self, audio: torch.Tensor) -> torch.Tensor:
        """Log-mel: the mel kernel on CUDA, the FFT version on the CPU."""
        return log_mel(audio, n_mels=self.dims.n_mels)

    def _upload(self, pre: AudioPreloader) -> torch.Tensor:
        """The whole file as int16 on the device, zero-padded by one window
        so every window gathers in bounds (16-bit, the reference's
        pcm_s16le ingest contract)."""
        a16 = np.clip(pre.audio * 32768.0, -32768, 32767).astype(np.int16)
        buf = torch.zeros(len(a16) + self.WINDOW_SAMPLES, dtype=torch.int16,
                          device=self.device)
        buf[: len(a16)] = torch.from_numpy(a16).to(self.device)
        return buf

    def _gather(self, audio16: torch.Tensor, windows: Sequence[Window],
                idx: Sequence[int]) -> torch.Tensor:
        """(B, 480000) f32 windows gathered on the device, zeroed past each
        window's length."""
        win = self.WINDOW_SAMPLES
        starts = [int(round(windows[i].start * SR)) for i in idx]
        lens = [min(win, int(round(windows[i].duration * SR))) for i in idx]
        view = audio16.as_strided((audio16.numel() - win + 1, win), (1, 1))
        rows = view[torch.as_tensor(starts, device=self.device)]
        ar = torch.arange(win, device=self.device)
        keep = ar[None, :] < torch.as_tensor(lens, device=self.device)[:, None]
        return torch.where(keep, rows.float() * (1.0 / 32768.0), 0.0)

    def _plan(self, pre: AudioPreloader, duration: float) -> List[Window]:
        probs = self._speech_scorer(pre.audio)
        speech = collect_speech_segments(probs, VadOptions(),
                                         total_samples=len(pre.audio))
        return plan_windows(speech, duration) if speech else []

    def _encode_batch(self, mel: torch.Tensor) -> torch.Tensor:
        return W.encode(self.params, mel.to(self.activation_dtype), self.dims)

    def _decode_batch(self, xa: torch.Tensor, prompt: np.ndarray,
                      temperature: float, sample_len: int, seed: int = 0,
                      beam_size: int = 1, patience: float = 1.0,
                      length_penalty: float = 1.0) -> Dict[str, Any]:
        """Decode the windows of ``xa``: beam search when ``beam_size`` > 1
        at temperature 0, else greedy / sampled over the prompt's rows
        (a multiple of the windows, window-major)."""
        dc = self.config.decode
        common = dict(
            with_timestamps=not dc.without_timestamps,
            kv_int8=self.kv_int8, self_kv_int8=self.self_kv_int8,
            repetition_penalty=(dc.repetition_penalty
                                if dc.repetition_penalty != 1.0 else None),
            no_repeat_ngram_size=dc.no_repeat_ngram_size,
            fused=self.fused, wpack=self.wpack)
        prompt_t = torch.as_tensor(prompt, device=self.device)
        t0 = time.time()
        if beam_size > 1 and temperature == 0:
            out = G.beam_search_decode(
                self.params, xa, prompt_t, self.dims, self.ids,
                self.suppress_mask, 0, beam_size=beam_size,
                sample_len=sample_len, length_penalty=length_penalty,
                patience=patience, **common)
            rows = int(xa.shape[0]) * beam_size
        else:
            gen = None
            if temperature > 0:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed)
            out = G.greedy_decode(
                self.params, xa, prompt_t, self.dims, self.ids,
                self.suppress_mask, 0, float(temperature), gen,
                sample_len=sample_len, **common)
            rows = int(prompt_t.shape[0])
        res = {k: v.cpu().numpy() for k, v in out.items()}
        stats = {"rows": rows, "windows": int(xa.shape[0]),
                 "steps": int(res["steps"]),
                 "temperature": float(temperature), "beam_size": beam_size,
                 "seconds": time.time() - t0}
        if "permuted" in res:
            stats["permuted"] = int(res["permuted"])
        self.last_stats.setdefault("decodes", []).append(stats)
        return res

    def detect_language(self, mel: torch.Tensor) -> Tuple[str, float]:
        """Language of the first window (faster-whisper's detection)."""
        sp = self.tokenizer.specials
        lang0 = min(sp.language_tokens.values())
        probs = G.detect_language_logits(
            self.params, self._encode_batch(mel[:1]), self.dims, sp.sot,
            lang0, sp.num_languages)[0].float().cpu().numpy()
        idx = int(np.argmax(probs))
        return LANGUAGES[idx], float(probs[idx])

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def transcribe_file(
        self,
        audio_path: str,
        language: Optional[str] = None,
        output_formats: Sequence[str] = ("txt",),
        output_dir: Optional[str] = None,
        task: str = "transcribe",
        beam_size: Optional[int] = None,
        best_of: int = 5,
        patience: Optional[float] = None,
        length_penalty: Optional[float] = None,
        temperature: Optional[Sequence[float]] = None,
        compression_ratio_threshold: float = 2.4,
        log_prob_threshold: float = -1.0,
        no_speech_threshold: float = 0.6,
        max_new_tokens: int = 224,
        word_timestamps: bool = False,
        prepend_punctuations: Optional[str] = None,
        append_punctuations: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Transcribe one file end to end (VAD, greedy or beam search,
        fallback ladder, optional word timestamps); returns the result dict
        and writes the requested output formats (txt, json, srt).
        ``beam_size``, ``patience``, ``length_penalty`` and the punctuation
        sets default to ``config.decode``'s."""
        t0 = time.time()
        self.last_stats = {}
        dc = self.config.decode
        beam = dict(
            beam_size=max(1, int(beam_size if beam_size is not None
                                 else dc.beam_size)),
            patience=float(patience if patience is not None
                           else dc.patience),
            length_penalty=float(length_penalty if length_penalty is not None
                                 else dc.length_penalty))
        pre = AudioPreloader(audio_path)
        duration = pre.duration
        windows = self._plan(pre, duration)
        log.info("planned %d windows for %.1fs audio", len(windows), duration)

        temps = (temperature if temperature is not None
                 else self.config.decode.temperature)
        if isinstance(temps, (int, float)):
            temps = (float(temps),)
        temps = tuple(temps)
        thresholds = (compression_ratio_threshold, log_prob_threshold,
                      no_speech_threshold)

        segments: List[Dict[str, Any]] = []
        lang_prob = 1.0 if language else None
        if windows:
            audio16 = self._upload(pre)
            if language is None and self.tokenizer.specials.language_tokens:
                mel0 = self._mel(self._gather(audio16, windows, [0]))
                language, lang_prob = self.detect_language(mel0)
            prompt_ids = self.tokenizer.specials.sot_sequence(language, task)
            segments = self._transcribe_windows(
                audio16, windows, prompt_ids, temps, max_new_tokens,
                thresholds, best_of, beam)

        if word_timestamps and segments:
            from whisper_aries_tpu_torch.align.word_align import (
                add_word_timestamps,
            )

            # no catch-all here: a kernel error in the word pass fails the
            # call (the JAX engine logs a warning instead)
            t_w = time.time()
            self.last_stats["words"] = add_word_timestamps(
                self, segments, pre.audio, windows,
                prepend_punctuations=(
                    prepend_punctuations if prepend_punctuations is not None
                    else dc.prepend_punctuations),
                append_punctuations=(
                    append_punctuations if append_punctuations is not None
                    else dc.append_punctuations))
            self.last_stats["words"]["seconds"] = time.time() - t_w

        wall = time.time() - t0
        result: Dict[str, Any] = {
            "success": True,
            "segments": segments,
            "text": " ".join(s["text"] for s in segments).strip(),
            "language": language,
            "language_probability": lang_prob,
            "duration": duration,
            "processing_time": wall,
            "real_time_factor": duration / wall if wall > 0 else 0.0,
            "num_windows": len(windows),
            "performance": self.last_stats,
            "metadata": {
                "audio_file": audio_path,
                "model": self.model_size,
                "device": str(self.device),
                "total_segments": len(segments),
            },
        }
        if output_formats:
            result["output_files"] = self._generate_outputs(
                audio_path, segments, result, output_formats, output_dir)
        return result

    # ------------------------------------------------------------------

    def _transcribe_windows(self, audio16, windows, prompt_ids, temps,
                            sample_len, thresholds, best_of, beam
                            ) -> List[Dict[str, Any]]:
        parse_skip = len(prompt_ids)
        N = len(windows)
        # size the batches to the file: ceil-divide the windows over the
        # batch count the cap implies, so no batch is mostly padding
        B = min(self.batch_size, -(-N // -(-N // self.batch_size)))
        all_segments: List[Dict[str, Any]] = []
        p = 0
        while p < N:
            batch_idx = list(range(p, min(N, p + B)))
            prompt = np.tile(np.asarray(prompt_ids, np.int64),
                             (len(batch_idx), 1))
            try:
                xa = self._encode_batch(
                    self._mel(self._gather(audio16, windows, batch_idx)))
                out = self._decode_batch(xa, prompt, temps[0], sample_len,
                                         **beam)
            except torch.cuda.OutOfMemoryError:
                # halve the window batch and retry this batch
                if B == 1:
                    raise
                B = max(1, B // 2)
                self.batch_size = B
                log.warning("device OOM — retrying with batch_size=%d", B)
                torch.cuda.empty_cache()
                continue
            del xa
            rows, fails = [], []
            for w_i, win_id in enumerate(batch_idx):
                window = windows[win_id]
                segs, quality = self._parse_one(
                    out["tokens"][w_i], window, parse_skip,
                    float(out["avg_logprob"][w_i]),
                    float(out["no_speech_prob"][w_i]), thresholds)
                if quality["is_silence"]:
                    continue
                if quality["needs_fallback"] and len(temps) > 1:
                    fails.append((win_id, window, prompt[w_i], segs))
                rows.append((win_id, window, segs))
            fb: Dict[int, Tuple[List[Dict[str, Any]], float]] = {}
            if fails:
                fb = self._fallback_windows(audio16, windows, fails,
                                            temps[1:], sample_len,
                                            thresholds, best_of, parse_skip)
            for win_id, window, segs in rows:
                if win_id in fb:
                    segs = fb[win_id][0]
                for s in segs:
                    s["chunk_id"] = window.chunk_id
                    s["window_id"] = win_id
                    s["worker_id"] = 0
                all_segments.extend(segs)
            p += len(batch_idx)
        all_segments.sort(key=lambda s: (s["start"], s["end"]))
        return all_segments

    def _parse_one(self, toks, window, prompt_len, avg_lp, ns_prob,
                   thresholds):
        cr_thresh, lp_thresh, ns_thresh = thresholds
        segs = parse_window_tokens(toks, self.tokenizer, window.start,
                                   window.duration, prompt_len=prompt_len)
        text = " ".join(s["text"] for s in segs)
        q = window_quality(
            text, avg_lp, ns_prob,
            log_prob_threshold=lp_thresh,
            compression_ratio_threshold=cr_thresh,
            no_speech_threshold=ns_thresh,
        )
        for s in segs:
            s["avg_logprob"] = avg_lp
            s["no_speech_prob"] = ns_prob
        return segs, q

    def _fallback_windows(self, audio16, windows, fails, temps, sample_len,
                          thresholds, best_of, parse_skip
                          ) -> Dict[int, Tuple[List[Dict[str, Any]], float]]:
        """Temperature-fallback ladder for a batch's failing windows: at
        each rung, ``best_of`` samples of every still-failing window decode
        as one batch (the samples of a window share its cross K/V) and the
        best by sum logprob is kept. Returns {window id: (segments,
        accepted temperature)}."""
        K = max(1, best_of)
        results: Dict[int, Tuple[List[Dict[str, Any]], float]] = {}
        last_t = float(temps[-1])
        for g0 in range(0, len(fails), self.FALLBACK_GROUP):
            group = fails[g0:g0 + self.FALLBACK_GROUP]
            xa = self._encode_batch(self._mel(self._gather(
                audio16, windows, [f[0] for f in group])))
            prompt = np.repeat(np.stack([np.asarray(f[2]) for f in group]),
                               K, axis=0)
            best = {f[0]: (f[3], last_t) for f in group}
            pending = dict(enumerate(group))
            for t_i, t in enumerate(temps):
                if not pending:
                    break
                out = self._decode_batch(xa, prompt, float(t), sample_len,
                                         seed=1234 + t_i)
                for i in list(pending):
                    win_idx, window = pending[i][0], pending[i][1]
                    b = i * K + int(np.argmax(
                        out["sum_logprob"][i * K:(i + 1) * K]))
                    segs, q = self._parse_one(
                        out["tokens"][b], window, parse_skip,
                        float(out["avg_logprob"][b]),
                        float(out["no_speech_prob"][b]), thresholds)
                    if q["is_silence"]:
                        results[win_idx] = ([], float(t))
                        del pending[i]
                    elif not q["needs_fallback"]:
                        results[win_idx] = (segs, float(t))
                        del pending[i]
                    else:
                        best[win_idx] = (segs, last_t)
            for f in pending.values():
                results[f[0]] = best[f[0]]
        return results

    def _generate_outputs(self, audio_path, segments, result, formats,
                          output_dir=None) -> Dict[str, str]:
        stem = Path(audio_path).with_suffix("")
        if output_dir:
            Path(output_dir).mkdir(parents=True, exist_ok=True)
            stem = Path(output_dir) / Path(audio_path).stem
        out: Dict[str, str] = {}
        for fmt in formats:
            path = f"{stem}.{fmt}"
            if fmt == "txt":
                with open(path, "w", encoding="utf-8") as f:
                    for s in segments:
                        f.write(s["text"].strip() + "\n")
            elif fmt == "json":
                payload = {
                    "transcription": [
                        {k: s[k] for k in
                         ("start", "end", "text", "avg_logprob",
                          "no_speech_prob", "chunk_id", "worker_id")
                         if k in s}
                        for s in segments
                    ],
                    "metadata": {
                        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
                        "audio_file": str(audio_path),
                        "total_segments": len(segments),
                        "model": self.model_size,
                        "device": str(self.device),
                        "language": result.get("language"),
                    },
                }
                with open(path, "w", encoding="utf-8") as f:
                    json.dump(payload, f, indent=2, ensure_ascii=False)
            elif fmt == "srt":
                with open(path, "w", encoding="utf-8") as f:
                    for i, s in enumerate(segments, 1):
                        f.write(f"{i}\n{srt_timestamp(s['start'])} --> "
                                f"{srt_timestamp(s['end'])}\n"
                                f"{s['text'].strip()}\n\n")
            else:
                continue
            out[fmt] = path
        return out
