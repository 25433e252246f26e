"""AriesTranscriber — the long-form ASR engine on one CUDA card.

The port of the JAX package's pipeline/engine.py main path:

    checkpoint dir -> params, tokenizer, alignment heads, smoke test
    WAV -> learned VAD (or fixed chunks) -> window plan
        -> [batch of 30 s windows, or 16 s under audio_ctx="bucket"]
        -> log-mel (mel kernel) -> encoder (encoder-attention kernel)
        -> [multilingual: a language per window, one batched probe]
        -> int8 cross K/V -> greedy or beam decode (decoder-layer kernels,
           grouped cross-attention kernel; beam: beam-tail and reorder
           kernels) -> temperature-fallback ladder -> parse
        -> [fixed chunks: overlap drop / merge]
        -> [word timestamps: re-encode, alignment_forward, host DTW]
        -> TXT/JSON/SRT

Checkpoints are local HF-format directories (models/loader.py): the
constructor loads ``model_size`` as a path or under ``cache_dir`` and runs
``smoke_test`` on them (``ARIES_SMOKE_TEST=0`` skips it); with no
checkpoint it raises unless ``allow_random`` (seeded random weights).
There is no download path. The whole file is uploaded to the card once as
int16 and windows are gathered on the device. Each decode row has its own
self-cache slot; the rows of one window (its beams, or the fallback
ladder's best_of samples) share the window's cross K/V. The TPU's
grouped-window layouts are a TPU workaround and are not ported; their
tokens equal this decode's.

Device: CUDA unless the caller passes ``device="cpu"``; with no card and
no explicit CPU the constructor raises. Threads: ``transcribe_file`` reads
and decodes its file first, then holds the device's lock
(``utils/device.py::on_card``, shared with every engine and diarizer on
that device) over all its device work, so calls from several threads (the
server's jobs) take turns on the card: a decode call's CUDA graph capture
never sees another job's launches. The constructor's weight upload,
``smoke_test`` and ``detect_language`` hold it too. ``last_stats`` holds
the port's own counters of the calling thread's last call (``encodes``,
``decodes``, ``words``, ``card_wait_s``: the seconds it waited for the
lock); the result's ``performance`` is the JAX engine's
``PerformanceMonitor`` report, one unit a window batch.

Replicas (``mesh``, parallel/mesh.py; the JAX engine's mesh): one copy of
the weights on each card of the mesh, and each batch of windows cut into
the mesh's contiguous shards; each shard's card work (gather, mel, encode,
language probe, decode, the fallback rungs) runs in its own host thread
against its replica under that card's lock, and the outputs join in
window order. The calling thread then holds no card lock (an engine lock
keeps the engine's calls one at a time); the sequential mode, the language
detection and the word pass run on the first replica. With one replica
every shard runs in the calling thread under the card lock, as before.

The batch loop is the JAX engine's double-buffered one (``ARIES_PIPELINE``,
read per call: "1", the default, is depth 2; anything else depth 1, each
batch run to its end). At depth 2 a helper thread parses batch k's tokens
on the host while the calling thread (and the replicas' threads) gather,
encode, probe and decode batch k + 1; batch k's fallback ladder runs after
that decode. All card work stays in the calling and replica threads: the
card's lock keeps one holder, no two decode calls of a job capture CUDA
graphs at once, and the launch counters see one sequence. Depth 2 holds
nothing more on the card: batch k's outputs are host arrays and its
encoder output is freed before batch k + 1 runs, so
``auto_windows_per_device`` sizes a batch as at depth 1. An out-of-memory
error at depth 2 drops to depth 1 and keeps the batch; at depth 1 it
halves the batch (the JAX engine's ladder). The sequential mode is not
pipelined.

Activations are bf16 on CUDA and f32 on the CPU. "auto" config values
resolve to the card's path: int8 cross K/V, decode steps through the
decoder-layer kernels with in-kernel int8 self-cache quantization. On the
CPU the plain versions run. The
per-call decode options (suppress tokens, timestamps off, initial-timestamp
cap, n-gram bans, repetition penalty, a language per window) travel in
``_CallOpts``; each defaults to ``config.decode``'s. A batch decodes by
beam search when the beam size is above 1 and the temperature is 0; the
fallback ladder's rungs sample with ``best_of``.

``compute_type="int8"`` quantizes every transformer dense layer; with
``ARIES_QUANT_IMPL=pallas`` their products go through the W8A16 GEMM
kernel on the card, with ``=native`` through the row quantization and the
s8 x s8 -> s32 GEMM (CTranslate2's scheme), wherever ``quant_matmul`` runs:
the encoder, the cross K/V, the prefills, the word pass and the unfused
decode steps (the fused decoder-layer kernel keeps its own W8A16 products
under every value, as the JAX fused kernel does). A call without a
language detects it from the first batch's first window at that batch's
context (deferred), or, when multilingual, conditioned or prefixed or at
``ARIES_DEFER_LANG=0`` (read per call), from window 0's 30 s mel before
any batch. ``decode.kv_cache_dtype="bf16"`` with
``decode.self_kv_cache_dtype="int8"`` decodes by unfused steps with an
int8 self cache (the int8 self-attention kernel on the card).
``word_timestamps=True`` attaches DTW word times to every segment
(align/word_align.py) with the checkpoint's alignment heads
(generation_config.json; without them the top half of the decoder
layers); a failure there fails the call.

Conditioned decoding, as the JAX engine's: ``initial_prompt`` (or else
``hotwords``) goes after <|startofprev|>; ``prefix`` forces the first
window's transcript; ``condition_on_previous_text=True`` decodes the windows
one at a time, each prompted with the text before it, every prompt
left-padded with -1 to one width (the first real token's index is the
decode's ``prompt_start``, its sot's ``sot_index``), and the fallback ladder
resets that context when the accepted temperature exceeds
``prompt_reset_on_temperature``. ``resume_path`` keeps a resume journal
(pipeline/journal.py) in both modes.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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
    WhisperTokenizer,
    build_special_tokens,
)
from whisper_aries_tpu_torch.models import whisper as W
from whisper_aries_tpu_torch.models.loader import (
    load_alignment_heads,
    load_model,
)
from whisper_aries_tpu_torch.ops.decode_layers import pack_layer_weights
from whisper_aries_tpu_torch.ops.mel import log_mel
from whisper_aries_tpu_torch.pipeline.journal import ResumeJournal, plan_signature
from whisper_aries_tpu_torch.render.renderers import srt_timestamp
from whisper_aries_tpu_torch.parallel.mesh import (
    auto_windows_per_device,
    join_shards,
    map_shards,
    replicate_params,
)
from whisper_aries_tpu_torch.utils.device import on_card, resolve_device
from whisper_aries_tpu_torch.utils.memory import is_oom_error
from whisper_aries_tpu_torch.utils.perf import (
    PerformanceMonitor,
    WorkerDiagnostics,
)
from whisper_aries_tpu_torch.utils.segments import (
    merge_overlapping_segments,
    remove_overlaps_drop,
)
from whisper_aries_tpu_torch.vad import (
    VadOptions,
    Window,
    collect_speech_segments,
    get_speech_probs,
    plan_chunks,
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


class _EventBuffer:
    """A diagnostics log that keeps its events in order, (unit, state,
    detail), for the calling thread to log into the call's
    WorkerDiagnostics: the parse helper logs nothing itself."""

    def __init__(self):
        self.events: List[Tuple[Any, str, str]] = []

    def log(self, unit_id: Any, state: str, detail: str = "") -> None:
        self.events.append((unit_id, state, detail))


def _cast_floats(tree: Any, device: torch.device, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _cast_floats(v, device, dtype) for k, v in tree.items()}
    if tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device)


@dataclasses.dataclass(frozen=True)
class _CallOpts:
    """Per-call decode options threaded through the window loops (the JAX
    engine's ``_CallOpts``): an engine may serve several calls, so they
    travel as a value, never as engine state. Each comes from the call or,
    where the call leaves it None, from ``config.decode``."""

    ids: G.DecodeSpecialIds          # carries max_initial_timestamp_index
    suppress_mask: torch.Tensor      # (vocab,) additive logit mask
    with_timestamps: bool = True     # False == without_timestamps
    multilingual: bool = False       # a language per window
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    #: sequential mode: the context resets above this accepted temperature
    prompt_reset_on_temperature: float = 0.5


class AriesTranscriber:
    """Long-form transcription engine on one CUDA card (or the CPU), or
    one replica a card of a mesh."""

    WINDOW_SAMPLES = 480_000  # 30 s @ 16 kHz
    # audio_ctx="bucket": a batch made only of windows of <= 16 s is
    # gathered at 16 s and encoded at T 800 (1,600 mel frames)
    SHORT_WINDOW_SAMPLES = 256_000
    SHORT_WINDOW_S = 16.0
    #: max failing windows per fallback dispatch
    FALLBACK_GROUP = 16

    def __init__(
        self,
        model_size: str = "large-v3",
        device: Optional[str] = None,
        compute_type: str = "bf16",
        chunk_length_minutes: float = 3.0,
        overlap_seconds: float = 5.0,
        num_workers: Optional[int] = None,  # maps to windows_per_device
        cache_dir: str = "./models",
        config: Optional[AriesConfig] = None,
        allow_random: bool = False,
        mesh=None,
        windows_per_device: Optional[int] = None,
        kv_cache_dtype: Optional[str] = None,  # "auto" | "int8" | "bf16"
        mel_backend: Optional[str] = None,     # "auto" | "pallas" | "xla"
        audio_ctx: Optional[str] = None,       # "full" | "bucket"
        _params=None,
        _dims: Optional[W.WhisperDims] = None,
        _tokenizer=None,
    ):
        self.config = config or load_config()
        self.model_size = model_size
        self.chunk_length_minutes = chunk_length_minutes
        self.overlap_seconds = overlap_seconds
        # the mesh: the data axis of replicas (default: one, on ``device``)
        if mesh is not None:
            self.mesh = [resolve_device(str(d), "AriesTranscriber")
                         for d in mesh]
            self.mesh = [torch.device("cuda", torch.cuda.current_device())
                         if d.type == "cuda" and d.index is None else d
                         for d in self.mesh]
            self.device = self.mesh[0]
        else:
            self.device = resolve_device(device, "AriesTranscriber")
            self.mesh = [self.device]
        on_cuda = self.device.type == "cuda"
        self._tls = threading.local()        # a thread's call stats
        self._stats_lock = threading.Lock()  # shards update them at once
        self._call_lock = threading.RLock()  # calls across several cards
        self.last_monitor: Optional[PerformanceMonitor] = None
        dc = self.config.decode
        # one mel: the kernel on the card ("auto" and "pallas"), its plain
        # version on the CPU, where "xla" (the FFT version) is the same
        self.mel_backend = mel_backend or dc.mel_backend
        if self.mel_backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown mel_backend {self.mel_backend!r}")
        if self.mel_backend == "xla" and on_cuda:
            raise ValueError("mel_backend='xla' has no CUDA path: the port's "
                             "mel on the card is the mel kernel")
        ctx = audio_ctx or dc.audio_ctx
        if ctx not in ("full", "bucket"):
            raise ValueError(f"unknown audio_ctx {ctx!r}")
        self.audio_ctx_bucket = ctx == "bucket"
        if compute_type in ("f32", "float32"):
            if on_cuda:
                raise ValueError("the CUDA path runs bf16 activations")
            dtype = torch.float32
        else:
            dtype = torch.bfloat16 if on_cuda else torch.float32
        self.activation_dtype = dtype

        # the weight upload, the packing and the smoke test are card work:
        # another job on the card may be capturing a graph meanwhile
        with on_card(self.device):
            if _params is not None:
                self.dims, self.model_dir = _dims, None
                params = _cast_floats(_params, self.device, dtype)
            else:
                params, self.dims, self.model_dir = load_model(
                    model_size, cache_dir=cache_dir, dtype=dtype,
                    allow_random=allow_random, device=self.device)
            if compute_type == "int8":
                from whisper_aries_tpu_torch.ops.quant import (
                    quantize_model_params)

                params = quantize_model_params(params)
            self.params = W.fuse_decoder_qkv(params)
            self.tokenizer = (_tokenizer if _tokenizer is not None
                              else self._load_tokenizer())
            self.ids = G.DecodeSpecialIds.from_tokenizer(self.tokenizer)
            # the default mask (config.decode.suppress_tokens); a call's
            # own suppress_tokens build theirs
            self.suppress_mask = self._make_suppress_mask(dc.suppress_tokens)

            kvd = kv_cache_dtype or dc.kv_cache_dtype
            self.kv_int8 = kvd == "int8" or (kvd == "auto" and on_cuda)
            # decode steps go through the decoder-layer kernels on the
            # card; they read int8 cross K/V and int8 weights (packed once
            # here)
            self.fused = on_cuda and self.kv_int8
            skvd = dc.self_kv_cache_dtype
            self.self_kv_int8 = (self.fused if skvd == "auto"
                                 else skvd == "int8")
            self.wpack = (
                pack_layer_weights(self.params["decoder"]["blocks"])
                if self.fused else None)
            # the checkpoint's DTW alignment heads [(layer, head), ...];
            # None falls back to the top half of the decoder layers
            self.alignment_heads: Optional[List[Tuple[int, int]]] = (
                load_alignment_heads(self.model_dir))
            self._speech_scorer = self._make_speech_scorer()
            self.last_stats = {}
            self.last_diagnostics: Optional[WorkerDiagnostics] = None
        self._others = self._make_replicas()
        # windows a replica decodes at once: given, else sized from the
        # card's free memory (as the JAX engine sizes them on the TPU), 8
        # on the CPU; the batch is that times the replicas
        wpd = windows_per_device or num_workers
        if wpd is None:
            wpd = (auto_windows_per_device(
                dims=self.dims, beam_size=dc.beam_size or 5,
                sample_len=dc.max_new_tokens, kv_int8=self.kv_int8,
                self_kv_int8=self.self_kv_int8, mesh=self.mesh)
                if on_cuda else 8)
        self.batch_size = max(1, len(self.mesh) * wpd)
        # a corrupt checkpoint fails here, not mid-job (the reference
        # runs 0.5 s of noise through a loaded model before serving);
        # random and injected weights skip it
        if self.model_dir is not None and os.environ.get(
                "ARIES_SMOKE_TEST", "1") != "0":
            self.smoke_test()

    @property
    def replicas(self) -> List["AriesTranscriber"]:
        """One engine view a mesh entry: this engine for the first."""
        return [self] + self._others

    def _make_replicas(self) -> List["AriesTranscriber"]:
        """The views of the mesh entries after the first: shallow copies
        holding that device's copy of the weights (and weight pack and
        suppress mask); entries on one device share it. (None holds this
        engine, so dropping it frees its card memory at once.)"""
        if len(self.mesh) == 1:
            return []
        trees = {}
        for d in dict.fromkeys(self.mesh):
            with on_card(d):  # the uploads are card work
                trees[d] = (replicate_params(self.params, [d])[0],
                            replicate_params(self.wpack, [d])[0]
                            if self.wpack is not None else None,
                            self.suppress_mask.to(d))
        reps = []
        for d in self.mesh[1:]:
            r = copy.copy(self)
            r.device = d
            r.params, r.wpack, r.suppress_mask = trees[d]
            reps.append(r)
        return reps

    @property
    def last_stats(self) -> Dict[str, Any]:
        """The port's counters of the calling thread's last call (else of
        the last call made)."""
        return getattr(self._tls, "stats", self._last_stats)

    @last_stats.setter
    def last_stats(self, stats: Dict[str, Any]) -> None:
        self._tls.stats = self._last_stats = stats

    def smoke_test(self) -> None:
        """0.5 s of noise through mel -> encoder -> one teacher-forced
        decoder call (the transcription's kernels on the card); raises
        RuntimeError on non-finite logits."""
        rng = np.random.default_rng(0)
        buf = np.zeros((1, self.WINDOW_SAMPLES), np.float32)
        buf[0, :8000] = 0.1 * rng.standard_normal(8000).astype(np.float32)
        with on_card(self.device):
            xa = self._encode_batch(self._mel(torch.from_numpy(buf).to(
                self.device)))
            sot = self.tokenizer.specials.sot
            logits = W.decoder_forward(
                self.params, torch.tensor([[sot]], device=self.device), xa,
                self.dims)
            finite = bool(torch.isfinite(logits).all())
        if not finite:
            raise RuntimeError(
                f"model smoke test failed: non-finite decoder logits "
                f"(corrupt checkpoint at {self.model_dir}?)")
        log.info("model smoke test passed (%s)", self.model_size)

    # ------------------------------------------------------------------

    def _load_tokenizer(self):
        """The checkpoint's BPE tokenizer, its special-token layout set
        from the model's vocabulary (51,864: English-only; else 51,766 +
        languages); the stand-in tokenizer without one."""
        if self.model_dir is None or not (
                Path(self.model_dir) / "vocab.json").exists():
            return DummyTokenizer(self.dims.n_vocab)
        tok = WhisperTokenizer.from_pretrained(str(self.model_dir))
        if tok.specials.n_vocab != self.dims.n_vocab:
            if self.dims.n_vocab == 51864:
                tok.specials = build_special_tokens(50257, 99, english=True)
            else:
                langs = self.dims.n_vocab - 51766
                if langs > 0:
                    tok.specials = build_special_tokens(
                        self.dims.n_vocab - langs - 1509, langs)
        return tok

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

    def _upload(self, pre: AudioPreloader
                ) -> Dict[torch.device, torch.Tensor]:
        """The whole file as int16 on each device of the mesh, zero-padded
        by one window so every window gathers in bounds (16-bit, the
        reference's pcm_s16le ingest contract): a PCM16 file's own
        samples, else the decoded audio quantized."""
        a16 = pre.audio_i16
        if a16 is None:
            a16 = np.clip(pre.audio * 32768.0, -32768, 32767).astype(np.int16)
        bufs = {}
        for d in dict.fromkeys(self.mesh):
            with on_card(d):
                buf = torch.zeros(len(a16) + self.WINDOW_SAMPLES,
                                  dtype=torch.int16, device=d)
                buf[: len(a16)] = torch.from_numpy(a16).to(d)
            bufs[d] = buf
        return bufs

    def _gather(self, audio16: Dict[torch.device, torch.Tensor],
                windows: Sequence[Window], idx: Sequence[int],
                win: Optional[int] = None) -> torch.Tensor:
        """(B, win) f32 windows gathered on this replica's device from its
        copy of the file (``_upload``), zeroed past each window's length;
        ``win`` defaults to the 30 s WINDOW_SAMPLES."""
        audio16 = audio16[self.device]
        win = win or self.WINDOW_SAMPLES
        starts = [int(round(windows[i].start * SR)) for i in idx]
        lens = [min(win, int(round(windows[i].duration * SR))) for i in idx]
        view = audio16.as_strided((audio16.numel() - win + 1, win), (1, 1))
        rows = view[torch.as_tensor(starts, device=self.device)]
        ar = torch.arange(win, device=self.device)
        keep = ar[None, :] < torch.as_tensor(lens, device=self.device)[:, None]
        return torch.where(keep, rows.float() * (1.0 / 32768.0), 0.0)

    def _batch_win(self, windows: Sequence[Window], idx: Sequence[int]
                   ) -> int:
        """The samples a batch is gathered at: 16 s under the bucket when
        every window of the batch fits, else 30 s."""
        if self.audio_ctx_bucket and all(
                windows[i].duration <= self.SHORT_WINDOW_S for i in idx):
            return self.SHORT_WINDOW_SAMPLES
        return self.WINDOW_SAMPLES

    def _plan(self, pre: AudioPreloader, duration: float,
              vad_filter: bool = True, vad_parameters: Optional[dict] = None,
              chunking_mode: str = "vad",
              chunk_length_minutes: Optional[float] = None) -> List[Window]:
        """The call's windows: fixed chunks (with overlap) tiled into 30 s
        windows that carry their chunk_id; VAD speech packed into windows;
        or, without VAD, the whole file tiled."""
        if chunking_mode == "fixed":
            windows: List[Window] = []
            for c in plan_chunks(
                    duration,
                    chunk_length_minutes or self.chunk_length_minutes,
                    self.overlap_seconds):
                t = c.start
                while t < c.end - 1e-6:
                    windows.append(Window(t, min(c.end, t + 30.0),
                                          chunk_id=c.chunk_id))
                    t += 30.0
            return windows
        if vad_filter:
            probs = self._speech_scorer(pre.audio)
            speech = collect_speech_segments(
                probs, VadOptions(**(vad_parameters or {})),
                total_samples=len(pre.audio))
            return plan_windows(speech, duration) if speech else []
        return plan_windows([(0.0, duration)], duration)

    def _encode_batch(self, mel: torch.Tensor) -> torch.Tensor:
        """The encoder over a batch's mel; counts the windows encoded at
        each context in ``last_stats["encodes"]`` ({T: windows})."""
        xa = W.encode(self.params, mel.to(self.activation_dtype), self.dims)
        with self._stats_lock:
            enc = self.last_stats.setdefault("encodes", {})
            T = int(xa.shape[1])
            enc[T] = enc.get(T, 0) + int(xa.shape[0])
        return xa

    def _encode_windows(self, audio16, windows: Sequence[Window],
                        idx: Sequence[int], win: Optional[int] = None
                        ) -> torch.Tensor:
        """Gather, mel and encode windows ``idx`` on this replica."""
        return self._encode_batch(self._mel(self._gather(audio16, windows,
                                                         idx, win)))

    def _on_shards(self, n: int, fn, sharded: bool = True) -> List[Any]:
        """``fn(i, replica, lo, hi)`` over the mesh's shards of ``n`` windows
        (parallel/mesh.py::map_shards): each in its replica's thread under
        its card's lock, with this call's ``last_stats``. ``sharded=False``
        runs all ``n`` on the first replica in the calling thread (the
        sequential mode, which holds that card's lock)."""
        if not sharded:
            with on_card(self.device):
                return [fn(0, self, 0, n)]
        stats = self.last_stats

        def one(i, device, lo, hi):
            self._tls.stats = stats
            return fn(i, self.replicas[i], lo, hi)

        return map_shards(self.mesh, n, one)

    def _decode_shards(self, xs: Sequence[Optional[torch.Tensor]],
                       prompt: np.ndarray, temperature: float,
                       sample_len: int, sharded: bool = True, **kw
                       ) -> Dict[str, np.ndarray]:
        """``_decode_batch`` of each replica's encoded shard ``xs[i]``
        (None: an empty shard) over its windows' prompt rows (a multiple of
        the windows, window-major), joined in window order. A sampled
        decode seeds each shard's generator alike: every replica samples
        its shard as a one-replica engine samples a batch of it."""
        n = sum(int(x.shape[0]) for x in xs if x is not None)
        g = prompt.shape[0] // n

        def one(i, r, lo, hi):
            return r._decode_batch(xs[i], prompt[lo * g:hi * g], temperature,
                                   sample_len, **kw)

        return join_shards(self._on_shards(n, one, sharded))

    def _call_opts(self, suppress_tokens=None, without_timestamps=None,
                   max_initial_timestamp=None, multilingual=None,
                   repetition_penalty=None, no_repeat_ngram_size=None,
                   prompt_reset_on_temperature=None) -> _CallOpts:
        """A call's decode options, each None taken from config.decode."""
        dc = self.config.decode
        pick = lambda v, d: d if v is None else v
        mit = pick(max_initial_timestamp, dc.max_initial_timestamp)
        return _CallOpts(
            ids=dataclasses.replace(
                self.ids,
                max_initial_timestamp_index=max(0, int(round(mit / 0.02)))),
            suppress_mask=(self.suppress_mask if suppress_tokens is None
                           else self._make_suppress_mask(suppress_tokens)),
            with_timestamps=not pick(without_timestamps,
                                     dc.without_timestamps),
            multilingual=bool(pick(multilingual, dc.multilingual)),
            repetition_penalty=float(pick(repetition_penalty,
                                          dc.repetition_penalty)),
            no_repeat_ngram_size=int(pick(no_repeat_ngram_size,
                                          dc.no_repeat_ngram_size)),
            prompt_reset_on_temperature=float(pick(
                prompt_reset_on_temperature,
                dc.prompt_reset_on_temperature)))

    def _decode_batch(self, xa: torch.Tensor, prompt: np.ndarray,
                      temperature: float, sample_len: int, seed: int = 0,
                      beam_size: int = 1, patience: float = 1.0,
                      length_penalty: float = 1.0,
                      opts: Optional[_CallOpts] = None, sot_index: int = 0,
                      prompt_start: int = 0) -> Dict[str, Any]:
        """Decode the windows of ``xa``: beam search when ``beam_size`` > 1
        at temperature 0, else greedy / sampled over the prompt's rows
        (a multiple of the windows, window-major). ``sot_index`` is the
        <|sot|> column of the prompt (its no-speech logits), and a
        left-padded prompt's first real token is at ``prompt_start``.
        ``opts`` default to config.decode's."""
        opts = opts or self._call_opts()
        rep = opts.repetition_penalty
        suppress_mask = opts.suppress_mask.to(self.device)
        common = dict(
            with_timestamps=opts.with_timestamps,
            kv_int8=self.kv_int8, self_kv_int8=self.self_kv_int8,
            repetition_penalty=rep if rep and rep != 1.0 else None,
            no_repeat_ngram_size=int(opts.no_repeat_ngram_size or 0),
            fused=self.fused, wpack=self.wpack, prompt_start=prompt_start)
        prompt_t = torch.as_tensor(prompt, device=self.device)
        t0 = time.time()
        if beam_size > 1 and temperature == 0:
            out = G.beam_search_decode(
                self.params, xa, prompt_t, self.dims, opts.ids,
                suppress_mask, sot_index, beam_size=beam_size,
                sample_len=sample_len, length_penalty=length_penalty,
                patience=patience, **common)
            rows = int(xa.shape[0]) * beam_size
        else:
            gen = None
            if temperature > 0:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed)
            out = G.greedy_decode(
                self.params, xa, prompt_t, self.dims, opts.ids,
                suppress_mask, sot_index, float(temperature), gen,
                sample_len=sample_len, **common)
            rows = int(prompt_t.shape[0])
        res = {k: v.cpu().numpy() for k, v in out.items()}
        stats = {"rows": rows, "windows": int(xa.shape[0]),
                 "audio_ctx": int(xa.shape[1]),
                 "prompt_start": int(prompt_start),
                 "cache_len": int(prompt_t.shape[1]) + sample_len,
                 "steps": int(res["steps"]),
                 "temperature": float(temperature), "beam_size": beam_size,
                 "seconds": time.time() - t0}
        if "permuted" in res:
            stats["permuted"] = int(res["permuted"])
        with self._stats_lock:
            self.last_stats.setdefault("decodes", []).append(stats)
        return res

    def _probe_languages(self, xa: torch.Tensor
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """(language token id, probability) of every window of ``xa``: one
        batched single-step probe over the encoded audio."""
        sp = self.tokenizer.specials
        lang0 = min(sp.language_tokens.values())
        probs = G.detect_language_batched(
            self.params, xa, self.dims, sp.sot, lang0,
            sp.num_languages).float().cpu().numpy()
        idx = probs.argmax(axis=1)
        return lang0 + idx, probs[np.arange(len(idx)), idx]

    def detect_language(self, mel: torch.Tensor) -> Tuple[str, float]:
        """Language of the first window (faster-whisper's detection)."""
        sp = self.tokenizer.specials
        lang0 = min(sp.language_tokens.values())
        with on_card(self.device):
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
        repetition_penalty: Optional[float] = None,
        no_repeat_ngram_size: Optional[int] = None,
        temperature: Optional[Sequence[float]] = None,
        vad_filter: bool = True,
        vad_parameters: Optional[dict] = None,
        initial_prompt: Optional[str] = None,
        prefix: Optional[str] = None,
        hotwords: Optional[str] = None,
        word_timestamps: bool = False,
        length_penalty: Optional[float] = None,
        compression_ratio_threshold: float = 2.4,
        log_prob_threshold: float = -1.0,
        no_speech_threshold: float = 0.6,
        max_new_tokens: int = 224,
        progress_callback=None,
        chunking_mode: str = "vad",
        chunk_size: Optional[float] = None,
        overlap_strategy: Optional[str] = None,
        condition_on_previous_text: bool = False,
        resume_path: Optional[str] = None,
        suppress_tokens: Optional[Sequence[int]] = None,
        without_timestamps: Optional[bool] = None,
        max_initial_timestamp: Optional[float] = None,
        prompt_reset_on_temperature: Optional[float] = None,
        multilingual: Optional[bool] = None,
        prepend_punctuations: Optional[str] = None,
        append_punctuations: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Transcribe one file end to end (VAD or fixed chunks, greedy or
        beam search, fallback ladder, optional word timestamps); returns
        the result dict and writes the requested output formats (txt,
        json, srt). The signature is the JAX engine's.

        ``chunking_mode="fixed"`` plans the reference's coarse chunks with
        overlap (``chunk_size`` seconds implies it), each tiled into 30 s
        windows; ``overlap_strategy`` ("drop" | "merge", default
        ``config.chunking``'s) then reconciles the overlap's duplicates.
        ``vad_filter=False`` tiles the whole file; ``vad_parameters`` are
        VadOptions fields. faster-whisper's options: ``suppress_tokens``
        (-1 expands to the non-speech set), ``without_timestamps`` (each
        window one untimed segment), ``max_initial_timestamp`` (seconds),
        ``repetition_penalty``, ``no_repeat_ngram_size``, ``multilingual``
        (a language per window; every segment carries its window's).
        ``progress_callback(done, total)`` is called after each batch.
        ``None`` defers to ``config.decode``. Conditioned decoding:
        ``initial_prompt`` (or else ``hotwords``) goes after
        <|startofprev|>, at most 223 tokens; ``prefix`` forces the first
        window's transcript (that window decodes alone, the rest batched);
        ``condition_on_previous_text=True`` decodes window by window, each
        prompted with the text before it, which resets when a window's
        accepted temperature exceeds ``prompt_reset_on_temperature``.
        ``resume_path`` keeps a resume journal (JSONL, the JAX engine's
        format): a rerun with the same plan and options decodes only the
        windows it lacks."""
        t0 = time.time()
        # host work outside the card lock: read, decode and resample
        pre = AudioPreloader(audio_path)
        t_wait = time.time()
        # one job's card work at a time: encode, decode calls with their
        # graph captures, the word pass (last_stats is this call's). Across
        # several cards the calling thread holds the engine's own lock and
        # each shard its card's (one replica: the card's over the call)
        with (on_card(self.device) if len(self.mesh) == 1
              else self._call_lock):
            self.last_stats = {"card_wait_s": time.time() - t_wait}
            self.last_monitor = None
            diag = WorkerDiagnostics()
            self.last_diagnostics = diag
            dc = self.config.decode
            beam = dict(
                beam_size=max(1, int(beam_size if beam_size is not None
                                     else dc.beam_size)),
                patience=float(patience if patience is not None
                               else dc.patience),
                length_penalty=float(
                    length_penalty if length_penalty is not None
                    else dc.length_penalty))
            opts = self._call_opts(
                suppress_tokens=suppress_tokens,
                without_timestamps=without_timestamps,
                max_initial_timestamp=max_initial_timestamp,
                multilingual=multilingual,
                repetition_penalty=repetition_penalty,
                no_repeat_ngram_size=no_repeat_ngram_size,
                prompt_reset_on_temperature=prompt_reset_on_temperature)

            duration = pre.duration
            if chunk_size is not None:
                chunking_mode = "fixed"  # a per-call chunk size implies it
            windows = self._plan(pre, duration, vad_filter, vad_parameters,
                                 chunking_mode=chunking_mode,
                                 chunk_length_minutes=(
                                     chunk_size / 60.0 if chunk_size
                                     else None))
            log.info("planned %d windows for %.1fs audio", len(windows),
                     duration)

            temps = (temperature if temperature is not None
                     else dc.temperature)
            if isinstance(temps, (int, float)):
                temps = (float(temps),)
            temps = tuple(temps)
            thresholds = (compression_ratio_threshold, log_prob_threshold,
                          no_speech_threshold)

            segments: List[Dict[str, Any]] = []
            lang = {"code": language, "prob": 1.0 if language else None}
            if windows:
                audio16 = self._upload(pre)
                sp = self.tokenizer.specials
                if language is None and sp.language_tokens:
                    if (opts.multilingual or condition_on_previous_text
                            or prefix or os.environ.get(
                                "ARIES_DEFER_LANG", "1") == "0"):
                        # the file's language from its first window at 30 s
                        # (ARIES_DEFER_LANG=0, read per call as in JAX,
                        # asks for this too)
                        with on_card(self.device):
                            mel0 = self._mel(self._gather(audio16, windows,
                                                          [0]))
                            lang["code"], lang["prob"] = (
                                self.detect_language(mel0))
                    else:
                        # detected from the first batch's first window, at the
                        # batch's context, before that batch decodes
                        lang["defer"] = True
                # a deferred language's token is a placeholder until then
                prompt_ids = list(sp.sot_sequence(
                    "en" if lang.get("defer") else lang["code"], task))
                sot_idx = 0
                prev_text = initial_prompt or hotwords
                if prev_text:
                    prev = [sp.sot_prev] + list(self.tokenizer.encode(
                        " " + prev_text.strip()))[-223:]
                    prompt_ids = prev + prompt_ids
                    sot_idx = len(prev)
                prefix_ids = (list(self.tokenizer.encode(" " + prefix.strip()))
                              if prefix else [])
                journal = None
                if resume_path:
                    # everything that changes the decoded output, as the JAX
                    # engine signs it (prompt_ids carry language, task and
                    # initial prompt)
                    opts_sig = json.dumps([
                        prompt_ids, prefix_ids, list(temps),
                        opts.repetition_penalty, opts.no_repeat_ngram_size,
                        beam["patience"], beam["length_penalty"],
                        condition_on_previous_text, self.audio_ctx_bucket,
                        not opts.with_timestamps,
                        opts.ids.max_initial_timestamp_index,
                        opts.multilingual,
                        opts.prompt_reset_on_temperature,
                        list(suppress_tokens) if suppress_tokens is not None
                        else None])
                    journal = ResumeJournal(resume_path, plan_signature(
                        windows, self.model_size, beam["beam_size"],
                        max_new_tokens, opts_sig))
                run = dict(temps=temps, sample_len=max_new_tokens,
                           thresholds=thresholds, best_of=best_of, beam=beam,
                           opts=opts, journal=journal)
                if condition_on_previous_text:
                    with on_card(self.device):  # on the first replica
                        segments = self._transcribe_windows_sequential(
                            audio16, windows, prompt_ids, sot_idx,
                            prefix_ids, progress_callback=progress_callback,
                            **run)
                else:
                    skip = set()
                    done = journal.done if journal else {}
                    if prefix_ids and 0 not in done:
                        # the prefix forces the first window only: it decodes
                        # alone, the rest batched without it
                        with on_card(self.device):
                            segments += self._transcribe_windows_sequential(
                                audio16, windows[:1], prompt_ids, sot_idx,
                                prefix_ids, **run)
                        skip = {0}
                    segments += self._transcribe_windows(
                        audio16, windows, prompt_ids, sot_idx, diag, lang,
                        progress_callback, skip_ids=skip, **run)
                    segments.sort(key=lambda s: (s["start"], s["end"]))
                if chunking_mode == "fixed":
                    strategy = (overlap_strategy
                                or self.config.chunking.overlap_strategy)
                    segments = (merge_overlapping_segments(segments)
                                if strategy == "merge"
                                else remove_overlaps_drop(segments))
            language = lang["code"]

            if word_timestamps and segments:
                from whisper_aries_tpu_torch.align.word_align import (
                    add_word_timestamps,
                )

                # no catch-all here: a kernel error in the word pass fails the
                # call (the JAX engine logs a warning instead)
                t_w = time.time()
                with on_card(self.device):  # on the first replica
                    self.last_stats["words"] = add_word_timestamps(
                        self, segments, pre.audio, windows,
                        prepend_punctuations=(
                            dc.prepend_punctuations
                            if prepend_punctuations is None
                            else prepend_punctuations),
                        append_punctuations=(
                            dc.append_punctuations
                            if append_punctuations is None
                            else append_punctuations))
                self.last_stats["words"]["seconds"] = time.time() - t_w

            wall = time.time() - t0
            result: Dict[str, Any] = {
                "success": True,
                "segments": segments,
                "text": " ".join(s["text"] for s in segments).strip(),
                "language": language,
                "language_probability": lang["prob"],
                "duration": duration,
                "processing_time": wall,
                "real_time_factor": duration / wall if wall > 0 else 0.0,
                "num_windows": len(windows),
                # the JAX engine's report (None without a batched pass)
                "performance": (self.last_monitor.final_report()
                                if self.last_monitor else None),
                "diagnostics": diag.summary(),
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

    def _transcribe_windows(self, audio16, windows, prompt_ids, sot_idx,
                            diag, lang, progress_callback=None, *, temps,
                            sample_len, thresholds, best_of, beam, opts,
                            journal=None, skip_ids=frozenset()
                            ) -> List[Dict[str, Any]]:
        """Every window in batches, but those the journal holds (their
        segments taken from it) and ``skip_ids`` (decoded by the caller).
        Under the bucket, short windows come first so whole batches
        qualify for the 16 s context. Each batch is cut into the mesh's
        shards: the replicas gather, encode and probe their windows, then
        decode them, each in its thread. A deferred language
        (``lang["defer"]``) is detected from the first batch's first window
        and written into every prompt; under ``opts.multilingual`` each
        window's own detected language token replaces it in its prompt row
        (beam rows, and the fallback ladder's, take their window's). A
        window whose tokens fail to parse becomes one failed segment and is
        not journaled (a resume retries it).

        The batch loop is the JAX engine's double-buffered one: at depth 2
        (``ARIES_PIPELINE`` "1", the default) batch k's host parse runs in
        a helper thread while this thread gathers, encodes, probes and
        decodes batch k + 1; then batch k's fallback ladder runs, so the
        card's order is decode 0, decode 1, ladder 0, decode 2, ladder 1,
        ... The helper touches no tensor and takes no lock; its events are
        logged here after batch k + 1's DECODING, as the JAX engine logs
        them. Depth 1 runs each batch to its end. On a card's
        out-of-memory error (utils/memory.py::is_oom_error) depth 2 drops
        to depth 1 with the batch kept; at depth 1 the batch halves and the
        windows left are planned again at the new size. Each batch is one
        unit of the call's PerformanceMonitor, timed from the start of its
        dispatch, on device ``batch % replicas``; a segment's ``worker_id``
        is its row in the batch modulo the replicas (the JAX engine's).
        ``last_stats["parses"]`` holds each batch's parse seconds and the
        seconds of it that overlapped the next batch's card work and its
        decode."""
        parse_skip = len(prompt_ids)
        N = len(windows)
        n_dev = len(self.mesh)
        done = dict(journal.done) if journal is not None else {}
        all_segments: List[Dict[str, Any]] = [
            s for wid, segs in done.items() if wid not in skip_ids
            for s in segs]
        pending = [i for i in range(N) if i not in done and i not in skip_ids]
        if self.audio_ctx_bucket:
            pending.sort(key=lambda i: (
                windows[i].duration > self.SHORT_WINDOW_S, i))
        for i in pending:
            diag.log(i, "PLANNED",
                     f"{windows[i].start:.1f}-{windows[i].end:.1f}s")
        monitor = PerformanceMonitor(
            total_audio_s=sum(windows[i].duration for i in pending))
        self.last_monitor = monitor
        has_langs = bool(self.tokenizer.specials.language_tokens)
        sp = self.tokenizer.specials
        lang0 = min(sp.language_tokens.values()) if has_langs else 0
        n_pend = len(pending)
        prompt_row = list(prompt_ids)

        def plan(start: int, cap: int) -> Tuple[int, List[Tuple[int, int]]]:
            """(batch size, [(offset, size)]) of pending[start:]: the windows
            ceil-divided over the batch count ``cap`` implies, so no batch
            is mostly padding, the size rounded up to a multiple of the
            replicas, so their shards are equal."""
            n = n_pend - start
            if n <= 0:
                return cap, []
            per = -(-n // -(-n // cap))
            size = min(cap, -(-per // n_dev) * n_dev)
            return size, [(s, min(size, n_pend - s))
                          for s in range(start, n_pend, size)]

        def dispatch(p: int, nB: int) -> Dict[str, Any]:
            """The card work of pending[p:p + nB], in this thread and the
            replicas': gather, mel, encode, language probe, decode. The
            outputs come back as host arrays."""
            batch_idx = pending[p:p + nB]
            t0 = time.time()
            prompt = np.tile(np.asarray(prompt_row, np.int64),
                             (len(batch_idx), 1))
            win_langs: Optional[List[str]] = None
            defer = bool(lang.get("defer"))
            win = self._batch_win(windows, batch_idx)
            for i in batch_idx:
                diag.log(i, "ENCODING", f"batch@{p} size={len(batch_idx)}")

            def encode(i, r, lo, hi):
                xa = r._encode_windows(audio16, windows, batch_idx[lo:hi],
                                       win)
                first = (r._probe_languages(xa[:1]) if defer and lo == 0
                         else None)
                langs = (r._probe_languages(xa)[0]
                         if opts.multilingual and has_langs else None)
                return xa, first, langs

            shards = self._on_shards(len(batch_idx), encode)
            if defer:
                # every later batch's prompt carries it
                lang.pop("defer")
                tok, prob = shards[0][1]
                lang["code"] = LANGUAGES[int(tok[0]) - lang0]
                lang["prob"] = float(prob[0])
                prompt_row[sot_idx + 1] = int(tok[0])
                prompt[:, sot_idx + 1] = int(tok[0])
            if opts.multilingual and has_langs:
                tok = np.concatenate([sh[2] for sh in shards
                                      if sh is not None])
                prompt[:, sot_idx + 1] = tok
                win_langs = [LANGUAGES[int(t) - lang0] for t in tok]
            t_dec = time.time()
            out = self._decode_shards(
                [sh[0] if sh is not None else None for sh in shards],
                prompt, temps[0], sample_len, opts=opts, sot_index=sot_idx,
                **beam)
            decoded = (t_dec, time.time())
            del shards
            for i in batch_idx:
                diag.log(i, "DECODING", f"batch@{p} size={len(batch_idx)}")
            return dict(batch_idx=batch_idx, prompt=prompt, out=out,
                        win_langs=win_langs, t0=t0, decoded=decoded)

        def parse(head: Dict[str, Any]) -> Dict[str, Any]:
            """The host parse of a decoded batch (the helper's work at depth
            2): its rows, its silent and its failing windows, and the
            diagnostics events, kept for the calling thread to log."""
            t0 = time.time()
            events = _EventBuffer()
            out, prompt = head["out"], head["prompt"]
            rows, fails, silent = [], [], []
            for w_i, win_id in enumerate(head["batch_idx"]):
                window = windows[win_id]
                segs, quality, failed = self._parse_or_fail(
                    out, w_i, window, parse_skip, thresholds, win_id, events)
                if quality["is_silence"]:
                    silent.append(win_id)
                    events.log(win_id, "COMPLETED", "silence")
                    continue
                if quality["needs_fallback"] and len(temps) > 1:
                    fails.append((win_id, window, prompt[w_i], segs))
                    events.log(win_id, "FALLBACK",
                               f"cr={quality['compression_ratio']:.2f} "
                               f"lp={out['avg_logprob'][w_i]:.2f}")
                rows.append((w_i, win_id, window, segs, failed))
            return dict(rows=rows, fails=fails, silent=silent,
                        events=events.events, span=(t0, time.time()))

        n_parsed = bi = 0

        def finish(head: Dict[str, Any], parsed: Dict[str, Any]) -> None:
            """Log a parsed batch's events, run its fallback ladder (card
            work, in this thread), then journal, record and report it."""
            nonlocal n_parsed, bi
            for unit, state, detail in parsed["events"]:
                diag.log(unit, state, detail)
            batch_idx, win_langs = head["batch_idx"], head["win_langs"]
            if journal is not None:
                for win_id in parsed["silent"]:
                    journal.record(win_id, [])
            fb: Dict[int, Tuple[List[Dict[str, Any]], float]] = {}
            if parsed["fails"]:
                fb = self._fallback_windows(audio16, windows, parsed["fails"],
                                            temps[1:], sample_len,
                                            thresholds, best_of, parse_skip,
                                            opts, sot_index=sot_idx)
            for w_i, win_id, window, segs, failed in parsed["rows"]:
                if win_id in fb:
                    segs = fb[win_id][0]
                if win_langs is not None and not failed:
                    for s in segs:
                        s["language"] = win_langs[w_i]
                for s in segs:
                    s["chunk_id"] = window.chunk_id
                    s["window_id"] = win_id
                    s["worker_id"] = w_i % n_dev
                if not failed:
                    if journal is not None:
                        journal.record(win_id, segs)
                    diag.log(win_id, "COMPLETED", f"{len(segs)} segment(s)")
                all_segments.extend(segs)
            if journal is not None:
                journal.flush()  # one fsync a batch
            monitor.record(bi, sum(windows[i].duration for i in batch_idx),
                           time.time() - head["t0"], device=bi % n_dev,
                           kind="batch")
            bi += 1
            n_parsed += len(batch_idx)
            if progress_callback:
                progress_callback(len(done) + n_parsed, N)

        depth = 2 if os.environ.get("ARIES_PIPELINE", "1") == "1" else 1
        B, grid = plan(0, self.batch_size)
        gi = 0
        held: Optional[Dict[str, Any]] = None  # decoded, not yet parsed
        parses = self.last_stats.setdefault("parses", [])
        with ThreadPoolExecutor(1, thread_name_prefix="aries-parse") as helper:
            while gi < len(grid) or held is not None:
                job = None
                if held is not None and depth > 1 and gi < len(grid):
                    job = helper.submit(parse, held)
                nxt = None
                if gi < len(grid) and (held is None or depth > 1):
                    try:
                        nxt = dispatch(*grid[gi])
                        gi += 1
                    except Exception as e:
                        if not is_oom_error(e) or (depth == 1 and B == 1):
                            raise
                        if depth > 1:
                            # the batch kept, the rest of the grid too
                            depth = 1
                            log.warning("device OOM — disabling batch "
                                        "pipelining")
                        else:
                            B = max(1, B // 2)
                            self.batch_size = B
                            log.warning("device OOM — retrying with "
                                        "batch_size=%d", B)
                            grid = grid[:gi] + plan(grid[gi][0], B)[1]
                        for d in dict.fromkeys(self.mesh):
                            if d.type == "cuda":
                                with torch.cuda.device(d):
                                    torch.cuda.empty_cache()
                if held is not None:
                    parsed = job.result() if job is not None else parse(held)
                    # the parse's seconds beside the next batch's card
                    # work: all of it, and its decode
                    a, b = parsed["span"]
                    beside = dict(overlap_dispatch_s=0.0, overlap_decode_s=0.0)
                    if job is not None and nxt is not None:
                        d0, d1 = nxt["decoded"]
                        beside = dict(
                            overlap_dispatch_s=max(0.0, min(b, d1)
                                                   - max(a, nxt["t0"])),
                            overlap_decode_s=max(0.0, min(b, d1)
                                                 - max(a, d0)))
                    parses.append(dict(
                        batch=bi, windows=len(held["batch_idx"]),
                        seconds=b - a, helper=job is not None, **beside))
                    finish(held, parsed)
                held = nxt
        self.last_stats["pipeline_depth"] = depth
        all_segments.sort(key=lambda s: (s["start"], s["end"]))
        return all_segments

    def _transcribe_windows_sequential(self, audio16, windows, prompt_ids,
                                       sot_idx, prefix_ids=(),
                                       progress_callback=None, *, temps,
                                       sample_len, thresholds, best_of, beam,
                                       opts, journal=None
                                       ) -> List[Dict[str, Any]]:
        """Window by window, each prompted with the text before it: the
        prompt is <|startofprev|> + the previous windows' tokens (the last
        223 - len(sot sequence)) + the sot sequence, or ``prompt_ids``
        while there is no context; ``prefix_ids`` follow it in the first
        window. Every prompt is left-padded with -1 to P_max = 224 + the
        sot sequence + the prefix, so each decode call runs at its own
        ``prompt_start`` (the pad) over a cache of P_max + ``sample_len``
        positions. Silence, a parse failure or a fallback whose accepted
        temperature exceeds ``opts.prompt_reset_on_temperature`` resets
        the context; a resume rebuilds it from the journal's tokens and
        reset marks."""
        sp = self.tokenizer.specials
        prefix_ids = list(prefix_ids)
        sot_seq = list(prompt_ids[sot_idx:])
        P_max = 224 + len(sot_seq) + len(prefix_ids)
        has_langs = bool(sp.language_tokens) and len(sot_seq) >= 2
        context = lambda segs: [t for s in segs for t in s.get("tokens", [])
                                if t < sp.eot]
        all_segments: List[Dict[str, Any]] = []
        prev_tokens: List[int] = []
        done = dict(journal.done) if journal is not None else {}
        for wi, window in enumerate(windows):
            if wi in done:
                segs = done[wi]
                all_segments.extend(segs)
                prev_tokens = ([] if wi in journal.reset_ids
                               else context(segs))
                continue
            pfx = prefix_ids if wi == 0 else []
            if prev_tokens:
                keep = max(0, 223 - len(sot_seq))
                prompt = ([sp.sot_prev] + (prev_tokens[-keep:] if keep else [])
                          + sot_seq + pfx)
            else:
                prompt = list(prompt_ids) + pfx
            w_sot = P_max - len(sot_seq) - len(pfx)
            pad = P_max - len(prompt)
            prompt = [-1] * pad + prompt  # the decoder masks the pad
            parse_skip = len(prompt) - len(pfx)
            xa = self._encode_windows(audio16, windows, [wi])
            win_lang = None
            if opts.multilingual and has_langs:
                tok, _ = self._probe_languages(xa)
                prompt[w_sot + 1] = int(tok[0])
                win_lang = LANGUAGES[int(tok[0])
                                     - min(sp.language_tokens.values())]
            prompt = np.asarray(prompt, np.int64)
            out = self._decode_batch(xa, prompt[None], temps[0], sample_len,
                                     opts=opts, sot_index=w_sot,
                                     prompt_start=pad, **beam)
            del xa
            segs, quality, failed = self._parse_or_fail(
                out, 0, window, parse_skip, thresholds, wi)
            if failed:
                prev_tokens = []
            if quality["is_silence"]:
                prev_tokens = []
                if journal is not None:
                    journal.record(wi, [], sync=True)
                continue
            was_reset = False
            if quality["needs_fallback"] and len(temps) > 1:
                segs, used_t = self._fallback_windows(
                    audio16, windows, [(wi, window, prompt, segs)],
                    temps[1:], sample_len, thresholds, best_of, parse_skip,
                    opts, sot_index=w_sot, prompt_start=pad,
                    sharded=False)[wi]
                # the context resets only when the ACCEPTED temperature
                # exceeds the threshold
                was_reset = used_t > opts.prompt_reset_on_temperature
            if was_reset:
                prev_tokens = []
            elif not failed:
                prev_tokens = context(segs)
            for s in segs:
                if win_lang is not None:
                    s["language"] = win_lang
                s["chunk_id"] = window.chunk_id
                s["window_id"] = wi
                s["worker_id"] = 0
            if journal is not None and not failed:
                # reset=True replays the context reset on resume
                journal.record(wi, segs, reset=was_reset, sync=True)
            all_segments.extend(segs)
            if progress_callback:
                progress_callback(wi + 1, len(windows))
        all_segments.sort(key=lambda s: (s["start"], s["end"]))
        return all_segments

    def _parse_or_fail(self, out, row, window, parse_skip, thresholds,
                       win_id, diag=None):
        """(segments, quality, failed) of one decoded row. Tokens that do
        not parse make one failed segment spanning the window (the file
        goes on; the window is not journaled). Only the host parse is
        caught: a decode error fails the call."""
        try:
            segs, quality = self._parse_one(
                out["tokens"][row], window, parse_skip,
                float(out["avg_logprob"][row]),
                float(out["no_speech_prob"][row]), thresholds)
            return segs, quality, False
        except Exception as e:
            log.warning("window %d (%.1f-%.1fs) failed: %s", win_id,
                        window.start, window.end, e)
            if diag is not None:
                diag.log(win_id, "ERROR", str(e))
            return ([{"start": window.start, "end": window.end, "text": "",
                      "success": False, "error": str(e),
                      "avg_logprob": 0.0, "no_speech_prob": 0.0}],
                    {"is_silence": False, "needs_fallback": False}, True)

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
                          thresholds, best_of, parse_skip, opts,
                          sot_index=0, prompt_start=0, sharded=True
                          ) -> Dict[int, Tuple[List[Dict[str, Any]], float]]:
        """Temperature-fallback ladder for failing windows: at each rung,
        ``best_of`` samples of every still-failing window decode as one
        batch (the samples of a window share its cross K/V; every window
        re-encoded at 30 s, each sample's prompt its window's row, language
        and left pad included) and the best by sum logprob is kept. The
        group's windows are cut into the mesh's shards as a batch is
        (``sharded=False``: all on the first replica).
        Returns {window id: (segments, accepted temperature)}."""
        K = max(1, best_of)
        results: Dict[int, Tuple[List[Dict[str, Any]], float]] = {}
        last_t = float(temps[-1])
        for g0 in range(0, len(fails), self.FALLBACK_GROUP):
            group = fails[g0:g0 + self.FALLBACK_GROUP]
            ids = [f[0] for f in group]
            xs = self._on_shards(len(group), lambda i, r, lo, hi: (
                r._encode_windows(audio16, windows, ids[lo:hi])), sharded)
            prompt = np.repeat(np.stack([np.asarray(f[2]) for f in group]),
                               K, axis=0)
            best = {f[0]: (f[3], last_t) for f in group}
            pending = dict(enumerate(group))
            for t_i, t in enumerate(temps):
                if not pending:
                    break
                out = self._decode_shards(xs, prompt, float(t), sample_len,
                                          sharded, seed=1234 + t_i,
                                          opts=opts, sot_index=sot_index,
                                          prompt_start=prompt_start)
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
            del xs
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


#: the reference's class name
OptimizedParallelTranscriber = AriesTranscriber
