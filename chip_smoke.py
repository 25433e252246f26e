#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (whisper_aries_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, in order. An error exits non-zero at once and no phase's error is
caught; a kernel check that fails is printed at once and fails the run
(non-zero exit, no result) after the last phase, so one run shows them all.
  1. header: the card's name and power limit (nvidia-smi); TF32 off for
     matmul and cuDNN.
  2. build: compile every kernel from the sources in the checkout, one nvcc
     per source, all in parallel; then the host library (the port's C++
     codecs, resampler and DTW in whisper_aries_tpu_torch/native/) with
     g++, and look for each codec's system library.
  3. kernels: hold each kernel against its plain PyTorch version on the card
     at the main paths' large-v3 shapes (mel at B=8 with 128 and 80 mels,
     and at 80 mels on the diarizer trainers' 10 s windows and 2 s
     utterances, each example floored at its own max - 8; encoder
     attention at (8, 20, 1500, 64) bf16; the training attention's
     forward (out and row log-sum-exp) and backward (dq, dk, dv) at (2,
     20, 1500, 64) f32 with "one key past T scored", two backward runs
     bitwise, timed beside scaled_dot_product_attention's f32 forward and
     backward; and at the 16 s
     bucket's shapes: mel at 8 x 256,000 samples, encoder attention at
     (8, 20, 800, 64), the decode step over Ta 800 cross K/V at R 8 and
     R 40, the grouped cross-attention at 8 windows x G 3 and 5 over 800
     keys and the W8A16 GEMM at M 6400 = 8 x 800, each with "keys past Ta
     read from the 30 s pad" or the 30 s shapes' mistakes; each entry's
     "bucket" holds its times and bound there; the decoder-layer kernels
     at R=8 for both self-cache dtypes over several positions, the grouped
     int8 cross-attention at (8 windows, 20 heads, 5 queries, 1500 keys) and
     at the prefill's (6 windows, 3, 15 and 20 queries, bf16 and f32), the
     beam tail at 8
     windows x 5 beams x 51866, the beam-cache reorder on the int8
     self-cache leaves at R=40), and time kernel, plain version and, where
     one exists, the one-call PyTorch yardstick; the decode step is also
     held, timed and profiled at the slices' shapes, R=6 (6 windows, greedy)
     and R=30 (6 windows x 5, beam and best_of), and at R=40 (8 windows x
     5 beams), each window's rows sharing its cross K/V, and one whole beam
     step (layers, vocab, tail, reorder) is profiled
     at R=30 and R=40. At each R two runs of the step give the same bits,
     and a CUDA graph replay (DecodeStepGraph) gives the bits of a direct
     launch over four positions, with an in-place beam reorder between;
     the step is timed as a replay and as direct launches, and profiled as
     a replay with and without programmatic dependent launch (launches per
     step, the share of the wall some kernel is resident, each kernel's own
     device time). The split-KV self-attention is held at valid_start 200,
     pos 300 (whole splits empty), and the step's split cross-attention
     on its own. The W8A16 GEMM is held at the int8 slices' shapes
     (M 9000 = 6 windows x 1500 with K, N in {1280, 5120}, an odd M, the
     words slice's prefill at M 18, and the six dense layers of a decoder
     layer at M 6 and at M 1), each on the path ops/quant.py::gemm_plan
     gives it (TMA + wgmma for large M, the split-K cluster weight stream
     for small M; the "quant_matmul shapes" line names each row's path,
     K slices and row tile, with cuBLAS's event and device times beside,
     and the wgmma path's dequant scratch is held bit for bit against
     dequantize_bf16); both paths are timed, forced, over M 32-1024 at
     N 1280 / 3840 / 5120 ("quant_matmul crossover" line, the
     measurement the plan's cut-over is set from); the int8
     self-attention step at 6 rows x 20 heads over 227 positions, and one
     unfused int8-self-cache decode step is profiled. Errors are taken
     over max |want|, and where a check names a mistake (keys past T
     scored, a dropped tail, the next head's keys scored in the last tile,
     a missing key, every window reading window 0's K/V, ties to the
     highest index, the scale on the sum, one K slice's partials dropped
     from the cluster sum, the last row tile's rows unwritten, an ignored
     mask, a dropped last position, the appended
     position left unscored, one split's P . V dropped from the int8
     self-attention's or the grouped cross-attention's cluster sum, one
     chunk's candidates dropped from the beam tail's merge, one mel band's
     last bin dropped), the same error of a plain version making that
     mistake must exceed the limit. The int8 self-attention (split-KV
     clusters) and the beam tail (several blocks a beam row) are also
     held at two runs giving the same bits, and their C plans equal their
     Python mirrors. The unfused step is replayed from one CUDA graph
     (UnfusedStepGraph), which must give the bits of direct launches; both
     are timed and profiled, under ARIES_QUANT_IMPL=pallas and =native.
     The native int8 path's two kernels (csrc/int8_gemm.cu: the row
     quantization and the s8 tensor-core GEMM) at a large-v3 layer's four
     products at M 6, 18, 227, 1135, 6400 and 9000, bf16 activations with
     a zero row, a row of exact halves and a row whose max tells a / 127
     from a * (1 / 127): both bit for bit their plain versions (the GEMM in
     bf16 and f32 out), each named mistake failing its hold (ax * (1 /
     127), roundf, sx = 0 on a zero row; (acc * s) * sx, B read as if
     K-major, a K slice dropped); timed beside the plain versions,
     torch._int_mm (B row-major and column-major, where it takes the call)
     with the torch ops around it, kernel 5 and cuBLAS bf16 ("int8 native
     shapes" line); the GEMM at forced (row tile, K slices) around its
     plan at M 6-1135, every plan the same bits ("int8 GEMM plan sweep",
     the measurement ops/quant.py's plan is set from).
     The conditioned shapes (conditioned_phase): the fused step over a
     T 451 self cache at R 1 and R 5 (one window's cross K/V),
     valid_start 0 / 100 / 224, pos 227 and 450, teacher-forced per layer
     with "keys before valid_start scored", two runs and a graph replay
     bitwise, and a whole step through generate._step_logits against the
     plain stack with "positional embedding not offset by valid_start";
     kernel 6's prefills at 1 window x G 227 and x G 1135 (the ladder's 5
     rows) with "the last query chunk dropped"; kernel 5 at M 227 and M
     1135 (K = N = 1280); kernel 7 at R 1 and R 5 over T 451 at
     valid_start 224; kernel 8 at R 5 over T 451. Each kernel's entry
     carries a "conditioned" part (times, device times, bounds).
  4. probes: the nine counterparts of the TPU probes in scripts/
     (whisper_aries_tpu_torch/scripts/: probe_dma's probe and probe_multi,
     probe_vmem's try_size, probe_mxu's probe, probe_int8_mxu's
     make_kernel, probe_batched_transpose's make, and the attention-micro
     trio probe_qa_micro, probe_qa_opt and probe_qa_bisect, each `build`
     in all its variants) run through their modules' main() at a reduced
     target (~6 ms of device time a rate line, QA_REPS iterations a
     micro), with every launch count set to 0 just before and read just
     after; each must have launched its kernel. Every attention-micro
     variant is held against its plain version (the (8, 128) answer
     within 1e-3 of max |want|, 2^-8 for the softmax only, below the
     padded keys scored, the normalisation moved across P.V and a head's
     P.V dropped; the checksum of everything the micro computes below a
     checksum of what the answer reads), every block (one an SM) must
     give the same bits, and a launch of 2 x QA_REPS must take 1.8-2.2x
     one of QA_REPS. Every line is held against
     the kernel's plain version on the card inside the probe (checksums,
     products, transposes, each limit below a named mistake). The
     shared-memory probe must find the launch at the card's opt-in limit
     run and one byte above it refused by cudaFuncSetAttribute with
     cudaErrorInvalidValue, and a cluster launch must run exactly where
     cudaOccupancyMaxActiveClusters finds room. Each probe kernel's entry
     in the kernels line comes from a configuration timed after the
     counted run (the 4 MB ring and the 4 MB two-stream copy reading a
     1 GiB source once, each the best of 3 runs of 3 back-to-back calls,
     taken twice in the order kernel / torch.sum / torch.sum / kernel,
     torch.sum reading the same source once; the 227 KB
     one-slot copy, by events and by the profiler's device time, beside
     torch.sum of the same bytes timed both ways; the bf16 product loop and the s8 fold at one block
     per SM, beside one torch.matmul / torch._int_mm of the same operation
     count, B in its faster layout; the batched transpose, both variants
     with the profiler's device time beside a one-element kernel's; each
     attention-micro probe's first variant, beside a two-call yardstick of
     the same work: scaled_dot_product_attention with the key mask and the
     O-projection's torch.matmul).
  5. greedy slice: transcribe a synthetic ~2-minute WAV (made from a seed)
     at large-v3 width with seeded random weights through
     AriesTranscriber.transcribe_file on the config defaults (VAD, greedy,
     temperature ladder, txt/json/srt), with every launch count set to 0
     just before and read just after; every kernel of the path (mel,
     encoder attention, decoder layers, grouped cross-attention) must have
     launched, and every decode step after a prefill must have been a
     replay of the decode call's graph (graph_replays, layer_steps; also in
     the beam and words slices).
  6. beam slice: the same file and weights with config decode.beam_size=5;
     all six kernels must have launched, counted from 0 again.
  7. words slice: compute int8 under ARIES_QUANT_IMPL=pallas, beam 5,
     word_timestamps=True with 10 fixed alignment heads: seven kernels
     (the W8A16 GEMM beside the beam slice's six) must have launched, and
     every segment must carry words with finite, ordered times inside the
     file; prints the word pass's seconds beside the wall time (its host
     part split into DTW, token times and the rest), the GEMM's
     launches by path (gemm_paths) and, for the products at M = windows x
     1500 (the encoder's and the cross K/V's), their count by M and path
     (gemm_windowed): every one must have taken the wgmma path, M 9000
     among them. The C++ DTW must give _dtw_path_py's path on every cost
     matrix the word pass handed it (both timed).
  8. self_int8 slice: compute int8 under ARIES_QUANT_IMPL=pallas,
     decode.kv_cache_dtype bf16 with decode.self_kv_cache_dtype int8,
     greedy at temperature 0: unfused steps, which must launch the int8
     self-attention kernel and the W8A16 GEMM, every step after a prefill
     a replay of the decode call's decoder_step graph (graph_replays =
     layer_steps); prints ms per step. Then the native slice: the same
     under ARIES_QUANT_IMPL=native, which must launch the row quantization
     and the s8 GEMM and never the W8A16 GEMM; prints every (M, N, K) the
     native GEMM's wrapper took (native_gemm_shapes).
  9. checkpoint path: write a large-v3 HF checkpoint directory (published
     widths and depth, seeded random weights as f16 model.safetensors in
     HF key names through the port's writer, large-v3's config.json,
     generation_config.json with 10 alignment heads, a synthesised v3
     tokenizer), build AriesTranscriber(model_size=<dir>) at compute int8
     under ARIES_QUANT_IMPL=pallas with audio_ctx="bucket" (the smoke test
     in the constructor), run transcribe_file at beam 5 with
     multilingual=True and word timestamps on a file of speech bursts,
     then a greedy call on the 125 s WAV with chunk_size 60, overlap
     merge, suppress_tokens [-1], no_repeat_ngram_size 3,
     repetition_penalty 1.1, max_initial_timestamp 0.5 and a
     progress_callback; counts from 0 over both calls (the directory is
     kept for the cli path). Both encoder
     contexts (800, 1500) must appear in the main pass, seven kernels
     must launch, the word pass must read the checkpoint's 10 heads and
     every segment carry a language; prints the write, load and smoke
     seconds and the peak host RSS of each (the "checkpoint" line).
 10. pipeline path: run_pipeline on a ~57 s two-speaker conversation made
     from seed 1 (tests/test_diarize.py's harmonic-stack voices in turns
     of 3-8 s) with the beam slice's engine as transcriber= and a
     DiarizationPipeline() on the card: beam 5, condition_on_previous_text
     with an initial prompt, html/json/srt, the meeting analysis with no
     API key (its error recorded, the run a success), strict_diarization,
     a resume journal; counts from 0. Every kernel of the path must
     launch, every decode call's graph must run at its prompt's own left
     pad over a 451-position cache, every step after a prefill must be a
     replay, the diarizer must find the 2 speakers, the outputs must
     parse. Then, at temperature 0: a journal run, a rerun from the full
     journal (no decode launch) and one from the journal cut to its first
     record (the other windows decoded), both with the same aligned
     segments. Prints the "pipeline" line (stage seconds, RTF, ms a step
     at R 5 and T 451, DER against the truth turns, the diarizer's peak).
 11. serve path: the same conversation at 44.1 kHz stereo as an s16 WAV,
     a FLAC (tests/flac_encoder.py, encoded once per content hash into
     chip_smoke_out/ and reused) and an s24 WAV, and as MP3, Ogg and
     m4a where this host's system libraries allow (the "codecs" line says
     which ran and why any was left out; decode and resample ms per
     format); the FLAC must decode to the s16 WAV's samples bit for bit,
     and the resampler must keep a 1 kHz sine (noise below 1e-6 of it,
     under "half a sample late") and remove a stop-band tone (power below
     1e-6, under "cut-off at the input Nyquist") from 8, 22.05, 44.1 and
     48 kHz. Then the port's job server (serve/server.py, aiohttp) on
     127.0.0.1 with its default pipeline, the beam slice's engine through
     get_transcriber and a card diarizer a job, at temperature 0: each
     file through run_pipeline serially, then the FLAC and the s24 WAV
     submitted at once, with counts from 0; every kernel of the path must
     launch, each job's segments, speakers and texts equal its serial
     run, its downloaded JSON and SRT the serial files; a .txt upload
     gets 400, an unknown job 404, /jobs/ and /stats/ count both, DELETE
     removes a job's outputs. Prints the "serve" line (per job the queue
     wait, upload to completion and stage seconds, the jobs' overlap, the
     card's peak memory, over HTTP).
 12. cli path: on phase 9's checkpoint directory, each command-line
     tool's main() in this process, counts from 0 before each: transcribe
     (the 125 s WAV, beam 5, txt/json/srt, word timestamps; every kernel
     of the path, every file parsing, the segments of an in-process
     transcribe_file with the same options), batch_transcribe (two WAVs
     and a manifest; a rerun without --overwrite skips both and launches
     nothing), diarize and conversation (phase 10's scene: 2 speakers
     each), meeting (no API key: rc 1, its error recorded), verify_setup
     --smoke-test, and the legacy FixedUltraFastTranscriber (parallel_info
     and performance filled). Replicas: the beam slice's engine at one
     window a replica, one replica against mesh [cuda:0, cuda:0] (the same
     tokens in every window, scores within 1e-3 relative, both replicas
     in per_device_distribution, the same launch counts); then an engine
     over make_mesh() (every visible card; its count printed) whose card
     peak must not exceed auto_windows_per_device's byte model at the
     windows it ran and at 8. Prints the ``cli`` line (each tool's rc,
     wall seconds and launches, the replicas' seconds, the chosen size).
 13. pipeline depth path (the engine's double-buffered batch loop,
     ARIES_PIPELINE): the beam slice's engine at 2 windows a batch over the
     125 s WAV (6 windows, 3 batches), transcribe_file with a resume
     journal at ARIES_PIPELINE=1 (depth 2: batch k parsed in a helper
     thread while batch k + 1 decodes, then batch k's ladder) and =0
     (depth 1), counts from 0 before each; equal segments, journals and
     diagnostics events (as multisets), at depth 2 batch k + 1's DECODING
     before batch k's first COMPLETED, the same batch size, every kernel
     of the path launched at both depths; one out-of-memory error injected
     into batch 1's decode at depth 2 keeps the batch (2), drops to depth 1
     and gives the same segments. Prints the ``depth`` line (each depth's
     wall, parse seconds a batch, the seconds of parse that overlapped a
     decode, the card's peak).
 14. tools path: the port's repo tools (whisper_aries_tpu_torch/scripts/),
     each main() with counts from 0: calibrate_emb_threshold on the
     shipped weights (threshold and pair accuracy beside the shipped
     0.53; one seed's similarities on the card within 5e-4 of the CPU's,
     below "the log-mel rounded to bf16 before the net"),
     sweep_cluster_threshold at 0.53 and 0.60 over one development scene,
     make_sample_audio (bytes equal to examples/sample_audio.wav),
     setup_environment --check-only, and parity_vs_goldens.run_job in
     mock mode (12 s cap) on a one-job golden directory written here,
     through run_pipeline with the beam slice's engine (every kernel of
     the path launched, no structure problem). Prints the ``tools`` line
     (each tool's seconds, rc, launches and readings).
 15. train path (counts from 0 over all of it): three make_train_step
     steps of Whisper large-v3 at its published widths (f32 seeded random
     params on the card, 2 windows of the synthetic WAV through the mel
     kernel, 448 target tokens a window, AdamW lr 1e-5): the loss finite
     and falling at each step, 32 training-attention forward and 32
     backward launches a step, each step's seconds (forward, backward,
     update) and the card's peak; the train state at large-v3's widths
     with 2 + 2 layers saved and restored bit for bit; train_vad,
     train_segmentation and train_embedding on the card for tens of steps
     on small synthetic sets (each loss falling: the mean of the last 5
     below the first 5; the mel kernel launched by the last two; each net
     written by _save_verified to chip_smoke_out/trained/); run_battery
     with the shipped weights on 2 scenes of 15 s, clean and augmented,
     its DER below tests/test_der.py's gate (0.45, 0.75). Prints the
     ``train`` line.
 16. speculative path (speculative decode's verify step, kernel 3 at S
     queries a cache row): held at large-v3, 16 windows x S 4 (R 64), a
     256-position self cache whose every lane is random (stale drafts),
     pos 30 / valid_start 0 and pos 62 / valid_start 2 (pos .. pos + 3
     crossing a split of 32 keys), both self-cache dtypes: its
     self-attention part against the plain version in bf16 steps, below
     "a drafted query sees the key one past its own position" and "the
     drafted block's keys read before this launch appended them"; the 32
     layers teacher-forced per layer (below the cross tail dropped); bit
     for bit the x and cache of 4 one-token steps; a graph replay bit for
     bit a direct launch; a verify accepting 1 of 4 then a verify at pos
     + 1 over the rejected lanes bit for bit fresh one-token steps; the
     verify step and the one-token step over the 16 windows profiled by
     kernel (``profile decode step verify S 4, B 16`` and ``one token,
     B 16`` lines, with and without PDL). Then
     scripts/bench_speculative.py's main() at its defaults, counts from 0:
     the SYNTHETIC-acceptance chains (S 4, 3 accepted a step, 16 windows,
     24 steps against 72 one-token steps; never a real-speech speedup) and
     the fused step's replay ms at S 1 / 2 / 4 / 8 (its line and cost(S) /
     cost(1)); prints the ``speculative`` line (the launches: verify
     replays, one-token replays, drafter calls; the card's peak) and adds
     the verify mode's kernels entry.
The second-to-last lines are the kernels JSON (all 22 entries) and
the card line; the last line is {"ok": true, "device": {...}}. Outputs go to
chip_smoke_out/.

It exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import subprocess
import sys
import time
from collections import Counter
from datetime import datetime
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chip_smoke_out"

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BYTES = 3.35e12          # HBM3, bytes/s
PEAK_BF16 = 989e12            # tensor-core bf16 FLOP/s
PEAK_F32 = 67e12              # f32 FLOP/s outside the tensor cores
PEAK_BF16X2 = 2 * PEAK_F32    # bf16 FLOP/s outside them, packed in pairs
PEAK_S8 = 1979e12             # tensor-core int8 OP/s


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, n: int = 20) -> float:
    """Device milliseconds per call (torch.profiler: the kernels' own time,
    summed over the calls' device events). Where a call's host work (the
    wrapper's checks, ctypes) takes longer than its kernels, back-to-back
    calls timed with events measure the host; this does not."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile that caught no device event is retaken
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(ev, "device_time_total", 0)
                 for ev in prof.key_averages()
                 if getattr(ev, "device_type", None) == DeviceType.CUDA)
        if us > 0:
            break
    return us / 1e3 / n


def host_ms(fn, n: int = 20) -> float:
    """Host milliseconds per call: the wall time of `n` calls enqueued
    back to back on an idle card, before any of them is waited for (the
    wrapper's checks, ctypes and the launches; the card runs behind)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / n


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


FAILED: list = []


def check(name: str, ok: bool, detail: str) -> None:
    """Record a kernel check; main() exits non-zero, printing no result,
    once every phase has run if any check failed (so one run shows all)."""
    print(f"check {name}: {'ok' if ok else 'FAILED'} ({detail})", flush=True)
    if not ok:
        FAILED.append(f"{name} disagrees with its plain version: {detail}")


def max_rel(got, want) -> float:
    """max |got - want| / max |want|."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max()) / float(w.abs().max())


def mean_rel(got, want, base=None) -> float:
    """mean |got - want| / mean |want - base| (base 0 by default)."""
    g, w = got.float(), want.float()
    ref = w if base is None else w - base.float()
    return float((g - w).abs().mean()) / float(ref.abs().mean())


def bf16_steps(got, want) -> dict:
    """The largest |got - want| in bf16 steps of want (2^-8..2^-7 of the
    value), and the share of elements that differ at all."""
    import torch

    w = want.float()
    d = (got.float() - w).abs()
    step = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
    return {"bf16_steps": float((d / step).max()),
            "flipped": float((d > 0).float().mean())}


def held(name: str, errs: dict, tols: dict, mutant: dict = None) -> dict:
    """Check err < tol for each metric; where `mutant` gives the same
    metric for a plain version with a deliberate mistake (masked keys
    scored, a dropped tail), also tol < mutant, so the limit is shown to
    catch that mistake."""
    mutant = mutant or {}
    ok = all(errs[k] < tols[k] for k in tols) and all(
        tols[k] < mutant[k] for k in mutant)
    detail = "; ".join(
        f"{k} {errs[k]:.3g} < {tols[k]:.3g}"
        + (f" < mistake {mutant[k]:.3g}" if k in mutant else "")
        for k in tols)
    check(name, ok, detail)
    return dict(errors=errs, tolerances=tols, mistakes=mutant)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def synth_audio(seconds: float, seed: int) -> np.ndarray:
    """Speech-like bursts (voiced tones with a syllable-rate envelope and
    noise) separated by pauses, 16 kHz mono."""
    sr = 16_000
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 140 + 40 * np.sin(2 * np.pi * 0.3 * t)
    voiced = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / sr) / k
                 for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.1 * t)) ** 2
    x = 0.2 * voiced * env + 0.01 * rng.standard_normal(n)
    gate = np.ones(n)
    pos = int(rng.uniform(8, 14) * sr)
    while pos < n:  # pauses of 1.5-4 s every 8-20 s
        gap = int(rng.uniform(1.5, 4.0) * sr)
        gate[pos:pos + gap] = 0.0
        pos += gap + int(rng.uniform(8, 20) * sr)
    return (x * gate + 0.001 * rng.standard_normal(n)).astype(np.float32)


def mel_band_cut(audio, n_mels: int, m: int):
    """The plain version with band m's last bin dropped from the
    filterbank (a mistake the mel check must catch)."""
    import torch
    from whisper_aries_tpu_torch.audio import mel as AM

    x = AM.reflect_pad(audio.float())
    frames = x.unfold(1, AM.N_FFT, AM.HOP_LENGTH)[:, :audio.shape[1] // 160]
    spec = torch.fft.rfft(frames * AM.hann_window(x.device), dim=-1)
    melw = AM.mel_filterbank(n_mels).copy()
    melw[m, np.flatnonzero(melw[m])[-1]] = 0.0
    mels = torch.einsum("mf,btf->bmt", torch.as_tensor(melw, device=x.device),
                        spec.real ** 2 + spec.imag ** 2)
    return AM.finish_log_mel(torch.log10(torch.clamp(mels, min=1e-10)))


def kernel_mel(dev, entries):
    """The mel kernel at B 8 over the synthetic audio, 128 mels (large-v3)
    and 80, against the plain version (cuFFT and the dense mel product);
    each named mistake (every frame off by one sample, the middle band's
    last bin dropped) must exceed the limits. Timed by events (log_mel,
    the torch floor after the kernel included, and the plain version) and
    by device time (the kernel alone)."""
    import torch
    from whisper_aries_tpu_torch.audio.mel import log_mel_spectrogram
    from whisper_aries_tpu_torch.ops import mel as M

    B = 8
    tols = {"max_abs": 5e-4, "mean_abs": 2e-6}
    entry = None
    # 30 s windows at 128 and 80 mels; the 16 s bucket's 256,000 samples;
    # the diarizer trainers' 10 s windows and 2 s utterances at 80 mels
    for seconds, n_mels in ((30, 128), (30, 80), (16, 128), (10, 80),
                            (2, 80)):
        audio = torch.as_tensor(np.stack([
            synth_audio(float(seconds), 100 + i) for i in range(B)]),
            device=dev)
        n_frames = audio.shape[1] // 160
        at = f"{n_mels} mels" + ("" if seconds == 30 else ", 16 s bucket"
                                 if seconds == 16 else f", {seconds} s")
        got = M.log_mel(audio, n_mels)
        want = log_mel_spectrogram(audio, n_mels)
        mistakes = {
            "frames off by one sample":
                log_mel_spectrogram(torch.roll(audio, 1, dims=-1), n_mels),
            f"band {n_mels // 2}'s last bin dropped":
                mel_band_cut(audio, n_mels, n_mels // 2)}
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()) or got.shape[-1] != n_frames:
            fail(f"mel kernel output is not finite or not {n_frames} frames")
        err = lambda a: {"max_abs": float((a - want).abs().max()),
                         "mean_abs": float((a - want).abs().mean())}
        errs = err(got)
        for name, wrong in mistakes.items():
            held(f"mel[{at}, {name}]", errs, tols, err(wrong))
        # the floor at each example's own max - 8 (features (x + 4) / 4:
        # each example's max - min is at most 2, as the plain version's)
        span = lambda a: a.amax(dim=(1, 2)) - a.amin(dim=(1, 2))
        check(f"mel[{at}, per-example floor]",
              float((span(got) - span(want)).abs().max()) < 2 * tols[
                  "max_abs"] and float(span(got).max()) <= 2.0 + 1e-6,
              f"max - min per example {span(got).tolist()}")
        kern = lambda: M.mel_power_kernel(audio, n_mels)
        times = dict(ms=time_ms(lambda: M.log_mel(audio, n_mels), 20),
                     device_ms=device_ms(kern),
                     plain_ms=time_ms(
                         lambda: log_mel_spectrogram(audio, n_mels), 20))
        # the function's least work per frame: a 400-point real FFT
        # (2.5 N log2 N operations), the Hann product, power over 201
        # bins, the filterbank's nonzeros (394 at 128 mels, 391 at 80)
        # and the log; the first design's own work, a DFT as a product
        # (2 x 400 x 402) and a dense mel product, is reported beside it
        nnz = len(M.mel_bands(n_mels)[1])
        fft_ops = 2.5 * 400 * math.log2(400)
        ops = B * n_frames * (fft_ops + 400 + 3 * 201 + 2 * nnz + n_mels)
        dft_ops = B * n_frames * (2 * 400 * 402 + 3 * 201 + 2 * 201 * n_mels)
        nbytes = audio.numel() * 4 + B * n_frames * n_mels * 4
        b_ms, b_by = bound(nbytes, ops, PEAK_F32)
        shape = f"audio ({B}, {audio.shape[1]}) f32, n_mels {n_mels}"
        if entry is None:
            entry = dict(
                name="mel", route="cuda",
                source="whisper_aries_tpu_torch/csrc/mel.cu",
                replaces="whisper_aries_tpu/ops/pallas_mel.py:62",
                max_abs_err=errs["max_abs"],
                tolerance="max |d| < 5e-4, mean |d| < 2e-6", **times,
                bound_ms=b_ms, bound_by=b_by,
                dft_design_bound_ms=bound(nbytes, dft_ops, PEAK_F32)[0],
                library_ms=None, shape=shape)
        else:
            entry["bucket" if seconds == 16 else f"at_{n_mels}_mels"
                  if seconds == 30 else f"at_{seconds}_s"] = dict(
                max_abs_err=errs["max_abs"], bound_ms=b_ms, bound_by=b_by,
                shape=shape, **times)
    entries.append(entry)


def encoder_attn_at(dev, T):
    """The encoder-attention kernel at (8, 20, T, 64) bf16 against its
    plain version, with three named mistakes (keys past T scored as zero
    keys, the last 28 keys dropped, the next head's keys scored in the
    ragged last tile), then timed beside SDPA. T 1500 is the 30 s window,
    T 800 (6 x 128 + 32) the 16 s bucket's."""
    import torch
    import torch.nn.functional as F
    from whisper_aries_tpu_torch.models import whisper as W

    B, H, dh = 8, 20, 64
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((B, H, T, dh), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    # bf16 outputs rounded from differently ordered f32 sums differ by one
    # step in many elements: mean_rel ~2e-3 (one step is 2^-8..2^-7)
    tol = {"max_rel": 1e-2, "mean_rel": 5e-3}
    err = 0.0
    pad = -T % 128 or 128
    zeros = torch.zeros((B, H, pad, dh), dtype=k.dtype, device=dev)
    at = f"T {T}"
    # unit q gives nearly flat softmax rows over T keys, where keys past
    # T scored as zero-valued keys show; q x 4 gives peaked rows, where a
    # dropped last tile (or a wrong scale) shows
    mistakes = {1: lambda qs: W.attention_plain(qs, torch.cat([k, zeros], 2),
                                                torch.cat([v, zeros], 2)),
                4: lambda qs: W.attention_plain(qs, k[:, :, :T - 28],
                                                v[:, :, :T - 28])}
    for q_scale, mistake in mistakes.items():
        qs = (q.float() * q_scale).to(torch.bfloat16)
        got = W.encoder_attention_kernel(qs, k, v)
        want = W.attention_plain(qs, k, v)
        wrong = mistake(qs)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got.float()).all()):
            fail("encoder attention output is not finite")
        held(f"encoder_attn[{at}, q x {q_scale}]",
             {"max_rel": max_rel(got, want), "mean_rel": mean_rel(got, want)},
             tol, {"max_rel": max_rel(wrong, want),
                   "mean_rel": mean_rel(wrong, want)})
        err = max(err, float((got.float() - want.float()).abs().max()))
        del want, wrong
    # T is no multiple of the 128-key tile: the last tile's rows past T
    # lie in the next head's memory. With each head's first keys made
    # large, scoring them there (the next head's keys and values, as a 2D
    # (B H T, 64) map would read them) must move the output past the limit.
    kb = k.clone()
    kb[:, :, :pad] *= 4
    got = W.encoder_attention_kernel(q, kb, v)
    want = W.attention_plain(q, kb, v)
    nxt = lambda t: torch.cat([t, torch.roll(t.reshape(B * H, T, dh), -1, 0)
                               [:, :pad].reshape(B, H, pad, dh)], 2)
    wrong = W.attention_plain(q, nxt(kb), nxt(v))
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got.float()).all()):
        fail("encoder attention output is not finite")
    held(f"encoder_attn[{at}, next head's keys scored]",
         {"max_rel": max_rel(got, want), "mean_rel": mean_rel(got, want)},
         tol, {"max_rel": max_rel(wrong, want),
               "mean_rel": mean_rel(wrong, want)})
    err = max(err, float((got.float() - want.float()).abs().max()))
    del kb, got, want, wrong
    kern = lambda: W.encoder_attention_kernel(q, k, v)
    ms, dev_ms, wrapper_ms = time_ms(kern, 20), device_ms(kern), host_ms(kern)
    plain_ms = time_ms(lambda: W.attention_plain(q, k, v), 5)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
    b_ms, b_by = bound(4 * B * H * T * dh * 2, 4 * B * H * T * T * dh,
                       PEAK_BF16)
    return dict(max_abs_err=err, tolerance=tol, ms=ms, device_ms=dev_ms,
                host_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                shape=f"q, k, v ({B}, {H}, {T}, {dh}) bf16; one call per "
                      "layer")


#: the train path's encoder attention: 2 windows of large-v3, f32
TRAIN_SHAPE = (2, 20, 1500, 64)


def kernel_encoder_attn_train(dev, entries):
    """The training attention kernels (csrc/encoder_attn_train.cu) at the
    train path's (2, 20, 1500, 64) f32: the forward's out and row
    log-sum-exp, then the backward's dq, dk and dv, against the plain
    versions (attention_plain, attention_lse_plain and the autograd of
    attention_plain), each within 2e-5 of max |want| (max) and 1e-5
    (mean), below the same errors of a plain version that scores one key
    past T (a zero key); two runs of the backward give the same bits.
    Timed by events and device time beside the plain versions (the plain
    backward recomputes its forward) and scaled_dot_product_attention in
    f32: its forward, and its backward alone (a retained graph). First a
    line of each device kernel's compiled registers, spilled bytes and
    shared bytes, and the grid's waves on this card; a spill fails."""
    import torch
    import torch.nn.functional as F
    from whisper_aries_tpu_torch.models import whisper as W

    B, H, T, dh = TRAIN_SHAPE
    # each device kernel's registers, spilled (local) bytes and shared
    # bytes as compiled, and its grid's waves at this shape
    attrs = W.encoder_attn_train_attrs(dev, B, H, T)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for a in attrs.values():
        a["waves"] = a["blocks"] / (sms * a["blocks_an_sm"])
    print("encoder_attn_train attrs " + json.dumps(attrs), flush=True)
    check("encoder_attn_train[no spill]",
          all(a["local_bytes"] == 0 for a in attrs.values()),
          "local bytes " + ", ".join(f"{n} {a['local_bytes']}"
                                     for n, a in attrs.items()))
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v, dout = (torch.randn(TRAIN_SHAPE, generator=g, device=dev)
                     for _ in range(4))
    # f32 sums of 1,500 terms in another order: ~2e-6 of max |want|
    tol = {"max_rel": 2e-5, "mean_rel": 1e-5}
    z = torch.zeros((B, H, 1, dh), device=dev)
    kz, vz = torch.cat([k, z], 2), torch.cat([v, z], 2)
    errs = lambda got, want: {"max_rel": max_rel(got, want),
                              "mean_rel": mean_rel(got, want)}
    out, lse = W.encoder_attn_train_fwd_kernel(q, k, v)
    pairs = (("out", out, W.attention_plain(q, k, v),
              W.attention_plain(q, kz, vz)),
             ("lse", lse, W.attention_lse_plain(q, k),
              W.attention_lse_plain(q, kz)))
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(out).all())
            and bool(torch.isfinite(lse).all())):
        fail("training attention forward output is not finite")
    fwd_err = 0.0
    for name, got, want, wrong in pairs:
        held(f"encoder_attn_train[forward {name}, one key past T]",
             errs(got, want), tol, errs(wrong, want))
        fwd_err = max(fwd_err, float((got - want).abs().max()))
    del pairs
    grads = W.encoder_attn_train_bwd_kernel(q, k, v, out, lse, dout)
    again = W.encoder_attn_train_bwd_kernel(q, k, v, out, lse, dout)
    check("encoder_attn_train[backward, two runs]",
          all(torch.equal(a, b) for a, b in zip(grads, again)),
          "dq, dk, dv bitwise")
    del again
    want_g = W.attention_backward_plain(q, k, v, dout)
    wq, wk, wv = W.attention_backward_plain(q, kz, vz, dout)
    wrong_g = (wq, wk[:, :, :T], wv[:, :, :T])
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t).all()) for t in grads):
        fail("training attention backward output is not finite")
    bwd_err = 0.0
    for name, got, want, wrong in zip(("dq", "dk", "dv"), grads, want_g,
                                      wrong_g):
        held(f"encoder_attn_train[backward {name}, one key past T]",
             errs(got, want), tol, errs(wrong, want))
        bwd_err = max(bwd_err, float((got - want).abs().max()))
    del want_g, wrong_g, wq, wk, wv, grads
    fwd = lambda: W.encoder_attn_train_fwd_kernel(q, k, v)
    bwd = lambda: W.encoder_attn_train_bwd_kernel(q, k, v, out, lse, dout)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qq, kk, vv)
    lib_f = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
    lib_b = time_ms(lambda: torch.autograd.grad(
        o_lib, (qq, kk, vv), dout, retain_graph=True), 5)
    elems = B * H * T * dh
    # bytes: each input read once, each output written once; operations:
    # the forward's two products, the backward's five (S recomputed, dP,
    # dV, dK, dQ), 2 T^2 dh each a head, at the f32 rate
    f_ms, f_by = bound(4 * elems * 4 + B * H * T * 4,
                       4 * B * H * T * T * dh, PEAK_F32)
    b_ms, b_by = bound(8 * elems * 4 + B * H * T * 4,
                       10 * B * H * T * T * dh, PEAK_F32)
    common = dict(route="cuda",
                  source="whisper_aries_tpu_torch/csrc/encoder_attn_train.cu",
                  tolerance=tol, shape=f"q, k, v ({B}, {H}, {T}, {dh}) f32; "
                  "one call per encoder layer a train step",
                  design="register-blocked f32 FMA on the CUDA cores: a warp "
                  "16 rows, a lane an 8 x 4 micro-tile; 64-row tiles "
                  "double-buffered by cp.async; no tensor cores, no atomics",
                  dq_option="b: each key tile's partial dQ to scratch, summed "
                  "in key-tile order", attrs=attrs)
    entries.append(dict(
        name="encoder_attn_train", variant="train forward",
        replaces="whisper_aries_tpu/models/whisper.py:337",
        max_abs_err=fwd_err, ms=time_ms(fwd, 10), device_ms=device_ms(fwd, 10),
        plain_ms=time_ms(lambda: W.attention_plain(q, k, v), 3),
        bound_ms=f_ms, bound_by=f_by, library_ms=lib_f, **common))
    entries.append(dict(
        name="encoder_attn_train_bwd", variant="train backward",
        replaces="whisper_aries_tpu/models/whisper.py:337",
        max_abs_err=bwd_err, ms=time_ms(bwd, 5), device_ms=device_ms(bwd, 5),
        plain_ms=time_ms(lambda: W.attention_backward_plain(q, k, v, dout),
                         3),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_b,
        library_fwd_bwd_ms=lib_f + lib_b, **common))


def kernel_encoder_attn(dev, entries):
    entries.append(dict(
        name="encoder_attn", route="cuda",
        source="whisper_aries_tpu_torch/csrc/encoder_attn.cu",
        replaces="whisper_aries_tpu/models/whisper.py:337",
        **encoder_attn_at(dev, 1500), bucket=encoder_attn_at(dev, 800)))


def decode_inputs(dev, R, P, self_int8, seed=0, windows=None, T=448):
    """Large-v3 decoder-layer operands at R rows over ``windows`` windows
    (R by default; R / windows beams per window share its cross K/V) with
    1500 cross keys and a self cache of T positions:
    int8-packed random weights (LayerNorm and bias segments perturbed so
    they matter), int8 cross K/V from random encoder output, a self cache
    holding P random positions. Cross-attention's output scale is raised
    30x: at random init its update to x is ~0.01, under one bf16 step of
    x, and no check of x could see it; raised, it is about as large as the
    MLP's."""
    import torch
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    dims = W.PRESETS["large-v3"]
    g = torch.Generator(device=dev).manual_seed(seed)
    full = W.init_params(dims, seed=seed, device=dev, dtype=torch.bfloat16)
    params = W.fuse_decoder_qkv({"decoder": full["decoder"]})
    wpack = DL.pack_layer_weights(params["decoder"]["blocks"])
    d, ff = dims.n_text_state, 4 * dims.n_text_state
    offs, _ = DL.vec_offsets(d, ff)
    vec = wpack["vecs"]
    vec[:, :int(offs[12])] += 0.02 * torch.randn(
        vec[:, :int(offs[12])].shape, generator=g, device=dev)
    vec[:, int(offs[15]):int(offs[16])] *= 30.0
    xa = torch.randn((windows or R, dims.n_audio_ctx, d), generator=g,
                     device=dev).to(torch.bfloat16)
    cross = W.precompute_cross_kv_int8(params, xa, dims)
    L, H = dims.n_text_layer, dims.n_text_head
    kv = torch.zeros((L, R, 2, H, T, 64), dtype=torch.bfloat16, device=dev)
    kv[:, :, :, :, :P] = (0.5 * torch.randn((L, R, 2, H, P, 64), generator=g,
                                            device=dev)).to(torch.bfloat16)
    if self_int8:
        q8, sc = DL.quantize_heads(kv)
        cache = {"kv8": q8, "ksc": sc}
    else:
        cache = {"kv": kv}
    return dims, params, wpack, cross, cache, g


def clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def tail_dropped(cross, keep: int = 1472):
    """A mistake the limits must catch: cross keys from `keep` on (the last
    28 of 1500) scored as zero-valued keys."""
    kv8 = cross["kv8"].clone()
    kv8[..., keep:, :] = 0
    return dict(cross, kv8=kv8)


def pos_unscored_layers(x, wpack, cache, cross, vs, pos, H):
    """A mistake the split-KV self-attention's limits must catch: the plain
    layers with a self-attention that appends this step's K/V but scores
    [vs, pos) only (the appended position left out)."""
    import torch
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    def self_attn(qkv, cache_l, pos, vs, n_head, queries=1):
        qw, ckv, ksc = DL._append_self(qkv, cache_l, pos, n_head)
        t = torch.arange(ckv.shape[3], device=qkv.device)
        lg = torch.einsum("rhd,rhtd->rht", qw.float(), ckv[:, 0].float())
        if ksc is not None:
            lg = lg * ksc[:, 0]
        pr = torch.softmax(torch.where((t >= vs) & (t < pos), lg,
                                       float("-inf")), dim=-1)
        if ksc is not None:
            pr = pr * ksc[:, 1]
        att = torch.einsum("rht,rhtd->rhd", pr.to(qkv.dtype).float(),
                           ckv[:, 1].float())
        return att.reshape(qkv.shape[0], -1).to(qkv.dtype)

    right = DL.self_attn_plain
    DL.self_attn_plain = self_attn
    try:
        return DL.fused_decoder_layers_plain(x, wpack, cache, cross, vs, pos,
                                             H)
    finally:
        DL.self_attn_plain = right


def hold_step_bits(label, dev, wpack, cache, cross, H, R, windows, P, g,
                   vs=0):
    """(a) Two direct runs of the step on the same inputs give the same
    bits; (b) a graph replay (DecodeStepGraph) gives the same bits as a
    direct launch over 4 positions, the cache permuted in place by the beam
    reorder between the second and third (each window's rows rotated);
    both at valid_start ``vs``."""
    import torch
    from whisper_aries_tpu_torch.ops import beam_reorder as BR
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    d = wpack["wq8"].shape[1]
    x = torch.randn((R, d), generator=g, device=dev).to(torch.bfloat16)
    c1, c2 = clone(cache), clone(cache)
    a = DL.fused_decoder_layers(x, wpack, c1, cross, vs, P, H)
    b = DL.fused_decoder_layers(x, wpack, c2, cross, vs, P, H)
    same = torch.equal(a, b) and all(torch.equal(c1[k], c2[k]) for k in c1)
    check(f"decode_layers[{label}] two runs bitwise", same,
          "x and the appended cache identical" if same else "differ")
    del c1, c2
    cg_, cd = clone(cache), clone(cache)
    graph = DL.DecodeStepGraph(wpack, cg_, cross, R, H, vs)
    K = R // windows
    src = torch.roll(torch.arange(K, device=dev, dtype=torch.int32), 1)
    src = src[None].expand(windows, K).contiguous()
    same = True
    for i, pos in enumerate(range(P, P + 4)):
        x = torch.randn((R, d), generator=g, device=dev).to(torch.bfloat16)
        same &= torch.equal(graph.run(x, pos),
                            DL.fused_decoder_layers(x, wpack, cd, cross, vs,
                                                    pos, H))
        same &= all(torch.equal(cg_[k], cd[k]) for k in cd)
        if i == 1 and K > 1:
            BR.permute_cache_rows(cg_, src)
            BR.permute_cache_rows(cd, src)
    check(f"decode_layers[{label}] graph replay = direct launch, bitwise",
          same, "4 positions, an in-place reorder between" if same
          else "differ")
    del graph, cg_, cd


def step_bound(dims, R, pos, self_int8, windows=None, ta=None, vs=0):
    """Least time of one decode step (all layers): int8 weights, the
    windows' int8 cross K/V with scales, the live self cache (positions vs
    .. pos), x in and out, each moved once; or the products at the bf16
    peak, whichever is longer."""
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    L, d, H = dims.n_text_layer, dims.n_text_state, dims.n_text_head
    ff, Ta = 4 * d, ta or dims.n_audio_ctx
    w_bytes = L * (d * 6 * d + 2 * d * ff + DL.vec_offsets(d, ff)[1] * 4)
    cross_bytes = L * (windows or R) * 2 * H * Ta * (64 + 4)
    elt = 1 if self_int8 else 2
    live = pos + 1 - vs
    self_bytes = L * R * 2 * H * live * (64 * elt + (4 if self_int8 else 0))
    nbytes = w_bytes + cross_bytes + self_bytes + 2 * R * d * 2
    ops = 2 * R * L * (6 * d * d + 2 * d * ff) + 4 * R * L * H * 64 * (live + Ta)
    return bound(nbytes, ops, PEAK_BF16)


def check_decode_plans(dev) -> None:
    """The C plans (K slices of each step product, self- and
    cross-attention splits) equal their Python mirrors, which the CPU tests
    hold, at large-v3's shapes on this card."""
    import torch
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    d, ff = 1280, 5120
    same = all(DL.kernel_gemm_plan(K, N, sms) == DL.gemm_plan(K, N, sms)[0]
               for K, N in ((d, 3 * d), (d, d), (d, ff), (ff, d)))
    same &= all(DL.kernel_attn_split(T) == DL.attn_split(T)
                for T in (227, 448))
    same &= all(DL.kernel_cross_split(Ta, w * 20, G, sms)
                == DL.cross_split(Ta, w * 20, G, sms) for w in (1, 5, 6, 8)
                for G in (1, 3, 5, 15) for Ta in (1500, 800))
    check("decode plans: C = Python mirrors", same,
          f"{sms} SMs, GEMM K slices "
          f"{[DL.gemm_plan(K, N, sms) for K, N in ((d, 3 * d), (d, d), (d, ff), (ff, d))]}, "
          f"self splits {DL.attn_split(227)}, cross splits at 6 / 8 windows "
          f"{DL.cross_split(1500, 120, 1, sms)} / "
          f"{DL.cross_split(1500, 160, 1, sms)}, G 15 at 6 windows "
          f"{DL.cross_split(1500, 120, 15, sms)}; the 16 s bucket's Ta 800 "
          f"at 8 windows G 1 / 5 {DL.cross_split(800, 160, 1, sms)} / "
          f"{DL.cross_split(800, 160, 5, sms)}")


def kernel_decode_layers(dev, entries, parts):
    import torch
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    check_decode_plans(dev)

    R, P = 8, 4
    for self_int8 in (False, True):
        dims, params, wpack, cross, cache, g = decode_inputs(dev, R, P,
                                                             self_int8)
        H = dims.n_text_head
        if not self_int8:
            decode_parts(dev, wpack, cross, cache, H, g, parts)
        tag = "int8" if self_int8 else "bf16"
        L = dims.n_text_layer
        sl = lambda tree, l, n=1: {k: v[l:l + n] for k, v in tree.items()}
        # (1) whole stack, error against depth: one-step bf16 flips at
        # rounding midpoints grow through random layers, so the stack is
        # reported and held loosely; (2) is the check
        x = torch.randn((R, dims.n_text_state), generator=g,
                        device=dev).to(torch.bfloat16)
        growth = {}
        for n in (1, 2, 4, 8, 16, L):
            ck, cp = clone(cache), clone(cache)
            got = DL.fused_decoder_layers(x, sl(wpack, 0, n), sl(ck, 0, n),
                                          sl(cross, 0, n), 0, P, H)
            want = DL.fused_decoder_layers_plain(
                x, sl(wpack, 0, n), sl(cp, 0, n), sl(cross, 0, n), 0, P, H)
            growth[n] = max_rel(got, want)
        print(f"decode_layers[{tag}] stack max_rel by depth {growth}",
              flush=True)
        # (2) teacher-forced per layer, several positions: each layer's
        # kernels and its plain version run on the same fresh input, small
        # so x's bf16 step is fine against the layer's update; the error is
        # held against that update, and the same metric for a plain layer
        # whose cross-attention drops its last 28 keys must exceed the limit
        ck, cp, cm = clone(cache), clone(cache), clone(cache)
        cu = clone(cache)
        cross_m = tail_dropped(cross)
        errs = {"max_rel": 0.0, "mean_rel": 0.0}
        mistake = {"mean_rel": math.inf}  # the limit must catch it
        unscored = {"mean_rel": math.inf}
        worst_abs = 0.0
        cache_errs = {}
        for pos in range(P, P + 4):  # several positions, valid_start 0
            for l in range(L):
                xin = (0.25 * torch.randn((R, dims.n_text_state), generator=g,
                                          device=dev)).to(torch.bfloat16)
                got = DL.fused_decoder_layers(xin, sl(wpack, l), sl(ck, l),
                                              sl(cross, l), 0, pos, H)
                want = DL.fused_decoder_layers_plain(
                    xin, sl(wpack, l), sl(cp, l), sl(cross, l), 0, pos, H)
                wrong = DL.fused_decoder_layers_plain(
                    xin, sl(wpack, l), sl(cm, l), sl(cross_m, l), 0, pos, H)
                no_pos = pos_unscored_layers(xin, sl(wpack, l), sl(cu, l),
                                             sl(cross, l), 0, pos, H)
                unscored["mean_rel"] = min(unscored["mean_rel"],
                                           mean_rel(no_pos, want, xin))
                worst_abs = max(worst_abs, float(
                    (got.float() - want.float()).abs().max()))
                errs["max_rel"] = max(errs["max_rel"], max_rel(got, want))
                errs["mean_rel"] = max(errs["mean_rel"],
                                       mean_rel(got, want, xin))
                mistake["mean_rel"] = min(mistake["mean_rel"],
                                          mean_rel(wrong, want, xin))
            # the appended entries at pos, all layers
            if self_int8:
                a = ck["kv8"][:, :, :, :, pos].int()
                b = cp["kv8"][:, :, :, :, pos].int()
                sa, sb = ck["ksc"][..., pos], cp["ksc"][..., pos]
                now = {"int8_step": float((a - b).abs().max()),
                       "int8_flipped": float((a != b).float().mean()),
                       "scale_max_rel": float(((sa - sb).abs() / sb).max()),
                       "scale_flipped": float((sa != sb).float().mean())}
            else:
                a = ck["kv"][:, :, :, :, pos]
                b = cp["kv"][:, :, :, :, pos]
                now = {"kv_max_rel": max_rel(a, b),
                       "kv_flipped": float((a != b).float().mean())}
            for k, v in now.items():
                cache_errs[k] = max(cache_errs.get(k, 0.0), v)
        # one-step bf16 flips at rounding midpoints cascade through a
        # layer (a flipped LayerNorm output moves every product of its row):
        # max_rel ~1e-2 is a step or two at the largest |x|, mean_rel ~2e-3
        # of the update; the mistake's mean_rel is ~0.1
        tols = {"max_rel": 3e-2, "mean_rel": 1e-2}
        held(f"decode_layers[{tag} self cache] x, {L} layers x 4 positions",
             errs, tols, mistake)
        held(f"decode_layers[{tag} self cache] x, appended position "
             "unscored", errs, tols, unscored)
        del cu
        hold_step_bits(f"{tag} self cache, R {R}", dev, wpack, cache, cross,
                       H, R, R, P + 8, g)
        if self_int8:
            # one int8 step at most, in ~1e-4 of the entries; a scale off
            # by at most one bf16 step of its absmax (< 2^-7)
            cache_tols = {"int8_step": 1.5, "int8_flipped": 1e-3,
                          "scale_max_rel": 8e-3, "scale_flipped": 2e-3}
        else:
            cache_tols = {"kv_max_rel": 8e-3, "kv_flipped": 5e-3}
        held(f"decode_layers[{tag} self cache] appended cache", cache_errs,
             cache_tols)
        check(f"decode_layers[{tag} self cache] {L}-layer stack",
              growth[L] < 0.1, f"max_rel {growth[L]:.3g} < 0.1")
        # time one step at the middle of a 224-token decode
        pos = P + 112
        x = torch.randn((R, dims.n_text_state), generator=g,
                        device=dev).to(torch.bfloat16)
        graph = DL.DecodeStepGraph(wpack, ck, cross, R, H)
        step = lambda: graph.run(x, pos)
        ms = time_ms(step, 20)
        direct = lambda: DL.fused_decoder_layers(x, wpack, ck, cross, 0, pos,
                                                 H)
        ms_direct = time_ms(direct, 20)
        plain_ms = time_ms(lambda: DL.fused_decoder_layers_plain(
            x, wpack, cp, cross, 0, pos, H), 3, warmup=1)
        b_ms, b_by = step_bound(dims, R, pos, self_int8)
        entry = dict(
            name="decode_layers", route="cuda",
            source="whisper_aries_tpu_torch/csrc/decode_layers.cu",
            replaces="whisper_aries_tpu/ops/pallas_decode_layers.py:775",
            max_abs_err=worst_abs,
            tolerance=dict(x=tols, appended=cache_tols),
            stack_max_rel=growth, ms=ms, ms_direct=ms_direct,
            plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=(f"one step, all 32 layers, R {R}, position {pos}, "
                   f"{tag} self cache; ms a CUDA graph replay, ms_direct "
                   "the same launches made one by one"))
        # the main path runs the int8 self cache; the bf16 one is reported
        # with the parts
        if self_int8:
            del graph
            profile_graph_step(f"R {R}", wpack, ck, cross, H, R, x, pos)
            del params, cross, cache, ck, cp, cm, cross_m
            # the slices' 6 windows: greedy (1 row each), the ladder's
            # best_of 5 and beam 5 (5 rows each); beam 5 over a full batch
            # of 8 windows
            for rows, windows in ((6, 6), (30, 6), (40, 8)):
                entry.update(step_at_rows(dev, rows, P, pos, windows, parts))
            entry["bucket"] = step_at_bucket(dev, P, pos)
            entries.append(entry)
        else:
            del graph
            parts.append(dict(entry, name="decode_layers[bf16 self cache]"))


def step_at_rows(dev, R, P, pos, windows, parts):
    """The int8-self-cache step at R rows over ``windows`` windows (their
    rows sharing the windows' cross K/V): held against its plain version
    teacher-forced per layer, as at R = 8, then timed and profiled. The
    launcher picks its cross-attention instantiation from the rows per
    window and the block count (windows x 20 heads against the SMs), so
    each slice's shape is held at its own. The named mistake: every row
    reading window 0's K/V (at one window per row, window 0's rows then
    agree, so it is measured over the other windows' rows)."""
    import torch
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    dims, _, wpack, cross, cache, g = decode_inputs(dev, R, P, True, seed=1,
                                                    windows=windows)
    H, L = dims.n_text_head, dims.n_text_layer
    sl = lambda tree, l: {k: v[l:l + 1] for k, v in tree.items()}
    wrong_cross = {k: v[:, :1].expand_as(v).contiguous()
                   for k, v in cross.items()}
    later = slice(R // windows, None)  # the rows of windows 1..
    ck, cp, cm = clone(cache), clone(cache), clone(cache)
    errs = {"max_rel": 0.0, "mean_rel": 0.0}
    mistake = {"mean_rel": math.inf}
    for l in range(L):
        xin = (0.25 * torch.randn((R, dims.n_text_state), generator=g,
                                  device=dev)).to(torch.bfloat16)
        got = DL.fused_decoder_layers(xin, sl(wpack, l), sl(ck, l),
                                      sl(cross, l), 0, P, H)
        want = DL.fused_decoder_layers_plain(xin, sl(wpack, l), sl(cp, l),
                                             sl(cross, l), 0, P, H)
        wrong = DL.fused_decoder_layers_plain(xin, sl(wpack, l), sl(cm, l),
                                              sl(wrong_cross, l), 0, P, H)
        errs["max_rel"] = max(errs["max_rel"], max_rel(got, want))
        errs["mean_rel"] = max(errs["mean_rel"], mean_rel(got, want, xin))
        mistake["mean_rel"] = min(mistake["mean_rel"], mean_rel(
            wrong[later], want[later], xin[later]))
    del ck, cp, cm, wrong_cross
    tols = {"max_rel": 3e-2, "mean_rel": 1e-2}
    label = f"R {R} = {windows} windows x {R // windows}"
    out = held(f"decode_layers[int8 self cache, {label}] x, {L} layers",
               errs, tols, mistake)
    parts.append(dict(name=f"decode_layers[{label}]", **out))
    hold_step_bits(f"int8 self cache, {label}", dev, wpack, cache, cross, H,
                   R, windows, P + 8, g)
    x = torch.randn((R, dims.n_text_state), generator=g,
                    device=dev).to(torch.bfloat16)
    graph = DL.DecodeStepGraph(wpack, cache, cross, R, H)
    step = lambda: graph.run(x, pos)
    ms = time_ms(step, 20)
    ms_direct = time_ms(lambda: DL.fused_decoder_layers(
        x, wpack, cache, cross, 0, pos, H), 20)
    del graph
    profile_graph_step(label, wpack, cache, cross, H, R, x, pos)
    b_ms, _ = step_bound(dims, R, pos, True, windows)
    return {f"ms_at_r{R}": ms, f"ms_direct_at_r{R}": ms_direct,
            f"bound_ms_at_r{R}": b_ms}


def step_at_bucket(dev, P, pos):
    """The int8-self-cache step over the 16 s bucket's cross K/V (Ta 800)
    at R 8 (8 windows, greedy) and R 40 (8 windows x 5 beams): held
    teacher-forced per layer against its plain version, where the same
    error of a plain layer with a named mistake must exceed the limit:
    keys past Ta read from the 30 s pad (the plain layer over 1500 keys
    whose first 800 are the bucket's), and every window reading window
    0's K/V; then two runs bitwise and a graph replay against direct
    launches; timed as a replay and as direct launches, with its bound at
    Ta 800."""
    import torch
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    out = {"shape": "one step, all 32 layers, cross K/V over Ta 800 (8 "
                    f"windows), int8 self cache, position {pos}"}
    for R in (8, 40):
        dims, _, wpack, full, cache, g = decode_inputs(dev, R, P, True,
                                                       seed=2, windows=8)
        H, L = dims.n_text_head, dims.n_text_layer
        cross = {"kv8": full["kv8"][:, :, :, :, :800].contiguous(),
                 "sc": full["sc"][:, :, :, :, :800].contiguous()}
        if cross["kv8"].shape[4] != 800:
            fail("bucket step: cross K/V not cut to Ta 800")
        window0 = {k: v[:, :1].expand_as(v).contiguous()
                   for k, v in cross.items()}
        later = slice(R // 8, None)  # the rows of windows 1..
        sl = lambda tree, l: {k: v[l:l + 1] for k, v in tree.items()}
        ck, cp, cm, cw = clone(cache), clone(cache), clone(cache), clone(cache)
        errs = {"max_rel": 0.0, "mean_rel": 0.0}
        past = {"mean_rel": math.inf}
        win0 = {"mean_rel": math.inf}
        worst_abs = 0.0
        for l in range(L):
            xin = (0.25 * torch.randn((R, dims.n_text_state), generator=g,
                                      device=dev)).to(torch.bfloat16)
            got = DL.fused_decoder_layers(xin, sl(wpack, l), sl(ck, l),
                                          sl(cross, l), 0, P, H)
            want = DL.fused_decoder_layers_plain(xin, sl(wpack, l), sl(cp, l),
                                                 sl(cross, l), 0, P, H)
            wrong = DL.fused_decoder_layers_plain(xin, sl(wpack, l),
                                                  sl(cm, l), sl(full, l), 0,
                                                  P, H)
            wrong0 = DL.fused_decoder_layers_plain(xin, sl(wpack, l),
                                                   sl(cw, l), sl(window0, l),
                                                   0, P, H)
            errs["max_rel"] = max(errs["max_rel"], max_rel(got, want))
            errs["mean_rel"] = max(errs["mean_rel"], mean_rel(got, want, xin))
            past["mean_rel"] = min(past["mean_rel"],
                                   mean_rel(wrong, want, xin))
            win0["mean_rel"] = min(win0["mean_rel"], mean_rel(
                wrong0[later], want[later], xin[later]))
            worst_abs = max(worst_abs, float(
                (got.float() - want.float()).abs().max()))
        del ck, cp, cm, cw, window0
        tols = {"max_rel": 3e-2, "mean_rel": 1e-2}
        label = f"Ta 800, R {R} = 8 windows x {R // 8}"
        held(f"decode_layers[{label}] keys past Ta read from the 30 s pad",
             errs, tols, past)
        held(f"decode_layers[{label}] every window reads window 0", errs,
             tols, win0)
        hold_step_bits(label, dev, wpack, cache, cross, H, R, 8, P + 8, g)
        x = torch.randn((R, dims.n_text_state), generator=g,
                        device=dev).to(torch.bfloat16)
        graph = DL.DecodeStepGraph(wpack, cache, cross, R, H)
        ms = time_ms(lambda: graph.run(x, pos), 20)
        ms_direct = time_ms(lambda: DL.fused_decoder_layers(
            x, wpack, cache, cross, 0, pos, H), 20)
        del graph
        b_ms, b_by = step_bound(dims, R, pos, True, 8, ta=800)
        if R == 8:
            plain_ms = time_ms(lambda: DL.fused_decoder_layers_plain(
                x, wpack, clone(cache), cross, 0, pos, H), 3, warmup=1)
            out.update(max_abs_err=worst_abs, tolerance=tols, ms=ms,
                       ms_direct=ms_direct, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None)
        else:
            out.update({"ms_at_r40": ms, "ms_direct_at_r40": ms_direct,
                        "bound_ms_at_r40": b_ms,
                        "max_abs_err_at_r40": worst_abs})
        del wpack, full, cache, cross, x
        torch.cuda.empty_cache()
    return out


def profile_step(label: str, step, n: int = 5,
                 what: str = "decode step") -> None:
    """Device time by kernel over n decode steps (torch.profiler), and the
    device's busy share of the wall time of those steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    from torch.autograd import DeviceType

    # the share of the wall during which some kernel is resident: the union
    # of the device events' intervals (with programmatic dependent launch a
    # kernel starts while its predecessor drains, so the kernels' summed
    # times can exceed the wall)
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if getattr(ev, "device_type", None) == DeviceType.CUDA)
    covered, end = 0.0, -math.inf
    for a, b in spans:
        if a > end:
            covered += b - a
            end = b
        elif b > end:
            covered += b - end
            end = b
    rows = []  # the device-side events only (CPU ops would count twice)
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0))
        rows.append((ev.key, dev_us / 1e3 / n, ev.count // n))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    busy_ms = covered / 1e3 / n
    print(f"profile {what} {label} " + json.dumps({
        "wall_ms_per_step": wall_ms, "kernel_ms_sum_per_step": busy,
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "launches_per_step": sum(r[2] for r in rows),
        "kernels": [{"name": k.replace("(anonymous namespace)::", "")
                     .split("(")[0], "ms_per_step": ms,
                     "launches_per_step": c} for k, ms, c in rows[:12]]}),
        flush=True)


def profile_graph_step(label, wpack, cache, cross, H, R, x, pos, queries=1):
    """The step replayed from one graph, profiled as the slices run it
    (each kernel a programmatic dependent of the one before), then from a
    graph captured without PDL: there each kernel's device time is its own,
    not stretched by waiting for its predecessor. ``queries``: the verify
    step's drafted tokens a window."""
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    for pdl in (True, False):
        DL.PDL = pdl
        try:
            graph = DL.DecodeStepGraph(wpack, cache, cross, R, H, 0,
                                       queries=queries)
            profile_step(label + ("" if pdl else ", no PDL"),
                         lambda: graph.run(x, pos))
            del graph
        finally:
            DL.PDL = True


def decode_parts(dev, wpack, cross, cache, H, g, parts):
    """Each decoder-layer kernel alone against its plain counterpart
    (layer 0's operands), errors in bf16 steps; the GEMM also at 30 rows
    (two m16 row tiles)."""
    import torch
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    R, d = 8, wpack["wq8"].shape[1]
    ff = wpack["wf18"].shape[-1]
    offs, _ = DL.vec_offsets(d, ff)
    vec = wpack["vecs"][0]
    seg = lambda i: vec[int(offs[i]):int(offs[i + 1])].contiguous()
    x = torch.randn((R, d), generator=g, device=dev).to(torch.bfloat16)
    # every part rounds f32 sums to bf16, and its sums run in another order
    # than the plain version's (cuBLAS, torch reductions): where a sum sits
    # at a rounding midpoint the outputs are one bf16 step apart. So each
    # part is held to one step, in under 2e-3 of its elements (~10x the
    # most measured), and its named mistake must flip far more
    tol = {"bf16_steps": 1.5, "flipped": 2e-3}

    def rec(name, got, want, kern, plain, wrong):
        torch.cuda.synchronize()
        out = held(f"decode part {name}", bf16_steps(got, want), tol,
                   bf16_steps(wrong, want))
        parts.append(dict(name=name, **out, ms=time_ms(kern, 20),
                          plain_ms=time_ms(plain, 5)))

    def chunk_dropped(h):
        """The GEMMs' mistake: the last 64-row K chunk left out."""
        h = h.clone()
        h[:, -64:] = 0
        return h

    xf = x.float()
    n_wrong = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(  # var over d-1
        xf.var(-1, keepdim=True) + 1e-5)
    rec("layer_norm", DL.layer_norm_kernel(x, seg(0), seg(1)),
        DL.layer_norm_plain(x, seg(0), seg(1)),
        lambda: DL.layer_norm_kernel(x, seg(0), seg(1)),
        lambda: DL.layer_norm_plain(x, seg(0), seg(1)),
        (n_wrong * seg(0) + seg(1)).to(torch.bfloat16))
    wq = wpack["wq8"][0]
    w_qkv = wq[:, :3 * d]
    for rows in (R, 30):
        xr = torch.randn((rows, d), generator=g, device=dev).to(torch.bfloat16)
        plain_qkv = lambda: DL.w8a16_gemm_plain(xr, w_qkv, seg(12),
                                                seg(2)).to(torch.bfloat16)
        rec(f"w8a16_gemm[qkv, R {rows}]",
            DL.w8a16_gemm_kernel(xr, w_qkv, seg(12), seg(2)), plain_qkv(),
            lambda: DL.w8a16_gemm_kernel(xr, w_qkv, seg(12), seg(2)),
            plain_qkv, DL.w8a16_gemm_plain(
                chunk_dropped(xr), w_qkv, seg(12), seg(2)).to(torch.bfloat16))
    w1 = wpack["wf18"][0]
    plain_f1 = lambda: DL.gelu_as(DL.w8a16_gemm_plain(
        x, w1, seg(16), seg(10))).to(torch.bfloat16)
    rec("w8a16_gemm[fc1+gelu]",
        DL.w8a16_gemm_kernel(x, w1, seg(16), seg(10), DL.EPI_GELU),
        plain_f1(),
        lambda: DL.w8a16_gemm_kernel(x, w1, seg(16), seg(10), DL.EPI_GELU),
        plain_f1, DL.gelu_as(DL.w8a16_gemm_plain(
            chunk_dropped(x), w1, seg(16), seg(10))).to(torch.bfloat16))
    h1 = torch.randn((R, ff), generator=g, device=dev).to(torch.bfloat16)
    w2 = wpack["wf28"][0]
    # a small residual, so the product dominates the sum that is compared
    res = (0.01 * x.float()).to(torch.bfloat16)
    plain_f2 = lambda: res + DL.w8a16_gemm_plain(h1, w2, seg(17), seg(11)).to(
        torch.bfloat16)
    rec("w8a16_gemm[fc2+residual]",
        DL.w8a16_gemm_kernel(h1, w2, seg(17), seg(11), DL.EPI_RESIDUAL,
                             out=res.clone()), plain_f2(),
        lambda: DL.w8a16_gemm_kernel(h1, w2, seg(17), seg(11),
                                     DL.EPI_RESIDUAL, out=res.clone()),
        plain_f2, res + DL.w8a16_gemm_plain(
            chunk_dropped(h1), w2, seg(17), seg(11)).to(torch.bfloat16))
    qkv = (0.5 * torch.randn((R, 3 * d), generator=g, device=dev)).to(
        torch.bfloat16)
    base = cache["kv"][0]
    q8, sc8 = DL.quantize_heads(base)
    pos = 4
    for int8 in (False, True):
        c = {"kv8": q8, "ksc": sc8} if int8 else {"kv": base}
        ck, cp, cm = clone(c), clone(c), clone(c)
        got = DL.self_attn_kernel(qkv, ck, pos, 0, H)
        want = DL.self_attn_plain(qkv, cp, pos, 0, H)
        # the mistake: the first valid key left out
        wrong = DL.self_attn_plain(qkv, cm, pos, 1, H)
        check(f"decode part self_attn[{'int8' if int8 else 'bf16'}] append",
              all(torch.equal(ck[k], cp[k]) for k in ck),
              "appended cache identical to the plain version's")
        rec(f"self_attn[{'int8' if int8 else 'bf16'}]", got, want,
            lambda: DL.self_attn_kernel(qkv, ck, pos, 0, H),
            lambda: DL.self_attn_plain(qkv, cp, pos, 0, H), wrong)
    # valid_start 200, pos 300 over a full 448-position cache: splits of
    # 64 keys, 0-2 and 5-6 without a live key; the mistake drops the first
    # valid key
    full = (0.5 * torch.randn(base.shape, generator=g, device=dev)).to(
        torch.bfloat16)
    S, C = DL.attn_split(full.shape[3])
    vs, pos = 200, 300
    for int8 in (False, True):
        q8f, scf = DL.quantize_heads(full)
        c = {"kv8": q8f, "ksc": scf} if int8 else {"kv": full}
        ck, cp, cm = clone(c), clone(c), clone(c)
        tag = f"{'int8' if int8 else 'bf16'}, valid_start {vs}, pos {pos}"
        got = DL.self_attn_kernel(qkv, ck, pos, vs, H)
        want = DL.self_attn_plain(qkv, cp, pos, vs, H)
        wrong = DL.self_attn_plain(qkv, cm, pos, vs + 1, H)
        check(f"decode part self_attn[{tag}] append",
              all(torch.equal(ck[k], cp[k]) for k in ck),
              "appended cache identical to the plain version's")
        empty = [s_ for s_ in range(S) if (s_ + 1) * C <= vs or s_ * C > pos]
        rec(f"self_attn[{tag}, splits {empty} of {S} empty]", got, want,
            lambda: DL.self_attn_kernel(qkv, ck, pos, vs, H),
            lambda: DL.self_attn_plain(qkv, cp, pos, vs, H), wrong)
    del full, ck, cp, cm
    kv8, sc = cross["kv8"][0], cross["sc"][0]
    rec("cross_attn_split[bf16 out, 8 windows]",
        DL.cross_attn_kernel(x, kv8, sc, H), DL.cross_attn_plain(x, kv8, sc, H),
        lambda: DL.cross_attn_kernel(x, kv8, sc, H),
        lambda: DL.cross_attn_plain(x, kv8, sc, H),
        DL.cross_attn_plain(x, tail_dropped(cross)["kv8"][0], sc, H))
    rec("cross_attn_q8[bf16 out, step layout]",
        step_cross_kernel(x, kv8, sc, H), DL.cross_attn_plain(x, kv8, sc, H),
        lambda: step_cross_kernel(x, kv8, sc, H),
        lambda: DL.cross_attn_plain(x, kv8, sc, H),
        DL.cross_attn_plain(x, tail_dropped(cross)["kv8"][0], sc, H))


def step_cross_kernel(cq, kv8_l, sc_l, H):
    """The decode step's cross-attention through the kernel's one entry:
    cq (R, d) rows window-major over the Bw windows of one layer's packed
    cross K/V (Bw, 2, H, Ta, 64), bf16 out in the same (R, d) layout."""
    import torch
    from whisper_aries_tpu_torch.ops import cross_attn as XA

    R, d = cq.shape
    Bw = kv8_l.shape[0]
    heads = lambda t: t.view(Bw, R // Bw, H, d // H).transpose(1, 2)
    att = torch.empty_like(cq)
    XA.cross_attention_q8_kernel(heads(cq), kv8_l[:, 0], sc_l[:, 0],
                                 kv8_l[:, 1], sc_l[:, 1], out=heads(att))
    return att


def cross_case(dev, Bw, G, seed, Ta=1500):
    """Grouped cross-attention operands at (Bw windows, 20 heads, G queries,
    Ta keys): K/V as views of the packed (Bw, 2, H, Ta, 64) cross layout,
    K scales folding 1/sqrt(dh); distinct peaked queries (x 4) per query
    slot, bf16, in the strided layout the model hands over ((Bw, G, H, 64)
    rows transposed to (Bw, H, G, 64)). Below 1500 keys (the 16 s
    bucket's 800) the case also returns, as a named mistake, the same
    views over 1500 keys whose first Ta are these (keys past Ta read from
    the 30 s pad); else None there."""
    import torch
    from whisper_aries_tpu_torch.ops import cross_attn as XA

    H, T, dh = 20, 1500, 64
    g = torch.Generator(device=dev).manual_seed(seed)
    kv = torch.randn((Bw, 2, H, T, dh), generator=g, device=dev).to(
        torch.bfloat16)
    kv8, sc = XA.quantize_kv_per_position(kv)
    sc[:, 0] /= 8.0
    del kv
    q = (4 * torch.randn((Bw, G, H, dh), generator=g, device=dev)).to(
        torch.bfloat16).transpose(1, 2)
    views = lambda k8, s: (k8[:, 0], s[:, 0], k8[:, 1], s[:, 1])
    if Ta == T:
        return q, views(kv8, sc), None
    return (q, views(kv8[..., :Ta, :].contiguous(), sc[..., :Ta].contiguous()),
            views(kv8, sc))


def hold_cross(label, q, args, past=None):
    """The kernel (f32 out) against its plain version; each named mistake
    (the last 28 keys dropped, every window reading window 0's K/V over
    several windows, the last split's P . V dropped from the rank-order
    sum, above 16 queries the last chunk of 16 left unwritten, and, given
    ``past``, keys past Ta read from the 30 s pad) must exceed the
    limits. Returns the largest |error|."""
    import torch
    from whisper_aries_tpu_torch.ops import cross_attn as XA
    from whisper_aries_tpu_torch.ops import cuda_build as cb
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    Bw, H, G, _ = q.shape
    Ta = args[0].shape[2]
    S, C = DL.cross_split(Ta, Bw * H, G, cb.sm_count(q))
    got = XA.cross_attention_q8_kernel(q, *args)
    want = XA.cross_attention_q8_reference(q, *args)
    mistakes = {
        "last 28 keys dropped": XA.cross_attention_q8_reference(
            q, *(a[:, :, :Ta - 28] for a in args)),
        f"split {S - 1} of {S}'s P.V dropped":
            XA.cross_attention_q8_split_plain(q, *args, S, C, drop=S - 1)}
    if Bw > 1:
        mistakes["every window reads window 0"] = \
            XA.cross_attention_q8_reference(
                q, *(a[:1].expand_as(a) for a in args))
    if G > 16:  # the per-warp kernel's query chunks of 16
        tail = want.clone()
        tail[:, :, (G - 1) // 16 * 16:] = 0
        mistakes["last query chunk dropped"] = tail
    if past is not None:
        mistakes["keys past Ta read from the 30 s pad"] = \
            XA.cross_attention_q8_reference(q, *past)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        fail(f"cross-attention kernel output is not finite ({label})")
    # f32 out from the same f32 products summed in another order: ~1e-6
    tols = {"max_rel": 1e-4, "mean_rel": 1e-5}
    errs = {"max_rel": max_rel(got, want), "mean_rel": mean_rel(got, want)}
    for name, wrong in mistakes.items():
        held(f"cross_attn_q8[{label}, {name}]", errs, tols,
             {"max_rel": max_rel(wrong, want),
              "mean_rel": mean_rel(wrong, want)})
    return float((got - want).abs().max()), tols


def cross_bound(Bw, G, T, H=20, dh=64):
    """Least time of one grouped cross-attention: int8 K/V with f32
    scales read once, q in and f32 out, or its operations: Q . K^T at the
    bf16 tensor-core rate (an int8 key is exact in bf16, so bf16 q times
    it loses nothing there), P . V at the f32 rate."""
    nbytes = Bw * H * T * 2 * (dh + 4) + Bw * H * G * dh * (2 + 4)
    n = 2 * Bw * H * G * T * dh
    return bound(nbytes, n + n * PEAK_F32 / PEAK_BF16, PEAK_F32)


def cross_bucket(dev):
    """Kernel 6 at the 16 s bucket's Ta 800: the prefill's shape over a
    full batch of 8 windows (G 3 queries, bf16 and f32 q) and the beam
    step's (G 5), each with the mistakes of ``hold_cross`` and keys past
    Ta read from the 30 s pad; timed at 8 x 3."""
    import torch
    from whisper_aries_tpu_torch.ops import cross_attn as XA
    from whisper_aries_tpu_torch.ops import cuda_build as cb
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    err, out = 0.0, {}
    for G in (3, 5):
        q, args, past = cross_case(dev, 8, G, 60 + G, Ta=800)
        for qdtype in (torch.bfloat16, torch.float32):
            e, tols = hold_cross(f"Ta 800, 8 windows x {G}, q {qdtype}",
                                 q.to(qdtype), args, past)
            err = max(err, e)
        if G == 3:
            kern = lambda: XA.cross_attention_q8_kernel(q, *args)
            b_ms, b_by = cross_bound(8, 3, 800)
            out.update(
                ms=time_ms(kern, 20), device_ms=device_ms(kern),
                plain_ms=time_ms(
                    lambda: XA.cross_attention_q8_reference(q, *args), 5),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                splits=DL.cross_split(800, 160, 3, cb.sm_count(dev)),
                shape="q (8, 20, 3, 64) bf16, K/V (8, 20, 800, 64) int8 + "
                      "f32 scales (the prefill of a bucket batch)")
        del q, args, past
    out.update(max_abs_err=err, tolerance=tols)
    return out


def kernel_cross_attn(dev, entries):
    """The grouped int8 cross-attention kernel, f32 out (its standalone
    entry, which the prefills launch once per decoder layer; the step runs
    the same device code with a bf16 out, held in the step checks), on the
    step's split plan (held against its mirror in check_decode_plans):
    held at the beam step's shape, 8 windows x 20 heads x 5 queries over
    1500 keys, and at the slices' prefill shapes over their 6 windows,
    G = P = 3 (greedy and beam, once per window; the block-wide kernel)
    and G = best_of x P = 15 (the fallback ladder; the per-warp kernel),
    and at G 20 (chunks of 16 and 4), with bf16 queries and with f32
    queries; timed by events and by device time at 8 x 5, 6 x 3 and
    6 x 15."""
    import torch
    from whisper_aries_tpu_torch.ops import cross_attn as XA
    from whisper_aries_tpu_torch.ops import cuda_build as cb
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    Bw, H, G, T, dh = 8, 20, 5, 1500, 64
    sms = cb.sm_count(dev)
    q, args, _ = cross_case(dev, Bw, G, 4)
    err, tols = hold_cross(f"{Bw} windows x {G}", q, args)
    kern = lambda: XA.cross_attention_q8_kernel(q, *args)
    ms, dev_ms = time_ms(kern, 20), device_ms(kern)
    plain_ms = time_ms(lambda: XA.cross_attention_q8_reference(q, *args), 5)

    b_ms, b_by = cross_bound(Bw, G, T)
    extra = {}
    for Gp in (3, 15, 20):
        qp, ap, _ = cross_case(dev, 6, Gp, 40 + Gp)
        for qdtype in (torch.bfloat16, torch.float32):
            qd = qp.to(qdtype)
            e, _ = hold_cross(f"prefill, 6 windows x {Gp}, q {qdtype}", qd, ap)
            err = max(err, e)
        if Gp != 20:
            kp = lambda: XA.cross_attention_q8_kernel(qp, *ap)
            extra[f"ms_at_g{Gp}_6_windows"] = time_ms(kp, 20)
            extra[f"device_ms_at_g{Gp}_6_windows"] = device_ms(kp)
            extra[f"bound_ms_at_g{Gp}_6_windows"] = cross_bound(6, Gp, T)[0]
        del qp, ap
    entries.append(dict(
        name="cross_attn_q8", route="cuda",
        source="whisper_aries_tpu_torch/csrc/cross_attn.cu",
        replaces="whisper_aries_tpu/ops/pallas_cross_attn.py:50",
        also_replaces="whisper_aries_tpu/ops/pallas_cross_attn.py:115",
        max_abs_err=err, tolerance=tols, ms=ms, device_ms=dev_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_note="none: no one PyTorch call attends over int8 K/V "
                     "with per-position scales",
        splits={"6x20, G 3": DL.cross_split(T, 120, 3, sms),
                "6x20, G 15": DL.cross_split(T, 120, 15, sms),
                "8x20, G 5": DL.cross_split(T, 160, 5, sms)},
        shape=f"q ({Bw}, {H}, {G}, {dh}) bf16, K/V ({Bw}, {H}, {T}, {dh}) "
              "int8 + f32 scales; also inside every decode step",
        bucket=cross_bucket(dev), **extra))


def large_v3_ids():
    from whisper_aries_tpu_torch.decoding import generate as G
    from whisper_aries_tpu_torch.pipeline.engine import DummyTokenizer

    return G.DecodeSpecialIds.from_tokenizer(DummyTokenizer(51866))


def tail_inputs(dev, B, K, V, ids, seed):
    """Logits and a beam state that reaches every branch of the grammar:
    fresh rows, open pairs, closed pairs, a monotonic floor, dead beams;
    1% of the vocabulary suppressed."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    neg = float(np.finfo(np.float32).min)
    tsb = ids.timestamp_begin
    logits = 3 * torch.randn((B * K, V), generator=g, device=dev)
    sum_lp = 2 * torch.randn((B, K), generator=g, device=dev)
    sum_lp[torch.rand((B, K), generator=g, device=dev) < 0.2] = neg
    sum_lp[:, 0] = torch.randn((B,), generator=g, device=dev)  # one live
    pick = lambda vals: torch.as_tensor(vals, device=dev)[torch.randint(
        0, len(vals), (B, K), generator=g, device=dev)]
    last = pick([100, 221, tsb + 3, tsb + 40])
    pen = pick([-1, 50, tsb + 2, tsb + 39])
    mts = pick([-1, tsb + 5, tsb + 90])
    sup = torch.where(torch.rand((V,), generator=g, device=dev) < 0.01,
                      neg, 0.0)
    return logits, sum_lp, last, pen, mts, sup


def tail_chunk_dropped(args, kw, K, with_ts, W, best):
    """The plain beam tail with one chunk's candidates dropped: for each
    window, the W columns of the chunk holding the window's best flat index
    ``best`` (B,) leave the top-K (a merge that loses one block's
    candidates). Returns top_idx."""
    import types

    import torch
    from whisper_aries_tpu_torch.decoding.logit_filters import apply_filters
    from whisper_aries_tpu_torch.ops import beam_tail as BT

    logits, sum_lp, last, pen, mts, sup, is_first = args
    BK, V = logits.shape
    B = BK // K
    ids = types.SimpleNamespace(
        no_timestamps=kw["no_ts"], blank=kw["blank"], eot=kw["eot"],
        timestamp_begin=kw["tsb"],
        max_initial_timestamp_index=kw["init_cap"] - kw["tsb"])
    f = apply_filters(logits, ids, sup, is_first, last.reshape(-1),
                      pen.reshape(-1), mts.reshape(-1), with_ts)
    total = sum_lp[:, :, None] + torch.log_softmax(f, dim=-1).reshape(B, K, V)
    total[:, :, kw["eot"]] = float(np.finfo(np.float32).min)
    for b, i in enumerate(best.tolist()):
        k, v = divmod(i, V)
        total[b, k, v // W * W:(v // W + 1) * W] = -math.inf
    return BT._top_k_unrolled(total.reshape(B, K * V), K)[1]


def kernel_beam_tail(dev, entries):
    """The beam-tail kernel at 8 windows x 5 beams x 51866, with and
    without timestamps, at the first and a later position; a tie planted
    across beams 1 and 3 of window 0 must go to beam 1; two runs give the
    same bits; dropping the candidates of the chunk (one block of a row)
    that holds each window's best must move top_idx past the limit. The C
    chunk plan equals its mirror."""
    import torch
    from whisper_aries_tpu_torch.ops import beam_tail as BT
    from whisper_aries_tpu_torch.ops import cuda_build as cb

    B, K = 8, 5
    ids = large_v3_ids()
    V = ids.n_vocab
    sms = cb.sm_count(dev)
    C, W = BT.chunk_plan(V, B * K, sms)
    cases = [(V_, rows) for V_ in (1000, 51866) for rows in (5, 30, 40, 64)]
    check("beam_tail plan: C = Python mirror",
          all(BT.kernel_chunk_plan(V_, rows, sms)
              == BT.chunk_plan(V_, rows, sms) for V_, rows in cases),
          f"{sms} SMs, {C} chunks of {W} columns at {B} x {K} x {V}")
    kw = dict(tsb=ids.timestamp_begin, eot=ids.eot, blank=ids.blank,
              no_ts=ids.no_timestamps,
              init_cap=ids.timestamp_begin + ids.max_initial_timestamp_index)
    logits, sum_lp, last, pen, mts, sup = tail_inputs(dev, B, K, V, ids, 5)
    logits[3] = logits[1]
    sum_lp[0, 1] = sum_lp[0, 3] = 20.0  # the tie leads every case
    for st, fresh in ((last, 100), (pen, -1), (mts, -1)):
        st[0, 1] = st[0, 3] = fresh  # the same (text) state on both
    rev = lambda t: t.reshape(B, K, -1).flip(1).reshape(t.shape)
    worst = {"score_rel": 0.0, "idx_mismatch": 0.0}
    dropped = math.inf
    worst_abs = 0.0
    tie_ok = same = True
    for with_ts, is_first in ((True, False), (True, True), (False, False)):
        args = (logits, sum_lp, last, pen, mts, sup, is_first, K)
        got = BT.beam_tail_kernel(*args, with_timestamps=with_ts, **kw)
        again = BT.beam_tail_kernel(*args, with_timestamps=with_ts, **kw)
        want = BT.beam_tail_plain(*args, with_timestamps=with_ts, **kw)
        torch.cuda.synchronize()
        same &= all(torch.equal(a, b) for a, b in zip(got, again))
        worst["idx_mismatch"] = max(worst["idx_mismatch"], float(
            (got[1] != want[1]).float().mean()))
        for a, b in ((got[0], want[0]), (got[2], want[2])):
            fin = b.abs() < 1e30
            if not torch.equal(a[~fin], b[~fin]):
                worst["score_rel"] = math.inf
            if bool(fin.any()):
                d = float((a - b)[fin].abs().max())
                worst_abs = max(worst_abs, d)
                worst["score_rel"] = max(worst["score_rel"],
                                         d / float(b[fin].abs().max()))
        # the mistakes: ties to the highest flat index (the plain version
        # on the beams in reverse order, its indices mapped back); one
        # chunk's candidates lost in the merge
        r = BT.beam_tail_plain(rev(logits), rev(sum_lp), rev(last), rev(pen),
                               rev(mts), sup, is_first, K,
                               with_timestamps=with_ts, **kw)[1]
        wrong = (K - 1 - r // V) * V + r % V
        tie_ok &= bool((got[1][0, :2] // V).tolist() == [1, 3])
        tie_ok &= not torch.equal(wrong, want[1])
        lost = tail_chunk_dropped(args[:7], kw, K, with_ts, W, want[1][:, 0])
        dropped = min(dropped, float((lost != want[1]).float().mean()))
    held("beam_tail[8 x 5 x 51866]", worst,
         {"score_rel": 1e-5, "idx_mismatch": 1e-9},
         {"idx_mismatch": dropped})
    check("beam_tail[planted tie to the lowest flat index]", tie_ok,
          "beam 1 before beam 3; ties to the highest index give other "
          "top_idx")
    check("beam_tail[two runs bitwise]", same,
          "live_score, top_idx and eot_scores, every case")
    args = (logits, sum_lp, last, pen, mts, sup, False, K)
    kern = lambda: BT.beam_tail_kernel(*args, **kw)
    ms, dev_ms = time_ms(kern, 20), device_ms(kern)
    plain_ms = time_ms(lambda: BT.beam_tail_plain(*args, **kw), 5)
    nbytes = B * K * V * 4 + V * 4 + B * K * (4 + 3 * 8) + B * K * 16
    b_ms, b_by = bound(nbytes, 12 * B * K * V, PEAK_F32)
    entries.append(dict(
        name="beam_tail", route="cuda",
        source="whisper_aries_tpu_torch/csrc/beam_tail.cu",
        replaces="whisper_aries_tpu/ops/pallas_beam_tail.py:174",
        max_abs_err=worst_abs, tolerance="top_idx identical; "
        "scores within 1e-5 of max |want|", ms=ms, device_ms=dev_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_note="none: no one PyTorch call filters, normalises and "
                     "takes the top-K with first-index ties",
        chunks=[C, W],
        shape=f"logits ({B * K}, {V}) f32, state ({B}, {K})"))


def kernel_reorder(dev, entries):
    """The reorder kernel on the int8 self-cache leaves of the beam slice
    (R = 40 rows = 8 windows x 5 beams, T = 3 + 224): bit for bit the plain
    gather, in place."""
    import torch
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import beam_reorder as BR

    dims = W.PRESETS["large-v3"]
    B, K, T = 8, 5, 3 + 224
    L, H = dims.n_text_layer, dims.n_text_head
    g = torch.Generator(device=dev).manual_seed(6)
    cache = {"kv8": torch.randint(-127, 128, (L, B * K, 2, H, T, 64),
                                  generator=g, device=dev,
                                  dtype=torch.int8),
             "ksc": torch.rand((L, B * K, 2, H, T), generator=g,
                               device=dev)}
    src = torch.randint(0, K, (B, K), generator=g, device=dev,
                        dtype=torch.int32)
    src[0] = torch.arange(K, device=dev)  # a window that keeps its beams
    want = {k: BR.permute_rows_plain(v.clone(), src) for k, v in
            cache.items()}
    got = BR.permute_cache_rows(clone(cache), src)
    torch.cuda.synchronize()
    same = all(torch.equal(got[k], want[k]) for k in cache)
    check("beam_reorder[int8 self cache, R 40]", same,
          "kv8 and ksc identical to the plain gather")
    # timed where every row moves (each beam takes its left neighbour's
    # history: the kernel's most work); the random map above, with its
    # kept rows, timed beside with the bytes that map needs
    roll = torch.roll(torch.arange(K, device=dev, dtype=torch.int32), 1)
    roll = roll[None].expand(B, K).contiguous()
    work = clone(cache)
    ms = time_ms(lambda: BR.permute_cache_rows(work, roll), 20)
    ms_random = time_ms(lambda: BR.permute_cache_rows(work, src), 20)
    plain_ms = time_ms(lambda: {k: BR.permute_rows_plain(v, roll)
                                for k, v in work.items()}, 5)
    flat = (torch.arange(B, device=dev)[:, None] * K + roll.long()).reshape(-1)
    lib_ms = time_ms(lambda: [torch.index_select(v, 1, flat)
                              for v in work.values()], 20)
    row_bytes = sum(v[0, 0].numel() * v.element_size() for v in cache.values())
    # every row moves: each read once and written once
    b_ms, b_by = bound(2 * L * B * K * row_bytes, 0, PEAK_F32)
    # the random map: the moved rows written, their distinct sources read
    moved = src != torch.arange(K, device=dev)[None]
    reads = sum(len(set(src[b][moved[b]].tolist())) for b in range(B))
    b_random, _ = bound(L * row_bytes * (int(moved.sum()) + reads), 0,
                        PEAK_F32)
    entries.append(dict(
        name="beam_reorder", route="cuda",
        source="whisper_aries_tpu_torch/csrc/beam_reorder.cu",
        replaces="whisper_aries_tpu/ops/pallas_beam_reorder.py:37",
        max_abs_err=0.0 if same else math.inf, tolerance="bitwise",
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms,
        library_note="torch.index_select along the row axis, out of place",
        ms_random_map=ms_random, bound_ms_random_map=b_random,
        rows_moved_random_map=int(moved.sum()),
        shape=f"kv8 ({L}, {B * K}, 2, {H}, {T}, 64) int8 + ksc f32, "
              "one launch per leaf, every row moving"))


def profile_beam_step(dev, parts, B):
    """One whole beam step at R = B x 5 rows (B windows x 5 beams),
    position 116: the decoder-layer kernels (grouped cross-attention
    inside), the vocab product, the beam tail and the reorder of both cache
    leaves."""
    import torch
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import beam_reorder as BR
    from whisper_aries_tpu_torch.ops import beam_tail as BT
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    K, P, pos = 5, 4, 116
    R = B * K
    dims, params, wpack, cross, cache, g = decode_inputs(dev, R, P, True,
                                                         seed=7, windows=B)
    ids = large_v3_ids()
    V = ids.n_vocab
    kw = dict(tsb=ids.timestamp_begin, eot=ids.eot, blank=ids.blank,
              no_ts=ids.no_timestamps,
              init_cap=ids.timestamp_begin + ids.max_initial_timestamp_index)
    _, sum_lp, last, pen, mts, sup = tail_inputs(dev, B, K, V, ids, 8)
    src = torch.roll(torch.arange(K, device=dev, dtype=torch.int32), 1)
    src = src[None].expand(B, K).contiguous()
    dec = params["decoder"]
    x = torch.randn((R, dims.n_text_state), generator=g,
                    device=dev).to(torch.bfloat16)
    graph = DL.DecodeStepGraph(wpack, cache, cross, R, dims.n_text_head)

    def step():  # the layers replayed from one graph, as the slices run
        y = graph.run(x, pos)
        logits = W.vocab_logits(dec, y)
        BT.beam_tail(logits, sum_lp, last, pen, mts, sup, False, K, **kw)
        BR.permute_cache_rows(cache, src)

    ms = time_ms(step, 10)
    profile_step(f"R {R} ({B} windows x {K} beams), position {pos}", step,
                 what="beam step")
    del graph
    parts.append(dict(name=f"beam step R {R}", ms=ms))


def kernel_quant_matmul(dev, entries):
    """The W8A16 GEMM (the int8 dense layers under ARIES_QUANT_IMPL=pallas)
    at the int8 slices' shapes, bf16 out as the path writes it: the
    encoder and cross K/V over 6 windows (M 9000 = 6 x 1500; K = N = 1280,
    fc1 N 5120, fc2 K 5120) and over a 16 s bucket batch of 8 windows (M
    6400 = 8 x 800), an odd M, the words slice's prefill (M 18 = 6
    windows x 3 prompt tokens) and the six dense layers of one unfused
    decoder layer at M 6 and at M 1. Each held in bf16 steps against its
    plain version; each named mistake must flip more elements than the
    limit: the scale on the sum (kernel 3's function, the weights not
    rounded to bf16), one K slice's partials dropped from the cluster sum
    (the plan's last slice; the last 32 rows of K on the wgmma path), and
    the last row tile's rows left unwritten (the last 8-row group of the
    split-K path, the last 128-row tile of the wgmma path). cuBLAS's
    device time stands beside the kernel's."""
    import torch
    from whisper_aries_tpu_torch.ops import quant as Q

    d, ff = 1280, 5120
    shapes = [("encoder q/k/v/o, cross k/v", 9000, d, d),
              ("encoder fc1", 9000, d, ff), ("encoder fc2", 9000, ff, d),
              ("bucket encoder q/k/v/o, cross k/v", 6400, d, d),
              ("bucket encoder fc1", 6400, d, ff),
              ("bucket encoder fc2", 6400, ff, d),
              ("odd M", 1517, d, d),
              ("conditioned prefill q/k/v/o", 227, d, d),
              ("conditioned ladder prefill q/k/v/o", 1135, d, d),
              ("words prefill qkv", 18, d, 3 * d),
              ("words prefill fc2", 18, ff, d),
              ("step qkv", 6, d, 3 * d), ("step o, cross q, cross o", 6, d, d),
              ("step fc1", 6, d, ff), ("step fc2", 6, ff, d),
              ("M 1 qkv", 1, d, 3 * d), ("M 1 o", 1, d, d),
              ("M 1 fc1", 1, d, ff), ("M 1 fc2", 1, ff, d)]
    # bf16 outputs rounded from f32 sums taken in another order: one step
    # apart where the sum sits at a rounding midpoint (in 1e-4..3e-3 of
    # them, more at K 5120); held as a share of elements and, since a sum
    # that cancels to near 0 is many of its own steps off, in steps of the
    # largest |want| (2^-7 is one step of it at most)
    tol = {"max_rel": 2 ** -7, "flipped": 1e-2}

    def errors(got, want):
        return {"max_rel": max_rel(got, want),
                "flipped": bf16_steps(got, want)["flipped"]}

    rows, worst, bucket_worst = [], 0.0, 0.0
    g = torch.Generator(device=dev).manual_seed(11)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for what, M, K, N in shapes:
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        q8, s = Q.quantize_int8(0.02 * torch.randn((K, N), generator=g,
                                                   device=dev))
        got = Q.quant_matmul_dequant_kernel(x, q8, s)
        want = Q.quant_matmul_dequant_plain(x, q8, s, torch.bfloat16)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got.float()).all()):
            fail(f"W8A16 GEMM output is not finite ({what})")
        path, splits, tile = Q.gemm_plan(M, N, K, sms)
        label = f"quant_matmul[{what}: M {M}, K {K}, N {N}, {path}]"
        errs = errors(got, want)
        outscale = Q._quant_matmul_outscale(x, q8, s).to(torch.bfloat16)
        # the scale on the sum is one step off where the unrounded weights
        # move a sum across a midpoint: it shows in the share, not the size
        held(f"{label} scale on the sum", errs, tol,
             {"flipped": errors(outscale, want)["flipped"]})
        xcut = x.clone()
        cut = K // splits if path == "splitk" and splits > 1 else 32
        xcut[:, K - cut:] = 0
        name = (f"K slice {splits - 1} of {splits}'s partials dropped"
                if path == "splitk" and splits > 1 else "last K rows dropped")
        held(f"{label} {name}", errs, tol, errors(
            Q.quant_matmul_dequant_plain(xcut, q8, s, torch.bfloat16), want))
        step = 8 if path == "splitk" else tile
        t0 = (M - 1) // step * step
        held(f"{label} last {step}-row tile's rows unwritten",
             errors(got[t0:], want[t0:]), tol,
             errors(torch.zeros_like(want[t0:]), want[t0:]))
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        if what.startswith("bucket"):
            bucket_worst = max(bucket_worst, float(
                (got.float() - want.float()).abs().max()))
        w16 = Q.dequantize_bf16(q8, s)
        if path == "wgmma":  # the first pass's scratch, bit for bit
            same = torch.equal(Q.dequantize_bf16_kernel(q8, s).view(
                torch.int16), w16.view(torch.int16))
            check(f"{label} dequant scratch bitwise", same,
                  "equal" if same else "differs")
        b_ms, b_by = bound(M * K * 2 + K * N + N * 4 + M * N * 2,
                           2 * M * N * K, PEAK_BF16)
        iters = 50 if M < 100 else 20
        kern = lambda: Q.quant_matmul_dequant_kernel(x, q8, s)
        lib = lambda: torch.matmul(x, w16)
        rows.append(dict(
            what=what, M=M, K=K, N=N, errors=errs,
            ms=time_ms(kern, iters), device_ms=device_ms(kern),
            host_ms=host_ms(kern),
            plain_ms=time_ms(lambda: Q.quant_matmul_dequant_plain(
                x, q8, s, torch.bfloat16), 5),
            library_ms=time_ms(lib, iters), library_device_ms=device_ms(lib),
            bound_ms=b_ms, bound_by=b_by, path=path, splits=splits,
            rows=tile))
        del x, q8, s, got, want, outscale, xcut, w16
    print("quant_matmul shapes " + json.dumps(rows), flush=True)
    crossover = quant_matmul_crossover(dev, g)
    print("quant_matmul crossover " + json.dumps(crossover), flush=True)
    step = [r for r in rows if r["what"].startswith("step")]
    per_layer = {k: sum(r[k] * (3 if r["what"].startswith("step o") else 1)
                        for r in step)
                 for k in ("ms", "device_ms", "host_ms", "bound_ms",
                           "library_ms", "library_device_ms")}
    head = rows[0]
    bucket = [r for r in rows if r["what"].startswith("bucket")]
    entries.append(dict(
        name="quant_matmul", route="cuda",
        source="whisper_aries_tpu_torch/csrc/quant_matmul.cu",
        replaces="whisper_aries_tpu/ops/quant.py:59",
        max_abs_err=worst, tolerance=tol, ms=head["ms"],
        device_ms=head["device_ms"],
        host_ms=head["host_ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        library_device_ms=head["library_device_ms"],
        library_note="torch.matmul of bf16 x with the dequantized bf16 "
                     "weight, made before timing (cuBLAS, the same FLOPs)",
        shape=f"x ({head['M']}, {head['K']}) bf16 @ int8 ({head['K']}, "
              f"{head['N']}) + f32 scales -> bf16",
        decoder_layer_at_m6=per_layer, shapes=rows, crossover=crossover,
        bucket=dict(
            {k: bucket[0][k] for k in ("ms", "device_ms", "host_ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "library_device_ms",
                                       "path")},
            max_abs_err=bucket_worst, tolerance=tol,
            shape="x (6400, 1280) bf16 @ int8 (1280, 1280): a bucket "
                  "batch's encoder and cross K/V products",
            paths={r["what"]: r["path"] for r in bucket})))


def quant_matmul_crossover(dev, g):
    """Device ms of each GEMM path forced, at the M where the plan's
    cut-over (Q.WGMMA_MIN_MN output elements) lies, K 1280 with N 1280,
    3840 and 5120: the measurement the cut-over is set from."""
    import torch
    from whisper_aries_tpu_torch.ops import quant as Q

    rows = []
    for N in (1280, 3840, 5120):
        for M in (32, 64, 128, 192, 256, 384, 512, 768, 1024):
            x = torch.randn((M, 1280), generator=g, device=dev).to(
                torch.bfloat16)
            q8, s = Q.quantize_int8(0.02 * torch.randn(
                (1280, N), generator=g, device=dev))
            row = dict(M=M, K=1280, N=N)
            for path in Q.GEMM_PATHS:
                row[path] = device_ms(lambda: Q.quant_matmul_dequant_kernel(
                    x, q8, s, path=path), 10)
            rows.append(row)
    return rows


#: a large-v3 decoder layer's four dense products (K, N): the fused q/k/v,
#: o (and the cross q, o), fc1, fc2
LAYER_PRODUCTS = (("qkv", 1280, 3840), ("o", 1280, 1280), ("fc1", 1280, 5120),
                  ("fc2", 5120, 1280))
#: the native path's row counts: the unfused step (6 windows), the words
#: prefill (6 x 3 prompt tokens), the conditioned prefill and its ladder's
#: 5 rows, a 16 s bucket batch (8 x 800), 6 windows x 1500
NATIVE_M = (6, 18, 227, 1135, 6400, 9000)


def reciprocal_trap() -> float:
    """A bf16 value a whose a / 127 and a * f32(1 / 127) are two f32
    values: a row whose max |x| is a shows the reciprocal mistake in its
    scale."""
    r = np.float32(1.0 / 127.0)
    for i in range(128):
        a = np.float32(1.0 + i / 128.0)  # exact in bf16
        if np.float32(a / np.float32(127.0)) != np.float32(a * r):
            return float(a)
    fail("no value in [1, 2) tells a / 127 from a * (1 / 127)")


def native_rows(dev, g, M, K, trap):
    """x (M, K) bf16: row 0 exact halves once divided by its scale (max
    |x| 127, so sx = 1), row 1 zero, row 2 with max |x| the reciprocal
    trap, the rest N(0, 1)."""
    import torch

    x = torch.randn((M, K), generator=g, device=dev)
    x[0] = torch.arange(K, device=dev).float() * 37 % 254 - 126.5
    x[0, 0] = 127.0
    x[1] = 0.0
    x[2] = (0.25 * trap * x[2]).clamp(-0.9 * trap, 0.9 * trap)
    x[2, 0] = trap
    return x.to(torch.bfloat16)


def int_mm_or_none(a, b):
    """torch._int_mm(a, b), or None where it refuses the shapes (M <= 16)."""
    import torch

    try:
        return torch._int_mm(a, b)
    except RuntimeError:
        return None


def kernel_int8_gemm(dev, entries):
    """The native int8 path's two kernels (ARIES_QUANT_IMPL=native) at a
    large-v3 layer's four products (LAYER_PRODUCTS) at each NATIVE_M, bf16
    activations: the row quantization (int8 values and f32 scales) and the
    s8 GEMM (bf16 and f32 out) held bit for bit against their plain
    versions on the card. Each named mistake must fail its hold: the scale
    as ax * (1 / 127), round half away from zero (roundf), sx = 0 on a zero
    row; the rescale as (acc * s) * sx, B read as if K-major, the plan's
    last K slice (or the last 32 K rows) dropped. Timed beside the plain
    versions, torch._int_mm (B row-major and column-major, where it takes
    the call; with the torch ops for the quantization and the rescale, and
    whether that gives the kernels' bits), kernel 5 (the W8A16 GEMM) and
    cuBLAS bf16 on the dequantized weights."""
    import torch
    from whisper_aries_tpu_torch.ops import quant as Q

    trap = reciprocal_trap()
    g = torch.Generator(device=dev).manual_seed(21)
    weights = {}
    for name, K, N in LAYER_PRODUCTS:
        q8, s = Q.quantize_int8(0.02 * torch.randn((K, N), generator=g,
                                                   device=dev))
        weights[name] = (q8, s, q8.t().contiguous().t(),
                         Q.dequantize_bf16(q8, s))
    c127 = torch.tensor(127.0, device=dev)
    rows, worst = [], 0.0
    for M in NATIVE_M:
        xs = {K: native_rows(dev, g, M, K, trap)
              for K in {k for _, k, _ in LAYER_PRODUCTS}}
        for name, K, N in LAYER_PRODUCTS:
            x = xs[K]
            q8, s, q8_cm, w16 = weights[name]
            label = f"int8 native[{name}: M {M}, K {K}, N {N}]"
            x8, sx = Q.quantize_rows_kernel(x)
            x8_p, sx_p = Q.quantize_rows_plain(x)
            torch.cuda.synchronize()

            def same_q(a8, asx):
                return (torch.equal(a8, x8_p)
                        and torch.equal(asx.view(torch.int32),
                                        sx_p.view(torch.int32)))

            xf = x.float()
            ax = xf.abs().amax(-1, keepdim=True)
            v = xf / sx_p
            sx_r = torch.where(ax > 0, ax * (1.0 / 127.0),
                               torch.ones_like(ax))
            sx_0 = torch.where(ax > 0, sx_p, torch.zeros_like(ax))
            mistakes = {
                "ax * (1/127)": (torch.clamp(torch.round(xf / sx_r), -127,
                                             127).to(torch.int8), sx_r),
                "roundf": (torch.clamp(torch.sign(v) * torch.floor(
                    v.abs() + 0.5), -127, 127).to(torch.int8), sx_p),
                "sx = 0 on a zero row": (x8_p, sx_0)}
            ok = same_q(x8, sx)
            caught = {k: not same_q(*m) for k, m in mistakes.items()}
            check(f"{label} row quantization bitwise", ok and all(
                caught.values()), f"equal: {ok}; mistakes caught: {caught}")
            acc = (x8_p.double() @ q8.double()).float()
            nk = K // 32
            plan_rows, splits = Q.int8_gemm_plan(M, N, K)
            cut = 32 * ((splits - 1) * nk // splits) if splits > 1 else K - 32
            x8_cut = x8_p.clone()
            x8_cut[:, cut:] = 0
            wrong = {
                "(acc * s) * sx": (acc * s) * sx_p,
                "B read as if K-major": (x8_p.double() @ q8.reshape(
                    N, K).t().double()).float() * sx_p * s,
                (f"K slice {splits - 1} of {splits} dropped" if splits > 1
                 else "last 32 K rows dropped"): (
                    x8_cut.double() @ q8.double()).float() * sx_p * s}
            for dt in (torch.float32, torch.bfloat16):
                got = Q.quant_matmul_int8io_kernel(x8, sx, q8, s, dt)
                want = Q.quant_matmul_int8io_plain(x, q8, s, dt)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(got.float()).all()):
                    fail(f"{label}: int8 GEMM output is not finite")
                ok = torch.equal(got, want)
                worst = max(worst, float((got.float() - want.float())
                                         .abs().max()))
                detail = f"{str(dt)[6:]} out equal: {ok}"
                if dt == torch.float32:  # a mistake fails the f32 hold
                    caught = {k: not torch.equal(m, want)
                              for k, m in wrong.items()}
                    ok = ok and all(caught.values())
                    detail += f"; mistakes caught: {caught}"
                check(f"{label} GEMM bitwise, rows {plan_rows}, {splits} "
                      "K slices", ok, detail)
            del acc, x8_cut, wrong, mistakes, v, xf
            # times (bf16 out, as the path writes it)
            iters = 50 if M < 100 else 20
            quant = lambda: Q.quantize_rows_kernel(x)
            gemm = lambda: Q.quant_matmul_int8io_kernel(x8, sx, q8, s)
            both = lambda: Q.quant_matmul_int8io(x, q8, s)
            mm_rm = int_mm_or_none(x8, q8)
            mm_cm = int_mm_or_none(x8, q8_cm)

            def torch_native():
                xf = x.float()
                ax = xf.abs().amax(-1, keepdim=True)
                sxt = torch.where(ax > 0, ax / c127, torch.ones_like(ax))
                a8 = torch.clamp(torch.round(xf / sxt), -127, 127).to(
                    torch.int8)
                return ((torch._int_mm(a8, q8_cm).float() * sxt) * s).to(
                    torch.bfloat16)

            row = dict(
                what=name, M=M, K=K, N=N, rows=plan_rows, splits=splits,
                ms=time_ms(both, iters), host_ms=host_ms(both),
                quantize_ms=time_ms(quant, iters),
                quantize_device_ms=device_ms(quant, 10),
                gemm_ms=time_ms(gemm, iters),
                gemm_device_ms=device_ms(gemm, 10),
                plain_ms=time_ms(lambda: Q.quant_matmul_int8io_plain(
                    x, q8, s, torch.bfloat16), 3),
                quantize_plain_ms=time_ms(lambda: Q.quantize_rows_plain(x),
                                          5),
                gemm_plain_ms=time_ms(lambda: (
                    (x8.double() @ q8.double()).float() * sx * s).to(
                        torch.bfloat16), 3),
                int_mm_row_major_ms=(time_ms(lambda: torch._int_mm(x8, q8),
                                             iters) if mm_rm is not None
                                     else None),
                int_mm_col_major_ms=(time_ms(lambda: torch._int_mm(
                    x8, q8_cm), iters) if mm_cm is not None else None),
                int_mm_col_major_device_ms=(device_ms(lambda: torch._int_mm(
                    x8, q8_cm), 10) if mm_cm is not None else None),
                torch_ops_native_ms=(time_ms(torch_native, iters)
                                     if mm_cm is not None else None),
                torch_ops_native_equal=(torch.equal(
                    torch_native(), Q.quant_matmul_int8io(x, q8, s))
                    if mm_cm is not None else None),
                w8a16_ms=time_ms(lambda: Q.quant_matmul_dequant_kernel(
                    x, q8, s), iters),
                w8a16_device_ms=device_ms(
                    lambda: Q.quant_matmul_dequant_kernel(x, q8, s), 10),
                cublas_bf16_ms=time_ms(lambda: torch.matmul(x, w16), iters),
                cublas_bf16_device_ms=device_ms(
                    lambda: torch.matmul(x, w16), 10))
            row["device_ms"] = row["quantize_device_ms"] + row[
                "gemm_device_ms"]
            # the function from x: x read once, q and s once, out written
            row["bound_ms"], row["bound_by"] = bound(
                M * K * 2 + K * N + N * 4 + M * N * 2, 2 * M * N * K,
                PEAK_S8)
            row["gemm_bound_ms"], row["gemm_bound_by"] = bound(
                M * K + M * 4 + K * N + N * 4 + M * N * 2, 2 * M * N * K,
                PEAK_S8)
            row["quantize_bound_ms"], _ = bound(M * K * 2 + M * K + M * 4,
                                                0, PEAK_S8)
            rows.append(row)
            del x8, sx, x8_p, sx_p, mm_rm, mm_cm
        del xs
    print("int8 native shapes " + json.dumps(rows), flush=True)
    sweep = int8_gemm_sweep(dev, g)
    print("int8 GEMM plan sweep " + json.dumps(sweep), flush=True)
    head = next(r for r in rows
                if (r["M"], r["what"]) == (NATIVE_M[-1], "o"))
    step = [r for r in rows if r["M"] == NATIVE_M[0]]
    # a decoder layer at M 6: qkv, o (with the cross q and o: 3 products),
    # fc1, fc2
    per_layer = {k: sum(r[k] * (3 if r["what"] == "o" else 1) for r in step)
                 for k in ("ms", "device_ms", "gemm_device_ms",
                           "quantize_device_ms", "bound_ms",
                           "w8a16_device_ms", "cublas_bf16_device_ms")}
    tol = "bit for bit (the plain version's bits)"
    shape = (f"x ({head['M']}, {head['K']}) bf16, q int8 ({head['K']}, "
             f"{head['N']}) + f32 scales")
    entries.append(dict(
        name="int8_quantize_rows", route="cuda",
        source="whisper_aries_tpu_torch/csrc/int8_gemm.cu",
        replaces="whisper_aries_tpu/ops/quant.py:151",
        max_abs_err=0.0, tolerance=tol, ms=head["quantize_ms"],
        device_ms=head["quantize_device_ms"],
        plain_ms=head["quantize_plain_ms"],
        bound_ms=head["quantize_bound_ms"], bound_by="bytes",
        library_ms=None,
        library_note="none: no one PyTorch call quantizes rows by their "
                     "own absmax scales",
        shape=f"x ({head['M']}, {head['K']}) bf16 -> int8 + f32 row "
              "scales"))
    entries.append(dict(
        name="int8_gemm", route="cuda",
        source="whisper_aries_tpu_torch/csrc/int8_gemm.cu",
        replaces="whisper_aries_tpu/ops/quant.py:151",
        max_abs_err=worst, tolerance=tol, ms=head["gemm_ms"],
        device_ms=head["gemm_device_ms"], plain_ms=head["gemm_plain_ms"],
        bound_ms=head["gemm_bound_ms"], bound_by=head["gemm_bound_by"],
        library_ms=head["int_mm_col_major_ms"],
        library_device_ms=head["int_mm_col_major_device_ms"],
        library_note="torch._int_mm with B column-major (the s32 product "
                     "alone: no row quantization, no rescale); B "
                     "row-major, as the port keeps q, in int_mm_row_major_ms",
        int_mm_row_major_ms=head["int_mm_row_major_ms"],
        native_ms=head["ms"], native_bound_ms=head["bound_ms"],
        torch_ops_native_ms=head["torch_ops_native_ms"],
        w8a16_ms=head["w8a16_ms"], cublas_bf16_ms=head["cublas_bf16_ms"],
        decoder_layer_at_m6=per_layer, shapes=rows,
        plan_sweep=sweep["best"], shape=shape + " -> bf16"))


def int8_gemm_sweep(dev, g):
    """Device ms of the native s8 GEMM at forced (row tile, K slices)
    around its plan, over a large-v3 layer's four products at M 6, 18, 64,
    227 and 1135: the measurement ops/quant.py's INT8_STAGES_A_SLICE is
    set from. Every plan must give the same bits. Returns the rows and,
    for each (M, product), the best plan beside the chosen one."""
    import torch
    from whisper_aries_tpu_torch.ops import quant as Q

    rows, same = [], True
    for M, tiles, slices in ((6, (16,), (1, 2, 4, 8, 16)),
                             (18, (16, 32), (1, 2, 4, 8, 16)),
                             (64, (32, 64), (1, 2, 4, 8, 16)),
                             (227, (32, 64), (1, 2, 3, 4, 8)),
                             (1135, (32, 64), (1, 2))):
        for name, K, N in LAYER_PRODUCTS:
            x8, sx = Q.quantize_rows_kernel(torch.randn(
                (M, K), generator=g, device=dev).to(torch.bfloat16))
            q8, s = Q.quantize_int8(0.02 * torch.randn((K, N), generator=g,
                                                       device=dev))
            want = Q.quant_matmul_int8io_kernel(x8, sx, q8, s)
            chosen = Q.int8_gemm_plan(M, N, K)
            plans = {(r, sp) for r in tiles for sp in slices
                     if sp <= K // 32} | {chosen}
            for plan in sorted(plans):
                kern = lambda: Q.quant_matmul_int8io_kernel(x8, sx, q8, s,
                                                            plan=plan)
                same = same and torch.equal(kern(), want)
                rows.append(dict(M=M, what=name, K=K, N=N, rows=plan[0],
                                 splits=plan[1], chosen=plan == chosen,
                                 device_ms=device_ms(kern, 10)))
    check("int8 GEMM plan sweep: every plan gives the same bits", same,
          f"{len(rows)} plans")
    best = []
    for key in dict.fromkeys((r["M"], r["what"]) for r in rows):
        rs = [r for r in rows if (r["M"], r["what"]) == key]
        b = min(rs, key=lambda r: r["device_ms"])
        c = next(r for r in rs if r["chosen"])
        best.append(dict(M=key[0], what=key[1], best=[b["rows"], b["splits"]],
                         best_ms=b["device_ms"],
                         chosen=[c["rows"], c["splits"]],
                         chosen_ms=c["device_ms"]))
    return dict(plans=rows, best=best)


def self_split_dropped(q, k8, ks, v8, vs, mask, lo, hi):
    """The plain int8 self-attention with keys lo .. hi - 1 (one split)
    left out of P . V, still in the softmax: a cluster sum that drops one
    block's partial output."""
    import torch

    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k8.float())
    p = torch.softmax(logits * ks[:, :, None, :] + mask, dim=-1)
    p = p * vs[:, :, None, :]
    p[..., lo:hi] = 0
    return torch.einsum("bhst,bhtd->bhsd", p, v8.float())


def kernel_self_attn(dev, entries):
    """The int8 self-attention step at the self_int8 slice's shape (6 rows
    x 20 heads over its 227-position cache, K scales folding 1/8), at
    positions on both sides of a split boundary and with valid_start 100,
    stale values past each: held against its plain version in f32;
    ignoring the mask, dropping the last written position, or dropping
    the P . V of the split holding the position must move it past the
    limits. The C split plan equals its mirror; two runs give the same
    bits."""
    import torch
    from whisper_aries_tpu_torch.ops import cross_attn as XA
    from whisper_aries_tpu_torch.ops import cuda_build as cb
    from whisper_aries_tpu_torch.ops import self_attn as SA

    B, H, T, dh = 6, 20, 227, 64
    sms = cb.sm_count(dev)
    S, C = SA.split_plan(T, B * H, sms)
    cases = [(T_, pairs) for T_ in (16, 227, 448) for pairs in (20, 120, 800)]
    check("self_attn_q8 plan: C = Python mirror",
          all(SA.kernel_split_plan(T_, pairs, sms)
              == SA.split_plan(T_, pairs, sms) for T_, pairs in cases),
          f"{sms} SMs, {S} splits of {C} keys at {B} x {H}, T {T}")
    g = torch.Generator(device=dev).manual_seed(12)
    kv = torch.randn((2, B, H, T, dh), generator=g, device=dev).to(
        torch.bfloat16)
    kv8, sc = XA.quantize_kv_per_position(kv)
    k8, v8 = kv8[0].contiguous(), kv8[1].contiguous()
    ks, vs = (sc[0] / 8.0).contiguous(), sc[1].contiguous()
    del kv, kv8, sc
    q = torch.randn((B, 1, H, dh), generator=g, device=dev).to(
        torch.bfloat16).transpose(1, 2)  # as decoder_step hands it over
    t = torch.arange(T, device=dev)
    neg = float(np.finfo(np.float32).min)
    # f32 out from the same f32 products summed in another order: ~1e-7
    tols = {"max_rel": 1e-4, "mean_rel": 1e-5}
    worst = 0.0
    same = True
    for v0, pos in ((0, 3), (0, C - 1), (0, C), (0, 116), (0, 200),
                    (100, 150)):
        mask = torch.where((t <= pos) & (t >= v0), 0.0, neg).float()[None]
        got = SA.self_attention_q8_kernel(q, k8, ks, v8, vs, mask)
        again = SA.self_attention_q8_kernel(q, k8, ks, v8, vs, mask)
        want = SA.self_attention_q8_plain(q, k8, ks, v8, vs, mask)
        cut = mask.clone()
        cut[..., pos] = neg
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            fail(f"self-attention kernel output is not finite (pos {pos})")
        same &= torch.equal(got, again)
        errs = {"max_rel": max_rel(got, want), "mean_rel": mean_rel(got, want)}
        lo = pos // C * C
        for name, wrong in (
                ("mask ignored", SA.self_attention_q8_plain(
                    q, k8, ks, v8, vs, torch.zeros_like(mask))),
                ("last written position dropped",
                 SA.self_attention_q8_plain(q, k8, ks, v8, vs, cut)),
                (f"split {lo // C}'s P.V dropped",
                 self_split_dropped(q, k8, ks, v8, vs, mask, lo, lo + C))):
            held(f"self_attn_q8[R {B} x {H} heads, T {T}, valid_start {v0}, "
                 f"pos {pos}, {name}]", errs, tols,
                 {"max_rel": max_rel(wrong, want),
                  "mean_rel": mean_rel(wrong, want)})
        worst = max(worst, float((got - want).abs().max()))
    check("self_attn_q8[two runs bitwise]", same, "every position")
    pos = 116
    mask = torch.where(t <= pos, 0.0, neg).float()[None]
    kern = lambda: SA.self_attention_q8_kernel(q, k8, ks, v8, vs, mask)
    ms, dev_ms = time_ms(kern, 50), device_ms(kern)
    plain_ms = time_ms(lambda: SA.self_attention_q8_plain(
        q, k8, ks, v8, vs, mask), 10)
    # the function reads every cache position (the mask is data)
    nbytes = B * H * T * 2 * (dh + 4) + T * 4 + B * H * dh * (2 + 4)
    b_ms, b_by = bound(nbytes, 4 * B * H * T * dh, PEAK_F32)
    entries.append(dict(
        name="self_attn_q8", route="cuda",
        source="whisper_aries_tpu_torch/csrc/self_attn.cu",
        replaces="whisper_aries_tpu/ops/pallas_self_attn.py:50",
        max_abs_err=worst, tolerance=tols, ms=ms, device_ms=dev_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_note="none: no one PyTorch call attends over int8 K/V "
                     "with per-position scales",
        splits=[S, C],
        shape=f"q ({B}, {H}, 1, {dh}) bf16, K/V ({B}, {H}, {T}, {dh}) int8 "
              f"+ f32 scales, mask ({T},), position {pos}"))


def profile_unfused_step(dev, parts):
    """One unfused decode step as the self_int8 and native slices run it
    (large-v3 at int8 compute under ARIES_QUANT_IMPL=pallas, then =native;
    6 rows over 6 windows' bf16 cross K/V, an int8 self cache of 227
    positions, position 116): decoder_step, whose dense layers run the
    W8A16 GEMM (pallas) or the row quantization and the s8 GEMM (native),
    and whose self-attention runs the int8 self-attention kernel. The step
    replayed from one CUDA graph (UnfusedStepGraph, as the slices run it)
    must give the bits of direct launches; both are timed and profiled
    (device time by kernel, the device's busy share)."""
    import os

    import torch
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops.quant import quantize_model_params

    dims = W.PRESETS["large-v3"]
    full = W.init_params(dims, seed=3, device=dev, dtype=torch.bfloat16)
    params = W.fuse_decoder_qkv(quantize_model_params(
        {"decoder": full["decoder"]}))
    del full
    B, pos = 6, 116
    old_impl = os.environ.get("ARIES_QUANT_IMPL")
    for impl in ("pallas", "native"):
        g = torch.Generator(device=dev).manual_seed(13)
        os.environ["ARIES_QUANT_IMPL"] = impl
        try:
            xa = torch.randn((B, dims.n_audio_ctx, dims.n_text_state),
                             generator=g, device=dev).to(torch.bfloat16)
            cross = W.precompute_cross_kv(params, xa, dims)
            cache = W.init_kv_cache(dims, B, max_len=3 + 224, int8=True,
                                    device=dev)
            tok = torch.randint(0, 50000, (B, 1), generator=g, device=dev)
            direct = lambda: W.decoder_step(params, tok, pos, cache, cross,
                                            dims)
            graph = W.UnfusedStepGraph(params, cache, cross, dims, B)
            replay = lambda: graph.run(tok[:, 0], pos)
            a = replay().clone()
            cache_a = {k: v.clone() for k, v in cache.items()}
            b = direct()[:, 0]
            torch.cuda.synchronize()
            tag = "" if impl == "pallas" else f" ({impl})"
            check(f"unfused step{tag}: graph replay = direct launches",
                  torch.equal(a, b) and all(torch.equal(cache_a[k], cache[k])
                                            for k in cache),
                  f"R {B}, position {pos}: logits and the int8 self cache "
                  "bit for bit")
            ms, direct_ms = time_ms(replay, 20), time_ms(direct, 10)
            label = (f"R {B} ({B} windows), position {pos}, int8 self cache, "
                     "bf16 cross K/V")
            if impl != "pallas":
                label += f", ARIES_QUANT_IMPL={impl}"
            profile_step(label, replay, what="unfused step")
            profile_step(label + ", direct launches", direct,
                         what="unfused step")
            del graph, cross, cache, xa
        finally:
            if old_impl is None:
                os.environ.pop("ARIES_QUANT_IMPL", None)
            else:
                os.environ["ARIES_QUANT_IMPL"] = old_impl
        parts.append(dict(name=f"unfused step R {B}{tag}", ms=ms,
                          direct_ms=direct_ms))
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# conditioned shapes (condition_on_previous_text, prompts, prefix)
# ---------------------------------------------------------------------------

#: the sequential mode's prompt width at large-v3 with timestamps: 224
#: context positions + the sot sequence (3), every prompt left-padded to it
P_COND = 227
#: its self cache: the prompt and 224 sampled tokens
T_COND = P_COND + 224
#: valid_start: no pad, a part-filled context, the pad of a window with no
#: context (224 - the 3 tokens of a short initial prompt and <|startofprev|>)
VS_COND = (0, 100, 224)


def cond_step(dev, parts):
    """Kernel 3 at the conditioned shapes: the int8-self-cache step over a
    T 451 cache (every position filled, so keys before valid_start hold
    stale values the mask must hide) at R 1 (greedy) and R 5 (beam 5 and
    the ladder's best_of 5), one window's cross K/V shared by its rows;
    valid_start 0 / 100 / 224 at the first position past the prompt (227)
    and the last (450). Per (R, valid_start, pos): teacher-forced per
    layer against the plain layers over 8 layers (every 4th), where "keys
    before valid_start scored" must exceed the limits; two runs bitwise
    and a graph replay bitwise against direct launches from 227 on (an
    in-place reorder between at R 5); then one whole step through the
    decode loop's own ``_step_logits`` (embedding, graph replay, vocab
    product) against the plain stack, where "positional embedding not
    offset by valid_start" must exceed the stack's limit. Timed as a
    replay and as direct launches at pos 227 and 450, valid_start 224; the
    device time from a graph captured without PDL."""
    import torch
    from whisper_aries_tpu_torch.decoding import generate as G
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    out = {"shape": f"one step, all 32 layers, int8 self cache T {T_COND}, "
                    "1 window's cross K/V (Ta 1500) shared by R rows"}
    worst = 0.0
    sl = lambda tree, l: {k: v[l:l + 1] for k, v in tree.items()}
    for R in (1, 5):
        dims, params, wpack, cross, cache, g = decode_inputs(
            dev, R, T_COND, True, seed=20 + R, windows=1, T=T_COND)
        H, L, dec = dims.n_text_head, dims.n_text_layer, params["decoder"]
        if cache["kv8"].shape[4] != T_COND:
            fail("conditioned step: the self cache is not 451 long")
        for vs in VS_COND:
            for pos in (P_COND, T_COND - 1):
                ck, cp, cm = clone(cache), clone(cache), clone(cache)
                errs = {"max_rel": 0.0, "mean_rel": 0.0}
                before = {"mean_rel": math.inf}
                for l in range(0, L, 4):
                    xin = (0.25 * torch.randn((R, dims.n_text_state),
                                              generator=g, device=dev)
                           ).to(torch.bfloat16)
                    got = DL.fused_decoder_layers(xin, sl(wpack, l), sl(ck, l),
                                                  sl(cross, l), vs, pos, H)
                    want = DL.fused_decoder_layers_plain(
                        xin, sl(wpack, l), sl(cp, l), sl(cross, l), vs, pos, H)
                    errs["max_rel"] = max(errs["max_rel"], max_rel(got, want))
                    errs["mean_rel"] = max(errs["mean_rel"],
                                           mean_rel(got, want, xin))
                    worst = max(worst, float(
                        (got.float() - want.float()).abs().max()))
                    if vs:
                        wrong = DL.fused_decoder_layers_plain(
                            xin, sl(wpack, l), sl(cm, l), sl(cross, l), 0,
                            pos, H)
                        before["mean_rel"] = min(before["mean_rel"], mean_rel(
                            wrong, want, xin))
                del ck, cp, cm
                tols = {"max_rel": 3e-2, "mean_rel": 1e-2}
                label = (f"conditioned, R {R}, T {T_COND}, valid_start {vs}, "
                         f"pos {pos}")
                held(f"decode_layers[{label}]"
                     + (", keys before valid_start scored" if vs else ""),
                     errs, tols, before if vs else None)
            hold_step_bits(f"conditioned, R {R}, T {T_COND}, valid_start "
                           f"{vs}", dev, wpack, cache, cross, H, R, 1,
                           P_COND, g, vs=vs)
            if not vs:
                continue
            # the whole step as the decode loop runs it
            pos = T_COND - 1 if vs == 224 else P_COND
            cg, cp = clone(cache), clone(cache)
            graph = DL.DecodeStepGraph(wpack, cg, cross, R, H, vs)
            tok = torch.randint(0, dims.n_vocab, (R,), generator=g,
                                device=dev)
            got = G._step_logits(params, dims, tok, pos, cg, cross, True,
                                 wpack, graph, vs)

            def plain(p_idx):
                x = dec["tok_emb"][tok] + dec["pos_emb"][p_idx]
                return W.vocab_logits(dec, DL.fused_decoder_layers_plain(
                    x, wpack, clone(cp), cross, vs, pos, H))

            want = plain(min(pos - vs, dims.n_text_ctx - 1))
            wrong = plain(min(pos, dims.n_text_ctx - 1))
            del graph, cg
            held(f"decode_layers[conditioned step logits, R {R}, valid_start "
                 f"{vs}, pos {pos}] positional embedding not offset by "
                 "valid_start", {"max_rel": max_rel(got, want)},
                 {"max_rel": 0.1}, {"max_rel": max_rel(wrong, want)})
        # timed where the sequential mode runs: valid_start 224
        x = torch.randn((R, dims.n_text_state), generator=g,
                        device=dev).to(torch.bfloat16)
        for pos in (P_COND, T_COND - 1):
            graph = DL.DecodeStepGraph(wpack, cache, cross, R, H, 224)
            key = f"r{R}_pos{pos}"
            out[f"ms_{key}"] = time_ms(lambda: graph.run(x, pos), 20)
            out[f"ms_direct_{key}"] = time_ms(lambda: DL.fused_decoder_layers(
                x, wpack, cache, cross, 224, pos, H), 20)
            out[f"bound_ms_{key}"] = step_bound(dims, R, pos, True, 1,
                                                vs=224)[0]
            # the kernels' own device time: a graph captured without PDL
            # (with it each kernel's time includes waiting for the one
            # before)
            DL.PDL = False
            try:
                graph = DL.DecodeStepGraph(wpack, cache, cross, R, H, 224)
                out[f"device_ms_{key}"] = device_ms(lambda: graph.run(x, pos))
            finally:
                DL.PDL = True
            del graph
        if R == 5:
            out["plain_ms_r5_pos450"] = time_ms(
                lambda: DL.fused_decoder_layers_plain(
                    x, wpack, clone(cache), cross, 224, T_COND - 1, H), 3,
                warmup=1)
            graph = DL.DecodeStepGraph(wpack, cache, cross, R, H, 224)
            profile_step(f"conditioned R 5, T {T_COND}",
                         lambda: graph.run(x, T_COND - 1))
            del graph
        del wpack, cross, cache, params
        torch.cuda.empty_cache()
    out.update(max_abs_err=worst, library_ms=None,
               tolerance={"max_rel": 3e-2, "mean_rel": 1e-2,
                          "stack_logits_max_rel": 0.1})
    return out


def cond_cross(dev):
    """Kernel 6 at the conditioned prefills over 1500 keys: one window x G
    227 (greedy and beam prefill a window's 227 prompt positions) and the
    ladder's 5 rows x 227 = G 1135 over that window, bf16 and f32 q, with
    ``hold_cross``'s mistakes, "the last query chunk dropped" among them;
    timed at each."""
    import torch
    from whisper_aries_tpu_torch.ops import cross_attn as XA

    err, out = 0.0, {}
    for rows in (1, 5):
        G = rows * P_COND
        q, args, _ = cross_case(dev, 1, G, 70 + rows)
        for qdtype in (torch.bfloat16, torch.float32):
            e, tols = hold_cross(f"conditioned prefill, 1 window x {rows} "
                                 f"rows x {P_COND}, q {qdtype}",
                                 q.to(qdtype), args)
            err = max(err, e)
        kern = lambda: XA.cross_attention_q8_kernel(q, *args)
        b_ms, b_by = cross_bound(1, G, 1500)
        out[f"g{G}"] = dict(
            ms=time_ms(kern, 20), device_ms=device_ms(kern),
            plain_ms=time_ms(lambda: XA.cross_attention_q8_reference(
                q, *args), 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=f"q (1, 20, {G}, 64) bf16, K/V (1, 20, 1500, 64) int8")
        del q, args
    out.update(max_abs_err=err, tolerance=tols)
    return out


def cond_self_attn(dev):
    """Kernel 7 at the conditioned shapes: R 1 and R 5 x 20 heads over a
    T 451 cache, valid_start 224, at positions 227 and 450, stale values
    before valid_start; the mistakes "keys before valid_start scored",
    the last written position dropped and the position's split's P . V
    dropped must exceed the limits; two runs bitwise; timed at R 5, pos
    450."""
    import torch
    from whisper_aries_tpu_torch.ops import cross_attn as XA
    from whisper_aries_tpu_torch.ops import cuda_build as cb
    from whisper_aries_tpu_torch.ops import self_attn as SA

    H, T, dh, v0 = 20, T_COND, 64, 224
    neg = float(np.finfo(np.float32).min)
    tols = {"max_rel": 1e-4, "mean_rel": 1e-5}
    worst, same, out = 0.0, True, {}
    t = torch.arange(T, device=dev)
    for B in (1, 5):
        S, C = SA.split_plan(T, B * H, cb.sm_count(dev))
        check(f"self_attn_q8 plan at R {B}, T {T}: C = Python mirror",
              SA.kernel_split_plan(T, B * H, cb.sm_count(dev)) == (S, C),
              f"{S} splits of {C} keys")
        g = torch.Generator(device=dev).manual_seed(30 + B)
        kv = torch.randn((2, B, H, T, dh), generator=g, device=dev).to(
            torch.bfloat16)
        kv8, sc = XA.quantize_kv_per_position(kv)
        k8, v8 = kv8[0].contiguous(), kv8[1].contiguous()
        ks, vs = (sc[0] / 8.0).contiguous(), sc[1].contiguous()
        del kv, kv8, sc
        q = torch.randn((B, 1, H, dh), generator=g, device=dev).to(
            torch.bfloat16).transpose(1, 2)
        for pos in (P_COND, T - 1):
            mask = torch.where((t <= pos) & (t >= v0), 0.0, neg).float()[None]
            got = SA.self_attention_q8_kernel(q, k8, ks, v8, vs, mask)
            again = SA.self_attention_q8_kernel(q, k8, ks, v8, vs, mask)
            want = SA.self_attention_q8_plain(q, k8, ks, v8, vs, mask)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                fail(f"self-attention kernel output is not finite (R {B}, "
                     f"pos {pos})")
            same &= torch.equal(got, again)
            errs = {"max_rel": max_rel(got, want),
                    "mean_rel": mean_rel(got, want)}
            cut = mask.clone()
            cut[..., pos] = neg
            lo = pos // C * C
            for name, wrong in (
                    ("keys before valid_start scored",
                     SA.self_attention_q8_plain(
                         q, k8, ks, v8, vs,
                         torch.where(t <= pos, 0.0, neg).float()[None])),
                    ("last written position dropped",
                     SA.self_attention_q8_plain(q, k8, ks, v8, vs, cut)),
                    (f"split {lo // C}'s P.V dropped",
                     self_split_dropped(q, k8, ks, v8, vs, mask, lo,
                                        lo + C))):
                held(f"self_attn_q8[conditioned, R {B} x {H} heads, T {T}, "
                     f"valid_start {v0}, pos {pos}, {name}]", errs, tols,
                     {"max_rel": max_rel(wrong, want),
                      "mean_rel": mean_rel(wrong, want)})
            worst = max(worst, float((got - want).abs().max()))
        pos = T - 1
        mask = torch.where((t <= pos) & (t >= v0), 0.0, neg).float()[None]
        kern = lambda: SA.self_attention_q8_kernel(q, k8, ks, v8, vs, mask)
        nbytes = B * H * T * 2 * (dh + 4) + T * 4 + B * H * dh * (2 + 4)
        b_ms, b_by = bound(nbytes, 4 * B * H * T * dh, PEAK_F32)
        out[f"r{B}"] = dict(
            ms=time_ms(kern, 50), device_ms=device_ms(kern),
            plain_ms=time_ms(lambda: SA.self_attention_q8_plain(
                q, k8, ks, v8, vs, mask), 10),
            bound_ms=b_ms, bound_by=b_by, library_ms=None, splits=[S, C],
            shape=f"q ({B}, {H}, 1, {dh}), K/V ({B}, {H}, {T}, {dh}) int8, "
                  f"valid_start {v0}, position {pos}")
        del q, k8, v8, ks, vs
    check("self_attn_q8[conditioned, two runs bitwise]", same,
          "every position")
    out.update(max_abs_err=worst, tolerance=tols)
    return out


def cond_reorder(dev):
    """Kernel 8 at R 5 (one window x 5 beams) over the T 451 int8 self
    cache: bit for bit the plain gather on a random map and on every row
    moving; timed (every row moving) beside index_select."""
    import torch
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import beam_reorder as BR

    dims = W.PRESETS["large-v3"]
    B, K, T = 1, 5, T_COND
    L, H = dims.n_text_layer, dims.n_text_head
    g = torch.Generator(device=dev).manual_seed(7)
    cache = {"kv8": torch.randint(-127, 128, (L, B * K, 2, H, T, 64),
                                  generator=g, device=dev, dtype=torch.int8),
             "ksc": torch.rand((L, B * K, 2, H, T), generator=g, device=dev)}
    roll = torch.roll(torch.arange(K, device=dev, dtype=torch.int32),
                      1)[None].contiguous()
    same = True
    for src in (torch.tensor([[1, 1, 0, 4, 2]], device=dev,
                             dtype=torch.int32), roll):
        want = {k: BR.permute_rows_plain(v.clone(), src)
                for k, v in cache.items()}
        got = BR.permute_cache_rows(clone(cache), src)
        torch.cuda.synchronize()
        same &= all(torch.equal(got[k], want[k]) for k in cache)
    check(f"beam_reorder[conditioned, R 5, T {T}]", same,
          "kv8 and ksc identical to the plain gather, two maps")
    work = clone(cache)
    kern = lambda: BR.permute_cache_rows(work, roll)
    flat = roll.long().reshape(-1)
    row_bytes = sum(v[0, 0].numel() * v.element_size()
                    for v in cache.values())
    b_ms, b_by = bound(2 * L * B * K * row_bytes, 0, PEAK_F32)
    return dict(
        max_abs_err=0.0 if same else math.inf, tolerance="bitwise",
        ms=time_ms(kern, 20), device_ms=device_ms(kern),
        plain_ms=time_ms(lambda: {k: BR.permute_rows_plain(v, roll)
                                  for k, v in work.items()}, 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: [torch.index_select(v, 1, flat)
                                    for v in work.values()], 20),
        shape=f"kv8 ({L}, 5, 2, {H}, {T}, 64) int8 + ksc f32, every row "
              "moving")


def conditioned_phase(dev, entries, parts):
    """Kernels 3, 5, 6, 7 and 8 at the shapes conditioned decoding gives
    them (T 451, valid_start up to 224, R 1 and R 5, prefills of 227
    positions a window); each kernel's entry gets a ``conditioned`` part.
    Kernel 5's rows (M 227 and M 1135 at K = N = 1280, on the path
    ``gemm_plan`` gives) are held with its other shapes."""
    by_name = {e["name"]: e for e in entries}
    by_name["decode_layers"]["conditioned"] = cond_step(dev, parts)
    by_name["cross_attn_q8"]["conditioned"] = cond_cross(dev)
    by_name["self_attn_q8"]["conditioned"] = cond_self_attn(dev)
    by_name["beam_reorder"]["conditioned"] = cond_reorder(dev)
    gemm = by_name["quant_matmul"]
    gemm["conditioned"] = {r["what"]: r for r in gemm["shapes"]
                           if r["what"].startswith("conditioned")}
    print("conditioned " + json.dumps(
        {k: by_name[k]["conditioned"] for k in (
            "decode_layers", "cross_attn_q8", "self_attn_q8", "beam_reorder",
            "quant_matmul")}), flush=True)


# ---------------------------------------------------------------------------
# probe phase
# ---------------------------------------------------------------------------

PROBE_MS = 6.0   # device time of one rate line in this run
QA_REPS = 20     # iterations of an attention micro in one probe launch
CUDA_INVALID_VALUE = 1   # cudaErrorInvalidValue


def held_probe(name: str, r: dict) -> None:
    """A probe line's own hold (its kernel against the plain version; a
    copy line's reads of its short run beside its checksum)."""
    from whisper_aries_tpu_torch.scripts.common import held_detail

    reads = "; reads " + held_detail(r["reads"]) if "reads" in r else ""
    check(name, r["ok"], held_detail(r) + reads)


def check_smem_probe(res: dict) -> None:
    """The shared-memory probe's answers: launches up to the opt-in limit
    run (128 a block), above it cudaFuncSetAttribute refuses the size with
    cudaErrorInvalidValue (from one byte above on), and a cluster at the
    limit runs exactly where the card reports room for one."""
    from whisper_aries_tpu_torch.scripts import probe_vmem as PV

    def refused(r):
        return (not r["ok"] and r.get("code") == CUDA_INVALID_VALUE
                and r.get("stage") == "attribute")

    optin = res["limits"]["optin"]
    for kb, r in zip(PV.SIZES_KB, res["sizes"]):
        fits = kb * 1024 <= optin
        ok = r["sums"] == [128.0] if fits else refused(r)
        check(f"probe_vmem[{kb} KB]", r["ok"] == fits and ok,
              f"{'runs' if r['ok'] else r['error']}, opt-in {optin} B")
    at, above = res["edge"]
    check("probe_vmem[refusal starts just above the opt-in limit]",
          at["ok"] and at["sums"] == [128.0] and refused(above),
          f"{optin} B runs, {optin + 1} B: "
          f"{above.get('error', 'ran')}")
    for r in res["clusters"]:
        ran_right = not r["ok"] or set(r["sums"]) == {128.0}
        check(f"probe_vmem[cluster {r['cluster']}]",
              r["ok"] == (r["max_active"] >= 1) and ran_right,
              f"{'runs' if r['ok'] else r['error']}, at most "
              f"{r['max_active']} such clusters at once")


def copy_entry_times(dev, PD, r: dict) -> dict:
    """A copy entry's kernel against torch.sum of the same source in f32
    (one read of it, the same work), taken twice in the order kernel /
    sum / sum / kernel, each the best of 3 runs of 3 calls enqueued back
    to back (the card stays busy, so neither side's host dispatch is
    timed)."""
    import torch
    from whisper_aries_tpu_torch.scripts import common

    src = PD.source(torch.bfloat16, r["chunks"], 256, 8192, dev)
    if r["streams"] > 1:
        kern = lambda: PD.copy_streams_kernel(
            src, r["band"], 8192, r["n_iter"], r["streams"], r["blocks"],
            bands=r["bands"])
    else:
        kern = lambda: PD.copy_ring_kernel(
            src, r["band"], 8192, r["n_iter"], r["slots"], r["blocks"],
            bands=r["bands"])
    lib = lambda: torch.sum(src, dtype=torch.float32)
    k1, s1, s2, k2 = (min(common.mean_ms(f, 3) for _ in range(3))
                      for f in (kern, lib, lib, kern))
    out = dict(ms=min(k1, k2), library_ms=min(s1, s2),
               pairs_ms=dict(kernel=[k1, k2], sum=[s1, s2]))
    del src
    torch.cuda.empty_cache()
    return out


def probe_entries(dev, res: dict, entries) -> None:
    """The kernels-line entries of the six probe kernels. The copy rings
    are timed reading a 1 GiB source once (interleaved with one torch.sum
    reading it once), the one-slot copy at the opt-in limit (beside a sum
    of the same bytes); the products and the transpose take their probe
    lines' own numbers, the products beside one PyTorch product of the
    same operation count, the transpose with the profiler's device time
    of both variants."""
    import torch
    from whisper_aries_tpu_torch.scripts import common
    from whisper_aries_tpu_torch.scripts import probe_dma as PD
    from whisper_aries_tpu_torch.scripts import probe_mxu as PM
    from whisper_aries_tpu_torch.scripts import probe_vmem as PV

    src = PD.source(torch.bfloat16, 1, PD.SOURCE_BYTES // 2, 1, dev)
    dst = torch.empty_like(src)
    copy_ms = common.best_ms(lambda: dst.copy_(src))
    del src, dst
    for name, streams, fn, tpu in (
            ("probe_dma.probe", 1, "probe",
             dict(replaces="scripts/probe_dma.py:38")),
            ("probe_dma.probe_multi", 2, "probe_multi",
             dict(replaces="scripts/probe_dma.py:114"))):
        C = PD.SOURCE_BYTES // (256 * 8192 * 2)
        r = PD.run(f"entry: bf16 4MB {fn}", 256, 8192, torch.bfloat16,
                   n_streams=streams, multi=streams > 1, n_iter=C // streams,
                   chunks=C, device=dev)
        held_probe(f"{name}[entry]", r)
        b_ms, b_by = bound(r["bytes"] + 4 * r["blocks"] * r["streams"], 0,
                           PEAK_BF16)
        t = copy_entry_times(dev, PD, r)
        print(f"{name} entry: kernel {t['pairs_ms']['kernel']} ms, "
              f"torch.sum {t['pairs_ms']['sum']} ms", flush=True)
        entries.append(dict(
            name=name, route="cuda",
            source="whisper_aries_tpu_torch/csrc/probe_copy.cu", **tpu,
            max_abs_err=r["abs_err"], tolerance=r["limit"],
            ms=t["ms"], plain_ms=r["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=t["library_ms"],
            library_note="torch.sum of the 1 GiB source in f32 (reads it "
                         "once); ms and library_ms: the best of 3 runs of 3 "
                         "back-to-back calls, taken twice as kernel / sum / "
                         "sum / kernel (pairs_ms)",
            pairs_ms=t["pairs_ms"], library_copy_ms=copy_ms,
            gbs=r["bytes"] / t["ms"] / 1e6,
            share_of_peak=r["bytes"] / (t["ms"] / 1e3) / PEAK_BYTES,
            inflight_per_sm=r["inflight_per_sm"],
            shape=f"4 MB chunks of a 1 GiB bf16 source, each read once: "
                  f"{r['bands']} bands of {r['copy_bytes']} B a chunk "
                  f"walked by {r['blocks']} blocks of {r['streams']} rings "
                  f"(a warp a ring), {r['slots']} slots"))
    optin = PD.smem_limits(dev)["optin"]
    ones = torch.ones((1, PV.copy_lanes(optin)), dtype=torch.bfloat16,
                      device=dev)
    got = PV.smem_copy_kernel(ones, optin)
    err = float((got - PV.smem_copy_plain(ones)).abs().max())
    check("probe_vmem.try_size[entry]", err == 0.0, f"err {err}")
    nbytes = ones.numel() * 2
    b_ms, b_by = bound(nbytes + 4, 0, PEAK_BF16)
    kern = lambda: PV.smem_copy_kernel(ones, optin)
    lib = lambda: torch.sum(ones, dtype=torch.float32)
    entries.append(dict(
        name="probe_vmem.try_size", route="cuda",
        source="whisper_aries_tpu_torch/csrc/probe_copy.cu",
        replaces="scripts/probe_vmem.py:21",
        max_abs_err=err, tolerance=0.0,
        ms=common.mean_ms(kern, 20), device_ms=device_ms(kern),
        plain_ms=common.mean_ms(lambda: PV.smem_copy_plain(ones), 20),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=common.mean_ms(lib, 20), library_device_ms=device_ms(lib),
        library_note="torch.sum of the same bytes in f32 (device_ms and "
                     "library_device_ms: the profiler's kernel time of "
                     "each; ms and library_ms: one call by events)",
        shape=f"one block, one copy of {nbytes} B into {optin} B of "
              "dynamic shared memory, then the sum of 128 elements"))
    for name, r, tpu in (
            ("probe_mxu.probe", res["mxu"][0],
             dict(replaces="scripts/probe_mxu.py:25")),
            ("probe_int8_mxu.make_kernel", res["int8_mxu"][1],
             dict(replaces="scripts/probe_int8_mxu.py:29"))):
        peak = PEAK_S8 if r["kind"] == "s8" else PEAK_BF16
        b_ms, b_by = bound(0, r["ops"], peak)
        lib = PM.library_at_ops(r["kind"], r["ops"], dev)
        entries.append(dict(
            name=name, route="cuda",
            source="whisper_aries_tpu_torch/csrc/probe_mma.cu", **tpu,
            max_abs_err=r["abs_err"],
            tolerance=r["limit"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, library_ms=lib["ms"],
            library_note=(("torch._int_mm" if r["kind"] == "s8"
                           else "torch.matmul")
                          + " at {} x {} x {}, {}: {:.0f} operations".format(
                              *lib["shape"], lib["layout"], lib["ops"])),
            library_by_layout=lib["by_layout"],
            library_tile_ms=r["library_tile_ms"],
            tflops=r["tflops"], share_of_peak=r["share"],
            library_tflops_8192=r["library_tflops"],
            by_label={x["label"]: dict(ms=x["ms"], tflops=x["tflops"],
                                       share=x["share"])
                      for x in res["mxu" if name == "probe_mxu.probe"
                                   else "int8_mxu"]},
            shape=f"{r['label']}: {r['blocks']} blocks x "
                  f"{PM.TM}x{r['shape'][1]}x{PM.TN}, {r['n_iter']} "
                  f"iterations ({'fold' if r['fold'] else 'loop'})"))
    r = res["transpose"]["batched"]
    from whisper_aries_tpu_torch.scripts import probe_batched_transpose as PT
    elems = PT.Bw * PT.KP * PT.D
    # an element a repetition: one bf16 add (x + i), at the packed bf16
    # rate, and one add of the window sum, which takes bf16 operands and
    # sums in f32 as the tensor cores do, at their bf16 rate
    n = elems * PT.REPS
    b_ms, b_by = bound(elems * 2 + PT.D * PT.KP * 4,
                       n + n * PEAK_BF16X2 / PEAK_BF16, PEAK_BF16X2)
    x = PT.inputs(dev)
    dev_ms = {v: device_ms(lambda: PT.transpose_sum_kernel(x, v))
              for v in PT.VARIANTS}
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms(lambda: one.add_(1.0))  # a one-element kernel
    print("probe_batched_transpose device ms: " + ", ".join(
        f"{v} {t:.5f} ({b_ms / t:.1%} of the bound)"
        for v, t in dev_ms.items()) + f"; a one-element kernel {floor_ms:.5f}",
        flush=True)
    entries.append(dict(
        name="probe_batched_transpose.make", route="cuda",
        source="whisper_aries_tpu_torch/csrc/probe_transpose.cu",
        replaces="scripts/probe_batched_transpose.py:30",
        max_abs_err=r["abs_err"], tolerance="one bf16 step of the window "
        "sum a repetition", ms=r["ms"], device_ms=dev_ms["batched"],
        plain_ms=r["plain_ms"], bound_ms=b_ms, bound_by=b_by,
        library_ms=None, perwin_ms=res["transpose"]["perwin"]["ms"],
        perwin_device_ms=dev_ms["perwin"],
        share_of_bound={v: b_ms / t for v, t in dev_ms.items()},
        launch_floor_device_ms=floor_ms,
        us_per_sweep=r["us_per_sweep"],
        shape=f"x ({PT.Bw * PT.KP}, {PT.D}) bf16, {PT.REPS} repetitions, "
              "batched (perwin_ms and perwin_device_ms beside); ms: events "
              "over back-to-back calls, device_ms: the profiler's"))


QA_PROBES = (
    ("qa_micro", "probe_qa_micro",
     dict(replaces="scripts/probe_qa_micro.py:36")),
    ("qa_opt", "probe_qa_opt", dict(replaces="scripts/probe_qa_opt.py:39")),
    ("qa_bisect", "probe_qa_bisect",
     dict(replaces="scripts/probe_qa_bisect.py:36")))


def held_qa(name: str, r: dict) -> None:
    """An attention-micro variant's checks: its answer and checksum against
    the plain version, every block's bits equal, 2 x reps in 1.8-2.2x."""
    from whisper_aries_tpu_torch.scripts.common import held_detail

    check(f"{name}[answer, checksum]", r["err"] <= r["limit"] and
          r["checksum"]["ok"] and all(m > r["limit"]
                                      for m in r["mistakes"].values()),
          held_detail(r) + "; checksum " + held_detail(r["checksum"]))
    check(f"{name}[blocks]", r["blocks_equal"],
          f"{r['blocks']} blocks {'equal' if r['blocks_equal'] else 'differ'}")
    check(f"{name}[2 x reps]", 1.8 <= r["scaling"] <= 2.2,
          f"{r['ms_2x']:.3f} / {r['ms']:.3f} ms = {r['scaling']:.3f}x")


def qa_entries(dev, res: dict, entries) -> None:
    """The kernels-line entries of the three attention-micro kernels, from
    each probe's first variant (full, base, base), every variant's numbers
    beside, and the two-call yardstick of one iteration's work (a micro on
    each of the blocks) and of one micro."""
    from whisper_aries_tpu_torch.scripts import qa_micro as QA

    ops = QA.inputs(dev, "rmask")
    blocks = res["qa_micro"][0]["blocks"]
    yard = {b: QA.yardstick_ms(dev, ops, b) for b in (1, blocks)}
    for key, module, tpu in QA_PROBES:
        r = res[key][0]
        entries.append(dict(
            name=f"{module}.build", route="cuda",
            source="whisper_aries_tpu_torch/csrc/probe_qa.cu", **tpu,
            max_abs_err=r["abs_err"],
            tolerance=f"{r['limit']} of max |want|", ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            library_note="no one PyTorch call computes the micro; "
                         "yardstick_ms: scaled_dot_product_attention "
                         "(masked, scale 1) + torch.matmul of the "
                         "O-projection, the same work as this launch",
            yardstick_ms=yard[blocks]["ms"] * r["reps"],
            yardstick=yard, us_per_iter=r["us_per_iter"],
            exp_ms=r["exp_ms"], ops=r["ops"], ops_done=r["ops_done"],
            exps=r["exps"], exps_done=r["exps_done"],
            by_variant={x["variant"]: dict(
                us_per_iter=x["us_per_iter"], ms=x["ms"],
                plain_ms=x["plain_ms"], bound_ms=x["bound_ms"],
                exp_ms=x["exp_ms"], ops_done=x["ops_done"],
                exps_done=x["exps_done"], scaling=x["scaling"],
                err=x["err"], checksum_err=x["checksum"]["err"],
                **({"twin": x["twin"]} if "twin" in x else {}),
                **({"rel_vs_base": x["rel_vs_base"]}
                   if "rel_vs_base" in x else {}))
                for x in res[key]},
            shape=f"{r['blocks']} blocks x {r['reps']} iterations of the "
                  f"micro (H 20, dh 64, bq 128, Tp 1536, T 1500, d 1280), "
                  f"variant {r['variant']}"))


def probes_phase(dev, entries) -> dict:
    """The nine probe functions through their modules' main() at a reduced
    target, every launch count set to 0 just before and read just after;
    returns the counts. Then each line's own hold, the shared-memory
    answers, and the probe kernels' entries (timed after the counts are
    read)."""
    import torch
    from whisper_aries_tpu_torch.scripts import probe_batched_transpose as PT
    from whisper_aries_tpu_torch.scripts import probe_dma as PD
    from whisper_aries_tpu_torch.scripts import probe_int8_mxu as PI
    from whisper_aries_tpu_torch.scripts import probe_mxu as PM
    from whisper_aries_tpu_torch.scripts import probe_qa_bisect as PQB
    from whisper_aries_tpu_torch.scripts import probe_qa_micro as PQM
    from whisper_aries_tpu_torch.scripts import probe_qa_opt as PQO
    from whisper_aries_tpu_torch.scripts import probe_vmem as PV

    target = ["--target-ms", str(PROBE_MS)]
    qa = ["--reps", str(QA_REPS)]
    for fn in counters().values():
        fn.launches = 0
    t0 = time.time()
    res = dict(dma=PD.main(target), vmem=PV.main([]), mxu=PM.main(target),
               int8_mxu=PI.main(target), transpose=PT.main([]),
               qa_micro=PQM.main(qa), qa_opt=PQO.main(qa),
               qa_bisect=PQB.main(qa))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    print(f"probes: {time.time() - t0:.1f}s, launches "
          + json.dumps({k: launches[k] for k in PROBE_KERNELS}), flush=True)
    for k in PROBE_KERNELS:
        if not launches[k]:
            FAILED.append(f"the probes did not launch {k}")
    for r in res["dma"]:
        held_probe(f"probe_dma[{r['name']}]", r)
    check_smem_probe(res["vmem"])
    for key in ("mxu", "int8_mxu"):
        for r in res[key]:
            held_probe(f"probe_{key}[{r['label']}]", r)
    for v, r in res["transpose"].items():
        held_probe(f"probe_batched_transpose[{v}]", r)
    for key, module, _ in QA_PROBES:
        for r in res[key]:
            held_qa(f"{module}[{r['variant']}]", r)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "probes.json").write_text(json.dumps(res, indent=2, default=str))
    probe_entries(dev, res, entries)
    qa_entries(dev, res, entries)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------


def counters():
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import beam_reorder as BR
    from whisper_aries_tpu_torch.ops import beam_tail as BT
    from whisper_aries_tpu_torch.ops import cross_attn as XA
    from whisper_aries_tpu_torch.ops import decode_layers as DL
    from whisper_aries_tpu_torch.ops import mel as M
    from whisper_aries_tpu_torch.ops import quant as Q
    from whisper_aries_tpu_torch.ops import self_attn as SA

    return {"mel": M.mel_power_kernel,
            "encoder_attn": W.encoder_attention_kernel,
            "encoder_attn_train": W.encoder_attn_train_fwd_kernel,
            "encoder_attn_train_bwd": W.encoder_attn_train_bwd_kernel,
            "decode_layers": DL.fused_decoder_layers,
            "cross_attn_q8": XA.cross_attention_q8_kernel,
            "beam_tail": BT.beam_tail_kernel,
            "beam_reorder": BR.permute_rows_kernel,
            "quant_matmul": Q.quant_matmul_dequant_kernel,
            "int8_quantize_rows": Q.quantize_rows_kernel,
            "int8_gemm": Q.quant_matmul_int8io_kernel,
            "self_attn_q8": SA.self_attention_q8_kernel,
            # kernel 3's launches and replays at S > 1 (also in
            # decode_layers)
            "decode_layers_verify": DL.VERIFY,
            **probe_counters()}


def probe_counters():
    from whisper_aries_tpu_torch.scripts import probe_batched_transpose as PT
    from whisper_aries_tpu_torch.scripts import probe_dma as PD
    from whisper_aries_tpu_torch.scripts import probe_int8_mxu as PI
    from whisper_aries_tpu_torch.scripts import probe_mxu as PM
    from whisper_aries_tpu_torch.scripts import probe_qa_bisect as PQB
    from whisper_aries_tpu_torch.scripts import probe_qa_micro as PQM
    from whisper_aries_tpu_torch.scripts import probe_qa_opt as PQO
    from whisper_aries_tpu_torch.scripts import probe_vmem as PV

    return {"probe_dma.probe": PD.copy_ring_kernel,
            "probe_dma.probe_multi": PD.copy_streams_kernel,
            "probe_vmem.try_size": PV.smem_copy_kernel,
            "probe_mxu.probe": PM.mma_loop_kernel,
            "probe_int8_mxu.make_kernel": PI.mma_fold_kernel,
            "probe_batched_transpose.make": PT.transpose_sum_kernel,
            "probe_qa_micro.build": PQM.micro_kernel,
            "probe_qa_opt.build": PQO.opt_kernel,
            "probe_qa_bisect.build": PQB.bisect_kernel}


# the kernels each slice's path must launch, in the order the slices run
PATH_KERNELS = {
    "greedy": ("mel", "encoder_attn", "decode_layers", "cross_attn_q8"),
    "beam": ("mel", "encoder_attn", "decode_layers", "cross_attn_q8",
             "beam_tail", "beam_reorder"),
    "words": ("mel", "encoder_attn", "quant_matmul", "decode_layers",
              "cross_attn_q8", "beam_tail", "beam_reorder"),
    "self_int8": ("mel", "encoder_attn", "quant_matmul", "self_attn_q8"),
    # self_int8 under ARIES_QUANT_IMPL=native: every dense product through
    # the row quantization and the s8 GEMM, none through kernel 5
    "native": ("mel", "encoder_attn", "int8_quantize_rows", "int8_gemm",
               "self_attn_q8"),
    "checkpoint": ("mel", "encoder_attn", "quant_matmul", "decode_layers",
                   "cross_attn_q8", "beam_tail", "beam_reorder"),
    "pipeline": ("mel", "encoder_attn", "decode_layers", "cross_attn_q8",
                 "beam_tail", "beam_reorder"),
    "serve": ("mel", "encoder_attn", "decode_layers", "cross_attn_q8",
              "beam_tail", "beam_reorder"),
    # the transcribe tool's run (beam 5, words) of the cli phase
    "cli": ("mel", "encoder_attn", "decode_layers", "cross_attn_q8",
            "beam_tail", "beam_reorder"),
    # three large-v3 f32 train steps, the train state, the diarizer's
    # trainers (mel on their batches)
    "train": ("mel", "encoder_attn_train", "encoder_attn_train_bwd"),
    # the beam engine at 2 windows a batch, depth 2 then depth 1
    "depth": ("mel", "encoder_attn", "decode_layers", "cross_attn_q8",
              "beam_tail", "beam_reorder"),
    # the parity harness's mock job through run_pipeline (beam 5)
    "tools": ("mel", "encoder_attn", "decode_layers", "cross_attn_q8",
              "beam_tail", "beam_reorder"),
    # bench_speculative.main(): the verify step's replays (kernel 3 at
    # S 4), the one-token step's
    "speculative": ("decode_layers_verify", "decode_layers"),
}
# the probe phase's path: every probe kernel, through the probes' entries
PROBE_KERNELS = ("probe_dma.probe", "probe_dma.probe_multi",
                 "probe_vmem.try_size", "probe_mxu.probe",
                 "probe_int8_mxu.make_kernel", "probe_batched_transpose.make",
                 "probe_qa_micro.build", "probe_qa_opt.build",
                 "probe_qa_bisect.build")
# each slice's config overrides; words and self_int8 run compute int8
# under ARIES_QUANT_IMPL=pallas, native under ARIES_QUANT_IMPL=native
SLICE_CONFIG = {
    "greedy": {},
    "beam": {"decode.beam_size": 5},
    "words": {"decode.beam_size": 5},
    "self_int8": {"decode.kv_cache_dtype": "bf16",
                  "decode.self_kv_cache_dtype": "int8"},
}
SLICE_CONFIG["native"] = SLICE_CONFIG["self_int8"]
#: each int8 slice's ARIES_QUANT_IMPL
SLICE_IMPL = {"words": "pallas", "self_int8": "pallas", "native": "native"}
# the words slice's alignment heads: 10 (layer, head) pairs in the top
# half of large-v3's 32 decoder layers (the size of a checkpoint's list)
ALIGNMENT_HEADS = [(16, 3), (18, 11), (19, 0), (21, 7), (23, 14), (25, 5),
                   (27, 19), (28, 2), (30, 9), (31, 16)]


def word_tokenizer():
    """The engine's stand-in tokenizer with every token decoding to its
    own space-led word, so the word pass forms one word per token."""
    from whisper_aries_tpu_torch.pipeline.engine import DummyTokenizer

    class WordTokenizer(DummyTokenizer):
        def decode(self, ids, skip_special=True):
            return "".join(f" <{int(i)}>" for i in ids)

    return WordTokenizer(51866)


def word_pass_split(words: dict, costs: list) -> dict:
    """The word pass's seconds with its host part split into DTW, token
    times (softmax, normalisation, median filter, first frames) and the
    rest (words, punctuation, segments); and the C++ DTW held against its
    plain version, ``_dtw_path_py``, on every cost matrix the pass gave it
    (the same path, index for index), with both timed on the host."""
    from whisper_aries_tpu_torch.align import word_align as WA

    if len(costs) != words["windows"]:
        fail(f"words: {len(costs)} DTW calls for {words['windows']} windows")
    cpp_s = plain_s = 0.0
    same = True
    for cost in costs:
        t0 = time.perf_counter()
        got = WA.dtw_path(cost)
        t1 = time.perf_counter()
        want = WA._dtw_path_py(cost)
        t2 = time.perf_counter()
        cpp_s, plain_s = cpp_s + t1 - t0, plain_s + t2 - t1
        same = same and all(np.array_equal(g, w) for g, w in zip(got, want))
    shapes = sorted({tuple(c.shape) for c in costs})
    check("C++ DTW on the words slice's cost matrices = _dtw_path_py",
          same, f"{len(costs)} matrices of {shapes}, identical paths")
    split = dict(words, host_rest_s=words["host_s"] - words["dtw_s"]
                 - words["token_times_s"])
    split["dtw_check"] = dict(matrices=len(costs), shapes=shapes,
                              cpp_s=cpp_s, plain_s=plain_s)
    return split


def slice_phase(dev, path: str, keep: bool = False):
    """transcribe_file on the synthetic WAV at large-v3 width, seeded
    random weights: "greedy" (config defaults), "beam" (decode.beam_size
    5), "words" (compute int8, beam 5, word timestamps with 10 alignment
    heads), "self_int8" (compute int8, bf16 cross K/V with an int8 self
    cache: unfused steps, greedy at temperature 0) or "native" (self_int8
    under ARIES_QUANT_IMPL=native: the s8 GEMM, never kernel 5). The int8
    slices run under their SLICE_IMPL, restored after. Launch counts are
    set to 0 just before and read just after. Returns the launches, the
    GEMM's launches by path and, with ``keep``, the engine (else None)."""
    import os

    import torch
    from whisper_aries_tpu_torch.audio.decode import write_wav
    from whisper_aries_tpu_torch.config import load_config
    from whisper_aries_tpu_torch.ops import quant as Q
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    OUT.mkdir(parents=True, exist_ok=True)
    wav = OUT / "synthetic_2min.wav"
    if not wav.exists():
        write_wav(str(wav), synth_audio(125.0, seed=7))
    out_dir = OUT / path
    int8 = path in SLICE_IMPL
    t0 = time.time()
    eng = AriesTranscriber(  # seed 0
        "large-v3", allow_random=True, compute_type="int8" if int8 else "bf16",
        config=load_config(overrides=SLICE_CONFIG[path]),
        _tokenizer=word_tokenizer() if path == "words" else None)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    if path in ("self_int8", "native"):
        if eng.fused or eng.kv_int8 or not eng.self_kv_int8:
            fail(f"{path}: the engine did not resolve to unfused steps "
                 "with an int8 self cache")
    elif not (eng.fused and eng.kv_int8 and eng.self_kv_int8):
        fail("the engine did not resolve 'auto' to the card's path")
    call = dict(output_formats=("txt", "json", "srt"), output_dir=str(out_dir))
    if path == "words":
        eng.alignment_heads = list(ALIGNMENT_HEADS)
        print(f"words: alignment heads {ALIGNMENT_HEADS}", flush=True)
        call["word_timestamps"] = True
    if path in ("self_int8", "native"):
        call["temperature"] = (0.0,)
    old_impl = os.environ.get("ARIES_QUANT_IMPL")
    if int8:
        os.environ["ARIES_QUANT_IMPL"] = SLICE_IMPL[path]
    # every W8A16 GEMM call's (M, N, K, path) as the plan gave it, and
    # every native GEMM call's (M, N, K); the plans themselves unchanged
    plan, planned = Q.gemm_plan, []
    plan8, planned8 = Q.int8_gemm_plan, []

    def recording_plan(M, N, K, sms):
        out = plan(M, N, K, sms)
        planned.append((M, N, K, out[0]))
        return out

    def recording_plan8(M, N, K):
        planned8.append((M, N, K))
        return plan8(M, N, K)

    Q.gemm_plan = recording_plan
    Q.int8_gemm_plan = recording_plan8
    from whisper_aries_tpu_torch.align import word_align as WA
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    # the words slice's DTW cost matrices, as the word pass hands them over
    dtw, costs = WA.dtw_path, []

    def recording_dtw(cost):
        costs.append(cost)
        return dtw(cost)

    WA.dtw_path = recording_dtw
    try:
        for fn in counters().values():
            fn.launches = 0
        DL.fused_decoder_layers.graph_replays = 0
        W.decoder_step.graph_replays = 0
        gemm = Q.quant_matmul_dequant_kernel
        gemm.launches_by_path = dict.fromkeys(Q.GEMM_PATHS, 0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = eng.transcribe_file(str(wav), **call)
        torch.cuda.synchronize()
        wall = time.time() - t0
        stats = eng.last_stats  # the port's counters of this call
        launches = {k: fn.launches for k, fn in counters().items()}
        # the fused step's replays, or the unfused decoder_step's
        graph_replays = (DL.fused_decoder_layers.graph_replays if eng.fused
                         else W.decoder_step.graph_replays)
        gemm_paths = dict(gemm.launches_by_path)
    finally:
        Q.gemm_plan = plan
        Q.int8_gemm_plan = plan8
        WA.dtw_path = dtw
        if old_impl is None:
            os.environ.pop("ARIES_QUANT_IMPL", None)
        else:
            os.environ["ARIES_QUANT_IMPL"] = old_impl
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decodes = stats.get("decodes", [])
    if res["num_windows"] < 1 or not decodes:
        fail(f"{path}: no window was decoded")
    for k in PATH_KERNELS[path]:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the {path} path")
    if path == "native" and launches["quant_matmul"]:
        fail(f"native: the W8A16 GEMM launched {launches['quant_matmul']} "
             "times under ARIES_QUANT_IMPL=native")
    if sum(gemm_paths.values()) != launches["quant_matmul"]:
        fail(f"{path}: W8A16 GEMM launches by path {gemm_paths} do not add "
             f"up to {launches['quant_matmul']}")
    # the encoder's and cross K/V's products: M = windows x 1500
    windowed = [c for c in planned if c[0] % 1500 == 0]
    by_m = dict(Counter(f"M {c[0]} {c[3]}" for c in windowed))
    # the other products (prefills, alignment_forward, eager steps) by M
    by_rows = dict(Counter(f"M {c[0]} {c[3]}" for c in planned
                           if c[0] % 1500))
    if path == "words":
        if not windowed or any(c[3] != "wgmma" for c in windowed):
            fail(f"words: not every encoder / cross K/V product took the "
                 f"wgmma path: {by_m}")
        if not any(c[0] == 9000 for c in windowed):
            fail(f"words: no encoder product at M 9000 (6 windows): {by_m}")
    # the word pass widens a segment to its words, which may end one
    # 20 ms frame past the window (and so the file)
    end_limit = res["duration"] + (0.02 if path == "words" else 1e-6)
    for s in res["segments"]:
        if not (math.isfinite(s["avg_logprob"])
                and math.isfinite(s["no_speech_prob"])
                and 0.0 <= s["start"] < s["end"] <= end_limit):
            fail(f"{path}: malformed segment {s}")
    if path == "words":
        n_words = 0
        for s in res["segments"]:
            if not s.get("words"):
                fail(f"words: a segment without words: {s}")
            for w in s["words"]:
                n_words += 1
                if not (math.isfinite(w["start"]) and math.isfinite(w["end"])
                        and math.isfinite(w["probability"])
                        and 0.0 <= w["start"] < w["end"] <= end_limit):
                    fail(f"words: malformed word {w} in segment {s['text']}")
    for fmt, p in res["output_files"].items():
        if not Path(p).exists():
            fail(f"{path}: {fmt} output missing")
    main_pass = [d for d in decodes if d["temperature"] == 0.0]
    if path in ("beam", "words") and not all(d["beam_size"] == 5
                                             for d in main_pass):
        fail(f"the {path} slice did not decode by beam search")
    steps = sum(d["steps"] for d in decodes)
    # every decode call takes its first token from the prefill's logits,
    # then one layer step per token, each a replay of the decode call's
    # graph (the fused layers', or the unfused decoder_step's)
    layer_steps = steps - len(decodes)
    if graph_replays != layer_steps or (
            eng.fused and graph_replays != launches["decode_layers"]):
        fail(f"{path}: {graph_replays} graph replays, "
             f"{launches['decode_layers']} decoder-layer launches, "
             f"{layer_steps} layer steps: not every step was a replay")
    rows_steps = sum(d["steps"] * d["rows"] for d in decodes)
    dec_s = sum(d["seconds"] for d in decodes)
    summary = dict(
        audio_s=res["duration"], windows=res["num_windows"],
        segments=len(res["segments"]), wall_s=wall, setup_s=setup_s,
        decode_calls=len(decodes), decode_steps=steps,
        rows_per_step=rows_steps / max(1, steps),
        decode_s=dec_s, ms_per_step=1e3 * dec_s / max(1, steps),
        main_pass=[{k: d[k] for k in ("rows", "windows", "steps", "seconds")
                    + (("permuted",) if "permuted" in d else ())}
                   for d in main_pass],
        permuting_steps=sum(d.get("permuted", 0) for d in decodes),
        launches=launches, graph_replays=graph_replays,
        layer_steps=layer_steps, gemm_paths=gemm_paths, gemm_windowed=by_m,
        gemm_rows=by_rows,
        native_gemm_shapes=dict(Counter(f"M {m} N {n} K {k}"
                                 for m, n, k in planned8)),
        peak_mem_gb=peak_gb, performance=res["performance"],
        language=res["language"], real_time_factor=res["real_time_factor"])
    if path == "words":
        summary["word_pass"] = word_pass_split(stats["words"], costs)
        summary["words"] = n_words
    tag = {"greedy": "slice", "beam": "slice_beam"}.get(path, f"slice_{path}")
    print(f"{tag} " + json.dumps(summary), flush=True)
    (OUT / f"{tag}.json").write_text(json.dumps(
        dict(summary, decodes=decodes), indent=2))
    if keep:
        return launches, gemm_paths, eng
    del eng
    torch.cuda.empty_cache()
    return launches, gemm_paths, None


# ---------------------------------------------------------------------------
# checkpoint path
# ---------------------------------------------------------------------------

#: openai/whisper-large-v3's config.json fields (its published widths,
#: depth, vocabulary and special ids)
LARGE_V3_CONFIG = {
    "architectures": ["WhisperForConditionalGeneration"],
    "model_type": "whisper", "torch_dtype": "float16",
    "vocab_size": 51866, "num_mel_bins": 128, "d_model": 1280,
    "encoder_layers": 32, "encoder_attention_heads": 20,
    "encoder_ffn_dim": 5120, "decoder_layers": 32,
    "decoder_attention_heads": 20, "decoder_ffn_dim": 5120,
    "max_source_positions": 1500, "max_target_positions": 448,
    "activation_function": "gelu", "scale_embedding": False,
    "pad_token_id": 50256, "bos_token_id": 50257, "eos_token_id": 50257,
    "decoder_start_token_id": 50258, "begin_suppress_tokens": [220, 50257],
    "use_cache": True,
}


class RssPeak:
    """The peak resident set size of this process over a stage, in GB,
    sampled every 5 ms by a thread from /proc/self/statm (the kernel's own
    peak, VmHWM, cannot be reset on the card's machine)."""

    def __init__(self):
        import os
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.gb = self.read()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def read(self) -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page / 1e9

    def _poll(self):
        while not self._stop.wait(0.005):
            self.gb = max(self.gb, self.read())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.gb = max(self.gb, self.read())


def write_checkpoint(dev, d: Path):
    """A large-v3 HF checkpoint directory at its published widths and
    depth: seeded random weights (biases and LayerNorms perturbed so that
    each key's load matters) written as f16 model.safetensors under HF's
    key names by the port's writer; config.json with large-v3's fields;
    generation_config.json with ALIGNMENT_HEADS; and a synthesised
    vocab.json / merges.txt in the v3 layout (the 256 byte symbols, then
    space-led words to 50,257 entries, <|endoftext|> at 50,257). Returns
    the written tree (on the card)."""
    import torch
    from whisper_aries_tpu_torch.decoding.tokenizer import _bytes_to_unicode
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.utils.params_io import write_safetensors

    dims = W.PRESETS["large-v3"]
    d.mkdir(parents=True, exist_ok=True)
    params = W.init_params(dims, seed=12, device=dev, dtype=torch.float16)
    g = torch.Generator(device=dev).manual_seed(13)
    sd = W.hf_state_dict(params, dims)
    for key, t in sd.items():
        if key.endswith(".bias"):
            t.add_(0.02 * torch.randn(t.shape, generator=g, device=dev)
                   .to(t.dtype))
        elif "layer_norm" in key:
            t.add_(0.1 * torch.randn(t.shape, generator=g, device=dev)
                   .to(t.dtype))
    write_safetensors(d / "model.safetensors", sd, metadata={"format": "pt"})
    (d / "config.json").write_text(json.dumps(LARGE_V3_CONFIG, indent=2))
    (d / "generation_config.json").write_text(json.dumps(
        {"alignment_heads": [list(h) for h in ALIGNMENT_HEADS],
         "is_multilingual": True}))
    b2u = _bytes_to_unicode()
    vocab = [b2u[i] for i in range(256)]
    vocab += [f"Ġw{i}" for i in range(50257 - len(vocab))]
    vocab.append("<|endoftext|>")
    (d / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(vocab)}, ensure_ascii=False),
        encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n", encoding="utf-8")
    return params


def burst_audio(seed: int) -> np.ndarray:
    """Ten speech-like bursts (synth_audio's voice, ungated) of 4.5-11 s
    and one of 22 s, 5 s of near-silence apart: the VAD plans a window a
    burst, all of them <= 16 s but the 22 s one."""
    sr = 16_000
    rng = np.random.default_rng(seed)
    lens = [6.0, 9.0, 4.5, 11.0, 7.0, 22.0, 5.0, 8.0, 10.0, 6.5]
    gap = 5.0
    n = int((sum(lens) + gap * (len(lens) + 1)) * sr)
    x = 0.001 * rng.standard_normal(n)
    pos = gap
    for i, length in enumerate(lens):
        t = np.arange(int(length * sr)) / sr
        f0 = 120 + 15 * i + 40 * np.sin(2 * np.pi * 0.3 * t)
        voiced = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / sr) / k
                     for k in range(1, 6))
        env = 0.5 * (1 + np.sin(2 * np.pi * 3.1 * t)) ** 2
        a = int(pos * sr)
        x[a:a + len(t)] += 0.2 * voiced * env + 0.01 * rng.standard_normal(
            len(t))
        pos += length + gap
    return x.astype(np.float32)


def checkpoint_phase(dev):
    """The port's main path from a checkpoint directory: write a large-v3
    checkpoint (seeded random weights), build AriesTranscriber(model_size=
    <dir>) on the card at compute int8 under ARIES_QUANT_IMPL=pallas with
    audio_ctx="bucket" (the smoke test runs in the constructor), then (1)
    one transcribe_file at beam 5 with multilingual=True and word
    timestamps on a file of speech bursts (most windows <= 16 s, one
    longer): both encoder contexts in the main pass, the word pass on the
    checkpoint's 10 heads, every segment with a language and its words;
    (2) one greedy temperature-0 call on the 125 s WAV with chunk_size 60,
    overlap merge, suppress_tokens [-1], no_repeat_ngram_size 3,
    repetition_penalty 1.1, max_initial_timestamp 0.5 and a
    progress_callback. Launch counts are set to 0 just before (1) and read
    just after (2). Prints the write, load and smoke-test seconds and the
    host RSS at the start and peak of the write and of the constructor;
    returns the launches, the GEMM's launches by path and the directory,
    which the cli path uses and deletes."""
    import os
    import shutil

    import torch
    from whisper_aries_tpu_torch.audio.decode import write_wav
    from whisper_aries_tpu_torch.decoding.tokenizer import LANGUAGES
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import decode_layers as DL
    from whisper_aries_tpu_torch.ops import quant as Q
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    OUT.mkdir(parents=True, exist_ok=True)
    ckpt = OUT / "checkpoint_large_v3"
    if ckpt.exists():
        shutil.rmtree(ckpt)
    figures = {}
    with RssPeak() as rss:
        t0 = time.time()
        written = write_checkpoint(dev, ckpt)
        torch.cuda.synchronize()
        figures["write_s"] = time.time() - t0
    figures["write_rss_gb"] = {"start": rss.start, "peak": rss.gb}
    figures["checkpoint_gb"] = (ckpt / "model.safetensors").stat().st_size / 1e9

    old_impl = os.environ.get("ARIES_QUANT_IMPL")
    os.environ["ARIES_QUANT_IMPL"] = "pallas"
    smoke = AriesTranscriber.smoke_test
    smoke_s = []

    def timed_smoke(self):
        t = time.time()
        smoke(self)
        torch.cuda.synchronize()
        smoke_s.append(time.time() - t)

    try:
        AriesTranscriber.smoke_test = timed_smoke
        with RssPeak() as rss:
            t0 = time.time()
            # 8 windows a batch: the bucket encodes at T 800 only a batch
            # made of short windows alone, and a batch sized from the
            # card's memory holds every window of this file
            eng = AriesTranscriber(model_size=str(ckpt),
                                   compute_type="int8", audio_ctx="bucket",
                                   windows_per_device=8)
            torch.cuda.synchronize()
            figures["construct_s"] = time.time() - t0
        figures["construct_rss_gb"] = {"start": rss.start, "peak": rss.gb}
        AriesTranscriber.smoke_test = smoke
        if len(smoke_s) != 1:
            fail("checkpoint: the constructor did not run the smoke test")
        figures["smoke_s"] = smoke_s[0]
        figures["load_s"] = figures["construct_s"] - smoke_s[0]
        if eng.model_dir != str(ckpt):
            fail(f"checkpoint: engine loaded {eng.model_dir}, not {ckpt}")
        if eng.alignment_heads != [tuple(h) for h in ALIGNMENT_HEADS]:
            fail(f"checkpoint: alignment heads {eng.alignment_heads}")
        sp = eng.tokenizer.specials
        if (sp.n_vocab, sp.eot, sp.sot, sp.num_languages,
                sp.timestamp_begin) != (51866, 50257, 50258, 100, 50365):
            fail(f"checkpoint: tokenizer layout {sp}")
        if not (eng.fused and eng.kv_int8 and eng.audio_ctx_bucket):
            fail("checkpoint: the engine did not resolve to the card's path")
        # two leaves the engine keeps as loaded (not quantized): the
        # written f16 values cast to bf16 on the card
        for path in (("encoder", "conv1", "w"), ("decoder", "tok_emb")):
            a, b = written, eng.params
            for p in path:
                a, b = a[p], b[p]
            if not torch.equal(a.to(b.dtype), b):
                fail(f"checkpoint: {'.'.join(path)} differs from the "
                     "written tensor")
        del written
        torch.cuda.empty_cache()

        wav = OUT / "bursts.wav"
        write_wav(str(wav), burst_audio(21))
        wav_125 = OUT / "synthetic_2min.wav"
        if not wav_125.exists():
            write_wav(str(wav_125), synth_audio(125.0, seed=7))
        # every W8A16 GEMM call's (M, path) as the plan gave it
        plan, planned = Q.gemm_plan, []

        def recording_plan(M, N, K, sms):
            out = plan(M, N, K, sms)
            planned.append((M, out[0]))
            return out

        Q.gemm_plan = recording_plan
        for fn in counters().values():
            fn.launches = 0
        DL.fused_decoder_layers.graph_replays = 0
        gemm = Q.quant_matmul_dequant_kernel
        gemm.launches_by_path = dict.fromkeys(Q.GEMM_PATHS, 0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = eng.transcribe_file(
            str(wav), beam_size=5, multilingual=True, word_timestamps=True,
            output_formats=("txt", "json", "srt"),
            output_dir=str(OUT / "checkpoint"))
        torch.cuda.synchronize()
        wall = time.time() - t0
        stats = eng.last_stats  # the port's counters of call (1)
        progress = []
        t0 = time.time()
        opt = eng.transcribe_file(
            str(wav_125), beam_size=1, temperature=(0.0,), chunk_size=60,
            overlap_strategy="merge", suppress_tokens=[-1],
            no_repeat_ngram_size=3, repetition_penalty=1.1,
            max_initial_timestamp=0.5,
            progress_callback=lambda done, total: progress.append(
                (done, total)),
            output_formats=("txt",), output_dir=str(OUT / "checkpoint"))
        torch.cuda.synchronize()
        opt_wall = time.time() - t0
        launches = {k: fn.launches for k, fn in counters().items()}
        gemm_paths = dict(gemm.launches_by_path)
    finally:
        AriesTranscriber.smoke_test = smoke
        Q.gemm_plan = plan
        if old_impl is None:
            os.environ.pop("ARIES_QUANT_IMPL", None)
        else:
            os.environ["ARIES_QUANT_IMPL"] = old_impl
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for k in PATH_KERNELS["checkpoint"]:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the checkpoint path")
    # (1): both contexts in the main pass, ten heads, languages, words
    decodes = stats["decodes"]
    main_pass = [d for d in decodes if d["temperature"] == 0.0]
    contexts = sorted({d["audio_ctx"] for d in main_pass})
    if contexts != [800, 1500]:
        fail(f"checkpoint: main-pass contexts {contexts}, not [800, 1500]")
    if not all(d["beam_size"] == 5 for d in main_pass):
        fail("checkpoint: the main pass did not decode by beam search")
    words = stats.get("words", {})
    if words.get("heads") != len(ALIGNMENT_HEADS):
        fail(f"checkpoint: the word pass read {words.get('heads')} heads, "
             f"not the checkpoint's {len(ALIGNMENT_HEADS)}")
    end_limit = res["duration"] + 0.02
    n_words = 0
    if not res["segments"]:
        fail("checkpoint: no segment")
    for s in res["segments"]:
        if s.get("language") not in LANGUAGES:
            fail(f"checkpoint: a segment without a language: {s}")
        if not (math.isfinite(s["avg_logprob"])
                and 0.0 <= s["start"] < s["end"] <= end_limit):
            fail(f"checkpoint: malformed segment {s}")
        if s["text"].strip() and not s.get("words"):
            fail(f"checkpoint: a segment with text but no words: {s}")
        for w in s.get("words", []):
            n_words += 1
            if not (math.isfinite(w["start"]) and math.isfinite(w["end"])
                    and math.isfinite(w["probability"])
                    and 0.0 <= w["start"] < w["end"] <= end_limit):
                fail(f"checkpoint: malformed word {w}")
    # (2): finite, ordered segments; the callback reached the total
    ostarts = [s["start"] for s in opt["segments"]]
    if not opt["segments"] or ostarts != sorted(ostarts) or not all(
            math.isfinite(s["avg_logprob"])
            and 0.0 <= s["start"] < s["end"] <= opt["duration"] + 1e-6
            for s in opt["segments"]):
        fail("checkpoint: the options call's segments are not finite and "
             "ordered")
    if not progress or progress[-1] != (opt["num_windows"],
                                        opt["num_windows"]):
        fail(f"checkpoint: progress_callback ended at {progress[-1:]}, "
             f"not at {opt['num_windows']} windows")
    # the share of the path at the bucket's shapes, from the engine's
    # records: windows encoded at T 800 (mel and 32 encoder-attention
    # launches a batch), decode calls over Ta 800 (32 prefill
    # cross-attention launches each, a step replay a token after the
    # first), and the W8A16 GEMM calls at M = windows x 800
    at800 = [d for d in decodes if d["audio_ctx"] == 800]
    bucket = dict(
        encoded_windows=stats["encodes"].get(800, 0),
        decode_calls=len(at800),
        step_replays=sum(d["steps"] - 1 for d in at800),
        gemm_by_m=dict(Counter(f"M {m} {p}" for m, p in planned
                               if m % 800 == 0 and m % 1500)))
    summary = dict(
        figures, bucket=bucket, audio_s=res["duration"], windows=res["num_windows"],
        segments=len(res["segments"]), words=n_words, wall_s=wall,
        real_time_factor=res["real_time_factor"], language=res["language"],
        languages=dict(Counter(s["language"] for s in res["segments"])),
        encodes=stats["encodes"],
        main_pass=[{k: d[k] for k in ("rows", "windows", "audio_ctx",
                                      "steps", "seconds")}
                   for d in main_pass],
        word_pass=words, diagnostics=res["diagnostics"],
        options_call=dict(audio_s=opt["duration"],
                          windows=opt["num_windows"],
                          segments=len(opt["segments"]), wall_s=opt_wall,
                          progress_calls=len(progress),
                          diagnostics=opt["diagnostics"]),
        launches=launches, gemm_paths=gemm_paths, peak_mem_gb=peak_gb)
    print("checkpoint " + json.dumps(summary), flush=True)
    (OUT / "checkpoint.json").write_text(json.dumps(
        dict(summary, decodes=decodes), indent=2))
    del eng
    torch.cuda.empty_cache()
    return launches, gemm_paths, ckpt


# ---------------------------------------------------------------------------
# pipeline path
# ---------------------------------------------------------------------------

#: the two voices of the conversation: (f0 Hz, formant Hz, noise seed)
VOICES = ((110, 500, 1), (280, 2400, 2))
#: an environment variable no machine sets: the meeting analysis finds no
#: API key and never reaches the network
NO_KEY = "ARIES_SMOKE_NO_LLM_KEY"


def synth_speaker(f0, formant, spans, total_s, seed):
    """tests/test_diarize.py's voice: a harmonic stack at f0 with a formant
    emphasis and a 3.1 Hz envelope over ``spans``, in noise of 0.002."""
    sr = 16_000
    rng = np.random.default_rng(seed)
    n = int(total_s * sr)
    t = np.arange(n) / sr
    x = 0.002 * rng.standard_normal(n).astype(np.float32)
    for s, e in spans:
        m = (t >= s) & (t < e)
        tm = t[m]
        v = sum((1.0 / (1 + abs(k * f0 - formant) / 300.0))
                * np.sin(2 * np.pi * k * f0 * tm + k) for k in range(1, 12))
        env = 0.55 + 0.45 * np.sin(2 * np.pi * 3.1 * tm + seed)
        x[m] += (0.25 * v / 3.0 * env).astype(np.float32)
    return x


def conversation_audio(seed: int = 1, seconds: float = 60.0):
    """A two-speaker conversation of about ``seconds``: the two VOICES take
    turns of 3-8 s, 0.3-1.0 s apart, from 0.5 s on; the file ends 0.5 s
    after the last turn (as tests/test_diarize.py's scene). Returns (audio,
    the truth turns)."""
    rng = np.random.default_rng(seed)
    turns, t, who = [], 0.5, 0
    while True:
        d = float(rng.uniform(3.0, 8.0))
        if t + d > seconds - 0.5:
            break
        turns.append({"start": round(t, 3), "end": round(t + d, 3),
                      "speaker": f"VOICE_{who}"})
        t += d + float(rng.uniform(0.3, 1.0))
        who ^= 1
    total = turns[-1]["end"] + 0.5
    x = sum(synth_speaker(f0, formant, [(u["start"], u["end"]) for u in turns
                                        if u["speaker"] == f"VOICE_{i}"],
                          total, vseed)
            for i, (f0, formant, vseed) in enumerate(VOICES))
    return x.astype(np.float32), turns


def check_outputs(tag: str, res: dict) -> None:
    """The html, json and srt files exist and parse; the analysis failed
    for want of a key (non-fatal) and the run succeeded."""
    import re

    if not res["success"]:
        fail(f"pipeline {tag}: run_pipeline failed: {res['error']}")
    if NO_KEY not in (res.get("llm_analysis_error") or ""):
        fail(f"pipeline {tag}: llm_analysis_error "
             f"{res.get('llm_analysis_error')!r} does not name {NO_KEY}")
    out = res["outputs"]
    if set(out) != {"html", "json", "srt"}:
        fail(f"pipeline {tag}: outputs {sorted(out)}")
    data = json.loads(Path(out["json"]).read_text(encoding="utf-8"))
    if data["segments"] != res["aligned_segments"]:
        fail(f"pipeline {tag}: the JSON's segments are not the result's")
    srt = Path(out["srt"]).read_text(encoding="utf-8").strip()
    blocks = [b for b in srt.split("\n\n") if b] if srt else []
    stamp = re.compile(r"^\d\d:\d\d:\d\d,\d\d\d --> \d\d:\d\d:\d\d,\d\d\d$")
    if len(blocks) != len(res["aligned_segments"]) or not all(
            b.split("\n")[0] == str(i) and stamp.match(b.split("\n")[1])
            for i, b in enumerate(blocks, 1)):
        fail(f"pipeline {tag}: the SRT does not parse")
    if "<html" not in Path(out["html"]).read_text(encoding="utf-8").lower():
        fail(f"pipeline {tag}: the HTML does not parse")


def hold_turns(label: str, got: list, want: list) -> float:
    """Hold the card diarizer's turns against its plain run on the host:
    the same speakers turn by turn, every edge within one 0.02 s
    segmentation frame. Returns the largest edge difference in seconds."""
    same = [t["speaker"] for t in got] == [t["speaker"] for t in want]
    diff = max((abs(g[k] - w[k]) for g, w in zip(got, want)
                for k in ("start", "end")), default=0.0) if same else \
        float("inf")
    check(f"diarizer on the card, {label} turns = the host's", diff <= 0.02
          + 1e-9, f"{len(got)} turns against {len(want)}, speakers "
          f"{'the same' if same else 'differ'}, edges within {diff:.4f} s "
          "(limit 0.02)")
    return diff


def pipeline_phase(dev, eng):
    """run_pipeline on a ~60 s two-speaker conversation (conversation_audio,
    seed 1) with the beam slice's large-v3 engine passed as transcriber=
    and a DiarizationPipeline() on the card (the trained nets): beam 5,
    condition_on_previous_text with an initial prompt, html/json/srt, the
    meeting analysis with no key, strict_diarization, a resume journal.
    Launch counts are set to 0 just before and read just after the run;
    every kernel of the path (mel, encoder attention, decode layers,
    cross-attention, beam tail, reorder) must launch, every decode call's
    graph must run at its prompt's own left pad (valid_start) over a
    451-position self cache, every step after a prefill must replay its
    graph, the diarizer must find the scene's 2 speakers with every turn
    within one 0.02 s frame of its plain run on the host, the outputs must
    parse. Then, at temperature 0 only: a run writing a new journal, a
    rerun from the full journal (no decode launch, the same aligned
    segments) and a rerun from the journal cut to its header and first
    record (the other windows decoded, the same aligned segments). Prints
    the ``pipeline`` line: stage seconds, RTF, windows, decode calls, ms a
    step at R 5 and T 451, DER against the truth turns (collar 0), the
    diarizer's card peak memory."""
    import os
    import shutil

    import torch
    from whisper_aries_tpu_torch.audio.decode import write_wav
    from whisper_aries_tpu_torch.config import load_config
    from whisper_aries_tpu_torch.diarize import DiarizationPipeline
    from whisper_aries_tpu_torch.eval.der import diarization_error_rate
    from whisper_aries_tpu_torch.ops import decode_layers as DL
    from whisper_aries_tpu_torch.pipeline.run import run_pipeline

    work = OUT / "pipeline"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    audio, truth = conversation_audio()
    wav = work / "conversation.wav"
    write_wav(str(wav), audio)
    os.environ.pop(NO_KEY, None)
    base = {"decode.beam_size": 5, "decode.condition_on_previous_text": True,
            "decode.initial_prompt": "The quarterly budget meeting.",
            "analyze.api_key_env": NO_KEY}

    diar = DiarizationPipeline()  # device None: the card
    if diar.seg_net is None or diar.emb_net is None or not all(
            p.is_cuda for net in (diar.seg_net, diar.emb_net)
            for p in net.parameters()):
        fail("pipeline: the diarizer's nets are not loaded on the card")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    card_turns = diar(str(wav))
    torch.cuda.synchronize()
    diar_alone_s = time.time() - t0
    diar_peak_gb = (torch.cuda.max_memory_allocated() - resident) / 1e9
    # the same scene through the plain run on the host: the same speakers
    # in the same order, every turn edge within one 0.02 s segmentation
    # frame (as tests/test_torch_diarize.py holds the port against JAX)
    cpu_turns = DiarizationPipeline(device="cpu")(str(wav))
    edge_diff = hold_turns("the card's run alone", card_turns, cpu_turns)

    stage, calls, graphs = {}, [], []

    class TimedDiarizer:
        def __call__(self, path, **kw):
            t = time.time()
            turns = diar(path, **kw)
            torch.cuda.synchronize()
            stage["diarize_s"] = time.time() - t
            stage["turns"] = turns
            return turns

    real_transcribe, real_decode = eng.transcribe_file, eng._decode_batch
    graph_init = DL.DecodeStepGraph.__init__

    def timed_transcribe(*a, **k):
        t = time.time()
        out = real_transcribe(*a, **k)
        torch.cuda.synchronize()
        stage["transcribe_s"] = time.time() - t
        return out

    def spy_decode(xa, prompt, *a, **k):
        p = np.asarray(prompt)
        calls.append({"pad": int((p[0] == -1).sum()),
                      "prompt_start": int(k.get("prompt_start", 0)),
                      "rows": int(p.shape[0])})
        return real_decode(xa, prompt, *a, **k)

    def recording_init(self, wpack, self_cache, cross, rows, n_head,
                       valid_start=0):
        graph_init(self, wpack, self_cache, cross, rows, n_head, valid_start)
        graphs.append((rows, valid_start, self.ops.T))

    def run(tag, journal, **over):
        cfg = load_config(overrides=dict(base, **over))
        eng.config = cfg
        stage.clear()
        calls.clear()
        graphs.clear()
        for fn in counters().values():
            fn.launches = 0
        DL.fused_decoder_layers.graph_replays = 0
        t = time.time()
        res = run_pipeline(str(wav), output_dir=str(work / tag),
                           formats=["html", "json", "srt"], config=cfg,
                           transcriber=eng, diarizer=TimedDiarizer(),
                           strict_diarization=True, run_llm_analysis=True,
                           resume_path=str(journal))
        torch.cuda.synchronize()
        wall = time.time() - t
        launches = {k: fn.launches for k, fn in counters().items()}
        check_outputs(tag, res)
        decodes = eng.last_stats.get("decodes", [])
        return dict(res=res, wall=wall, launches=launches, decodes=decodes,
                    calls=list(calls), graphs=list(graphs),
                    replays=DL.fused_decoder_layers.graph_replays,
                    stage={k: v for k, v in stage.items() if k != "turns"},
                    turns=stage.get("turns"))

    old_config = eng.config
    eng.transcribe_file = timed_transcribe
    eng._decode_batch = spy_decode
    DL.DecodeStepGraph.__init__ = recording_init
    try:
        main = run("main", work / "main.jsonl")
        journal = work / "resume.jsonl"
        first = run("resume_first", journal, **{"decode.temperature": (0.0,)})
        full = run("resume_full_journal", journal,
                   **{"decode.temperature": (0.0,)})
        lines = journal.read_text(encoding="utf-8").splitlines()
        journal.write_text("\n".join(lines[:2]) + "\n", encoding="utf-8")
        cut = run("resume_cut_journal", journal,
                  **{"decode.temperature": (0.0,)})
    finally:
        del eng.transcribe_file, eng._decode_batch
        DL.DecodeStepGraph.__init__ = graph_init
        eng.config = old_config

    # the main run: every kernel of the path, each decode call at its own
    # left pad over a 451-position cache, every step a replay
    for k in PATH_KERNELS["pipeline"]:
        if main["launches"][k] <= 0:
            fail(f"kernel {k} was not launched on the pipeline path")
    decodes = main["decodes"]
    if not decodes or len(main["graphs"]) != len(decodes):
        fail(f"pipeline: {len(main['graphs'])} step graphs for "
             f"{len(decodes)} decode calls")
    for c, d, (rows, vs, T) in zip(main["calls"], decodes, main["graphs"]):
        if not (c["pad"] == c["prompt_start"] == d["prompt_start"] == vs
                and T == d["cache_len"] == 451 and rows == d["rows"]):
            fail(f"pipeline: decode call {d} ran its graph at valid_start "
                 f"{vs}, T {T}, {rows} rows; its prompt's pad is {c['pad']}")
    valid_starts = [d["prompt_start"] for d in decodes]
    if not any(v > 0 for v in valid_starts):
        fail("pipeline: no decode call ran at a valid_start above 0")
    steps = sum(d["steps"] for d in decodes)
    if not (main["replays"] == steps - len(decodes)
            == main["launches"]["decode_layers"]):
        fail(f"pipeline: {main['replays']} graph replays, "
             f"{main['launches']['decode_layers']} decoder-layer launches, "
             f"{steps - len(decodes)} layer steps")
    edge_diff = max(edge_diff, hold_turns("run_pipeline's", main["turns"],
                                          cpu_turns))
    speakers = sorted({t["speaker"] for t in main["turns"]})
    if len(speakers) != 2:
        fail(f"pipeline: the diarizer found {speakers}, not the scene's 2 "
             "speakers")
    # the resume reruns
    windows = len(first["decodes"])
    if windows < 2 or any(d["temperature"] != 0.0 for d in first["decodes"]):
        fail(f"pipeline: the journal run decoded {windows} windows")
    if full["decodes"] or full["launches"]["decode_layers"] or \
            full["launches"]["cross_attn_q8"]:
        fail("pipeline: the rerun from the full journal decoded "
             f"{len(full['decodes'])} windows")
    if len(cut["decodes"]) != windows - 1:
        fail(f"pipeline: the rerun from the cut journal decoded "
             f"{len(cut['decodes'])} windows, not {windows - 1}")
    for r in (full, cut):
        if r["res"]["aligned_segments"] != first["res"]["aligned_segments"]:
            fail("pipeline: a resumed run's aligned segments differ")
    r5 = [d for d in decodes if d["rows"] == 5 and d["cache_len"] == 451]
    der = diarization_error_rate(truth, main["turns"], collar_s=0.0)
    st = main["stage"]
    summary = dict(
        audio_s=len(audio) / 16_000, wall_s=main["wall"],
        transcribe_s=st["transcribe_s"], diarize_s=st["diarize_s"],
        align_render_s=main["wall"] - st["transcribe_s"] - st["diarize_s"],
        real_time_factor=len(audio) / 16_000 / main["wall"],
        windows=windows, decode_calls=len(decodes),
        decode_rows=sorted({d["rows"] for d in decodes}),
        valid_starts=valid_starts, cache_lens=sorted(
            {d["cache_len"] for d in decodes}),
        ms_per_step_r5_t451=1e3 * sum(d["seconds"] for d in r5)
        / max(1, sum(d["steps"] for d in r5)),
        steps=steps, graph_replays=main["replays"],
        segments=len(main["res"]["aligned_segments"]),
        speakers=speakers, truth_turns=len(truth),
        turns=len(main["turns"]), der=der,
        diarizer_peak_gb=diar_peak_gb, diarizer_alone_s=diar_alone_s,
        diarizer_cpu_turns=len(cpu_turns), diarizer_max_edge_diff_s=edge_diff,
        llm_analysis_error=main["res"]["llm_analysis_error"],
        resume=dict(
            {tag: dict(wall_s=r["wall"], decode_calls=len(r["decodes"]),
                       decode_layers=r["launches"]["decode_layers"],
                       valid_starts=[d["prompt_start"] for d in r["decodes"]])
             for tag, r in (("first", first), ("full_journal", full),
                            ("cut_journal", cut))}),
        launches=main["launches"])
    print("pipeline " + json.dumps(summary), flush=True)
    (OUT / "pipeline.json").write_text(json.dumps(
        dict(summary, decodes=decodes, truth=truth, turns=main["turns"]),
        indent=2))
    return main["launches"]


# ---------------------------------------------------------------------------
# serve path: the port's codecs and its job server
# ---------------------------------------------------------------------------

#: the test tones of the resampler check: a 1 kHz sine in the pass band
#: and, by input rate, a tone above the 8 kHz output Nyquist in the
#: filter's stop band, which must be removed. The filter (32 input taps a
#: phase, cut-off 0.945 x 8 kHz) is soft: between 8 and ~12 kHz a tone
#: aliases at -11 to -60 dB (printed, at 10 kHz, as alias_10k_db)
PASS_HZ = 1000.0
STOP_HZ = {22050: 11000.0, 44100: 14000.0, 48000: 14000.0}


def pcm_wav(ints: np.ndarray, bits: int, sr: int) -> bytes:
    """A PCM WAV of integer samples ``ints`` (n, channels) at ``bits``."""
    import struct

    n, ch = ints.shape
    if bits == 16:
        pcm = ints.astype("<i2").tobytes()
    else:  # 24
        pcm = np.frombuffer(ints.astype("<i4").tobytes(), np.uint8).reshape(
            -1, 4)[:, :3].tobytes()
    align = ch * bits // 8
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE" + b"fmt "
            + struct.pack("<IHHIIHH", 16, 1, ch, sr, sr * align, align, bits)
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


def load_test_module(name: str):
    """tests/<name>.py of this checkout (numpy or ctypes only)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def system_library(*names: str) -> bool:
    """Whether ``dlopen`` finds one of ``names`` on this host."""
    import ctypes

    for n in names:
        try:
            ctypes.CDLL(n)
            return True
        except OSError:
            continue
    return False


def resampler_checks() -> dict:
    """The port's resampler on sines, each limit below a named mistake:
    the pass-band sine's noise-to-signal power (core of 1 s, away from the
    edges) against "the output half an input sample late"; at 22.05, 44.1
    and 48 kHz, a stop-band tone's (STOP_HZ) power after resampling to
    16 kHz over its power before, against "a filter cut-off at the input
    Nyquist" (the tone aliases below 8 kHz at full power)."""
    from whisper_aries_tpu_torch.audio.decode import resample

    out = {}
    for sr in (8000, 22050, 44100, 48000):
        t = np.arange(sr) / sr
        y = resample(np.sin(2 * np.pi * PASS_HZ * t).astype(np.float32), sr)
        t16 = np.arange(len(y)) / 16_000
        core = slice(400, len(y) - 400)

        def nsr(want):
            return float(np.mean((y[core] - want[core]) ** 2)
                         / np.mean(want[core] ** 2))

        errs = {"passband_nsr": nsr(np.sin(2 * np.pi * PASS_HZ * t16))}
        tols = {"passband_nsr": 1e-6}  # 60 dB
        late = np.sin(2 * np.pi * PASS_HZ * (t16 - 0.5 / sr))
        mistakes = {"passband_nsr": float(
            np.mean((late[core] - np.sin(2 * np.pi * PASS_HZ * t16[core])) ** 2)
            / 0.5)}
        if sr > 16_000:
            def power(hz):
                x = np.sin(2 * np.pi * hz * t).astype(np.float32)
                return float(np.mean(resample(x, sr)[core] ** 2)
                             / np.mean(x ** 2))

            errs["stopband_power"] = power(STOP_HZ[sr])
            tols["stopband_power"] = 1e-6
            aliased = np.sin(2 * np.pi * STOP_HZ[sr] * t16)
            mistakes["stopband_power"] = float(np.mean(aliased[core] ** 2)
                                               / 0.5)
        out[sr] = held(f"resampler {sr} Hz -> 16 kHz", errs, tols, mistakes)
        if sr > 16_000:
            out[sr]["alias_10k_db"] = 10 * math.log10(power(10_000.0))
    return out


SCENE_SR = 44_100


def cached_flac(s16: np.ndarray, sr: int) -> tuple:
    """FLAC bytes of the stereo s16 samples (tests/flac_encoder.py, fixed
    order 2, blocks of 4096): encoded once per content hash (the samples,
    the rate, the encoder's source and its settings) into chip_smoke_out/
    and read back on later runs; the pure-Python encoder takes tens of
    seconds. Returns (bytes, encode seconds, whether it was cached)."""
    import hashlib

    enc = ROOT / "tests" / "flac_encoder.py"
    h = hashlib.sha256(np.ascontiguousarray(s16, "<i8").tobytes())
    h.update(f"{sr} fixed 2 4096".encode())
    h.update(enc.read_bytes())
    path = OUT / f"scene_{h.hexdigest()[:16]}.flac"
    if path.exists():
        return path.read_bytes(), 0.0, True
    t0 = time.time()
    blob = load_test_module("flac_encoder").encode_flac(
        [s16[:, 0], s16[:, 1]], sample_rate=sr, mode="fixed", order=2,
        block_size=4096)
    seconds = time.time() - t0
    OUT.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_bytes(blob)
    tmp.rename(path)
    return blob, seconds, False


def scene_blobs():
    """The pipeline path's conversation (seed 1) at 44.1 kHz stereo as s16
    WAV, s24 WAV and FLAC bytes (``cached_flac``, of the s16 samples), and
    the mono downmix. main() runs this in a thread while nvcc builds the
    kernels. Returns (blobs, mono, FLAC encode seconds, whether the FLAC
    was cached)."""
    from whisper_aries_tpu_torch.audio import _native as tn

    sr = SCENE_SR
    x16, _ = conversation_audio()
    x = tn.resample(x16, 16_000, sr)
    stereo = np.stack([x, 0.8 * x], axis=1)
    s16 = np.round(np.clip(stereo, -1, 1) * 32767).astype(np.int64)
    s24 = np.round(np.clip(stereo, -1, 1) * 8388607).astype(np.int64)
    mono = stereo.mean(axis=1).astype(np.float32)
    flac, seconds, cached = cached_flac(s16, sr)
    blobs = {"s16.wav": pcm_wav(s16, 16, sr), "s24.wav": pcm_wav(s24, 24, sr),
             "flac": flac}
    return blobs, mono, seconds, cached


def scene_formats(work: Path, scene):
    """The conversation of ``scene`` (scene_blobs' result) in every format
    this host can write and the port decode: s16 WAV, FLAC and s24 WAV
    always; MP3 where libmp3lame and libmpg123 resolve, Ogg where
    libvorbisenc and libvorbisfile resolve, m4a where the libavformat
    decoder was built and resolves (those three of the mono downmix). Each
    is decoded and resampled to 16 kHz by the port, timed; FLAC must decode
    to the s16 WAV's samples bit for bit. Returns ({format: path}, the
    report)."""
    from whisper_aries_tpu_torch.audio import _native as tn
    from whisper_aries_tpu_torch.audio.decode import resample

    sr = SCENE_SR
    blobs, mono, encode_s, flac_cached = scene
    blobs = dict(blobs)
    left_out = {}
    mp3_enc = load_test_module("mp3_encoder")
    if mp3_enc.lame_available() and tn.codec_available("mp3"):
        blobs["mp3"] = mp3_enc.encode_mp3(mono, sr)
    else:
        left_out["mp3"] = "system libmp3lame or libmpg123 absent"
    if system_library("libvorbisenc.so.2", "libvorbisenc.so") and \
            tn.codec_available("ogg"):
        blobs["ogg"] = tn.encode_ogg(mono, sr)
    else:
        left_out["ogg"] = "system libvorbisenc or libvorbisfile absent"
    if tn.codec_available("av"):
        blobs["m4a"] = tn.encode_m4a(mono, sr)
    elif not tn.av_built():
        left_out["m4a"] = "libavformat headers absent at build"
    else:
        left_out["m4a"] = "system libavformat absent"
    decoders = {"s16.wav": tn.decode_wav, "s24.wav": tn.decode_wav,
                "flac": tn.decode_flac, "mp3": tn.decode_mp3,
                "ogg": tn.decode_ogg, "m4a": tn.decode_av}
    files, report, decoded = {}, {}, {}
    for fmt, blob in blobs.items():
        path = work / f"conversation_44k.{fmt.split('.')[-1]}"
        if fmt == "s24.wav":
            path = work / "conversation_44k_s24.wav"
        path.write_bytes(blob)
        files[fmt] = path
        t0 = time.perf_counter()
        audio, got_sr = decoders[fmt](blob)
        t1 = time.perf_counter()
        y = resample(audio, got_sr)
        t2 = time.perf_counter()
        decoded[fmt] = audio
        secs = len(audio) / got_sr
        if got_sr != sr or not np.isfinite(y).all() or abs(
                len(y) / 16_000 - secs) > 0.01:
            fail(f"serve: {fmt} decoded to {len(audio)} samples at {got_sr}"
                 f" Hz, {len(y)} at 16 kHz")
        report[fmt] = dict(bytes=len(blob), audio_s=secs,
                           decode_ms=1e3 * (t1 - t0),
                           resample_ms=1e3 * (t2 - t1),
                           decode_ms_per_audio_s=1e3 * (t1 - t0) / secs,
                           resample_ms_per_audio_s=1e3 * (t2 - t1) / secs)
    flac_ok = decoded["flac"].tobytes() == decoded["s16.wav"].tobytes()
    check("FLAC decode = the s16 WAV of the same samples", flac_ok,
          f"{len(decoded['flac'])} samples at 44.1 kHz, bit for bit")
    print("codecs " + json.dumps(dict(
        ran=sorted(report), left_out=left_out, flac_encode_s=encode_s,
        flac_cached=flac_cached,
        formats=report)), flush=True)
    return files, dict(ran=sorted(report), left_out=left_out,
                       formats=report)


async def serve_over_http(cfg, files: dict) -> dict:
    """The server of ``create_app(cfg)`` (its default pipeline) on
    127.0.0.1, spoken to over HTTP: the FLAC and the s24 WAV submitted at
    once, each polled to "completed" and its json and srt downloaded; a
    .txt upload (400), an unknown job (404), /jobs/ and /stats/, and
    DELETE of the first job."""
    import aiohttp
    from aiohttp import web
    from whisper_aries_tpu_torch.serve.server import create_app

    app = create_app(cfg)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = "http://127.0.0.1:%d" % runner.addresses[0][1]
    out = {"jobs": {}}
    try:
        async with aiohttp.ClientSession() as s:
            async def submit(fmt):
                form = aiohttp.FormData()
                form.add_field("file", files[fmt].read_bytes(),
                               filename=files[fmt].name)
                form.add_field("formats", "json,srt")
                form.add_field("run_llm_analysis", "false")
                t = time.time()
                async with s.post(base + "/analyze/", data=form) as r:
                    body = await r.json()
                    if r.status != 200 or body["status"] != "queued":
                        fail(f"serve: upload of {fmt}: {r.status} {body}")
                return fmt, body["job_id"], t

            async def finish(fmt, job_id, t_up):
                while True:
                    async with s.get(f"{base}/status/{job_id}") as r:
                        st = await r.json()
                    if st["status"] in ("completed", "failed"):
                        break
                    await asyncio.sleep(0.05)
                t_done = time.time()
                if st["status"] != "completed":
                    fail(f"serve: job {fmt} {st['status']}: {st['error']}")
                got = {}
                for kind in ("json", "srt"):
                    async with s.get(f"{base}/download/{job_id}/{kind}") as r:
                        if r.status != 200:
                            fail(f"serve: download {kind} of {fmt}: "
                                 f"{r.status}")
                        got[kind] = await r.text()
                return fmt, dict(job_id=job_id, status=st, upload_s=t_up,
                                 upload_to_done_s=t_done - t_up, **got)

            jobs = await asyncio.gather(submit("flac"), submit("s24.wav"))
            for fmt, job in await asyncio.gather(
                    *(finish(*j) for j in jobs)):
                out["jobs"][fmt] = job
            form = aiohttp.FormData()
            form.add_field("file", b"hello", filename="notes.txt")
            async with s.post(base + "/analyze/", data=form) as r:
                out["txt_status"] = r.status
            async with s.get(base + "/status/no-such-job") as r:
                out["unknown_status"] = r.status
            async with s.get(base + "/jobs/") as r:
                out["jobs_listed"] = len((await r.json())["jobs"])
            async with s.get(base + "/stats/") as r:
                out["stats"] = await r.json()
            first = out["jobs"]["flac"]["job_id"]
            async with s.delete(f"{base}/jobs/{first}") as r:
                out["delete_status"] = r.status
            async with s.get(f"{base}/status/{first}") as r:
                out["deleted_status"] = r.status
            out["deleted_outputs_left"] = (
                Path(cfg.server.output_root) / first).exists()
    finally:
        await runner.cleanup()
    return out


def card_lock_held(device) -> bool:
    """Whether some thread holds ``device``'s card lock: another thread
    tries to take it (and gives it back if it could)."""
    import threading

    from whisper_aries_tpu_torch.utils.device import card_lock

    lock, took = card_lock(device), []

    def take():
        took.append(lock.acquire(blocking=False))
        if took[0]:
            lock.release()

    t = threading.Thread(target=take)
    t.start()
    t.join()
    return not took[0]


def preload_paths(eng, work: Path, minutes: float = 36.0) -> dict:
    """The preloader's two ways to the card, on a long PCM16 mono WAV at
    16 kHz (noise, seed 5): its raw int16 samples uploaded as they are
    (AudioPreloader, engine._upload), against the native decode to f32
    and the quantization back (load_audio, then _upload's quantization).
    Each timed best of 3 with the card synchronised, with VAD off (the
    int16 buffer only) and on (the f32 view the planner reads as well);
    the two uploaded buffers must be equal bit for bit. Prints the
    "preload" line."""
    import torch
    from whisper_aries_tpu_torch.audio import decode as td

    path = work / "long_pcm16.wav"
    rng = np.random.default_rng(5)
    n = int(minutes * 60 * 16_000)
    td.write_wav(str(path), 0.1 * rng.standard_normal(n, np.float32),
                 16_000)

    def int16_path(vad):
        pre = td.AudioPreloader(str(path))
        buf = eng._upload(pre)[eng.device]  # a copy a device of the mesh
        if vad:
            pre.audio
        torch.cuda.synchronize()
        return buf

    def f32_path(vad):
        a = td.load_audio(str(path))
        a16 = np.clip(a * 32768.0, -32768, 32767).astype(np.int16)
        buf = torch.zeros(len(a16) + eng.WINDOW_SAMPLES, dtype=torch.int16,
                          device=eng.device)
        buf[: len(a16)] = torch.from_numpy(a16).to(eng.device)
        torch.cuda.synchronize()
        return buf

    out = dict(audio_s=n / 16_000, file_mb=path.stat().st_size / 1e6)
    for vad in (False, True):
        for name, fn in (("int16", int16_path), ("f32", f32_path)):
            secs = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn(vad)
                secs.append(time.perf_counter() - t0)
            out[f"{name}_s_vad_{'on' if vad else 'off'}"] = min(secs)
    same = bool(torch.equal(int16_path(False), f32_path(False)))
    check("preload: the int16 upload = the f32 decode quantized", same,
          f"{n} samples, bit for bit")
    path.unlink()
    print("preload " + json.dumps(out), flush=True)
    return out


def serve_phase(dev, eng, scene):
    """The serve path: the codecs (scene_formats, resampler_checks), then
    the port's job server, over HTTP on 127.0.0.1, with its default
    pipeline: run_pipeline with the engine from get_transcriber (the beam
    slice's large-v3 engine, handed to get_transcriber's cache as the
    engine it builds) and a DiarizationPipeline() on the card for each
    job, at beam 5, conditioned with an initial prompt, temperature 0.
    First each file through run_pipeline serially; then both submitted at
    once (server.max_concurrent_jobs 2), launch counts set to 0 just
    before and read just after, every kernel of the path launched; each
    job's aligned segments (texts, times, speakers) equal its serial run,
    its downloaded JSON's segments and its SRT the serial files'. Prints
    the "serve" line: per job the queue wait, upload to completion and
    stage seconds, the two jobs' overlap, the card's peak memory, and that
    the run went over HTTP."""
    import shutil
    import threading

    import torch
    from whisper_aries_tpu_torch.config import load_config
    from whisper_aries_tpu_torch.diarize import DiarizationPipeline
    from whisper_aries_tpu_torch.diarize import pipeline as DP
    from whisper_aries_tpu_torch.ops import decode_layers as DL
    from whisper_aries_tpu_torch.pipeline import engine as E
    from whisper_aries_tpu_torch.pipeline import run as R
    from whisper_aries_tpu_torch.pipeline.run import run_pipeline

    work = OUT / "serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    files, codecs = scene_formats(work, scene)
    resampler = resampler_checks()
    preload = preload_paths(eng, work)

    os.environ.pop(NO_KEY, None)
    cfg = load_config(overrides={
        "decode.beam_size": 5, "decode.condition_on_previous_text": True,
        "decode.initial_prompt": "The quarterly budget meeting.",
        "decode.temperature": (0.0,), "analyze.api_key_env": NO_KEY,
        "server.output_root": str(work / "outputs"),
        "server.job_store_path": str(work / "jobs.json"),
        "server.max_concurrent_jobs": 2})
    # each stage's (start, end) by file name, from the job threads
    stamps: dict = {}
    lock = threading.Lock()
    built = []

    def resident(**kw):
        built.append(kw)
        return eng

    real_transcribe, diar_call = eng.transcribe_file, \
        DiarizationPipeline.__call__

    def stamp(path, key, t0):
        with lock:
            stamps.setdefault(Path(path).name, {})[key] = (t0, time.time())

    def timed_transcribe(path, **kw):
        t0 = time.time()
        res = real_transcribe(path, **kw)
        stamp(path, "transcribe", t0)
        # this job thread's own call's counters
        stamps[Path(path).name]["card_wait_s"] = eng.last_stats[
            "card_wait_s"]
        return res

    def timed_diarize(self, path, **kw):
        t0 = time.time()
        turns = diar_call(self, path, **kw)
        stamp(path, "diarize", t0)
        stamps[Path(path).name]["turns"] = turns
        if not all(p.device.type == dev.type
                   for p in self.seg_net.parameters()):
            fail("serve: the job's diarizer is not on the card")
        return turns

    # every decode call's graph capture: in a job's thread, with the
    # engine's card that thread's current device and the graph's
    graph_init, captures = DL.DecodeStepGraph.__init__, []

    def recording_init(self, *a, **k):
        graph_init(self, *a, **k)
        captures.append((threading.current_thread() is not
                         threading.main_thread(),
                         torch.cuda.current_device(), self.dev.index,
                         card_lock_held(eng.device)))

    # every weight upload of a job's diarizer: under the card lock
    net_loads, net_classes = [], (DP.SegmentationNet, DP.EmbeddingNet)
    own_loads = [cls.__dict__.get("load") for cls in net_classes]

    def recording_load(cls):
        real = cls.load

        def load(*a, **k):
            net_loads.append((cls.__name__, card_lock_held(eng.device)))
            return real(*a, **k)
        return staticmethod(load)

    old_config = eng.config
    eng.config = cfg
    DL.DecodeStepGraph.__init__ = recording_init
    for cls in net_classes:
        cls.load = recording_load(cls)
    E.AriesTranscriber, real_class = resident, E.AriesTranscriber
    eng.transcribe_file = timed_transcribe
    DiarizationPipeline.__call__ = timed_diarize
    try:
        serial = {}
        for fmt in ("flac", "s24.wav"):
            t0 = time.time()
            res = run_pipeline(str(files[fmt]), output_dir=str(
                work / "serial"), formats=["json", "srt"],
                confidence_threshold=0.7, run_llm_analysis=False, config=cfg)
            if not res["success"]:
                fail(f"serve: serial run of {fmt}: {res['error']}")
            serial[fmt] = dict(res=res, wall_s=time.time() - t0)
        if len(built) != 1 or built[0]["model_size"] != cfg.model.name:
            fail(f"serve: get_transcriber built {built}")
        serial_turns = {name: s["turns"] for name, s in stamps.items()}
        for name in list(stamps):
            stamps[name] = {}
        captures.clear()
        net_loads.clear()
        for fn in counters().values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        http = asyncio.run(serve_over_http(cfg, files))
        wall = time.time() - t0
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters().items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        eng.config = old_config
        DL.DecodeStepGraph.__init__ = graph_init
        for cls, own in zip(net_classes, own_loads):
            if own is None:
                del cls.load
            else:
                cls.load = own
        E.AriesTranscriber = real_class
        del eng.transcribe_file
        DiarizationPipeline.__call__ = diar_call
        for key in [k for k, v in R._ENGINE_CACHE.items() if v is eng]:
            del R._ENGINE_CACHE[key]

    for k in PATH_KERNELS["serve"]:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the serve path")
    card = eng.device.index if eng.device.index is not None else 0
    if dev.type == "cuda" and not (captures and all(
            job and cur == card and (g if g is not None else card) == card
            and held for job, cur, g, held in captures)):
        fail(f"serve: decode graphs captured as (in a job thread, current "
             f"device, graph's device, card lock held) {captures}; the "
             f"engine's card is {card}")
    check("serve: every diarizer weight upload under the card lock",
          len(net_loads) == 4 and all(h for _, h in net_loads),
          f"{len(net_loads)} uploads in the two jobs: {net_loads}")
    jobs = {}
    spans = []
    for fmt, job in http["jobs"].items():
        want = serial[fmt]["res"]
        got = job["status"]["result"]
        same = got["aligned_segments"] == want["aligned_segments"]
        texts = [s["text"] for s in got["aligned_segments"]]
        name = files[fmt].name
        turns = stamps[name]["turns"]
        speakers = sorted({u["speaker"] for u in turns})
        same_turns = turns == serial_turns[name]
        check(f"serve: the {fmt} job = its serial run_pipeline", same
              and same_turns and bool(texts),
              f"{len(texts)} segments: texts, times and speakers "
              f"{'identical' if same else 'differ'}; {len(turns)} speaker "
              f"turns {'identical' if same_turns else 'differ'}")
        seg = json.loads(job["json"])["segments"]
        want_json = json.loads(Path(want["outputs"]["json"]).read_text(
            encoding="utf-8"))["segments"]
        srt_same = job["srt"] == Path(want["outputs"]["srt"]).read_text(
            encoding="utf-8")
        check(f"serve: the {fmt} job's downloads = its serial files",
              seg == want_json and srt_same,
              f"json segments {'equal' if seg == want_json else 'differ'}, "
              f"srt {'equal' if srt_same else 'differs'}")
        if len(speakers) != 2:
            fail(f"serve: the {fmt} job's diarizer found {speakers}, not "
                 "the scene's 2 speakers")
        st = job["status"]
        created, started, done = (
            datetime.fromisoformat(st[k]).timestamp()
            for k in ("created_at", "started_at", "completed_at"))
        spans.append((started, done))
        stage = {f"{k}_s": stamps[name][k][1] - stamps[name][k][0]
                 for k in ("transcribe", "diarize")}
        jobs[fmt] = dict(
            queue_wait_s=started - created, run_s=done - started,
            upload_to_done_s=job["upload_to_done_s"],
            card_wait_s=stamps[name]["card_wait_s"], **stage,
            rest_s=(done - started) - stage["transcribe_s"]
            - stage["diarize_s"], segments=len(texts), turns=len(turns),
            speakers=speakers,
            serial_wall_s=serial[fmt]["wall_s"])
    overlap = max(0.0, min(e for _, e in spans) - max(s for s, _ in spans))
    if overlap <= 0:
        fail(f"serve: the two jobs did not overlap: {spans}")
    if http["txt_status"] != 400 or http["unknown_status"] != 404:
        fail(f"serve: .txt upload {http['txt_status']}, unknown job "
             f"{http['unknown_status']}")
    if http["jobs_listed"] != 2 or http["stats"]["total_jobs"] != 2 or \
            http["stats"]["completed_jobs"] != 2:
        fail(f"serve: /jobs/ listed {http['jobs_listed']}, /stats/ "
             f"{http['stats']}")
    if http["delete_status"] != 200 or http["deleted_status"] != 404 or \
            http["deleted_outputs_left"]:
        fail(f"serve: DELETE {http['delete_status']}, then status "
             f"{http['deleted_status']}, outputs left "
             f"{http['deleted_outputs_left']}")
    summary = dict(
        over_http=True, engine_from_get_transcriber=True, wall_s=wall,
        graphs_captured_in_job_threads=len(captures),
        diarizer_uploads_under_lock=len(net_loads),
        jobs=jobs, overlap_s=overlap, peak_mem_gb=peak_gb,
        txt_status=http["txt_status"],
        unknown_status=http["unknown_status"],
        stats=http["stats"], codecs=codecs["ran"],
        codecs_left_out=codecs["left_out"],
        resampler={sr: dict(r["errors"], alias_10k_db=r.get("alias_10k_db"))
                   for sr, r in resampler.items()},
        preload=preload, launches=launches)
    print("serve " + json.dumps(summary), flush=True)
    (OUT / "serve.json").write_text(json.dumps(
        dict(summary, codecs=codecs, resampler=resampler), indent=2))
    return launches


# ---------------------------------------------------------------------------
# cli path
# ---------------------------------------------------------------------------

#: the kernels a bf16 run launches greedy, and at beam 5
GREEDY_KERNELS = ("mel", "encoder_attn", "decode_layers", "cross_attn_q8")
BEAM_KERNELS = GREEDY_KERNELS + ("beam_tail", "beam_reorder")


def counted(fn, *args, **kw):
    """(fn(*args, **kw), wall seconds, launches) with every launch count
    set to 0 just before and read just after (``graph_replays``: the fused
    step's replays)."""
    import torch
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    for c in counters().values():
        c.launches = 0
    DL.fused_decoder_layers.graph_replays = 0
    W.decoder_step.graph_replays = 0
    t0 = time.time()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: c.launches for k, c in counters().items()}
    launches["graph_replays"] = DL.fused_decoder_layers.graph_replays
    return out, wall, launches


def run_tool(report: dict, name: str, main, argv, kernels=(), rc_want=0):
    """A tool's ``main(argv)`` in this process with counts from 0, its
    stdout and stderr kept in chip_smoke_out/cli/<name>.log: the exit code
    must be ``rc_want`` and each of ``kernels`` must have launched.
    Records rc, wall seconds and the nonzero launches in ``report[name]``;
    returns (rc, stdout, stderr, launches)."""
    import contextlib
    import gc
    import io

    import torch

    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        rc, wall, launches = counted(main, list(argv))
    gc.collect()  # the tool's engine goes with it
    torch.cuda.empty_cache()
    (OUT / "cli" / f"{name}.log").write_text(
        f"argv {argv}\nrc {rc}\n--- stdout\n{o.getvalue()}\n--- stderr\n"
        f"{e.getvalue()}")
    report[name] = dict(rc=rc, wall_s=wall,
                        launches={k: n for k, n in launches.items() if n})
    if rc != rc_want:
        fail(f"cli: {name} returned {rc}, not {rc_want} (see "
             f"chip_smoke_out/cli/{name}.log)")
    for k in kernels:
        if launches[k] <= 0:
            fail(f"cli: kernel {k} was not launched by {name}")
    return rc, o.getvalue(), e.getvalue(), launches


def parse_outputs(tag: str, stem: Path, formats) -> dict:
    """Each of the TXT, JSON and SRT files at ``stem`` exists and parses;
    returns the JSON's content ({} without one)."""
    import re

    data = {}
    stamp = re.compile(r"^\d\d:\d\d:\d\d,\d\d\d --> \d\d:\d\d:\d\d,\d\d\d$")
    for fmt in formats:
        p = stem.with_suffix(f".{fmt}")
        if not p.exists():
            fail(f"cli: {tag} wrote no {p.name}")
        text = p.read_text(encoding="utf-8")
        if fmt == "json":
            data = json.loads(text)
            if not isinstance(data.get("transcription"), list):
                fail(f"cli: {tag}'s JSON has no transcription")
        if fmt == "srt":
            blocks = [b for b in text.strip().split("\n\n") if b]
            if not all(b.split("\n")[0] == str(i)
                       and stamp.match(b.split("\n")[1])
                       for i, b in enumerate(blocks, 1)):
                fail(f"cli: {tag}'s SRT does not parse")
    return data


def window_tokens(res: dict) -> dict:
    """{window id: its segments' tokens, in order}."""
    out: dict = {}
    for s in res["segments"]:
        out.setdefault(s["window_id"], []).extend(s.get("tokens", []))
    return out


def cli_phase(dev, ckpt: Path, beam_engine):
    """The command-line tools and the legacy engine on phase 9's large-v3
    checkpoint directory (seeded random weights), each tool's main() in
    this process with every launch count set to 0 just before: transcribe
    on the 125 s WAV (beam 5, txt/json/srt, word timestamps; every kernel
    of the path launched, every file parsing, its segments those of an
    in-process transcribe_file with the same engine options);
    batch_transcribe on a directory of two WAVs with a manifest, then a
    rerun without --overwrite that skips both and launches no kernel;
    diarize and conversation on phase 10's two-speaker scene (both finding
    the 2 speakers); meeting with no API key (its error recorded);
    verify_setup --smoke-test (rc 0); FixedUltraFastTranscriber on the
    125 s WAV (parallel_info and performance filled). Then the replicas:
    the beam slice's engine at one window a replica, as one replica and
    with mesh [cuda:0, cuda:0] (the same tokens in every window, scores
    within 1e-3 relative, per_device_distribution over both replicas, the
    one-replica run's launch counts), and an engine on make_mesh() over
    every visible card at its own batch size, whose card peak over its
    resident memory must not exceed auto_windows_per_device's byte model.
    Prints the ``cli`` line; deletes the checkpoint directory after.
    Returns the transcribe tool's launches."""
    import os
    import shutil

    import torch
    from whisper_aries_tpu_torch.audio.decode import write_wav
    from whisper_aries_tpu_torch.cli import batch_transcribe as cbt
    from whisper_aries_tpu_torch.cli import conversation as cconv
    from whisper_aries_tpu_torch.cli import diarize as cdz
    from whisper_aries_tpu_torch.cli import meeting as cmeet
    from whisper_aries_tpu_torch.cli import transcribe as ctr
    from whisper_aries_tpu_torch.cli import verify_setup as cvs
    from whisper_aries_tpu_torch.config import load_config
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.parallel.mesh import (
        auto_windows_per_device,
        make_mesh,
        window_bytes,
    )
    from whisper_aries_tpu_torch.pipeline import run as PR
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber
    from whisper_aries_tpu_torch.pipeline.legacy import (
        FixedUltraFastTranscriber,
    )

    work = OUT / "cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    wav125 = OUT / "synthetic_2min.wav"
    if not wav125.exists():
        write_wav(str(wav125), synth_audio(125.0, seed=7))
    tools: dict = {}
    model = ["--model", str(ckpt)]

    # transcribe, and the same call in-process
    out = work / "transcribe"
    _, _, _, tr_launches = run_tool(
        tools, "transcribe", ctr.main,
        [str(wav125), *model, "--beam-size", "5", "--formats",
         "txt,json,srt", "--word-timestamps", "--output-dir", str(out)],
        BEAM_KERNELS)
    data = parse_outputs("transcribe", out / "synthetic_2min",
                         ("txt", "json", "srt"))
    eng = AriesTranscriber(model_size=str(ckpt))
    want = eng.transcribe_file(
        str(wav125), beam_size=5, repetition_penalty=1.0,
        max_new_tokens=224, output_formats=[], word_timestamps=True)
    del eng
    torch.cuda.empty_cache()
    keys = ("start", "end", "text", "avg_logprob", "no_speech_prob",
            "chunk_id", "worker_id")
    same = data["transcription"] == [{k: s[k] for k in keys if k in s}
                                     for s in want["segments"]]
    check("cli transcribe = an in-process transcribe_file",
          same and bool(want["segments"]),
          f"{len(data['transcription'])} segments against "
          f"{len(want['segments'])}, every field equal: {same}")

    # batch_transcribe: two files with a manifest, then a rerun
    src = work / "batch_in"
    src.mkdir()
    write_wav(str(src / "one.wav"), synth_audio(40.0, seed=8))
    write_wav(str(src / "two.wav"), synth_audio(25.0, seed=9))
    manifest = work / "manifest.json"
    batch = [str(src), *model, "--output-dir", str(work / "batch_out"),
             "--manifest", str(manifest)]
    run_tool(tools, "batch_transcribe", cbt.main, batch, GREEDY_KERNELS)
    results = json.loads(manifest.read_text())["results"]
    if len(results) != 2 or any("error" in r for r in results):
        fail(f"cli: batch_transcribe's manifest {results}")
    for stem in ("one", "two"):
        parse_outputs("batch_transcribe", work / "batch_out" / stem,
                      ("txt", "json"))
    _, rerun_out, _, rerun = run_tool(tools, "batch_transcribe_rerun",
                                      cbt.main, batch)
    if rerun_out.count("skip (exists)") != 2 or any(rerun.values()):
        fail(f"cli: the rerun without --overwrite did not skip both files "
             f"without a launch: {rerun}")

    # diarize and conversation on the two-speaker scene
    scene, _ = conversation_audio()
    wav = work / "conversation.wav"
    write_wav(str(wav), scene)
    run_tool(tools, "diarize", cdz.main,
             [str(wav), "--output-dir", str(work / "diarize")])
    turns = json.loads((work / "diarize" / "conversation_diarization.json")
                       .read_text())
    speakers = {"diarize": len({t["speaker"] for t in turns})}
    run_tool(tools, "conversation", cconv.main,
             [str(wav), *model, "--output-dir", str(work / "conversation"),
              "--no-llm"], GREEDY_KERNELS)
    PR._ENGINE_CACHE.clear()  # the pipeline's resident engine
    torch.cuda.empty_cache()
    conv_json = work / "conversation" / "conversation.json"
    segs = json.loads(conv_json.read_text())["segments"]
    # segments under the confidence threshold carry no speaker
    speakers["conversation"] = len({s["speaker"] for s in segs
                                    if s["speaker"]})
    if speakers != {"diarize": 2, "conversation": 2}:
        fail(f"cli: speakers found {speakers}, not 2 and 2")

    # meeting with no key: the error is recorded
    key_env = load_config().analyze.api_key_env
    saved_key = os.environ.pop(key_env, None)
    try:
        _, _, err, _ = run_tool(tools, "meeting", cmeet.main,
                                [str(conv_json)], rc_want=1)
    finally:
        if saved_key is not None:
            os.environ[key_env] = saved_key
    tools["meeting"]["error"] = err.strip()
    if key_env not in err:
        fail(f"cli: meeting's error does not name ${key_env}: {err!r}")

    run_tool(tools, "verify_setup", cvs.main, ["--smoke-test", *model],
             ("mel", "encoder_attn"))

    # the legacy engine
    conf = work / "whisper_config.json"
    conf.write_text(json.dumps({"model_size": str(ckpt)}))

    def legacy():
        t = FixedUltraFastTranscriber(str(conf))
        return t.transcribe_ultra_fast(str(wav125),
                                       output_dir=str(work / "legacy"))

    leg, leg_s, leg_launches = counted(legacy)
    torch.cuda.empty_cache()
    pi, lp = leg["parallel_info"], leg["performance"]
    tools["legacy"] = dict(wall_s=leg_s, parallel_info=pi, performance=lp,
                           launches={k: n for k, n in leg_launches.items()
                                     if n})
    if not (leg["success"] and pi["workers_used"] >= 1
            and pi["chunks_processed"] >= 1
            and isinstance(pi["parallel_efficiency"], float)
            and pi["chunks_per_minute"] > 0 and lp["speed_factor"] > 0
            and lp["assessment"]):
        fail(f"cli: the legacy engine's blocks are not filled: {pi} {lp}")
    for k in GREEDY_KERNELS:
        if leg_launches[k] <= 0:
            fail(f"cli: kernel {k} was not launched by the legacy engine")

    # replicas: one window a replica, one replica against two on cuda:0
    saved = beam_engine.batch_size
    beam_engine.batch_size = 1
    try:
        one, one_s, one_l = counted(beam_engine.transcribe_file, str(wav125))
    finally:
        beam_engine.batch_size = saved
    two_eng = AriesTranscriber(
        "large-v3", allow_random=True,
        config=load_config(overrides=SLICE_CONFIG["beam"]),
        mesh=[torch.device("cuda", 0)] * 2, windows_per_device=1)
    two, two_s, two_l = counted(two_eng.transcribe_file, str(wav125))
    del two_eng
    torch.cuda.empty_cache()
    tok1, tok2 = window_tokens(one), window_tokens(two)
    lp1 = np.asarray([s["avg_logprob"] for s in one["segments"]])
    lp2 = np.asarray([s["avg_logprob"] for s in two["segments"]])
    rel = (float(np.max(np.abs(lp2 - lp1) / np.maximum(np.abs(lp1), 1e-9)))
           if lp1.shape == lp2.shape and len(lp1) else float("inf"))
    check("two replicas on cuda:0 = one replica, tokens of every window",
          tok1 == tok2 and bool(tok1), f"{len(tok2)} windows against "
          f"{len(tok1)}, identical tokens: {tok1 == tok2}")
    check("two replicas on cuda:0 = one replica, scores", rel <= 1e-3,
          f"avg_logprob within {rel:.2e} relative (limit 1e-3)")
    dist = two["performance"]["per_device_distribution"]
    check("two replicas: per_device_distribution over both",
          sorted(dist) == [0, 1], f"{dist}")
    check("two replicas: launch counts = the one replica's", one_l == two_l,
          f"one {dict((k, n) for k, n in one_l.items() if n)}, two "
          f"{dict((k, n) for k, n in two_l.items() if n)}")
    for k in BEAM_KERNELS:
        if two_l[k] <= 0:
            fail(f"cli: kernel {k} was not launched by the replicas")

    # every visible card, at the engine's own batch; the byte model
    mesh = make_mesh()
    all_eng = AriesTranscriber(
        "large-v3", allow_random=True,
        config=load_config(overrides=SLICE_CONFIG["beam"]), mesh=mesh)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    full, full_s, full_l = counted(all_eng.transcribe_file, str(wav125))
    act = torch.cuda.max_memory_allocated() - base
    windows = max(d["windows"] for d in all_eng.last_stats["decodes"])
    wpd = all_eng.batch_size // len(mesh)
    del all_eng
    torch.cuda.empty_cache()
    per = window_bytes(W.PRESETS["large-v3"], rows=5, cache_len=3 + 224)
    chosen = auto_windows_per_device("large-v3", beam_size=5)
    check("auto_windows_per_device's bytes >= the measured peak",
          windows * per >= act and 8 * per >= act,
          f"{per} bytes a window: {windows} windows {windows * per}, 8 "
          f"windows {8 * per}, the run's peak over its resident memory "
          f"{act}")
    if not full["segments"] or not all(
            math.isfinite(s["avg_logprob"]) for s in full["segments"]):
        fail("cli: the run over every visible card has no finite segment")
    full_tok = window_tokens(full)
    summary = dict(
        tools=tools, speakers=speakers,
        replicas=dict(one_s=one_s, two_s=two_s, windows=len(tok2),
                      identical_windows=sum(tok1.get(w) == t
                                            for w, t in tok2.items()),
                      max_score_rel=rel, per_device_distribution=dist,
                      launches={k: n for k, n in two_l.items() if n}),
        mesh=dict(count=len(mesh), windows_per_device=wpd, wall_s=full_s,
                  windows_a_batch=windows,
                  windows_equal_to_one_a_batch=sum(
                      tok1.get(w) == t for w, t in full_tok.items()),
                  launches={k: n for k, n in full_l.items() if n}),
        auto_windows=dict(chosen=chosen, window_bytes=per,
                          model_bytes_run=windows * per,
                          model_bytes_8=8 * per, measured_peak_bytes=act))
    print("cli " + json.dumps(summary), flush=True)
    (OUT / "cli.json").write_text(json.dumps(summary, indent=2))
    shutil.rmtree(ckpt, ignore_errors=True)
    return tr_launches


# ---------------------------------------------------------------------------
# pipeline depth path
# ---------------------------------------------------------------------------

#: the depth path's windows a batch: the 125 s WAV's 6 windows in 3 batches
DEPTH_BATCH = 2


def batches_of(events) -> list:
    """The units of each batch, in dispatch order, from the ENCODING
    events' "batch@p" details (a retried batch counted once)."""
    seen: dict = {}
    for e in events:
        if e["state"] == "ENCODING":
            seen.setdefault(e["detail"].split()[0], []).append(e["unit"])
    return [list(dict.fromkeys(u)) for u in seen.values()]


def depth_phase(dev, eng):
    """The engine's double-buffered batch loop on the card: the beam
    slice's engine at DEPTH_BATCH windows a batch (windows_per_device 2 on
    one card) over the 125 s WAV (6 windows, 3 batches), transcribe_file
    with a resume journal at ARIES_PIPELINE=1 (depth 2) and =0 (depth 1),
    counts from 0 before each. Holds: equal segments (tokens, text, times,
    window and worker), equal journals, equal diagnostics events as
    multisets, at depth 2 each batch k + 1's DECODING before batch k's
    first COMPLETED (at depth 1 after its last), the same batch size, and
    every kernel of the path launched at both depths. Then one
    out-of-memory error injected into batch 1's decode at depth 2: the
    batch size kept, the depth dropped to 1, the segments equal. Prints the
    ``depth`` line (each depth's wall, its parse seconds a batch and the
    seconds of parse that overlapped the next batch's card work and its
    decode, the card's peak over the resident memory). Returns the depth-2 run's launches."""
    import os
    import shutil

    import torch

    work = OUT / "depth"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    wav = OUT / "synthetic_2min.wav"
    saved_bs, saved_env = eng.batch_size, os.environ.get("ARIES_PIPELINE")
    eng.batch_size = DEPTH_BATCH
    runs: dict = {}

    def one(pipeline: str, **kw):
        os.environ["ARIES_PIPELINE"] = pipeline
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res, wall, launches = counted(eng.transcribe_file, str(wav),
                                      output_formats=(), **kw)
        stats = eng.last_stats
        return dict(res=res, wall=wall, launches=launches,
                    peak=torch.cuda.max_memory_allocated() - base,
                    events=list(eng.last_diagnostics.events),
                    parses=stats["parses"], depth=stats["pipeline_depth"],
                    batch_size=eng.batch_size)

    try:
        for pipeline in ("1", "0"):
            journal = work / f"journal{pipeline}.jsonl"
            runs[pipeline] = one(pipeline, resume_path=str(journal))
            runs[pipeline]["journal"] = [
                json.loads(line) for line in journal.read_text().splitlines()]
        real, calls = eng._decode_batch, []

        def flaky(*a, **k):
            calls.append(1)
            if len(calls) == 2:  # batch 1, while batch 0 is parsed
                raise RuntimeError("CUDA out of memory. Tried to allocate "
                                   "1.00 GiB (injected)")
            return real(*a, **k)

        eng._decode_batch = flaky
        try:
            oom = one("1")
        finally:
            del eng._decode_batch
    finally:
        eng.batch_size = saved_bs
        if saved_env is None:
            os.environ.pop("ARIES_PIPELINE", None)
        else:
            os.environ["ARIES_PIPELINE"] = saved_env
        torch.cuda.empty_cache()

    def segs(run):
        return [(s["text"], list(s.get("tokens", [])), s["start"], s["end"],
                 s["window_id"], s["worker_id"])
                for s in run["res"]["segments"]]

    def pairs(run):
        return sorted((e["unit"], e["state"]) for e in run["events"])

    d2, d1 = runs["1"], runs["0"]
    if not d2["res"]["segments"]:
        fail("depth: the depth-2 run has no segment")
    n_batches = len(batches_of(d2["events"]))
    check("depth: 3 batches of 2 windows at both depths",
          n_batches == 3 and len(batches_of(d1["events"])) == 3
          and d2["res"]["num_windows"] == 6,
          f"{n_batches} batches, {d2['res']['num_windows']} windows")
    check("depth: depth 2 = depth 1, segments", segs(d2) == segs(d1),
          f"{len(segs(d2))} against {len(segs(d1))} segments")
    check("depth: depth 2 = depth 1, journal", d2["journal"] == d1["journal"],
          f"{len(d2['journal'])} against {len(d1['journal'])} records")
    check("depth: depth 2 = depth 1, events as multisets",
          pairs(d2) == pairs(d1), f"{len(pairs(d2))} events")
    check("depth: the same batch size, the depths as asked",
          d2["batch_size"] == d1["batch_size"] == DEPTH_BATCH
          and (d2["depth"], d1["depth"]) == (2, 1),
          f"batch {d2['batch_size']} / {d1['batch_size']}, depths "
          f"{d2['depth']} / {d1['depth']}")

    def ahead(run) -> bool:
        """Every batch k + 1's last DECODING before batch k's first
        COMPLETED."""
        ev = [(e["unit"], e["state"]) for e in run["events"]]
        bs = batches_of(run["events"])
        return all(
            max(ev.index((u, "DECODING")) for u in bs[k + 1])
            < min(ev.index(e) for e in ev
                  if e[1] == "COMPLETED" and e[0] in bs[k])
            for k in range(len(bs) - 1))

    check("depth: at depth 2 batch k + 1 decodes before batch k completes",
          ahead(d2) and not ahead(d1), f"depth 2 {ahead(d2)}, depth 1 "
          f"{ahead(d1)}")
    check("depth: an OOM at depth 2 keeps the batch and drops the depth",
          oom["batch_size"] == DEPTH_BATCH and oom["depth"] == 1
          and len(calls) >= 4, f"batch {oom['batch_size']}, depth "
          f"{oom['depth']}, decode calls {len(calls)}")
    check("depth: the OOM run's segments = the depth-2 run's",
          segs(oom) == segs(d2), f"{len(segs(oom))} segments")
    for label, run in (("depth 2", d2), ("depth 1", d1)):
        for k in PATH_KERNELS["depth"]:
            if run["launches"][k] <= 0:
                fail(f"depth: kernel {k} was not launched at {label}")
    summary = {
        label: dict(
            wall_s=run["wall"], peak_bytes=run["peak"],
            parse_s=[p["seconds"] for p in run["parses"]],
            parse_in_helper=[p["helper"] for p in run["parses"]],
            parse_overlapping_dispatch_s=[p["overlap_dispatch_s"]
                                          for p in run["parses"]],
            parse_overlapping_decode_s=[p["overlap_decode_s"]
                                        for p in run["parses"]],
            launches={k: n for k, n in run["launches"].items() if n})
        for label, run in (("depth2", d2), ("depth1", d1), ("oom", oom))}
    summary.update(audio_s=d2["res"]["duration"], windows=6,
                   batch=DEPTH_BATCH, batches=n_batches,
                   oom_decode_calls=len(calls))
    print("depth " + json.dumps(summary), flush=True)
    (OUT / "depth.json").write_text(json.dumps(summary, indent=2))
    return d2["launches"]


# ---------------------------------------------------------------------------
# tools path
# ---------------------------------------------------------------------------

#: the shipped diarizer's clustering threshold (diarize/pipeline.py)
SHIPPED_THRESHOLD = 0.53
#: calibrate's card-against-CPU limit on one seed's cosine similarities;
#: the log-mel rounded to bf16 before the net moves them 1.6e-3 (CPU run)
CALIBRATE_TOL = 5e-4


def golden_job(root: Path) -> None:
    """A one-job golden directory in the reference pipeline's layout: a
    job's JSON (5-key segments, 5-key metadata), SRT and HTML."""
    segments = [
        {"text": "good morning everyone", "start": 0.4, "end": 3.1,
         "speaker": "SPEAKER_00", "confidence": 0.91},
        {"text": "thanks for joining", "start": 3.6, "end": 6.2,
         "speaker": "SPEAKER_01", "confidence": 0.88},
        {"text": "let us begin", "start": 7.0, "end": 10.5,
         "speaker": "SPEAKER_00", "confidence": 0.93}]
    golden = {"segments": segments, "metadata": {
        "audio_file": "standup.wav", "pipeline_version": "1.0",
        "confidence_threshold": 0.7, "language": "en",
        "total_segments": len(segments)}}
    job = root / "job_0"
    job.mkdir(parents=True)
    (job / "standup.json").write_text(json.dumps(golden))
    (job / "standup.srt").write_text("".join(
        f"{i + 1}\n00:00:00,000 --> 00:00:01,000\n{s['text']}\n\n"
        for i, s in enumerate(segments)))
    (job / "standup.html").write_text("<html><body></body></html>")


def tools_phase(dev, eng):
    """The port's repo tools on the card (whisper_aries_tpu_torch/scripts/),
    each main() in this process with counts from 0 (chip_smoke_out/cli/
    <tool>.log): calibrate_emb_threshold on the shipped weights (its
    threshold and pair accuracy beside the shipped 0.53; the mel kernel
    launched), with one seed's similarities on the card held against the
    CPU's within CALIBRATE_TOL; sweep_cluster_threshold at 0.53 and 0.60
    over one development scene; make_sample_audio into chip_smoke_out/,
    its bytes the checked-in examples/sample_audio.wav's; setup_environment
    --check-only (no pip: it reports, builds, verifies); then
    parity_vs_goldens.run_job in mock mode (12 s cap) on a one-job golden
    directory written here, through run_pipeline with the beam slice's
    engine and a card diarizer (every kernel of the path launched, no
    structure problem). Prints the ``tools`` line (each tool's seconds,
    rc and launches, the readings). Returns the launches summed over the
    tools."""
    import argparse
    import shutil

    import torch
    from whisper_aries_tpu_torch.config import load_config
    from whisper_aries_tpu_torch.scripts import calibrate_emb_threshold as CT
    from whisper_aries_tpu_torch.scripts import make_sample_audio as MS
    from whisper_aries_tpu_torch.scripts import parity_vs_goldens as PG
    from whisper_aries_tpu_torch.scripts import setup_environment as SE
    from whisper_aries_tpu_torch.scripts import sweep_cluster_threshold as SW
    from whisper_aries_tpu_torch.utils.params_io import default_weights_dir

    work = OUT / "tools"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    (OUT / "cli").mkdir(parents=True, exist_ok=True)
    wdir = str(default_weights_dir())
    tools: dict = {}
    total: Counter = Counter()

    _, out, _, launches = run_tool(tools, "calibrate_emb_threshold", CT.main,
                                   [wdir], ("mel",))
    total.update(launches)
    line = next(s for s in out.splitlines() if s.startswith("calibrated"))
    nums = [float(x) for x in line.replace("=", " ").split()
            if x.replace(".", "", 1).isdigit()]
    tools["calibrate_emb_threshold"].update(
        threshold=nums[0], pair_accuracy=nums[1], shipped=SHIPPED_THRESHOLD,
        printed=out.strip().splitlines())
    audio = CT.utterances(CT.SEEDS[0])
    n = (CT.N_SPK, CT.N_UTT)
    on_card = CT.load_embedding(wdir, dev)
    got, same = CT.similarities(on_card, audio, *n)
    want, _ = CT.similarities(CT.load_embedding(wdir, "cpu"), audio, *n)
    mistake, _ = CT.similarities(on_card, audio, *n,
                                 mel_dtype=torch.bfloat16)
    err, mis = float(np.abs(got - want).max()), float(
        np.abs(mistake - want).max())
    tools["calibrate_emb_threshold"].update(
        similarity_err=err, similarity_tol=CALIBRATE_TOL,
        similarity_mistake=mis, pairs=int(len(got)), same_pairs=int(
            same.sum()))
    held("tools: calibrate's similarities, card against CPU (seed 30000)",
         {"max_abs": err}, {"max_abs": CALIBRATE_TOL},
         {"max_abs": mis})

    _, out, _, launches = run_tool(tools, "sweep_cluster_threshold",
                                   SW.main, [wdir, "0.53,0.60", "1"])
    total.update(launches)
    sweep = json.loads(out.strip().splitlines()[-1])
    tools["sweep_cluster_threshold"]["result"] = sweep
    if sorted(sweep) != ["0.53", "0.6"] or not all(
            math.isfinite(v["clean"]) and math.isfinite(v["aug"])
            for v in sweep.values()):
        fail(f"tools: the sweep's result is not two finite rows: {sweep}")

    sample = work / "sample_audio.wav"
    _, _, _, launches = run_tool(tools, "make_sample_audio", MS.main,
                                 [str(sample)])
    total.update(launches)
    same_bytes = sample.read_bytes() == (
        ROOT / "examples" / "sample_audio.wav").read_bytes()
    tools["make_sample_audio"]["bytes_equal"] = same_bytes
    check("tools: make_sample_audio = examples/sample_audio.wav, bytes",
          same_bytes, f"{sample.stat().st_size} bytes")

    _, _, _, launches = run_tool(tools, "setup_environment", SE.main,
                                 ["--check-only"])
    total.update(launches)

    goldens = work / "goldens"
    golden_job(goldens)
    job = PG.find_golden_jobs(goldens)[0]
    cfg = load_config(overrides=dict(SLICE_CONFIG["beam"], **{
        "analyze.api_key_env": NO_KEY}))
    args = argparse.Namespace(out=str(work / "parity"), audio_dir=None,
                              mock_cap_seconds=12.0, device=None)
    rep, wall, launches = counted(PG.run_job, job, args, eng, cfg)
    torch.cuda.empty_cache()
    total.update(launches)
    tools["parity_vs_goldens.run_job"] = dict(
        wall_s=wall, report=rep,
        launches={k: v for k, v in launches.items() if v})
    if not (rep["pipeline_success"] and rep["mock_audio"]
            and rep.get("structure_problems") == []):
        fail(f"tools: the parity harness's mock job failed: {rep}")
    for k in PATH_KERNELS["tools"]:
        if launches[k] <= 0:
            fail(f"tools: kernel {k} was not launched by the parity job")
    print("tools " + json.dumps(tools), flush=True)
    (OUT / "tools.json").write_text(json.dumps(tools, indent=2))
    return dict(total)


# ---------------------------------------------------------------------------
# train path
# ---------------------------------------------------------------------------

#: the train path's Whisper batch: 2 windows, S target tokens a window,
#: the second window's last 48 positions masked
TRAIN_S = 448
#: the diarizer trainers' steps and data (small n: the nets at their
#: published dims memorise it, so each loss falls within tens of steps)
DIARIZER_RUNS = {
    "vad": dict(steps=30, batch=8, n_train=16, n_val=4, log_every=10),
    "segmentation": dict(steps=20, batch=4, n_train=8, n_val=4,
                         log_every=10),
    "embedding": dict(steps=30, n_batches=2, log_every=10),
}
#: the DER gate of tests/test_der.py:146-147 (clean, augmented)
DER_GATE = {"clean": 0.45, "augmented": 0.75}


def falling(losses) -> bool:
    """The mean of the last 5 losses below the mean of the first 5."""
    return float(np.mean(losses[-5:])) < float(np.mean(losses[:5]))


def whisper_train(dev, report: dict) -> None:
    """Three make_train_step steps of Whisper large-v3 at its published
    widths, f32 seeded random params on the card, on a fixed batch: the
    mels of 2 windows of the synthetic WAV by the mel kernel, TRAIN_S
    random target tokens a window. The loss must be finite and fall at
    each step, and each step must launch the training attention forward
    and backward once an encoder layer (32 each)."""
    import gc

    import torch
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops.mel import log_mel
    from whisper_aries_tpu_torch.pipeline.train import make_train_step
    from whisper_aries_tpu_torch.utils.params_io import flatten_params

    dims = W.PRESETS["large-v3"]
    t0 = time.time()
    params = W.init_params(dims, seed=0, device=dev)
    audio = torch.as_tensor(synth_audio(60.0, 7).reshape(2, 480_000),
                            device=dev)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, dims.n_vocab, (2, TRAIN_S + 1)),
                             device=dev)
    mask = torch.ones((2, TRAIN_S), device=dev)
    mask[1, TRAIN_S - 48:] = 0.0
    batch = {"mel": log_mel(audio, dims.n_mels), "tokens_in": tokens[:, :-1],
             "tokens_tgt": tokens[:, 1:], "mask": mask}
    init, step, _ = make_train_step(dims, [dev], timing=True)
    opt = init(params)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    fwd, bwd = W.encoder_attn_train_fwd_kernel, W.encoder_attn_train_bwd_kernel
    steps = []
    for i in range(3):
        torch.cuda.reset_peak_memory_stats(dev)
        f0, b0 = fwd.launches, bwd.launches
        params, opt, loss = step(params, opt, batch)
        st = dict(step.last_stats, loss=float(loss),
                  peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                  attn_fwd_launches=fwd.launches - f0,
                  attn_bwd_launches=bwd.launches - b0)
        steps.append(st)
        print(f"train step {i}: " + json.dumps(st), flush=True)
        if not math.isfinite(st["loss"]):
            fail(f"train: large-v3 step {i} loss is not finite")
        if (st["attn_fwd_launches"], st["attn_bwd_launches"]) != (32, 32):
            fail(f"train: step {i} launched the training attention "
                 f"{st['attn_fwd_launches']} / {st['attn_bwd_launches']} "
                 "times, not 32 / 32")
    losses = [st["loss"] for st in steps]
    if not losses[0] > losses[1] > losses[2]:
        fail(f"train: the large-v3 loss did not fall: {losses}")
    n_params = sum(t.numel() for t in flatten_params(params).values())
    report["whisper"] = dict(dims="large-v3", params=n_params,
                             batch=f"2 windows x {TRAIN_S} tokens",
                             setup_s=setup_s, steps=steps, losses=losses,
                             lr=1e-5, weight_decay=0.01)
    del params, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()


def train_state(dev, report: dict) -> None:
    """The train state at large-v3's widths, 2 + 2 layers: one step, then
    save_train_state and restore_train_state (to the CPU) bit for bit."""
    import dataclasses
    import gc
    import shutil

    import torch
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.pipeline.checkpoint import (
        restore_train_state,
        save_train_state,
    )
    from whisper_aries_tpu_torch.pipeline.train import make_train_step
    from whisper_aries_tpu_torch.utils.params_io import flatten_params

    dims = dataclasses.replace(W.PRESETS["large-v3"], n_audio_layer=2,
                               n_text_layer=2)
    params = W.init_params(dims, seed=1, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"mel": torch.randn((1, dims.n_mels, 3000), generator=g,
                                device=dev),
             "tokens_in": torch.arange(16, device=dev)[None],
             "tokens_tgt": torch.arange(1, 17, device=dev)[None],
             "mask": torch.ones((1, 16), device=dev)}
    init, step, _ = make_train_step(dims, [dev])
    opt = init(params)
    params, opt, _ = step(params, opt, batch)
    root = OUT / "train_state"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.time()
    path = save_train_state(str(root), 1, params, opt)
    t1 = time.time()
    step_no, state = restore_train_state(str(root))
    t2 = time.time()
    same = lambda a, b: all(
        a[k].dtype == b[k].dtype and a[k].cpu().numpy().tobytes()
        == b[k].cpu().numpy().tobytes() for k in b) and set(a) == set(b)
    ok = (step_no == 1 and same(flatten_params(state["params"]),
                                flatten_params(params))
          and same(state["opt_state"]["mu"], opt["mu"])
          and same(state["opt_state"]["nu"], opt["nu"])
          and state["opt_state"]["count"] == opt["count"] == 1)
    size = sum(f.stat().st_size for f in Path(path).iterdir())
    check("train state[2 + 2 layers, save / restore]", ok,
          f"{size / 1e9:.2f} GB bit for bit")
    report["train_state"] = dict(layers="2 + 2", bytes=size,
                                 save_s=t1 - t0, restore_s=t2 - t1)
    shutil.rmtree(root, ignore_errors=True)
    del params, opt, state
    gc.collect()
    torch.cuda.empty_cache()


def diarizer_train(dev, report: dict) -> None:
    """train_vad, train_segmentation and train_embedding on the card at the
    nets' published dims (DIARIZER_RUNS), each loss falling, each net
    written by _save_verified into chip_smoke_out/trained/; then
    run_battery with the shipped weights on 2 scenes of 15 s, clean and
    augmented, its DER held to DER_GATE."""
    from whisper_aries_tpu_torch.diarize.pipeline import DiarizationPipeline
    from whisper_aries_tpu_torch.eval.diarize_battery import run_battery
    from whisper_aries_tpu_torch.ops import mel as M
    from whisper_aries_tpu_torch.training import diarize_train as DT

    trainers = {"vad": DT.train_vad, "segmentation": DT.train_segmentation,
                "embedding": DT.train_embedding}
    out = OUT / "trained"
    for name, fn in trainers.items():
        m0 = M.mel_power_kernel.launches
        t0 = time.time()
        params, metrics = fn(device=dev, **DIARIZER_RUNS[name])
        wall = time.time() - t0
        DT._save_verified(str(out / f"{name}.safetensors"), params)
        losses = metrics.pop("losses")
        rep = dict(DIARIZER_RUNS[name], seconds=wall,
                   loss_first=losses[0], loss_last=losses[-1],
                   loss_first5=float(np.mean(losses[:5])),
                   loss_last5=float(np.mean(losses[-5:])),
                   mel_launches=M.mel_power_kernel.launches - m0,
                   metrics=metrics)
        print(f"train {name}: " + json.dumps(rep), flush=True)
        if not falling(losses):
            fail(f"train: the {name} loss did not fall: {losses}")
        if name != "vad" and rep["mel_launches"] <= 0:
            fail(f"train: {name} did not launch the mel kernel")
        report[name] = rep
    t0 = time.time()
    bat = run_battery(DiarizationPipeline(device=dev), n_scenes=2, seed=7000,
                      dur_s=15.0, collar_s=0.25,
                      conditions=list(DER_GATE))
    report["battery"] = dict(
        seconds=time.time() - t0, scenes=2, dur_s=15.0, seed=7000,
        **{f"{c}_der": bat[f"{c}_der"] for c in DER_GATE},
        per_scene=[{c: r[c]["der"] for c in DER_GATE} for r in bat["scenes"]])
    print("train battery: " + json.dumps(report["battery"]), flush=True)
    for c, gate in DER_GATE.items():
        if not bat[f"{c}_der"] < gate:
            fail(f"train: the battery's {c} DER {bat[c + '_der']:.3f} is "
                 f"not below {gate}")


def train_phase(dev):
    """The train path, counts from 0 over all of it: the large-v3 train
    steps, the train state, the diarizer's trainers and the battery.
    Prints the ``train`` line; returns the launches."""
    import gc

    import torch

    gc.collect()  # the earlier phases' engines
    torch.cuda.empty_cache()
    report: dict = {}

    def run():
        whisper_train(dev, report)
        train_state(dev, report)
        diarizer_train(dev, report)

    _, wall, launches = counted(run)
    for k in PATH_KERNELS["train"]:
        if launches[k] <= 0:
            fail(f"train: kernel {k} was not launched")
    report["wall_s"] = wall
    report["launches"] = {k: n for k, n in launches.items() if n}
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "train.json").write_text(json.dumps(report, indent=2))
    print("train " + json.dumps(report), flush=True)
    return launches


# ---------------------------------------------------------------------------
# speculative path
# ---------------------------------------------------------------------------

# the verify step held at large-v3: 16 windows, 4 drafted tokens a window
# (R 64), a 256-position self cache (attn_split: 8 splits of 32 keys);
# pos .. pos + 3 crosses a split boundary at both positions
SPEC_B, SPEC_S, SPEC_T = 16, 4, 256
SPEC_CASES = ((30, 0), (62, 2))


class key_one_past:
    """A mistake the verify step's limits must catch: each drafted query
    of the plain version also sees the key one past its own position (its
    neighbour's draft; never past the drafted block)."""

    def __enter__(self):
        from whisper_aries_tpu_torch.models import whisper as W

        self.W, self.right = W, W.multi_token_mask

        def shifted(group, n_draft, pos, vs, Tmax, minor, n_groups):
            m = self.right(group, n_draft, pos + 1, vs, Tmax, minor,
                           n_groups).clone()
            m[..., pos + n_draft:] = W.NEG
            return m

        W.multi_token_mask = shifted

    def __exit__(self, *exc):
        self.W.multi_token_mask = self.right


def self_attn_block_early(qkv, cache_l, pos, vs, n_head, queries):
    """A mistake the verify step's limits must catch: the plain verify
    self-attention scoring the drafted block's lanes pos .. pos + S - 1 as
    they stood before this launch appended them (stale lanes), then
    appending."""
    import torch
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    before = clone(cache_l)
    qw, _, _ = DL._append_self(qkv, cache_l, pos, n_head, queries)
    ckv = before["kv8"] if "kv8" in before else before["kv"]
    att = DL._self_attend(
        qw, ckv, before.get("ksc"), pos, vs, queries,
        lambda lg: torch.softmax(lg, dim=-1),
        lambda pr, v: torch.einsum("rht,rhtd->rhd", pr.float(), v.float()))
    return att.reshape(qkv.shape[0], -1).to(qkv.dtype)


def verify_one_token_steps(x, wpack, cache, cross, vs, pos, H, S):
    """S consecutive one-token kernel steps at pos .. pos + S - 1, query
    s of each window its x row: the bits the verify step must give."""
    import torch
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    B, d = x.shape[0] // S, x.shape[1]
    xs = x.view(B, S, d)
    return torch.stack([DL.fused_decoder_layers(
        xs[:, s].contiguous(), wpack, cache, cross, vs, pos + s, H)
        for s in range(S)], dim=1).view(B * S, d)


def hold_verify(dev, self_int8: bool) -> dict:
    """The verify step (kernel 3 at S 4 queries a cache row) at large-v3,
    16 windows, T 256, every lane of the self cache random (stale drafts
    past pos), at pos 30 / valid_start 0 and pos 62 / valid_start 2:
      * its self-attention part against the plain version in bf16 steps,
        below both named mistakes (a drafted query seeing the key one past
        its own position; the drafted block's keys read before this launch
        appended them), the appended lanes the plain version's bits;
      * the 32 layers teacher-forced per layer against the plain layer,
        as the one-token step (below the cross tail dropped);
      * bit for bit the x and the cache of 4 one-token steps;
      * a graph replay bit for bit a direct launch;
      * a verify at pos accepting 1 of 4, then one at pos + 1 over the
        rejected drafts' lanes: the bits of fresh one-token steps.
    Returns the max abs error, the plain version's ms and the bound."""
    import torch
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    B, S, T = SPEC_B, SPEC_S, SPEC_T
    R = B * S
    dims, _, wpack, cross, cache, g = decode_inputs(
        dev, B, T, self_int8, seed=4, windows=B, T=T)
    H, L, d = dims.n_text_head, dims.n_text_layer, dims.n_text_state
    tag = f"verify S {S}, {'int8' if self_int8 else 'bf16'} self cache"
    sl = lambda tree, l: {k: v[l:l + 1] for k, v in tree.items()}
    rnd = lambda scale=1.0: (scale * torch.randn(
        (R, d), generator=g, device=dev)).to(torch.bfloat16)
    # (1) the self-attention part, layer 0's cache
    part_tol = {"bf16_steps": 1.5, "flipped": 2e-3}
    c0 = sl(cache, 0)
    c0 = {k: v[0].contiguous() for k, v in c0.items()}
    for pos, vs in SPEC_CASES:
        qkv = (0.5 * torch.randn((R, 3 * d), generator=g, device=dev)).to(
            torch.bfloat16)
        ck, cp, c_past, c_early = (clone(c0) for _ in range(4))
        got = DL.self_attn_kernel(qkv, ck, pos, vs, H, queries=S)
        want = DL.self_attn_plain(qkv, cp, pos, vs, H, queries=S)
        with key_one_past():
            past = DL.self_attn_plain(qkv, c_past, pos, vs, H, queries=S)
        early = self_attn_block_early(qkv, c_early, pos, vs, H, S)
        errs = bf16_steps(got, want)
        held(f"{tag} self_attn part, pos {pos}, valid_start {vs}: "
             "a drafted query sees the key one past its own position",
             errs, part_tol, bf16_steps(past, want))
        held(f"{tag} self_attn part, pos {pos}, valid_start {vs}: the "
             "drafted block's keys read before this launch appended them",
             errs, part_tol, bf16_steps(early, want))
        check(f"{tag} self_attn part append, pos {pos}",
              all(torch.equal(ck[k], cp[k]) for k in ck),
              "appended lanes identical to the plain version's")
    # (2) the layers, teacher-forced per layer
    tols = {"max_rel": 3e-2, "mean_rel": 1e-2}
    errs = {"max_rel": 0.0, "mean_rel": 0.0}
    mistake = {"mean_rel": math.inf}
    worst_abs = 0.0
    cross_m = tail_dropped(cross)
    for pos, vs in SPEC_CASES:
        ck, cp, cm = clone(cache), clone(cache), clone(cache)
        for l in range(L):
            xin = rnd(0.25)
            args = (sl(wpack, l),)
            got = DL.fused_decoder_layers(xin, *args, sl(ck, l),
                                          sl(cross, l), vs, pos, H, queries=S)
            want = DL.fused_decoder_layers_plain(
                xin, *args, sl(cp, l), sl(cross, l), vs, pos, H, queries=S)
            wrong = DL.fused_decoder_layers_plain(
                xin, *args, sl(cm, l), sl(cross_m, l), vs, pos, H, queries=S)
            worst_abs = max(worst_abs, float(
                (got.float() - want.float()).abs().max()))
            errs["max_rel"] = max(errs["max_rel"], max_rel(got, want))
            errs["mean_rel"] = max(errs["mean_rel"], mean_rel(got, want, xin))
            mistake["mean_rel"] = min(mistake["mean_rel"],
                                      mean_rel(wrong, want, xin))
        del ck, cp, cm
    held(f"{tag} x, {L} layers x 2 positions", errs, tols, mistake)
    del cross_m
    # (3) bits of 4 one-token steps, the whole stack
    for pos, vs in SPEC_CASES:
        x = rnd()
        c1, c2 = clone(cache), clone(cache)
        a = DL.fused_decoder_layers(x, wpack, c1, cross, vs, pos, H,
                                    queries=S)
        b = verify_one_token_steps(x, wpack, c2, cross, vs, pos, H, S)
        same = torch.equal(a, b) and all(torch.equal(c1[k], c2[k])
                                         for k in c1)
        check(f"{tag} = {S} one-token steps, bitwise, pos {pos}", same,
              "x and every cache lane identical" if same else "differ")
        del c1, c2
    # (4) a graph replay against a direct launch
    pos, vs = SPEC_CASES[1]
    cg_, cd = clone(cache), clone(cache)
    graph = DL.DecodeStepGraph(wpack, cg_, cross, R, H, vs, queries=S)
    same = True
    for p in (pos, pos + 1, pos + 4):
        x = rnd()
        same &= torch.equal(graph.run(x, p), DL.fused_decoder_layers(
            x, wpack, cd, cross, vs, p, H, queries=S))
        same &= all(torch.equal(cg_[k], cd[k]) for k in cd)
    check(f"{tag} graph replay = direct launch, bitwise", same,
          "3 positions" if same else "differ")
    del graph, cg_, cd
    # (5) stale lanes: accept 1 of 4 at pos, verify again at pos + 1
    pos, vs = SPEC_CASES[0]
    x, y = rnd(), rnd()
    c1, c2 = clone(cache), clone(cache)
    DL.fused_decoder_layers(x, wpack, c1, cross, vs, pos, H, queries=S)
    a = DL.fused_decoder_layers(y, wpack, c1, cross, vs, pos + 1, H,
                                queries=S)
    DL.fused_decoder_layers(x.view(B, S, d)[:, 0].contiguous(), wpack, c2,
                            cross, vs, pos, H)
    b = verify_one_token_steps(y, wpack, c2, cross, vs, pos + 1, H, S)
    lanes = slice(0, pos + 1 + S)
    same = torch.equal(a, b) and all(
        torch.equal(c1[k][:, :, :, :, lanes], c2[k][:, :, :, :, lanes])
        for k in c1)
    check(f"{tag} over a rejected draft's lanes = fresh one-token steps, "
          "bitwise", same, f"verify at {pos} accepting 1, then at {pos + 1}"
          if same else "differ")
    del c1, c2
    out = {"max_abs_err": worst_abs, "tolerance": dict(
        self_attn_part=part_tol, x=tols)}
    if self_int8:
        # where the time goes: the verify step and the one-token step over
        # the same 16 windows, by kernel (the sweep's position)
        x, pos = rnd(), 128
        profile_graph_step(f"verify S {S}, B {B}", wpack, cache, cross, H, R,
                           x, pos, queries=S)
        profile_graph_step(f"one token, B {B}", wpack, cache, cross, H, B,
                           x[:B].contiguous(), pos)
        out["plain_ms"] = time_ms(lambda: DL.fused_decoder_layers_plain(
            x, wpack, cache, cross, 0, pos, H, queries=S), 3, warmup=1)
    del dims, wpack, cross, cache
    return out


def spec_phase(dev, entries):
    """14. The speculative path: the verify step held (hold_verify) on both
    self-cache dtypes, then bench_speculative.main() at its defaults (the
    synthetic-acceptance chains and the S sweep) with every launch count
    set to 0 just before and read just after. Prints the ``speculative``
    line; appends the verify mode's kernels entry; returns the launches."""
    import gc

    import torch
    from whisper_aries_tpu_torch.decoding import drafter as DR
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.scripts import bench_speculative as BS

    gc.collect()  # the earlier phases' models
    torch.cuda.empty_cache()
    t0 = time.time()
    held_by = {tag: hold_verify(dev, int8) for tag, int8 in
               (("bf16", False), ("int8", True))}
    hold_s = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    DR.ngram_draft.calls = 0
    out, wall, launches = counted(BS.main, [])
    drafts = DR.ngram_draft.calls
    for k in PATH_KERNELS["speculative"]:
        if launches[k] <= 0:
            fail(f"speculative: kernel {k} was not launched")
    knobs = BS.knobs()
    # the speculative chain twice (untimed, timed), the sweep's S > 1
    want = (2 * knobs["steps"] + sum(S > 1 for S in BS.SWEEP_S)
            * (BS.SWEEP_WARMUP + BS.SWEEP_REPS))
    if launches["decode_layers_verify"] != want:
        FAILED.append(f"speculative: {launches['decode_layers_verify']} "
                      f"verify launches, not {want}")
    sweep = out["sweep"]
    dims = W.PRESETS["large-v3"]
    traffic = BS.verify_traffic(dims, knobs["B"], knobs["S"], BS.SWEEP_POS)
    b_ms, b_by = bound(traffic["bytes"], traffic["ops"], PEAK_BF16)
    report = dict(
        hold_s=hold_s, wall_s=wall, bench=out["bench"], sweep_ms=sweep["ms"],
        cost_over_s1=sweep["cost_over_s1"],
        launches={"verify_replays": launches["decode_layers_verify"],
                  "decode_layers": launches["decode_layers"],
                  "graph_replays": launches["graph_replays"],
                  "drafter_calls": drafts},
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "speculative.json").write_text(json.dumps(report, indent=2))
    print("speculative " + json.dumps(report), flush=True)
    S = knobs["S"]
    entries.append(dict(
        name="decode_layers_verify", route="cuda",
        source="whisper_aries_tpu_torch/csrc/decode_layers.cu",
        replaces="whisper_aries_tpu/models/whisper.py:1382",
        also_replaces="whisper_aries_tpu/ops/pallas_decode_layers.py:775",
        max_abs_err=max(h["max_abs_err"] for h in held_by.values()),
        tolerance=held_by["int8"]["tolerance"],
        ms=sweep["ms"][S], plain_ms=held_by["int8"]["plain_ms"],
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ms_by_s=sweep["ms"], bound_ms_by_s=sweep["bound_ms"],
        one_token_ms=sweep["ms"][1],
        shape=(f"one verify step, all 32 layers, {knobs['B']} windows x S "
               f"{S} drafted tokens (R {knobs['B'] * S}), pos "
               f"{BS.SWEEP_POS}, T {BS.CACHE_LEN}, int8 self cache; ms a "
               "CUDA graph replay (bench_speculative.cost_sweep); plain_ms "
               "the plain version at pos 128")))
    return launches


def main() -> None:
    import torch

    t_start = time.time()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a card")
    try:
        from whisper_aries_tpu_torch.ops import cuda_build
    except ImportError as e:
        fail(f"run from the root of a checkout of the repository ({e})")
    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    from concurrent.futures import ThreadPoolExecutor

    from whisper_aries_tpu_torch.audio import _native

    # the host library (codecs, resampler, DTW): built by g++ from the
    # port's sources, loaded, and each dlopen'd codec's system library
    # looked for
    t0 = time.time()
    _native.library()
    print("native build: " + json.dumps(dict(
        library=str(_native.LIB_PATH.relative_to(ROOT)),
        sources=[s.name for s in _native.sources()],
        seconds=time.time() - t0, libavformat_headers=_native.av_headers(),
        codecs={k: _native.codec_available(k)
                for k in _native.CODEC_LIBRARIES})), flush=True)
    # the serve path's FLAC is encoded while nvcc runs (the main thread
    # waits on its processes) and is waited for before any timed phase
    with ThreadPoolExecutor(1) as pool:
        scene_job = pool.submit(scene_blobs)
        t0 = time.time()
        built = cuda_build.build()
        print(f"build: {json.dumps(built)} in {time.time() - t0:.1f}s",
              flush=True)
        t0 = time.time()
        scene = scene_job.result()
    print(f"scene encoded beside the build: FLAC {scene[2]:.1f}s "
          f"({'cached' if scene[3] else 'encoded'}), waited "
          f"{time.time() - t0:.1f}s after the build", flush=True)
    for name in cuda_build.SOURCES:
        log = cuda_build.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")

    entries, parts = [], []
    kernel_mel(dev, entries)
    kernel_encoder_attn(dev, entries)
    kernel_encoder_attn_train(dev, entries)
    kernel_decode_layers(dev, entries, parts)
    kernel_cross_attn(dev, entries)
    kernel_beam_tail(dev, entries)
    kernel_reorder(dev, entries)
    kernel_quant_matmul(dev, entries)
    kernel_int8_gemm(dev, entries)
    kernel_self_attn(dev, entries)
    conditioned_phase(dev, entries, parts)
    for B in (6, 8):  # the slice's 6 windows; a full batch of 8
        profile_beam_step(dev, parts, B)
    profile_unfused_step(dev, parts)
    print("decode_layer_parts " + json.dumps(parts), flush=True)
    probe_launches = probes_phase(dev, entries)
    runs = {path: slice_phase(dev, path, keep=path == "beam")
            for path in PATH_KERNELS
            if path not in ("checkpoint", "pipeline", "serve", "cli",
                            "depth", "tools", "train", "speculative")}
    beam_engine, runs["beam"] = runs["beam"][2], runs["beam"][:2]
    *runs["checkpoint"], ckpt = checkpoint_phase(dev)
    runs["pipeline"] = (pipeline_phase(dev, beam_engine), {})
    runs["serve"] = (serve_phase(dev, beam_engine, scene), {})
    runs["cli"] = (cli_phase(dev, ckpt, beam_engine), {})
    runs["depth"] = (depth_phase(dev, beam_engine), {})
    runs["tools"] = (tools_phase(dev, beam_engine), {})
    del beam_engine
    runs["train"] = (train_phase(dev), {})
    runs["speculative"] = (spec_phase(dev, entries), {})
    launches = {path: run[0] for path, run in runs.items()}
    launches["probes"] = probe_launches
    paths = dict(PATH_KERNELS, probes=PROBE_KERNELS)
    if FAILED:
        fail("; ".join(FAILED))
    for e in entries:
        # the launches of the first path that needs the kernel; every
        # path's count beside
        path = next(p for p, ks in paths.items() if e["name"] in ks)
        e["launches"] = launches[path][e["name"]]
        e["launches_by_path"] = {p: n[e["name"]] for p, n in launches.items()}
        if e["name"] == "quant_matmul":  # by GEMM path, in each int8 slice
            e["gemm_paths"] = {p: run[1] for p, run in runs.items()
                               if launches[p]["quant_matmul"]}
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "kernels.json").write_text(json.dumps(entries, indent=2))
    print(f"chip_smoke: {time.time() - t_start:.1f} s from start to the "
          "kernels line", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
