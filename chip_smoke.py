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
     per source, all in parallel.
  3. kernels: hold each kernel against its plain PyTorch version on the card
     at the main path's large-v3 shapes (mel at B=8, encoder attention at
     (8, 20, 1500, 64) bf16, the decoder-layer kernels at R=8 for both
     self-cache dtypes over several positions), and time kernel, plain
     version and, where one exists, the one-call PyTorch yardstick; the
     decode step is also timed at R=30. Errors are taken over max |want|,
     and where a check names a mistake (keys past T scored, a dropped tail,
     a missing key), the same error of a plain version making that mistake
     must exceed the limit.
  4. slice: transcribe a synthetic ~2-minute WAV (made from a seed) at
     large-v3 width with seeded random weights through
     AriesTranscriber.transcribe_file on the config defaults (VAD, greedy,
     temperature ladder, txt/json/srt), with every launch count set to 0
     just before and read just after; every kernel must have launched.
The second-to-last lines are the card line and the kernels JSON; the last
line is {"ok": true, "device": {...}}. Outputs go to chip_smoke_out/.

It exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chip_smoke_out"

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BYTES = 3.35e12          # HBM3, bytes/s
PEAK_BF16 = 989e12            # tensor-core bf16 FLOP/s
PEAK_F32 = 67e12              # f32 FLOP/s outside the tensor cores


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


def kernel_mel(dev, entries):
    import torch
    from whisper_aries_tpu_torch.audio.mel import log_mel_spectrogram
    from whisper_aries_tpu_torch.ops import mel as M

    B, n_mels = 8, 128
    audio = torch.as_tensor(np.stack([synth_audio(30.0, 100 + i)
                                      for i in range(B)]), device=dev)
    got = M.log_mel(audio, n_mels)
    want = log_mel_spectrogram(audio, n_mels)
    # a mistake the limit must catch: every frame off by one sample
    shifted = log_mel_spectrogram(torch.roll(audio, 1, dims=-1), n_mels)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        fail("mel kernel output is not finite")
    err = float((got - want).abs().max())
    held("mel", {"max_abs": err, "mean_abs": float((got - want).abs().mean())},
         {"max_abs": 5e-4, "mean_abs": 2e-6},
         {"mean_abs": float((shifted - want).abs().mean())})
    ms = time_ms(lambda: M.log_mel(audio, n_mels), 20)
    plain_ms = time_ms(lambda: log_mel_spectrogram(audio, n_mels), 20)
    n_frames = 3000
    # the function's least work per frame: a 400-point real FFT
    # (2.5 N log2 N operations), the Hann product, power over 201 bins, the
    # 201 x n_mels mel product and the log; the kernel's own design does a
    # DFT as a product (2 x 400 x 402 per frame), reported beside it
    fft_ops = 2.5 * 400 * math.log2(400)
    ops = B * n_frames * (fft_ops + 400 + 3 * 201 + 2 * 201 * n_mels + n_mels)
    dft_ops = B * n_frames * (2 * 400 * 402 + 3 * 201 + 2 * 201 * n_mels)
    nbytes = audio.numel() * 4 + B * n_frames * n_mels * 4
    b_ms, b_by = bound(nbytes, ops, PEAK_F32)
    entries.append(dict(
        name="mel", route="cuda",
        source="whisper_aries_tpu_torch/csrc/mel.cu",
        replaces="whisper_aries_tpu/ops/pallas_mel.py:62",
        max_abs_err=err, tolerance="max |d| < 5e-4, mean |d| < 2e-6",
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        dft_design_bound_ms=bound(nbytes, dft_ops, PEAK_F32)[0],
        library_ms=None, shape=f"audio ({B}, 480000) f32, n_mels {n_mels}"))


def kernel_encoder_attn(dev, entries):
    import torch
    import torch.nn.functional as F
    from whisper_aries_tpu_torch.models import whisper as W

    B, H, T, dh = 8, 20, 1500, 64
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((B, H, T, dh), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    # bf16 outputs rounded from differently ordered f32 sums differ by one
    # step in many elements: mean_rel ~2e-3 (one step is 2^-8..2^-7)
    tol = {"max_rel": 1e-2, "mean_rel": 5e-3}
    err = 0.0
    pad = torch.zeros((B, H, 36, dh), dtype=k.dtype, device=dev)
    # unit q gives nearly flat softmax rows over 1500 keys, where keys past
    # T scored as zero-valued keys show; q x 4 gives peaked rows, where a
    # dropped last tile (or a wrong scale) shows
    mistakes = {1: lambda qs: W.attention_plain(qs, torch.cat([k, pad], 2),
                                                torch.cat([v, pad], 2)),
                4: lambda qs: W.attention_plain(qs, k[:, :, :1472],
                                                v[:, :, :1472])}
    for q_scale, mistake in mistakes.items():
        qs = (q.float() * q_scale).to(torch.bfloat16)
        got = W.encoder_attention_kernel(qs, k, v)
        want = W.attention_plain(qs, k, v)
        wrong = mistake(qs)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got.float()).all()):
            fail("encoder attention output is not finite")
        held(f"encoder_attn[q x {q_scale}]",
             {"max_rel": max_rel(got, want), "mean_rel": mean_rel(got, want)},
             tol, {"max_rel": max_rel(wrong, want),
                   "mean_rel": mean_rel(wrong, want)})
        err = max(err, float((got.float() - want.float()).abs().max()))
        del want, wrong
    ms = time_ms(lambda: W.encoder_attention_kernel(q, k, v), 20)
    plain_ms = time_ms(lambda: W.attention_plain(q, k, v), 5)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
    b_ms, b_by = bound(4 * B * H * T * dh * 2, 4 * B * H * T * T * dh,
                       PEAK_BF16)
    entries.append(dict(
        name="encoder_attn", route="cuda",
        source="whisper_aries_tpu_torch/csrc/encoder_attn.cu",
        replaces="whisper_aries_tpu/models/whisper.py:337",
        max_abs_err=err, tolerance=tol, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f"q, k, v ({B}, {H}, {T}, {dh}) bf16; one call per layer"))


def decode_inputs(dev, R, P, self_int8, seed=0):
    """Large-v3 decoder-layer operands at R rows: int8-packed random
    weights (LayerNorm and bias segments perturbed so they matter), int8
    cross K/V from random encoder output, a self cache holding P random
    positions. Cross-attention's output scale is raised 30x: at random
    init its update to x is ~0.01, under one bf16 step of x, and no check
    of x could see it; raised, it is about as large as the MLP's."""
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
    xa = torch.randn((R, dims.n_audio_ctx, d), generator=g,
                     device=dev).to(torch.bfloat16)
    cross = W.precompute_cross_kv_int8(params, xa, dims)
    L, H, T = dims.n_text_layer, dims.n_text_head, 448
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


def step_bound(dims, R, pos, self_int8):
    """Least time of one decode step (all layers): int8 weights, int8 cross
    K/V with scales, the live self cache, x in and out, each moved once;
    or the products at the bf16 peak, whichever is longer."""
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    L, d, H = dims.n_text_layer, dims.n_text_state, dims.n_text_head
    ff, Ta = 4 * d, dims.n_audio_ctx
    w_bytes = L * (d * 6 * d + 2 * d * ff + DL.vec_offsets(d, ff)[1] * 4)
    cross_bytes = L * R * 2 * H * Ta * (64 + 4)
    elt = 1 if self_int8 else 2
    live = pos + 1
    self_bytes = L * R * 2 * H * live * (64 * elt + (4 if self_int8 else 0))
    nbytes = w_bytes + cross_bytes + self_bytes + 2 * R * d * 2
    ops = 2 * R * L * (6 * d * d + 2 * d * ff) + 4 * R * L * H * 64 * (live + Ta)
    return bound(nbytes, ops, PEAK_BF16)


def kernel_decode_layers(dev, entries, parts):
    import torch
    from whisper_aries_tpu_torch.ops import decode_layers as DL

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
        cross_m = tail_dropped(cross)
        errs = {"max_rel": 0.0, "mean_rel": 0.0}
        mistake = {"mean_rel": math.inf}  # the limit must catch it
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
        ms = time_ms(lambda: DL.fused_decoder_layers(x, wpack, ck, cross, 0,
                                                     pos, H), 20)
        plain_ms = time_ms(lambda: DL.fused_decoder_layers_plain(
            x, wpack, cp, cross, 0, pos, H), 3, warmup=1)
        b_ms, b_by = step_bound(dims, R, pos, self_int8)
        entry = dict(
            name="decode_layers", route="cuda",
            source="whisper_aries_tpu_torch/csrc/decode_layers.cu",
            replaces="whisper_aries_tpu/ops/pallas_decode_layers.py:775",
            max_abs_err=worst_abs,
            tolerance=dict(x=tols, appended=cache_tols),
            stack_max_rel=growth, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=(f"one step, all 32 layers, R {R}, position {pos}, "
                   f"{tag} self cache"))
        # the main path runs the int8 self cache; the bf16 one is reported
        # with the parts
        if self_int8:
            profile_step(f"R {R}", lambda: DL.fused_decoder_layers(
                x, wpack, ck, cross, 0, pos, H))
            del params, cross, cache, ck, cp, cm, cross_m
            entry.update(step_at_rows(dev, 30, P, pos))
            entries.append(entry)
        else:
            parts.append(dict(entry, name="decode_layers[bf16 self cache]"))


def step_at_rows(dev, R, P, pos):
    """The int8-self-cache step at R rows (the fallback ladder's best_of 5
    runs up to ~30 rows), timed and profiled: the GEMMs read each weight
    byte once whatever R is."""
    import torch
    from whisper_aries_tpu_torch.ops import decode_layers as DL

    dims, _, wpack, cross, cache, g = decode_inputs(dev, R, P, True, seed=1)
    H = dims.n_text_head
    x = torch.randn((R, dims.n_text_state), generator=g,
                    device=dev).to(torch.bfloat16)
    step = lambda: DL.fused_decoder_layers(x, wpack, cache, cross, 0, pos, H)
    ms = time_ms(step, 20)
    profile_step(f"R {R}", step)
    b_ms, _ = step_bound(dims, R, pos, True)
    return {f"ms_at_r{R}": ms, f"bound_ms_at_r{R}": b_ms}


def profile_step(label: str, step, n: int = 5) -> None:
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

    rows = []  # the device-side events only (CPU ops would count twice)
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0))
        rows.append((ev.key, dev_us / 1e3 / n, ev.count // n))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"profile decode step {label} " + json.dumps({
        "wall_ms_per_step": wall_ms, "device_ms_per_step": busy,
        "device_busy_share": busy / wall_ms if wall_ms else None,
        "kernels": [{"name": k.replace("(anonymous namespace)::", "")
                     .split("(")[0], "ms_per_step": ms,
                     "launches_per_step": c} for k, ms, c in rows[:8]]}),
        flush=True)


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
    kv8, sc = cross["kv8"][0], cross["sc"][0]
    rec("cross_attn_q8", DL.cross_attn_kernel(x, kv8, sc, H),
        DL.cross_attn_plain(x, kv8, sc, H),
        lambda: DL.cross_attn_kernel(x, kv8, sc, H),
        lambda: DL.cross_attn_plain(x, kv8, sc, H),
        DL.cross_attn_plain(x, tail_dropped(cross)["kv8"][0], sc, H))


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------


def counters():
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops import decode_layers as DL
    from whisper_aries_tpu_torch.ops import mel as M

    return {"mel": M.mel_power_kernel,
            "encoder_attn": W.encoder_attention_kernel,
            "decode_layers": DL.fused_decoder_layers}


def slice_phase(dev):
    import torch
    from whisper_aries_tpu_torch.audio.decode import write_wav
    from whisper_aries_tpu_torch.pipeline.engine import AriesTranscriber

    OUT.mkdir(parents=True, exist_ok=True)
    wav = OUT / "synthetic_2min.wav"
    write_wav(str(wav), synth_audio(125.0, seed=7))
    t0 = time.time()
    eng = AriesTranscriber("large-v3", allow_random=True)  # seed 0
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    if not (eng.fused and eng.kv_int8 and eng.self_kv_int8):
        fail("the engine did not resolve 'auto' to the card's path")
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = eng.transcribe_file(str(wav), output_formats=("txt", "json", "srt"),
                              output_dir=str(OUT))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: fn.launches for k, fn in counters().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decodes = res["performance"].get("decodes", [])
    if res["num_windows"] < 1 or not decodes:
        fail("no window was decoded")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")
    for s in res["segments"]:
        if not (math.isfinite(s["avg_logprob"])
                and math.isfinite(s["no_speech_prob"])
                and 0.0 <= s["start"] < s["end"] <= res["duration"] + 1e-6):
            fail(f"malformed segment {s}")
    for fmt, path in res["output_files"].items():
        if not Path(path).exists():
            fail(f"{fmt} output missing")
    steps = sum(d["steps"] for d in decodes)
    rows_steps = sum(d["steps"] * d["rows"] for d in decodes)
    dec_s = sum(d["seconds"] for d in decodes)
    first = decodes[0]
    summary = dict(
        audio_s=res["duration"], windows=res["num_windows"],
        segments=len(res["segments"]), wall_s=wall, setup_s=setup_s,
        decode_calls=len(decodes), decode_steps=steps,
        tokens_per_step=rows_steps / max(1, steps),
        decode_s=dec_s, ms_per_step=1e3 * dec_s / max(1, steps),
        first_decode=first, launches=launches, peak_mem_gb=peak_gb,
        language=res["language"], real_time_factor=res["real_time_factor"])
    print("slice " + json.dumps(summary), flush=True)
    (OUT / "slice.json").write_text(json.dumps(
        dict(summary, decodes=decodes), indent=2))
    return launches


def main() -> None:
    import torch

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

    t0 = time.time()
    built = cuda_build.build()
    print(f"build: {json.dumps(built)} in {time.time() - t0:.1f}s", flush=True)
    for name in cuda_build.SOURCES:
        log = cuda_build.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")

    entries, parts = [], []
    kernel_mel(dev, entries)
    kernel_encoder_attn(dev, entries)
    kernel_decode_layers(dev, entries, parts)
    print("decode_layer_parts " + json.dumps(parts), flush=True)
    launches = slice_phase(dev)
    if FAILED:
        fail("; ".join(FAILED))
    for e in entries:
        e["launches"] = launches[e["name"]]
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "kernels.json").write_text(json.dumps(entries, indent=2))
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
