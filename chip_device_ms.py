#!/usr/bin/env python3
"""Device milliseconds, kernel by kernel, of the calls that a checkout's
chip_smoke.py times with CUDA events in its kernel phase: for holding a
kernel against the design it replaced, in one call on one card, where the
older chip_smoke.py reports event times only.

    python3 chip_device_ms.py CHECKOUT [PHASE ...]

CHECKOUT is the root of a checkout of this repository; its chip_smoke.py
and its package are imported from there. PHASE names kernel-phase
functions of that chip_smoke.py (default: kernel_mel kernel_cross_attn),
or NAME:ARG for one called with a string in place of the list (the
phases of WITH_PARTS get a second list, for their parts)
(slice_phase:self_int8 runs that slice), or probe:MODULE for a probe
module of that checkout's scripts/ (probe_batched_transpose, probe_dma,
probe_vmem): its kernel wrapper profiled at chip_smoke.py's entry shapes
through the interface every checkout's module shares, and for probe_dma
the two entries interleaved with torch.sum of their source (kernel /
sum / sum / kernel, each the best of 3 runs of 3 back-to-back calls) and
every TPU configuration's rate line
("probe_out " and a JSON object each).
Each phase runs as chip_smoke.py runs it, its checks included, with its
time_ms also profiling every call it times: one line per timed call,
"device_ms " and a JSON object with the phase, the event milliseconds per
call and the device milliseconds per call of each CUDA kernel the call
launched; after each phase, "phase_out " and what it appended to its list
(a kernel's entry, a profiled step's times). The card line comes first.
Needs one CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path


def probe_transpose(smoke, mod, dev, timed) -> None:
    x = mod.inputs(dev)
    for v in mod.VARIANTS:
        timed(f"transpose {v}", lambda: mod.transpose_sum_kernel(x, v), 20)


def probe_dma(smoke, mod, dev, timed) -> None:
    import torch

    C = mod.SOURCE_BYTES // (256 * 8192 * 2)
    for streams in (1, 2):
        r = mod.run(f"entry: bf16 4MB x{streams}", 256, 8192, torch.bfloat16,
                    n_streams=streams, multi=streams > 1, n_iter=C // streams,
                    chunks=C, device=dev)
        smoke.check(f"{mod.__name__} entry x{streams}", r["ok"],
                    f"err {r['err']}")
        src = mod.source(torch.bfloat16, C, 256, 8192, dev)
        extra = {"bands": r["bands"]} if "bands" in r else {}
        if streams > 1:
            kern = lambda: mod.copy_streams_kernel(
                src, r["band"], 8192, r["n_iter"], streams, r["blocks"],
                **extra)
        else:
            kern = lambda: mod.copy_ring_kernel(
                src, r["band"], 8192, r["n_iter"], r["slots"], r["blocks"],
                **extra)
        lib = lambda: torch.sum(src, dtype=torch.float32)
        k1, s1, s2, k2 = (min(mod.common.mean_ms(f, 3) for _ in range(3))
                          for f in (kern, lib, lib, kern))
        timed(f"copy entry x{streams}", kern, 5)
        print("probe_out " + json.dumps(dict(
            what=f"copy entry x{streams}", kernel_ms=[k1, k2],
            sum_ms=[s1, s2], blocks=r["blocks"],
            band=r["band"], copy_bytes=r["copy_bytes"],
            gbs=r["bytes"] / min(k1, k2) / 1e6)),
            flush=True)
        del src
        torch.cuda.empty_cache()
    lines = [dict(n_slots=slots, full_lanes=full, args=(name, rows, lanes,
                                                       dtype))
             for name, rows, lanes, dtype, slots, full in mod.TPU_RUNS]
    lines += [dict(n_streams=streams, multi=True,
                   args=(name, rows, lanes, torch.bfloat16))
              for name, rows, lanes, streams in mod.TPU_MULTI]
    for kw in lines:
        args = kw.pop("args")
        r = mod.run(*args, target_ms=smoke.PROBE_MS, device=dev, **kw)
        smoke.check(f"{mod.__name__}[{args[0]}]", r["ok"], f"err {r['err']}")
        print("probe_out " + json.dumps({k: r.get(k) for k in (
            "name", "ms", "gbs", "share", "blocks", "band",
            "copy_bytes", "slots", "streams", "n_iter", "inflight_per_sm")}),
            flush=True)


def probe_vmem(smoke, mod, dev, timed) -> None:
    import torch

    optin = mod.PD.smem_limits(dev)["optin"]
    ones = torch.ones((1, mod.copy_lanes(optin)), dtype=torch.bfloat16,
                      device=dev)
    got = mod.smem_copy_kernel(ones, optin)
    err = float((got - mod.smem_copy_plain(ones)).abs().max())
    smoke.check(f"{mod.__name__} at the opt-in limit", err == 0.0,
                f"err {err}")
    timed("smem copy", lambda: mod.smem_copy_kernel(ones, optin), 20)
    timed("torch.sum of the same bytes",
          lambda: torch.sum(ones, dtype=torch.float32), 20)


PROBES = {"probe_batched_transpose": probe_transpose, "probe_dma": probe_dma,
          "probe_vmem": probe_vmem}
#: the kernel phases that take (dev, entries, parts) in every checkout
#: that has them
WITH_PARTS = ("kernel_decode_layers",)


def main() -> None:
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    root = Path(sys.argv[1]).resolve()
    phases = sys.argv[2:] or ["kernel_mel", "kernel_cross_attn"]
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this needs a card")
    print(smoke.card_line(), flush=True)
    events_ms = smoke.time_ms
    phase = {"name": None}

    def time_ms(fn, iters: int, warmup: int = 2) -> float:
        ms = events_ms(fn, iters, warmup)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = {ev.key: ev.device_time_total / 1e3 / iters
                   for ev in prof.key_averages()
                   if getattr(ev, "device_type", None) == DeviceType.CUDA
                   and ev.device_time_total > 0}
        print("device_ms " + json.dumps(
            {"phase": phase["name"], "events_ms": ms, "kernels": kernels}),
            flush=True)
        return ms

    smoke.time_ms = time_ms
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    def timed(label: str, fn, iters: int) -> float:
        phase["name"] = f"{name}: {label}"
        return time_ms(fn, iters)

    for name in phases:
        phase["name"] = name
        fn, _, arg = name.partition(":")
        out = []
        if fn == "probe":
            mod = importlib.import_module(
                f"whisper_aries_tpu_torch.scripts.{arg}")
            PROBES[arg](smoke, mod, dev, timed)
            continue
        parts = []
        extra = (parts,) if fn in WITH_PARTS and not arg else ()
        getattr(smoke, fn)(dev, arg if arg else out, *extra)
        if out or parts:  # the phase's entries / parts (a profile's times)
            print("phase_out " + json.dumps(
                {"phase": name, "out": out, "parts": parts}, default=str),
                flush=True)
    if smoke.FAILED:
        smoke.fail("; ".join(smoke.FAILED))


if __name__ == "__main__":
    main()
