#!/usr/bin/env python3
"""Device milliseconds, kernel by kernel, of the calls that a checkout's
chip_smoke.py times with CUDA events in its kernel phase: for holding a
kernel against the design it replaced, in one call on one card, where the
older chip_smoke.py reports event times only.

    python3 chip_device_ms.py CHECKOUT [PHASE ...]

CHECKOUT is the root of a checkout of this repository; its chip_smoke.py
and its package are imported from there. PHASE names kernel-phase
functions of that chip_smoke.py (default: kernel_mel kernel_cross_attn),
or NAME:ARG for one called with a string in place of the list
(slice_phase:self_int8 runs that slice).
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
    for name in phases:
        phase["name"] = name
        fn, _, arg = name.partition(":")
        out = []
        getattr(smoke, fn)(dev, arg if arg else out)
        if out:  # the phase's entries / parts (a profile's step times)
            print("phase_out " + json.dumps(
                {"phase": name, "out": out}, default=str), flush=True)
    if smoke.FAILED:
        smoke.fail("; ".join(smoke.FAILED))


if __name__ == "__main__":
    main()
