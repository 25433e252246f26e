#!/usr/bin/env python3
"""Where the vocab kernel's tiles path spends its time: variants of
whisper_aries_tpu_torch/csrc/vocab_gemm.cu, each made from the source by
one text edit, compiled by hand with the port's nvcc flags into OUT_DIR
(a git-ignored directory), loaded in place of the built library, held
against the plain version and timed (the profiler's device ms) at large M
in one call on one card:

    python3 chip_vocab_variants.py [OUT_DIR] [M ...]

  base           the source as it is
  nostore        the epilogue's global stores skipped (shared-memory
                 staging kept): what the f32 logits' writes cost
  nomma          no wgmma (TMA loads, barriers, epilogue): the sums are
                 wrong, the time is the data movement's
  nomma_nostore  neither: the TMA loads from L2 and the barriers alone

Prints the card line, then one "variant " JSON line per M with each
variant's device ms (two runs) and its error over max |logit| (nomma's
are meant to be wrong). Default OUT_DIR chip_smoke_out/vocab_variants, M
672 1135 1536 (the words slice's word pass, a conditioned full prefill,
6 windows x 256). Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STORE = "        if (row < M && col < V) {"
MMA = ("        wgmma_m64n256k16_ss(acc, wgmma_desc(a + kk * 32, 16, 1024),"
       "\n                            wgmma_desc(b + kk * 32, 16, 1024), 1);")


def variants(src: str) -> dict:
    for text in (STORE, MMA):
        if text not in src:
            raise SystemExit(f"the source has changed: {text!r} not found")
    nostore = "        if (row < M && col < V && M < 0) {"
    return {
        "base": src,
        "nostore": src.replace(STORE, nostore),
        "nomma": src.replace(MMA, "        ;"),
        "nomma_nostore": src.replace(MMA, "        ;").replace(STORE,
                                                               nostore),
    }


def main() -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from whisper_aries_tpu_torch.ops import cuda_build as cb
    from whisper_aries_tpu_torch.ops import vocab as VO

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else (
        ROOT / "chip_smoke_out" / "vocab_variants")
    ms_list = [int(a) for a in sys.argv[2:]] or [672, 1135, 1536]
    print(CS.card_line(), flush=True)
    out.mkdir(parents=True, exist_ok=True)
    for header in cb.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    procs = {}
    for name, text in variants((cb.CSRC / "vocab_gemm.cu").read_text()
                               ).items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cb.nvcc_path(), *cb.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    dev = torch.device("cuda")
    V, K = 51866, 1280
    g = torch.Generator(device=dev).manual_seed(24)
    emb = (0.05 * torch.randn((V, K), generator=g, device=dev)).to(
        torch.bfloat16)
    for M in ms_list:
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        want = VO.vocab_product_plain(x, emb)
        row = {"M": M}
        for _ in range(2):
            for name, lib in libs.items():
                VO._lib.cache_clear()
                cb._libs["vocab_gemm"] = lib
                got = VO.vocab_product_kernel(x, emb, path="tiles")
                torch.cuda.synchronize()
                row[name + "_err"] = CS.max_rel(got, want)
                row.setdefault(name, []).append(CS.device_ms(
                    lambda: VO.vocab_product_kernel(x, emb, path="tiles")))
        print("variant " + json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
