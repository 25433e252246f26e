"""``verify_setup`` — environment check of the port's own stack (the JAX
package's cli/verify_setup.py for the PyTorch / CUDA port).

    python -m whisper_aries_tpu_torch.cli.verify_setup [--smoke-test] \\
        [--model DIR] [--device cpu]

Reports torch and its CUDA build; the card's name and power limit
(nvidia-smi); nvcc and the kernels' build into ``_build/`` (one nvcc a
source, in parallel); the port's native host library (codecs, resampler,
DTW; g++); the model directory. ``--smoke-test`` builds the engine on the
device and runs its smoke test (0.5 s of noise through mel, encoder and
one decoder call): on the ``--model`` checkpoint when one resolves, else
on tiny random weights. With no card and no ``--device cpu`` the card is
reported missing and the exit code is 1; on the CPU the card, nvcc and
the kernels are not needed.
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
from typing import Optional, Sequence


def check(name: str, fn) -> bool:
    try:
        detail = fn()
        print(f"  [ok] {name}" + (f": {detail}" if detail else ""))
        return True
    except Exception as e:
        print(f"  [FAIL] {name}: {type(e).__name__}: {e}")
        return False


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="verify_setup")
    p.add_argument("--model", default="large-v3")
    p.add_argument("--model-cache", default="./models")
    p.add_argument("--smoke-test", action="store_true",
                   help="build the engine on the device and run its smoke "
                        "test")
    p.add_argument("--device", default=None,
                   help="cuda (default), cuda:N or cpu")
    return p


def _torch() -> str:
    import torch

    return (f"{torch.__version__}, CUDA build {torch.version.cuda}, "
            f"cards visible {torch.cuda.device_count()}")


def _card() -> str:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible (pass --device cpu for "
                           "the CPU path)")
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return "; ".join(line)


def _nvcc() -> str:
    from whisper_aries_tpu_torch.ops import cuda_build as cb

    path = cb.nvcc_path()
    out = subprocess.run([path, "--version"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return f"{path} ({out[-1] if out else '?'})"


def _kernels() -> str:
    from whisper_aries_tpu_torch.ops import cuda_build as cb

    cb.build()
    return f"{len(cb.SOURCES)} sources built into {cb.BUILD_DIR}"


def _native() -> str:
    from whisper_aries_tpu_torch.audio import _native

    _native.library()
    return f"{_native.LIB_PATH.name} loaded"


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    on_cpu = str(args.device or "cuda") == "cpu"

    ok = True
    print("Core stack:")
    ok &= check("torch", _torch)
    for mod in ("numpy", "regex"):
        ok &= check(mod, lambda m=mod: importlib.import_module(m).__version__)

    print("Optional:")
    for mod in ("aiohttp", "requests", "psutil"):
        check(mod, lambda m=mod: importlib.import_module(m).__version__)

    print("Card:")
    if on_cpu:
        print("  [--] the CPU path (--device cpu): card, nvcc and kernels "
              "not needed")
    else:
        card_ok = check("card", _card)
        ok &= card_ok
        ok &= check("nvcc", _nvcc)
        if card_ok:
            ok &= check("kernels", _kernels)

    print("Native runtime:")
    check("host library (codecs, resampler, DTW)", _native)

    print("Model:")

    def _model():
        from whisper_aries_tpu_torch.models.loader import resolve_model_dir

        d = resolve_model_dir(args.model, args.model_cache)
        if d is None:
            raise RuntimeError(
                f"no local checkpoint for {args.model!r} under "
                f"{args.model_cache} (config.json + model.safetensors + "
                "tokenizer files)")
        return str(d)

    model_ok = check(f"checkpoint {args.model}", _model)

    if args.smoke_test and ok:
        print("Smoke test:")

        def _smoke():
            from whisper_aries_tpu_torch.models import whisper as W
            from whisper_aries_tpu_torch.pipeline.engine import (
                AriesTranscriber,
            )

            if model_ok:
                eng = AriesTranscriber(model_size=args.model,
                                       cache_dir=args.model_cache,
                                       device=args.device,
                                       windows_per_device=1)
                what = f"checkpoint {eng.model_dir}"
            else:
                # heads of 64 (the encoder-attention kernel's width)
                dims = W.WhisperDims(
                    n_mels=80, n_audio_ctx=1500, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=1, n_vocab=51866,
                    n_text_ctx=448, n_text_state=128, n_text_head=2,
                    n_text_layer=1)
                eng = AriesTranscriber(
                    model_size="verify", device=args.device,
                    windows_per_device=1, _dims=dims,
                    _params=W.init_params(dims, seed=0))
                what = "tiny random weights"
            eng.smoke_test()
            return f"{what} on {eng.device}"

        ok &= check("engine smoke test", _smoke)

    print("\nSetup " + ("OK" if ok else "INCOMPLETE") +
          ("" if model_ok else " (no model checkpoint — only random-weight "
                              "runs will work)"))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
