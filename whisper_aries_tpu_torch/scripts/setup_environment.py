"""One-shot environment setup of the port: install, build, then verify.

The counterpart of the JAX repo's ``scripts/setup_environment.py``:

  1. ``cli/install_packages.main`` with the arguments given (it reports
     each package and pip-installs the missing ones; ``--check-only`` and
     ``--dry-run`` never run pip);
  2. the builds ``make -C native`` stands for in the JAX repo: the port's
     host library (``audio/_native.py::library``: codecs, resampler, DTW,
     by g++) and, on the card, every CUDA kernel
     (``ops/cuda_build.py::build``: one nvcc a source, in parallel). A
     failed build is reported and setup goes on: the verification names
     what is missing;
  3. ``cli/verify_setup.main``.

    python -m whisper_aries_tpu_torch.scripts.setup_environment
        [install_packages flags] [--device cpu]

The exit code is install's when it fails, else verify's. With
``--device cpu`` no kernel is built and the card is not verified; without
a card and without ``--device cpu`` it raises before installing anything.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

from whisper_aries_tpu_torch.audio import _native
from whisper_aries_tpu_torch.cli import install_packages, verify_setup
from whisper_aries_tpu_torch.ops import cuda_build
from whisper_aries_tpu_torch.utils.device import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 add_help=False)
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    args, rest = ap.parse_known_args(argv)
    on_cpu = resolve_device(args.device, "setup_environment").type == "cpu"
    rc = install_packages.main(rest)
    if rc != 0:
        return rc
    try:
        _native.library()
    except Exception as e:
        print(f"native build failed: {type(e).__name__}: {e}")
    if not on_cpu:
        try:
            cuda_build.build()
        except Exception as e:
            print(f"kernel build failed: {type(e).__name__}: {e}")
    verify: List[str] = ["--device", args.device] if args.device else []
    return verify_setup.main(verify)


if __name__ == "__main__":
    raise SystemExit(main())
