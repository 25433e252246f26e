"""``install_packages`` — the port's dependency check and installer (the
JAX package's cli/install_packages.py for the PyTorch / CUDA port).

    python -m whisper_aries_tpu_torch.cli.install_packages --check-only

Reports each package the port imports (with its version) and
pip-installs the missing ones. ``--check-only`` and ``--dry-run`` never
run pip (``--dry-run`` prints the command). The CUDA toolkit (nvcc) and
g++ build the kernels and the host library; they are not pip packages
(``verify_setup`` checks them). Exit code 0 = everything required is
importable.
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
from typing import List, Optional, Sequence, Tuple

# (pip name, import name, required?)
PACKAGES: List[Tuple[str, str, bool]] = [
    ("torch", "torch", True),
    ("numpy", "numpy", True),
    ("regex", "regex", True),
    ("aiohttp", "aiohttp", False),
    ("requests", "requests", False),
    ("psutil", "psutil", False),
    ("pytest", "pytest", False),
]


def probe(import_name: str) -> Optional[str]:
    """Version string if importable, else None."""
    try:
        mod = importlib.import_module(import_name)
        return getattr(mod, "__version__", "unknown")
    except Exception:
        return None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="install_packages")
    ap.add_argument("--check-only", action="store_true",
                    help="report status; never run pip")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the pip command instead of running it")
    ap.add_argument("--include-optional", action="store_true",
                    help="also install missing optional packages")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    missing_required: List[str] = []
    missing_optional: List[str] = []
    print("Package status:")
    for pip_name, import_name, required in PACKAGES:
        ver = probe(import_name)
        tag = "required" if required else "optional"
        if ver:
            print(f"  [ok]      {import_name:<18} {ver}  ({tag})")
        else:
            print(f"  [missing] {import_name:<18} -> pip install {pip_name}"
                  f"  ({tag})")
            (missing_required if required else missing_optional).append(
                pip_name)

    to_install = missing_required + (
        missing_optional if args.include_optional else [])
    if not to_install:
        print("\nAll required packages present.")
        if missing_optional and not args.include_optional:
            print("Optional packages missing (fine unless you need them): "
                  + ", ".join(missing_optional))
        return 0

    cmd = [sys.executable, "-m", "pip", "install", *to_install]
    if args.check_only:
        print(f"\n{len(missing_required)} required package(s) missing "
              "(--check-only: not installing).")
        return 1 if missing_required else 0
    if args.dry_run:
        print("\nWould run: " + " ".join(cmd))
        return 0

    print("\nInstalling: " + " ".join(to_install))
    rc = subprocess.call(cmd)
    if rc != 0:
        print("pip failed — see output above", file=sys.stderr)
        return rc

    still_missing = [n for p, n, req in PACKAGES if req and not probe(n)]
    if still_missing:
        print("Still missing after install: " + ", ".join(still_missing),
              file=sys.stderr)
        return 1
    print("Done. Run `python -m whisper_aries_tpu_torch.cli.verify_setup` "
          "for the full environment check.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
