"""The optimised q-attention micro's steps one at a time, each inside a
branch on a runtime value: the counterpart of the TPU probe
``scripts/probe_qa_bisect.py`` (``build``: the micro inside ``pl.when(i >=
0)``, adding into its output each iteration), which bisected a Mosaic
crash in the optimised micro.

Variants, as the TPU probe defines them:

  base     - the micro as shipped (iota mask, normalised probabilities)
  iotamask - the mask as an additive row computed from the key index
  refmask  - the mask as an additive row read from the rmask buffer
  latediv  - iota mask, normalisation after P.V as att * (1 / sum)
  latediv2 - iota mask, normalisation after P.V as att / sum
  target   - refmask + latediv (what the megakernel wanted)

The crash has no counterpart here: each variant's answer on the card is
that it builds, runs inside ``if (i >= gate)`` with ``gate`` a kernel
argument, holds against its plain version and has a time.

    python -m whisper_aries_tpu_torch.scripts.probe_qa_bisect
        [--reps 100] [--device cpu]

Prints one line a variant: us per iteration, rel_vs_base, the hold against
the plain version and the checksum, whether every block agrees and the 2 x
reps launch against the reps one. ``--device cpu`` runs the plain versions
untimed.
"""

from __future__ import annotations

from typing import List

from whisper_aries_tpu_torch.scripts import qa_micro as QA

VARIANTS = {
    "base": QA.Spec(branch=True),
    "iotamask": QA.Spec(mask="row", branch=True),
    "refmask": QA.Spec(mask="buffer", branch=True),
    "latediv": QA.Spec(norm="rcp", branch=True),
    "latediv2": QA.Spec(norm="div", branch=True),
    "target": QA.Spec(mask="buffer", norm="rcp", branch=True),
}
TWINS: dict = {}
REPS = 100   # the TPU script's default

bisect_kernel = QA.counted_kernel(VARIANTS, "rmask")
build = QA.make_build(VARIANTS, "rmask", bisect_kernel)
build.__doc__ = """scripts/probe_qa_bisect.py's ``build``: the function of
(q, k, v, wo, rmask) giving the (8, 128) answer of ``reps`` iterations of
``variant``."""


def main(argv=None) -> List[dict]:
    return QA.main_for(__doc__, VARIANTS, TWINS, build, bisect_kernel,
                       "rmask", REPS, True, argv)


if __name__ == "__main__":
    main()
