"""Optimised q-attention micro candidates against the one shipped: the
counterpart of the TPU probe ``scripts/probe_qa_opt.py`` (``build``: the
micro of ``probe_qa_micro`` in five variants, on resident operands, with
the key mask as an (8, Tp) f32 row buffer).

Variants, as the TPU probe's code computes them:

  base    - the micro as shipped (iota mask, full softmax, P.V as
            pr v -> (H, bq, dh), identity transpose, O-projection)
  vmajor  - P.V as v pr^T -> (H, dh, bq) directly (no identity transpose);
            the TPU body gives it the additive row mask from the buffer
            too (its docstring says otherwise), so it computes rowmask
  rowmask - vmajor with the additive row mask from the buffer
  latediv - rowmask with the normalisation after P.V: attT / sum
  nolng   - latediv without the max subtraction (exp of raw logits)

On the card (wgmma) P stays in registers as the A operand of pr v, but
v pr^T takes P^T as its B operand, which wgmma reads from shared memory
only: vmajor moves P through shared memory every tile (and a barrier of
the warpgroup) where base and rowmask run the identity product.

    python -m whisper_aries_tpu_torch.scripts.probe_qa_opt
        [--reps 200] [--device cpu]

Prints one line a variant: us per iteration, rel_vs_base (max |answer -
base's| over max |base's|), the hold against the plain version and the
checksum, whether every block agrees and the 2 x reps launch against the
reps one. ``--device cpu`` runs the plain versions untimed.
"""

from __future__ import annotations

from typing import List

from whisper_aries_tpu_torch.scripts import qa_micro as QA

_ROWMASK = QA.Spec(mask="buffer", layout="vmajor")
VARIANTS = {
    "base": QA.Spec(),
    "vmajor": _ROWMASK,
    "rowmask": _ROWMASK,
    "latediv": QA.Spec(mask="buffer", layout="vmajor", norm="div"),
    "nolng": QA.Spec(mask="buffer", layout="vmajor", norm="div",
                     max_sub=False),
}
TWINS = {"vmajor": "same code as rowmask: the TPU body applies the row "
                   "mask to every variant but base",
         "base": "same code as probe_qa_micro's full"}
REPS = 200   # the TPU script's default

opt_kernel = QA.counted_kernel(VARIANTS, "rmask")
build = QA.make_build(VARIANTS, "rmask", opt_kernel)
build.__doc__ = """scripts/probe_qa_opt.py's ``build``: the function of
(q, k, v, wo, rmask) giving the (8, 128) answer of ``reps`` iterations of
``variant``."""


def main(argv=None) -> List[dict]:
    return QA.main_for(__doc__, VARIANTS, TWINS, build, opt_kernel, "rmask",
                       REPS, True, argv)


if __name__ == "__main__":
    main()
