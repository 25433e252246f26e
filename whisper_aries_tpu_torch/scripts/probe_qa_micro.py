"""What the q-attention micro costs on the card, phase by phase: the
counterpart of the TPU probe ``scripts/probe_qa_micro.py`` (``build``: the
encoder megakernel's q-attention micro at large-v3 shapes, H 20, dh 64,
bq 128, Tp 1536, on resident operands, REPS iterations, an (8, 128) f32
answer).

Variants, as the TPU probe defines them:

  full    - the micro as written (QK product, iota mask, softmax, P.V
            product, identity transpose, O-projection)
  nomask  - the mask as an additive row computed from the key index
  nosm    - products only (bf16(lg * 1e-3) straight to P.V; no mask, no
            softmax)
  smonly  - mask and softmax only, on an f32 buffer of logits (no
            products)
  qk      - the QK product only
  perhead - full with the products as H unrolled 2-D dots; on the card a
            head is one loop of wgmma tiles either way, so it runs
            full's code

The micro runs on the card as one block an SM, every SM at once
(``csrc/probe_qa.cu``, see ``qa_micro``); "us/iter" is one iteration of
one micro on each SM. The smonly buffer (15.7 MB) does not fit an SM as
it fit the TPU core's VMEM: each block reads it from L2, twice.

    python -m whisper_aries_tpu_torch.scripts.probe_qa_micro
        [--reps 200] [--device cpu]

Prints one line a variant: us per iteration, the hold against the plain
version (and the checksum of everything the micro computes), whether
every block agrees and what a launch of 2 x reps takes against one of
reps. ``--device cpu`` runs the plain versions untimed.
"""

from __future__ import annotations

from typing import List

from whisper_aries_tpu_torch.scripts import qa_micro as QA

VARIANTS = {
    "full": QA.Spec(),
    "nomask": QA.Spec(mask="row"),
    "nosm": QA.Spec(mask="none", norm="none", max_sub=False),
    "smonly": QA.Spec(phase="sm"),
    "qk": QA.Spec(mask="none", norm="none", max_sub=False, phase="qk"),
    "perhead": QA.Spec(),
}
TWINS = {"perhead": "same code as full: batched and per-head dots are the "
                    "same wgmma loop on the card"}
REPS = 200   # the TPU script's default

micro_kernel = QA.counted_kernel(VARIANTS, "lgb")
build = QA.make_build(VARIANTS, "lgb", micro_kernel)
build.__doc__ = """scripts/probe_qa_micro.py's ``build``: the function of
(q, k, v, wo, lgbuf) giving the (8, 128) answer of ``reps`` iterations of
``variant``."""


def main(argv=None) -> List[dict]:
    return QA.main_for(__doc__, VARIANTS, TWINS, build, micro_kernel, "lgb",
                       REPS, False, argv)


if __name__ == "__main__":
    main()
