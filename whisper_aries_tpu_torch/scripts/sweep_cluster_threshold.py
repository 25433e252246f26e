"""Sweep the diarizer's clustering threshold on a development set of scenes.

The counterpart of the JAX repo's ``scripts/sweep_cluster_threshold.py``.
The diarization battery (eval/diarize_battery.py, seed 7000) is the test
set: tuning on it would overfit the reported number. This sweep builds a
separate development set from the same ``conversation_scene`` generator
at seed 5000 on and scores ``DiarizationPipeline`` at several stopping
thresholds for a weights directory; the chosen threshold is then checked
once on the battery.

    python -m whisper_aries_tpu_torch.scripts.sweep_cluster_threshold
        [weights_dir] [t1,t2,...] [n_scenes] [--device cpu]

Defaults: the shipped weights, thresholds 0.53,0.60,0.67,0.74, 6 scenes.
One line a threshold (clean and augmented DER, the speakers found and the
truth's a scene), then the JSON of them all. The diarizer runs on the card
unless ``--device cpu``; without a card and without ``--device cpu`` it
raises.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Sequence

from whisper_aries_tpu_torch.diarize.pipeline import DiarizationPipeline
from whisper_aries_tpu_torch.eval.diarize_battery import run_battery

#: the development set's first scene seed (the battery's is 7000)
DEV_SEED = 5000


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("weights_dir", nargs="?", default=None,
                    help="default: the shipped weights")
    ap.add_argument("thresholds", nargs="?", default="0.53,0.60,0.67,0.74")
    ap.add_argument("n_scenes", nargs="?", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    args = ap.parse_args(argv)
    out: Dict[float, Dict[str, Any]] = {}
    for t in (float(t) for t in args.thresholds.split(",")):
        pipeline = DiarizationPipeline(model_dir=args.weights_dir,
                                       clustering_threshold=t,
                                       device=args.device)
        rep = run_battery(pipeline, n_scenes=args.n_scenes, seed=DEV_SEED)
        out[t] = {"clean": rep["clean_der"], "aug": rep["augmented_der"],
                  "hyp_clean": [s["clean"]["n_hyp_speakers"]
                                for s in rep["scenes"]],
                  "ref": [s["n_ref_speakers"] for s in rep["scenes"]]}
        print(f"t={t:.2f}: clean={rep['clean_der']:.3f} "
              f"aug={rep['augmented_der']:.3f} "
              f"hyp={out[t]['hyp_clean']} ref={out[t]['ref']}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
