"""Word-error-rate evaluation (the port's copy of the JAX package's
eval/wer.py).

Levenshtein alignment over normalised word sequences, with the standard
English text normalisation (lowercase, punctuation stripping, whitespace
collapse, common contraction/number-form folding kept minimal and
documented). For Arabic, diacritics are stripped and alef/hamza variants
folded — the forms that differ freely between transcribers.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, Sequence, Tuple

_ARABIC_DIACRITICS = re.compile(r"[ً-ٰٟ]")
_PUNCT = re.compile(r"[^\w\s']", re.UNICODE)


def normalize_text(text: str, language: str = "en") -> str:
    text = text.strip().lower()
    text = unicodedata.normalize("NFKC", text)
    if language == "ar":
        text = _ARABIC_DIACRITICS.sub("", text)
        text = (text.replace("آ", "ا")  # alef madda
                    .replace("أ", "ا")  # alef hamza above
                    .replace("إ", "ا")  # alef hamza below
                    .replace("ة", "ه")  # ta marbuta -> ha
                    .replace("ى", "ي"))  # alef maqsura -> ya
    text = _PUNCT.sub(" ", text)
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def _levenshtein_ops(ref: Sequence[str], hyp: Sequence[str]
                     ) -> Tuple[int, int, int]:
    """(substitutions, deletions, insertions) from the optimal alignment."""
    n, m = len(ref), len(hyp)
    # dp[j] = (cost, subs, dels, ins)
    prev = [(j, 0, 0, j) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, i, 0)] + [None] * m
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                cand = [(prev[j - 1][0], prev[j - 1])]
            else:
                cand = [(prev[j - 1][0] + 1, None)]
            del_cost = cur[j - 1][0] + 1
            ins_cost = prev[j][0] + 1
            best = min(cand[0][0], del_cost, ins_cost)
            if best == cand[0][0]:
                src = prev[j - 1]
                hit = ref[i - 1] == hyp[j - 1]
                cur[j] = (best, src[1] + (0 if hit else 1), src[2], src[3])
            elif best == ins_cost:
                src = prev[j]
                cur[j] = (best, src[1], src[2] + 1, src[3])
            else:
                src = cur[j - 1]
                cur[j] = (best, src[1], src[2], src[3] + 1)
        prev = cur
    _, subs, dels, ins = prev[m]
    return subs, dels, ins


def word_error_details(reference: str, hypothesis: str,
                       language: str = "en") -> Dict[str, float]:
    ref = normalize_text(reference, language).split()
    hyp = normalize_text(hypothesis, language).split()
    if not ref:
        return {"wer": 0.0 if not hyp else 1.0, "substitutions": 0,
                "deletions": 0, "insertions": len(hyp), "ref_words": 0}
    subs, dels, ins = _levenshtein_ops(ref, hyp)
    return {
        "wer": (subs + dels + ins) / len(ref),
        "substitutions": subs,
        "deletions": dels,
        "insertions": ins,
        "ref_words": len(ref),
    }


def wer(reference: str, hypothesis: str, language: str = "en") -> float:
    return word_error_details(reference, hypothesis, language)["wer"]
