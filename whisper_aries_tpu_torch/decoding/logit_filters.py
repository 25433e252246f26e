"""Whisper's logit rules, as the JAX package implements them
(openai/whisper's SuppressBlank / SuppressTokens / ApplyTimestampRules):
blank suppression at the first sampled position, a static suppress mask,
and the timestamp grammar tracked with O(1) per-row state (last /
penultimate / max timestamp). Greedy decoding applies them on their own;
the beam tail's plain version (ops/beam_tail.py) applies them before its
log_softmax, and its kernel recomputes them on the fly.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float(np.finfo(np.float32).min)


def apply_filters(logits: torch.Tensor, ids, suppress_mask: torch.Tensor,
                  is_first: bool, last_tok: torch.Tensor,
                  penult_tok: torch.Tensor, max_ts_tok: torch.Tensor,
                  with_timestamps: bool, suppress_blank: bool = True
                  ) -> torch.Tensor:
    """(R, V) logits -> filtered logits (masked entries f32 min). ``ids``
    carries no_timestamps, blank, eot, timestamp_begin and
    max_initial_timestamp_index; the grammar state is per row."""
    V = logits.shape[-1]
    vocab_idx = torch.arange(V, device=logits.device)[None, :]
    logits = logits + suppress_mask[None, :]
    logits = torch.where(vocab_idx == ids.no_timestamps, NEG_INF, logits)
    if is_first and suppress_blank:  # SuppressBlank: no " " or eot first
        blank = (vocab_idx == ids.blank) | (vocab_idx == ids.eot)
        logits = torch.where(blank, NEG_INF, logits)
    if not with_timestamps:
        return torch.where(vocab_idx >= ids.timestamp_begin, NEG_INF, logits)

    tsb = ids.timestamp_begin
    last_was_ts = last_tok >= tsb
    penult_was_ts = penult_tok >= tsb
    ts_region = vocab_idx >= tsb
    text_region = vocab_idx < ids.eot
    # after a timestamp pair -> text required; after a single timestamp ->
    # text forbidden (close the pair or end)
    suppress_ts = (last_was_ts & penult_was_ts)[:, None]
    suppress_text = (last_was_ts & ~penult_was_ts)[:, None]
    logits = torch.where(suppress_ts & ts_region, NEG_INF, logits)
    logits = torch.where(suppress_text & text_region, NEG_INF, logits)
    # monotonic timestamps: forbid < max so far (<= max once the pair closed)
    has_ts = (max_ts_tok >= tsb)[:, None]
    floor = torch.where(last_was_ts & ~penult_was_ts, max_ts_tok,
                        max_ts_tok + 1)[:, None]
    logits = torch.where(ts_region & (vocab_idx < floor) & has_ts, NEG_INF,
                         logits)
    if is_first:  # must open with a timestamp, capped at the initial max
        init_cap = tsb + ids.max_initial_timestamp_index
        logits = torch.where((vocab_idx < tsb) | (vocab_idx > init_cap),
                             NEG_INF, logits)
    # force a timestamp when the total timestamp probability beats every
    # text token (shift-invariant, so compared on raw logits)
    ts_lp = torch.logsumexp(torch.where(ts_region, logits, NEG_INF), dim=-1)
    max_text = torch.where(ts_region, NEG_INF, logits).amax(dim=-1)
    force = (ts_lp > max_text)[:, None]
    return torch.where(force & ~ts_region, NEG_INF, logits)
