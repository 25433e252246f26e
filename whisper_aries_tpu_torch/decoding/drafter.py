"""Draft tokens for speculative decode: prompt-lookup / n-gram reuse.

The port of the JAX package's decoding/drafter.py. A drafter proposes the
next S tokens of each window from its own decoded transcript: the most
recent earlier occurrence of the last n-gram, and the tokens that followed
it (prompt-lookup decoding, Saxena 2023; transformers'
``prompt_lookup_num_tokens``). It costs the card next to nothing, which a
drafter must: verifying S drafted tokens in one decode step
(``models/whisper.py::decoder_step_fused_multi``) pays only where drafting
is cheaper than the steps it saves. Dictated speech and meetings repeat
n-grams; random weights do not, so acceptance on random weights means
nothing (``scripts/bench_speculative.py`` forces it).

Two implementations of one function, held equal by the tests:
``ngram_draft_np`` (numpy, one window) and ``ngram_draft`` (batched torch
ops on the tokens' device with fixed shapes, no data-dependent control
flow and nothing read back to the host). Neither is a kernel.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


def ngram_draft_np(tokens: np.ndarray, pos: int, n_draft: int,
                   ngram: int = 2, fallback: int = -1) -> np.ndarray:
    """Host reference. ``tokens`` (L,) int; the history is tokens[:pos].

    Finds the LATEST i < pos - ngram with
    tokens[i : i + ngram] == tokens[pos - ngram : pos] and proposes
    tokens[i + ngram : i + ngram + n_draft] (clipped to the history;
    missing positions fill with ``fallback``). No match: all fallback."""
    out = np.full(n_draft, fallback, dtype=tokens.dtype)
    if pos < ngram + 1:
        return out
    key = tokens[pos - ngram:pos]
    for i in range(pos - ngram - 1, -1, -1):
        if np.array_equal(tokens[i:i + ngram], key):
            src = tokens[i + ngram:min(i + ngram + n_draft, pos)]
            out[:len(src)] = src
            return out
    return out


def ngram_draft(tokens: torch.Tensor, pos: Union[int, torch.Tensor],
                n_draft: int, ngram: int = 2,
                fallback: int = -1) -> torch.Tensor:
    """Batched drafter: ``tokens`` (B, L) int32, ``pos`` an int or a 0-d
    integer tensor (the same decode position for every row: the batch's
    windows step together). Returns (B, n_draft) int32, ``fallback``
    marking unusable slots; row for row ``ngram_draft_np``."""
    B, L = tokens.shape
    dev = tokens.device
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    idx = torch.arange(L, device=dev)
    # the query n-gram tokens[pos - ngram : pos], its start clamped into
    # the row as a fixed-size slice is
    start = torch.clamp(pos - ngram, 0, L - ngram)
    key = tokens.gather(1, (start + torch.arange(ngram, device=dev))
                        .expand(B, ngram))                    # (B, ngram)
    # every start position i against the query: t[i + k] at column i
    match = torch.ones((B, L), dtype=torch.bool, device=dev)
    for k in range(ngram):
        match &= torch.roll(tokens, -k, dims=1) == key[:, k:k + 1]
    # valid starts: the whole n-gram inside the history, strictly before
    # the query's own occurrence
    match &= ((idx + ngram <= pos) & (idx < pos - ngram))[None, :]
    best = torch.where(match, idx[None, :], -1).amax(dim=1)   # latest, or -1
    gather = (best[:, None] + ngram
              + torch.arange(n_draft, device=dev)[None, :])
    draft = tokens.gather(1, torch.clamp(gather, 0, L - 1))
    usable = (best >= 0)[:, None] & (gather < pos)
    ngram_draft.calls += 1
    return torch.where(usable, draft,
                       torch.full_like(draft, fallback)).to(torch.int32)


ngram_draft.calls = 0


def acceptance_len(draft: torch.Tensor, verified: torch.Tensor
                   ) -> torch.Tensor:
    """(B,) int32 count of ACCEPTED draft tokens, greedy speculative
    semantics (Leviathan 2022): verified[:, s] is the model's token after
    consuming draft[:, s]; draft[:, 0] is always accepted (the caller took
    it from the model's previous step), and acceptance runs while
    draft[:, s] == verified[:, s - 1]. In [1, S]."""
    ok = draft[:, 1:] == verified[:, :-1]                     # (B, S - 1)
    run = torch.cumprod(ok.to(torch.int32), dim=1)
    return (1 + run.sum(dim=1)).to(torch.int32)
