"""Word-level timestamps from cross-attention DTW (the port of the JAX
package's align/word_align.py).

Equivalent of faster-whisper's ``word_timestamps=True`` machinery: the
decoder is run teacher-forced over the already-decoded tokens with the
alignment heads' cross-attention logits captured
(models/whisper.py ``alignment_forward``), attention is averaged over those
heads (the top half of the decoder layers when no per-checkpoint head list
is given — openai/whisper's fallback), time-normalised and median-filtered,
and a monotonic DTW path maps each token to an encoder frame (20 ms).
Tokens are grouped into words with unicode-aware splitting and each word
gets {word, start, end, probability}.

The device part (the mel kernel, the encoder, ``alignment_forward``) runs
on the engine's device, one batched call per group of windows; the
softmax, normalisation and median filter and the word grouping are
host-side numpy, and the DTW is the port's C++ (``dtw_path``). Errors are
not caught here: a failing kernel fails the transcription.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from whisper_aries_tpu_torch.audio import _native

FRAME_S = 0.02  # one encoder position = 20 ms


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW through cost (N_text, N_audio); returns aligned index
    arrays (text_indices, time_indices, int32) along the optimal path.

    The recurrence D[i, j] = cost[i-1, j-1] + min(D[i-1, j-1], D[i-1, j],
    D[i, j-1]) and its backtrace (ties to the first of diagonal, up, left)
    run in C++ (``native/ariesdtw.cpp`` through ``audio/_native.py``), the
    JAX package's native DTW; ``_dtw_path_py`` is its plain version."""
    n, m = cost.shape
    if n == 0 or m == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    return _native.dtw(cost)


def _dtw_path_py(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Reference pure-numpy DTW, row by row: the plain version of
    ``dtw_path``, for the tests."""
    n, m = cost.shape
    D = np.full((n + 1, m + 1), np.inf, dtype=np.float64)
    D[0, 0] = 0.0
    for i in range(1, n + 1):
        row_cost = cost[i - 1]
        prev = D[i - 1]
        cur = D[i]
        # transitions: diagonal, left (advance time), up (advance text)
        for j in range(1, m + 1):
            c = row_cost[j - 1]
            best = prev[j - 1]
            if prev[j] < best:
                best = prev[j]
            if cur[j - 1] < best:
                best = cur[j - 1]
            cur[j] = c + best
    # backtrace
    i, j = n, m
    ti, tj = [], []
    while i > 0 and j > 0:
        ti.append(i - 1)
        tj.append(j - 1)
        moves = (D[i - 1, j - 1], D[i - 1, j], D[i, j - 1])
        k = int(np.argmin(moves))
        if k == 0:
            i, j = i - 1, j - 1
        elif k == 1:
            i -= 1
        else:
            j -= 1
    return np.array(ti[::-1]), np.array(tj[::-1])


def _median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis with REFLECT padding — matching
    openai/whisper's timing.py median_filter and transformers'
    _median_filter exactly (edge padding shifts boundary medians)."""
    if width < 3 or x.shape[-1] <= width // 2:
        return x
    pad = width // 2
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1)


def attention_to_token_times(
    cross_qk: np.ndarray,  # (L, H, T_text, T_audio) logits for ONE sequence
    n_frames: int,
    alignment_layers: Optional[Sequence[int]] = None,
    alignment_heads: Optional[Sequence[Tuple[int, int]]] = None,
    timing: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Token -> time (seconds) via DTW over averaged attention.

    ``alignment_heads``: per-checkpoint (layer, head) pairs from
    generation_config.json (openai/whisper's published head masks) —
    preferred when available; falls back to whole top-half layers.
    ``timing`` (optional) accumulates host seconds: ``dtw_s`` (the DTW)
    and ``token_times_s`` (the rest of this function: softmax,
    normalisation, median filter, first frames).
    """
    t0 = time.perf_counter()
    L = cross_qk.shape[0]
    if alignment_heads:
        w = np.stack([cross_qk[l, h] for l, h in alignment_heads
                      if l < L and h < cross_qk.shape[1]])
        w = w[None]  # (1, N, T_text, T_audio) — same axes as the layer path
    else:
        layers = (
            list(alignment_layers)
            if alignment_layers is not None
            else list(range(L // 2, L))  # openai/whisper fallback head set
        )
        w = cross_qk[layers]  # (L', H, T_text, T_audio)
    w = w[..., :n_frames]
    # softmax over audio axis in f64 for stability
    w = w.astype(np.float64)
    w = np.exp(w - w.max(axis=-1, keepdims=True))
    w = w / w.sum(axis=-1, keepdims=True)
    # normalise each head across time, then average heads/layers
    mean = w.mean(axis=-2, keepdims=True)
    std = w.std(axis=-2, keepdims=True) + 1e-8
    w = (w - mean) / std
    w = _median_filter(w, 7)
    matrix = w.mean(axis=(0, 1))  # (T_text, T_audio)
    t1 = time.perf_counter()
    ti, tj = dtw_path(-matrix)
    t2 = time.perf_counter()
    # first frame where each token appears on the path
    n_text = matrix.shape[0]
    times = np.zeros(n_text)
    jumps = np.pad(np.diff(ti), (1, 0), constant_values=1).astype(bool)
    times[ti[jumps]] = tj[jumps] * FRAME_S
    if timing is not None:
        timing["dtw_s"] = timing.get("dtw_s", 0.0) + t2 - t1
        timing["token_times_s"] = (timing.get("token_times_s", 0.0) + t1
                                   - t0 + time.perf_counter() - t2)
    return times


def split_tokens_into_words(
    tokens: Sequence[int], tokenizer
) -> Tuple[List[str], List[List[int]]]:
    """Group text tokens into display words (unicode-aware: split on spaces
    when the language uses them, else on codepoint boundaries).

    Returns (words, token_groups) covering exactly the input tokens.
    """
    sp = tokenizer.specials
    words: List[str] = []
    groups: List[List[int]] = []
    cur: List[int] = []

    def flush():
        nonlocal cur
        if cur:
            text = tokenizer.decode(cur)
            if text.strip():
                words.append(text)
                groups.append(list(cur))
            elif groups:
                groups[-1].extend(cur)
                words[-1] = words[-1] + text
            cur = []

    for tok in tokens:
        tok = int(tok)
        if tok >= sp.eot:
            continue
        piece = tokenizer.decode([tok])
        # a piece starting with a space (or replacement char boundary)
        # begins a new word
        if piece.startswith(" ") and cur:
            flush()
        cur.append(tok)
        # decode may produce replacement chars mid-codepoint; only split when
        # the accumulated text currently ends cleanly
        text = tokenizer.decode(cur)
        if text.endswith("�"):
            continue
    flush()
    return words, groups


#: faster-whisper / openai-whisper default punctuation sets
PREPEND_PUNCTUATIONS = "\"'“¿([{-"
APPEND_PUNCTUATIONS = "\"'.。,，!！?？:：”)]}、"


def merge_punctuations(
    words: List[Dict[str, Any]],
    groups: List[List[int]],
    prepended: str = PREPEND_PUNCTUATIONS,
    appended: str = APPEND_PUNCTUATIONS,
) -> Tuple[List[Dict[str, Any]], List[List[int]]]:
    """Merge punctuation-only words into their neighbours in place.

    openai/whisper timing.py merge_punctuations semantics (exposed by the
    reference whitelist's prepend_punctuations/append_punctuations,
    final_optimized_transcriber.py:317-318): a word that is a leading
    punctuation mark (" ¿" etc.) prepends onto the FOLLOWING word; a
    trailing punctuation mark (".", ",", "?" ...) appends onto the
    PRECEDING word. Timing/probability fields of the surviving word are
    kept (matching openai, which only merges text and tokens). Returns the
    filtered (words, token_groups) with emptied entries dropped.
    """
    # prepended: scan right-to-left
    i, j = len(words) - 2, len(words) - 1
    while i >= 0:
        prev_w, next_w = words[i], words[j]
        if prev_w["word"].startswith(" ") and prev_w["word"].strip() in prepended:
            next_w["word"] = prev_w["word"] + next_w["word"]
            groups[j] = groups[i] + groups[j]
            prev_w["word"] = ""
            groups[i] = []
        else:
            j = i
        i -= 1
    # appended: scan left-to-right
    i, j = 0, 1
    while j < len(words):
        prev_w, next_w = words[i], words[j]
        if not prev_w["word"].endswith(" ") and next_w["word"] in appended:
            prev_w["word"] = prev_w["word"] + next_w["word"]
            groups[i] = groups[i] + groups[j]
            next_w["word"] = ""
            groups[j] = []
        else:
            i = j
        j += 1
    keep = [k for k in range(len(words)) if words[k]["word"]]
    return [words[k] for k in keep], [groups[k] for k in keep]


def find_word_alignments(
    tokens: Sequence[int],
    cross_qk: np.ndarray,  # (L, H, T_text, T_audio) for this sequence
    tokenizer,
    n_frames: int,
    token_probs: Optional[np.ndarray] = None,
    alignment_layers: Optional[Sequence[int]] = None,
    alignment_heads: Optional[Sequence[Tuple[int, int]]] = None,
    prepend_punctuations: Optional[str] = None,
    append_punctuations: Optional[str] = None,
    return_groups: bool = False,
    timing: Optional[Dict[str, float]] = None,
):
    """Words with times for one decoded sequence (token list incl specials).

    ``cross_qk`` rows must correspond 1:1 with ``tokens``. When punctuation
    strings are given, punctuation-only words merge into their neighbours
    (merge_punctuations). ``return_groups`` additionally returns the
    per-word token-id groups (post-merge) for segment distribution.
    ``timing`` is ``attention_to_token_times``'s.
    """
    times = attention_to_token_times(cross_qk, n_frames, alignment_layers,
                                     alignment_heads, timing)
    # carry times forward so every token has a start estimate
    for i in range(1, len(times)):
        if times[i] == 0.0 and i > 0:
            times[i] = times[i - 1]

    sp = tokenizer.specials
    # indices of text tokens only
    text_idx = [i for i, t in enumerate(tokens) if int(t) < sp.eot]
    words, groups = split_tokens_into_words(
        [int(tokens[i]) for i in text_idx], tokenizer
    )
    out: List[Dict[str, Any]] = []
    out_groups: List[List[int]] = []
    pos = 0
    for word, group in zip(words, groups):
        idxs = text_idx[pos : pos + len(group)]
        pos += len(group)
        if not idxs:
            continue
        start = float(times[idxs[0]])
        end_i = idxs[-1] + 1
        end = float(times[end_i]) if end_i < len(times) else start + 0.02
        if end <= start:
            end = start + 0.02
        prob = 1.0
        if token_probs is not None:
            prob = float(np.exp(np.mean([np.log(max(token_probs[i], 1e-10))
                                         for i in idxs])))
        out.append({
            "word": word,
            "start": round(start, 3),
            "end": round(end, 3),
            "probability": round(prob, 4),
        })
        out_groups.append(list(idxs))  # flat-token positions, not ids
    if prepend_punctuations is not None or append_punctuations is not None:
        out, out_groups = merge_punctuations(
            out, out_groups,
            prepend_punctuations if prepend_punctuations is not None
            else PREPEND_PUNCTUATIONS,
            append_punctuations if append_punctuations is not None
            else APPEND_PUNCTUATIONS,
        )
    if return_groups:
        return out, out_groups
    return out


def _alignment_head_onehot(
    dims, alignment_heads: Optional[Sequence[Tuple[int, int]]]
) -> Tuple[np.ndarray, int]:
    """(L, N_sel, H) one-hot selectors for W.alignment_forward.

    Uses the per-checkpoint (layer, head) pairs when available, else the
    openai/whisper fallback (all heads of the top half of the layers).
    """
    L, H = dims.n_text_layer, dims.n_text_head
    pairs = [(l, h) for l, h in (alignment_heads or [])
             if 0 <= l < L and 0 <= h < H]
    if not pairs:
        pairs = [(l, h) for l in range(L // 2, L) for h in range(H)]
    sel = np.zeros((L, len(pairs), H), np.float32)
    for i, (l, h) in enumerate(pairs):
        sel[l, i, h] = 1.0
    return sel, len(pairs)


def add_word_timestamps(
    engine,
    segments: List[Dict[str, Any]],
    audio: np.ndarray,
    windows,
    prepend_punctuations: Optional[str] = None,
    append_punctuations: Optional[str] = None,
) -> Dict[str, float]:
    """Attach ``words`` to every segment in place.

    Groups segments by window, teacher-forces the decoder over all windows'
    token sequences in batched device calls (tokens eot-padded to one
    width, a multiple of 32; windows sub-batched so the selected-heads
    accumulator stays under ~1.5 GB), and distributes DTW word times
    (rebased by each window's start). The windows are re-encoded from the
    float audio, as the JAX package's word pass does. ``engine`` carries
    params, dims, tokenizer, device, activation_dtype, batch_size and
    alignment_heads (None: the top-half fallback).

    Punctuation-only tokens merge into neighbouring words per
    prepend_punctuations/append_punctuations (faster-whisper semantics).
    Returns the pass's seconds: encode (mel and encoder), align
    (``alignment_forward`` and the copy to the host) and host (DTW and
    words), each ended by a device synchronisation, the host's split into
    ``dtw_s``, ``token_times_s`` (softmax, normalisation, median filter,
    first frames) and the rest (words, punctuation, segments); with the
    windows
    aligned and the number of (layer, head) pairs read (``heads``)."""
    from whisper_aries_tpu_torch.models import whisper as W
    from whisper_aries_tpu_torch.ops.mel import log_mel
    from whisper_aries_tpu_torch.vad.planner import windows_to_batch

    times = {"encode_s": 0.0, "align_s": 0.0, "host_s": 0.0, "dtw_s": 0.0,
             "token_times_s": 0.0, "windows": 0}
    by_window: Dict[int, List[Dict[str, Any]]] = {}
    for seg in segments:
        by_window.setdefault(
            seg.get("window_id", seg.get("chunk_id", 0)), []
        ).append(seg)

    # (win_id, segs, flat_tokens, seg_spans) for windows with any tokens
    work: List[Tuple[int, List[Dict[str, Any]], List[int],
                     List[Tuple[int, int]]]] = []
    for win_id, segs in by_window.items():
        flat_tokens: List[int] = []
        seg_spans: List[Tuple[int, int]] = []
        for seg in segs:
            toks = seg.get("tokens")
            if not toks:
                seg_spans.append((len(flat_tokens), len(flat_tokens)))
                continue
            start = len(flat_tokens)
            flat_tokens.extend(int(t) for t in toks)
            seg_spans.append((start, len(flat_tokens)))
        if flat_tokens:
            work.append((win_id, segs, flat_tokens, seg_spans))
    if not work:
        return times

    dims = engine.dims
    dev = engine.device
    sp = engine.tokenizer.specials
    sel_onehot, n_sel = _alignment_head_onehot(
        dims, getattr(engine, "alignment_heads", None)
    )
    times["heads"] = n_sel

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    S_pad = max(32, int(np.ceil(max(len(w[2]) for w in work) / 32)) * 32)
    Ta = dims.n_audio_ctx
    # sub-batch so the (N_sel, B, S, Ta) f32 accumulator stays ~<=1.5 GB
    B_max = max(1, int(1.5e9 // (n_sel * S_pad * Ta * 4)))
    B_max = min(B_max, getattr(engine, "batch_size", B_max) or B_max)

    for lo in range(0, len(work), B_max):
        sub = work[lo : lo + B_max]
        B = len(sub)
        t0 = time.perf_counter()
        batch = windows_to_batch(audio, [windows[w[0]] for w in sub])
        toks_np = np.full((B, S_pad), sp.eot, np.int64)
        for b, (_, _, flat_tokens, _) in enumerate(sub):
            toks_np[b, : len(flat_tokens)] = flat_tokens
        mel = log_mel(torch.from_numpy(batch).to(dev), n_mels=dims.n_mels)
        xa = W.encode(engine.params, mel.to(engine.activation_dtype), dims)
        sync()
        t1 = time.perf_counter()
        sel_qk, token_probs = W.alignment_forward(
            engine.params, torch.from_numpy(toks_np).to(dev), xa, sel_onehot,
            dims)
        del xa
        sel_qk = sel_qk.cpu().numpy()            # (N_sel, B, S_pad, Ta)
        token_probs = token_probs.cpu().numpy()  # (B, S_pad)
        t2 = time.perf_counter()

        for b, (win_id, segs, flat_tokens, seg_spans) in enumerate(sub):
            window = windows[win_id]
            S_b = len(flat_tokens)
            n_frames = int(round(min(window.duration, 30.0) / FRAME_S))
            # (1, N_sel, S_b, Ta) with alignment_layers=[0]: the heads were
            # already selected on the device, so "layer 0 / all heads" is
            # exactly the chosen pair set
            cqk_b = sel_qk[:, b, :S_b][None]
            words, groups = find_word_alignments(
                flat_tokens, cqk_b, engine.tokenizer, max(n_frames, 1),
                token_probs=token_probs[b, :S_b],
                alignment_layers=[0],
                prepend_punctuations=(
                    prepend_punctuations if prepend_punctuations is not None
                    else PREPEND_PUNCTUATIONS),
                append_punctuations=(
                    append_punctuations if append_punctuations is not None
                    else APPEND_PUNCTUATIONS),
                return_groups=True,
                timing=times,
            )
            # groups hold flat-token POSITIONS (post punctuation merge)
            pos_to_word: Dict[int, int] = {}
            for wi, g in enumerate(groups):
                for p in g:
                    pos_to_word[p] = wi
            for seg, (s0, s1) in zip(segs, seg_spans):
                wset = sorted({pos_to_word[i] for i in range(s0, s1)
                               if i in pos_to_word})
                seg_words = []
                for wi in wset:
                    w = dict(words[wi])
                    w["start"] = round(w["start"] + window.start, 3)
                    w["end"] = round(w["end"] + window.start, 3)
                    seg_words.append(w)
                seg["words"] = seg_words
                if seg_words:
                    seg["start"] = min(seg["start"], seg_words[0]["start"])
                    seg["end"] = max(seg["end"], seg_words[-1]["end"])
        times["encode_s"] += t1 - t0
        times["align_s"] += t2 - t1
        times["host_s"] += time.perf_counter() - t2
        times["windows"] += B
    return times
