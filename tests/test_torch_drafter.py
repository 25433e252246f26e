"""The port's speculative-decode helpers against the JAX package's: the
n-gram drafter (numpy and batched), ``acceptance_len`` and the verify
step's ``multi_token_mask``. Each must give the JAX function's values
exactly, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_aries_tpu.decoding import drafter as JD
from whisper_aries_tpu.models import whisper as JW
from whisper_aries_tpu_torch.decoding import drafter as TD
from whisper_aries_tpu_torch.models import whisper as TW

# tests/test_drafter.py's cases: (tokens, pos, n_draft, ngram)
CASES = [
    ([5, 6, 7, 8, 9, 5, 6, 0], 7, 3, 2),
    ([1, 2, 3, 1, 2, 4, 9, 1, 2, 0, 0], 9, 2, 2),
    ([1, 2, 3, 4, 5], 5, 3, 2),
    ([1, 2], 2, 2, 2),
    ([7, 8, 1, 7, 8, 0], 5, 4, 2),
]


@pytest.mark.parametrize("tokens,pos,n_draft,ngram", CASES)
def test_drafter_cases_identical(tokens, pos, n_draft, ngram):
    """Both port drafters give the JAX numpy reference's draft on each of
    tests/test_drafter.py's cases, and the JAX batched drafter's."""
    t = np.asarray(tokens, np.int32)
    want = JD.ngram_draft_np(t, pos, n_draft, ngram=ngram)
    got_np = TD.ngram_draft_np(t, pos, n_draft, ngram=ngram)
    assert got_np.dtype == want.dtype
    np.testing.assert_array_equal(got_np, want)
    got = TD.ngram_draft(torch.from_numpy(t)[None], pos, n_draft, ngram=ngram)
    assert got.dtype == torch.int32 and got.shape == (1, n_draft)
    np.testing.assert_array_equal(got[0].numpy(), want)
    jax_b = np.asarray(JD.ngram_draft(jnp.asarray(t)[None], pos, n_draft,
                                      ngram=ngram))
    np.testing.assert_array_equal(got.numpy(), jax_b)


@pytest.mark.parametrize("ngram", [1, 2, 3])
@pytest.mark.parametrize("n_draft", [1, 4])
def test_drafter_random_batches_identical(ngram, n_draft):
    """Seeded random batches over a small alphabet (many repeated n-grams)
    at positions from before the first possible match to the row's end,
    with fallback -1 and 0: the batched port drafter equals the JAX batched
    drafter and both numpy references, row for row; a 0-d position tensor
    gives the same as an int."""
    rng = np.random.default_rng(100 * ngram + n_draft)
    B, L = 6, 48
    toks = rng.integers(0, 5, (B, L)).astype(np.int32)
    tt = torch.from_numpy(toks)
    for pos in (0, 1, ngram, ngram + 1, 5, 17, 31, 47, 48):
        for fallback in (-1, 0):
            got = TD.ngram_draft(tt, pos, n_draft, ngram=ngram,
                                 fallback=fallback).numpy()
            want = np.asarray(JD.ngram_draft(jnp.asarray(toks), pos, n_draft,
                                             ngram=ngram, fallback=fallback))
            np.testing.assert_array_equal(got, want)
            if pos <= L:
                ref = np.stack([JD.ngram_draft_np(toks[b], pos, n_draft,
                                                  ngram=ngram,
                                                  fallback=fallback)
                                for b in range(B)])
                port = np.stack([TD.ngram_draft_np(toks[b], pos, n_draft,
                                                   ngram=ngram,
                                                   fallback=fallback)
                                 for b in range(B)])
                np.testing.assert_array_equal(port, ref)
                np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(
                TD.ngram_draft(tt, torch.tensor(pos), n_draft, ngram=ngram,
                               fallback=fallback).numpy(), got)


def test_acceptance_len_identical():
    """tests/test_drafter.py's three rows and seeded random ones."""
    draft = np.asarray([[10, 11, 12, 13], [10, 11, 99, 13],
                        [10, 99, 12, 13]], np.int32)
    verified = np.asarray([[11, 12, 13, 14], [11, 98, 13, 14],
                           [55, 12, 13, 14]], np.int32)
    got = TD.acceptance_len(torch.from_numpy(draft),
                            torch.from_numpy(verified))
    assert got.dtype == torch.int32 and got.tolist() == [4, 2, 1]
    rng = np.random.default_rng(3)
    for S in (1, 2, 4, 8):
        d = rng.integers(0, 3, (32, S)).astype(np.int32)
        v = rng.integers(0, 3, (32, S)).astype(np.int32)
        want = np.asarray(JD.acceptance_len(jnp.asarray(d), jnp.asarray(v)))
        got = TD.acceptance_len(torch.from_numpy(d), torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("S,pos,vs", [(1, 0, 0), (3, 5, 2), (8, 20, 7)])
def test_multi_token_mask_identical(group, S, pos, vs):
    """The same (G, S*group, minor) f32 mask, bit for bit, with minor
    larger than Tmax * group (the JAX cache's x128 padding)."""
    Tmax = pos + S + 3
    minor = Tmax * group + 11
    want = np.asarray(JW.multi_token_mask(group, S, pos, vs, Tmax, minor, 3))
    got = TW.multi_token_mask(group, S, pos, vs, Tmax, minor, 3)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
