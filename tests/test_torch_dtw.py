"""The port's DTW (align/word_align.py ``dtw_path`` over its own
native/ariesdtw.cpp) against the JAX package's C++ DTW (``_dtw_native``)
and against its plain version (``_dtw_path_py``, row by row in numpy), on
the CPU.

Tolerance: none; the paths must be identical index for index."""

import numpy as np
import pytest

from torch_port_util import jax_native_library
from whisper_aries_tpu.align import word_align as JA
from whisper_aries_tpu_torch.align import word_align as TA


def _cost(case):
    rng = np.random.default_rng(7)
    if case == "random 40 x 300":
        return rng.standard_normal((40, 300))
    if case == "random 224 x 1500 window, 12 tokens":
        return -rng.random((12, 1500))
    if case == "1 x 1":
        return np.array([[0.5]])
    if case == "1 x m":
        return rng.random((1, 9))
    if case == "n x 1":
        return rng.random((9, 1))
    if case == "n > m":
        return rng.random((30, 7))
    if case == "n < m":
        return rng.random((7, 30))
    if case == "ties: all equal":
        return np.zeros((6, 11))
    if case == "ties: small integers":
        return rng.integers(0, 3, (25, 40)).astype(np.float64)
    if case == "ties: a constant column band":
        c = rng.random((10, 20))
        c[:, 5:12] = 1.0
        return c
    if case == "float32 input":
        return rng.standard_normal((16, 50)).astype(np.float32)
    raise ValueError(case)


CASES = ["random 40 x 300", "random 224 x 1500 window, 12 tokens", "1 x 1",
         "1 x m", "n x 1", "n > m", "n < m", "ties: all equal",
         "ties: small integers", "ties: a constant column band",
         "float32 input"]


@pytest.mark.parametrize("case", CASES)
def test_dtw_path_identical(case):
    jax_native_library()  # JAX's _dtw_native is None without it
    cost = _cost(case)
    ti, tj = TA.dtw_path(cost)
    jti, jtj = JA._dtw_native(cost)
    pti, ptj = TA._dtw_path_py(cost)
    assert ti.dtype == tj.dtype == np.int32
    np.testing.assert_array_equal(ti, jti)
    np.testing.assert_array_equal(tj, jtj)
    np.testing.assert_array_equal(ti, pti)
    np.testing.assert_array_equal(tj, ptj)
    n, m = cost.shape
    # a monotonic path from (0, 0) to (n - 1, m - 1), one step at a time
    assert (ti[0], tj[0], ti[-1], tj[-1]) == (0, 0, n - 1, m - 1)
    steps = np.stack([np.diff(ti), np.diff(tj)], 1)
    assert {tuple(s) for s in steps} <= {(1, 1), (1, 0), (0, 1)}
    if case == "ties: all equal":
        # the backtrace's first minimum (diagonal before up before left)
        # wins: diagonal from the end until the first text row
        assert list(zip(ti, tj))[-6:] == [(i, i + 5) for i in range(6)]


def test_dtw_path_empty():
    for shape in ((0, 5), (5, 0)):
        ti, tj = TA.dtw_path(np.zeros(shape))
        assert ti.shape == tj.shape == (0,)
