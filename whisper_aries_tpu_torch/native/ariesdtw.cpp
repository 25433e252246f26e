// Monotonic DTW for the word-timestamp aligner of whisper_aries_tpu_torch
// (align/word_align.py; the port's own copy of the JAX package's
// native/ariesdtw.cpp).
//
// The Python reference implementation (_dtw_path_py) is an O(N*M) dynamic
// program — ~336k pure-Python loop iterations per 30 s window at 224
// tokens x 1500 frames, which dominates word_timestamps=True on long
// files. This is the same recurrence in C: transitions (diagonal, up,
// left) with numpy-argmin tie-breaking (first minimum wins), backtrace
// from (n, m) to (0, 0).
//
// Exported C ABI (bound with ctypes in audio/_native.py):
//   aries_dtw(cost, n, m, out_ti, out_tj) -> path length (<= n + m)
//     cost:   (n*m,) float64 row-major cost matrix
//     out_ti: (n+m,) int32 — text indices along the path (caller-alloc)
//     out_tj: (n+m,) int32 — time indices along the path (caller-alloc)
// Returns -1 on invalid input.

#include <cstddef>
#include <cstdint>
#include <limits>
#include <vector>

using std::size_t;

extern "C" int32_t aries_dtw(const double* cost, int32_t n, int32_t m,
                             int32_t* out_ti, int32_t* out_tj) {
  if (cost == nullptr || n <= 0 || m <= 0 || out_ti == nullptr ||
      out_tj == nullptr)
    return -1;
  const double inf = std::numeric_limits<double>::infinity();
  // Full (n+1) x (m+1) table: the backtrace re-reads arbitrary rows, and at
  // word-alignment scale (<=225 x 1501 doubles ~ 2.7 MB) it fits easily.
  std::vector<double> D(static_cast<size_t>(n + 1) * (m + 1), inf);
  const size_t W = static_cast<size_t>(m + 1);
  D[0] = 0.0;
  for (int32_t i = 1; i <= n; ++i) {
    const double* row_cost = cost + static_cast<size_t>(i - 1) * m;
    const double* prev = D.data() + static_cast<size_t>(i - 1) * W;
    double* cur = D.data() + static_cast<size_t>(i) * W;
    for (int32_t j = 1; j <= m; ++j) {
      double best = prev[j - 1];           // diagonal
      if (prev[j] < best) best = prev[j];  // up (advance text)
      if (cur[j - 1] < best) best = cur[j - 1];  // left (advance time)
      cur[j] = row_cost[j - 1] + best;
    }
  }
  // Backtrace, writing the path REVERSED (caller flips it, matching the
  // Python implementation's ti[::-1]).
  int32_t i = n, j = m, k = 0;
  while (i > 0 && j > 0) {
    out_ti[k] = i - 1;
    out_tj[k] = j - 1;
    ++k;
    const double diag = D[static_cast<size_t>(i - 1) * W + (j - 1)];
    const double up = D[static_cast<size_t>(i - 1) * W + j];
    const double left = D[static_cast<size_t>(i) * W + (j - 1)];
    // numpy argmin tie-break: first minimum in (diag, up, left) order
    if (diag <= up && diag <= left) {
      --i;
      --j;
    } else if (up <= left) {
      --i;
    } else {
      --j;
    }
  }
  return k;
}
