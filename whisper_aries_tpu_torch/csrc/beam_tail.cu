// Beam-search expansion tail of one decode step (ops/beam_tail.py).
//
// Replaces: whisper_aries_tpu/ops/pallas_beam_tail.py, beam_tail (the fused
// filters + log_softmax + top-K of expand() in decoding/generate.py).
//
// For each window b, over its K beams' logits (K, V):
//   f      = the filtered logits: additive suppress mask, the no_timestamps
//            ban, SuppressBlank at the first sampled position, and the
//            timestamp grammar (pair alternation, monotonic floor, initial
//            timestamp cap, and a forced timestamp when the timestamps'
//            logsumexp beats the largest text logit)
//   lp     = (f - max f) - log(sum exp(f - max f))       per row, f32
//   total  = lp + sum_logprob[b, k]
//   eot_scores[b, k] = total[k, eot]   (read before the column is masked)
//   the K best of the flat K*V totals with the eot column set to f32 min,
//   by (score descending, flat index k*V+v ascending): live_score, top_idx.
// IEEE expf/logf (never fast math) in the plain version's order.
//
// Bound on the H100: bytes, the logits read once (B*K*V*4: 8.3 MB at
// B 8, K 5, V 51866, ~2.5 us). With one block per window only B SMs work,
// so the kernel sits far above that bound; it is one launch where the plain
// version is ~20 full-vocab passes.
//
// Design: one block of 1024 threads per window. For each beam row the
// block reads the logits once, filters them into shared memory (a row of
// V f32: 207 KB at V 51866) and then makes its reductions over shared
// memory: timestamp max / text max, the timestamps' exp sum, the row's exp
// sum. Every thread touches only its own columns (v = tid mod 1024) in
// every pass, so the row buffer needs no barrier of its own. Each thread
// keeps its own top-K in registers; K block-wide argmax rounds then merge
// them, ties to the lowest flat index.
#include <climits>

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -3.4028234663852886e38f;  // f32 min: the masked value

struct Ids {
  int V, tsb, eot, blank, no_ts, init_cap;
  int with_ts, suppress_blank, is_first;
};

// a better candidate: higher score, or equal score and lower flat index
__device__ __forceinline__ bool better(float s1, long long i1, float s2,
                                       long long i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

template <int K>
__global__ void __launch_bounds__(THREADS)
beam_tail_kernel(const float* __restrict__ logits,
                 const float* __restrict__ sum_lp,
                 const int* __restrict__ last, const int* __restrict__ pen,
                 const int* __restrict__ mts,
                 const float* __restrict__ sup, Ids c,
                 float* __restrict__ live_score,
                 long long* __restrict__ top_idx,
                 float* __restrict__ eot_scores) {
  extern __shared__ float fbuf[];  // one filtered row, V floats
  __shared__ float red[32];
  __shared__ float ws[WARPS];
  __shared__ long long wi[WARPS];
  __shared__ float s_eot;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = c.V;

  float tsc[K];
  long long tix[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    tsc[j] = -INFINITY;
    tix[j] = LLONG_MAX;
  }

  for (int k = 0; k < K; ++k) {
    const int row = b * K + k;
    const float* lr = logits + (size_t)row * V;
    const int lt = last[row], pt = pen[row], mt = mts[row];
    const bool last_was = lt >= c.tsb, pen_was = pt >= c.tsb;
    const bool has_ts = mt >= c.tsb;
    const int floor_ = (last_was && !pen_was) ? mt : mt + 1;
    const bool first = c.is_first != 0;

    // (1) filter into shared memory; maxima of the timestamp region and
    // of the text (non-timestamp) region
    float m_ts = NEG, m_text = NEG;
    for (int v = tid; v < V; v += THREADS) {
      float f = __fadd_rn(lr[v], sup[v]);
      if (v == c.no_ts) f = NEG;
      if (c.suppress_blank && first && (v == c.blank || v == c.eot)) f = NEG;
      const bool ts = v >= c.tsb;
      if (!c.with_ts) {
        if (ts) f = NEG;
      } else {
        if (last_was && pen_was && ts) f = NEG;
        if (last_was && !pen_was && v < c.eot) f = NEG;
        if (ts && v < floor_ && has_ts) f = NEG;
        if (first && (v < c.tsb || v > c.init_cap)) f = NEG;
      }
      fbuf[v] = f;
      if (ts) m_ts = fmaxf(m_ts, f);
      else m_text = fmaxf(m_text, f);
    }
    m_ts = block_max(m_ts, red);
    m_text = block_max(m_text, red);

    // (2) the timestamp rule: force a timestamp when the logsumexp over
    // the timestamps (the non-timestamp entries count as f32 min there)
    // beats every text logit
    bool force = false;
    if (c.with_ts) {
      float s = 0.f;
      for (int v = tid; v < V; v += THREADS)
        if (v >= c.tsb) s += expf(__fsub_rn(fbuf[v], m_ts));
      s = block_sum(s, red);
      s += (float)min(c.tsb, V) * expf(__fsub_rn(NEG, m_ts));
      force = __fadd_rn(logf(s), m_ts) > m_text;
    }
    // the row max after the rule: text entries are f32 min when forced
    const float m2 = force ? fmaxf(m_ts, NEG) : fmaxf(m_ts, m_text);

    // (3) log-sum-exp of the row
    float s2 = 0.f;
    for (int v = tid; v < V; v += THREADS) {
      const float f = (force && v < c.tsb) ? NEG : fbuf[v];
      s2 += expf(__fsub_rn(f, m2));
    }
    const float lse = logf(block_sum(s2, red));
    const float base = sum_lp[row];

    // (4) scores and this thread's top-K (its columns ascend, so a later
    // equal score has a higher flat index and ranks after)
    for (int v = tid; v < V; v += THREADS) {
      const float f = (force && v < c.tsb) ? NEG : fbuf[v];
      const float total = __fadd_rn(__fsub_rn(__fsub_rn(f, m2), lse), base);
      if (v == c.eot) s_eot = total;
      const float sc = v == c.eot ? NEG : total;
      const long long idx = (long long)k * V + v;
      if (better(sc, idx, tsc[K - 1], tix[K - 1])) {
        tsc[K - 1] = sc;
        tix[K - 1] = idx;
#pragma unroll
        for (int j = K - 1; j > 0; --j) {
          if (better(tsc[j], tix[j], tsc[j - 1], tix[j - 1])) {
            const float ts_ = tsc[j];
            tsc[j] = tsc[j - 1];
            tsc[j - 1] = ts_;
            const long long ti_ = tix[j];
            tix[j] = tix[j - 1];
            tix[j - 1] = ti_;
          }
        }
      }
    }
    __syncthreads();
    if (tid == 0) eot_scores[row] = s_eot;
  }

  // (5) merge: K rounds of a block-wide argmax over the threads' heads
  for (int j = 0; j < K; ++j) {
    float bs = tsc[0];
    long long bi = tix[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, o);
      const long long oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      ws[warp] = bs;
      wi[warp] = bi;
    }
    __syncthreads();
    bs = ws[lane];
    bi = wi[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, o);
      const long long oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    // every lane of every warp now holds the winner
    if (tid == 0) {
      live_score[b * K + j] = bs;
      top_idx[b * K + j] = bi;
    }
    if (tix[0] == bi) {  // the owner pops its head
#pragma unroll
      for (int i = 0; i < K - 1; ++i) {
        tsc[i] = tsc[i + 1];
        tix[i] = tix[i + 1];
      }
      tsc[K - 1] = -INFINITY;
      tix[K - 1] = LLONG_MAX;
    }
    __syncthreads();  // ws / wi are rewritten by the next round
  }
}

template <int K>
int launch_k(const float* logits, const float* sum_lp, const int* last,
             const int* pen, const int* mts, const float* sup, const Ids& c,
             int B, float* live, long long* idx, float* eot,
             cudaStream_t st) {
  const size_t smem = (size_t)c.V * sizeof(float);
  if (smem > 200 * 1024 + 12 * 1024) return (int)cudaErrorInvalidValue;
  auto kern = beam_tail_kernel<K>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B, THREADS, smem, st>>>(logits, sum_lp, last, pen, mts, sup, c,
                                 live, idx, eot);
  return launch_status();
}

}  // namespace

extern "C" {

// logits (B*K, V) f32; sum_lp (B, K) f32; last/pen/mts (B, K) int32;
// sup (V,) f32; outputs live (B, K) f32, idx (B, K) int64, eot (B, K) f32.
int aries_beam_tail(const float* logits, const float* sum_lp, const int* last,
                    const int* pen, const int* mts, const float* sup, int B,
                    int K, int V, int tsb, int eot, int blank, int no_ts,
                    int init_cap, int with_ts, int suppress_blank,
                    int is_first, float* live, long long* idx, float* eots,
                    void* stream) {
  const Ids c{V, tsb, eot, blank, no_ts, init_cap, with_ts, suppress_blank,
              is_first};
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  switch (K) {
    case 1: return launch_k<1>(logits, sum_lp, last, pen, mts, sup, c, B, live, idx, eots, st);
    case 2: return launch_k<2>(logits, sum_lp, last, pen, mts, sup, c, B, live, idx, eots, st);
    case 3: return launch_k<3>(logits, sum_lp, last, pen, mts, sup, c, B, live, idx, eots, st);
    case 4: return launch_k<4>(logits, sum_lp, last, pen, mts, sup, c, B, live, idx, eots, st);
    case 5: return launch_k<5>(logits, sum_lp, last, pen, mts, sup, c, B, live, idx, eots, st);
    case 6: return launch_k<6>(logits, sum_lp, last, pen, mts, sup, c, B, live, idx, eots, st);
    case 7: return launch_k<7>(logits, sum_lp, last, pen, mts, sup, c, B, live, idx, eots, st);
    case 8: return launch_k<8>(logits, sum_lp, last, pen, mts, sup, c, B, live, idx, eots, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
