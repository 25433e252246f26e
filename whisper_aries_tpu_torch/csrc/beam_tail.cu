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
// IEEE expf/logf (never fast math).
//
// Bound on the H100: bytes, the logits read once (B*K*V*4: 8.3 MB at
// B 8, K 5, V 51866, ~2.5 us). One block per window (the first design)
// kept B SMs busy and the rest idle.
//
// Design: several blocks per beam row. `plan` cuts V into C chunks of W
// columns (W a multiple of 4; C from the rows and the SM count, at most 8)
// and the grid is (C, K, B): 240 blocks at 6 windows x 5 beams. The C
// blocks of a row form a thread-block cluster:
//   1. a block copies its chunk of the row, and of the suppress mask, into
//      shared memory with 16-byte cp.async (placed so that every 16-byte
//      source lands on a 16-byte slot whatever the row's alignment), then
//      filters it in place with the rules that need only the row's
//      scalars, keeping the chunk's timestamp and text maxima and each
//      region's sum of exp(f - its max);                     cluster sync
//   2. one exchange: each block writes its statistics into every block's
//      shared memory before the barrier (distributed shared memory; a
//      relaxed arrive at the start, waited before the writes, makes sure
//      every block runs) and reads them from its own after it, summing in
//      rank order, each rank's sum rescaled to the row's max:
//      the row's timestamp max and logsumexp and its text max decide the
//      forced-timestamp rule, and with it the row's max and log-sum-exp;
//   3. each block forms total = lp + sum_logprob over its chunk (the block
//      holding eot writes eot_scores). A candidate is one 64-bit key that
//      orders as (score descending, index ascending): the score's bits
//      made monotone in the high word, the index's complement in the low
//      one. Each thread keeps its K largest keys in registers; each warp
//      merges its threads' in K rounds of two redux.sync maxima, and one
//      warp merges the warps' into the chunk's K candidates.
//                                                            cluster sync
// A second launch (one warp per window) merges the window's K x C x K
// candidates in K such rounds. The order is total (every index is
// unique), so the K best are the same whatever order the candidates meet
// in: no atomics, and two runs give the same bits. Every
// per-thread and per-block sum runs over columns in a fixed order in v
// (shared memory decouples it from the row's alignment), so two rows with
// the same logits and state get the same scores bit for bit and a tie
// between them goes to the lower flat index.
#include <climits>

#include "attn_split.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CHUNKS = 8;     // the portable cluster size
constexpr int MAX_CHUNK = 8192;   // columns of one block (64 KB of shared)
constexpr int BLOCKS_PER_SM = 2;
constexpr float NEG = -3.4028234663852886e38f;  // f32 min: the masked value
constexpr unsigned FULL = 0xffffffffu;
typedef unsigned long long u64;

// C chunks of W columns over V for `rows` beam rows on `sms` SMs: about
// BLOCKS_PER_SM blocks per SM, at least V / MAX_CHUNK and at most
// MAX_CHUNKS chunks, W a multiple of 4 (the last chunk may be ragged).
// ops/beam_tail.py::chunk_plan mirrors it.
void plan(int V, int rows, int sms, int* C, int* W) {
  int c = (BLOCKS_PER_SM * sms + rows - 1) / (rows > 0 ? rows : 1);
  const int least = (V + MAX_CHUNK - 1) / MAX_CHUNK;
  c = c < least ? least : c;
  c = c < 1 ? 1 : (c > MAX_CHUNKS ? MAX_CHUNKS : c);
  const int w = ((V + c - 1) / c + 3) / 4 * 4;
  *W = w;
  *C = (V + w - 1) / w;
}

struct Ids {
  int V, tsb, eot, blank, no_ts, init_cap;
  int with_ts, suppress_blank, is_first;
};

// the largest key over a warp's lanes: two redux.sync maxima
__device__ __forceinline__ u64 warp_max_key(u64 k) {
  const unsigned hi = (unsigned)(k >> 32);
  const unsigned mh = __reduce_max_sync(FULL, hi);
  const unsigned ml = __reduce_max_sync(FULL, hi == mh ? (unsigned)k : 0u);
  return ((u64)mh << 32) | ml;
}

// the K largest keys of a warp's per-lane lists (each sorted, largest
// first; a lane pops its head when it is taken): out[j] by lane 0
template <int K>
__device__ __forceinline__ void warp_top_k(u64 (&keys)[K], u64* out) {
  for (int j = 0; j < K; ++j) {
    const u64 best = warp_max_key(keys[0]);
    if ((threadIdx.x & 31) == 0) out[j] = best;
    if (keys[0] == best) {
#pragma unroll
      for (int i = 0; i < K - 1; ++i) keys[i] = keys[i + 1];
      keys[K - 1] = 0;
    }
  }
}

// a chunk's statistics: timestamp and text maxima, sums of exp(f - max)
struct Stats {
  float m_ts, s_ts, m_text, s_text;
};

// the block-wide max of a and of b (every thread gets both)
__device__ __forceinline__ void block_max2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_max_redux(a);
  b = warp_max_redux(b);
  if (lane == 0) {
    red[warp] = a;
    red[WARPS + warp] = b;
  }
  __syncthreads();
  a = b = NEG;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    a = fmaxf(a, red[w]);
    b = fmaxf(b, red[WARPS + w]);
  }
  __syncthreads();  // red is reused
}

// the block-wide sums of a and of b, warps in order (every thread gets
// both)
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[WARPS + warp] = b;
  }
  __syncthreads();
  a = b = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    a += red[w];
    b += red[WARPS + w];
  }
}

// copy n floats from src to shared memory: element i lands at the
// returned f[i], f sitting as far past a 16-byte slot of buf (n + 4
// floats) as src does, so the middle moves in 16-byte cp.async
__device__ __forceinline__ float* stage(float* buf, const float* src, int n) {
  const int off = (int)(((uintptr_t)src >> 2) & 3);
  float* f = buf + off;
  const int head = min((4 - off) & 3, n);
  const int nvec = (n - head) / 4;
  for (int i = threadIdx.x; i < head; i += THREADS)
    splitkv::cp4(f + i, src + i);
  for (int j = threadIdx.x; j < nvec; j += THREADS)
    splitkv::cp16(f + head + 4 * j, src + head + 4 * j);
  for (int i = head + 4 * nvec + threadIdx.x; i < n; i += THREADS)
    splitkv::cp4(f + i, src + i);
  return f;
}

// the sum of lane r's v over lanes r < n, in lane order (every lane gets it)
__device__ __forceinline__ float ordered_sum(float v, int n) {
  float s = 0.f;
  for (int r = 0; r < n; ++r) s += __shfl_sync(FULL, v, r);
  return s;
}

// grid (C, K, B), cluster (C, 1, 1), THREADS threads: block c takes
// columns c W .. c W + W - 1 of beam row b K + k and writes that chunk's K
// candidate keys (flat index k V + v) to cand [((b K + k) C + c) K + j]
template <int K>
__global__ void __launch_bounds__(THREADS)
tail_chunk_kernel(const float* logits, const float* sum_lp,
                  const long long* last, const long long* pen,
                  const long long* mts, const float* sup, Ids c, int W,
                  float* eot_scores, u64* cand) {
  extern __shared__ __align__(16) float buf[];  // 2 x (W + 4) floats
  __shared__ float red[2 * WARPS];
  __shared__ u64 wk[WARPS][K];
  __shared__ Stats st[MAX_CHUNKS];  // rank r's, written by rank r
  cg::cluster_group cl = cg::this_cluster();
  splitkv::cluster_arrive_relaxed();
  const int ch = blockIdx.x, k = blockIdx.y, b = blockIdx.z, C = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = c.V;
  const int row = b * K + k;
  const int v0 = ch * W, n = min(W, V - v0);

  // 1) the chunk of the row and of the suppress mask to shared memory
  float* f = stage(buf, logits + (size_t)row * V + v0, n);
  const float* sf = stage(buf + W + 4, sup + v0, n);
  splitkv::cp_commit();
  const long long lt = last[row], pt = pen[row], mt = mts[row];
  const float base = sum_lp[row];
  const bool last_was = lt >= c.tsb, pen_was = pt >= c.tsb;
  const bool has_ts = mt >= c.tsb;
  const long long floor_ = (last_was && !pen_was) ? mt : mt + 1;
  const bool first = c.is_first != 0;
  splitkv::cp_wait<0>();
  __syncthreads();

  // filter in place (every pass below touches only this thread's own
  // columns i = tid + j THREADS); the chunk's maxima
  float m_ts = NEG, m_text = NEG;
  for (int i = tid; i < n; i += THREADS) {
    const int v = v0 + i;
    float x = __fadd_rn(f[i], sf[i]);
    if (v == c.no_ts) x = NEG;
    if (c.suppress_blank && first && (v == c.blank || v == c.eot)) x = NEG;
    const bool ts = v >= c.tsb;
    if (!c.with_ts) {
      if (ts) x = NEG;
    } else {
      if (last_was && pen_was && ts) x = NEG;
      if (last_was && !pen_was && v < c.eot) x = NEG;
      if (ts && v < floor_ && has_ts) x = NEG;
      if (first && (v < c.tsb || v > c.init_cap)) x = NEG;
    }
    f[i] = x;
    if (ts) m_ts = fmaxf(m_ts, x);
    else m_text = fmaxf(m_text, x);
  }
  block_max2(m_ts, m_text, red);
  // the chunk's sums of exp(f - its region's max): timestamps, text
  float s_ts = 0.f, s_text = 0.f;
  for (int i = tid; i < n; i += THREADS) {
    if (v0 + i >= c.tsb) s_ts += expf(__fsub_rn(f[i], m_ts));
    else s_text += expf(__fsub_rn(f[i], m_text));
  }
  block_sum2(s_ts, s_text, red);
  splitkv::cluster_wait();  // every block of the cluster is running
  // this chunk's statistics into every rank's slot ch
  if (tid < C)
    *cl.map_shared_rank(&st[ch], tid) = Stats{m_ts, s_ts, m_text, s_text};
  cl.sync();

  // 2) the one exchange (lane r takes rank r's): the row's timestamp and
  // text maxima and sums of exp(f - max), each rank's sum rescaled to the
  // row's max and summed in rank order
  Stats o = {NEG, 0.f, NEG, 0.f};
  if (lane < C) o = st[lane];
  const float M_ts = warp_max_redux(o.m_ts);
  const float M_text = warp_max_redux(o.m_text);
  const float S_ts = ordered_sum(o.s_ts * expf(__fsub_rn(o.m_ts, M_ts)), C);
  const float S_text =
      ordered_sum(o.s_text * expf(__fsub_rn(o.m_text, M_text)), C);
  // the forced-timestamp rule: the timestamps' logsumexp (the
  // non-timestamp entries count as f32 min there, as in the plain version)
  // against the largest text logit
  const float n_text = (float)min(c.tsb, V);
  const bool force =
      c.with_ts &&
      __fadd_rn(logf(S_ts + n_text * expf(__fsub_rn(NEG, M_ts))), M_ts) >
          M_text;
  // the row max after the rule (text entries are f32 min when forced) and
  // the row's log-sum-exp
  const float m2 = force ? fmaxf(M_ts, NEG) : fmaxf(M_ts, M_text);
  const float s_row =
      S_ts * expf(__fsub_rn(M_ts, m2)) +
      (force ? n_text * expf(__fsub_rn(NEG, m2))
             : S_text * expf(__fsub_rn(M_text, m2)));
  const float lse = logf(s_row);

  // 3) scores and this thread's K largest keys: a key is larger for a
  // higher score, then for a lower column (monotone score bits, then the
  // column's complement); 0 is below every key
  u64 keys[K];
#pragma unroll
  for (int j = 0; j < K; ++j) keys[j] = 0;
  const int ieot = c.eot - v0;  // the eot column in this chunk, if any
  for (int i = tid; i < n; i += THREADS) {
    const float x = (force && v0 + i < c.tsb) ? NEG : f[i];
    const float total = __fadd_rn(__fsub_rn(__fsub_rn(x, m2), lse), base);
    if (i == ieot) eot_scores[row] = total;
    const unsigned o = f32_ord(i == ieot ? NEG : total);
    if (o < (unsigned)(keys[K - 1] >> 32)) continue;  // below the K-th
    const u64 key = ((u64)o << 32) | (FULL - (unsigned)i);
    if (key > keys[K - 1]) {
      keys[K - 1] = key;
#pragma unroll
      for (int j = K - 1; j > 0; --j)
        if (keys[j] > keys[j - 1]) {
          const u64 t = keys[j];
          keys[j] = keys[j - 1];
          keys[j - 1] = t;
        }
    }
  }
  // each warp's K largest, then warp 0 takes the chunk's K largest of
  // those and writes them with flat indices
  warp_top_k<K>(keys, wk[warp]);
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) keys[j] = lane < WARPS ? wk[lane][j] : 0;
    __syncwarp();
    warp_top_k<K>(keys, wk[0]);
    __syncwarp();
    if (lane < K) {
      const u64 key = wk[0][lane];
      const unsigned flat = (unsigned)k * V + v0 + (FULL - (unsigned)key);
      cand[((size_t)row * C + ch) * K + lane] =
          key ? (key & 0xffffffff00000000ull) | (FULL - flat) : 0;
    }
  }
}

// grid B, one warp: the K largest of window b's n = K x C x K candidate
// keys (at most CAND_LANE a lane, held in registers), K rounds, each over
// the keys below the last pick
constexpr int CAND_LANE = MAX_CHUNKS * 8 * 8 / 32;

template <int K>
__global__ void __launch_bounds__(32)
tail_merge_kernel(const u64* cand, int n, float* live_score,
                  long long* top_idx) {
  const int b = blockIdx.x, lane = threadIdx.x;
  u64 ck[CAND_LANE];
#pragma unroll
  for (int j = 0; j < CAND_LANE; ++j) {
    const int i = lane + 32 * j;
    ck[j] = i < n ? cand[(size_t)b * n + i] : 0;
  }
  u64 last = ~0ull;  // every key is below it
  for (int j = 0; j < K; ++j) {
    u64 mine = 0;
#pragma unroll
    for (int x = 0; x < CAND_LANE; ++x)
      if (ck[x] < last && ck[x] > mine) mine = ck[x];
    const u64 best = warp_max_key(mine);
    if (lane == 0) {
      live_score[b * K + j] = f32_unord((unsigned)(best >> 32));
      top_idx[b * K + j] = (long long)(FULL - (unsigned)best);
    }
    last = best;
  }
}

template <int K>
int launch_k(const float* logits, const float* sum_lp, const long long* last,
             const long long* pen, const long long* mts, const float* sup,
             const Ids& c, int B, int C, int W, u64* cand, float* live,
             long long* idx, float* eot, cudaStream_t st) {
  const int smem = 2 * (W + 4) * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tail_chunk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  int e = splitkv::launch(tail_chunk_kernel<K>, dim3(C, K, B), THREADS, smem,
                          C, 0, st, logits, sum_lp, last, pen, mts, sup, c, W,
                          eot, cand);
  if (e != 0) return e;
  tail_merge_kernel<K><<<B, 32, 0, st>>>(cand, K * C * K, live, idx);
  return launch_status();
}

}  // namespace

extern "C" {

// The chunk plan for V columns over `rows` = B K beam rows on `sms` SMs:
// out[0] = C, out[1] = W (the card check of ops/beam_tail.py::chunk_plan).
int aries_beam_tail_plan(int V, int rows, int sms, int* out) {
  plan(V, rows, sms, &out[0], &out[1]);
  return 0;
}

// logits (B*K, V) f32; sum_lp (B, K) f32; last/pen/mts (B, K) int64;
// sup (V,) f32; scratch cand (B, K*C*K) 64-bit keys for the plan's C;
// outputs live (B, K) f32, idx (B, K) int64, eot (B, K) f32.
int aries_beam_tail(const float* logits, const float* sum_lp,
                    const long long* last, const long long* pen,
                    const long long* mts, const float* sup, int B, int K,
                    int V, int tsb, int eot, int blank, int no_ts,
                    int init_cap, int with_ts, int suppress_blank,
                    int is_first, int sms, u64* cand, float* live,
                    long long* idx, float* eots, void* stream) {
  const Ids c{V, tsb, eot, blank, no_ts, init_cap, with_ts, suppress_blank,
              is_first};
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || B > 65535 || V <= 0 || sms <= 0 || (long long)K * V > FULL)
    return (int)cudaErrorInvalidValue;
  int C, W;
  plan(V, B * K, sms, &C, &W);
  if (W > MAX_CHUNK) return (int)cudaErrorInvalidValue;
#define ARIES_TAIL(KK)                                                 \
  return launch_k<KK>(logits, sum_lp, last, pen, mts, sup, c, B, C, W, \
                      cand, live, idx, eots, st)
  switch (K) {
    case 1: ARIES_TAIL(1);
    case 2: ARIES_TAIL(2);
    case 3: ARIES_TAIL(3);
    case 4: ARIES_TAIL(4);
    case 5: ARIES_TAIL(5);
    case 6: ARIES_TAIL(6);
    case 7: ARIES_TAIL(7);
    case 8: ARIES_TAIL(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARIES_TAIL
}

}  // extern "C"
