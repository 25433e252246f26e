// The greedy / sampled choice of one decode step (ops/decode_choice.py):
// from a step's (R, V) f32 logits, Whisper's logit rules, the log-softmax of
// the chosen token, the choice (argmax at temperature 0, the Gumbel-max
// draw above it) and the loop state's bookkeeping, in one launch.
//
// Replaces: whisper_aries_tpu/decoding/generate.py:341-380 (`step`: its
// `_apply_filters` (:143), `log_softmax`, `argmax` / the draw of
// `jax.random.categorical` (:364) and the state updates), which XLA fuses
// inside its `lax.while_loop`; no Pallas kernel. The port ran them as some
// thirty torch launches a step, each a pass over (R, V) f32, plus the
// standalone draw kernel writing an (R, V) u.
//
// Layout: one cluster of 8 blocks a row, each block a contiguous eighth of
// the row's ids; 512 threads a block. Two passes over the logits (from L2:
// the vocab product wrote them just before):
//   1. each id's filtered logit f (the suppress mask added, then the rules
//      of decoding/logit_filters.py, every masked entry the f32 minimum
//      NEG exactly as torch.where writes it) and, by region (text: id <
//      timestamp_begin; timestamps: the rest), the maximum of f and the
//      first-index argmax of the choice's key: f at temperature 0, else
//      f * (1 / T) + (-log(-log(u))), u the counter hash of (seed, row,
//      pos, id) computed in registers (draw.cuh; no u is written);
//   2. with the row's maxima (combined through distributed shared memory,
//      so every block holds the same values), the sums of
//      exp(f - m) over the timestamp region (against its own max, for the
//      force rule's logsumexp) and over the row (against the row max).
// Rank 0 then combines the sums (a fixed tree over the ranks) and decides: the force rule
// (the timestamp region's logsumexp against the text region's max, taken
// before that region is masked), the token (the forced or unforced
// argmax; eot for a finished row), its log-probability (f - m) - log(sum),
// and the in-place updates of generate.py's greedy_body: sum_logprob,
// present, finished, tokens[:, pos], max_ts_tok, penult_tok, last_tok. The
// last row's cluster to finish (a counter in the state, back to 0 after)
// advances pos and steps; every block has read pos before that.
//
// Bits: every f, every key and the token are torch's bits (the same f32
// operations one by one: the add, f * reciprocal (PyTorch's CUDA division
// by a host scalar), -logf(-logf(u)) and an add, no contraction into an
// FMA, no fast math); the sums run in another order than torch's
// reductions, so the log-probability and the force rule's logsumexp
// differ from torch's in the last bits. A region masked everywhere sums
// exp(0) = 1 for each id, exactly as torch does, and its logsumexp
// absorbs log(V) into NEG. Bound: bytes, the logits read once (R x V x 4)
// and the mask once (V x 4).
#include <cooperative_groups.h>

#include <climits>

#include "common.cuh"
#include "draw.cuh"

namespace cg = cooperative_groups;

// The C entry's arguments (ops/decode_choice.py::_Args mirrors them).
struct ChoiceArgs {
  const float* logits;       // (R, V), rows row_stride apart
  long long row_stride;
  int V;
  const float* mask;         // (V,) added first
  int no_ts, blank, eot, tsb, init_cap;  // init_cap: tsb + max initial index
  int is_first, with_ts, suppress_blank, sample;
  float inv_t;               // f32 1 / max(T, 1e-6), the sampled rungs'
  unsigned seed_lo, seed_hi;
  unsigned char* finished;   // (R,) bool
  long long* last_tok;       // (R,) int64
  long long* penult_tok;
  long long* max_ts_tok;
  long long* tokens;         // (R, L) int64
  int L;
  int* pos;                  // () int32
  float* sum_logprob;        // (R,)
  unsigned char* present;    // (R, V) bool, or null
  int* steps;                // () int32
  int* arrived;              // () int32, 0 between launches
};

namespace {

constexpr int CH_BLOCKS = 8;      // a cluster a row
constexpr int CH_THREADS = 512;
constexpr int CH_WARPS = CH_THREADS / 32;
constexpr float NEG = -3.40282346638528859811704183484516925e+38f;  // f32 min

// a row's rules (decoding/logit_filters.py) from its state
struct RowRules {
  bool first_blank, with_ts, sup_ts, sup_text, has_ts, is_first;
  long long floor;
};

__device__ __forceinline__ RowRules row_rules(const ChoiceArgs& a, int r) {
  RowRules w;
  const long long last = a.last_tok[r], penult = a.penult_tok[r];
  const long long mts = a.max_ts_tok[r];
  const bool last_ts = last >= a.tsb, penult_ts = penult >= a.tsb;
  w.is_first = a.is_first;
  w.first_blank = a.is_first && a.suppress_blank;
  w.with_ts = a.with_ts;
  w.sup_ts = last_ts && penult_ts;
  w.sup_text = last_ts && !penult_ts;
  w.has_ts = mts >= a.tsb;
  w.floor = w.sup_text ? mts : mts + 1;
  return w;
}

__device__ __forceinline__ float filtered(const ChoiceArgs& a,
                                          const RowRules& w, int v, float l) {
  float f = __fadd_rn(l, a.mask[v]);
  if (v == a.no_ts) f = NEG;
  if (w.first_blank && (v == a.blank || v == a.eot)) f = NEG;
  const bool ts = v >= a.tsb;
  if (!w.with_ts) return ts ? NEG : f;
  if (w.sup_ts && ts) f = NEG;
  if (w.sup_text && v < a.eot) f = NEG;
  if (ts && (long long)v < w.floor && w.has_ts) f = NEG;
  if (w.is_first && (v < a.tsb || v > a.init_cap)) f = NEG;
  return f;
}

// pass 1's partials: per region the max of f and the argmax of the key
struct Part {
  float mt, mts;   // max f: text, timestamps
  float kt, kts;   // best key
  int it, its;     // its id (the first on ties)
};

__device__ __forceinline__ void better(float& k, int& i, float k2, int i2) {
  if (k2 > k || (k2 == k && i2 < i)) {
    k = k2;
    i = i2;
  }
}

__device__ __forceinline__ void combine(Part& p, const Part& q) {
  p.mt = fmaxf(p.mt, q.mt);
  p.mts = fmaxf(p.mts, q.mts);
  better(p.kt, p.it, q.kt, q.it);
  better(p.kts, p.its, q.kts, q.its);
}

__device__ __forceinline__ Part shfl_part(const Part& p, int o) {
  Part q;
  q.mt = __shfl_xor_sync(0xffffffffu, p.mt, o);
  q.mts = __shfl_xor_sync(0xffffffffu, p.mts, o);
  q.kt = __shfl_xor_sync(0xffffffffu, p.kt, o);
  q.kts = __shfl_xor_sync(0xffffffffu, p.kts, o);
  q.it = __shfl_xor_sync(0xffffffffu, p.it, o);
  q.its = __shfl_xor_sync(0xffffffffu, p.its, o);
  return q;
}

__global__ void __cluster_dims__(CH_BLOCKS, 1, 1) __launch_bounds__(CH_THREADS)
choice_kernel(const ChoiceArgs a) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int r = blockIdx.y;
  const int R = gridDim.y;
  const int V = a.V;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ Part warp_part[CH_WARPS];
  __shared__ Part block_part;          // read by the cluster
  __shared__ float warp_sum2[CH_WARPS][2];
  __shared__ float block_sum2[2];      // read by rank 0
  __shared__ float row_max[2];         // the row's mts (>= NEG) and max

  const int pos = *a.pos;
  const bool fin = a.finished[r] != 0;
  const RowRules w = row_rules(a, r);
  const float* row = a.logits + (long long)r * a.row_stride;
  const int slice = (V + CH_BLOCKS - 1) / CH_BLOCKS;
  const int lo = rank * slice, hi = min(V, lo + slice);
  const int end = fin ? lo : hi;  // a finished row takes eot: no passes
  const uint32_t key = draw_key(a.seed_lo, a.seed_hi, r, pos);

  // pass 1
  Part p{-INFINITY, -INFINITY, -INFINITY, -INFINITY, INT_MAX, INT_MAX};
#pragma unroll 4
  for (int v = lo + threadIdx.x; v < end; v += CH_THREADS) {
    const float f = filtered(a, w, v, row[v]);
    float k = f;
    if (a.sample) {
      const float g = -logf(-logf(draw_uniform(key, v)));
      k = __fadd_rn(__fmul_rn(f, a.inv_t), g);
    }
    if (v < a.tsb) {
      p.mt = fmaxf(p.mt, f);
      better(p.kt, p.it, k, v);
    } else {
      p.mts = fmaxf(p.mts, f);
      better(p.kts, p.its, k, v);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) combine(p, shfl_part(p, o));
  if (lane == 0) warp_part[warp] = p;
  __syncthreads();
  if (threadIdx.x == 0) {
    Part b = warp_part[0];
    for (int q = 1; q < CH_WARPS; ++q) combine(b, warp_part[q]);
    block_part = b;
  }
  cl.sync();
  if (warp == 0) {  // lane q reads rank q's partials; maxima and first
    // indices do not depend on the order they combine in
    Part c{-INFINITY, -INFINITY, -INFINITY, -INFINITY, INT_MAX, INT_MAX};
    if (lane < CH_BLOCKS) c = *cl.map_shared_rank(&block_part, lane);
#pragma unroll
    for (int o = CH_BLOCKS / 2; o > 0; o >>= 1) combine(c, shfl_part(c, o));
    if (lane == 0) {
      // torch's maxima: the timestamp logsumexp's over where(ts, f, NEG)
      // (NEG where the text region is not empty), the softmax's over f
      row_max[0] = a.tsb > 0 ? fmaxf(c.mts, NEG) : c.mts;
      row_max[1] = fmaxf(c.mt, c.mts);
      warp_part[0] = c;  // rank 0's thread 0 decides from it
    }
  }
  __syncthreads();
  const float m_ts = row_max[0], m_all = row_max[1];

  // pass 2
  float s_ts = 0.f, s_all = 0.f;
#pragma unroll 4
  for (int v = lo + threadIdx.x; v < end; v += CH_THREADS) {
    const float f = filtered(a, w, v, row[v]);
    s_all += expf(f - m_all);
    if (v >= a.tsb) s_ts += expf(f - m_ts);
  }
  s_ts = warp_sum(s_ts);
  s_all = warp_sum(s_all);
  if (lane == 0) {
    warp_sum2[warp][0] = s_ts;
    warp_sum2[warp][1] = s_all;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float b0 = 0.f, b1 = 0.f;
    for (int q = 0; q < CH_WARPS; ++q) {
      b0 += warp_sum2[q][0];
      b1 += warp_sum2[q][1];
    }
    block_sum2[0] = b0;
    block_sum2[1] = b1;
  }
  cl.sync();
  float sum_ts = 0.f, sum_all = 0.f;
  if (rank == 0 && warp == 0) {  // lane q reads rank q's sums; a fixed tree
    if (lane < CH_BLOCKS) {
      const float* s = cl.map_shared_rank(block_sum2, lane);
      sum_ts = s[0];
      sum_all = s[1];
    }
#pragma unroll
    for (int o = CH_BLOCKS / 2; o > 0; o >>= 1) {
      sum_ts += __shfl_xor_sync(0xffffffffu, sum_ts, o);
      sum_all += __shfl_xor_sync(0xffffffffu, sum_all, o);
    }
  }
  cl.sync();  // no block leaves before rank 0 has read its sums
  if (rank != 0 || threadIdx.x != 0) return;

  const Part c = warp_part[0];
  int tok = a.eot;
  float lp = 0.f;
  if (!fin) {
    // the text ids (< tsb, masked: exp(NEG - m_ts)) in the logsumexp
    const float n_text = (float)min(a.tsb, V);
    const float ts_lp = logf(sum_ts + n_text * expf(NEG - m_ts)) + m_ts;
    const bool force = w.with_ts && ts_lp > c.mt;
    float m_f, s_f;
    if (force) {  // text masked: the row's max is the timestamp region's
      tok = c.its;
      m_f = m_ts;
      s_f = sum_ts + n_text * expf(NEG - m_ts);
    } else {
      tok = (c.kt > c.kts || (c.kt == c.kts && c.it < c.its)) ? c.it : c.its;
      m_f = m_all;
      s_f = sum_all;
    }
    const float f_tok = filtered(a, w, tok, row[tok]);
    lp = (f_tok - m_f) - logf(s_f);
  }
  a.sum_logprob[r] = a.sum_logprob[r] + (fin ? 0.f : lp);
  if (a.present != nullptr && !fin) a.present[(long long)r * V + tok] = 1;
  a.finished[r] = (fin || tok == a.eot) ? 1 : 0;
  if (pos < a.L) a.tokens[(long long)r * a.L + pos] = tok;
  if (tok >= a.tsb && tok > a.max_ts_tok[r]) a.max_ts_tok[r] = tok;
  a.penult_tok[r] = a.last_tok[r];
  a.last_tok[r] = tok;
  __threadfence();
  if (atomicAdd(a.arrived, 1) == R - 1) {  // the last row: advance
    *a.pos = pos + 1;
    *a.steps += 1;
    *a.arrived = 0;
  }
}

}  // namespace

extern "C" {

// The choice of rows 0..R-1 (one cluster of 8 blocks a row) on `stream`.
int aries_decode_choice(const ChoiceArgs* args, int R, void* stream) {
  if (!args || R <= 0 || R > 65535 || args->V <= 0 || !args->logits ||
      !args->mask || !args->finished || !args->last_tok ||
      !args->penult_tok || !args->max_ts_tok || !args->tokens ||
      !args->pos || !args->sum_logprob || !args->steps || !args->arrived ||
      args->L <= 0 || args->row_stride < args->V)
    return (int)cudaErrorInvalidValue;
  choice_kernel<<<dim3(CH_BLOCKS, R), CH_THREADS, 0, (cudaStream_t)stream>>>(
      *args);
  return launch_status();
}

}  // extern "C"
