// Decode-step self-attention over an int8 self cache: the unfused
// decoder_step's S == 1 branch (models/whisper.py; ops/self_attn.py,
// self_attention_q8_kernel).
//
// Replaces: whisper_aries_tpu/ops/pallas_self_attn.py,
// self_attention_q8_step. One query per (row, head) over that row's cache:
//
//   logits[t] = (q . k8[t]) * ks[t] + mask[t]     ks folds 1/sqrt(dh)
//   p[t]      = softmax_t(logits) * vs[t]          f32, never rounded
//   out       = sum_t p[t] * v8[t]                 f32 (B, H, 1, 64)
//
// The mask row is the one additive row (0 where a position may be read,
// f32 min elsewhere) every row and head shares: positions past the decode
// position hold zeros or stale values, so it is applied, not assumed. It is
// an input (a device tensor), so a CUDA graph replays the kernel at any
// position.
//
// Bound on the H100: bytes. Each (row, head) reads its int8 K and V rows
// (2 x T x 64) and their scales (2 x T f32) once, and the mask row; the
// products (4 x T x 64 per head) are far below the card's rate. At the
// unfused step's 6 rows x 20 heads that is 120 (row, head) pairs, fewer
// than the SMs, so one block per pair leaves the card mostly idle.
//
// Design: split-KV over thread-block clusters (the scheme of
// attn_split.cuh's self-attention, for this cache layout and without the
// append). The T keys of a (row, head) are cut into S splits of C <= 128
// keys (`plan`: S from T, rows x heads and the SM count, never from the
// position, so one grid serves every replay); each split is one block of
// 256 threads, four a key and 16 dims each, and the S blocks of a
// (row, head) form a cluster. Every step is short, since the kernel is a
// latency chain far more than a byte stream:
//   1. each thread loads its keys' 16-byte K and V slices, their scales
//      and mask entries into registers (at most two keys a thread), all
//      before any is used;
//   2. logits: 16 products, two shuffles, then times ks and plus the mask
//      (two roundings, as the plain version); the split's max m_s and sum
//      of exp(l - m_s) are written into every block's shared memory
//      (distributed shared memory);                          cluster sync
//   3. each block reads the S statistics from its own shared memory:
//      M = max_r m_r, and the sum over the ranks, in rank order, of
//      l_r exp(m_r - M); it forms p = exp(l - M) / sum * vs as one block
//      over all keys would, and its P . V from the V slices in registers
//      (shuffles over the warp's keys, then the warps in order), which it
//      writes into rank 0's shared memory;                   cluster sync
//   4. rank 0 sums the splits' partials in rank order (the same bits
//      every run).
// Every remote access is a write before a barrier, so no block waits for
// another to finish reading it; a relaxed arrive at the start (waited
// before the first write) makes sure every block of the cluster runs.
// A split whose keys are all masked has logits near f32 min: each
// exp(l - M) is exactly 0, so it adds exactly 0 to the sum and to P . V.
// The dh-minor (B, H, T, 64) cache makes a key row 64 contiguous bytes; the
// JAX package's time-minor layout is not ported.
#include "attn_split.cuh"

namespace selfq8 {

constexpr int DH = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KEYS_PER_PASS = THREADS / 4;  // four threads a key row
constexpr int PASSES = 2;                   // keys a thread holds
constexpr int MAX_SPLITS = 8;               // the portable cluster size
constexpr int MAX_KEYS = 128;               // keys of one split
static_assert(MAX_KEYS == KEYS_PER_PASS * PASSES, "a key a thread quad");
constexpr int BLOCKS_PER_SM = 2;

// S splits of C keys over T keys for `pairs` = rows x heads on `sms` SMs:
// about BLOCKS_PER_SM blocks per SM (at most MAX_SPLITS a pair, at least
// T / MAX_KEYS), C a multiple of 32; the last split may be ragged.
// ops/self_attn.py::split_plan mirrors it.
__host__ __device__ inline void plan(int T, int pairs, int sms, int* S,
                                     int* C) {
  int s = BLOCKS_PER_SM * sms / (pairs > 0 ? pairs : 1);
  const int least = (T + MAX_KEYS - 1) / MAX_KEYS;
  s = s < least ? least : s;
  s = s < 1 ? 1 : (s > MAX_SPLITS ? MAX_SPLITS : s);
  int c = splitkv::round32((T + s - 1) / s);
  if (c < 32) c = 32;
  *C = c;
  *S = (T + c - 1) / c;
}

struct Args {
  const void* q;               // QT, (b, h, 64)
  long long q_sb, q_sh;
  const int8_t* k8;            // (b, h, t, 64)
  const int8_t* v8;
  long long kv_sb, kv_sh;
  const float* ks;             // (b, h, t)
  const float* vs;
  long long s_sb, s_sh;
  const float* mask;           // (t)
  float* out;                  // (B, H, 64) contiguous
  int H, T, C;
};

// a split's softmax statistics: its max m and sum of exp(l - m)
struct Stat {
  float m, l;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) { return bf2f(*p); }

// 16 products of q[16 c4 ..] with the 16 int8 values of `raw`, f32 sums
__device__ __forceinline__ float dot16(const float (&q)[16], int4 raw) {
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
  float acc = 0.f;
#pragma unroll
  for (int wd = 0; wd < 4; ++wd) {
    float f[4];
    splitkv::i8x4_to_f32(w[wd], f);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = fmaf(q[4 * wd + i], f[i], acc);
  }
  return acc;
}

// grid (S, H, B), cluster (S, 1, 1), THREADS threads: block s takes keys
// s C .. s C + C - 1 of head h of row b; thread (key tid / 4 + 64 p,
// dims 16 (tid % 4) ..) for p < PASSES
template <typename QT>
__global__ void __launch_bounds__(THREADS)
self_q8_kernel(Args a) {
  __shared__ float red[WARPS][DH];
  __shared__ float wm[WARPS], wl[WARPS];
  __shared__ Stat stats[MAX_SPLITS];        // rank r's, written by rank r
  __shared__ float parts[MAX_SPLITS][DH];   // rank r's P . V (rank 0's used)
  cg::cluster_group cl = cg::this_cluster();
  splitkv::cluster_arrive_relaxed();
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z, S = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c4 = tid & 3, kq = tid >> 2;
  const int t0 = s * a.C;
  const int nk = min(a.C, a.T - t0);  // this split's keys (>= 1)
  const size_t kv0 = (size_t)b * a.kv_sb + (size_t)h * a.kv_sh;
  const size_t s0 = (size_t)b * a.s_sb + (size_t)h * a.s_sh;

  // 1) every load first: K and V slices, scales, mask entries, the query
  int4 kr[PASSES], vr[PASSES];
  float ksc[PASSES], vsc[PASSES], mk[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int t = t0 + p * KEYS_PER_PASS + kq;
    if (p * KEYS_PER_PASS + kq < nk) {
      kr[p] = *reinterpret_cast<const int4*>(a.k8 + kv0 + (size_t)t * DH +
                                             16 * c4);
      vr[p] = *reinterpret_cast<const int4*>(a.v8 + kv0 + (size_t)t * DH +
                                             16 * c4);
      ksc[p] = a.ks[s0 + t];
      vsc[p] = a.vs[s0 + t];
      mk[p] = a.mask[t];
    } else {
      kr[p] = vr[p] = make_int4(0, 0, 0, 0);
      ksc[p] = vsc[p] = mk[p] = 0.f;
    }
  }
  const QT* q = static_cast<const QT*>(a.q) + b * a.q_sb + h * a.q_sh +
                16 * c4;
  float qr[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) qr[i] = load_f(q + i);

  // 2) logits (every lane of a key ends with the full sum)
  float l[PASSES];
  float mloc = -INFINITY;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    float acc = dot16(qr, kr[p]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    // the mask added after the scale, never fused into it
    l[p] = __fadd_rn(__fmul_rn(acc, ksc[p]), mk[p]);
    if (p * KEYS_PER_PASS + kq < nk) mloc = fmaxf(mloc, l[p]);
  }
  mloc = warp_max_redux(mloc);
  if (lane == 0) wm[warp] = mloc;
  __syncthreads();
  float m_s = -INFINITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) m_s = fmaxf(m_s, wm[w]);
  float sl = 0.f;
#pragma unroll
  for (int p = 0; p < PASSES; ++p)
    if (c4 == 0 && p * KEYS_PER_PASS + kq < nk) sl += expf(l[p] - m_s);
  sl = warp_sum(sl);
  if (lane == 0) wl[warp] = sl;
  __syncthreads();
  splitkv::cluster_wait();  // every block of the cluster is running
  if (tid < S) {  // this split's statistics into every rank's slot s
    float v = 0.f;
    for (int w = 0; w < WARPS; ++w) v += wl[w];
    *cl.map_shared_rank(&stats[s], tid) = Stat{m_s, v};
  }
  cl.sync();

  // 3) M = the max over the ranks (lane r takes rank r's), the sum over
  // the ranks in rank order; probabilities; P . V
  Stat o = {-INFINITY, 0.f};
  if (lane < S) o = stats[lane];
  const float M = warp_max_redux(o.m);
  const float term = lane < S ? o.l * expf(o.m - M) : 0.f;
  float sum = 0.f;
  for (int r = 0; r < S; ++r) sum += __shfl_sync(0xffffffffu, term, r);
  float e[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p)
    e[p] = p * KEYS_PER_PASS + kq < nk ? expf(l[p] - M) : 0.f;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const float pr = __fmul_rn(e[p] / sum, vsc[p]);
    const int w[4] = {vr[p].x, vr[p].y, vr[p].z, vr[p].w};
#pragma unroll
    for (int wd = 0; wd < 4; ++wd) {
      float f[4];
      splitkv::i8x4_to_f32(w[wd], f);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[4 * wd + i] = fmaf(pr, f[i], acc[4 * wd + i]);
    }
  }
  // the warp's eight keys of each dim group (lanes xor 4, 8, 16), then the
  // warps in order
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 4);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 8);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
  }
  if (lane < 4)
#pragma unroll
    for (int i = 0; i < 16; ++i) red[warp][16 * lane + i] = acc[i];
  __syncthreads();
  if (tid < DH) {  // this split's partial output into rank 0's slot s
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += red[w][tid];
    *cl.map_shared_rank(&parts[s][tid], 0) = o;
  }
  cl.sync();

  // 4) rank 0 sums the splits' partials in rank order; no block reads
  // another's shared memory after the last barrier
  if (s == 0 && tid < DH) {
    float o = 0.f;
    for (int r = 0; r < S; ++r) o += parts[r][tid];
    a.out[((size_t)b * a.H + h) * DH + tid] = o;
  }
}

template <typename QT>
int launch(const Args& a0, int B, int sms, cudaStream_t st) {
  Args a = a0;
  int S, C;
  plan(a.T, B * a.H, sms, &S, &C);
  if (S > MAX_SPLITS || C > MAX_KEYS) return (int)cudaErrorInvalidValue;
  a.C = C;
  return splitkv::launch(self_q8_kernel<QT>, dim3(S, a.H, B), THREADS, 0, S,
                         0, st, a);
}

}  // namespace selfq8

extern "C" {

// The split plan for T keys, `pairs` = rows x heads on `sms` SMs:
// out[0] = S, out[1] = C (the card check of ops/self_attn.py::split_plan).
int aries_self_attn_q8_plan(int T, int pairs, int sms, int* out) {
  selfq8::plan(T, pairs, sms, &out[0], &out[1]);
  return 0;
}

// q (B, H, 1, 64) bf16 (q_bf16 = 1) or f32 with element strides per row
// and head (dims contiguous); k8/v8 (B, H, T, 64) int8 and ks/vs (B, H, T)
// f32 with strides per row and head (t contiguous; the int8 base and
// strides 16-byte aligned); mask (T,) f32; out (B, H, 1, 64) f32
// contiguous; `sms` the card's SM count.
int aries_self_attn_q8(const void* q, int q_bf16, long long q_sb,
                       long long q_sh, const int8_t* k8, const int8_t* v8,
                       long long kv_sb, long long kv_sh, const float* ks,
                       const float* vs, long long s_sb, long long s_sh,
                       const float* mask, float* out, int B, int H, int T,
                       int sms, void* stream) {
  if (mask == nullptr || B <= 0 || B > 65535 || H <= 0 || H > 65535 ||
      T <= 0 || sms <= 0 || (kv_sb % 16) || (kv_sh % 16) ||
      ((uintptr_t)k8 % 16) || ((uintptr_t)v8 % 16))
    return (int)cudaErrorInvalidValue;
  const selfq8::Args a{q,  q_sb, q_sh, k8,   v8,  kv_sb, kv_sh,
                       ks, vs,   s_sb, s_sh, mask, out, H,    T, 0};
  cudaStream_t st = (cudaStream_t)stream;
  return q_bf16 ? selfq8::launch<bf16>(a, B, sms, st)
                : selfq8::launch<float>(a, B, sms, st);
}

}  // extern "C"
