// Split-KV (flash-decoding) attention for one decode step: the self- and
// cross-attention device code of csrc/decode_layers.cu.
//
// The keys of each (row, head) for self-attention, and of each
// (head, window) for cross-attention, are cut into S splits of C keys;
// each split is one block and the S blocks of one row (self) or one
// (head, window) (cross) form a thread-block cluster. The blocks exchange
// their softmax statistics through distributed shared memory, so every
// block forms the same probabilities as one block over all keys would:
//
//   1. each block scores its keys and writes its max m_s;   cluster sync
//   2. each reads every m_r (rank order), M = max_r m_r, and writes
//      l_s = sum over its keys of exp(l_t - M);           cluster sync
//   3. each reads every l_r (rank order), sum = sum_r l_r, forms
//      p_t = exp(l_t - M) / sum (times the value scale; rounded to bf16
//      for self-attention, as the plain version rounds its probabilities)
//      and its partial output o_s = sum over its keys of p_t v_t;
//                                                          cluster sync
//   4. the outputs are sums of the o_r in rank order (a fixed order, so
//      two runs give the same bits);                       cluster sync
//      (the last sync keeps every block's shared memory alive until the
//      others have read it).
// A split holding no live key (self-attention outside [vs, pos]) has
// m_s = -inf and adds nothing; every max and sum guards -inf - (-inf).
//
// Bound: bytes (the int8 cross K/V, the live self cache), read once. The
// cross K/V and the self cache below `pos` are written by no kernel of the
// step, so their loads go out before a block waits for the previous
// kernel: the cross-attention streams its split's K and then V tiles
// through a cp.async ring in shared memory, the self-attention loads each
// thread's K and V rows into registers. The loads overlap the previous
// kernel's tail and each other, and a block's chain of dependent steps
// after the wait is short. The cross plan keeps its grid to one wave.
//
// The split plans depend on shapes fixed for a decode call (Tmax for the
// self cache; Ta, the windows x heads and the SM count for the cross K/V),
// never on `pos`: the step is replayed as a CUDA graph with one fixed grid,
// and `pos` / `valid_start` are read from device memory. The split holding
// `pos` appends this step's K/V (quantizing when the cache is int8) and
// scores it as stored.
//
// Every kernel here waits with griddepcontrol.wait before it reads what
// the previous kernel of the step writes: it may be launched as a
// programmatic dependent of that kernel (PDL).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace splitkv {

constexpr int DH = 64;
constexpr int MAX_SPLITS = 8;     // the portable cluster size
constexpr int SELF_MAX_KEYS = 256;
constexpr int SELF_MAX_SMEM = 96 * 1024;
constexpr int CROSS_THREADS = 256;
constexpr int CROSS_WARPS = CROSS_THREADS / 32;
constexpr int CROSS_BLOCKS_PER_SM = 3;
constexpr int SELF_BLOCKS_PER_SM = 4;  // at 256 threads: <= 64 registers
constexpr int CROSS_MAX_KEYS = 2048;
constexpr int X_TILE = 64;        // keys per cross ring stage
constexpr int X_NST = 8;          // cross ring stages
constexpr int CROSS_GM_MAX = 8;

// programmatic dependent launch: wait for the previous kernel of the
// stream to complete (a no-op when this launch has no PDL attribute), and
// let the next one start launching
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// a cluster barrier split in two: every block arrives at its start
// (relaxed: no memory ordering) and waits just before its first write into
// another block's shared memory, which needs every block of the cluster
// running
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ inline int round32(int c) { return (c + 31) / 32 * 32; }

// Self-attention splits for a cache of T positions: C = the least
// multiple of 32 with at most MAX_SPLITS splits, S = ceil(T / C); the last
// split may be ragged. ops/decode_layers.py::attn_split mirrors it.
__host__ __device__ inline void split_plan(int T, int* S, int* C) {
  int c = round32((T + MAX_SPLITS - 1) / MAX_SPLITS);
  if (c < 32) c = 32;
  *C = c;
  *S = (T + c - 1) / c;
}

// Cross-attention splits over Ta keys for `pairs` = windows x heads on
// `sms` SMs: as many splits (at most 8) as keep the grid one wave of
// CROSS_BLOCKS_PER_SM blocks per SM, C a multiple of 32.
// ops/decode_layers.py::cross_split mirrors it.
__host__ __device__ inline void cross_plan(int Ta, int pairs, int sms, int* S,
                                           int* C) {
  int s = CROSS_BLOCKS_PER_SM * sms / (pairs > 0 ? pairs : 1);
  s = s < 1 ? 1 : (s > MAX_SPLITS ? MAX_SPLITS : s);
  int c = round32((Ta + s - 1) / s);
  if (c < 32) c = 32;
  *C = c;
  *S = (Ta + c - 1) / c;
}

// the four signed bytes of a 32-bit word as exact f32 values, without the
// quarter-rate integer conversion: byte b + 128 becomes the low mantissa
// byte of 2^23 (one byte permute), then one subtraction
__device__ __forceinline__ void i8x4_to_f32(int word, float (&f)[4]) {
  const uint32_t u = (uint32_t)word ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | k)) -
           8388736.f;
}

// two signed bytes (the low 16 bits) as an exact bf16 pair, low byte in
// the low half
__device__ __forceinline__ uint32_t i8x2_to_bf2(uint32_t pair) {
  const uint32_t u = pair ^ 0x8080u;
  const float lo =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  return pack_bf2(lo, hi);
}

// the max / sum over the cluster's ranks of *v (rank order)
__device__ __forceinline__ float cluster_max(cg::cluster_group& cl, float* v,
                                             int S) {
  float m = -INFINITY;
  for (int q = 0; q < S; ++q) m = fmaxf(m, *cl.map_shared_rank(v, q));
  return m;
}

__device__ __forceinline__ float cluster_sum(cg::cluster_group& cl, float* v,
                                             int S) {
  float s = 0.f;
  for (int q = 0; q < S; ++q) s += *cl.map_shared_rank(v, q);
  return s;
}

// ---------------------------------------------------------------- self

struct SelfArgs {
  const bf16* qkv;  // (R, 3d): q | k | v
  int d;
  void* cache;      // (R, 2, H, Tmax, 64) bf16 or int8
  float* csc;       // (R, 2, H, Tmax) f32 scales (int8 cache)
  int H, Tmax, C, HPB;
  const int* step;  // device {pos, valid_start}
  bf16* att;        // (R, d)
};

template <bool INT8>
__host__ __device__ constexpr int self_row_stride() {
  return INT8 ? 64 + 16 : 128 + 16;  // padded: conflict-free row reads
}

// dynamic shared memory of one self-attention block: V rows,
// probabilities, queries, per-warp and per-head partials, stats
template <bool INT8>
__host__ __device__ inline int self_smem_bytes(int HPB, int C) {
  return HPB * C * self_row_stride<INT8>() + HPB * C * 4 +
         HPB * DH * 4 * 2 + HPB * (C / 32) * (DH + 1) * 4 + 2 * HPB * 4;
}

// grid (S, H / HPB, R), cluster (S, 1, 1), HPB x C threads: the block
// takes split s of HPB heads of row r, C threads per head. Thread i of a
// head owns key s C + i: it loads that key's K and V rows (and scales)
// into registers before the wait, scores the key, and puts the V row in
// shared memory, where half-warps own keys in P . V.
template <bool INT8>
__global__ void __launch_bounds__(SELF_MAX_KEYS, SELF_BLOCKS_PER_SM)
self_split_kernel(SelfArgs a) {
  extern __shared__ __align__(16) uint8_t sm_self[];
  constexpr int RS = self_row_stride<INT8>();
  constexpr int NV = INT8 ? 4 : 8;  // 16-byte words per K or V row
  const int C = a.C, HPB = a.HPB, NW = C / 32;
  uint8_t* vsm = sm_self;
  float* ps = reinterpret_cast<float*>(vsm + HPB * C * RS);
  float* qs = ps + HPB * C;
  float* os = qs + HPB * DH;
  float* po = os + HPB * DH;            // (HPB, NW, DH + 1)
  float* stat_m = po + HPB * NW * (DH + 1);
  float* stat_l = stat_m + HPB;
  float* wred = po;                     // reused before P . V
  cg::cluster_group cl = cg::this_cluster();
  const int s = blockIdx.x, r = blockIdx.z, S = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int sub = tid / C, lt = tid - sub * C, wh = lt >> 5;
  const int h = blockIdx.y * HPB + sub;
  const int d = a.d;
  const int t0 = s * C;
  // pos and valid_start were written before the step began
  const int pos = a.step[0], vs = a.step[1];
  const size_t kb = (((size_t)r * 2 + 0) * a.H + h) * a.Tmax;
  const size_t vb = (((size_t)r * 2 + 1) * a.H + h) * a.Tmax;
  int8_t* c8 = static_cast<int8_t*>(a.cache);
  bf16* c16 = static_cast<bf16*>(a.cache);
  const int4* rows16 = static_cast<const int4*>(a.cache);

  // this thread's key: live rows below pos were written by earlier steps,
  // so their loads go out before the wait
  const int t = t0 + lt;
  const bool live = t >= vs && t <= pos && t < a.Tmax;
  int4 kr[NV], vr[NV];
  float ksc = 1.f, vsc = 1.f;
  if (live && t < pos) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      kr[c] = rows16[(kb + t) * NV + c];
      vr[c] = rows16[(vb + t) * NV + c];
    }
    if (INT8) {
      ksc = a.csc[kb + t];
      vsc = a.csc[vb + t];
    }
  }
  pdl_wait();
  pdl_trigger();

  const bf16* row = a.qkv + (size_t)r * 3 * d;
  // the split holding pos appends this step's k and v (each head's first
  // warp)
  if (wh == 0 && pos >= t0 && pos < t0 + C) {
    for (int which = 0; which < 2; ++which) {
      const bf16* src = row + (which + 1) * d + h * DH + 2 * lane;
      const size_t dst = (which == 0 ? kb : vb) + pos;
      if (INT8) {
        const float f0 = bf2f(src[0]), f1 = bf2f(src[1]);
        const float am = warp_max(fmaxf(fabsf(f0), fabsf(f1)));
        const float sc = am > 0.f ? am / 127.f : 1.f;
        const int q0 = max(-127, min(127, __float2int_rn(f0 / sc)));
        const int q1 = max(-127, min(127, __float2int_rn(f1 / sc)));
        c8[dst * DH + 2 * lane] = (int8_t)q0;
        c8[dst * DH + 2 * lane + 1] = (int8_t)q1;
        if (lane == 0) a.csc[dst] = sc;
      } else {
        c16[dst * DH + 2 * lane] = src[0];
        c16[dst * DH + 2 * lane + 1] = src[1];
      }
    }
  }
  for (int j = lt; j < DH; j += C)
    qs[sub * DH + j] = round_bf(__fmul_rn(bf2f(row[h * DH + j]), 0.125f));
  __syncthreads();  // the append (global) and qs are visible to the block
  if (t == pos) {  // the appended row, as stored
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      kr[c] = rows16[(kb + t) * NV + c];
      vr[c] = rows16[(vb + t) * NV + c];
    }
    if (INT8) {
      ksc = a.csc[kb + t];
      vsc = a.csc[vb + t];
    }
  }

  // 1) logits of this split's live keys, the split's max per head; the
  // V rows to shared memory
  const float* q = qs + sub * DH;
  float lg = -INFINITY;
  if (live) {
    int4* vdst = reinterpret_cast<int4*>(vsm + (sub * C + lt) * RS);
#pragma unroll
    for (int c = 0; c < NV; ++c) vdst[c] = vr[c];
    float acc = 0.f;
    if (INT8) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int w[4] = {kr[c].x, kr[c].y, kr[c].z, kr[c].w};
#pragma unroll
        for (int wd = 0; wd < 4; ++wd) {
          float f[4];
          i8x4_to_f32(w[wd], f);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc = fmaf(q[16 * c + 4 * wd + i], f[i], acc);
        }
      }
      lg = __fmul_rn(acc, ksc);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const __nv_bfloat162* p2 =
            reinterpret_cast<const __nv_bfloat162*>(&kr[c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(p2[i]);
          acc = fmaf(q[8 * c + 2 * i], f.x, acc);
          acc = fmaf(q[8 * c + 2 * i + 1], f.y, acc);
        }
      }
      lg = acc;
    }
  }
  const float m = warp_max(lg);
  if (lane == 0) wred[sub * NW + wh] = m;
  __syncthreads();
  if (lt == 0) {
    float v = -INFINITY;
    for (int w = 0; w < NW; ++w) v = fmaxf(v, wred[sub * NW + w]);
    stat_m[sub] = v;
  }
  cl.sync();

  // 2) the global max (finite: pos is live); this split's sum
  const float M = cluster_max(cl, &stat_m[sub], S);
  const float e = live ? expf(lg - M) : 0.f;
  const float sm = warp_sum(e);
  if (lane == 0) wred[HPB * NW + sub * NW + wh] = sm;
  __syncthreads();
  if (lt == 0) {
    float v = 0.f;
    for (int w = 0; w < NW; ++w) v += wred[HPB * NW + sub * NW + w];
    stat_l[sub] = v;
  }
  cl.sync();

  // 3) probabilities (v scale folded in, rounded to bf16) and P . V
  const float sum = cluster_sum(cl, &stat_l[sub], S);
  {
    float p = 0.f;
    if (live) {
      p = e / sum;
      if (INT8) p = p * vsc;
      p = round_bf(p);
    }
    ps[sub * C + lt] = p;
  }
  __syncthreads();  // ps ready; wred no longer read
  const int hl = lane & 15;
  const int klo = max(t0, vs) - t0, khi = min(t0 + C - 1, pos) - t0;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k2 = 0; k2 < 16; ++k2) {
    const int kl = wh * 32 + 2 * k2 + (lane >> 4);
    if (kl < klo || kl > khi) continue;
    const float p = ps[sub * C + kl];
    const uint8_t* vr = vsm + (sub * C + kl) * RS;
    if (INT8) {
      float f[4];
      i8x4_to_f32(*reinterpret_cast<const int*>(vr + 4 * hl), f);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(p, f[j], acc[j]);
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(vr + 8 * hl);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 f0 = __bfloat1622float2(p2[0]);
      const float2 f1 = __bfloat1622float2(p2[1]);
      acc[0] = fmaf(p, f0.x, acc[0]);
      acc[1] = fmaf(p, f0.y, acc[1]);
      acc[2] = fmaf(p, f1.x, acc[2]);
      acc[3] = fmaf(p, f1.y, acc[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 16);
    if (lane < 16) po[(sub * NW + wh) * (DH + 1) + 4 * hl + j] = acc[j];
  }
  __syncthreads();
  for (int j = lt; j < DH; j += C) {
    float o = 0.f;
    for (int w = 0; w < NW; ++w) o += po[(sub * NW + w) * (DH + 1) + j];
    os[sub * DH + j] = o;
  }
  cl.sync();

  // 4) rank 0 sums the splits' outputs in rank order
  if (s == 0) {
    for (int i = tid; i < HPB * DH; i += blockDim.x) {
      float o = 0.f;
      for (int q2 = 0; q2 < S; ++q2) o += *cl.map_shared_rank(&os[i], q2);
      a.att[(size_t)r * d + blockIdx.y * HPB * DH + i] = f2bf(o);
    }
  }
  cl.sync();
}

// ---------------------------------------------------------------- cross

struct CrossArgs {
  const bf16* q;      // (R, d), R = Bw * G rows window-major
  int d;
  const int8_t* kv8;  // (Bw, 2, H, Ta, 64)
  const float* sc;    // (Bw, 2, H, Ta); K scales fold 1/sqrt(dh)
  int H, Ta, C, G;
  bf16* out;          // (R, d)
};

// per-query max (MAX) or sum of v over the block's threads, warps in
// order; every thread gets the results
template <int GM, bool MAX>
__device__ __forceinline__ void block_reduce_g(float (&v)[GM],
                                               float (*wred)[GM]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < GM; ++g) v[g] = MAX ? warp_max(v[g]) : warp_sum(v[g]);
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GM; ++g) wred[warp][g] = v[g];
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    float r = MAX ? -INFINITY : 0.f;
    for (int w = 0; w < CROSS_WARPS; ++w)
      r = MAX ? fmaxf(r, wred[w][g]) : r + wred[w][g];
    v[g] = r;
  }
  __syncthreads();  // wred is reused
}

// dynamic shared memory of one cross-attention block: the ring, the
// split's K and V scales, the GM rows of logits / probabilities
__host__ __device__ inline int cross_smem_bytes(int GM, int C) {
  return X_NST * X_TILE * DH + 2 * C * 4 + GM * C * 4;
}

// grid (S, H, Bw), cluster (S, 1, 1), 256 threads. The split's K tiles
// and then its V tiles (64 keys each) stream through an 8-stage cp.async
// ring; the window's G queries run in chunks of GM (at most 8). Logits on
// the tensor cores (mma.sync m16n8k16: 16 keys x 8 queries a warp, the
// int8 keys converted to bf16 exactly), then times the key scales. P . V
// in f32 as the plain version sums it (the probabilities are not rounded
// there): sixteen threads per key row, 4 dims each, 16 keys at a time.
template <int GM>
__global__ void __launch_bounds__(CROSS_THREADS, CROSS_BLOCKS_PER_SM)
cross_split_kernel(CrossArgs a) {
  extern __shared__ __align__(16) uint8_t sm_x[];
  __shared__ float red[CROSS_WARPS][GM][DH];
  __shared__ float os[GM][DH];
  __shared__ float stat_m[GM], stat_l[GM];
  __shared__ float wred[CROSS_WARPS][GM];
  const int C = a.C;
  uint8_t* ring = sm_x;
  float* kss = reinterpret_cast<float*>(ring + X_NST * X_TILE * DH);
  float* vss = kss + C;
  float* pr = vss + C;  // (GM, C)
  cg::cluster_group cl = cg::this_cluster();
  const int s = blockIdx.x, h = blockIdx.y, w = blockIdx.z, S = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = s * C;
  const int nk = min(C, a.Ta - t0);  // this split's keys (>= 1)
  const int nt = (nk + X_TILE - 1) / X_TILE;
  const size_t kvw = (size_t)w * 2 * a.H * a.Ta;
  const int8_t* kbase = a.kv8 + (kvw + (size_t)h * a.Ta + t0) * DH;
  const int8_t* vbase = a.kv8 + (kvw + (size_t)(a.H + h) * a.Ta + t0) * DH;
  const float* ks = a.sc + kvw + (size_t)h * a.Ta + t0;
  const float* vsg = a.sc + kvw + (size_t)(a.H + h) * a.Ta + t0;

  // tile j < nt: K tile j; nt <= j < 2 nt: V tile j - nt
  auto fetch = [&](int j) {
    if (j >= 2 * nt) return;
    uint8_t* dst = ring + (j % X_NST) * X_TILE * DH;
    const bool isv = j >= nt;
    const int jt = isv ? j - nt : j;
    const int8_t* src = (isv ? vbase : kbase) + (size_t)jt * X_TILE * DH;
    const int rows = min(X_TILE, nk - jt * X_TILE);
    for (int i = tid; i < rows * 4; i += CROSS_THREADS)
      cp16(dst + i * 16, src + i * 16);
  };

  for (int g0 = 0; g0 < a.G; g0 += GM) {
    const int gc = min(GM, a.G - g0);
    const size_t row0 = (size_t)w * a.G + g0;
    // the cross K/V are written by no kernel of the step: the first tiles
    // go out before the wait
    for (int i = tid; i < nk; i += CROSS_THREADS) {
      cp4(kss + i, ks + i);
      cp4(vss + i, vsg + i);
    }
    for (int j = 0; j < X_NST - 1; ++j) {
      fetch(j);
      cp_commit();
    }
    if (g0 == 0) {
      pdl_wait();
      pdl_trigger();
    }
    // the logits run on the tensor cores: the queries are B (dims x 8
    // queries) of mma m16n8k16, the int8 keys A (exact in bf16); lane
    // (qg, qt) holds query qg's dims 2 qt .. of each k16 step
    const int qg = lane >> 2, qt = lane & 3;
    uint32_t qb0[4] = {0u, 0u, 0u, 0u}, qb1[4] = {0u, 0u, 0u, 0u};
    if (qg < gc) {
      const uint32_t* qr = reinterpret_cast<const uint32_t*>(
          a.q + (row0 + qg) * a.d + h * DH);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        qb0[kk] = qr[kk * 8 + qt];
        qb1[kk] = qr[kk * 8 + qt + 4];
      }
    }

    float acc[GM][4];
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[g][j] = 0.f;

    for (int j = 0; j < 2 * nt; ++j) {
      cp_wait<X_NST - 2>();
      __syncthreads();  // tile j landed; the stage of tile j - 1 is free
      fetch(j + X_NST - 1);
      cp_commit();
      const uint8_t* tile = ring + (j % X_NST) * X_TILE * DH;
      if (j < nt) {
        // logits on the tensor cores: warp w < 4 takes keys 16 w .. of the
        // tile (A rows), all 64 dims in four k16 steps
        if (warp < 4) {
          const int m0 = warp * 16;
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint8_t* k0 = tile + (m0 + qg) * DH + kk * 16 + 2 * qt;
            const uint8_t* k1 = k0 + 8 * DH;
            const uint32_t af[4] = {
                i8x2_to_bf2(*reinterpret_cast<const uint16_t*>(k0)),
                i8x2_to_bf2(*reinterpret_cast<const uint16_t*>(k1)),
                i8x2_to_bf2(*reinterpret_cast<const uint16_t*>(k0 + 8)),
                i8x2_to_bf2(*reinterpret_cast<const uint16_t*>(k1 + 8))};
            mma_bf16(c, af, qb0[kk], qb1[kk]);
          }
          // c[e]: key m0 + qg (+8 for e >= 2), query 2 qt + (e & 1)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j * X_TILE + m0 + qg + (e >= 2 ? 8 : 0);
            const int g = 2 * qt + (e & 1);
            if (g < GM && key < nk) pr[g * C + key] = __fmul_rn(c[e], kss[key]);
          }
        }
      } else {
        // P . V: rows 4 (tid / 16) .. + 3 of the tile, dims 4 (tid % 16)
        const int jt = j - nt, kg = tid >> 4, dg = tid & 15;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kl = kg * 4 + i, key = jt * X_TILE + kl;
          if (key < nk) {
            float v[4];
            i8x4_to_f32(*reinterpret_cast<const int*>(tile + kl * DH + 4 * dg),
                        v);
#pragma unroll
            for (int g = 0; g < GM; ++g) {
              const float p = pr[g * C + key];
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[g][c] = fmaf(p, v[c], acc[g][c]);
            }
          }
        }
      }
      if (j == nt - 1) {
        // the split's logits are complete: softmax statistics across
        // the block's threads and the cluster, then the probabilities
        // times the value scales
        __syncthreads();
        float st[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) st[g] = -INFINITY;
        for (int t = tid; t < nk; t += CROSS_THREADS)
#pragma unroll
          for (int g = 0; g < GM; ++g) st[g] = fmaxf(st[g], pr[g * C + t]);
        block_reduce_g<GM, true>(st, wred);
        if (tid == 0)
#pragma unroll
          for (int g = 0; g < GM; ++g) stat_m[g] = st[g];
        cl.sync();
        float M[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          M[g] = cluster_max(cl, &stat_m[g], S);
          st[g] = 0.f;
        }
        for (int t = tid; t < nk; t += CROSS_THREADS)
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            const float e = expf(pr[g * C + t] - M[g]);
            pr[g * C + t] = e;
            st[g] += e;
          }
        block_reduce_g<GM, false>(st, wred);
        if (tid == 0)
#pragma unroll
          for (int g = 0; g < GM; ++g) stat_l[g] = st[g];
        cl.sync();
#pragma unroll
        for (int g = 0; g < GM; ++g) st[g] = cluster_sum(cl, &stat_l[g], S);
        for (int t = tid; t < nk; t += CROSS_THREADS) {
          const float sv = vss[t];
#pragma unroll
          for (int g = 0; g < GM; ++g)
            pr[g * C + t] = __fmul_rn(pr[g * C + t] / st[g], sv);
        }
        // the next iteration's __syncthreads publishes pr
      }
    }
    cp_wait<0>();

    // the block's partial: half-warps, then warps through shared memory
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], 16);
        if (lane < 16) red[warp][g][4 * (lane & 15) + j] = acc[g][j];
      }
    __syncthreads();
    for (int i = tid; i < GM * DH; i += CROSS_THREADS) {
      const int g = i / DH, j = i - g * DH;
      float o = 0.f;
#pragma unroll
      for (int wi = 0; wi < CROSS_WARPS; ++wi) o += red[wi][g][j];
      os[g][j] = o;
    }
    cl.sync();

    // 4) the outputs, spread over the cluster's blocks, each the sum of
    // the splits' partials in rank order
    for (int i = s * CROSS_THREADS + tid; i < gc * DH;
         i += S * CROSS_THREADS) {
      const int g = i / DH, j = i - g * DH;
      float o = 0.f;
      for (int q = 0; q < S; ++q) o += *cl.map_shared_rank(&os[g][j], q);
      a.out[(row0 + g) * a.d + h * DH + j] = f2bf(o);
    }
    cl.sync();  // shared memory is rewritten by the next chunk
  }
}

// ---------------------------------------------------------------- launch

// launch on `st` as a cluster of `cluster` blocks along x (no cluster
// for 0), a programmatic dependent of the stream's previous kernel when
// `pdl`
template <typename Kern, typename... Args>
int launch(Kern kern, dim3 grid, int threads, size_t smem, int cluster,
           int pdl, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (cluster > 0) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (pdl) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return (int)cudaLaunchKernelEx(&cfg, kern, args...);
}

// heads per self-attention block: 4, 2 or 1, dividing H, at most 256
// threads and SELF_MAX_SMEM bytes
inline int self_heads_per_block(int H, int C, int int8) {
  for (int hp = 4; hp > 1; hp /= 2) {
    const int smem = int8 ? self_smem_bytes<true>(hp, C)
                          : self_smem_bytes<false>(hp, C);
    if (H % hp == 0 && hp * C <= SELF_MAX_KEYS && smem <= SELF_MAX_SMEM)
      return hp;
  }
  return 1;
}

inline int launch_self(const SelfArgs& a0, int R, int int8, int pdl,
                       cudaStream_t st) {
  SelfArgs a = a0;
  int S, C;
  split_plan(a.Tmax, &S, &C);
  if (S > MAX_SPLITS || C > SELF_MAX_KEYS || R <= 0 || R > 65535)
    return (int)cudaErrorInvalidValue;
  a.C = C;
  a.HPB = self_heads_per_block(a.H, C, int8);
  const int smem = int8 ? self_smem_bytes<true>(a.HPB, C)
                        : self_smem_bytes<false>(a.HPB, C);
  if (smem > SELF_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const dim3 grid(S, a.H / a.HPB, R);
  const int threads = a.HPB * C;
  return int8 ? launch(self_split_kernel<true>, grid, threads, smem, S, pdl,
                       st, a)
              : launch(self_split_kernel<false>, grid, threads, smem, S, pdl,
                       st, a);
}

inline int launch_cross(const CrossArgs& a0, int Bw, int sms, int pdl,
                        cudaStream_t st) {
  CrossArgs a = a0;
  int S, C;
  cross_plan(a.Ta, Bw * a.H, sms, &S, &C);
  if (S > MAX_SPLITS || C > CROSS_MAX_KEYS || Bw <= 0 || Bw > 65535 ||
      a.G <= 0)
    return (int)cudaErrorInvalidValue;
  a.C = C;
  const dim3 grid(S, a.H, Bw);
  const int T = CROSS_THREADS;
#define ARIES_CROSS(GM)                                                   \
  return launch(cross_split_kernel<GM>, grid, T, cross_smem_bytes(GM, C), \
                S, pdl, st, a)
  switch (a.G) {  // queries per chunk: G itself up to 6, else 8
    case 1: ARIES_CROSS(1);
    case 2: ARIES_CROSS(2);
    case 3: ARIES_CROSS(3);
    case 4: ARIES_CROSS(4);
    case 5: ARIES_CROSS(5);
    case 6: ARIES_CROSS(6);
    default: ARIES_CROSS(8);
  }
#undef ARIES_CROSS
}

}  // namespace splitkv
