// Split-KV (flash-decoding) attention: the self- and cross-attention
// device code of the decode step (csrc/decode_layers.cu), and the
// cross-attention of the standalone grouped entry (csrc/cross_attn.cu: the
// prefills).
//
// Replaces: the attention inside whisper_aries_tpu/ops/
// pallas_decode_layers.py, fused_decoder_layers, and (the standalone
// entry) whisper_aries_tpu/ops/pallas_cross_attn.py, cross_attention_q8 and
// cross_attention_q8_blocked.
//
// The keys of each (row, head) for self-attention, and of each
// (head, window) for cross-attention, are cut into S splits of C keys;
// each split is one block and the S blocks of one row (self) or one
// (head, window) (cross) form a thread-block cluster. The blocks exchange
// their softmax statistics through distributed shared memory.
//
// Self-attention forms the probabilities as one block over all keys would
// (the plain version rounds them to bf16):
//   1. each block scores its keys and writes its max m_s;   cluster sync
//   2. each reads every m_r (rank order), M = max_r m_r, and writes
//      l_s = sum over its keys of exp(l_t - M);           cluster sync
//   3. each reads every l_r (rank order), sum = sum_r l_r, forms
//      p_t = exp(l_t - M) / sum, rounded to bf16, and its partial output
//      o_s = sum over its keys of p_t v_t;                 cluster sync
//   4. the outputs are sums of the o_r in rank order (a fixed order, so
//      two runs give the same bits);                       cluster sync
//      (the last sync keeps every block's shared memory alive until the
//      others have read it).
// A split holding no live key (outside [vs, pos]) has m_s = -inf and adds
// nothing; every max and sum guards -inf - (-inf).
//
// Cross-attention's probabilities are f32 and never rounded, so each
// block works with its own statistics and one exchange combines them:
// each block scores its keys, takes m_s, l_s = sum of exp(l_t - m_s) and
// o_s = sum of exp(l_t - m_s) vs_t v_t, and writes (m_s, l_s) into every
// block of the cluster and its o_s of each output element into the block
// that sums that element; cluster sync; an output is
// sum_r e^(m_r - M) o_r / sum_r e^(m_r - M) l_r in rank order. Up to 8
// queries a window (every decode step, the prefills' prompt) a block
// works a tile at a time (cross_split_kernel); more (the prefills'
// sampled rungs) run in chunks of 16 with a softmax state per warp and
// P . V on the tensor cores (cross_flash_kernel).
//
// Bound: bytes (the int8 cross K/V, the live self cache), read once. The
// cross K/V and the self cache below `pos` are written by no kernel of the
// step, so their loads go out before a block waits for the previous
// kernel: the cross-attention streams its split's K and then V tiles
// through a cp.async ring in shared memory, the self-attention loads each
// thread's K and V rows into registers. The loads overlap the previous
// kernel's tail and each other, and a block's chain of dependent steps
// after the wait is short. The cross plans keep their grids to one wave.
//
// The split plans depend on shapes fixed for a decode call (Tmax for the
// self cache; Ta, the windows x heads and the SM count for the cross K/V),
// never on `pos`: the step is replayed as a CUDA graph with one fixed grid,
// and `pos` / `valid_start` are read from device memory. The split holding
// `pos` appends this step's K/V (quantizing when the cache is int8) and
// scores it as stored. The speculative verify step runs the self-attention
// with NQ drafted queries a cache row (self_verify_kernel<INT8, NQ, F32>):
// query q appends at pos + q and attends over [valid_start, pos + q].
//
// Every kernel here waits with griddepcontrol.wait before it reads what
// the previous kernel of the step writes: it may be launched as a
// programmatic dependent of that kernel (PDL); the standalone entry
// launches without it.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

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
constexpr int FLASH_BLOCKS_PER_SM = 2;  // the per-warp cross kernel's
constexpr int SELF_BLOCKS_PER_SM = 4;  // at 256 threads: <= 64 registers
constexpr int CROSS_MAX_KEYS = 2048;
constexpr int X_TILE = 64;        // keys a tile, per-warp cross kernel

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

// Cross-attention splits over Ta keys for `pairs` = windows x heads with
// G queries a window on `sms` SMs: as many splits (at most 8) as keep the
// grid one wave of the kernel's blocks per SM (CROSS_BLOCKS_PER_SM for the
// block-wide kernel, up to 8 queries; FLASH_BLOCKS_PER_SM for the per-warp
// one), C a multiple of 32. ops/decode_layers.py::cross_split mirrors it.
__host__ __device__ inline void cross_plan(int Ta, int pairs, int G, int sms,
                                           int* S, int* C) {
  const int per_sm = G > 8 ? FLASH_BLOCKS_PER_SM : CROSS_BLOCKS_PER_SM;
  int s = per_sm * sms / (pairs > 0 ? pairs : 1);
  s = s < 1 ? 1 : (s > MAX_SPLITS ? MAX_SPLITS : s);
  int c = round32((Ta + s - 1) / s);
  if (c < 32) c = 32;
  *C = c;
  *S = (Ta + c - 1) / c;
}

using ::i8x4_to_f32;  // common.cuh

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
  const void* qkv;  // (R, 3d) bf16 or f32 (F32): q | k | v; row c NQ + q
                    // is query q of row c
  int d;
  void* cache;      // (R / NQ, 2, H, Tmax, 64) bf16, f32 (F32) or int8
  float* csc;       // (R / NQ, 2, H, Tmax) f32 scales (int8 cache)
  int H, Tmax, C, HPB;
  const int* step;  // device {pos, valid_start}
  bf16* att;        // (R, d)
};

// queries a cache row the self-attention takes: 1 (a decode step) or up to
// SELF_MAX_QUERIES drafted tokens (the speculative verify step)
constexpr int SELF_MAX_QUERIES = 8;

// bytes of a staged cache row: int8, bf16, or f32 (an f32 self cache, F32
// without INT8), padded: conflict-free row reads
template <bool INT8, bool F32 = false>
__host__ __device__ constexpr int self_row_stride() {
  return INT8 ? 64 + 16 : (F32 ? 256 + 16 : 128 + 16);
}

// dynamic shared memory of one self-attention block: V rows (shared by
// the NQ queries; an f32 cache stages its K rows too), and a query's
// probabilities, query, per-head and per-warp partials and stats, NQ times
template <bool INT8, bool F32 = false>
__host__ __device__ inline int self_smem_bytes(int HPB, int C, int NQ) {
  return (F32 && !INT8 ? 2 : 1) * HPB * C * self_row_stride<INT8, F32>() +
         NQ * (HPB * C * 4 + HPB * DH * 4 * 2 +
               HPB * (C / 32) * (DH + 1) * 4 + 2 * HPB * 4);
}

__device__ __forceinline__ float to_f(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// grid (S, H / HPB, R), cluster (S, 1, 1), HPB x C threads: the block
// takes split s of HPB heads of row r, C threads per head. Thread i of a
// head owns key s C + i: it loads that key's K and V rows (and scales)
// into registers before the wait, scores the key, and puts the V row in
// shared memory, where half-warps own keys in P . V.
//
// F32 is the f32 residual stream's instantiation (compute_type "f32", the
// JAX megakernel at x f32): qkv f32, the query scaled without a rounding,
// K/V appended from their f32 values (quantized, or stored into an f32
// cache), probabilities f32 into P . V. An f32 cache row (256 bytes) is
// staged by cp.async, K beside V, into shared memory instead of registers.
template <bool INT8, bool F32 = false>
__global__ void __launch_bounds__(SELF_MAX_KEYS, SELF_BLOCKS_PER_SM)
self_split_kernel(SelfArgs a) {
  extern __shared__ __align__(16) uint8_t sm_self[];
  using QT = std::conditional_t<F32, float, bf16>;
  constexpr bool CF32 = F32 && !INT8;  // an f32 self cache
  constexpr int RS = self_row_stride<INT8, F32>();
  // 16-byte words per K or V row held in registers (none: f32 cache)
  constexpr int NV = INT8 ? 4 : (CF32 ? 1 : 8);
  const int C = a.C, HPB = a.HPB, NW = C / 32;
  uint8_t* vsm = sm_self;
  uint8_t* ksm = vsm + HPB * C * RS;  // the f32 cache's K rows
  float* ps = reinterpret_cast<float*>(vsm + (CF32 ? 2 : 1) * HPB * C * RS);
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
  float* c32 = static_cast<float*>(a.cache);
  const int4* rows16 = static_cast<const int4*>(a.cache);
  int4* kst = reinterpret_cast<int4*>(ksm + (sub * C + lt) * RS);
  int4* vst = reinterpret_cast<int4*>(vsm + (sub * C + lt) * RS);

  // this thread's key: live rows below pos were written by earlier steps,
  // so their loads go out before the wait
  const int t = t0 + lt;
  const bool live = t >= vs && t <= pos && t < a.Tmax;
  int4 kr[NV], vr[NV];
  float ksc = 1.f, vsc = 1.f;
  if (live && t < pos) {
    if constexpr (CF32) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        cp16(kst + c, rows16 + (kb + t) * 16 + c);
        cp16(vst + c, rows16 + (vb + t) * 16 + c);
      }
    } else {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        kr[c] = rows16[(kb + t) * NV + c];
        vr[c] = rows16[(vb + t) * NV + c];
      }
    }
    if (INT8) {
      ksc = a.csc[kb + t];
      vsc = a.csc[vb + t];
    }
  }
  if constexpr (CF32) cp_commit();
  pdl_wait();
  pdl_trigger();

  const QT* row = static_cast<const QT*>(a.qkv) + (size_t)r * 3 * d;
  // the split holding pos appends this step's k and v (each head's first
  // warp)
  if (wh == 0 && pos >= t0 && pos < t0 + C) {
    for (int which = 0; which < 2; ++which) {
      const QT* src = row + (which + 1) * d + h * DH + 2 * lane;
      const size_t dst = (which == 0 ? kb : vb) + pos;
      if constexpr (INT8) {
        const float f0 = to_f(src[0]), f1 = to_f(src[1]);
        const float am = warp_max(fmaxf(fabsf(f0), fabsf(f1)));
        const float sc = am > 0.f ? am / 127.f : 1.f;
        const int q0 = max(-127, min(127, __float2int_rn(f0 / sc)));
        const int q1 = max(-127, min(127, __float2int_rn(f1 / sc)));
        c8[dst * DH + 2 * lane] = (int8_t)q0;
        c8[dst * DH + 2 * lane + 1] = (int8_t)q1;
        if (lane == 0) a.csc[dst] = sc;
      } else if constexpr (CF32) {
        c32[dst * DH + 2 * lane] = src[0];
        c32[dst * DH + 2 * lane + 1] = src[1];
      } else {
        c16[dst * DH + 2 * lane] = src[0];
        c16[dst * DH + 2 * lane + 1] = src[1];
      }
    }
  }
  for (int j = lt; j < DH; j += C) {
    const float qj = __fmul_rn(to_f(row[h * DH + j]), 0.125f);
    qs[sub * DH + j] = F32 ? qj : round_bf(qj);
  }
  __syncthreads();  // the append (global) and qs are visible to the block
  if (t == pos) {  // the appended row, as stored
    if constexpr (CF32) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        kst[c] = rows16[(kb + t) * 16 + c];
        vst[c] = rows16[(vb + t) * 16 + c];
      }
    } else {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        kr[c] = rows16[(kb + t) * NV + c];
        vr[c] = rows16[(vb + t) * NV + c];
      }
    }
    if (INT8) {
      ksc = a.csc[kb + t];
      vsc = a.csc[vb + t];
    }
  }
  // the f32 cache's staged rows: this thread's K row (read by it alone)
  // and V row (read by others after the barrier before P . V) landed
  if constexpr (CF32) cp_wait<0>();

  // 1) logits of this split's live keys, the split's max per head; the
  // V rows to shared memory
  const float* q = qs + sub * DH;
  float lg = -INFINITY;
  if (live) {
    float acc = 0.f;
    if constexpr (!CF32) {
#pragma unroll
      for (int c = 0; c < NV; ++c) vst[c] = vr[c];
    }
    if constexpr (CF32) {
      const float4* kp = reinterpret_cast<const float4*>(kst);
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float4 f = kp[c];
        acc = fmaf(q[4 * c], f.x, acc);
        acc = fmaf(q[4 * c + 1], f.y, acc);
        acc = fmaf(q[4 * c + 2], f.z, acc);
        acc = fmaf(q[4 * c + 3], f.w, acc);
      }
      lg = acc;
    } else if (INT8) {
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
      if (!F32) p = round_bf(p);
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
    if constexpr (CF32) {
      const float4 f = *reinterpret_cast<const float4*>(vr + 16 * hl);
      acc[0] = fmaf(p, f.x, acc[0]);
      acc[1] = fmaf(p, f.y, acc[1]);
      acc[2] = fmaf(p, f.z, acc[2]);
      acc[3] = fmaf(p, f.w, acc[3]);
    } else if (INT8) {
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

// The verify step's self-attention: grid (S, H / HPB, R / NQ), cluster
// (S, 1, 1), HPB x C threads, NQ >= 2 drafted queries a cache row. As
// self_split_kernel, the block takes split s of HPB heads of cache row c,
// a thread a key, loading its K and V rows before the wait; it scores
// each key against all NQ queries of row c (query q at position pos + q),
// so the self cache is read once for NQ queries.
//
// Query q appends its K/V at pos + q and attends over [vs, pos + q], so
// it reads the rows pos .. pos + q - 1 that the same launch appends for
// the queries before it. Blocks of one grid are not ordered, so every key
// is appended and read by one block: the split that holds position
// pos + q appends it (from qkv row c NQ + q), syncs, and reloads it as
// stored, as self_split_kernel does with pos. A block reads only lanes of
// its own split that it wrote itself or that earlier launches wrote;
// lanes pos .. pos + NQ - 1 may hold drafts an earlier verify rejected,
// which are always rewritten before they are read (the preload stays
// t < pos). Each query keeps its own causal limit, split max and sum and
// P . V, every sum in self_split_kernel's order, so query q gives the
// bits of a one-token step at pos + q. The shared memory holds the V rows
// once and each query's probabilities, query, partials and statistics.
//
// F32 is the f32 residual stream's instantiation, query for query what
// self_split_kernel<INT8, true> computes: qkv f32, each query scaled
// without a rounding, K/V appended from their f32 values (quantized, or
// stored into an f32 cache), probabilities f32 into P . V. An f32 cache
// row (256 bytes) is staged by cp.async, K beside V, in shared memory
// (self_smem_bytes<false, true> counts both), as the one-token kernel
// stages it: in registers, the K and V rows of a thread would take 128.
template <bool INT8, int NQ, bool F32 = false>
__global__ void __launch_bounds__(SELF_MAX_KEYS, 2)
self_verify_kernel(SelfArgs a) {
  extern __shared__ __align__(16) uint8_t sm_self[];
  using QT = std::conditional_t<F32, float, bf16>;
  constexpr bool CF32 = F32 && !INT8;  // an f32 self cache
  constexpr int RS = self_row_stride<INT8, F32>();
  // 16-byte words per K or V row held in registers (none: f32 cache)
  constexpr int NV = INT8 ? 4 : (CF32 ? 1 : 8);
  const int C = a.C, HPB = a.HPB, NW = C / 32;
  uint8_t* vsm = sm_self;
  uint8_t* ksm = vsm + HPB * C * RS;  // the f32 cache's K rows
  // (NQ, HPB, C)
  float* ps = reinterpret_cast<float*>(vsm + (CF32 ? 2 : 1) * HPB * C * RS);
  float* qs = ps + NQ * HPB * C;                             // (NQ, HPB, DH)
  float* os = qs + NQ * HPB * DH;                            // (NQ, HPB, DH)
  float* po = os + NQ * HPB * DH;  // (NQ, HPB, NW, DH + 1)
  float* stat_m = po + NQ * HPB * NW * (DH + 1);             // (NQ, HPB)
  float* stat_l = stat_m + NQ * HPB;
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
  float* c32 = static_cast<float*>(a.cache);
  const int4* rows16 = static_cast<const int4*>(a.cache);
  int4* kst = reinterpret_cast<int4*>(ksm + (sub * C + lt) * RS);
  int4* vst = reinterpret_cast<int4*>(vsm + (sub * C + lt) * RS);

  // this thread's key, live for some query; rows below pos were written by
  // earlier steps, so their loads go out before the wait
  const int t = t0 + lt;
  const bool live = t >= vs && t <= pos + NQ - 1 && t < a.Tmax;
  // live for query q (the one-query kernel's `live` at position pos + q)
  auto live_q = [&](int q) { return live && t <= pos + q; };
  int4 kr[NV], vr[NV];
  float ksc = 1.f, vsc = 1.f;
  if (live && t < pos) {
    if constexpr (CF32) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        cp16(kst + c, rows16 + (kb + t) * 16 + c);
        cp16(vst + c, rows16 + (vb + t) * 16 + c);
      }
    } else {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        kr[c] = rows16[(kb + t) * NV + c];
        vr[c] = rows16[(vb + t) * NV + c];
      }
    }
    if (INT8) {
      ksc = a.csc[kb + t];
      vsc = a.csc[vb + t];
    }
  }
  if constexpr (CF32) cp_commit();
  pdl_wait();
  pdl_trigger();

  // the split holding position pos + q appends query q's k and v (each
  // head's first warp)
  if (wh == 0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int tp = pos + q;
      if (tp < t0 || tp >= t0 + C) continue;
      const QT* row =
          static_cast<const QT*>(a.qkv) + ((size_t)r * NQ + q) * 3 * d;
      for (int which = 0; which < 2; ++which) {
        const QT* src = row + (which + 1) * d + h * DH + 2 * lane;
        const size_t dst = (which == 0 ? kb : vb) + tp;
        if constexpr (INT8) {
          const float f0 = to_f(src[0]), f1 = to_f(src[1]);
          const float am = warp_max(fmaxf(fabsf(f0), fabsf(f1)));
          const float sc = am > 0.f ? am / 127.f : 1.f;
          const int q0 = max(-127, min(127, __float2int_rn(f0 / sc)));
          const int q1 = max(-127, min(127, __float2int_rn(f1 / sc)));
          c8[dst * DH + 2 * lane] = (int8_t)q0;
          c8[dst * DH + 2 * lane + 1] = (int8_t)q1;
          if (lane == 0) a.csc[dst] = sc;
        } else if constexpr (CF32) {
          c32[dst * DH + 2 * lane] = src[0];
          c32[dst * DH + 2 * lane + 1] = src[1];
        } else {
          c16[dst * DH + 2 * lane] = src[0];
          c16[dst * DH + 2 * lane + 1] = src[1];
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const QT* row =
        static_cast<const QT*>(a.qkv) + ((size_t)r * NQ + q) * 3 * d;
    for (int j = lt; j < DH; j += C) {
      const float qj = __fmul_rn(to_f(row[h * DH + j]), 0.125f);
      qs[(q * HPB + sub) * DH + j] = F32 ? qj : round_bf(qj);
    }
  }
  __syncthreads();  // the append (global) and qs are visible to the block
  if (live && t >= pos) {  // an appended row, as stored
    if constexpr (CF32) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        kst[c] = rows16[(kb + t) * 16 + c];
        vst[c] = rows16[(vb + t) * 16 + c];
      }
    } else {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        kr[c] = rows16[(kb + t) * NV + c];
        vr[c] = rows16[(vb + t) * NV + c];
      }
    }
    if (INT8) {
      ksc = a.csc[kb + t];
      vsc = a.csc[vb + t];
    }
  }
  // the f32 cache's staged rows: this thread's K row (read by it alone)
  // and V row (read by others after the barrier before P . V) landed
  if constexpr (CF32) cp_wait<0>();

  // 1) each query's logits of this split's live keys, the split's max per
  // head; the V rows to shared memory
  float lg[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) lg[q] = -INFINITY;
  if (live) {
    if constexpr (!CF32) {
#pragma unroll
      for (int c = 0; c < NV; ++c) vst[c] = vr[c];
    }
    float acc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] = 0.f;
    if constexpr (CF32) {
      const float4* kp = reinterpret_cast<const float4*>(kst);
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float4 f = kp[c];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float* qq = qs + (q * HPB + sub) * DH + 4 * c;
          acc[q] = fmaf(qq[0], f.x, acc[q]);
          acc[q] = fmaf(qq[1], f.y, acc[q]);
          acc[q] = fmaf(qq[2], f.z, acc[q]);
          acc[q] = fmaf(qq[3], f.w, acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        if (live_q(q)) lg[q] = acc[q];
    } else if (INT8) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int w[4] = {kr[c].x, kr[c].y, kr[c].z, kr[c].w};
#pragma unroll
        for (int wd = 0; wd < 4; ++wd) {
          float f[4];
          i8x4_to_f32(w[wd], f);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < NQ; ++q)
              acc[q] = fmaf(qs[(q * HPB + sub) * DH + 16 * c + 4 * wd + i],
                            f[i], acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        if (live_q(q)) lg[q] = __fmul_rn(acc[q], ksc);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const __nv_bfloat162* p2 =
            reinterpret_cast<const __nv_bfloat162*>(&kr[c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(p2[i]);
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const float* qq = qs + (q * HPB + sub) * DH + 8 * c + 2 * i;
            acc[q] = fmaf(qq[0], f.x, acc[q]);
            acc[q] = fmaf(qq[1], f.y, acc[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        if (live_q(q)) lg[q] = acc[q];
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float m = warp_max(lg[q]);
    if (lane == 0) wred[(q * HPB + sub) * NW + wh] = m;
  }
  __syncthreads();
  if (lt == 0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float v = -INFINITY;
      for (int w = 0; w < NW; ++w) v = fmaxf(v, wred[(q * HPB + sub) * NW + w]);
      stat_m[q * HPB + sub] = v;
    }
  }
  cl.sync();

  // 2) each query's global max (finite: pos + q is live); this split's sum
  float e[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float M = cluster_max(cl, &stat_m[q * HPB + sub], S);
    e[q] = live_q(q) ? expf(lg[q] - M) : 0.f;
    const float sm = warp_sum(e[q]);
    if (lane == 0) wred[NQ * HPB * NW + (q * HPB + sub) * NW + wh] = sm;
  }
  __syncthreads();
  if (lt == 0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float v = 0.f;
      for (int w = 0; w < NW; ++w)
        v += wred[NQ * HPB * NW + (q * HPB + sub) * NW + w];
      stat_l[q * HPB + sub] = v;
    }
  }
  cl.sync();

  // 3) probabilities (v scale folded in, rounded to bf16 but at F32) and
  // P . V
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float sum = cluster_sum(cl, &stat_l[q * HPB + sub], S);
    float p = 0.f;
    if (live_q(q)) {
      p = e[q] / sum;
      if (INT8) p = p * vsc;
      if (!F32) p = round_bf(p);
    }
    ps[(q * HPB + sub) * C + lt] = p;
  }
  __syncthreads();  // ps ready; wred no longer read
  const int hl = lane & 15;
  const int klo = max(t0, vs) - t0;
  float acc[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[q][j] = 0.f;
  for (int k2 = 0; k2 < 16; ++k2) {
    const int kl = wh * 32 + 2 * k2 + (lane >> 4);
    // keys past the last query's position, or past the split's end
    if (kl < klo || kl > min(t0 + C - 1, pos + NQ - 1) - t0) continue;
    const uint8_t* vrow = vsm + (sub * C + kl) * RS;
    float f[4];
    if constexpr (CF32) {
      const float4 v4 = *reinterpret_cast<const float4*>(vrow + 16 * hl);
      f[0] = v4.x;
      f[1] = v4.y;
      f[2] = v4.z;
      f[3] = v4.w;
    } else if (INT8) {
      i8x4_to_f32(*reinterpret_cast<const int*>(vrow + 4 * hl), f);
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(vrow + 8 * hl);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 f0 = __bfloat1622float2(p2[0]);
      const float2 f1 = __bfloat1622float2(p2[1]);
      f[0] = f0.x;
      f[1] = f0.y;
      f[2] = f1.x;
      f[3] = f1.y;
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (t0 + kl > pos + q) continue;  // past query q's own position
      const float p = ps[(q * HPB + sub) * C + kl];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][j] = fmaf(p, f[j], acc[q][j]);
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[q][j] += __shfl_xor_sync(0xffffffffu, acc[q][j], 16);
      if (lane < 16)
        po[((q * HPB + sub) * NW + wh) * (DH + 1) + 4 * hl + j] = acc[q][j];
    }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    for (int j = lt; j < DH; j += C) {
      float o = 0.f;
      for (int w = 0; w < NW; ++w)
        o += po[((q * HPB + sub) * NW + w) * (DH + 1) + j];
      os[(q * HPB + sub) * DH + j] = o;
    }
  cl.sync();

  // 4) rank 0 sums the splits' outputs in rank order
  if (s == 0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      for (int i = tid; i < HPB * DH; i += blockDim.x) {
        float o = 0.f;
        for (int q2 = 0; q2 < S; ++q2)
          o += *cl.map_shared_rank(&os[q * HPB * DH + i], q2);
        a.att[((size_t)r * NQ + q) * d + blockIdx.y * HPB * DH + i] = f2bf(o);
      }
  }
  cl.sync();
}

// ---------------------------------------------------------------- cross

// The cross-attention's operands, with element strides per window (w) and
// head (h), and per query (g) for the queries and outputs; within a
// (window, head) the keys are rows of 64 int8 (t-stride 64), the scales
// contiguous in t and the query and output dims contiguous. The decode
// step hands over its (R, d) rows, R = Bw * G window-major, and its packed
// (Bw, 2, H, Ta, 64) K/V; the standalone entry (cross_attn.cu) its
// (Bw, H, G, 64) queries and outputs and (Bw, H, Ta, 64) K/V views.
struct CrossArgs {
  const void* q;      // QT
  long long q_sw, q_sh, q_sg;
  const int8_t* k8;
  const int8_t* v8;
  long long kv_sw, kv_sh;
  const float* ks;    // K scales fold 1/sqrt(dh)
  const float* vs;
  long long s_sw, s_sh;
  void* out;          // OT
  long long o_sw, o_sh, o_sg;
  int H, Ta, C, G;
};

template <typename T> __device__ __forceinline__ void store_f(T* p, float v);
template <> __device__ __forceinline__ void store_f<float>(float* p, float v) {
  *p = v;
}
template <> __device__ __forceinline__ void store_f<bf16>(bf16* p, float v) {
  *p = f2bf(v);
}

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

// The exchange both cross kernels end a chunk of gc <= 16 queries with:
// each split's (m_s, l_s) per query goes into every block of the cluster,
// its partial o_s of each output element into the block that sums that
// element (block i / E, E elements each); cluster sync; an output is
// sum_r e^(m_r - M) o_r / sum_r e^(m_r - M) l_r, in rank order (the same
// bits every run). red: the block's partial, (warps, 16, 64), summed over
// the warps here; own_m / own_l the split's statistics. The caller syncs
// the cluster before it writes into any of these again.
struct CrossExchange {
  float stat_m[MAX_SPLITS][16], stat_l[MAX_SPLITS][16];
  float fac[MAX_SPLITS][16];
  float part[16 * DH + MAX_SPLITS];
};

template <typename OT>
__device__ __forceinline__ void cross_exchange(
    cg::cluster_group& cl, CrossExchange& x, float (*red)[16][DH],
    const float* own_m, const float* own_l, int gc, OT* ow, long long o_sg) {
  const int s = blockIdx.x, S = gridDim.x, tid = threadIdx.x;
  if (tid < S) {  // this split's statistics into block tid
    float* dm = cl.map_shared_rank(&x.stat_m[s][0], tid);
    float* dl = cl.map_shared_rank(&x.stat_l[s][0], tid);
    for (int g = 0; g < gc; ++g) {
      dm[g] = own_m[g];
      dl[g] = own_l[g];
    }
  }
  const int E = (gc * DH + S - 1) / S;
  for (int i = tid; i < gc * DH; i += CROSS_THREADS) {
    const int g = i / DH, jd = i - g * DH, r = i / E;
    float o = 0.f;
#pragma unroll
    for (int wi = 0; wi < CROSS_WARPS; ++wi) o += red[wi][g][jd];
    *cl.map_shared_rank(&x.part[s * E + i - r * E], r) = o;
  }
  cl.sync();

  // each split's factor e^(m_r - M) / sum_r e^(m_r - M) l_r, a query; M is
  // finite (every split holds a key, nothing is masked), and a row of
  // -inf logits would still not form -inf - (-inf)
  if (tid < gc) {
    float M = -INFINITY;
    for (int r = 0; r < S; ++r) M = fmaxf(M, x.stat_m[r][tid]);
    if (M == -INFINITY) M = 0.f;
    float den = 0.f;
    for (int r = 0; r < S; ++r) {
      x.fac[r][tid] = expf(x.stat_m[r][tid] - M);
      den += x.fac[r][tid] * x.stat_l[r][tid];
    }
    for (int r = 0; r < S; ++r) x.fac[r][tid] = x.fac[r][tid] / den;
  }
  __syncthreads();
  for (int e = tid; e < E && s * E + e < gc * DH; e += CROSS_THREADS) {
    const int i = s * E + e, g = i / DH, jd = i - g * DH;
    float o = 0.f;
    for (int q = 0; q < S; ++q) o = fmaf(x.fac[q][g], x.part[q * E + e], o);
    store_f<OT>(ow + (size_t)g * o_sg + jd, o);
  }
}

// a block's ring of cp.async stages: 32 KB
constexpr int X_RING = 32 * 1024;

// queries a chunk of the block-wide kernel: G itself up to 6, else 8
__host__ __device__ inline int cross_gm(int G) { return G <= 6 ? G : 8; }

// dynamic shared memory of one cross-attention block: the ring, the
// split's K and V scales, and for the block-wide kernel its C keys' rows
// of GP = 4 or 8 floats of logits / weights (GM queries)
__host__ __device__ inline int cross_smem_bytes(int GM, int C) {
  return X_RING + 2 * C * 4 + (GM > 8 ? 0 : C * (GM <= 4 ? 4 : 8) * 4);
}

// the float of (key t, query g) in rows of GP floats: 16-byte words
// XOR-swizzled by key so that eight consecutive keys' words sit in
// distinct banks
template <int GP>
__device__ __forceinline__ int prx(int t, int g) {
  return t * GP + ((GP == 8 ? (g >> 2) ^ ((t >> 2) & 1) : 0) << 2) + (g & 3);
}

// the split's K and V scales into shared memory (16-byte copies where
// both rows allow them)
__device__ __forceinline__ void cross_scales(float* kss, float* vss,
                                             const float* ks,
                                             const float* vsg, int nk) {
  const bool sc16 = ((reinterpret_cast<uintptr_t>(ks) |
                      reinterpret_cast<uintptr_t>(vsg)) & 15) == 0;
  const int n16 = sc16 ? nk / 4 : 0;
  for (int i = threadIdx.x; i < n16; i += CROSS_THREADS) {
    cp16(kss + 4 * i, ks + 4 * i);
    cp16(vss + 4 * i, vsg + 4 * i);
  }
  for (int i = 4 * n16 + threadIdx.x; i < nk; i += CROSS_THREADS) {
    cp4(kss + i, ks + i);
    cp4(vss + i, vsg + i);
  }
}

// Block-wide, for chunks of GM <= 8 queries (the decode step's rows of a
// window, the prefills' 3 prompt positions). grid (S, H, Bw), cluster
// (S, 1, 1), 256 threads. The split's K tiles and then its V tiles (128
// keys each: tiles of 64 measured slower, a barrier a tile) stream
// through a 4-stage cp.async ring.
//   * Logits of bf16 queries on the tensor cores (mma.sync m16n8k16: 16
//     keys x 8 queries a warp, the int8 keys converted to bf16 exactly), of
//     f32 queries by f32 FMAs (a bf16 product would round q): a thread a
//     key and every second query; then times the key scales, into a row of
//     GP floats a key.
//   * The split's own statistics once its logits are complete: m_s its
//     max, l_s its sum of exp(l - m_s); its keys' weights exp(l - m_s) vs
//     stay f32, never rounded, as the plain version's probabilities.
//   * P . V by f32 FMAs: sixteen threads a key row, 4 dims each, all GM
//     queries over 8 keys a tile.
//   * The exchange (cross_exchange).
template <typename QT, typename OT, int GM>
__global__ void __launch_bounds__(CROSS_THREADS, CROSS_BLOCKS_PER_SM)
cross_split_kernel(CrossArgs a) {
  constexpr bool QF32 = std::is_same<QT, float>::value;
  constexpr int GP = GM <= 4 ? 4 : 8;
  constexpr int TILE = 16 * CROSS_WARPS;  // keys a tile: 16 a warp
  constexpr int NST = X_RING / (TILE * DH);
  static_assert(GM <= 8, "query chunks of at most 8");
  static_assert(CROSS_WARPS * 16 * DH * 4 <= X_RING,
                "the partial outputs fit the ring");
  extern __shared__ __align__(16) uint8_t sm_x[];
  __shared__ CrossExchange xch;
  __shared__ float own_m[GM], own_l[GM];
  __shared__ float wred[CROSS_WARPS][GM];
  __shared__ __align__(16) float qf[QF32 ? GM : 1][DH];
  const int C = a.C;
  uint8_t* ring = sm_x;
  // the warps' partial outputs, in the ring once its last tile is read
  float(*red)[16][DH] = reinterpret_cast<float(*)[16][DH]>(sm_x);
  float* kss = reinterpret_cast<float*>(ring + X_RING);
  float* vss = kss + C;
  float* pr = vss + C;  // (C, GP), swizzled (prx)
  cg::cluster_group cl = cg::this_cluster();
  const int s = blockIdx.x, h = blockIdx.y, w = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = s * C;
  const int nk = min(C, a.Ta - t0);  // this split's keys (>= 1)
  const int nt = (nk + TILE - 1) / TILE;
  const int8_t* kbase = a.k8 + w * a.kv_sw + h * a.kv_sh + (size_t)t0 * DH;
  const int8_t* vbase = a.v8 + w * a.kv_sw + h * a.kv_sh + (size_t)t0 * DH;
  const float* ks = a.ks + w * a.s_sw + h * a.s_sh + t0;
  const float* vsg = a.vs + w * a.s_sw + h * a.s_sh + t0;
  const QT* qw = static_cast<const QT*>(a.q) + w * a.q_sw + h * a.q_sh;
  OT* ow = static_cast<OT*>(a.out) + w * a.o_sw + h * a.o_sh;
  // waited before the first write into another block's shared memory,
  // which needs every block of the cluster running
  cluster_arrive_relaxed();

  // tile j < nt: K tile j; nt <= j < 2 nt: V tile j - nt
  auto fetch = [&](int j) {
    if (j >= 2 * nt) return;
    uint8_t* dst = ring + (j % NST) * TILE * DH;
    const bool isv = j >= nt;
    const int jt = isv ? j - nt : j;
    const int8_t* src = (isv ? vbase : kbase) + (size_t)jt * TILE * DH;
    const int rows = min(TILE, nk - jt * TILE);
    for (int i = tid; i < rows * 4; i += CROSS_THREADS)
      cp16(dst + i * 16, src + i * 16);
  };

  for (int g0 = 0; g0 < a.G; g0 += GM) {
    const int gc = min(GM, a.G - g0);
    // the cross K/V are written by no kernel of the step: the first tiles
    // go out before the wait
    cross_scales(kss, vss, ks, vsg, nk);
    for (int j = 0; j < NST - 1; ++j) {
      fetch(j);
      cp_commit();
    }
    if (g0 == 0) {
      pdl_wait();
      pdl_trigger();
    }
    // bf16 queries are B (dims x 8 queries) of mma m16n8k16, the int8 keys
    // A (exact in bf16); lane (qg, qt) holds query qg's dims 2 qt .. of
    // each k16 step. f32 queries go to shared memory (zeros past gc),
    // published by the tile loop's first barrier.
    const int qg = lane >> 2, qt = lane & 3;
    uint32_t qb0[4] = {0u, 0u, 0u, 0u}, qb1[4] = {0u, 0u, 0u, 0u};
    if constexpr (QF32) {
      for (int i = tid; i < GM * DH; i += CROSS_THREADS) {
        const int g = i / DH, jd = i - g * DH;
        qf[g][jd] = g < gc ? qw[(size_t)(g0 + g) * a.q_sg + jd] : 0.f;
      }
    } else if (qg < gc) {
      const bf16* qr = qw + (size_t)(g0 + qg) * a.q_sg;
      auto pair = [&](int i) {
        return (uint32_t)__bfloat16_as_ushort(qr[i]) |
               ((uint32_t)__bfloat16_as_ushort(qr[i + 1]) << 16);
      };
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        qb0[kk] = pair(kk * 16 + 2 * qt);
        qb1[kk] = pair(kk * 16 + 2 * qt + 8);
      }
    }

    float acc[GM][4];
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][c] = 0.f;

    for (int j = 0; j < 2 * nt; ++j) {
      cp_wait<NST - 2>();
      __syncthreads();  // tile j landed; the stage of tile j - 1 is free
      fetch(j + NST - 1);
      cp_commit();
      const uint8_t* tile = ring + (j % NST) * TILE * DH;
      if (j < nt) {
        if constexpr (QF32) {
          // thread (key tid % TILE, queries tid / TILE + QG i); the key
          // row's 16-byte words in an order rotated by key pair, so a
          // quarter warp's reads hit distinct banks
          constexpr int QG = CROSS_THREADS / TILE;
          constexpr int NQ = (GM + QG - 1) / QG;
          const int kl = tid % TILE, gq = tid / TILE, key = j * TILE + kl;
          float lg[NQ];
#pragma unroll
          for (int i = 0; i < NQ; ++i) lg[i] = 0.f;
#pragma unroll
          for (int c0 = 0; c0 < 4; ++c0) {
            const int c = (c0 + (kl >> 1)) & 3;
            const int4 raw =
                *reinterpret_cast<const int4*>(tile + kl * DH + 16 * c);
            const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int wd = 0; wd < 4; ++wd) {
              float f[4];
              i8x4_to_f32(words[wd], f);
#pragma unroll
              for (int i = 0; i < NQ; ++i) {
                const int g = gq + QG * i;
                if (g < GM) {
                  const float4 qv =
                      *reinterpret_cast<const float4*>(&qf[g][16 * c + 4 * wd]);
                  lg[i] = fmaf(qv.x, f[0], lg[i]);
                  lg[i] = fmaf(qv.y, f[1], lg[i]);
                  lg[i] = fmaf(qv.z, f[2], lg[i]);
                  lg[i] = fmaf(qv.w, f[3], lg[i]);
                }
              }
            }
          }
          if (key < nk)
#pragma unroll
            for (int i = 0; i < NQ; ++i)
              if (gq + QG * i < GM)
                pr[prx<GP>(key, gq + QG * i)] = __fmul_rn(lg[i], kss[key]);
        } else {
          // warp w takes keys 16 w .. of the tile (A rows), all 64 dims in
          // four k16 steps
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
            const int key = j * TILE + m0 + qg + (e >= 2 ? 8 : 0);
            const int g = 2 * qt + (e & 1);
            if (g < GM && key < nk)
              pr[prx<GP>(key, g)] = __fmul_rn(c[e], kss[key]);
          }
        }
      } else {
        // P . V: half-warp hw takes the tile's rows TILE / 16 hw .., dims
        // 4 (tid % 16) ..
        const int jt = j - nt, hw = tid >> 4, dg = tid & 15;
#pragma unroll
        for (int i = 0; i < TILE / 16; ++i) {
          const int kl = hw * (TILE / 16) + i, key = jt * TILE + kl;
          if (key < nk) {
            float v[4];
            i8x4_to_f32(*reinterpret_cast<const int*>(tile + kl * DH + 4 * dg),
                        v);
#pragma unroll
            for (int g4 = 0; g4 < GP / 4; ++g4) {
              const float4 p4 =
                  *reinterpret_cast<const float4*>(pr + prx<GP>(key, 4 * g4));
              const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
              for (int u = 0; u < 4; ++u)
                if (4 * g4 + u < GM)
#pragma unroll
                  for (int c = 0; c < 4; ++c)
                    acc[4 * g4 + u][c] = fmaf(p[u], v[c], acc[4 * g4 + u][c]);
            }
          }
        }
      }
      if (j == nt - 1) {
        // the split's logits are complete: its own max and sum, and its
        // keys' weights exp(l - m_s) vs; a key's row is whole 16-byte
        // words
        __syncthreads();
        float st[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) st[g] = -INFINITY;
        for (int t = tid; t < nk; t += CROSS_THREADS)
#pragma unroll
          for (int g4 = 0; g4 < GP / 4; ++g4) {
            const float4 v =
                *reinterpret_cast<const float4*>(pr + prx<GP>(t, 4 * g4));
            const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (4 * g4 + u < GM) st[4 * g4 + u] = fmaxf(st[4 * g4 + u], vv[u]);
          }
        block_reduce_g<GM, true>(st, wred);
        if (tid == 0)
#pragma unroll
          for (int g = 0; g < GM; ++g) own_m[g] = st[g];
        // m_s is finite (every split holds a key, and nothing is masked);
        // a row of -inf logits would still not form -inf - (-inf)
#pragma unroll
        for (int g = 0; g < GM; ++g) st[g] = st[g] == -INFINITY ? 0.f : st[g];
        float sum[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) sum[g] = 0.f;
        for (int t = tid; t < nk; t += CROSS_THREADS) {
          const float sv = vss[t];
#pragma unroll
          for (int g4 = 0; g4 < GP / 4; ++g4) {
            float4* w4 = reinterpret_cast<float4*>(pr + prx<GP>(t, 4 * g4));
            const float4 v = *w4;
            float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int g = 4 * g4 + u;
              if (g < GM) {
                const float e = expf(vv[u] - st[g]);
                sum[g] += e;
                vv[u] = __fmul_rn(e, sv);
              }
            }
            *w4 = make_float4(vv[0], vv[1], vv[2], vv[3]);
          }
        }
        block_reduce_g<GM, false>(sum, wred);
        if (tid == 0)
#pragma unroll
          for (int g = 0; g < GM; ++g) own_l[g] = sum[g];
        // the next iteration's __syncthreads publishes pr, own_m, own_l
      }
    }
    cp_wait<0>();
    __syncthreads();  // every warp is done with the ring's last tile

    // the block's partial: half-warps, then warps (in the exchange)
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[g][c] += __shfl_xor_sync(0xffffffffu, acc[g][c], 16);
        if (lane < 16) red[warp][g][4 * (lane & 15) + c] = acc[g][c];
      }
    __syncthreads();
    if (g0 == 0) cluster_wait();
    cross_exchange<OT>(cl, xch, red, own_m, own_l, gc,
                       ow + (size_t)g0 * a.o_sg, a.o_sg);
    // the next chunk writes into every block's exchange
    if (g0 + GM < a.G) cl.sync();
  }
}

// c += a . b on the tensor cores: m16n8k8, bf16 in, f32 accumulate
// (g = lane / 4, t = lane % 4): a0 (row g, k 2t..2t+1), a1 (row g+8, k
// 2t..), b0 (k 2t..2t+1, col g), c as for m16n8k16
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// f32 x, y as three bf16 pairs whose sum is x, y exactly: each part the
// rounded remainder of the one before (24 bits of significand in three
// parts of 8; the products of a part with an int8 value are exact in f32)
__device__ __forceinline__ void split3(float x, float y, uint32_t (&p)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(x, y);
    p[k] = *reinterpret_cast<const uint32_t*>(&b);
    const float2 f = __bfloat1622float2(b);
    x -= f.x;
    y -= f.y;
  }
}

// the 16-byte word c (0..3) of key row r in a staged tile of the
// per-warp kernel, swizzled so that the rows a warp reads together sit in
// distinct banks
__device__ __forceinline__ int xswz(int r, int c) {
  return r * DH + ((c ^ ((r >> 1) & 3)) << 4);
}

// Per-warp, for chunks of 16 queries (more than 8: the prefills' sampled
// rungs, best_of x the prompt). grid (S, H, Bw), cluster (S, 1, 1), 256
// threads, FLASH_BLOCKS_PER_SM blocks an SM (its registers: the plan
// cuts fewer splits for it). The split's K and V tiles
// (64 keys each, a pair a stage) stream through a 4-stage cp.async ring.
// Each warp takes 8 keys of every tile and keeps its own softmax state
// (flash attention), so its steps never wait for the block's other warps
// between tiles:
//   * logits by mma.sync m16n8k16 (16 queries x 8 keys: the queries are A
//     in registers, bf16, or, for f32 queries, three bf16 parts summed
//     exactly as three products; the int8 keys B, exact in bf16), times
//     the key scales;
//   * its running max m per query, its sum l of exp(l - m) and its
//     partial output rescaled by e^(m_old - m) when m grows;
//   * the weights exp(l - m) vs, f32 and never rounded, split into three
//     bf16 parts that sum to them exactly, times the int8 values by
//     mma.sync m16n8k8 (the logits' accumulator layout is the weights'
//     operand layout), three products accumulated in f32.
// Then the warps' states are combined in shared memory, and the split's
// with the cluster's (cross_exchange).
template <typename QT, typename OT>
__global__ void __launch_bounds__(CROSS_THREADS, FLASH_BLOCKS_PER_SM)
cross_flash_kernel(CrossArgs a) {
  constexpr bool QF32 = std::is_same<QT, float>::value;
  constexpr int NP = QF32 ? 3 : 1;  // bf16 parts of a query
  constexpr int STAGE = 2 * X_TILE * DH;
  constexpr int NST = X_RING / STAGE;
  constexpr int QROW = DH + 8;  // bf16 elements of a staged query row
  static_assert(CROSS_WARPS * 16 * DH * 4 <= X_RING,
                "the partial outputs fit the ring");
  extern __shared__ __align__(16) uint8_t sm_x[];
  __shared__ CrossExchange xch;
  __shared__ float wm[CROSS_WARPS][16], wl[CROSS_WARPS][16];
  __shared__ float own_m[16], own_l[16];
  __shared__ __align__(16) bf16 qpart[NP][QF32 ? 16 : 1][QROW];
  const int C = a.C;
  uint8_t* ring = sm_x;
  float(*red)[16][DH] = reinterpret_cast<float(*)[16][DH]>(sm_x);
  float* kss = reinterpret_cast<float*>(ring + X_RING);
  float* vss = kss + C;
  cg::cluster_group cl = cg::this_cluster();
  const int s = blockIdx.x, h = blockIdx.y, w = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qg = lane >> 2, qt = lane & 3;
  const int t0 = s * C;
  const int nk = min(C, a.Ta - t0);  // this split's keys (>= 1)
  const int nt = (nk + X_TILE - 1) / X_TILE;
  const int8_t* kbase = a.k8 + w * a.kv_sw + h * a.kv_sh + (size_t)t0 * DH;
  const int8_t* vbase = a.v8 + w * a.kv_sw + h * a.kv_sh + (size_t)t0 * DH;
  const float* ks = a.ks + w * a.s_sw + h * a.s_sh + t0;
  const float* vsg = a.vs + w * a.s_sw + h * a.s_sh + t0;
  const QT* qw = static_cast<const QT*>(a.q) + w * a.q_sw + h * a.q_sh;
  OT* ow = static_cast<OT*>(a.out) + w * a.o_sw + h * a.o_sh;
  cluster_arrive_relaxed();

  // stage j: K tile j, then V tile j, rows swizzled (xswz)
  auto fetch = [&](int j) {
    if (j >= nt) return;
    uint8_t* dst = ring + (j % NST) * STAGE;
    const int rows = min(X_TILE, nk - j * X_TILE);
    const size_t off = (size_t)j * X_TILE * DH;
    for (int i = tid; i < rows * 8; i += CROSS_THREADS) {
      const int v = i >= rows * 4, r = (i - v * rows * 4) >> 2, c = i & 3;
      cp16(dst + v * X_TILE * DH + xswz(r, c),
           (v ? vbase : kbase) + off + r * DH + c * 16);
    }
  };

  for (int g0 = 0; g0 < a.G; g0 += 16) {
    const int gc = min(16, a.G - g0);
    cross_scales(kss, vss, ks, vsg, nk);
    for (int j = 0; j < NST - 1; ++j) {
      fetch(j);
      cp_commit();
    }
    if (g0 == 0) {
      pdl_wait();
      pdl_trigger();
    }
    // the queries as A of m16n8k16: lane (qg, qt) holds rows qg, qg + 8,
    // dims 2 qt .. of each k16 step (bf16: in registers; f32: its three
    // parts in shared memory, published by the tile loop's first barrier)
    uint32_t qa[4][4];
    if constexpr (!QF32) {
      auto pair = [&](int g, int i) -> uint32_t {
        if (g >= gc) return 0u;
        const bf16* qr = qw + (size_t)(g0 + g) * a.q_sg + i;
        return (uint32_t)__bfloat16_as_ushort(qr[0]) |
               ((uint32_t)__bfloat16_as_ushort(qr[1]) << 16);
      };
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        qa[kk][0] = pair(qg, kk * 16 + 2 * qt);
        qa[kk][1] = pair(qg + 8, kk * 16 + 2 * qt);
        qa[kk][2] = pair(qg, kk * 16 + 2 * qt + 8);
        qa[kk][3] = pair(qg + 8, kk * 16 + 2 * qt + 8);
      }
    } else {
      for (int i = tid; i < 16 * DH / 2; i += CROSS_THREADS) {
        const int g = i / (DH / 2), jd = 2 * (i - g * (DH / 2));
        float x = 0.f, y = 0.f;
        if (g < gc) {
          const float* qr = qw + (size_t)(g0 + g) * a.q_sg + jd;
          x = qr[0];
          y = qr[1];
        }
        uint32_t p3[3];
        split3(x, y, p3);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          *reinterpret_cast<uint32_t*>(&qpart[k][g][jd]) = p3[k];
      }
    }

    // this warp's state for rows qg (index 0) and qg + 8 (index 1)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

    for (int j = 0; j < nt; ++j) {
      cp_wait<NST - 2>();
      __syncthreads();  // stage j landed; the stage of j - 1 is free
      fetch(j + NST - 1);
      cp_commit();
      const uint8_t* kt = ring + (j % NST) * STAGE;
      const uint8_t* vt = kt + X_TILE * DH;
      const int kw = 8 * warp;  // this warp's keys of the tile
      // logits: c (rows qg, qg + 8; keys kw + 2 qt, + 1)
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint8_t* kr = kt + xswz(kw + qg, kk);
        const uint32_t b0 =
            i8x2_to_bf2(*reinterpret_cast<const uint16_t*>(kr + 2 * qt));
        const uint32_t b1 =
            i8x2_to_bf2(*reinterpret_cast<const uint16_t*>(kr + 2 * qt + 8));
        if constexpr (!QF32) {
          mma_bf16(c, qa[kk], b0, b1);
        } else {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            auto word = [&](int g, int i) {
              return *reinterpret_cast<const uint32_t*>(&qpart[k][g][i]);
            };
            const int i0 = kk * 16 + 2 * qt;
            const uint32_t af[4] = {word(qg, i0), word(qg + 8, i0),
                                    word(qg, i0 + 8), word(qg + 8, i0 + 8)};
            mma_bf16(c, af, b0, b1);
          }
        }
      }
      // times the key scales; keys past the split's end score -inf
      const int key = j * X_TILE + kw + 2 * qt;
      float lg[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = key + (e & 1);
        lg[e] = k < nk ? __fmul_rn(c[e], kss[k]) : -INFINITY;
      }
      // the running max of rows qg, qg + 8 over the warp's keys so far;
      // -inf - (-inf) is never formed: a row with no key yet keeps its
      // zeros
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(lg[2 * r], lg[2 * r + 1]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[r], mx);
        alpha[r] = mn == -INFINITY ? 1.f : expf(m[r] - mn);
        m[r] = mn;
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int c2 = 0; c2 < 4; ++c2) o[n][c2] *= alpha[c2 >> 1];
      }
      float w8[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float ev = lg[e] == -INFINITY ? 0.f : expf(lg[e] - m[r]);
        l[r] = ((e & 1) == 0 ? l[r] * alpha[r] : l[r]) + ev;
        w8[e] = key + (e & 1) < nk ? __fmul_rn(ev, vss[key + (e & 1)]) : 0.f;
      }
      // P . V: the weights (rows qg, qg + 8; keys kw + 2 qt, + 1) in three
      // exact bf16 parts, the values (keys kw + 2 qt, + 1; dim 8 n + qg:
      // word n / 2 of both rows, swizzled alike)
      uint32_t p0[3], p1[3];
      split3(w8[0], w8[1], p0);
      split3(w8[2], w8[3], p1);
      const int vr = kw + 2 * qt, vsw = (vr >> 1) & 3;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint8_t* vp =
            vt + vr * DH + (((n >> 1) ^ vsw) << 4) + 8 * (n & 1) + qg;
        const uint32_t b =
            i8x2_to_bf2((uint32_t)vp[0] | ((uint32_t)vp[DH] << 8));
#pragma unroll
        for (int k = 0; k < 3; ++k) mma_bf16_k8(o[n], p0[k], p1[k], b);
      }
    }

    // the warp's sums over its quad; its state into shared memory
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (qt == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        wm[warp][qg + 8 * r] = m[r];
        wl[warp][qg + 8 * r] = l[r];
      }
    cp_wait<0>();
    __syncthreads();  // the ring is free; wm, wl published
    // the block's max per row, each warp's partial scaled to it, into the
    // ring; the block's sum
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = qg + 8 * r;
      float M = -INFINITY;
#pragma unroll
      for (int w2 = 0; w2 < CROSS_WARPS; ++w2) M = fmaxf(M, wm[w2][g]);
      const float f = m[r] == -INFINITY ? 0.f : expf(m[r] - M);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        red[warp][g][8 * n + 2 * qt] = o[n][2 * r] * f;
        red[warp][g][8 * n + 2 * qt + 1] = o[n][2 * r + 1] * f;
      }
    }
    if (tid < 16) {
      float M = -INFINITY, L = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < CROSS_WARPS; ++w2) M = fmaxf(M, wm[w2][tid]);
#pragma unroll
      for (int w2 = 0; w2 < CROSS_WARPS; ++w2)
        if (wm[w2][tid] != -INFINITY)
          L = fmaf(expf(wm[w2][tid] - M), wl[w2][tid], L);
      own_m[tid] = M;
      own_l[tid] = L;
    }
    __syncthreads();
    if (g0 == 0) cluster_wait();
    cross_exchange<OT>(cl, xch, red, own_m, own_l, gc,
                       ow + (size_t)g0 * a.o_sg, a.o_sg);
    if (g0 + 16 < a.G) cl.sync();
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
// threads and SELF_MAX_SMEM bytes at NQ queries a cache row
inline int self_heads_per_block(int H, int C, int int8, int NQ,
                                int f32 = 0) {
  for (int hp = 4; hp > 1; hp /= 2) {
    const int smem = int8 ? self_smem_bytes<true>(hp, C, NQ)
                     : f32 ? self_smem_bytes<false, true>(hp, C, NQ)
                           : self_smem_bytes<false>(hp, C, NQ);
    if (H % hp == 0 && hp * C <= SELF_MAX_KEYS && smem <= SELF_MAX_SMEM)
      return hp;
  }
  return 1;
}

// the self-attention at NQ queries a cache row: the one-token kernel at 1,
// the verify kernel at 2 .. SELF_MAX_QUERIES; F32 the f32 residual
// stream's instantiation of either
template <bool INT8, bool F32 = false>
int launch_self_nq(const SelfArgs& a, dim3 grid, int threads, int smem,
                   int NQ, int pdl, cudaStream_t st) {
#define ARIES_SELF(N)                                                       \
  case N:                                                                   \
    return launch(self_verify_kernel<INT8, N, F32>, grid, threads, smem,   \
                  grid.x, pdl, st, a)
  switch (NQ) {
    case 1:
      return launch(self_split_kernel<INT8, F32>, grid, threads, smem,
                    grid.x, pdl, st, a);
    ARIES_SELF(2);
    ARIES_SELF(3);
    ARIES_SELF(4);
    ARIES_SELF(5);
    ARIES_SELF(6);
    ARIES_SELF(7);
    ARIES_SELF(8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ARIES_SELF
}

// allow every self-attention instantiation SELF_MAX_SMEM of dynamic shared
// memory on the current card, before its first launch or capture there
template <bool INT8>
int self_allow_smem() {
  const void* kerns[] = {(const void*)self_split_kernel<INT8>,
                         (const void*)self_split_kernel<INT8, true>,
                         (const void*)self_verify_kernel<INT8, 2>,
                         (const void*)self_verify_kernel<INT8, 3>,
                         (const void*)self_verify_kernel<INT8, 4>,
                         (const void*)self_verify_kernel<INT8, 5>,
                         (const void*)self_verify_kernel<INT8, 6>,
                         (const void*)self_verify_kernel<INT8, 7>,
                         (const void*)self_verify_kernel<INT8, 8>,
                         (const void*)self_verify_kernel<INT8, 2, true>,
                         (const void*)self_verify_kernel<INT8, 3, true>,
                         (const void*)self_verify_kernel<INT8, 4, true>,
                         (const void*)self_verify_kernel<INT8, 5, true>,
                         (const void*)self_verify_kernel<INT8, 6, true>,
                         (const void*)self_verify_kernel<INT8, 7, true>,
                         (const void*)self_verify_kernel<INT8, 8, true>};
  for (const void* k : kerns) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, SELF_MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// the cross-attention over cross_plan's S splits of C keys on `sms` SMs:
// grid (S, H, Bw), a cluster of the S blocks of each (head, window); up to
// 8 queries a window the block-wide kernel, above 8 the per-warp one
template <typename QT, typename OT>
int launch_cross_split(const CrossArgs& a0, int Bw, int sms, int pdl,
                       cudaStream_t st) {
  CrossArgs a = a0;
  int S;
  cross_plan(a.Ta, Bw * a.H, a.G, sms, &S, &a.C);
  if (S < 1 || S > MAX_SPLITS || a.C > CROSS_MAX_KEYS || Bw <= 0 ||
      Bw > 65535 || a.H <= 0 || a.H > 65535 || a.G <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(S, a.H, Bw);
  const int T = CROSS_THREADS;
  const int gm = a.G > 8 ? 16 : cross_gm(a.G);
  const int smem = cross_smem_bytes(gm, a.C);
#define ARIES_CROSS(GM)                                                 \
  case GM:                                                              \
    return launch(cross_split_kernel<QT, OT, GM>, grid, T, smem, S, pdl, \
                  st, a)
  switch (gm) {
    ARIES_CROSS(1);
    ARIES_CROSS(2);
    ARIES_CROSS(3);
    ARIES_CROSS(4);
    ARIES_CROSS(5);
    ARIES_CROSS(6);
    ARIES_CROSS(8);
    default:
      return launch(cross_flash_kernel<QT, OT>, grid, T, smem, S, pdl, st,
                    a);
  }
#undef ARIES_CROSS
}

// allow each cross kernel its largest dynamic shared memory on the current
// card, before its first launch or capture there
template <typename QT, typename OT>
int cross_allow_smem() {
  const void* kerns[] = {(const void*)cross_split_kernel<QT, OT, 1>,
                         (const void*)cross_split_kernel<QT, OT, 2>,
                         (const void*)cross_split_kernel<QT, OT, 3>,
                         (const void*)cross_split_kernel<QT, OT, 4>,
                         (const void*)cross_split_kernel<QT, OT, 5>,
                         (const void*)cross_split_kernel<QT, OT, 6>,
                         (const void*)cross_split_kernel<QT, OT, 8>,
                         (const void*)cross_flash_kernel<QT, OT>};
  const int smem = cross_smem_bytes(8, CROSS_MAX_KEYS);
  for (const void* k : kerns) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace splitkv
