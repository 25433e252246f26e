// Encoder attention for training: an f32 forward that keeps the row
// log-sum-exp, and its backward.
//
// Replaces: whisper_aries_tpu/models/whisper.py, _flash_attention_pallas
// (the Pallas TPU kernel the JAX encoder runs on a TPU at n_audio_ctx >=
// 256), at the f32 inputs of a train step (params in f32, as
// ``init_params`` makes them). JAX cannot differentiate that kernel, so
// what the backward computes is the gradient of the same function, held
// against the autograd of the plain version (models/whisper.py
// ``attention_plain``, the JAX package's ``_attention_xla``).
//
// What it computes, for q, k, v (B, H, T, 64) f32:
//   forward:  s_ij = (q_i * 1/8) . k_j over the T real keys (keys at or
//             past T are never scored), o_i = softmax_j(s_ij) v_j and
//             L_i = log sum_j exp(s_ij), all in f32;
//   backward: given dO, D_i = dO_i . o_i, P_ij = exp(s_ij - L_i),
//             dV_j = sum_i P_ij dO_i, dS_ij = P_ij (dO_i . v_j - D_i),
//             dK_j = sum_i dS_ij (q_i / 8), dQ_i = 1/8 sum_j dS_ij k_j.
// Every product is a CUDA-core FMA in f32 (no tensor cores, so no TF32):
// the step computes f32 as the JAX step does.
//
// Design (simple first; a later redesign moves the products onto the
// tensor cores):
//   * forward: one thread per query row, 128 rows a block; K and V tiles
//     of 64 keys in shared memory (every thread of a warp reads the same
//     key: broadcasts); the row's scaled q and its 64 output sums in
//     registers; an online softmax over chunks of 16 keys (one rescale a
//     chunk);
//   * backward, three launches, no atomics (deterministic): D, one warp a
//     row; dK/dV, one block per 64 keys, two threads a key (each holds
//     half of k_j, v_j and of the dK_j, dV_j sums; the two halves of each
//     dot product meet in one shuffle), looping over query tiles of 64
//     rows in shared memory and recomputing P from q, k and L; dQ, one
//     block per 64 queries, two threads a query, looping over key tiles.
//     A thread's half is the dims 8c + 4h .. 8c + 4h + 3 (c = 0..7, h its
//     parity), so the pair's float4 reads of a row fall in one 32-byte
//     sector and never on one bank.
// Rows and keys past T are loaded as zeros, computed and never written.
#include "common.cuh"

namespace {

constexpr int DH = 64;
constexpr int FQ = 128;  // forward: query rows a block, one a thread
constexpr int FK = 64;   // forward: keys a shared-memory tile
constexpr int CH = 16;   // forward: keys scored before one rescale
constexpr int BR = 64;   // backward: rows (keys or queries) a block
constexpr int BT = 64;   // backward: rows of the other side a tile
constexpr int HALF = DH / 2;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float4 mul4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

// a tile of `rows` rows of a (T, 64) head from row `r0` into shared
// memory, rows at or past T as zeros, each value times `s`
__device__ __forceinline__ void load_tile(float (*dst)[DH], const float* src,
                                          int r0, int rows, int T, float s) {
  for (int i = threadIdx.x; i < rows * (DH / 4); i += blockDim.x) {
    const int r = i / (DH / 4), c = i % (DH / 4);
    const float4 x = r0 + r < T ? mul4(ld4(src + (size_t)(r0 + r) * DH + 4 * c), s)
                                : zero4();
    reinterpret_cast<float4*>(&dst[r][0])[c] = x;
  }
}

__global__ void __launch_bounds__(FQ)
    attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int T, float scale) {
  __shared__ __align__(16) float ks[FK][DH];
  __shared__ __align__(16) float vs[FK][DH];
  const size_t head = (size_t)blockIdx.y * T * DH;
  const int row = blockIdx.x * FQ + threadIdx.x;
  const bool live = row < T;
  float qr[DH], acc[DH];
#pragma unroll
  for (int c = 0; c < DH / 4; ++c) {
    const float4 x = live ? ld4(q + head + (size_t)row * DH + 4 * c) : zero4();
    qr[4 * c] = x.x * scale;
    qr[4 * c + 1] = x.y * scale;
    qr[4 * c + 2] = x.z * scale;
    qr[4 * c + 3] = x.w * scale;
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < T; k0 += FK) {
    __syncthreads();
    load_tile(ks, k + head, k0, FK, T, 1.f);
    load_tile(vs, v + head, k0, FK, T, 1.f);
    __syncthreads();
    const int nk = min(FK, T - k0);
    for (int j0 = 0; j0 < nk; j0 += CH) {
      float s[CH];
      float mc = m;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(&ks[j0 + j][0]);
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < DH / 4; ++c) {
          const float4 x = kr[c];
          a = fmaf(qr[4 * c], x.x, a);
          a = fmaf(qr[4 * c + 1], x.y, a);
          a = fmaf(qr[4 * c + 2], x.z, a);
          a = fmaf(qr[4 * c + 3], x.w, a);
        }
        s[j] = j0 + j < nk ? a : -INFINITY;  // keys at or past T
        mc = fmaxf(mc, s[j]);
      }
      const float alpha = expf(m - mc);  // 0 at the first chunk
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float p = expf(s[j] - mc);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(&vs[j0 + j][0]);
#pragma unroll
        for (int c = 0; c < DH / 4; ++c) {
          const float4 x = vr[c];
          acc[4 * c] = fmaf(p, x.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(p, x.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(p, x.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(p, x.w, acc[4 * c + 3]);
        }
      }
      m = mc;
    }
  }
  if (!live) return;
  const float inv = 1.f / l;
  float4* out = reinterpret_cast<float4*>(o + head + (size_t)row * DH);
#pragma unroll
  for (int c = 0; c < DH / 4; ++c)
    out[c] = make_float4(acc[4 * c] * inv, acc[4 * c + 1] * inv,
                         acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
  lse[(size_t)blockIdx.y * T + row] = m + logf(l);
}

// D_i = dO_i . o_i, one warp a row
__global__ void attn_delta_kernel(const float* __restrict__ o,
                                  const float* __restrict__ dout,
                                  float* __restrict__ delta, int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* a = o + (size_t)row * DH;
  const float* b = dout + (size_t)row * DH;
  const float s = warp_sum(fmaf(a[lane + 32], b[lane + 32], a[lane] * b[lane]));
  if (lane == 0) delta[row] = s;
}

// the dims of a thread's half: 8c + 4h + e, as float4 index 2c + h
__device__ __forceinline__ void load_half(float* dst, const float* row, int h,
                                          bool live, float s) {
#pragma unroll
  for (int c = 0; c < HALF / 4; ++c) {
    const float4 x = live ? mul4(ld4(row + 8 * c + 4 * h), s) : zero4();
    dst[4 * c] = x.x;
    dst[4 * c + 1] = x.y;
    dst[4 * c + 2] = x.z;
    dst[4 * c + 3] = x.w;
  }
}

__device__ __forceinline__ void store_half(float* row, const float* src,
                                           int h, float s) {
#pragma unroll
  for (int c = 0; c < HALF / 4; ++c)
    *reinterpret_cast<float4*>(row + 8 * c + 4 * h) =
        make_float4(src[4 * c] * s, src[4 * c + 1] * s, src[4 * c + 2] * s,
                    src[4 * c + 3] * s);
}

// this thread's half of a . b over a shared-memory row, then the pair's sum
__device__ __forceinline__ float pair_dot(const float* reg, const float* row,
                                          int h) {
  const float4* r = reinterpret_cast<const float4*>(row) + h;
  float a = 0.f;
#pragma unroll
  for (int c = 0; c < HALF / 4; ++c) {
    const float4 x = r[2 * c];
    a = fmaf(reg[4 * c], x.x, a);
    a = fmaf(reg[4 * c + 1], x.y, a);
    a = fmaf(reg[4 * c + 2], x.z, a);
    a = fmaf(reg[4 * c + 3], x.w, a);
  }
  return a + __shfl_xor_sync(0xffffffffu, a, 1);
}

// acc += w * row (this thread's half)
__device__ __forceinline__ void pair_axpy(float* acc, float w,
                                          const float* row, int h) {
  const float4* r = reinterpret_cast<const float4*>(row) + h;
#pragma unroll
  for (int c = 0; c < HALF / 4; ++c) {
    const float4 x = r[2 * c];
    acc[4 * c] = fmaf(w, x.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(w, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, x.w, acc[4 * c + 3]);
  }
}

__global__ void __launch_bounds__(2 * BR)
    attn_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int T, float scale) {
  __shared__ __align__(16) float qs[BT][DH];  // q / 8
  __shared__ __align__(16) float gs[BT][DH];  // dO
  __shared__ float ls[BT], ds[BT];
  const size_t head = (size_t)blockIdx.y * T * DH;
  const float* lse_h = lse + (size_t)blockIdx.y * T;
  const float* delta_h = delta + (size_t)blockIdx.y * T;
  const int key = blockIdx.x * BR + (threadIdx.x >> 1), h = threadIdx.x & 1;
  const bool live = key < T;
  float kr[HALF], vr[HALF], dkr[HALF], dvr[HALF];
  load_half(kr, k + head + (size_t)key * DH, h, live, 1.f);
  load_half(vr, v + head + (size_t)key * DH, h, live, 1.f);
#pragma unroll
  for (int d = 0; d < HALF; ++d) dkr[d] = dvr[d] = 0.f;
  for (int i0 = 0; i0 < T; i0 += BT) {
    __syncthreads();
    load_tile(qs, q + head, i0, BT, T, scale);
    load_tile(gs, dout + head, i0, BT, T, 1.f);
    for (int i = threadIdx.x; i < BT; i += blockDim.x) {
      ls[i] = i0 + i < T ? lse_h[i0 + i] : 0.f;
      ds[i] = i0 + i < T ? delta_h[i0 + i] : 0.f;
    }
    __syncthreads();
    const int nq = min(BT, T - i0);
    for (int i = 0; i < nq; ++i) {
      const float s = pair_dot(kr, &qs[i][0], h);
      const float dp = pair_dot(vr, &gs[i][0], h);
      const float p = expf(s - ls[i]);
      pair_axpy(dvr, p, &gs[i][0], h);
      pair_axpy(dkr, p * (dp - ds[i]), &qs[i][0], h);
    }
  }
  if (!live) return;
  store_half(dk + head + (size_t)key * DH, dkr, h, 1.f);
  store_half(dv + head + (size_t)key * DH, dvr, h, 1.f);
}

__global__ void __launch_bounds__(2 * BR)
    attn_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int T, float scale) {
  __shared__ __align__(16) float ks[BT][DH];
  __shared__ __align__(16) float vs[BT][DH];
  const size_t head = (size_t)blockIdx.y * T * DH;
  const int row = blockIdx.x * BR + (threadIdx.x >> 1), h = threadIdx.x & 1;
  const bool live = row < T;
  float qr[HALF], gr[HALF], acc[HALF];
  load_half(qr, q + head + (size_t)row * DH, h, live, scale);
  load_half(gr, dout + head + (size_t)row * DH, h, live, 1.f);
#pragma unroll
  for (int d = 0; d < HALF; ++d) acc[d] = 0.f;
  const float Li = live ? lse[(size_t)blockIdx.y * T + row] : 0.f;
  const float Di = live ? delta[(size_t)blockIdx.y * T + row] : 0.f;
  for (int k0 = 0; k0 < T; k0 += BT) {
    __syncthreads();
    load_tile(ks, k + head, k0, BT, T, 1.f);
    load_tile(vs, v + head, k0, BT, T, 1.f);
    __syncthreads();
    const int nk = min(BT, T - k0);
    for (int j = 0; j < nk; ++j) {
      const float s = pair_dot(qr, &ks[j][0], h);
      const float dp = pair_dot(gr, &vs[j][0], h);
      const float p = expf(s - Li);
      pair_axpy(acc, p * (dp - Di), &ks[j][0], h);
    }
  }
  if (!live) return;
  store_half(dq + head + (size_t)row * DH, acc, h, scale);
}

bool bad_shape(int B, int H, int T) {
  return B <= 0 || H <= 0 || T <= 0 || B * H > 65535;
}

}  // namespace

extern "C" int aries_attn_train_fwd(const float* q, const float* k,
                                    const float* v, float* o, float* lse,
                                    int B, int H, int T, float scale,
                                    void* stream) {
  if (bad_shape(B, H, T)) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + FQ - 1) / FQ, B * H);
  attn_fwd_kernel<<<grid, FQ, 0, (cudaStream_t)stream>>>(q, k, v, o, lse, T,
                                                        scale);
  return launch_status();
}

// delta: (B, H, T) f32 scratch for D
extern "C" int aries_attn_train_bwd(const float* q, const float* k,
                                    const float* v, const float* o,
                                    const float* lse, const float* dout,
                                    float* delta, float* dq, float* dk,
                                    float* dv, int B, int H, int T,
                                    float scale, void* stream) {
  if (bad_shape(B, H, T)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = B * H * T;
  attn_delta_kernel<<<(rows + 7) / 8, 256, 0, s>>>(o, dout, delta, rows);
  const dim3 grid((T + BR - 1) / BR, B * H);
  attn_dkdv_kernel<<<grid, 2 * BR, 0, s>>>(q, k, v, dout, lse, delta, dk, dv,
                                           T, scale);
  attn_dq_kernel<<<grid, 2 * BR, 0, s>>>(q, k, v, dout, lse, delta, dq, T,
                                         scale);
  return launch_status();
}
