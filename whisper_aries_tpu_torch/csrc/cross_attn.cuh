// Grouped int8 cross-attention: the device code of the standalone entry
// (csrc/cross_attn.cu).
//
// Replaces: whisper_aries_tpu/ops/pallas_cross_attn.py, cross_attention_q8
// and its row-blocked form cross_attention_q8_blocked. The G queries of one
// window (its beams, times the prompt positions in a prefill) attend over
// that window's int8 K/V with per-position scales:
//
//   logits[g, t] = (q[g] . k8[t]) * ks[t]          ks folds 1/sqrt(dh)
//   p[g, t]      = softmax_t(logits[g, :]) * vs[t]
//   out[g]       = sum_t p[g, t] * v8[t]
//
// Bound on the H100: bytes. A window's K/V (2 x H x Ta x 64 int8) and its
// scales (2 x H x Ta f32) are read once for all G queries; the products
// (4 x G x Ta x 64 per head) are far below the card's rate.
//
// Design: one block of 512 threads per (head, window). The block's queries
// sit in shared memory as f32, so every key row and every value row is read
// from device memory once for all of them:
//   * logits: a thread owns a key, reads its 64 bytes as four 16-byte loads
//     and forms its G dot products against the queries (broadcast reads);
//     the loads of two keys are in flight before the products;
//   * softmax: one warp per query, f32, the max subtracted first;
//   * P.V: half-warps own keys, lanes own 4 dims each (one 64-byte value row
//     per half-warp), eight rows' loads in flight before their FMAs (the
//     loop is latency-bound otherwise); the G x 4 accumulators are summed
//     over the block through shared memory.
// Ta needs no tiling (a thread loop over the keys, so 1500 is not rounded
// up). More than GMAX queries run in chunks of GMAX inside the block, each
// chunk reading the K/V again (mostly from L2).
//
// Operand layout: element strides per window (w) and head (h); within a
// (window, head) the keys are rows of 64 int8 (t-stride 64), the scales
// contiguous in t, the query and output dims contiguous.
#pragma once

#include "common.cuh"

namespace xattn {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int HALVES = THREADS / 16;
constexpr int DH = 64;
constexpr int GMAX_MOST = 16;
constexpr int QK_UNROLL = 2;  // keys a thread loads before its products
constexpr int PV_UNROLL = 8;  // value rows a half-warp loads before its FMAs

struct Args {
  const void* q;                  // QT, (w, h, g, 64)
  long long q_sw, q_sh, q_sg;
  const int8_t* k8;               // (w, h, t, 64)
  const int8_t* v8;
  long long kv_sw, kv_sh;
  const float* ks;                // (w, h, t)
  const float* vs;
  long long s_sw, s_sh;
  void* out;                      // OT, (w, h, g, 64)
  long long o_sw, o_sh, o_sg;
  int H, G, Ta;
};

template <typename T> __device__ __forceinline__ float load_f(const T* p);
template <> __device__ __forceinline__ float load_f<float>(const float* p) {
  return *p;
}
template <> __device__ __forceinline__ float load_f<bf16>(const bf16* p) {
  return bf2f(*p);
}
template <typename T> __device__ __forceinline__ void store_f(T* p, float v);
template <> __device__ __forceinline__ void store_f<float>(float* p, float v) {
  *p = v;
}
template <> __device__ __forceinline__ void store_f<bf16>(bf16* p, float v) {
  *p = f2bf(v);
}

// byte b (0..3) of a 32-bit word as a signed int8 value
__device__ __forceinline__ float i8_at(int word, int b) {
  return (float)((int)((unsigned)word << (24 - 8 * b)) >> 24);
}

__host__ __device__ inline size_t smem_floats(int gmax, int Ta) {
  // queries | logits | per-warp partial outputs
  return (size_t)gmax * DH + (size_t)gmax * Ta + (size_t)WARPS * gmax * DH;
}

// MINB blocks per SM: with MINB 2 the kernel keeps to 64 registers a
// thread, so two blocks share an SM (launch() takes it when there are more
// blocks than SMs: 8 windows x 20 heads = 160 blocks then run in one wave
// on the 132 SMs); with MINB 1 a lone block runs faster.
template <typename QT, typename OT, int GMAX, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
cross_attn_q8_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // GMAX x 64
  float* lg = qs + GMAX * DH;                    // GMAX x Ta
  float* red = lg + (size_t)GMAX * a.Ta;         // WARPS x GMAX x 64
  const float4* qs4 = smem4;
  const int h = blockIdx.x, w = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hw = tid >> 4, hl = tid & 15;
  const int Ta = a.Ta;
  const QT* q = static_cast<const QT*>(a.q) + w * a.q_sw + h * a.q_sh;
  OT* out = static_cast<OT*>(a.out) + w * a.o_sw + h * a.o_sh;
  const int8_t* kb = a.k8 + w * a.kv_sw + h * a.kv_sh;
  const int8_t* vb = a.v8 + w * a.kv_sw + h * a.kv_sh;
  const float* ks = a.ks + w * a.s_sw + h * a.s_sh;
  const float* vs = a.vs + w * a.s_sw + h * a.s_sh;

  for (int g0 = 0; g0 < a.G; g0 += GMAX) {
    const int gc = min(GMAX, a.G - g0);
    for (int i = tid; i < gc * DH; i += THREADS) {
      const int g = i / DH, j = i - g * DH;
      qs[i] = load_f<QT>(q + (g0 + g) * a.q_sg + j);
    }
    __syncthreads();

    // (1) logits: thread per key, G dot products of 64; QK_UNROLL keys'
    // loads are issued before their products
    for (int t0 = tid; t0 < Ta; t0 += THREADS * QK_UNROLL) {
      int4 raw[QK_UNROLL][4];
#pragma unroll
      for (int u = 0; u < QK_UNROLL; ++u) {
        const int t = t0 + u * THREADS;
        const int4* kr = reinterpret_cast<const int4*>(kb + (size_t)t * DH);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          raw[u][c] = t < Ta ? kr[c] : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < QK_UNROLL; ++u) {
        const int t = t0 + u * THREADS;
        if (t >= Ta) break;
        float acc[GMAX];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int words[4] = {raw[u][c].x, raw[u][c].y, raw[u][c].z,
                                raw[u][c].w};
#pragma unroll
          for (int wd = 0; wd < 4; ++wd) {
            const float k0 = i8_at(words[wd], 0), k1 = i8_at(words[wd], 1);
            const float k2 = i8_at(words[wd], 2), k3 = i8_at(words[wd], 3);
#pragma unroll
            for (int g = 0; g < GMAX; ++g) {
              if (g < gc) {
                const float4 qv = qs4[g * (DH / 4) + c * 4 + wd];
                acc[g] = fmaf(qv.x, k0, acc[g]);
                acc[g] = fmaf(qv.y, k1, acc[g]);
                acc[g] = fmaf(qv.z, k2, acc[g]);
                acc[g] = fmaf(qv.w, k3, acc[g]);
              }
            }
          }
        }
        const float s = ks[t];
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < gc) lg[(size_t)g * Ta + t] = acc[g] * s;
      }
    }
    __syncthreads();

    // (2) softmax per query (one warp each), v scales folded in
    for (int g = warp; g < gc; g += WARPS) {
      float* row = lg + (size_t)g * Ta;
      float mx = -INFINITY;
      for (int t = lane; t < Ta; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < Ta; t += 32) {
        const float e = expf(row[t] - mx);
        row[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int t = lane; t < Ta; t += 32) row[t] = row[t] / sum * vs[t];
    }
    __syncthreads();

    // (3) P . V: half-warp per value row, lane per 4 dims
    float acc[GMAX][4];
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[g][j] = 0.f;
    // PV_UNROLL rows' loads are issued before their FMAs, so a half-warp
    // waits once per PV_UNROLL rows, not once per row
    for (int t0 = hw; t0 < Ta; t0 += HALVES * PV_UNROLL) {
      char4 vv[PV_UNROLL];
#pragma unroll
      for (int u = 0; u < PV_UNROLL; ++u) {
        const int t = t0 + u * HALVES;
        vv[u] = t < Ta ? *reinterpret_cast<const char4*>(
                             vb + (size_t)t * DH + 4 * hl)
                       : make_char4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < PV_UNROLL; ++u) {
        const int t = t0 + u * HALVES;
        if (t >= Ta) break;
        const float v0 = vv[u].x, v1 = vv[u].y, v2 = vv[u].z, v3 = vv[u].w;
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < gc) {
            const float p = lg[(size_t)g * Ta + t];
            acc[g][0] = fmaf(p, v0, acc[g][0]);
            acc[g][1] = fmaf(p, v1, acc[g][1]);
            acc[g][2] = fmaf(p, v2, acc[g][2]);
            acc[g][3] = fmaf(p, v3, acc[g][3]);
          }
        }
      }
    }
    // the two half-warps of a warp, then the warps through shared memory
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < gc) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], 16);
          if (lane < 16) red[(warp * GMAX + g) * DH + 4 * hl + j] = acc[g][j];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < gc * DH; i += THREADS) {
      const int g = i / DH, j = i - g * DH;
      float o = 0.f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) o += red[(wi * GMAX + g) * DH + j];
      store_f<OT>(out + (g0 + g) * a.o_sg + j, o);
    }
    __syncthreads();  // qs, lg and red are rewritten by the next chunk
  }
}

template <typename QT, typename OT, int GMAX, int MINB>
int launch_gb(const Args& a, int Bw, size_t smem, cudaStream_t st) {
  auto kern = cross_attn_q8_kernel<QT, OT, GMAX, MINB>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(a.H, Bw), THREADS, smem, st>>>(a);
  return launch_status();
}

template <typename QT, typename OT, int GMAX>
int launch_g(const Args& a, int Bw, cudaStream_t st) {
  const size_t smem = smem_floats(GMAX, a.Ta) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if constexpr (GMAX <= 8) {
    // the current device's SM count, asked at every launch (the runtime
    // answers from its own table)
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (2 * smem <= 232448 && a.H * Bw > sms)
      return launch_gb<QT, OT, GMAX, 2>(a, Bw, smem, st);
  }
  return launch_gb<QT, OT, GMAX, 1>(a, Bw, smem, st);
}

// One launch for all Bw windows: grid (H, Bw). The query chunk (GMAX) is
// the least power of two >= G, at most 16.
template <typename QT, typename OT>
int launch(const Args& a, int Bw, cudaStream_t st) {
  if (Bw <= 0 || a.G <= 0 || a.H <= 0 || a.Ta <= 0 || Bw > 65535)
    return (int)cudaErrorInvalidValue;
  if (a.G <= 1) return launch_g<QT, OT, 1>(a, Bw, st);
  if (a.G <= 2) return launch_g<QT, OT, 2>(a, Bw, st);
  if (a.G <= 4) return launch_g<QT, OT, 4>(a, Bw, st);
  if (a.G <= 8) return launch_g<QT, OT, 8>(a, Bw, st);
  return launch_g<QT, OT, GMAX_MOST>(a, Bw, st);
}

}  // namespace xattn
