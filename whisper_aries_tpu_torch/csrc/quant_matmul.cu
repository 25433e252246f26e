// W8A16 GEMM with the dequant on the weight side: the int8 dense layers'
// "pallas" path (ops/quant.py, quant_matmul under ARIES_QUANT_IMPL=pallas).
//
// Replaces: whisper_aries_tpu/ops/quant.py, _quant_matmul_pallas (the
// Pallas TPU kernel that dequantizes each int8 weight tile to bf16 inside
// the MXU matmul).
//
// What it computes, x (M, K) bf16, q (K, N) int8, s (N,) f32:
//   w[k, n]   = bf16(f32(q[k, n]) * s[n])    an f32 multiply, then round to
//                                            nearest even (no FMA, no
//                                            truncation)
//   out[m, n] = sum_k x[m, k] * w[k, n]      bf16 x bf16 products, f32 sums
// written as bf16 (the cast to the activation dtype fused) or f32. The bias
// stays in models/layers.py's dense, as in the JAX package.
//
// Bound on the H100: operations at the encoder's shapes (M = windows x
// 1500 rows: 2 M N K at the bf16 tensor-core rate, 0.030 ms for M 9000,
// K = N = 1280), bytes at a decode step's (M = 6 rows: the int8 weight
// matrix, read once).
//
// Design: a block owns a 128 x 128 output tile and walks K in slabs of 32.
// cp.async brings the next slab of x (bf16) and of q (int8) into shared
// memory while the present one is used (two stages); the int8 slab is then
// dequantized in shared memory, once per block, into a bf16 tile stored
// k-minor per column, so each B fragment of mma.sync m16n8k16 (bf16 in,
// f32 accumulate) is one 32-bit load. Eight warps, each a 64 x 32 sub-tile
// (4 x 4 fragments). Rows past M are loaded as zeros and not written, so
// M needs no padding. When the tiles do not fill the card (the decode
// step's M = 6 gives N / 128 blocks), K is split over blockIdx.z: each
// split writes f32 partial sums and a second kernel adds them in a fixed
// order, then casts. wgmma/TMA and a persistent schedule come later.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;     // 8 warps: 2 along M x 4 along N
constexpr int LDS = BK + 8;      // bf16 per shared row: 80 bytes, so the
                                 // fragment loads of a warp hit 32 banks
constexpr int MIN_TRIPS = 4;     // K slabs per split at least

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);  // all but the newest group
}

// byte b (0..3) of a 32-bit word as a signed int8 value
__device__ __forceinline__ float i8_byte(int word, int b) {
  return (float)((int)((unsigned)word << (24 - 8 * b)) >> 24);
}

// OUT_BF16: out (M, N) bf16; else f32 at out + blockIdx.z * M * N (the
// split's partial sums, or the result when there is one split)
template <bool OUT_BF16>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ s, void* __restrict__ out,
                    int M, int N, int K, int trips) {
  __shared__ __align__(16) bf16 As[2][BM][LDS];   // x slab, k-minor
  __shared__ __align__(16) int8_t Bq[2][BK][BN];  // q slab, n-minor
  __shared__ __align__(16) bf16 Bt[BN][LDS];      // dequantized, k-minor
  __shared__ float ss[BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * trips;

  for (int i = tid; i < BN; i += THREADS)
    ss[i] = n0 + i < N ? s[n0 + i] : 0.f;

  auto load = [&](int st, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // x: 128 rows x 4 chunks of 16 bytes
      const int c = tid + i * THREADS;
      const int r = c >> 2, ch = c & 3;
      const int gm = m0 + r;
      const bool ok = gm < M;
      cp_async16(&As[st][r][ch * 8],
                 x + (size_t)(ok ? gm : 0) * K + k0 + ch * 8, ok);
    }
    {  // q: 32 rows x 8 chunks of 16 bytes
      const int r = tid >> 3, ch = tid & 7;
      const int gn = n0 + ch * 16;
      const bool ok = gn < N;
      cp_async16(&Bq[st][r][ch * 16],
                 q + (size_t)(k0 + r) * N + (ok ? gn : 0), ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load(0, kt0);
  cp_async_commit();
  for (int it = 0; it < trips; ++it) {
    const int st = it & 1;
    if (it + 1 < trips) load(st ^ 1, kt0 + it + 1);
    cp_async_commit();  // possibly empty: the wait below stays uniform
    cp_async_wait_prev();
    __syncthreads();

    // dequantize the slab: a thread takes k rows 2kp, 2kp+1 at 8 columns
    // and writes each column's pair as one bf16x2 word of Bt
    {
      const int kp = tid & 15, ng = tid >> 4;
      const int2 r0 = *reinterpret_cast<const int2*>(&Bq[st][2 * kp][ng * 8]);
      const int2 r1 =
          *reinterpret_cast<const int2*>(&Bq[st][2 * kp + 1][ng * 8]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = ng * 8 + j;
        const float sc = ss[n];
        const float a = i8_byte(j < 4 ? r0.x : r0.y, j & 3);
        const float b = i8_byte(j < 4 ? r1.x : r1.y, j & 3);
        __nv_bfloat162 w;
        w.x = __float2bfloat16_rn(__fmul_rn(a, sc));
        w.y = __float2bfloat16_rn(__fmul_rn(b, sc));
        *reinterpret_cast<__nv_bfloat162*>(&Bt[n][2 * kp]) = w;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + g;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&As[st][r][kk + 2 * t]);
        a[mt][1] =
            *reinterpret_cast<const uint32_t*>(&As[st][r + 8][kk + 2 * t]);
        a[mt][2] =
            *reinterpret_cast<const uint32_t*>(&As[st][r][kk + 2 * t + 8]);
        a[mt][3] =
            *reinterpret_cast<const uint32_t*>(&As[st][r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + g;
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&Bt[c][kk + 2 * t]);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(&Bt[c][kk + 2 * t + 8]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();  // Bt and this stage are rewritten next trip
  }

  // c[0..1]: row g, columns 2t, 2t+1; c[2..3]: row g + 8
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mt * 16 + g + 8 * half;
        if (row >= M) continue;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (OUT_BF16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                             (size_t)row * N + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          float* o = static_cast<float*>(out) +
                     (size_t)blockIdx.z * M * N + (size_t)row * N + col;
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        }
      }
    }
  }
}

// out = cast(sum over the splits of part), the splits added in order
__global__ void splitk_sum_kernel(const float* __restrict__ part, int splits,
                                  long long MN, void* __restrict__ out,
                                  int out_bf16) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += part[z * MN + i];
  if (out_bf16)
    static_cast<bf16*>(out)[i] = f2bf(acc);
  else
    static_cast<float*>(out)[i] = acc;
}

}  // namespace

extern "C" {

// The K splits for (M, N, K): 1 when the output tiles alone fill the card,
// else about two blocks per SM, each split a whole number (>= MIN_TRIPS)
// of K slabs. Negative: a CUDA error asking for the SM count.
int aries_quant_matmul_splits(int M, int N, int K) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  const long long blocks =
      (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  if (blocks >= sms) return 1;
  const int slabs = K / BK;
  const long long want = (2LL * sms + blocks - 1) / blocks;
  int best = 1;
  for (int c = 2; c <= want && c * MIN_TRIPS <= slabs; ++c)
    if (slabs % c == 0) best = c;
  return best;
}

// x (M, K) bf16, q (K, N) int8, s (N,) f32, all contiguous and 16-byte
// aligned; K % 32 == 0, N % 16 == 0. out (M, N) bf16 (out_bf16 = 1) or
// f32. splits > 1 needs part: splits x M x N f32 scratch.
int aries_quant_matmul(const void* x, const int8_t* q, const float* s,
                       void* out, int out_bf16, int M, int N, int K,
                       int splits, float* part, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K <= 0 || K % BK || N % 16 || splits < 1 ||
      (K / BK) % splits || (M + BM - 1) / BM > 65535 || splits > 65535 ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const int trips = K / BK / splits;
  const bf16* xb = static_cast<const bf16*>(x);
  if (splits == 1) {
    if (out_bf16)
      quant_matmul_kernel<true><<<grid, THREADS, 0, st>>>(xb, q, s, out, M, N,
                                                          K, trips);
    else
      quant_matmul_kernel<false><<<grid, THREADS, 0, st>>>(xb, q, s, out, M,
                                                           N, K, trips);
    return launch_status();
  }
  quant_matmul_kernel<false><<<grid, THREADS, 0, st>>>(xb, q, s, part, M, N,
                                                       K, trips);
  const int err = launch_status();
  if (err) return err;
  const long long MN = (long long)M * N;
  splitk_sum_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      part, splits, MN, out, out_bf16);
  return launch_status();
}

}  // extern "C"
