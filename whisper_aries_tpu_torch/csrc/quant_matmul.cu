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
// Two paths; ops/quant.py::gemm_plan picks one by shape and passes it in.
//
// "wgmma" (large M: the encoder's and the cross K/V's M = windows x 1500).
// Bound on the H100: operations (2 M N K at the bf16 tensor-core rate,
// 0.030 ms for M 9000, K = N = 1280). What held the first design back was
// everything around the products: a 32-deep slab, two cp.async stages,
// three block-wide syncs per slab and the int8 -> bf16 dequant of every
// slab repeated by each of the 71 row tiles of a column. This design takes
// the dequant out of the loop and feeds the tensor cores the way Hopper
// wants:
//   (a) dequant_kernel turns q into a bf16 (K, N) scratch once per call
//       (8 columns a thread: 8-byte loads, 16-byte stores, __fmul_rn then
//       __float2bfloat16_rn, the weights bit for bit); 1.6 MB in and 3.3 MB
//       out at K = N = 1280, and the scratch stays in the 50 MB L2 for (b);
//   (b) gemm_kernel: one block per 128 x 256 output tile, 64-deep K tiles
//       in a ring of 4 stages (48 KB each) in shared memory. A producer
//       warpgroup (registers given back with setmaxnreg) keeps the ring
//       full with TMA loads of x (K-major) and of the scratch (N-major,
//       wgmma's transpose bit: no transposed copy), 128-byte swizzled;
//       each stage's "full" mbarrier completes on the TMA byte count, its
//       "empty" one when both consumers are done with it. Two consumer
//       warpgroups, 64 rows each, run wgmma m64n128k16 twice per k16 step
//       into 128 f32 registers a thread, one commit group kept in flight.
//       x's map fills rows past M (and the scratch's columns past N) with
//       zeros, and the epilogue stores only rows < M and columns < N.
//       Needs K % 64. One m64n256k16 instead of the two m64n128k16 was no
//       faster; a cluster of two blocks along M sharing each weight tile by
//       TMA multicast (a third less L2 traffic) was slower.
//
// "splitk" (small M: a decode step's 6 rows, prefill, alignment_forward).
// Bound on the H100: bytes (the int8 weights, read once). A block owns a
// 128 x 128 output tile and walks K in slabs of 32. cp.async brings the
// next slab of x (bf16) and of q (int8) into shared memory while the
// present one is used (two stages); the int8 slab is then dequantized in
// shared memory, once per block, into a bf16 tile stored k-minor per
// column, so each B fragment of mma.sync m16n8k16 (bf16 in, f32
// accumulate) is one 32-bit load. Eight warps, each a 64 x 32 sub-tile
// (4 x 4 fragments). Rows past M are loaded as zeros and not written, so M
// needs no padding. When the tiles do not fill the card (M = 6 gives N /
// 128 blocks), K is split over blockIdx.z: each split writes f32 partial
// sums and a second kernel adds them in a fixed order, then casts. Its
// calls are bound by the Python wrapper on the host, not by the device.
#include "hopper.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;     // 8 warps: 2 along M x 4 along N
constexpr int LDS = BK + 8;      // bf16 per shared row: 80 bytes, so the
                                 // fragment loads of a warp hit 32 banks

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

// ---------------------------------------------------------------------------
// "wgmma" path
// ---------------------------------------------------------------------------

// w = bf16(f32(q) * s[n]) for 8 consecutive columns a thread: a warp
// reads 256 contiguous bytes of q and writes 512 of w
__global__ void dequant_kernel(const int8_t* __restrict__ q,
                               const float* __restrict__ s,
                               bf16* __restrict__ w, int K, int N) {
  const long long chunks = (long long)K * (N / 8);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= chunks) return;
  const size_t off = (size_t)i * 8;
  const int n0 = (int)(off % N);
  const int2 v = *reinterpret_cast<const int2*>(q + off);
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(s + n0));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(s + n0) + 1);
  const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  uint32_t packed[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int word = j < 2 ? v.x : v.y, b = (j & 1) * 2;
    __nv_bfloat162 p;
    p.x = __float2bfloat16_rn(__fmul_rn(i8_byte(word, b), sc[2 * j]));
    p.y = __float2bfloat16_rn(__fmul_rn(i8_byte(word, b + 1), sc[2 * j + 1]));
    packed[j] = *reinterpret_cast<uint32_t*>(&p);
  }
  *reinterpret_cast<uint4*>(w + off) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

constexpr int GM = 128, GN = 256, GK = 64, GSTAGES = 4;
constexpr int G_THREADS = 384;            // consumers: warpgroups 0, 1;
                                          // producer: warpgroup 2
constexpr int G_A = GM * GK * 2;          // 16 KB: x tile, 128 rows x 128 B
constexpr int G_BOX = GK * 64 * 2;        // 8 KB: 64 k rows x 64 columns
constexpr int G_B = (GN / 64) * G_BOX;    // 32 KB: the scratch's tile
constexpr int G_STAGE = G_A + G_B;
constexpr int G_SMEM = 1024 + GSTAGES * G_STAGE + 2 * GSTAGES * 8;

// x map: (K, M) box (64, 128); w map: (N, K) box (64, 64); both bf16,
// 128-byte swizzle. OUT_BF16: out (M, N) bf16, else f32.
template <bool OUT_BF16>
__global__ void __launch_bounds__(G_THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap mx,
            const __grid_constant__ CUtensorMap mw, void* __restrict__ out,
            int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GSTAGES * G_STAGE);
  uint64_t* empty = full + GSTAGES;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int n0 = blockIdx.x * GN, m0 = blockIdx.y * GM;
  const int k_tiles = K / GK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % GSTAGES;
        if (kt >= GSTAGES) mbar_wait(&empty[s], (kt / GSTAGES - 1) & 1);
        uint8_t* a = smem + s * G_STAGE;
        mbar_arrive_expect_tx(&full[s], G_STAGE);
        tma_load_2d(a, &mx, &full[s], kt * GK, m0);
#pragma unroll
        for (int j = 0; j < GN / 64; ++j)
          tma_load_2d(a + G_A + j * G_BOX, &mw, &full[s], n0 + 64 * j,
                      kt * GK);
      }
    }
  } else {  // consumers: rows m0 + 64 wg .. + 63
    setmaxnreg_inc<232>();
    float acc[GN / 128][64];
#pragma unroll
    for (int h = 0; h < GN / 128; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % GSTAGES;
      mbar_wait(&full[s], (kt / GSTAGES) & 1);
      const uint8_t* a = smem + s * G_STAGE + wg * 64 * 128;
      const uint8_t* b = smem + s * G_STAGE + G_A;
#pragma unroll
      for (int h = 0; h < GN / 128; ++h) fence_regs(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GK / 16; ++kk) {
        const uint64_t da = wgmma_desc(a + kk * 32, 16, 1024);
#pragma unroll
        for (int h = 0; h < GN / 128; ++h)
          wgmma_m64n128k16_ss<1>(
              acc[h], da,
              wgmma_desc(b + h * 2 * G_BOX + kk * 2048, G_BOX, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous tile's products are done
#pragma unroll
      for (int h = 0; h < GN / 128; ++h) fence_regs(acc[h]);
      if (kt > 0 && tid == 0) mbar_arrive(&empty[(kt - 1) % GSTAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < GN / 128; ++h) fence_regs(acc[h]);

    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = m0 + wg * 64 + warp * 16 + g;
#pragma unroll
    for (int h = 0; h < GN / 128; ++h) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + h * 128 + j * 8 + 2 * t;
        if (col >= N) continue;  // N % 16 == 0: col + 1 < N too
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + 8 * half;
          if (row >= M) continue;
          const float v0 = acc[h][4 * j + 2 * half];
          const float v1 = acc[h][4 * j + 2 * half + 1];
          if (OUT_BF16)
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                               (size_t)row * N + col) =
                __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(out) +
                                       (size_t)row * N + col) =
                make_float2(v0, v1);
        }
      }
    }
  }
}

int dequant(const int8_t* q, const float* s, bf16* w, int K, int N,
            cudaStream_t st) {
  const long long chunks = (long long)K * (N / 8);
  dequant_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(q, s, w,
                                                                    K, N);
  return launch_status();
}

template <bool OUT_BF16>
int launch_gemm(const CUtensorMap& mx, const CUtensorMap& mw, void* out,
                int M, int N, int K, cudaStream_t st) {
  static bool configured = false;  // the attribute is set once a process
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<OUT_BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM);
  gemm_kernel<OUT_BF16><<<grid, G_THREADS, G_SMEM, st>>>(mx, mw, out, M, N,
                                                          K);
  return launch_status();
}

}  // namespace

extern "C" {

// w (K, N) bf16 = bf16(f32(q) * s[n]); N % 16 == 0, q, s and w 16-byte
// aligned. The "wgmma" path's first pass, on its own for the checks.
int aries_dequant_bf16(const int8_t* q, const float* s, void* w, int K, int N,
                       void* stream) {
  if (K <= 0 || N <= 0 || N % 16) return (int)cudaErrorInvalidValue;
  return dequant(q, s, static_cast<bf16*>(w), K, N, (cudaStream_t)stream);
}

// x (M, K) bf16, q (K, N) int8, s (N,) f32, all contiguous and 16-byte
// aligned; N % 16 == 0. out (M, N) bf16 (out_bf16 = 1) or f32.
// path 1 ("wgmma"): K % 64 == 0, splits 1, scratch: K x N bf16.
// path 0 ("splitk"): K % 32 == 0, (K / 32) % splits == 0; splits > 1 needs
// scratch: splits x M x N f32.
// Returns 0, a cudaError_t, or hopper.cuh's tensor-map codes.
int aries_quant_matmul(const void* x, const int8_t* q, const float* s,
                       void* out, int out_bf16, int M, int N, int K, int path,
                       int splits, void* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = static_cast<const bf16*>(x);
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (path == 1) {
    if (K % GK || splits != 1 || scratch == nullptr)
      return (int)cudaErrorInvalidValue;
    bf16* w = static_cast<bf16*>(scratch);
    int err = dequant(q, s, w, K, N, st);
    if (err) return err;
    CUtensorMap mx, mw;
    const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t xs[1] = {(cuuint64_t)K * 2};
    const cuuint32_t xb_box[2] = {64, GM};
    const cuuint64_t wd[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t ws[1] = {(cuuint64_t)N * 2};
    const cuuint32_t wb_box[2] = {64, GK};
    if ((err = encode_map(&mx, x, 2, xd, xs, xb_box))) return err;
    if ((err = encode_map(&mw, w, 2, wd, ws, wb_box))) return err;
    return out_bf16 ? launch_gemm<true>(mx, mw, out, M, N, K, st)
                    : launch_gemm<false>(mx, mw, out, M, N, K, st);
  }
  if (path != 0 || K % BK || splits < 1 || (K / BK) % splits ||
      splits > 65535 || (splits > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const int trips = K / BK / splits;
  if (splits == 1) {
    if (out_bf16)
      quant_matmul_kernel<true><<<grid, THREADS, 0, st>>>(xb, q, s, out, M, N,
                                                          K, trips);
    else
      quant_matmul_kernel<false><<<grid, THREADS, 0, st>>>(xb, q, s, out, M,
                                                           N, K, trips);
    return launch_status();
  }
  float* part = static_cast<float*>(scratch);
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
