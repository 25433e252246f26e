// W8A8 GEMM, s8 x s8 -> s32 on the tensor cores: the int8 dense layers'
// "native" path (ops/quant.py, quant_matmul under ARIES_QUANT_IMPL=native),
// CTranslate2's int8 scheme (per-channel weight scales, per-row dynamic
// activation scales).
//
// Replaces: whisper_aries_tpu/ops/quant.py, _quant_matmul_int8io (an XLA s8
// dot, not a Pallas kernel).
//
// What it computes, x (M, K) bf16 or f32, q (K, N) int8, s (N,) f32:
//   (a) quantize_rows_kernel, one block a row:
//         sx[m]     = max_k |x[m, k]| / 127, or 1 for a zero row
//         x8[m, k]  = clip(round_half_even(x[m, k] / sx[m]), -127, 127)
//       both divisions IEEE (__fdiv_rn: never the reciprocal product that
//       XLA makes of the JAX package's jitted "/ 127.0"), rounded by
//       __float2int_rn (half to even). The max is exact in any order.
//   (b) int8_gemm_kernel:
//         acc[m, n] = sum_k x8[m, k] q[k, n]        s32, exact
//         out[m, n] = (f32(acc) * sx[m]) * s[n]     __int2float_rn, two
//                                                   __fmul_rn (no FMA)
//       written as bf16 (__float2bfloat16_rn) or f32. The bias stays in
//       models/layers.py's dense, as in the JAX package.
// Every step is exact or one correctly rounded operation, so the output is
// the plain version's (ops/quant.py::quant_matmul_int8io_plain, an f64
// product of the int8 values) bit for bit.
//
// Bound on the H100: at a decode step's M (6 rows) the weights' bytes
// (1.6-6.6 MB a product, read once); at the encoder's M (windows x 1500)
// the products, 2 M N K at the int8 tensor-core rate. A first design that
// is right; wgmma, TMA and fusing (a) into (b) are later work.
//
// The operand layout. s8 mma.sync (m16n8k32) and s8 wgmma both take B
// K-major (wgmma's transpose bit exists only for 16-bit types), and the
// port keeps one copy of the weights, q (K, N) row-major: N-major. So (b)
// stages each 32 x 128 weight tile as it lies (16-byte cp.async, a
// swizzle on the 16-byte chunks: chunk c of row r lands at c ^ 2 ((r / 4)
// % 4), which makes the fragment reads below conflict-free), and each
// thread builds its B fragments in registers: it reads four 32-bit words,
// K rows 4t .. 4t + 3 at four adjacent columns, and transposes that 4 x 4
// byte block with eight __byte_perm, which gives the K-major words of four
// columns at once. The four columns go to four n8 tiles: n8 tile j of a
// warp holds the warp's columns 4 g + j (g = 0..7), so a thread's eight
// accumulators of a row are eight adjacent output columns (one 16-byte
// bf16 store).
//
// The tiling. A block is 4 warps along N (32 columns each, a 128-column
// tile); each warp holds all MT m16 tiles of the block's rows: row tiles
// of 16, 32 or 64 rows (a 128-row tile of 8 warps was slower at every M
// measured). The K loop runs over 32-row stages in a ring of 4 (cp.async,
// one block barrier a stage). At small M the stages can be split into up
// to 16 slices (grid z), which shortens each block's serial chain of
// stages: each slice adds its s32 partials into an s32 scratch (M, N) with
// integer atomics (exact, so the order does not matter), and the last
// block of a tile to arrive (a counter a tile) reads the sums back and
// writes the output. The atomics cost M x N a slice, so larger M splits
// less. ops/quant.py::int8_gemm_plan picks the row tile and the slices
// (from a measured sweep) and passes them in. Rows past M read zeros
// (cp.async zero fill) and are never stored; so are columns past N.
#include "attn_split.cuh"
#include "hopper.cuh"

namespace {

constexpr int G_COLS = 128;       // output columns a block, 32 a warp
constexpr int G_KC = 32;          // K rows a stage (one m16n8k32 step)
constexpr int G_NST = 4;          // ring stages
constexpr int G_XPITCH = 48;      // bytes a staged x row (32 + 16 of pad)
constexpr int G_MAX_SPLITS = 16;  // K slices at most
constexpr int Q_THREADS = 128;    // threads of a row-quantization block

// c += a . b on the tensor cores: m16n8k32, s8 in, s32 accumulate, with
// PTX's fragment layout (g = lane / 4, t = lane % 4; byte i of a word is
// the i-th of its four k):
//   a[0] (row g, k 4t..4t+3)  a[1] (row g+8, k 4t..)  a[2] (row g, k
//   16+4t..)  a[3] (row g+8, k 16+4t..)  b0 (k 4t..4t+3, col g)  b1 (k
//   16+4t.., col g)  c[0..1] (row g, cols 2t, 2t+1)  c[2..3] (row g+8, ..)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w[r] holds row r of a 4 x 4 byte block (byte j: column j); o[j] gets
// column j, its bytes in row order
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4],
                                             uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);  // a0 b0 a1 b1
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);  // a2 b2 a3 b3
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);  // c0 d0 c1 d1
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);  // c2 d2 c3 d3
  o[0] = __byte_perm(t0, t2, 0x5410);                   // a0 b0 c0 d0
  o[1] = __byte_perm(t0, t2, 0x7632);                   // a1 b1 c1 d1
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// byte offset of 16-byte chunk c (0..7) of staged weight row r (0..31)
__device__ __forceinline__ int b_off(int r, int c) {
  return r * G_COLS + ((c ^ (((r >> 2) & 3) << 1)) << 4);
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// out[idx .. idx + 7] = (f32(v[e]) * sxm) * s[e], as bf16 or f32
__device__ __forceinline__ void store8(void* out, int out_bf16, size_t idx,
                                       const int (&v)[8], float sxm,
                                       const float* s) {
  const float4 s0 = *reinterpret_cast<const float4*>(s);
  const float4 s1 = *reinterpret_cast<const float4*>(s + 4);
  const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  float f[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    f[e] = __fmul_rn(__fmul_rn(__int2float_rn(v[e]), sxm), sc[e]);
  if (out_bf16) {
    uint4 p;
    p.x = pack_bf2(f[0], f[1]);
    p.y = pack_bf2(f[2], f[3]);
    p.z = pack_bf2(f[4], f[5]);
    p.w = pack_bf2(f[6], f[7]);
    *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + idx) = p;
  } else {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + idx);
    o[0] = make_float4(f[0], f[1], f[2], f[3]);
    o[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// ---------------------------------------------------------------------------
// (a) row quantization
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(Q_THREADS)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ x8,
                         float* __restrict__ sx, int K) {
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * K;
  float m = 0.f;
  for (int i = threadIdx.x * 8; i < K; i += Q_THREADS * 8) {
    float v[8];
    load8(x + base + i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
  m = block_max(m, red);
  const float s = m > 0.f ? __fdiv_rn(m, 127.f) : 1.f;
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  for (int i = threadIdx.x * 8; i < K; i += Q_THREADS * 8) {
    float v[8];
    load8(x + base + i, v);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int qv = min(max(__float2int_rn(__fdiv_rn(v[e], s)), -127), 127);
      w[e >> 2] |= ((uint32_t)qv & 0xffu) << (8 * (e & 3));
    }
    *reinterpret_cast<uint2*>(x8 + base + i) = make_uint2(w[0], w[1]);
  }
}

// ---------------------------------------------------------------------------
// (b) the s8 GEMM with the rescale in its epilogue
// ---------------------------------------------------------------------------

template <int MT>
__global__ void __launch_bounds__(128)
    int8_gemm_kernel(const int8_t* __restrict__ x8,
                     const float* __restrict__ sx,
                     const int8_t* __restrict__ q,
                     const float* __restrict__ s, void* __restrict__ out,
                     int out_bf16, int M, int N, int K,
                     int* __restrict__ acc, int* __restrict__ arrived) {
  constexpr int THREADS = 128;
  constexpr int BM = 16 * MT;
  static_assert(2 * BM <= THREADS, "one x chunk a thread a stage");
  __shared__ __align__(128) uint8_t Bs[G_NST][G_KC * G_COLS];
  __shared__ __align__(16) uint8_t Xs[G_NST][BM * G_XPITCH];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wn = warp;
  const int n0 = blockIdx.x * G_COLS, m0 = blockIdx.y * BM;
  const int nk = K / G_KC, splits = gridDim.z;
  const int kb = (int)((long long)blockIdx.z * nk / splits);
  const int ke = (int)((long long)(blockIdx.z + 1) * nk / splits);

  // stage kt of the K loop into ring slot `slot`: the 32 x 128 weight
  // tile (swizzled chunks) and the block's BM x 32 rows of x8
  auto load = [&](int kt, int slot) {
    const int k0 = kt * G_KC;
#pragma unroll
    for (int c = tid; c < G_KC * 8; c += THREADS) {
      const int r = c >> 3, cc = c & 7, n = n0 + cc * 16;
      const bool ok = n < N;
      splitkv::cp16(&Bs[slot][b_off(r, cc)],
                    ok ? q + (size_t)(k0 + r) * N + n : q, ok ? 16 : 0);
    }
    if (tid < 2 * BM) {
      const int r = tid >> 1, cc = tid & 1, m = m0 + r;
      const bool ok = m < M;
      splitkv::cp16(&Xs[slot][r * G_XPITCH + cc * 16],
                    ok ? x8 + (size_t)m * K + k0 + cc * 16 : x8, ok ? 16 : 0);
    }
  };

  int c[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][j][e] = 0;

#pragma unroll
  for (int st = 0; st < G_NST - 1; ++st) {
    if (kb + st < ke) load(kb + st, st);
    splitkv::cp_commit();
  }
  for (int kt = kb; kt < ke; ++kt) {
    const int i = kt - kb;
    splitkv::cp_wait<G_NST - 2>();
    __syncthreads();  // stage kt landed for all; slot (i - 1) % NST is free
    if (kt + G_NST - 1 < ke) load(kt + G_NST - 1, (i + G_NST - 1) % G_NST);
    splitkv::cp_commit();
    const uint8_t* B = Bs[i % G_NST];
    const uint8_t* X = Xs[i % G_NST];
    // B fragments: k rows 16 h + 4 t + r at columns 32 wn + 4 g .. + 3
    uint32_t b[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = lds32(B + b_off(16 * h + 4 * t + r, 2 * wn + (g >> 2)) +
                     (g & 3) * 4);
      transpose4x4(w, b[h]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint8_t* xr = X + (mt * 16 + g) * G_XPITCH + 4 * t;
      const uint32_t a[4] = {lds32(xr), lds32(xr + 8 * G_XPITCH),
                             lds32(xr + 16), lds32(xr + 8 * G_XPITCH + 16)};
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(c[mt][j], a, b[0][j], b[1][j]);
    }
  }
  splitkv::cp_wait<0>();

  // a thread's row holds output columns ncol .. ncol + 7: element e is
  // n8 tile e % 4's accumulator 0 (e < 4) or 1 (e >= 4) of that row
  const int ncol = n0 + 32 * wn + 8 * t;
  const bool col_ok = ncol < N;  // N % 16 == 0: all 8 columns or none
  if (splits > 1) {
    // this slice's s32 partials into the scratch: integer sums, exact in
    // any order
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = m0 + mt * 16 + g + 8 * hi;
        if (row >= M || !col_ok) continue;
        int* a = acc + (size_t)row * N + ncol;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          atomicAdd(a + e, c[mt][e & 3][2 * hi + (e >> 2)]);
      }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last = atomicAdd(&arrived[blockIdx.y * gridDim.x + blockIdx.x], 1) ==
             splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();  // the other slices' partials are visible from here
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = m0 + mt * 16 + g + 8 * hi;
      if (row >= M || !col_ok) continue;
      const size_t idx = (size_t)row * N + ncol;
      int v[8];
      if (splits > 1) {
        const int4 lo = __ldcg(reinterpret_cast<const int4*>(acc + idx));
        const int4 up = __ldcg(reinterpret_cast<const int4*>(acc + idx + 4));
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = up.x; v[5] = up.y; v[6] = up.z; v[7] = up.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = c[mt][e & 3][2 * hi + (e >> 2)];
      }
      store8(out, out_bf16, idx, v, sx[row], s + ncol);
    }
}

template <int MT>
int launch_gemm(const int8_t* x8, const float* sx, const int8_t* q,
                const float* s, void* out, int out_bf16, int M, int N, int K,
                int splits, int* acc, int* arrived, cudaStream_t st) {
  const dim3 grid((N + G_COLS - 1) / G_COLS, (M + 16 * MT - 1) / (16 * MT),
                  splits);
  int8_gemm_kernel<MT><<<grid, 128, 0, st>>>(
      x8, sx, q, s, out, out_bf16, M, N, K, acc, arrived);
  return launch_status();
}

}  // namespace

extern "C" {

// x (M, K) bf16 (x_bf16 = 1) or f32, 16-byte aligned, K % 32 == 0 ->
// x8 (M, K) int8 and sx (M,) f32. Returns 0, a cudaError_t or ERR_BAD_ARGS.
int aries_int8_quantize_rows(const void* x, int x_bf16, int8_t* x8,
                             float* sx, int M, int K, void* stream) {
  if (M <= 0 || K <= 0 || K % 32) return ERR_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    quantize_rows_kernel<bf16><<<M, Q_THREADS, 0, st>>>(
        static_cast<const bf16*>(x), x8, sx, K);
  else
    quantize_rows_kernel<float><<<M, Q_THREADS, 0, st>>>(
        static_cast<const float*>(x), x8, sx, K);
  return launch_status();
}

// x8 (M, K) int8, sx (M,) f32, q (K, N) int8, s (N,) f32, all contiguous,
// x8, q and s 16-byte aligned; K % 32 == 0, N % 16 == 0. out (M, N) bf16
// (out_bf16 = 1) or f32, 16-byte aligned. `rows` (16, 32 or 64) the
// row tile, `splits` (1 .. min(16, K / 32)) the K slices; with splits > 1,
// acc an s32 (M, N) scratch of zeros and arrived ceil(M / rows) x ceil(N /
// 128) s32 zeros. Returns 0, a cudaError_t or ERR_BAD_ARGS.
int aries_int8_gemm(const int8_t* x8, const float* sx, const int8_t* q,
                    const float* s, void* out, int out_bf16, int M, int N,
                    int K, int rows, int splits, int* acc, int* arrived,
                    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % G_KC || N % 16 || splits < 1 ||
      splits > G_MAX_SPLITS || splits > K / G_KC ||
      (splits > 1 && (acc == nullptr || arrived == nullptr)) ||
      rows < 16 || (M + rows - 1) / rows > 65535)
    return ERR_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  switch (rows) {
    case 16:
      return launch_gemm<1>(x8, sx, q, s, out, out_bf16, M, N, K, splits, acc,
                            arrived, st);
    case 32:
      return launch_gemm<2>(x8, sx, q, s, out, out_bf16, M, N, K, splits, acc,
                            arrived, st);
    case 64:
      return launch_gemm<4>(x8, sx, q, s, out, out_bf16, M, N, K, splits, acc,
                            arrived, st);
    default:
      return ERR_BAD_ARGS;
  }
}

}  // extern "C"
