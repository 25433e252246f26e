// W8A8 GEMM, s8 x s8 -> s32 on the tensor cores: the int8 dense layers'
// "native" path (ops/quant.py, quant_matmul under ARIES_QUANT_IMPL=native),
// CTranslate2's int8 scheme (per-channel weight scales, per-row dynamic
// activation scales).
//
// Replaces: whisper_aries_tpu/ops/quant.py, _quant_matmul_int8io (an XLA s8
// dot, not a Pallas kernel).
//
// What it computes, x (M, K) bf16 or f32, q (K, N) int8, s (N,) f32:
//   sx[m]     = max_k |x[m, k]| / 127, or 1 for a zero row
//   x8[m, k]  = clip(round_half_even(x[m, k] / sx[m]), -127, 127)
//   acc[m, n] = sum_k x8[m, k] q[k, n]        s32, exact in any order
//   out[m, n] = (f32(acc) * sx[m]) * s[n]     __int2float_rn, two __fmul_rn
// both divisions IEEE (__fdiv_rn: never the reciprocal product that XLA
// makes of the JAX package's jitted "/ 127.0"; x / sx is taken as a
// product by the correctly rounded reciprocal only where that provably
// rounds to the same integer, quantize8), rounded by __float2int_rn (half
// to even); the max is exact in any order. Written as bf16
// (__float2bfloat16_rn) or f32; the bias stays in models/layers.py's
// dense, as in the JAX package. Every step is exact or one correctly
// rounded operation, so both paths give the plain version's bits
// (ops/quant.py::quant_matmul_int8io_plain, an f64 product of the int8
// values) at every M and plan.
//
// The operand layout. s8 wgmma and s8 mma.sync both take B K-major (wgmma's
// transpose bit exists only for 16-bit types), and the port keeps one copy
// of the weights, q (K, N) row-major: N-major. A K-major copy kept beside
// it would cost the int8 weights again (1.47 GB at large-v3). Each path
// meets the layout its own way; ops/quant.py::int8_gemm_plan picks the path
// by M and passes its tile in.
//
// "wgmma" (large M: the encoder's M = windows x 1500, the largest
// prefills). Bound on the H100: operations, 2 M N K at 1,979 TOPS (0.0149
// ms at M 9000, K = N = 1280). Two launches a call:
//   (a) prepare_kernel, split by blockIdx: blocks below the row count
//       quantize x, a warp a row (the max, then the int8 values from the
//       values kept in registers), into an x8 (M, K) and sx (M,) scratch;
//       the rest transpose q into a K-major qt (N, K) scratch, a 64 x 64
//       byte tile a block (4 x 4 byte blocks transposed in registers by
//       __byte_perm, through shared memory so both sides move whole
//       rows). The scratch
//       is 1.6-6.6 MB at large-v3 and stays in the 50 MB L2 for (b); it is
//       made again each call (kernel 5's per-call dequant, quant_matmul.cu),
//       so the weights keep one copy.
//   (b) wgmma_kernel: output tiles of 128 rows x BN columns (BN 128 or
//       256), K stages of 128 bytes (one 128-byte swizzle row, four k32
//       steps) in a ring of STAGES (6 or 4: 192 KB) with full and empty
//       mbarriers. A producer warpgroup (registers given back by
//       setmaxnreg) issues the TMA loads of x8 and qt, both K-major; two
//       consumer warpgroups of 64 rows run wgmma m64n128k32 s8 into s32
//       registers (BN / 128 a k32 step), one commit group in flight. The
//       epilogue rescales in registers, stages each 128-byte column chunk
//       of a warpgroup's 64 rows in shared memory and stores whole lines
//       of rows < M, columns < N; the maps fill rows past M, columns past
//       N and K past its end with zeros, so the sums there are 0 and are
//       never stored. One block an SM walks its share of the tiles
//       (persistent), and the producer runs on into the next tile's stages
//       while the consumers store. The plan takes 128 x 256 tiles where
//       they give every SM one, else 128 x 128.
//
// "cluster" (small M: a decode step's 6 rows, the words prefill's 18, up
// to the plan's cut-over). Bound on the H100: bytes, the int8 weights read
// once (22.9 MB a large-v3 decoder layer, 0.0070 ms). One launch a
// product, the row quantization inside, no device scratch, no atomics:
//   * grid (S, ceil(N / 64)): block (ks, ct) owns output columns
//     [64 ct, 64 ct + 64) and the K slice [ks K / S, (ks + 1) K / S); the S
//     slices of a column tile are one thread-block cluster (S <= 8).
//   * The weight stream (kernel 5's "splitk"): 32-row stages of the N-major
//     tile (2 KB, one 16-byte cp.async a thread) through a ring of 16
//     stages, issued from the block's first instruction (its rows' K slice
//     of x rides in the first stage's group), so 32 KB are in flight while
//     the block quantizes its rows.
//   * The fused quantization: each block takes the row maxima of its own K
//     slice of x (a warp a row, from shared memory), pushes them into every
//     rank's shared memory, and after one cluster barrier takes the max of
//     the S partial maxima. A max is exact in any order, so every block
//     derives the same sx; it then quantizes its slice into shared memory
//     as the s8 operand.
//   * The products: mma.sync m16n8k32 s8. A thread reads the words of K
//     rows 4t .. 4t + 3 (and 16 + ...) at four adjacent columns and
//     transposes each 4 x 4 byte block with eight __byte_perm, which gives
//     four columns' K-major words. The weights are the m16 operand (two
//     m16 tiles from one pair of transposes: tile h rows g, g + 8 are
//     columns 4g + 2h, 4g + 2h + 1) and a group of 8 x rows is the n8
//     operand, so 8 rows cost two mma a warp a stage. (x's rows as the m16
//     operand, each transposed column to one of four n8 tiles, was slower
//     at every product at M 6 and 18 on the H100.)
//     A warp owns 32 columns and every other stage (warp & 1: the column
//     half; warp >> 1: the stage parity): the stages land in pairs, one
//     block barrier a pair. Groups whose rows all lie past M are skipped.
//     Rows past 64 (rows a pass) loop, the weights streamed again from
//     L2.
//   * The reduction: each warp writes its s32 partials, 4 adjacent columns
//     of a row at a time (a unit), into the shared memory of the block that
//     owns the unit (unit u: rank u % S), one slot per (rank, parity); after
//     one cluster barrier each owner adds the 2 S partials in rank order,
//     rescales and stores. No atomics, no scratch, no memset, no read-back.
#include "attn_split.cuh"
#include "hopper.cuh"

namespace {

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

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 8 values of x as they lie, kept in registers
template <typename T>
struct Chunk;
template <>
struct Chunk<bf16> {
  uint4 u;
  __device__ __forceinline__ void load(const bf16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Chunk<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void get(float (&v)[8]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

// 8 values of x at p (16-byte aligned) as f32
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  Chunk<T> c;
  c.load(p);
  c.get(v);
}

// the row scale from the row's max |x|
__device__ __forceinline__ float row_scale(float m) {
  return m > 0.f ? __fdiv_rn(m, 127.f) : 1.f;
}

// eight values divided by the row scale s (r = __frcp_rn(s)), rounded half
// to even, clipped, packed as eight int8: rint(__fdiv_rn(v, s)) bit for
// bit, without a division per value. |v / s| <= 127 (s is the row's max /
// 127), so q = __fmul_rn(v, r) lies within 1.5 x 2^-16 of the correctly
// rounded quotient (r and the product each within half an ulp, an ulp
// below 128 at most 2^-16); where q is more than 2^-14 from every
// half-integer, both round to the same integer. Otherwise (rare; and for
// a non-finite q) the eight values are divided. __fdiv_rn branches to a
// slow path, so a division per value serializes the loop: on the H100 it
// took 1.6-3.8 us of a small-M product.
__device__ __forceinline__ uint2 quantize8(const float (&v)[8], float s,
                                          float r) {
  float q[8];
  bool near = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    q[e] = __fmul_rn(v[e], r);
    near |= !(fabsf(__fsub_rn(__fsub_rn(q[e], floorf(q[e])), 0.5f)) >
              0x1p-14f);
  }
  if (near) {
#pragma unroll
    for (int e = 0; e < 8; ++e) q[e] = __fdiv_rn(v[e], s);
  }
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int qv = min(max(__float2int_rn(q[e]), -127), 127);
    w[e >> 2] |= ((uint32_t)qv & 0xffu) << (8 * (e & 3));
  }
  return make_uint2(w[0], w[1]);
}

// out[row, col + e] = (f32(v[e]) * sxm) * s[col + e], e < 4
__device__ __forceinline__ void store4(bf16* out, size_t idx,
                                       const int (&v)[4], float sxm,
                                       const float* s) {
  const float4 sc = __ldg(reinterpret_cast<const float4*>(s));
  const float c[4] = {sc.x, sc.y, sc.z, sc.w};
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __fmul_rn(__fmul_rn(__int2float_rn(v[e]), sxm), c[e]);
  *reinterpret_cast<uint2*>(out + idx) =
      make_uint2(pack_bf2(f[0], f[1]), pack_bf2(f[2], f[3]));
}
__device__ __forceinline__ void store4(float* out, size_t idx,
                                       const int (&v)[4], float sxm,
                                       const float* s) {
  const float4 sc = __ldg(reinterpret_cast<const float4*>(s));
  const float c[4] = {sc.x, sc.y, sc.z, sc.w};
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __fmul_rn(__fmul_rn(__int2float_rn(v[e]), sxm), c[e]);
  *reinterpret_cast<float4*>(out + idx) = make_float4(f[0], f[1], f[2], f[3]);
}

// out[row, col], out[row, col + 1] from two s32 sums
__device__ __forceinline__ void store2(bf16* out, size_t idx, int a, int b,
                                       float sxm, float s0, float s1) {
  *reinterpret_cast<uint32_t*>(out + idx) =
      pack_bf2(__fmul_rn(__fmul_rn(__int2float_rn(a), sxm), s0),
               __fmul_rn(__fmul_rn(__int2float_rn(b), sxm), s1));
}
__device__ __forceinline__ void store2(float* out, size_t idx, int a, int b,
                                       float sxm, float s0, float s1) {
  *reinterpret_cast<float2*>(out + idx) =
      make_float2(__fmul_rn(__fmul_rn(__int2float_rn(a), sxm), s0),
                  __fmul_rn(__fmul_rn(__int2float_rn(b), sxm), s1));
}

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

// ---------------------------------------------------------------------------
// "wgmma" path, (a): the row quantization and the weights' transposition
// ---------------------------------------------------------------------------

constexpr int P_THREADS = 256;
constexpr int P_ROWS = P_THREADS / 32;  // rows a quantization block
constexpr int P_TILE = 64;              // K x N bytes a transposition block

// the chunks of 8 values a lane of a quantization warp keeps for a row of
// K: each lane's share of the row, in steps of 4, at most 20 (bf16: 80
// registers) or 12 (f32)
inline int prepare_keep(int K, int x_bytes) {
  const int need = (K + 255) / 256, cap = x_bytes == 2 ? 20 : 12;
  const int keep = (need + 3) / 4 * 4;
  return keep < cap ? keep : cap;
}

template <typename T, int KEEP>
__global__ void __launch_bounds__(P_THREADS)
prepare_kernel(const T* __restrict__ x, int8_t* __restrict__ x8,
               float* __restrict__ sx, const int8_t* __restrict__ q,
               int8_t* __restrict__ qt, int M, int N, int K, int qblocks) {
  __shared__ uint32_t st[P_TILE][P_TILE / 4 + 1];
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < qblocks) {  // rows: one a warp
    const int lane = tid & 31, row = blockIdx.x * P_ROWS + (tid >> 5);
    if (row >= M) return;
    const T* xr = x + (size_t)row * K;
    int8_t* x8r = x8 + (size_t)row * K;
    // a lane's first KEEP chunks of 8 values stay in registers as they lie,
    // so x is read once up to K = 256 KEEP (a second read of each row
    // missed L2 at M 9000, K 5120); chunks past them are read again. KEEP
    // follows K (prepare_keep): registers kept for nothing cost blocks an
    // SM, and bytes in flight
    Chunk<T> keep[KEEP];
    float m = 0.f;
#pragma unroll
    for (int c = 0; c < KEEP; ++c) {
      const int i = (lane + 32 * c) * 8;
      if (i < K) {
        float v[8];
        keep[c].load(xr + i);
        keep[c].get(v);
#pragma unroll
        for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
      }
    }
    for (int i = (lane + 32 * KEEP) * 8; i < K; i += 256) {
      float v[8];
      load8(xr + i, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
    }
    const float s = row_scale(warp_max(m)), r = __frcp_rn(s);
    if (lane == 0) sx[row] = s;
#pragma unroll
    for (int c = 0; c < KEEP; ++c) {
      const int i = (lane + 32 * c) * 8;
      if (i < K) {
        float v[8];
        keep[c].get(v);
        *reinterpret_cast<uint2*>(x8r + i) = quantize8(v, s, r);
      }
    }
    for (int i = (lane + 32 * KEEP) * 8; i < K; i += 256) {
      float v[8];
      load8(xr + i, v);
      *reinterpret_cast<uint2*>(x8r + i) = quantize8(v, s, r);
    }
    return;
  }
  // q (K, N) -> qt (N, K), one 64 x 64 byte tile: thread (kb, nb) moves
  // the 4 x 4 block at K rows k0 + 4 kb, columns n0 + 4 nb (N % 16 == 0
  // and K % 32 == 0: a block is all inside or all outside)
  const int tiles_n = (N + P_TILE - 1) / P_TILE;
  const int tile = blockIdx.x - qblocks;
  const int k0 = (tile / tiles_n) * P_TILE, n0 = (tile % tiles_n) * P_TILE;
  const int kb = tid >> 4, nb = tid & 15;
  const int k = k0 + 4 * kb, n = n0 + 4 * nb;
  uint32_t w[4] = {0u, 0u, 0u, 0u}, o[4];
  if (k < K && n < N) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)(k + r) * N +
                                                     n));
  }
  transpose4x4(w, o);
#pragma unroll
  for (int j = 0; j < 4; ++j) st[4 * nb + j][kb] = o[j];
  __syncthreads();
  const int nr = tid >> 2, c = tid & 3;  // qt row n0 + nr, K bytes 16c..
  if (n0 + nr < N && k0 + 16 * c < K)
    *reinterpret_cast<uint4*>(qt + (size_t)(n0 + nr) * K + k0 + 16 * c) =
        make_uint4(st[nr][4 * c], st[nr][4 * c + 1], st[nr][4 * c + 2],
                   st[nr][4 * c + 3]);
}

// ---------------------------------------------------------------------------
// "wgmma" path, (b): TMA + s8 wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int W_BM = 128, W_BK = 128;  // rows a tile; K bytes a stage
constexpr int W_THREADS = 384;         // consumers: warpgroups 0, 1;
                                       // producer: warpgroup 2
constexpr int W_A = W_BM * W_BK;       // 16 KB: the x8 tile
constexpr int W_PITCH = 128 + 16;      // bytes an output row of a chunk
                                       // (16 of pad: conflict-free writes)
constexpr int W_OUT = 64 * W_PITCH;    // a consumer warpgroup's buffer

// the ring, then 1 KB for the barriers, then the two output buffers
template <int BN, int STAGES>
constexpr int wgmma_smem() {
  return 1024 + STAGES * (W_A + BN * W_BK) + 1024 + 2 * W_OUT;
}

// ma: x8 (K, M) bytes, box (128, 128); mb: qt (K, N) bytes, box (128, BN);
// both 128-byte swizzled. OutT bf16 or f32. Persistent: block b takes
// output tiles b, b + gridDim.x, ... (column tiles fastest, so the blocks
// in flight share x8's rows in L2), and the producer runs on into the next
// tile's stages while the consumers store this one's.
template <int BN, int STAGES, typename OutT>
__global__ void __launch_bounds__(W_THREADS, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap ma,
             const __grid_constant__ CUtensorMap mb,
             const float* __restrict__ sx, const float* __restrict__ s,
             OutT* __restrict__ out, int M, int N, int K) {
  constexpr int STAGE = W_A + BN * W_BK;
  constexpr int H = BN / 128;  // m64n128k32 products a k32 step
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int k_tiles = (K + W_BK - 1) / W_BK;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_n * ((M + W_BM - 1) / W_BM);

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    setmaxnreg_dec<40>();
    if (tid == 0) {
      int it = 0;  // stages issued, over all of this block's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % tiles_n) * BN, m0 = (tile / tiles_n) * W_BM;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
          uint8_t* a = smem + st * STAGE;
          mbar_arrive_expect_tx(&full[st], STAGE);
          tma_load_2d(a, &ma, &full[st], kt * W_BK, m0);
          tma_load_2d(a + W_A, &mb, &full[st], kt * W_BK, n0);
        }
      }
    }
    return;
  }
  // consumers: rows m0 + 64 wg .. + 63 of each tile
  setmaxnreg_inc<232>();
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int it = 0;  // stages consumed
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % tiles_n) * BN, m0 = (tile / tiles_n) * W_BM;
    int acc[H][64];
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0;

    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      const uint8_t* a = smem + st * STAGE + wg * 64 * W_BK;
      const uint8_t* b = smem + st * STAGE + W_A;
#pragma unroll
      for (int h = 0; h < H; ++h) fence_regs(acc[h]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W_BK / 32; ++kk) {
        const uint64_t da = wgmma_desc(a + kk * 32, 16, 1024);
#pragma unroll
        for (int h = 0; h < H; ++h)
          wgmma_m64n128k32_s8(acc[h], da,
                              wgmma_desc(b + h * 128 * W_BK + kk * 32, 16,
                                         1024),
                              1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
#pragma unroll
      for (int h = 0; h < H; ++h) fence_regs(acc[h]);
      if (kt > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < H; ++h) fence_regs(acc[h]);
    if (tid == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

    // acc[h][4j + 2 half + e]: row 16 warp + g + 8 half of the
    // warpgroup's 64, column h 128 + 8j + 2t + e. Stored through this
    // warpgroup's 64-row buffer a 128-byte column chunk at a time, so each
    // store of a warp writes whole 128-byte lines (4- or 8-byte stores
    // straight from the fragments wrote at about a quarter of the H100's
    // memory rate: half the kernel's time at M 9000, K = N = 1280)
    constexpr int CW = 128 / (int)sizeof(OutT);  // columns a chunk
    uint8_t* buf = smem + STAGES * STAGE + 1024 + wg * W_OUT;
    const int rw = warp * 16 + g;  // this thread's rows rw, rw + 8
    const int m1 = m0 + wg * 64;
    const float sx0 = m1 + rw < M ? sx[m1 + rw] : 0.f;
    const float sx1 = m1 + rw + 8 < M ? sx[m1 + rw + 8] : 0.f;
#pragma unroll
    for (int cc = 0; cc < BN / CW; ++cc) {
#pragma unroll
      for (int jj = 0; jj < CW / 8; ++jj) {
        const int base = cc * CW + jj * 8;  // constant: so is acc's index
        const int h = base / 128, j = (base % 128) / 8;
        const int col = base + 2 * t;  // in the tile
        const float2 sc =
            n0 + col < N ? __ldg(reinterpret_cast<const float2*>(s + n0 +
                                                                 col))
                         : make_float2(0.f, 0.f);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          store2(reinterpret_cast<OutT*>(buf + (rw + 8 * half) * W_PITCH),
                 col % CW, acc[h][4 * j + 2 * half],
                 acc[h][4 * j + 2 * half + 1], half ? sx1 : sx0, sc.x,
                 sc.y);
      }
      named_barrier(1 + wg, 128);  // the chunk is in the buffer
      // 64 rows x 128 bytes: 8 threads a row, 16 rows a pass
#pragma unroll
      for (int pass = 0; pass < 4; ++pass) {
        const int r = pass * 16 + (tid >> 3), piece = tid & 7;
        const int row = m1 + r;
        const int col = n0 + cc * CW + piece * (16 / (int)sizeof(OutT));
        if (row < M && col < N)  // N % 16 == 0: a piece is all in or out
          *reinterpret_cast<uint4*>(out + (size_t)row * N + col) =
              *reinterpret_cast<const uint4*>(buf + r * W_PITCH + 16 * piece);
      }
      named_barrier(1 + wg, 128);  // the buffer is free again
    }
  }
}

// ---------------------------------------------------------------------------
// "cluster" path
// ---------------------------------------------------------------------------

constexpr int C_COLS = 64;          // output columns a block, 32 a warp
constexpr int C_UNITS = C_COLS / 4; // 4-column units a row
constexpr int C_THREADS = 128;
constexpr int C_KC = 32;            // K rows a ring stage
constexpr int C_NST = 16;           // ring stages (32 KB of weights)
constexpr int C_WLD = 80;           // bytes a staged weight row (64 + pad)
constexpr int C_STAGE = C_KC * C_WLD;  // bytes a ring stage
constexpr int C_MAX_CLUSTER = 8;
constexpr int C_MAX_ROWS = 64;      // rows a pass
constexpr int C_MAX_SMEM = 232448;  // the opt-in limit of a block

// the ring's stages for a K slice: as many as the slice has, at most
// C_NST (a shorter ring leaves room for more blocks an SM)
__host__ __device__ inline int cluster_ring(int kslice) {
  const int n = kslice / C_KC;
  return (n < C_NST ? n : C_NST) * C_STAGE;
}

// the shared memory of a block: the ring, its rows' K slice of x as it
// lies (x_bytes a value), the s8 rows of the slice (16 bytes of pad a row:
// conflict-free fragment reads), the partial sums it owns (2 S
// contributions of ceil(rows x 16 / S) units of 16 bytes), the S ranks'
// partial maxima and the rows' scales and their reciprocals
__host__ __device__ inline int cluster_smem(int rows, int kslice, int S,
                                            int x_bytes) {
  const int per = (rows * C_UNITS + S - 1) / S;
  return cluster_ring(kslice) + rows * kslice * x_bytes +
         rows * (kslice + 16) + 2 * S * per * 16 + S * rows * 4 + rows * 8;
}

// RT: rows a pass; T: x's type; OutT: out's
template <int RT, typename T, typename OutT>
__global__ void __launch_bounds__(C_THREADS)
cluster_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ s, OutT* __restrict__ out, int M,
               int N, int K) {
  static_assert(RT % 8 == 0, "whole row groups");
  constexpr int G = RT / 8;  // row groups of 8: the mma's n8 operand
  extern __shared__ __align__(128) uint8_t sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ch = warp & 1, par = warp >> 1;  // column half, stage parity
  const int S = gridDim.x, ks = blockIdx.x;
  const int n0 = blockIdx.y * C_COLS;
  const int kslice = K / S, kbase = ks * kslice, nch = kslice / C_KC;
  const int xp = kslice + 16;
  const int per = (RT * C_UNITS + S - 1) / S;  // units a rank owns
  // (RT, kslice) as it lies
  T* xraw = reinterpret_cast<T*>(sm + cluster_ring(kslice));
  uint8_t* x8s = reinterpret_cast<uint8_t*>(xraw + RT * kslice);
  int4* red = reinterpret_cast<int4*>(x8s + RT * xp);
  unsigned* pmax = reinterpret_cast<unsigned*>(red + 2 * S * per);
  float* sxs = reinterpret_cast<float*>(pmax + S * RT);
  float* sxr = sxs + RT;  // the scales' reciprocals
  splitkv::cluster_arrive_relaxed();  // waited on before the first push

  auto load_w = [&](int c) {  // stage c: 32 rows x 64 columns, 16 B a thread
    const int r = tid >> 2, cc = tid & 3;
    const int gn = n0 + 16 * cc;
    const bool ok = gn < N;
    splitkv::cp16(sm + (c % C_NST) * C_STAGE + r * C_WLD + 16 * cc,
                  q + (size_t)(kbase + c * C_KC + r) * N + (ok ? gn : 0),
                  ok ? 16 : 0);
  };
  const int chunks = kslice / 8;  // 8 values a chunk
  constexpr int CP = sizeof(T) / 2;  // 16-byte copies a chunk

  for (int r0 = 0; r0 < M; r0 += RT) {
    if (r0 > 0) __syncthreads();  // the last pass is done with the ring
    // the rows' slice of x, a group of its own (past M: zeros), then the
    // first stages in pairs: group p + 1 holds stages 2p and 2p + 1
    for (int i = tid; i < RT * chunks * CP; i += C_THREADS) {
      const int r = i / (chunks * CP), e = i - r * chunks * CP;
      const int row = r0 + r;
      const bool ok = row < M;
      splitkv::cp16(reinterpret_cast<uint8_t*>(xraw + r * kslice) + 16 * e,
                    reinterpret_cast<const uint8_t*>(
                        x + (size_t)(ok ? row : 0) * K + kbase) + 16 * e,
                    ok ? 16 : 0);
    }
    splitkv::cp_commit();
    for (int p2 = 0; p2 < C_NST / 2 - 1; ++p2) {
      if (2 * p2 < nch) load_w(2 * p2);
      if (2 * p2 + 1 < nch) load_w(2 * p2 + 1);
      splitkv::cp_commit();
    }
    splitkv::cp_wait<C_NST / 2 - 1>();
    __syncthreads();  // x landed
    // this slice's row maxima (the bits of |x|: non-negative floats order
    // as their bits), a warp a row, into this rank's slot
    unsigned* mine = pmax + ks * RT;
    for (int r = warp; r < RT; r += C_THREADS / 32) {
      float m = 0.f;
      for (int c8 = lane; c8 < chunks; c8 += 32) {
        float v[8];
        load8(xraw + r * kslice + 8 * c8, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
      }
      m = warp_max(m);
      if (lane == 0) mine[r] = __float_as_uint(m);
    }
    __syncthreads();
    if (r0 == 0) splitkv::cluster_wait();  // every block of the cluster runs
    for (int i = tid; i < RT * S; i += C_THREADS) {
      const int rank = i / RT, r = i - rank * RT;
      if (rank != ks) *cl.map_shared_rank(mine + r, rank) = mine[r];
    }
    cl.sync();  // every rank's maxima landed
    for (int r = tid; r < RT; r += C_THREADS) {
      unsigned m = 0u;
      for (int k = 0; k < S; ++k) m = max(m, pmax[k * RT + r]);
      sxs[r] = row_scale(__uint_as_float(m));
      sxr[r] = __frcp_rn(sxs[r]);
    }
    __syncthreads();
    for (int i = tid; i < RT * chunks; i += C_THREADS) {
      const int r = i / chunks, c8 = 8 * (i - r * chunks);
      float v[8];
      load8(xraw + r * kslice + c8, v);  // rows past M: zeros
      *reinterpret_cast<uint2*>(x8s + r * xp + c8) =
          quantize8(v, sxs[r], sxr[r]);
    }
    const int ng = min(G, (M - r0 + 7) / 8);  // groups holding a row < M

    int acc[G][2][4];
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

    // a pair of stages a barrier, one to each half of the warps
    for (int c0 = 0; c0 < nch; c0 += 2) {
      splitkv::cp_wait<C_NST / 2 - 2>();
      __syncthreads();  // pair c0 / 2 landed (and x8s written); the last
                        // pair's slots are free
      {
        const int pn = c0 / 2 + C_NST / 2 - 1;
        if (2 * pn < nch) load_w(2 * pn);
        if (2 * pn + 1 < nch) load_w(2 * pn + 1);
      }
      splitkv::cp_commit();
      const int c = c0 + par;
      if (c >= nch) continue;
      // words of K rows 4t + r and 16 + 4t + r at columns 32 ch + 4g ..
      const uint8_t* B = sm + (c % C_NST) * C_STAGE + 32 * ch + 4 * g;
      uint32_t w0[4], w1[4], o0[4], o1[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        w0[r] = lds32(B + (4 * t + r) * C_WLD);
        w1[r] = lds32(B + (16 + 4 * t + r) * C_WLD);
      }
      transpose4x4(w0, o0);  // o0[j]: column 32 ch + 4g + j, k 4t..4t+3
      transpose4x4(w1, o1);  // o1[j]: the same column, k 16 + 4t..
      const uint8_t* X = x8s + c * C_KC + 4 * t;
      const uint32_t a0[4] = {o0[0], o0[1], o1[0], o1[1]};
      const uint32_t a1[4] = {o0[2], o0[3], o1[2], o1[3]};
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (i >= ng) continue;
        const uint8_t* xr = X + (8 * i + g) * xp;  // x row 8i + g
        const uint32_t b0 = lds32(xr), b1 = lds32(xr + 16);
        mma_s8(acc[i][0], a0, b0, b1);
        mma_s8(acc[i][1], a1, b0, b1);
      }
    }
    splitkv::cp_wait<0>();

    // this warp's partials by unit (row x 16 + column / 4) into the owning
    // rank's slot (2 ks + par) x per + u / S
    const int slot = (2 * ks + par) * per;
    auto put = [&](int r, int cu, int a, int b, int c2, int d) {
      const int u = r * C_UNITS + cu;
      int4* dst = red + slot + u / S;
      *cl.map_shared_rank(dst, u % S) = make_int4(a, b, c2, d);
    };
    // acc[i][A][h]: row 8i + 2t + h, column 32 ch + 4g + 2A;
    // acc[i][A][2 + h]: the next column
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        put(8 * i + 2 * t + h, 8 * ch + g, acc[i][0][h], acc[i][0][2 + h],
            acc[i][1][h], acc[i][1][2 + h]);
    cl.sync();  // every partial of this rank's units landed
    for (int lp = tid; lp < per; lp += C_THREADS) {
      const int u = lp * S + ks;
      const int r = u / C_UNITS, row = r0 + r, col = n0 + 4 * (u % C_UNITS);
      if (r >= RT || row >= M || col >= N) continue;
      int v[4] = {0, 0, 0, 0};
      for (int k = 0; k < 2 * S; ++k) {  // rank order, parity 0 then 1
        const int4 p = red[k * per + lp];
        v[0] += p.x;
        v[1] += p.y;
        v[2] += p.z;
        v[3] += p.w;
      }
      store4(out, (size_t)row * N + col, v, sxs[r], s + col);
    }
  }
}

template <int RT, typename T, typename OutT>
int launch_cluster_t(const void* x, const int8_t* q, const float* s,
                     void* out, int M, int N, int K, int S,
                     cudaStream_t st) {
  auto kern = cluster_kernel<RT, T, OutT>;
  static std::once_flag once[MAX_CARDS];
  static int status[MAX_CARDS];
  const int e = once_per_card(once, status, [kern] {
    const cudaError_t r = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C_MAX_SMEM);
    return r == cudaSuccess ? 0 : ERR_ATTRIBUTE + (int)r;
  });
  if (e) return e;
  const dim3 grid(S, (N + C_COLS - 1) / C_COLS);
  return splitkv::launch(kern, grid, C_THREADS,
                         cluster_smem(RT, K / S, S, sizeof(T)), S, 0, st,
                         static_cast<const T*>(x), q, s,
                         static_cast<OutT*>(out), M, N, K);
}

template <typename T, typename OutT>
int launch_cluster(const void* x, const int8_t* q, const float* s, void* out,
                   int M, int N, int K, int S, int rows, cudaStream_t st) {
  switch (rows) {
#define ARIES_ROWS(R)                                                    \
  case R:                                                                \
    return launch_cluster_t<R, T, OutT>(x, q, s, out, M, N, K, S, st);
    ARIES_ROWS(8) ARIES_ROWS(16) ARIES_ROWS(24) ARIES_ROWS(32)
    ARIES_ROWS(40) ARIES_ROWS(48) ARIES_ROWS(56) ARIES_ROWS(64)
#undef ARIES_ROWS
  }
  return ERR_BAD_ARGS;
}

template <int BN, int STAGES, typename OutT>
int launch_wgmma_t(const CUtensorMap& ma, const CUtensorMap& mb,
                   const float* sx, const float* s, void* out, int M, int N,
                   int K, int sms, cudaStream_t st) {
  auto kern = wgmma_kernel<BN, STAGES, OutT>;
  static std::once_flag once[MAX_CARDS];
  static int status[MAX_CARDS];
  const int e = once_per_card(once, status, [kern] {
    const cudaError_t r = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        wgmma_smem<BN, STAGES>());
    return r == cudaSuccess ? 0 : ERR_ATTRIBUTE + (int)r;
  });
  if (e) return e;
  const long long tiles =
      (long long)((N + BN - 1) / BN) * ((M + W_BM - 1) / W_BM);
  const int grid = (int)(tiles < sms ? tiles : sms);
  kern<<<grid, W_THREADS, wgmma_smem<BN, STAGES>(), st>>>(
      ma, mb, sx, s, static_cast<OutT*>(out), M, N, K);
  return launch_status();
}

}  // namespace

extern "C" {

// The "wgmma" path's (a): x (M, K) bf16 (x_bf16 = 1) or f32 -> x8 (M, K)
// int8 and sx (M,) f32; q (K, N) int8 -> qt (N, K) int8. All contiguous
// and 16-byte aligned; K % 32 == 0, N % 16 == 0. Returns 0, a cudaError_t
// or ERR_BAD_ARGS.
int aries_int8_prepare(const void* x, int x_bf16, int8_t* x8, float* sx,
                       const int8_t* q, int8_t* qt, int M, int N, int K,
                       void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 || N % 16) return ERR_BAD_ARGS;
  const long long qblocks = (M + P_ROWS - 1) / P_ROWS;
  const long long tblocks = (long long)((K + P_TILE - 1) / P_TILE) *
                            ((N + P_TILE - 1) / P_TILE);
  if (qblocks + tblocks > 0x7fffffffLL) return ERR_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)(qblocks + tblocks);
#define ARIES_KEEP(T, KP)                                                 \
  case KP:                                                                \
    prepare_kernel<T, KP><<<grid, P_THREADS, 0, st>>>(                    \
        static_cast<const T*>(x), x8, sx, q, qt, M, N, K, (int)qblocks); \
    break;
  if (x_bf16) {
    switch (prepare_keep(K, 2)) {
      ARIES_KEEP(bf16, 4) ARIES_KEEP(bf16, 8) ARIES_KEEP(bf16, 12)
      ARIES_KEEP(bf16, 16) ARIES_KEEP(bf16, 20)
    }
  } else {
    switch (prepare_keep(K, 4)) {
      ARIES_KEEP(float, 4) ARIES_KEEP(float, 8) ARIES_KEEP(float, 12)
    }
  }
#undef ARIES_KEEP
  return launch_status();
}

// The "wgmma" path's (b): x8 (M, K) int8 with its row scales sx (M,),
// qt (N, K) int8 (the weights K-major), s (N,) f32 -> out (M, N) bf16
// (out_bf16 = 1) or f32 = (f32(x8 qt^T) * sx) * s. All contiguous and
// 16-byte aligned; K % 32 == 0, N % 16 == 0; bn 128 or 256 (the tile's
// columns); at most `sms` blocks (one an SM, persistent). Returns 0, a
// cudaError_t or hopper.cuh's codes.
int aries_int8_gemm_wgmma(const int8_t* x8, const float* sx,
                          const int8_t* qt, const float* s, void* out,
                          int out_bf16, int M, int N, int K, int bn, int sms,
                          void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 || N % 16 || sms <= 0 ||
      (M + W_BM - 1) / W_BM > 65535 || (bn != 128 && bn != 256))
    return ERR_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap ma, mb;
  const cuuint64_t ad[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t bd[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t stride[1] = {(cuuint64_t)K};
  const cuuint32_t abox[2] = {W_BK, W_BM};
  const cuuint32_t bbox[2] = {W_BK, (cuuint32_t)bn};
  int err;
  if ((err = encode_map(&ma, x8, 2, ad, stride, abox,
                        CU_TENSOR_MAP_DATA_TYPE_UINT8)))
    return err;
  if ((err = encode_map(&mb, qt, 2, bd, stride, bbox,
                        CU_TENSOR_MAP_DATA_TYPE_UINT8)))
    return err;
  if (bn == 256)
    return out_bf16 ? launch_wgmma_t<256, 4, bf16>(ma, mb, sx, s, out, M, N,
                                                   K, sms, st)
                    : launch_wgmma_t<256, 4, float>(ma, mb, sx, s, out, M, N,
                                                    K, sms, st);
  return out_bf16 ? launch_wgmma_t<128, 6, bf16>(ma, mb, sx, s, out, M, N, K,
                                                 sms, st)
                  : launch_wgmma_t<128, 6, float>(ma, mb, sx, s, out, M, N,
                                                  K, sms, st);
}

// Shared memory of a "cluster" block at `rows` rows a pass, a K slice of
// `kslice`, a cluster of S and x_bytes bytes a value of x (the plan's
// check of its own choice).
int aries_int8_cluster_smem(int rows, int kslice, int S, int x_bytes) {
  return cluster_smem(rows, kslice, S, x_bytes);
}

// The "cluster" path, the row quantization inside: x (M, K) bf16 (x_bf16 =
// 1) or f32, q (K, N) int8, s (N,) f32 -> out (M, N) bf16 (out_bf16 = 1) or
// f32. All contiguous and 16-byte aligned; N % 16 == 0; S (1..8) divides K
// into slices of whole 32-row stages; rows a pass a multiple of 8, at most
// 64, with the block's shared memory within the opt-in limit. Returns 0, a
// cudaError_t or ERR_BAD_ARGS.
int aries_int8_gemm_cluster(const void* x, int x_bf16, const int8_t* q,
                            const float* s, void* out, int out_bf16, int M,
                            int N, int K, int S, int rows, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || S < 1 || S > C_MAX_CLUSTER ||
      K % (S * C_KC) || rows < 8 || rows > C_MAX_ROWS || rows % 8 ||
      cluster_smem(rows, K / S, S, x_bf16 ? 2 : 4) > C_MAX_SMEM ||
      (N + C_COLS - 1) / C_COLS > 65535)
    return ERR_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return out_bf16 ? launch_cluster<bf16, bf16>(x, q, s, out, M, N, K, S,
                                                 rows, st)
                    : launch_cluster<bf16, float>(x, q, s, out, M, N, K, S,
                                                  rows, st);
  return out_bf16 ? launch_cluster<float, bf16>(x, q, s, out, M, N, K, S,
                                                rows, st)
                  : launch_cluster<float, float>(x, q, s, out, M, N, K, S,
                                                 rows, st);
}

}  // extern "C"
