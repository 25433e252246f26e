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
// "splitk" (small M: a decode step's 6 rows, the prefills, alignment_forward;
// every M below the plan's cut-over). Bound on the H100: bytes (the int8
// weights, read once; 22.9 MB a decoder layer, 0.0070 ms). At M 6 a call
// moves 1.6-6.6 MB, so its launch, its first loads' latency and its
// reduction weigh as much as its bytes. One launch a product:
//   * grid (S, ceil(N / 64)): block (ks, ct) owns output columns
//     [64 ct, 64 ct + 64) and the K slice [ks K/S, (ks + 1) K/S); the S
//     slices of a column tile are one thread-block cluster (S <= 8).
//   * The weight stream: each block walks its slice in 32-row stages
//     (2 KB of int8, one 16-byte cp.async a thread, whole 32-byte sectors)
//     through a ring of 16 stages, so up to 32 KB of weights are in flight
//     a block from its first instruction; one block barrier a stage.
//   * x: the block's rows of its K slice are staged once a pass (one
//     cp.async group with the first weight stage), up to 64 rows; larger M
//     loops over 64-row passes, the weights streamed again (from L2).
//   * The products: mma.sync m16n8k16 with the weights as A (16 output
//     columns a warp) and x's rows as the n8 operand, so a group of 8 rows
//     costs one mma and no mma runs on a group whose rows are all past M.
//     One ldmatrix.trans a stage gives a thread its weight bytes (k rows
//     2t, 2t + 1 at columns 2g, 2g + 1, for 32 rows); each is dequantized
//     in registers, w = bf16(f32(q) * s[n]) (exact int8 -> f32, __fmul_rn,
//     round to nearest even), and packed into the A fragment: no
//     block-wide dequant pass. A fragment row g is column 2g, row g + 8
//     column 2g + 1.
//   * The reduction: each block writes its f32 partial of every output
//     pair into the shared memory of the block that owns the pair (pair p
//     of the tile: rank p % S), never reading another block's memory; after
//     one cluster barrier each owner adds the S partials in rank order and
//     stores the pair cast to bf16 or f32. No scratch in device memory, no
//     second launch.
// splitk_plan picks S (the least divisor s <= 8 of K / 32 giving
// ceil(N / 64) s >= 2 x SMs blocks, else the largest) and the row tile;
// ops/quant.py::gemm_plan mirrors it.
#include "attn_split.cuh"
#include "hopper.cuh"

namespace {

// byte b (0..3) of a 32-bit word as a signed int8 value
__device__ __forceinline__ float i8_byte(int word, int b) {
  return (float)((int)((unsigned)word << (24 - 8 * b)) >> 24);
}

// ---------------------------------------------------------------------------
// "splitk" path
// ---------------------------------------------------------------------------

constexpr int S_COLS = 64;          // output columns a block, 16 a warp
constexpr int S_THREADS = 128;
constexpr int S_KC = 32;            // K rows a ring stage
constexpr int S_NST = 16;           // ring stages (32 KB of weights)
constexpr int S_WLD = 80;           // bytes a staged weight row (64 + pad)
constexpr int S_RING = S_NST * S_KC * S_WLD;
constexpr int S_MAX_CLUSTER = 8;
constexpr int S_TARGET_WAVES = 2;   // blocks an SM the plan aims at
constexpr int S_MAX_ROWS = 64;      // rows a pass
constexpr int S_MAX_SMEM = 232448;  // the opt-in limit of a block

// bytes of one staged x row of a K slice (16 of pad: the ldmatrix rows of
// a group of 8 hit distinct banks)
__host__ __device__ inline int splitk_x_pitch(int kslice) {
  return kslice * 2 + 16;
}

inline int splitk_smem(int rows, int kslice, int S) {
  return S_RING + rows * splitk_x_pitch(kslice) +
         (S > 1 ? (rows * S_COLS + 16) * 4 : 0);
}

// The cluster size S and the rows a pass for x (M, K) . (K, N) on `sms`
// SMs: S as in the note at the top; rows = M rounded up to 8, at most 64,
// less while the block's shared memory would pass the opt-in limit.
// Returns 0, or ERR_BAD_ARGS when not even 8 rows fit (K / S > ~10,000).
int splitk_plan(int M, int N, int K, int sms, int* S_out, int* rows_out) {
  if (M <= 0 || N <= 0 || K <= 0 || K % S_KC || N % 16) return ERR_BAD_ARGS;
  const int cols = (N + S_COLS - 1) / S_COLS, units = K / S_KC;
  int S = 1;
  for (int s = 1; s <= S_MAX_CLUSTER; ++s) {
    if (units % s) continue;
    S = s;
    if (cols * s >= S_TARGET_WAVES * sms) break;
  }
  int rows = (M + 7) / 8 * 8;
  if (rows > S_MAX_ROWS) rows = S_MAX_ROWS;
  while (rows > 8 && splitk_smem(rows, K / S, S) > S_MAX_SMEM) rows -= 8;
  if (splitk_smem(rows, K / S, S) > S_MAX_SMEM) return ERR_BAD_ARGS;
  *S_out = S;
  *rows_out = rows;
  return 0;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// barrier.cluster.arrive with its default release semantics: this block's
// reads of its shared memory come before the other blocks' next writes
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

// the A fragments (16 columns x k16, two k16 steps) of one stage's word
// pair w[2h], w[2h + 1] (k rows 2t, 2t+1 and 2t+8, 2t+9 of step h):
// w = bf16(f32(q) * s), column 2g scaled by s0, 2g + 1 by s1
__device__ __forceinline__ void dequant_a(uint32_t (&a)[4], uint32_t lo,
                                          uint32_t hi, float s0, float s1) {
  float f[4], e[4];
  splitkv::i8x4_to_f32((int)lo, f);  // (2t, 2g) (2t, 2g+1) (2t+1, 2g) ...
  splitkv::i8x4_to_f32((int)hi, e);
  a[0] = pack_bf2(__fmul_rn(f[0], s0), __fmul_rn(f[2], s0));
  a[1] = pack_bf2(__fmul_rn(f[1], s1), __fmul_rn(f[3], s1));
  a[2] = pack_bf2(__fmul_rn(e[0], s0), __fmul_rn(e[2], s0));
  a[3] = pack_bf2(__fmul_rn(e[1], s1), __fmul_rn(e[3], s1));
}

// G: n8 row groups a pass (rows / 8); OUT_BF16: out (M, N) bf16, else f32
template <int G, bool OUT_BF16>
__global__ void __launch_bounds__(S_THREADS)
splitk_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ s, void* __restrict__ out, int M,
              int N, int K) {
  extern __shared__ __align__(128) uint8_t sm[];
  constexpr int RT = G * 8;
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int S = gridDim.x, ks = blockIdx.x;
  const int n0 = blockIdx.y * S_COLS;
  const int kslice = K / S, kbase = ks * kslice, nch = kslice / S_KC;
  const int xp = splitk_x_pitch(kslice);
  uint8_t* xs = sm + S_RING;
  float* red = reinterpret_cast<float*>(xs + RT * xp);
  const int per = (RT * 32 + S - 1) / S;  // pairs a block owns
  if (S > 1) splitkv::cluster_arrive_relaxed();

  // this thread's output columns n0 + 16 warp + 2g, + 1; N % 16 == 0, so a
  // warp's 16 columns are all inside N or all past it
  const int col = n0 + 16 * warp + 2 * g;
  const bool live = n0 + 16 * warp < N;
  float s0 = 0.f, s1 = 0.f;
  if (live) {
    const float2 sv = __ldg(reinterpret_cast<const float2*>(s + col));
    s0 = sv.x;
    s1 = sv.y;
  }

  auto load_w = [&](int c) {  // stage c: 32 rows x 64 columns, 16 B a thread
    const int r = tid >> 2, ch = tid & 3;
    const int gn = n0 + 16 * ch;
    const bool ok = gn < N;
    splitkv::cp16(sm + (c % S_NST) * S_KC * S_WLD + r * S_WLD + 16 * ch,
                  q + (size_t)(kbase + c * S_KC + r) * N + (ok ? gn : 0),
                  ok ? 16 : 0);
  };
  auto load_x = [&](int r0) {  // rows r0 .. r0 + RT of the slice; past M: 0
    const int chunks = kslice / 8;
    for (int i = tid; i < RT * chunks; i += S_THREADS) {
      const int r = i / chunks, ch = i - r * chunks;
      const int row = r0 + r;
      const bool ok = row < M;
      splitkv::cp16(xs + r * xp + 16 * ch,
                    x + (size_t)(ok ? row : 0) * K + kbase + 8 * ch,
                    ok ? 16 : 0);
    }
  };

  for (int r0 = 0; r0 < M; r0 += RT) {
    if (r0 > 0) __syncthreads();  // the last pass is done with xs, ring
    const int ng = min(G, (M - r0 + 7) / 8);  // groups holding a row < M
    load_x(r0);
    for (int c = 0; c < S_NST - 1; ++c) {
      if (c < nch) load_w(c);
      splitkv::cp_commit();  // x rides in the first group
    }
    float acc[G][4];
#pragma unroll
    for (int i = 0; i < G; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

    for (int c = 0; c < nch; ++c) {
      splitkv::cp_wait<S_NST - 2>();
      __syncthreads();  // stage c (and x) landed; stage c - 1 is free
      if (c + S_NST - 1 < nch) load_w(c + S_NST - 1);
      splitkv::cp_commit();
      uint32_t w[4], a0[4], a1[4];
      ldsm_x4_t(w, sm + (c % S_NST) * S_KC * S_WLD + lane * S_WLD +
                       16 * warp);
      dequant_a(a0, w[0], w[1], s0, s1);
      dequant_a(a1, w[2], w[3], s0, s1);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (i < ng) {
          uint32_t b[4];  // x rows 8i + g: k 2t.. of steps 0 and 1
          ldsm_x4(b, xs + (8 * i + (lane & 7)) * xp +
                         2 * (c * S_KC + 8 * (lane >> 3)));
          mma_bf16(acc[i], a0, b[0], b[1]);
          mma_bf16(acc[i], a1, b[2], b[3]);
        }
      }
    }
    splitkv::cp_wait<0>();

    // acc[i]: (column col, row 8i + 2t), (col, 8i + 2t + 1),
    //         (col + 1, 8i + 2t), (col + 1, 8i + 2t + 1)
    if (S == 1) {
#pragma unroll
      for (int i = 0; i < G; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * i + 2 * t + h;
          if (i >= ng || row >= M || !live) continue;
          const float v0 = acc[i][h], v1 = acc[i][2 + h];
          if (OUT_BF16)
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                               (size_t)row * N + col) =
                __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(out) +
                                       (size_t)row * N + col) =
                make_float2(v0, v1);
        }
      continue;
    }
    // pair p = (tile row) x 32 + (column - n0) / 2 goes to rank p % S, slot
    // ks x per + p / S of that rank's red
    splitkv::cluster_wait();  // every block running / done reading red
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (i >= ng) continue;
        const int p = (8 * i + 2 * t + h) * 32 + 8 * warp + g;
        float* dst = red + 2 * (ks * per + p / S);
        *reinterpret_cast<float2*>(cl.map_shared_rank(dst, p % S)) =
            make_float2(acc[i][h], acc[i][2 + h]);
      }
    cluster_arrive();
    splitkv::cluster_wait();  // every partial of this block's pairs landed
    for (int lp = tid; lp < per; lp += S_THREADS) {
      const int p = lp * S + ks;
      const int row = r0 + p / 32, cn = n0 + 2 * (p % 32);
      if (p >= RT * 32 || row >= M || cn >= N) continue;
      float v0 = 0.f, v1 = 0.f;
      for (int r = 0; r < S; ++r) {  // rank order
        const float2 v = *reinterpret_cast<const float2*>(
            red + 2 * (r * per + lp));
        v0 += v.x;
        v1 += v.y;
      }
      if (OUT_BF16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                           (size_t)row * N + cn) =
            __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) +
                                   (size_t)row * N + cn) = make_float2(v0, v1);
    }
    if (r0 + RT < M) cluster_arrive();  // red read: the next pass may write
  }
}

template <int G, bool OUT_BF16>
int launch_splitk_g(const bf16* x, const int8_t* q, const float* s, void* out,
                    int M, int N, int K, int S, cudaStream_t st) {
  auto kern = splitk_kernel<G, OUT_BF16>;
  static std::once_flag once[MAX_CARDS];
  static int status[MAX_CARDS];
  const int e = once_per_card(once, status, [kern] {
    const cudaError_t r = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S_MAX_SMEM);
    return r == cudaSuccess ? 0 : ERR_ATTRIBUTE + (int)r;
  });
  if (e) return e;
  const dim3 grid(S, (N + S_COLS - 1) / S_COLS);
  return splitkv::launch(kern, grid, S_THREADS, splitk_smem(G * 8, K / S, S),
                         S, 0, st, x, q, s, out, M, N, K);
}

template <bool OUT_BF16>
int launch_splitk(const bf16* x, const int8_t* q, const float* s, void* out,
                  int M, int N, int K, int sms, cudaStream_t st) {
  int S, rows;
  const int err = splitk_plan(M, N, K, sms, &S, &rows);
  if (err) return err;
  switch (rows / 8) {
    case 1: return launch_splitk_g<1, OUT_BF16>(x, q, s, out, M, N, K, S, st);
    case 2: return launch_splitk_g<2, OUT_BF16>(x, q, s, out, M, N, K, S, st);
    case 3: return launch_splitk_g<3, OUT_BF16>(x, q, s, out, M, N, K, S, st);
    case 4: return launch_splitk_g<4, OUT_BF16>(x, q, s, out, M, N, K, S, st);
    case 5: return launch_splitk_g<5, OUT_BF16>(x, q, s, out, M, N, K, S, st);
    case 6: return launch_splitk_g<6, OUT_BF16>(x, q, s, out, M, N, K, S, st);
    case 7: return launch_splitk_g<7, OUT_BF16>(x, q, s, out, M, N, K, S, st);
    default:
      return launch_splitk_g<8, OUT_BF16>(x, q, s, out, M, N, K, S, st);
  }
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
  static std::once_flag once[MAX_CARDS];
  static int status[MAX_CARDS];
  const int e = once_per_card(once, status, [] {
    return (int)cudaFuncSetAttribute(
        gemm_kernel<OUT_BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G_SMEM);
  });
  if (e) return e;
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

// The "splitk" path's plan for (M, N, K) on `sms` SMs: out[0] the cluster
// size S (K slices), out[1] the rows a pass. Returns 0 or ERR_BAD_ARGS.
int aries_quant_matmul_plan(int M, int N, int K, int sms, int* out) {
  return splitk_plan(M, N, K, sms, &out[0], &out[1]);
}

// x (M, K) bf16, q (K, N) int8, s (N,) f32, all contiguous and 16-byte
// aligned; N % 16 == 0. out (M, N) bf16 (out_bf16 = 1) or f32.
// path 1 ("wgmma"): K % 64 == 0, scratch: K x N bf16.
// path 0 ("splitk"): K % 32 == 0, one launch, its plan from `sms`.
// Returns 0, a cudaError_t, or hopper.cuh's codes.
int aries_quant_matmul(const void* x, const int8_t* q, const float* s,
                       void* out, int out_bf16, int M, int N, int K, int path,
                       int sms, void* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = static_cast<const bf16*>(x);
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || sms <= 0 ||
      (N + S_COLS - 1) / S_COLS > 65535 || (M + GM - 1) / GM > 65535)
    return (int)cudaErrorInvalidValue;
  if (path == 1) {
    if (K % GK || scratch == nullptr) return (int)cudaErrorInvalidValue;
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
  if (path != 0 || K % S_KC) return (int)cudaErrorInvalidValue;
  return out_bf16 ? launch_splitk<true>(xb, q, s, out, M, N, K, sms, st)
                  : launch_splitk<false>(xb, q, s, out, M, N, K, sms, st);
}

}  // extern "C"
