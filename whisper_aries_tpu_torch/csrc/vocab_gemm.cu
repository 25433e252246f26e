// The vocab product (ops/vocab.py): logits (M, V) f32 = x (M, K) bf16 .
// E (V, K)^T bf16, E the tied token embedding as the model holds it
// (row-major, K contiguous), products exact in f32 and summed in f32 on the
// tensor cores.
//
// Replaces: whisper_aries_tpu/models/whisper.py:510 (decoder_forward's
// `jnp.dot(x, emb.T, preferred_element_type=f32)`, and the same product in
// decoder_step, :1249, alignment_forward, :589, and the verify step), an
// XLA dot that XLA fuses with the embedding's read; no Pallas kernel. The
// port's plain version (x.float() @ E.float().T) writes an f32 copy of E
// and reads it back in an f32 GEMM.
//
// Two paths, picked by M (aries_vocab_gemm_plan; `path` forces one):
//
// "passes" (M <= VG_TILES_ABOVE: a decode step's 6 to 64 rows). Bound:
// bytes. The product does 2 M FLOP for each 2-byte element of E: far below
// the ~295 FLOP a byte at which bf16 products become the limit, so the
// design is about keeping E's 132.8 MB (large-v3: 51,866 x 1,280)
// streaming at the card's rate:
//
//   * A and B swapped: E's vocab rows are the MMAs' M dimension (the
//     K-major A operand of mma.sync m16n8k16) and the decode rows the N
//     dimension in blocks of 8, so R 6 pays for 8 columns, not 16 rows.
//   * A persistent grid, one block an SM, each over a contiguous range of
//     16-row units of E (V / 16 units split evenly: no quarter-full last
//     wave). A block walks its range in stages of up to 8 units (128 rows)
//     by 64 k: a producer warp keeps a ring of such stages in flight by TMA
//     (16-row boxes, 128-byte swizzle, rows past V zero-filled), completing
//     on mbarriers; 8 consumer warps, one 16-row unit each, read their A
//     fragments with ldmatrix and run the products.
//   * x staged in shared memory once a block (16-byte chunks swizzled
//     against bank conflicts), up to 64 rows a pass; the ring takes the
//     rest of the 227 KB (4 stages, 64 KB in flight, at 64 rows of K 1280;
//     8 stages at 8 rows). More rows run more passes in the same launch,
//     the passes over one range of E adjacent in the grid (all but one
//     read it from L2), but every pass walks all of E through the SMs.
//   * Each warp writes its 16 x 8 NB sums straight from the accumulators:
//     a store instruction writes 8 consecutive ids (32 bytes) of each of
//     four rows, and a block's units are contiguous, so the L2 holds whole
//     sectors of a block's logits before they go to memory; the logits are
//     1-10% of E's bytes at decode rows.
//
// "tiles" (M > VG_TILES_ABOVE: the teacher-forced passes, the word pass's
// B x S_pad rows, the larger prefills). Bound: operations above M ~800
// (2 M V K at 989 TFLOP/s: 0.152 ms at M 1135), bytes below (E once, x
// once, the f32 logits once). A persistent TMA + bf16 wgmma GEMM:
//
//   * Output tiles of 128 rows x 256 ids. x (M, K) is the K-major A
//     operand, E (V, K) already the K-major B operand: no transpose, no
//     scratch. Both come by TMA in 64-k stages (128-byte swizzle; rows
//     past M or V zero-filled, so their sums are 0 and never stored) into
//     a ring of 4 stages (192 KB) with full and empty mbarriers, filled by
//     one producer thread (its warpgroup gives its registers back by
//     setmaxnreg). Two consumer warpgroups of 64 rows each run one
//     m64n256k16 a k16 step, one commit group in flight.
//   * The tile order keeps E's bands in L2: tiles are numbered with the M
//     tile fastest and block b takes tiles b, b + grid, ..., so the ~132
//     tiles in flight share ~132 / ceil(M / 128) vocab bands of E (0.66 MB
//     each) and all of x: E comes from memory about once. (A block owning
//     a band and walking its M tiles would keep 132 bands alive, 86 MB,
//     more than the 50 MB L2.)
//   * The epilogue is half the bytes at large M (the f32 logits, 235 MB at
//     M 1135). Their row stride, V x 4 = 207,464 bytes at large-v3, is 8
//     mod 16: TMA cannot store the tensor (strides must be multiples of 16)
//     and 16-byte stores are misaligned on every other row. Each
//     warpgroup stages its 64 rows a 32-id (128-byte) chunk at a time in
//     shared memory and writes whole 128-byte row pieces with 8-byte
//     streaming stores (4-byte where V is odd), which the L2 drains while
//     the consumers run the next tile, the producer already filling its
//     stages.
#include "hopper.cuh"

namespace {

constexpr int VG_UNIT = 16;              // vocab rows a TMA box: one m16 tile
constexpr int VG_UNITS = 8;              // units a stage, a consumer warp each
constexpr int VG_KC = 64;                // k a stage: a 128-byte swizzled row
constexpr int VG_BOX = VG_UNIT * VG_KC * 2;   // 2 KB
constexpr int VG_STAGE = VG_UNITS * VG_BOX;   // 16 KB
constexpr int VG_MAX_STAGES = 8;
constexpr int VG_MIN_STAGES = 2;
constexpr int VG_THREADS = (VG_UNITS + 1) * 32;  // + the producer warp
constexpr int VG_MAX_ROWS = 64;          // decode rows a pass: 8 n8 blocks
constexpr int VG_SMEM_LIMIT = 232448;    // the opt-in limit of a block

// dynamic shared memory of a pass over `rows8` x rows (a multiple of 8)
// with `stages` ring stages: alignment slack, ring, x, barriers
__host__ __device__ inline int vg_smem(int rows8, int K, int stages) {
  return 1024 + stages * VG_STAGE + rows8 * K * 2 + 2 * stages * 8;
}

// the ring's stages at `rows8` rows: as many as fit, at most 8
__host__ __device__ inline int vg_stages(int rows8, int K) {
  const int free = VG_SMEM_LIMIT - vg_smem(rows8, K, 0);
  int s = free / (VG_STAGE + 16);
  return s > VG_MAX_STAGES ? VG_MAX_STAGES : s;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// NB: n8 blocks of decode rows a pass (rows padded to 8 NB with zeros).
// me: E's map, (K, V) box (64, 16). The grid is G ranges x `passes`
// passes, a range's passes adjacent: block (r, p) = r passes + p takes
// rows [p rows, p rows + rows) of x and units [r U / G, (r + 1) U / G) of
// U = ceil(V / 16), so the passes over one range run together and all but
// the first read its E from L2.
template <int NB>
__global__ void __launch_bounds__(VG_THREADS, 1)
vocab_kernel(const __grid_constant__ CUtensorMap me,
             const bf16* __restrict__ x, float* __restrict__ out, int M,
             int V, int K, int stages, int rows, int passes) {
  const int pass = blockIdx.x % passes, range = blockIdx.x / passes;
  const int G = gridDim.x / passes;
  x += (size_t)pass * rows * K;
  out += (size_t)pass * rows * V;
  M = min(rows, M - pass * rows);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ring = smem;
  uint8_t* xs = smem + stages * VG_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + NB * 8 * K * 2);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = (V + VG_UNIT - 1) / VG_UNIT;
  const int u0 = (int)((long long)range * units / G);
  const int u1 = (int)((long long)(range + 1) * units / G);
  const int kch = K / VG_KC;
  const int tiles = (u1 - u0 + VG_UNITS - 1) / VG_UNITS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], VG_UNITS);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  // x into shared memory: 16-byte chunk c of row n at chunk c ^ (n & 7)
  // (K % 64 == 0: the xor stays inside the row); rows >= M zero
  const int cpr = K / 8;
  for (int i = threadIdx.x; i < NB * 8 * cpr; i += VG_THREADS) {
    const int n = i / cpr, c = i - n * cpr;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < M) v = *reinterpret_cast<const uint4*>(x + (size_t)n * K + c * 8);
    *reinterpret_cast<uint4*>(xs + (size_t)n * K * 2 + ((c ^ (n & 7)) << 4)) =
        v;
  }
  __syncthreads();
  const int iters = tiles * kch;

  if (warp == VG_UNITS) {  // producer
    if (lane == 0) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % stages;
        if (it >= stages) mbar_wait(&empty[s], (it / stages - 1) & 1);
        const int t = it / kch, kc = it - t * kch;
        const int ub = u0 + t * VG_UNITS;
        const int nbox = min(VG_UNITS, u1 - ub);
        mbar_arrive_expect_tx(&full[s], nbox * VG_BOX);
        for (int b = 0; b < nbox; ++b)
          tma_load_2d(ring + s * VG_STAGE + b * VG_BOX, &me, &full[s],
                      kc * VG_KC, (ub + b) * VG_UNIT);
      }
    }
    return;
  }

  // consumers: warp w owns unit w of each stage
  const int g = lane >> 2, t4 = lane & 3;
  // ldmatrix rows: A (16 vocab rows x 16 k) as matrices (rows 0-7, k lo),
  // (8-15, lo), (0-7, hi), (8-15, hi); B (8 x rows, 16 k) as (j, lo),
  // (j, hi), (j + 1, lo), (j + 1, hi)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_hi = lane >> 4;
  const int b_row = lane & 7, b_hi = (lane >> 3) & 1, b_next = lane >> 4;
  for (int t = 0; t < tiles; ++t) {
    const int ub = u0 + t * VG_UNITS;
    const bool mine = warp < u1 - ub;
    float acc[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    for (int kc = 0; kc < kch; ++kc) {
      const int it = t * kch + kc, s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      if (mine) {
        const uint8_t* box = ring + s * VG_STAGE + warp * VG_BOX;
#pragma unroll
        for (int kk = 0; kk < VG_KC / 16; ++kk) {
          uint32_t a[4];
          const int ca = 2 * kk + a_hi;
          ldsm_x4(a, box + a_row * 128 + ((ca ^ (a_row & 7)) << 4));
          const int cb = kc * (VG_KC / 8) + 2 * kk + b_hi;  // x's chunk
          if constexpr (NB == 1) {
            uint32_t b[2];
            ldsm_x2(b, xs + (size_t)b_row * K * 2 + ((cb ^ b_row) << 4));
            mma_bf16(acc[0], a, b[0], b[1]);
          } else {
#pragma unroll
            for (int j = 0; j < NB; j += 2) {
              const int n = 8 * (j + b_next) + b_row;
              uint32_t b[4];
              ldsm_x4(b, xs + (size_t)n * K * 2 + ((cb ^ (n & 7)) << 4));
              mma_bf16(acc[j], a, b[0], b[1]);
              mma_bf16(acc[j + 1], a, b[2], b[3]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (mine) {
      const int v = (ub + warp) * VG_UNIT + g;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int n = 8 * j + 2 * t4;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int nn = n + (q & 1), vv = v + 8 * (q >> 1);
          if (nn < M && vv < V) out[(size_t)nn * V + vv] = acc[j][q];
        }
      }
    }
  }
}

template <int NB>
int launch(const CUtensorMap& me, const bf16* x, float* out, int M, int V,
           int K, int blocks, int rows, int passes, cudaStream_t st) {
  static std::once_flag once[MAX_CARDS];
  static int status[MAX_CARDS];
  const int e = once_per_card(once, status, [] {
    const cudaError_t r = cudaFuncSetAttribute(
        vocab_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        VG_SMEM_LIMIT);
    return r == cudaSuccess ? 0 : ERR_ATTRIBUTE + (int)r;
  });
  if (e) return e;
  const int stages = vg_stages(NB * 8, K);
  vocab_kernel<NB><<<blocks * passes, VG_THREADS,
                     vg_smem(NB * 8, K, stages), st>>>(me, x, out, M, V, K,
                                                       stages, rows, passes);
  return launch_status();
}

// rows a pass at K: 64, or fewer where x and the smallest ring do not fit
inline int rows_a_pass(int K) {
  for (int r = VG_MAX_ROWS; r >= 8; r -= 8)
    if (vg_stages(r, K) >= VG_MIN_STAGES) return r;
  return 0;
}

inline int nb_of(int rows) {
  return rows <= 8 ? 1 : rows <= 16 ? 2 : rows <= 32 ? 4 : 8;
}

// ---------------------------------------------------------------------------
// "tiles" path: TMA + bf16 wgmma, warp-specialised, persistent
// ---------------------------------------------------------------------------

constexpr int VG_TILES_ABOVE = 64;     // M above which the plan takes tiles
constexpr int T_BM = 128;              // rows a tile: two warpgroups of 64
constexpr int T_BK = 64;               // k a stage: a 128-byte swizzled row
constexpr int T_THREADS = 384;         // consumers: warpgroups 0, 1;
                                       // producer: warpgroup 2
constexpr int T_A = T_BM * T_BK * 2;   // 16 KB: the x tile
constexpr int T_CW = 32;               // ids a staged chunk (128 bytes)
constexpr int T_PITCH = T_CW * 4 + 16; // bytes a staged row (16 of pad:
                                       // conflict-free fragment writes)
constexpr int T_OUT = 64 * T_PITCH;    // a consumer warpgroup's buffer
constexpr int T_BN = 256;              // ids a tile: one m64n256k16 a k16
constexpr int T_STAGES = 4;            // ring stages: 4 x 48 KB
constexpr int T_STAGE = T_A + T_BN * T_BK * 2;
// the ring, then 1 KB for the barriers, then the two output buffers
constexpr int T_SMEM = 1024 + T_STAGES * T_STAGE + 1024 + 2 * T_OUT;

// mx: x (K, M) box (64, 128); me: E (K, V) box (64, 256); both 128-byte
// swizzled. Block b takes tiles b, b + gridDim.x, ... of tiles_m x
// ceil(V / 256), the M tile fastest; the producer runs on into the next
// tile's stages while the consumers store this one's.
__global__ void __launch_bounds__(T_THREADS, 1)
tiles_kernel(const __grid_constant__ CUtensorMap mx,
             const __grid_constant__ CUtensorMap me, float* __restrict__ out,
             int M, int V, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T_STAGES * T_STAGE);
  uint64_t* empty = full + T_STAGES;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int kch = K / T_BK;
  const int tiles_m = (M + T_BM - 1) / T_BM;
  const int tiles = tiles_m * ((V + T_BN - 1) / T_BN);

  if (threadIdx.x == 0) {
    for (int st = 0; st < T_STAGES; ++st) {
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
        const int m0 = (tile % tiles_m) * T_BM;
        const int n0 = (tile / tiles_m) * T_BN;
        for (int kc = 0; kc < kch; ++kc, ++it) {
          const int st = it % T_STAGES;
          if (it >= T_STAGES) mbar_wait(&empty[st], (it / T_STAGES - 1) & 1);
          uint8_t* a = smem + st * T_STAGE;
          mbar_arrive_expect_tx(&full[st], T_STAGE);
          tma_load_2d(a, &mx, &full[st], kc * T_BK, m0);
          tma_load_2d(a + T_A, &me, &full[st], kc * T_BK, n0);
        }
      }
    }
    return;
  }
  // consumers: rows m0 + 64 wg .. + 63 of each tile
  setmaxnreg_inc<232>();
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool even = (V & 1) == 0;  // 8-byte stores line up on every row
  uint8_t* buf = smem + T_STAGES * T_STAGE + 1024 + wg * T_OUT;
  int it = 0;  // stages consumed
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % tiles_m) * T_BM, n0 = (tile / tiles_m) * T_BN;
    float acc[T_BN / 2];
#pragma unroll
    for (int i = 0; i < T_BN / 2; ++i) acc[i] = 0.f;

    for (int kc = 0; kc < kch; ++kc, ++it) {
      const int st = it % T_STAGES;
      mbar_wait(&full[st], (it / T_STAGES) & 1);
      const uint8_t* a = smem + st * T_STAGE + wg * 64 * 128;
      const uint8_t* b = smem + st * T_STAGE + T_A;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T_BK / 16; ++kk)
        wgmma_m64n256k16_ss(acc, wgmma_desc(a + kk * 32, 16, 1024),
                            wgmma_desc(b + kk * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      fence_regs(acc);
      if (kc > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % T_STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid == 0) mbar_arrive(&empty[(it - 1) % T_STAGES]);

    // acc[4j + 2 half + e]: row 16 warp + g + 8 half of the warpgroup's
    // 64, id n0 + 8j + 2t + e; staged a 32-id chunk (j = 4 cc .. 4 cc + 3)
    // at a time, then written as 128-byte row pieces, 16 threads a row
    const int rw = warp * 16 + g;
    const int m1 = m0 + wg * 64;
#pragma unroll
    for (int cc = 0; cc < T_BN / T_CW; ++cc) {
#pragma unroll
      for (int jj = 0; jj < T_CW / 8; ++jj) {
        const int j = cc * (T_CW / 8) + jj;  // constant: so is acc's index
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(buf + (rw + 8 * half) * T_PITCH +
                                     (jj * 8 + 2 * t) * 4) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
      named_barrier(1 + wg, 128);  // the chunk is in the buffer
#pragma unroll
      for (int pass = 0; pass < 8; ++pass) {
        const int r = pass * 8 + (tid >> 4), piece = tid & 15;
        const int row = m1 + r, col = n0 + cc * T_CW + 2 * piece;
        if (row < M && col < V) {
          const float2 v =
              *reinterpret_cast<const float2*>(buf + r * T_PITCH + 8 * piece);
          float* o = out + (size_t)row * V + col;
          if (even) {  // col even, V even: 8-byte aligned, col + 1 < V
            __stcs(reinterpret_cast<float2*>(o), v);
          } else {
            __stcs(o, v.x);
            if (col + 1 < V) __stcs(o + 1, v.y);
          }
        }
      }
      named_barrier(1 + wg, 128);  // the buffer is free again
    }
  }
}

int launch_tiles(const CUtensorMap& mx, const CUtensorMap& me, float* out,
                 int M, int V, int K, int blocks, cudaStream_t st) {
  static std::once_flag once[MAX_CARDS];
  static int status[MAX_CARDS];
  const int e = once_per_card(once, status, [] {
    const cudaError_t r = cudaFuncSetAttribute(
        tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
    return r == cudaSuccess ? 0 : ERR_ATTRIBUTE + (int)r;
  });
  if (e) return e;
  tiles_kernel<<<blocks, T_THREADS, T_SMEM, st>>>(mx, me, out, M, V, K);
  return launch_status();
}

}  // namespace

extern "C" {

// The plan of a product (M, V, K) on `sms` SMs, by `path` (-1: by M, 0:
// "passes", 1: "tiles"): out[0] the path (0 or 1), out[1] blocks (of a
// pass, or of the persistent grid), out[2] rows a pass or a tile, out[3]
// passes or M tiles, out[4] ring stages, out[5] a block's dynamic shared
// memory, out[6] a tile's ids (0 for passes), out[7] tiles (0 for passes).
// Returns 0 or ERR_BAD_ARGS.
int aries_vocab_gemm_plan(int M, int V, int K, int sms, int path, int* out) {
  if (M <= 0 || V <= 0 || K <= 0 || K % VG_KC || sms <= 0 || path < -1 ||
      path > 1)
    return ERR_BAD_ARGS;
  if (path == -1) path = M > VG_TILES_ABOVE ? 1 : 0;
  out[0] = path;
  if (path == 1) {
    const long long tiles_m = (M + T_BM - 1) / T_BM;
    const long long tiles = tiles_m * ((V + T_BN - 1) / T_BN);
    if (tiles > 0x7fffffffLL) return ERR_BAD_ARGS;
    out[1] = (int)(tiles < sms ? tiles : sms);
    out[2] = T_BM;
    out[3] = (int)tiles_m;
    out[4] = T_STAGES;
    out[5] = T_SMEM;
    out[6] = T_BN;
    out[7] = (int)tiles;
    return 0;
  }
  const int rows = rows_a_pass(K);
  if (rows == 0) return ERR_BAD_ARGS;
  const int units = (V + VG_UNIT - 1) / VG_UNIT;
  const int first = M < rows ? M : rows;
  const int rows8 = 8 * nb_of(first);
  out[1] = units < sms ? units : sms;
  out[2] = rows;
  out[3] = (M + rows - 1) / rows;
  out[4] = vg_stages(rows8, K);
  out[5] = vg_smem(rows8, K, out[4]);
  out[6] = 0;
  out[7] = 0;
  return 0;
}

// x (M, K) bf16 and e (V, K) bf16, contiguous and 16-byte aligned, K % 64
// == 0; out (M, V) f32, contiguous. One launch, by the plan's path
// (`path` as in the plan). Returns 0, a cudaError_t, or hopper.cuh's
// codes.
int aries_vocab_gemm(const void* x, const void* e, void* out, int M, int V,
                     int K, int sms, int path, void* stream) {
  int plan[8];
  if (aries_vocab_gemm_plan(M, V, K, sms, path, plan)) return ERR_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  float* o = static_cast<float*>(out);
  CUtensorMap me;
  int err;
  if (plan[0] == 1) {
    CUtensorMap mx;
    const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t ed[2] = {(cuuint64_t)K, (cuuint64_t)V};
    const cuuint32_t xbox[2] = {T_BK, T_BM};
    const cuuint32_t ebox[2] = {T_BK, T_BN};
    if ((err = encode_map(&mx, x, 2, xd, strides, xbox))) return err;
    if ((err = encode_map(&me, e, 2, ed, strides, ebox))) return err;
    return launch_tiles(mx, me, o, M, V, K, plan[1], st);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)V};
  const cuuint32_t box[2] = {VG_KC, VG_UNIT};
  if ((err = encode_map(&me, e, 2, dims, strides, box))) return err;
  const bf16* xb = static_cast<const bf16*>(x);
  switch (nb_of(M < plan[2] ? M : plan[2])) {
    case 1: return launch<1>(me, xb, o, M, V, K, plan[1], plan[2], plan[3], st);
    case 2: return launch<2>(me, xb, o, M, V, K, plan[1], plan[2], plan[3], st);
    case 4: return launch<4>(me, xb, o, M, V, K, plan[1], plan[2], plan[3], st);
    default:
      return launch<8>(me, xb, o, M, V, K, plan[1], plan[2], plan[3], st);
  }
}

}  // extern "C"
