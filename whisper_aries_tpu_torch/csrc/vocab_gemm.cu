// The vocab product of a decode step (ops/vocab.py): logits (M, V) f32 =
// x (M, K) bf16 . E (V, K)^T bf16, E the tied token embedding as the model
// holds it (row-major, K contiguous), products exact in f32 and summed in
// f32 on the tensor cores.
//
// Replaces: whisper_aries_tpu/models/whisper.py:510 (decoder_forward's
// `jnp.dot(x, emb.T, preferred_element_type=f32)`, and the same product in
// decoder_step, :1249, and the verify step), an XLA dot that XLA fuses with
// the embedding's read; no Pallas kernel. The port's plain version
// (x.float() @ E.float().T) wrote an f32 copy of E at every step and read
// it back in an f32 GEMM.
//
// Bound: bytes. At a decode step's M (6 to 64 rows) the product does
// 2 M FLOP for each 2-byte element of E: far below the ~295 FLOP a byte at
// which bf16 products become the limit, so the design is about keeping
// E's 132.8 MB (large-v3: 51,866 x 1,280) streaming at the card's rate:
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
//     8 stages at 8 rows). More rows (the prefills: rows x prompt) run
//     more passes in the same launch, the passes over one range of E
//     adjacent in the grid, so they stream it together and all but one
//     read it from L2.
//   * Each warp writes its 16 x 8 NB sums straight from the accumulators:
//     a store instruction writes 8 consecutive ids (32 bytes) of each of
//     four rows, and a block's units are contiguous, so the L2 holds whole
//     sectors of a block's logits before they go to memory; the logits are
//     1-10% of E's bytes at decode rows.
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

}  // namespace

extern "C" {

// The plan of a product (M, V, K) on `sms` SMs: out[0] blocks a pass,
// out[1] rows a pass, out[2] passes, out[3] ring stages, out[4] a block's
// dynamic shared memory. Returns 0 or ERR_BAD_ARGS.
int aries_vocab_gemm_plan(int M, int V, int K, int sms, int* out) {
  if (M <= 0 || V <= 0 || K <= 0 || K % VG_KC || sms <= 0)
    return ERR_BAD_ARGS;
  const int rows = rows_a_pass(K);
  if (rows == 0) return ERR_BAD_ARGS;
  const int units = (V + VG_UNIT - 1) / VG_UNIT;
  const int first = M < rows ? M : rows;
  const int rows8 = 8 * nb_of(first);
  out[0] = units < sms ? units : sms;
  out[1] = rows;
  out[2] = (M + rows - 1) / rows;
  out[3] = vg_stages(rows8, K);
  out[4] = vg_smem(rows8, K, out[3]);
  return 0;
}

// x (M, K) bf16 and e (V, K) bf16, contiguous and 16-byte aligned, K % 64
// == 0; out (M, V) f32. One launch: min(sms, ceil(V / 16)) blocks for
// each pass of up to 64 rows. Returns 0, a cudaError_t, or hopper.cuh's
// codes.
int aries_vocab_gemm(const void* x, const void* e, void* out, int M, int V,
                     int K, int sms, void* stream) {
  int plan[5];
  if (aries_vocab_gemm_plan(M, V, K, sms, plan)) return ERR_BAD_ARGS;
  CUtensorMap me;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)V};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {VG_KC, VG_UNIT};
  int err = encode_map(&me, e, 2, dims, strides, box);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = static_cast<const bf16*>(x);
  float* o = static_cast<float*>(out);
  switch (nb_of(M < plan[1] ? M : plan[1])) {
    case 1: return launch<1>(me, xb, o, M, V, K, plan[0], plan[1], plan[2], st);
    case 2: return launch<2>(me, xb, o, M, V, K, plan[0], plan[1], plan[2], st);
    case 4: return launch<4>(me, xb, o, M, V, K, plan[0], plan[1], plan[2], st);
    default:
      return launch<8>(me, xb, o, M, V, K, plan[0], plan[1], plan[2], st);
  }
}

}  // extern "C"
