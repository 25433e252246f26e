// Batched against per-window transposes, the Hopper counterpart of the
// TPU probe of a batched minor-dims transpose.
//
// Replaces: scripts/probe_batched_transpose.py, make (both variants).
// Python: whisper_aries_tpu_torch/scripts/probe_batched_transpose.py
// (transpose_sum_kernel).
//
// What it computes. x (Bw * KP, D) bf16 is Bw windows of (KP, D). For each
// repetition i < reps, h_w = bf16(x_w + i), and out (D, KP) f32, zeroed
// first, gains
//   "batched" (variant 1): f32(bf16(sum over w of h_w^T))  (the window sum
//                          in f32, rounded to bf16 once)
//   "perwin"  (variant 0): h_w^T for each window, added in f32.
// The TPU probe never zeroes its accumulator; this one does.
//
// Bound on the H100: operations (a bf16 add and an f32 add an element a
// window a repetition: 70.8 M of each at 64 repetitions, against 2.2 MB
// read once and 0.12 MB written).
//
// Design. The window sum of 16 windows is one tensor-core product: with
// A (16 elements x 16 windows) = h and B (16 windows x 8) = ones (zeros for
// windows past Bw), mma.sync m16n8k16 gives every column of D the f32 sum
// over the windows of each element, exactly (each product is a bf16 value
// times 1). So an element-window costs half a packed bf16 add (add.rn.
// bf16x2: i < 256 is exact in bf16, and bf16(x + i) rounded once is what
// the plain version's f32 add rounded to bf16 gives, f32 having more than
// 2 x 8 + 2 bits) and a sixteenth of a product, not a conversion and an
// f32 add.
//   A block owns 16 columns of D: it reads its (Bw * KP, 16) slab of x once,
// with 16-byte loads, into shared memory as KP tiles of (windows, 16
// columns), windows padded with zeros to a multiple of 16; one barrier.
// Warp (g, k) of its KP x G warps takes row k of the windows and the
// repetitions i = g, g + G, ...: ldmatrix.trans gives it the A fragments
// of x (windows on the product's K axis) once, held in registers; each
// repetition adds i to them (packed) and runs one product a 16 windows
// (m16n8k8 for a last 8 or fewer).
// "batched" starts each repetition's sum at zero and adds its bf16
// rounding to an f32 sum; "perwin" lets the products accumulate, one chain
// a 16 windows. No barrier inside the repetition loop; the G groups' sums
// meet in shared memory at the end and are added in group order (the
// output does not vary from run to run), one coalesced store a block.
#include "common.cuh"

namespace {

constexpr int DB = 16;   // columns of D a block: the product's 16 rows
constexpr int G = 2;     // repetition groups a block
constexpr int BW = 36;   // windows (the TPU probe's)
constexpr int KS = (BW + 15) / 16;        // products of 16 windows
constexpr int K8 = BW <= 16 * KS - 8;     // the last of them m16n8k8

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// c += a . b, m16n8k8: a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..), b0
// (k 2t..2t+1, col g), c as for mma_bf16 (m16n8k16)
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// four 8 x 8 bf16 matrices of shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a =
      static_cast<uint32_t>(__cvta_generic_to_shared(const_cast<void*>(p)));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <int BATCHED>
__global__ void __launch_bounds__(1024)
    transpose_kernel(const bf16* __restrict__ x, int KP, int D, int reps,
                     float* __restrict__ out) {
  constexpr int WP = 16 * KS;  // windows of a tile, padded
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // tiles [k][w][DB] bf16, then the groups' sums [G][DB][KP] f32
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);
  float* red = reinterpret_cast<float*>(tile + (size_t)KP * WP * DB);
  const int d0 = blockIdx.x * DB, t = threadIdx.x;

  // the slab, once: two 16-byte vectors a row of (Bw * KP) rows
  for (int v = t; v < KP * WP * 2; v += blockDim.x) {
    const int half = v & 1, row = v >> 1;  // row = k * WP + w
    const int k = row / WP, w = row % WP;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (w < BW)
      val = __ldg(reinterpret_cast<const uint4*>(
          x + (size_t)(w * KP + k) * D + d0 + half * 8));
    *reinterpret_cast<uint4*>(tile + (size_t)row * DB + half * 8) = val;
  }
  __syncthreads();

  const int lane = t & 31, warp = t >> 5;
  const int k = warp % KP, grp = warp / KP;
  const int g = lane >> 2, tq = lane & 3;
  // A fragments of x: rows = the 16 columns of D, K = windows
  uint32_t xa[KS][4];
  // B fragments: 1 for a window below Bw, else 0 (b0: windows 2tq, 2tq+1;
  // b1: 2tq + 8, 2tq + 9 of each 16)
  uint32_t b0[KS], b1[KS];
  const uint32_t one = 0x3F80u;  // bf16 1.0
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int w = s * 16 + ((lane >> 4) << 3) + (lane & 7);
    const int col = ((lane >> 3) & 1) << 3;
    ldmatrix_x4_trans(xa[s], tile + ((size_t)k * WP + w) * DB + col);
    const int w0 = s * 16 + 2 * tq;
    b0[s] = (w0 < BW ? one : 0u) | ((w0 + 1 < BW ? one : 0u) << 16);
    b1[s] = (w0 + 8 < BW ? one : 0u) | ((w0 + 9 < BW ? one : 0u) << 16);
  }

  // sums of elements g and g + 8 (rows of the product)
  float acc_lo = 0.f, acc_hi = 0.f;
  float c[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) c[s][0] = c[s][1] = c[s][2] = c[s][3] = 0.f;
  // the products of one repetition into acc (K8: the last one m16n8k8, on
  // the first 8 windows of its 16)
  auto window_sums = [&](float (&acc)[KS][4], uint32_t ip, bool one_acc) {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      float (&cs)[4] = acc[one_acc ? 0 : s];
      if (K8 && s == KS - 1) {
        mma_bf16_k8(cs, add_bf16x2(xa[s][0], ip), add_bf16x2(xa[s][1], ip),
                    b0[s]);
      } else {
        uint32_t h[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) h[q] = add_bf16x2(xa[s][q], ip);
        mma_bf16(cs, h, b0[s], b1[s]);
      }
    }
  };
  float fi = (float)grp;  // i, exact in f32 and (below 256) in bf16
#pragma unroll 2
  for (int i = grp; i < reps; i += G, fi += (float)G) {
    // bf16 of i in both halves: the high half of f32 i, twice
    const uint32_t ip = __byte_perm(__float_as_uint(fi), 0, 0x3232);
    if (BATCHED) {
      float d[KS][4];
      d[0][0] = d[0][1] = d[0][2] = d[0][3] = 0.f;
      window_sums(d, ip, true);
      // the window sums of both rows rounded to bf16 at once
      uint32_t r;
      asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n"
          : "=r"(r)
          : "f"(d[0][2]), "f"(d[0][0]));
      acc_lo += __uint_as_float(r << 16);
      acc_hi += __uint_as_float(r & 0xFFFF0000u);
    } else {
      window_sums(c, ip, false);
    }
  }
  if (!BATCHED) {
#pragma unroll
    for (int s = 0; s < KS; ++s) acc_lo += c[s][0], acc_hi += c[s][2];
  }
  if (tq == 0) {
    red[((size_t)grp * DB + g) * KP + k] = acc_lo;
    red[((size_t)grp * DB + g + 8) * KP + k] = acc_hi;
  }
  __syncthreads();
  for (int e = t; e < DB * KP; e += blockDim.x) {
    float v = red[e];
#pragma unroll
    for (int q = 1; q < G; ++q) v += red[(size_t)q * DB * KP + e];
    out[(size_t)d0 * KP + e] = v;
  }
}

template <int BATCHED>
int launch(const bf16* x, int KP, int D, int reps, float* out,
           cudaStream_t st) {
  const size_t smem = (size_t)KP * 16 * KS * DB * sizeof(bf16) +
                      (size_t)G * DB * KP * sizeof(float);
  transpose_kernel<BATCHED>
      <<<D / DB, 32 * KP * G, smem, st>>>(x, KP, D, reps, out);
  return launch_status();
}

}  // namespace

extern "C" {

// x (Bw * KP, D) bf16 contiguous, 16-byte aligned; out (D, KP) f32.
// Bw == 36 (the window tiling is built for it), KP <= 16 (a block of KP x
// 2 warps), D % 16 == 0, 0 < reps <= 256 (i + x is one bf16 add while i is
// exact in bf16). variant 1: batched, 0: perwin.
int aries_probe_transpose(const void* x, int Bw, int KP, int D, int reps,
                          int variant, float* out, void* stream) {
  if (Bw != BW || KP <= 0 || KP > 16 || D <= 0 || D % DB ||
      reps <= 0 || reps > 256 || (variant != 0 && variant != 1) ||
      (reinterpret_cast<uintptr_t>(x) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = static_cast<const bf16*>(x);
  return variant ? launch<1>(xb, KP, D, reps, out, st)
                 : launch<0>(xb, KP, D, reps, out, st);
}

}  // extern "C"
