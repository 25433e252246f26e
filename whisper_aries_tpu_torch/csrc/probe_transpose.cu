// Batched against per-window transposes, the Hopper counterpart of the
// TPU probe of a batched minor-dims transpose.
//
// Replaces: scripts/probe_batched_transpose.py, make (both variants).
// Python: whisper_aries_tpu_torch/scripts/probe_batched_transpose.py
// (transpose_sum_kernel).
//
// What it computes. x (Bw * KP, D) bf16 is Bw windows of (KP, D). For each
// repetition i < reps, h_w = bf16(x_w + i) (an f32 add rounded to bf16, as
// a bf16 add is), and out (D, KP) f32, zeroed first, gains
//   "batched" (variant 1): f32(bf16(sum over w of h_w^T))  (the window sum
//                          in f32, in window order, rounded to bf16 once)
//   "perwin"  (variant 0): h_w^T for each window in turn, added in f32.
// The TPU probe never zeroes its accumulator; this one does.
//
// Bound on the H100: operations (two adds an element a repetition, 0.14
// GFLOP at 64 repetitions, against 2.2 MB read once and 0.12 MB written).
//
// Design. A block owns DT = 32 columns of D and KP x DT threads. Loads are
// coalesced along D (thread (k, d) reads x[w * KP + k][d0 + d]) into a
// shared tile; the sums are taken in the transposed mapping (thread t owns
// out[d0 + t / KP][t % KP], so the final store is one contiguous run of
// DT x KP floats a block), which reads the tile across its rows: the
// transpose goes through shared memory. "batched" stages every window's
// tile with one barrier a repetition; "perwin" stages one window at a
// time, two barriers a window. Tile rows are padded by two elements so the
// transposed reads spread over the banks.
#include "common.cuh"

namespace {

constexpr int DT = 32;       // columns of D a block
constexpr int PITCH = DT + 2;  // bf16 a tile row

template <int BATCHED>
__global__ void transpose_kernel(const bf16* __restrict__ x, int Bw, int KP,
                                 int D, int reps, float* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);  // BATCHED: Bw x KP rows;
                                                   // else KP rows
  const int d0 = blockIdx.x * DT, t = threadIdx.x;
  const int lk = t / DT, ld = t % DT;  // the load mapping
  const int od = t / KP, ok = t % KP;  // the sum (output) mapping
  float acc = 0.f;
  for (int i = 0; i < reps; ++i) {
    const float fi = (float)i;
    if (BATCHED) {
      for (int w = 0; w < Bw; ++w)
        tile[(w * KP + lk) * PITCH + ld] = x[(size_t)(w * KP + lk) * D + d0 + ld];
      __syncthreads();
      float s = 0.f;
      for (int w = 0; w < Bw; ++w)
        s += round_bf(bf2f(tile[(w * KP + ok) * PITCH + od]) + fi);
      acc += round_bf(s);
      __syncthreads();
    } else {
      for (int w = 0; w < Bw; ++w) {
        tile[lk * PITCH + ld] = x[(size_t)(w * KP + lk) * D + d0 + ld];
        __syncthreads();
        acc += round_bf(bf2f(tile[ok * PITCH + od]) + fi);
        __syncthreads();
      }
    }
  }
  out[(size_t)d0 * KP + t] = acc;
}

}  // namespace

extern "C" {

// x (Bw * KP, D) bf16 contiguous, out (D, KP) f32; D % 32 == 0, KP x 32
// threads a block (KP <= 32). variant 1: batched, 0: perwin.
int aries_probe_transpose(const void* x, int Bw, int KP, int D, int reps,
                          int variant, float* out, void* stream) {
  if (Bw <= 0 || KP <= 0 || KP > 32 || D <= 0 || D % DT || reps <= 0 ||
      (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(variant ? Bw : 1) * KP * PITCH * sizeof(bf16);
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* xb = static_cast<const bf16*>(x);
  if (variant) {
    const cudaError_t e = cudaFuncSetAttribute(
        transpose_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    transpose_kernel<1><<<D / DT, KP * DT, smem, st>>>(xb, Bw, KP, D, reps,
                                                       out);
  } else {
    transpose_kernel<0><<<D / DT, KP * DT, smem, st>>>(xb, Bw, KP, D, reps,
                                                       out);
  }
  return launch_status();
}

}  // extern "C"
