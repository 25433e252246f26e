// Log-mel power spectrum kernel.
//
// Replaces: whisper_aries_tpu/ops/pallas_mel.py, log_mel_pallas (the Pallas
// TPU kernel that computes the Hann-windowed DFT of each 400-sample frame as
// products with a cos/-sin table, then power, the mel product and log10,
// per 200-frame block).
//
// What it computes, per window b and frame f (f < n_frames):
//   re[k] = sum_n x[b, f*160 + n] * dft[n, k]          k in [0, 201)
//   im[k] = sum_n x[b, f*160 + n] * dft[n, 201 + k]
//   out[b, f, m] = log10(max(sum_k (re[k]^2 + im[k]^2) * melw[k, m], 1e-10))
// x is the reflect-padded audio (B, 480400); dft the (400, 402) f32
// Hann*cos | Hann*-sin table; melw the (201, n_mels) filterbank. Whisper
// drops the final STFT frame, so n_frames = 3000 for a 30 s window. The
// reflect pad, the max - 8 floor and (x + 4) / 4 stay in torch, as they sit
// outside pallas_call in the JAX package.
//
// Bound on the H100: operations. The function's least work is a 400-point
// real FFT per frame (~2.5 N log2 N), power and the 201 x n_mels mel
// product: ~1.5 GFLOP for 8 windows, 0.022 ms at 67 TFLOP/s of f32, against
// ~28 MB of audio in and features out (0.008 ms). This design does the DFT
// as a product instead, 2 * 400 * 402 operations per frame (~9 GFLOP, a
// 0.13 ms ceiling of its own): simple, exact in f32 and on a par with the
// cuFFT plain version, but ~6x the least work. The products stay f32:
// TF32 or bf16 inputs fail the feature tolerance in near-silent bins.
//
// Design: one block per (window, tile of FT frames). The tile's samples
// (FT-1 hops + one frame) are staged once in shared memory; thread k owns
// frequency bin k and keeps 2 * FT f32 accumulators, so each table load
// (coalesced across bins, served from L2) feeds FT frames. Powers go to
// shared memory, then the block does the mel product and log10 for its
// FT x n_mels outputs. FT = 24 keeps the staging (~16 KB) and the power
// tile (~19 KB) inside the 48 KB static shared-memory limit.
#include "common.cuh"

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int NBIN = N_FFT / 2 + 1;  // 201
constexpr int FT = 24;               // frames per block
constexpr int THREADS = 256;
constexpr int SPAN = (FT - 1) * HOP + N_FFT;

__global__ void __launch_bounds__(THREADS)
mel_kernel(const float* __restrict__ x, int padded_len,
           const float* __restrict__ dft, const float* __restrict__ melw,
           float* __restrict__ out, int n_frames, int n_mels) {
  __shared__ float xs[SPAN];
  __shared__ float pw[FT][NBIN];
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const float* xb = x + (size_t)b * padded_len;
  const int s0 = f0 * HOP;
  for (int i = threadIdx.x; i < SPAN; i += THREADS) {
    const int s = s0 + i;
    xs[i] = s < padded_len ? xb[s] : 0.f;
  }
  __syncthreads();

  const int k = threadIdx.x;
  if (k < NBIN) {
    float re[FT], im[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) { re[f] = 0.f; im[f] = 0.f; }
    for (int n = 0; n < N_FFT; ++n) {
      const float c = __ldg(dft + n * (2 * NBIN) + k);
      const float s = __ldg(dft + n * (2 * NBIN) + NBIN + k);
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        const float xv = xs[f * HOP + n];
        re[f] = fmaf(xv, c, re[f]);
        im[f] = fmaf(xv, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FT; ++f) pw[f][k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < FT * n_mels; idx += THREADS) {
    const int f = idx / n_mels, m = idx - f * n_mels;
    if (f0 + f >= n_frames) break;
    float acc = 0.f;
    for (int kk = 0; kk < NBIN; ++kk)
      acc = fmaf(pw[f][kk], __ldg(melw + kk * n_mels + m), acc);
    out[((size_t)b * n_frames + f0 + f) * n_mels + m] =
        log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

extern "C" int aries_mel(const float* x, int batch, int padded_len,
                         const float* dft, const float* melw, float* out,
                         int n_frames, int n_mels, void* stream) {
  dim3 grid((n_frames + FT - 1) / FT, batch);
  mel_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, padded_len, dft, melw, out, n_frames, n_mels);
  return launch_status();
}
