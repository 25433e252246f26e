// Log-mel power spectrum kernel.
//
// Replaces: whisper_aries_tpu/ops/pallas_mel.py, log_mel_pallas (the Pallas
// TPU kernel that computes the Hann-windowed DFT of each 400-sample frame as
// products with a cos/-sin table, then power, the mel product and log10,
// per 200-frame block).
//
// What it computes, per window b and frame f < n_frames:
//   X[k] = sum_n hann[n] xp[b, 160 f + n] e^{-2 pi i k n / 400}   k < 201
//   out[b, m, f] = log10(max(sum_k |X[k]|^2 melw[k, m], 1e-10))
// xp is the audio (B, N) reflected by 200 samples at both ends (Whisper's
// center padding, read here by reflected indices: no padded copy); melw
// the Slaney filterbank. Whisper drops the final STFT frame, so
// n_frames = N / 160 = 3000 for a 30 s window. The max - 8 floor and
// (x + 4) / 4 stay in torch, as they sit outside pallas_call in JAX.
//
// Bound on the H100: bytes. Audio in and features out, 15.4 + 12.3 MB at
// B 8 and 128 mels: 0.0083 ms at 3.35 TB/s. The least work, a 400-point
// real FFT a frame (~8.6k operations), power and the filterbank's 394
// nonzeros (128 mels; 391 at 80), is 0.25 GFLOP at B 8: 0.0038 ms of f32.
// The first design of this kernel did the DFT as a product with a dense
// mel product (2 x 400 x 402 + 2 x 201 x n_mels a frame, ~28x the least
// work, slower than cuFFT); the products stay f32 here as there: TF32 or
// bf16 fail the feature tolerance in near-silent bins.
//
// Design: one block of 256 threads per (window, tile of FT = 8 frames).
// The tile's samples (FT - 1 hops + one frame) are staged in shared memory
// once: 16-byte words where the span lies inside the audio, reflected
// indices at its two ends. Each frame is transformed as a 200-point
// complex FFT of its packed even and odd windowed samples,
// z[n] = w x[2n] + i w x[2n+1], in three passes of small DFTs held in
// registers, each thread one DFT of one frame (200 = 8 x 5 x 5,
// Cooley-Tukey, n = 25 n1 + 5 m1 + m2):
//   1. over n1 (radix 8), times W_200^(n2 k1), into slot k1 * 25 + n2;
//   2. over m1 (radix 5) in place, times W_25^(m2 j1);
//   3. over m2 (radix 5) in place: slot k1 * 25 + 5 j1 + j2 holds
//      Z[k1 + 8 j1 + 40 j2].
// Then the real-input split gives bins k and 200 - k from Z[k] and
// Z[200 - k] (their slots from a table): X[k] = E + W_400^k O,
// X[200 - k] = conj(E - W_400^k O), with E = (Z[k] + conj Z[200 - k]) / 2,
// O = -i (Z[k] - conj Z[200 - k]) / 2; the powers reuse the samples'
// buffer. Twiddles are a table of W_400^j built on the host in f64 and
// rounded to f32 (W_200, W_25, W_8, W_5 are its entries), as is the Hann
// window; no sine or cosine is evaluated on the card. The mel product
// runs over each band's own bins only (first bin, count, weights: a host
// table from the same filterbank; at most 9 bins at 128 mels, 14 at 80),
// ascending, then log10; the outputs go out as (B, n_mels, n_frames).
// Development variants on the H100 (not kept) were slower with tiles of
// 16 to 32 frames (fewer blocks in flight) and with a thread per band over
// several frames.
#include "common.cuh"

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int PAD = N_FFT / 2;
constexpr int NZ = N_FFT / 2;        // complex points
constexpr int NBIN = N_FFT / 2 + 1;  // 201
constexpr int FT = 8;                // frames per block
constexpr int THREADS = 256;
constexpr int SPAN = (FT - 1) * HOP + N_FFT;
// the staged samples, then (once the first pass has read them) the powers;
// SPAN a multiple of 4 (16-byte staging)
constexpr int XS = SPAN > FT * NBIN ? SPAN : FT * NBIN;
static_assert(XS % 4 == 0 && SPAN % 4 == 0, "16-byte rows");

// shared memory: samples or powers | twiddles W_400^j | Hann pairs | the
// frames' complex points
constexpr int SMEM_BYTES = XS * 4 + N_FFT * 8 + NZ * 8 + FT * NZ * 8;
static_assert(SMEM_BYTES <= 48 * 1024, "no opt-in to more shared memory");

__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 operator-(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 scale(float s, float2 a) {
  return make_float2(s * a.x, s * a.y);
}
// -i a and i a
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}
__device__ __forceinline__ float2 mul_i(float2 a) {
  return make_float2(-a.y, a.x);
}

// in place: y[k] = sum_n y[n] W_4^(kn)
__device__ __forceinline__ void dft4(float2& b0, float2& b1, float2& b2,
                                     float2& b3) {
  const float2 t0 = b0 + b2, t1 = b0 - b2, t2 = b1 + b3,
               t3 = mul_mi(b1 - b3);
  b0 = t0 + t2;
  b2 = t0 - t2;
  b1 = t1 + t3;
  b3 = t1 - t3;
}

// in place: y[k] = sum_n y[n] W_8^(kn); c = cos(pi / 4) from the table
__device__ __forceinline__ void dft8(float2 (&y)[8], float c) {
  float2 e0 = y[0], e1 = y[2], e2 = y[4], e3 = y[6];
  float2 o0 = y[1], o1 = y[3], o2 = y[5], o3 = y[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  const float2 t1 = make_float2(c * (o1.x + o1.y), c * (o1.y - o1.x));
  const float2 t2 = mul_mi(o2);
  const float2 t3 = make_float2(c * (o3.y - o3.x), -c * (o3.x + o3.y));
  y[0] = e0 + o0;
  y[4] = e0 - o0;
  y[1] = e1 + t1;
  y[5] = e1 - t1;
  y[2] = e2 + t2;
  y[6] = e2 - t2;
  y[3] = e3 + t3;
  y[7] = e3 - t3;
}

// in place: y[j] = sum_m y[m] W_5^(jm); w1 = W_5, w2 = W_5^2 from the table
__device__ __forceinline__ void dft5(float2 (&y)[5], float2 w1, float2 w2) {
  const float c1 = w1.x, s1 = -w1.y, c2 = w2.x, s2 = -w2.y;
  const float2 a1 = y[1] + y[4], b1 = y[1] - y[4];
  const float2 a2 = y[2] + y[3], b2 = y[2] - y[3];
  const float2 r1 = y[0] + scale(c1, a1) + scale(c2, a2);
  const float2 r2 = y[0] + scale(c2, a1) + scale(c1, a2);
  const float2 i1 = scale(s1, b1) + scale(s2, b2);
  const float2 i2 = scale(s2, b1) - scale(s1, b2);
  y[0] = y[0] + a1 + a2;
  y[1] = r1 + mul_mi(i1);
  y[4] = r1 + mul_i(i1);
  y[2] = r2 + mul_mi(i2);
  y[3] = r2 + mul_i(i2);
}

// slot of Z[k] after the three passes
__device__ __forceinline__ int zslot(int k) {
  const int k2 = k >> 3;
  return (k & 7) * 25 + 5 * (k2 % 5) + k2 / 5;
}

// grid (ceil(n_frames / FT), B). tw: W_400^j (j < 400) as (cos, -sin);
// hann2: the window's (even, odd) pairs; band: (first bin, bins, offset
// into wt) per mel.
__global__ void __launch_bounds__(THREADS)
mel_kernel(const float* __restrict__ x, int n_samples,
           const float2* __restrict__ tw, const float2* __restrict__ hann2,
           const int* __restrict__ band, const float* __restrict__ wt,
           float* __restrict__ out, int n_frames, int n_mels) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                                      // SPAN
  float* pw = sm;                                      // FT x NBIN
  float2* tws = reinterpret_cast<float2*>(sm + XS);    // N_FFT
  float2* hs = tws + N_FFT;                            // NZ
  float2* zb = hs + NZ;                                // FT x NZ
  const int b = blockIdx.y, tid = threadIdx.x;
  const int f0 = blockIdx.x * FT;
  const float* xb = x + (size_t)b * n_samples;

  __shared__ int slot2[NZ / 2 + 1];  // slots of Z[k], Z[200 - k], k <= 100
  for (int i = tid; i < N_FFT; i += THREADS) tws[i] = tw[i];
  for (int i = tid; i < NZ; i += THREADS) hs[i] = hann2[i];
  for (int k = tid; k <= NZ / 2; k += THREADS)
    slot2[k] = zslot(k) | zslot((NZ - k) % NZ) << 16;
  // padded sample s is audio sample s - PAD, reflected at both ends; a
  // span inside the audio is copied as 16-byte words
  const float* xs0 = xb + f0 * HOP - PAD;
  if (f0 * HOP >= PAD && f0 * HOP - PAD + SPAN <= n_samples &&
      (reinterpret_cast<uintptr_t>(xs0) & 15) == 0) {
    for (int i = tid; i < SPAN / 4; i += THREADS)
      reinterpret_cast<float4*>(xs)[i] =
          __ldg(reinterpret_cast<const float4*>(xs0) + i);
  } else {
    for (int i = tid; i < SPAN; i += THREADS) {
      const int s = f0 * HOP + i;
      int j = s - PAD;
      j = j < 0 ? -j : j;
      j = j >= n_samples ? 2 * (n_samples - 1) - j : j;
      xs[i] = s < n_samples + 2 * PAD && j >= 0 ? xb[j] : 0.f;
    }
  }
  __syncthreads();
  const float c8 = tws[50].x;                   // cos(pi / 4)
  const float2 w5a = tws[80], w5b = tws[160];   // W_5, W_5^2

  // 1. radix 8 over n1, task (frame, n2)
  for (int t = tid; t < FT * 25; t += THREADS) {
    const int f = t / 25, n2 = t - f * 25;
    const float* fx = xs + f * HOP;
    float2 y[8];
#pragma unroll
    for (int n1 = 0; n1 < 8; ++n1) {
      const int n = 25 * n1 + n2;
      const float2 v = *reinterpret_cast<const float2*>(fx + 2 * n);
      const float2 w = hs[n];
      y[n1] = make_float2(v.x * w.x, v.y * w.y);
    }
    dft8(y, c8);
    float2* zf = zb + f * NZ;
    zf[n2] = y[0];
#pragma unroll
    for (int k1 = 1; k1 < 8; ++k1)
      zf[k1 * 25 + n2] = cmul(y[k1], tws[2 * n2 * k1]);  // n2 k1 < 200
  }
  __syncthreads();

  // 2. radix 5 over m1 in place, task (frame, k1, m2)
  for (int t = tid; t < FT * 40; t += THREADS) {
    const int f = t / 40, r = t - f * 40, k1 = r / 5, m2 = r - k1 * 5;
    float2* zs = zb + f * NZ + k1 * 25 + m2;
    float2 y[5];
#pragma unroll
    for (int m1 = 0; m1 < 5; ++m1) y[m1] = zs[5 * m1];
    dft5(y, w5a, w5b);
    zs[0] = y[0];
#pragma unroll
    for (int j1 = 1; j1 < 5; ++j1)
      zs[5 * j1] = cmul(y[j1], tws[16 * m2 * j1]);  // m2 j1 < 25
  }
  __syncthreads();

  // 3. radix 5 over m2 in place, task (frame, k1, j1)
  for (int t = tid; t < FT * 40; t += THREADS) {
    const int f = t / 40, r = t - f * 40;
    float2* zs = zb + f * NZ + r * 5;  // k1 * 25 + 5 j1
    float2 y[5];
#pragma unroll
    for (int m2 = 0; m2 < 5; ++m2) y[m2] = zs[m2];
    dft5(y, w5a, w5b);
#pragma unroll
    for (int j2 = 0; j2 < 5; ++j2) zs[j2] = y[j2];
  }
  __syncthreads();

  // the real-input split and power, task (frame, k <= 100): bins k and
  // 200 - k
  for (int t = tid; t < FT * 101; t += THREADS) {
    const int f = t / 101, k = t - f * 101;
    const float2* zf = zb + f * NZ;
    const int sl = slot2[k];
    const float2 A = zf[sl & 0xffff], B = zf[sl >> 16];
    const float2 e = make_float2(0.5f * (A.x + B.x), 0.5f * (A.y - B.y));
    const float2 o = make_float2(0.5f * (A.y + B.y), -0.5f * (A.x - B.x));
    const float2 wo = cmul(tws[k], o);
    const float2 lo = e + wo, hi = e - wo;
    pw[f * NBIN + k] = lo.x * lo.x + lo.y * lo.y;
    pw[f * NBIN + NZ - k] = hi.x * hi.x + hi.y * hi.y;
  }
  __syncthreads();

  // the mel product over each band's bins, log10; task (mel, frame), so
  // FT neighbouring threads write one band's FT consecutive frames
  for (int t = tid; t < FT * n_mels; t += THREADS) {
    const int m = t / FT, f = t - m * FT;
    if (f0 + f >= n_frames) continue;
    const int k0 = __ldg(band + 3 * m), nb = __ldg(band + 3 * m + 1);
    const float* w = wt + __ldg(band + 3 * m + 2);
    const float* p = pw + f * NBIN + k0;
    float acc = 0.f;
    for (int i = 0; i < nb; ++i) acc = fmaf(p[i], __ldg(w + i), acc);
    out[((size_t)b * n_mels + m) * n_frames + f0 + f] =
        log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

extern "C" int aries_mel(const float* x, int batch, int n_samples,
                         const void* tw, const void* hann2, const int* band,
                         const float* wt, float* out, int n_frames,
                         int n_mels, void* stream) {
  if (batch <= 0 || batch > 65535 || n_samples <= PAD || n_frames <= 0 ||
      (n_frames - 1) * HOP + N_FFT > n_samples + 2 * PAD || n_mels <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n_frames + FT - 1) / FT, batch);
  mel_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, n_samples, static_cast<const float2*>(tw),
      static_cast<const float2*>(hann2), band, wt, out, n_frames, n_mels);
  return launch_status();
}
