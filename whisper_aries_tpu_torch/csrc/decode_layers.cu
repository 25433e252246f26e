// Decoder-layer kernels for one greedy decode step (all L layers).
//
// Replaces: whisper_aries_tpu/ops/pallas_decode_layers.py,
// fused_decoder_layers (the Pallas TPU megakernel whose body, _make_kernel,
// runs every decoder layer of one decode step; its golden model is
// fused_decoder_layers_reference).
//
// What one step computes, per layer l, on R rows (window-major: G rows,
// the beams, per window; G = 1 for greedy):
//   h   = LN1(x)                                   f32 stats, eps 1e-5
//   qkv = bf16((bf16(h) . W8_qkv) * s + b)           f32 accumulate
//   append k, v at `pos` to the self cache (int8 cache: quantize per
//     (row, head) with absmax over dh / 127, round half to even, clip 127)
//   att = softmax_t(bf16(q / 8) . k_t [* ks_t]) over t in [vs, pos]
//         [* vs_t], probabilities rounded to bf16, then . v_t
//   x   = x + bf16(att . W8_o * s + b)
//   h   = LN_cross(x);  cq = bf16(h . W8_cq * s + b)
//   atx = softmax_t(cq . k8_t * ks_t) * vs_t . v8_t over the row's
//         window's int8 cross K/V (ks folds 1/sqrt(dh)); the G = R / Bw
//         rows of a window (its beams) share that window's K/V
//   x   = x + bf16(atx . W8_co * s + b)
//   h   = LN2(x);  h1 = bf16(gelu_AS(h . W8_fc1 * s + b))
//   x   = x + bf16(h1 . W8_fc2 * s + b)
// with the Abramowitz-Stegun erf fit of the TPU kernel (an exact-erf delta
// flips int8 cache values at rounding boundaries). Scale and bias are
// applied to the f32 accumulator with separate multiply and add, as the
// plain version does.
//
// Bound on the H100: bytes. At large-v3 (d 1280, ff 5120, L 32) a step
// streams 0.73 GB of int8 weights, ~1 GB of int8 cross K/V plus scales for
// 8 windows (whatever the beams per window) and the self cache up to
// `pos`; the products are ~1.5 GFLOP at R = 8.
//
// Design: the layer loop runs in C (aries_decode_layers), so one call from
// Python launches the whole step on the caller's stream:
//   * LayerNorm: one block per row, two-pass f32 statistics.
//   * W8A16 GEMM: a weight stream, so every int8 weight byte is read once
//     per step, whatever the number of rows. Each block owns 32 output
//     columns and one K slice (64-256 rows); it loads its int8 weight
//     fragment into registers with all loads in flight, converts it to
//     bf16 (exact) and multiplies every row of x against it on the tensor
//     cores (mma.sync m16n8k16, f32 accumulate; up to 64 rows in one pass).
//     K is split over blocks (deterministic: partial sums go to scratch and
//     a second small kernel adds them in a fixed order, then applies scale,
//     bias and the epilogue), so even the narrow d-wide outputs run ~800
//     blocks with their loads in flight together.
//   * Self-attention: one block per (row, head). It appends the new K/V
//     (quantizing when the cache is int8), then attends over the valid
//     prefix: warps own positions, lanes own pairs of dims, logits and
//     probabilities live in shared memory.
//   * Cross-attention: the grouped kernel of cross_attn.cuh, one block per
//     (head, window) over the 1500 int8 keys, each key and value row read
//     once for all the window's rows.
// The self and cross caches are dh-minor: (L, R, 2, H, T, 64) with scales
// (L, R, 2, H, T). Fusing the launches (CUDA graphs, one persistent kernel)
// and wgmma/TMA come in later changes.
#include "common.cuh"
#include "cross_attn.cuh"

namespace {

constexpr int DH = 64;

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ float erf_as(float x) {
  // Abramowitz & Stegun 7.1.26, operation for operation as the plain
  // version (IEEE division, no contraction into fused multiply-adds)
  const float a = fabsf(x);
  const float t = 1.f / __fadd_rn(1.f, __fmul_rn(0.3275911f, a));
  float p = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  p = __fadd_rn(1.421413741f, __fmul_rn(t, p));
  p = __fadd_rn(-0.284496736f, __fmul_rn(t, p));
  p = __fadd_rn(0.254829592f, __fmul_rn(t, p));
  p = __fmul_rn(t, p);
  const float y = __fsub_rn(1.f, __fmul_rn(p, expf(__fmul_rn(-a, a))));
  return x > 0.f ? y : (x < 0.f ? -y : 0.f);
}

__device__ __forceinline__ float gelu_as(float y) {
  const float e = erf_as(y / 1.41421356237f);
  return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.f, e));
}

// ------------------------------------------------------------ (a) LayerNorm

constexpr int LN_THREADS = 256;

__global__ void __launch_bounds__(LN_THREADS)
layer_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ s,
                  const float* __restrict__ b, bf16* __restrict__ y, int d) {
  __shared__ float red[32];
  const bf16* xr = x + (size_t)blockIdx.x * d;
  bf16* yr = y + (size_t)blockIdx.x * d;
  float acc = 0.f;
  for (int i = threadIdx.x; i < d; i += LN_THREADS) acc += bf2f(xr[i]);
  const float mu = block_sum(acc, red) / (float)d;
  float sq = 0.f;
  for (int i = threadIdx.x; i < d; i += LN_THREADS) {
    const float dx = bf2f(xr[i]) - mu;
    sq = fmaf(dx, dx, sq);
  }
  const float var = block_sum(sq, red) / (float)d;
  const float rstd = 1.f / sqrtf(var + 1e-5f);
  for (int i = threadIdx.x; i < d; i += LN_THREADS) {
    const float n = __fmul_rn(__fsub_rn(bf2f(xr[i]), mu), rstd);
    yr[i] = f2bf(__fadd_rn(__fmul_rn(n, s[i]), b[i]));
  }
}

// --------------------------------------------------------- (b) W8A16 GEMM

constexpr int G_COLS = 32;   // output columns per block: 4 n8 tiles
constexpr int G_WARPS = 4;   // the block's K slice is split over its warps
constexpr int G_KSTEP = 16 * G_WARPS;  // K rows per block trip (k16/warp)
constexpr int G_TRIPS = 4;   // most trips per block (K slice <= 256 rows)
constexpr int G_MT = 4;      // most m16 row tiles per pass (64 rows)

__device__ __forceinline__ uint32_t pack_i8(int8_t lo, int8_t hi) {
  // int8 values are exact in bf16
  return pack_bf2((float)lo, (float)hi);
}

// part[ks, r, n] = sum_{k in slice ks} bf16(x[r, k]) * w[k, n], on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate).
// The block owns 32 columns and one K slice; in each trip warp w takes the
// k16 chunk w. A thread loads, for each of its k rows (2t, 2t+1, 2t+8,
// 2t+9 of the chunk), the 4 consecutive bytes at columns 4g..4g+3: byte j
// of them is the B fragment of n8 tile j at fragment column g, so tile j
// covers physical columns 4c + j (c = 0..7), and the 8 lanes of one k row
// read one 32-byte sector. All the block's weight loads are issued before
// any product, and every row of x (MT m16 tiles per pass, all rows in one
// pass when R <= 64) is multiplied against that fragment: each weight byte
// is read once per call.
template <int MT>
__global__ void __launch_bounds__(32 * G_WARPS)
gemm_w8_kernel(const bf16* __restrict__ x, int ldx,
               const int8_t* __restrict__ w, int ldw, int N, int R,
               int kslice, float* __restrict__ part) {
  __shared__ float red[G_WARPS][MT * 16][G_COLS + 1];  // +1: no bank clash
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * G_COLS;
  const int ks = blockIdx.y;
  const int trips = kslice / G_KSTEP;
  const int kw = ks * kslice + warp * 16 + 2 * t;  // this thread's k, trip 0

  const int8_t* wc = w + n0 + 4 * g;
  char4 wr[G_TRIPS][4];
#pragma unroll
  for (int j = 0; j < G_TRIPS; ++j) {
    if (j < trips) {
      const int k = kw + j * G_KSTEP;
      wr[j][0] = *reinterpret_cast<const char4*>(wc + (size_t)k * ldw);
      wr[j][1] = *reinterpret_cast<const char4*>(wc + (size_t)(k + 1) * ldw);
      wr[j][2] = *reinterpret_cast<const char4*>(wc + (size_t)(k + 8) * ldw);
      wr[j][3] = *reinterpret_cast<const char4*>(wc + (size_t)(k + 9) * ldw);
    }
  }

  for (int r0 = 0; r0 < R; r0 += MT * 16) {
    float acc[MT][4][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
#pragma unroll
    for (int j = 0; j < G_TRIPS; ++j) {
      if (j < trips) {
        const int k = kw + j * G_KSTEP;
        const uint32_t b0[4] = {pack_i8(wr[j][0].x, wr[j][1].x),
                                pack_i8(wr[j][0].y, wr[j][1].y),
                                pack_i8(wr[j][0].z, wr[j][1].z),
                                pack_i8(wr[j][0].w, wr[j][1].w)};
        const uint32_t b1[4] = {pack_i8(wr[j][2].x, wr[j][3].x),
                                pack_i8(wr[j][2].y, wr[j][3].y),
                                pack_i8(wr[j][2].z, wr[j][3].z),
                                pack_i8(wr[j][2].w, wr[j][3].w)};
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int ra = r0 + m * 16 + g, rb = ra + 8;
          const uint32_t* xa = reinterpret_cast<const uint32_t*>(
              x + (size_t)ra * ldx + k);
          const uint32_t* xb = reinterpret_cast<const uint32_t*>(
              x + (size_t)rb * ldx + k);
          const uint32_t a[4] = {ra < R ? xa[0] : 0u, rb < R ? xb[0] : 0u,
                                 ra < R ? xa[4] : 0u, rb < R ? xb[4] : 0u};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[m][nt], a, b0[nt], b1[nt]);
        }
      }
    }
    // fragment (row g [+8], fragment column 2t [+1]) of tile nt is
    // physical column 4 * (2t [+1]) + nt
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[warp][m * 16 + g + (i >= 2 ? 8 : 0)][4 * (2 * t + (i & 1)) + nt] =
              acc[m][nt][i];
    __syncthreads();
    const int nr = min(MT * 16, R - r0);
    for (int idx = threadIdx.x; idx < nr * G_COLS; idx += 32 * G_WARPS) {
      const int r = idx / G_COLS, c = idx - r * G_COLS;
      float v = 0.f;
#pragma unroll
      for (int wi = 0; wi < G_WARPS; ++wi) v += red[wi][r][c];
      part[((size_t)ks * R + r0 + r) * N + n0 + c] = v;
    }
    __syncthreads();  // red is rewritten by the next pass
  }
}

enum { EPI_STORE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

// y = (sum_ks part) * s + b, then: store bf16(y) | bf16(gelu_AS(y)) |
// out = bf16(out + bf16(y)) (the residual add; out holds x)
__global__ void gemm_epilogue_kernel(const float* __restrict__ part, int nks,
                                     int R, int N,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ bias, int mode,
                                     bf16* out, int ldo) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= R * N) return;
  const int r = idx / N, n = idx - r * N;
  float acc = 0.f;
  for (int s = 0; s < nks; ++s) acc += part[((size_t)s * R + r) * N + n];
  const float y = __fadd_rn(__fmul_rn(acc, scale[n]), bias[n]);
  bf16* o = out + (size_t)r * ldo + n;
  if (mode == EPI_GELU) {
    *o = f2bf(gelu_as(y));
  } else if (mode == EPI_RESIDUAL) {
    *o = f2bf(__fadd_rn(bf2f(*o), round_bf(y)));
  } else {
    *o = f2bf(y);
  }
}

// K splits for a (K, N) weight (K a multiple of G_KSTEP): ~10 blocks per
// SM (132 SMs) so enough weight loads are in flight to approach the memory
// rate; each slice a whole number of trips, at most G_TRIPS (the register
// fragment)
int gemm_splits(int K, int N) {
  const int col_blocks = N / G_COLS > 0 ? N / G_COLS : 1;
  const int units = K / G_KSTEP;  // slices must divide K into whole trips
  const int lo = (units + G_TRIPS - 1) / G_TRIPS;
  int ks = (1320 + col_blocks - 1) / col_blocks;
  if (ks > units) ks = units;
  if (ks < lo) ks = lo;
  for (int c = ks; c >= lo; --c)
    if (c > 0 && units % c == 0) return c;
  for (int c = ks + 1; c <= units; ++c)
    if (units % c == 0) return c;
  return units;
}

int run_gemm(const bf16* x, int ldx, int K, const int8_t* w, int ldw, int N,
             int R, const float* scale, const float* bias, int mode,
             bf16* out, int ldo, float* part, cudaStream_t st) {
  const int nks = gemm_splits(K, N);
  const dim3 grid(N / G_COLS, nks), block(32 * G_WARPS);
  const int tiles = (R + 15) / 16;
  if (tiles <= 1)
    gemm_w8_kernel<1><<<grid, block, 0, st>>>(x, ldx, w, ldw, N, R, K / nks, part);
  else if (tiles == 2)
    gemm_w8_kernel<2><<<grid, block, 0, st>>>(x, ldx, w, ldw, N, R, K / nks, part);
  else if (tiles == 3)
    gemm_w8_kernel<3><<<grid, block, 0, st>>>(x, ldx, w, ldw, N, R, K / nks, part);
  else
    gemm_w8_kernel<G_MT><<<grid, block, 0, st>>>(x, ldx, w, ldw, N, R, K / nks,
                                                 part);
  int err = launch_status();
  if (err) return err;
  const int total = R * N;
  gemm_epilogue_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      part, nks, R, N, scale, bias, mode, out, ldo);
  return launch_status();
}

// --------------------------------------- (c) self-attention with append

constexpr int SA_THREADS = 128;
constexpr int SA_WARPS = SA_THREADS / 32;

template <bool INT8>
__global__ void __launch_bounds__(SA_THREADS)
self_attn_kernel(const bf16* __restrict__ qkv, int d, void* cache,
                 float* __restrict__ csc, int H, int Tmax, int pos, int vs,
                 bf16* __restrict__ att) {
  extern __shared__ float lg[];  // Tmax floats
  __shared__ float qs[DH];
  __shared__ float red[32];
  __shared__ float pv[SA_WARPS][DH];
  const int r = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* row = qkv + (size_t)r * 3 * d;
  // cache rows (of DH values) for this (row, head): k at kb + t, v at vb + t
  const size_t kb = (((size_t)r * 2 + 0) * H + h) * Tmax;
  const size_t vb = (((size_t)r * 2 + 1) * H + h) * Tmax;
  int8_t* c8 = static_cast<int8_t*>(cache);
  bf16* c16 = static_cast<bf16*>(cache);

  // 1) append this step's k (warp 0) and v (warp 1); q (warp 2)
  if (warp < 2) {
    const bf16* src = row + (warp + 1) * d + h * DH + 2 * lane;
    const size_t dst = (warp == 0 ? kb : vb) + pos;
    if (INT8) {
      const float f0 = bf2f(src[0]), f1 = bf2f(src[1]);
      const float am = warp_max(fmaxf(fabsf(f0), fabsf(f1)));
      const float sc = am > 0.f ? am / 127.f : 1.f;
      const int q0 = max(-127, min(127, __float2int_rn(f0 / sc)));
      const int q1 = max(-127, min(127, __float2int_rn(f1 / sc)));
      c8[dst * DH + 2 * lane] = (int8_t)q0;
      c8[dst * DH + 2 * lane + 1] = (int8_t)q1;
      if (lane == 0) csc[dst] = sc;
    } else {
      c16[dst * DH + 2 * lane] = src[0];
      c16[dst * DH + 2 * lane + 1] = src[1];
    }
  } else if (warp == 2) {
    const bf16* src = row + h * DH + 2 * lane;
    qs[2 * lane] = round_bf(__fmul_rn(bf2f(src[0]), 0.125f));
    qs[2 * lane + 1] = round_bf(__fmul_rn(bf2f(src[1]), 0.125f));
  }
  __syncthreads();

  // 2) logits over the valid prefix [vs, pos]
  for (int t = vs + warp; t <= pos; t += SA_WARPS) {
    float k0, k1;
    if (INT8) {
      k0 = (float)c8[(kb + t) * DH + 2 * lane];
      k1 = (float)c8[(kb + t) * DH + 2 * lane + 1];
    } else {
      k0 = bf2f(c16[(kb + t) * DH + 2 * lane]);
      k1 = bf2f(c16[(kb + t) * DH + 2 * lane + 1]);
    }
    float part = fmaf(qs[2 * lane + 1], k1, qs[2 * lane] * k0);
    part = warp_sum(part);
    if (lane == 0) lg[t] = INT8 ? part * csc[kb + t] : part;
  }
  __syncthreads();

  // 3) softmax (f32), v scale folded into the probabilities, bf16 rounding
  float mx = -INFINITY;
  for (int t = vs + tid; t <= pos; t += SA_THREADS) mx = fmaxf(mx, lg[t]);
  mx = block_max(mx, red);
  float sum = 0.f;
  for (int t = vs + tid; t <= pos; t += SA_THREADS) {
    const float e = expf(lg[t] - mx);
    lg[t] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  for (int t = vs + tid; t <= pos; t += SA_THREADS) {
    float p = lg[t] / sum;
    if (INT8) p = p * csc[vb + t];
    lg[t] = round_bf(p);
  }
  __syncthreads();

  // 4) P . V
  float a0 = 0.f, a1 = 0.f;
  for (int t = vs + warp; t <= pos; t += SA_WARPS) {
    const float p = lg[t];
    float v0, v1;
    if (INT8) {
      v0 = (float)c8[(vb + t) * DH + 2 * lane];
      v1 = (float)c8[(vb + t) * DH + 2 * lane + 1];
    } else {
      v0 = bf2f(c16[(vb + t) * DH + 2 * lane]);
      v1 = bf2f(c16[(vb + t) * DH + 2 * lane + 1]);
    }
    a0 = fmaf(p, v0, a0);
    a1 = fmaf(p, v1, a1);
  }
  pv[warp][2 * lane] = a0;
  pv[warp][2 * lane + 1] = a1;
  __syncthreads();
  if (tid < DH) {
    float o = 0.f;
#pragma unroll
    for (int wi = 0; wi < SA_WARPS; ++wi) o += pv[wi][tid];
    att[(size_t)r * d + h * DH + tid] = f2bf(o);
  }
}

int run_self_attn(const bf16* qkv, int R, int d, int H, void* cache,
                  float* csc, int self_int8, int Tmax, int pos, int vs,
                  bf16* att, cudaStream_t st) {
  dim3 grid(R, H);
  const size_t smem = (size_t)Tmax * sizeof(float);
  if (self_int8)
    self_attn_kernel<true><<<grid, SA_THREADS, smem, st>>>(
        qkv, d, cache, csc, H, Tmax, pos, vs, att);
  else
    self_attn_kernel<false><<<grid, SA_THREADS, smem, st>>>(
        qkv, d, cache, csc, H, Tmax, pos, vs, att);
  return launch_status();
}

// ------------------------------------------- (d) int8 cross-attention

// The grouped int8 cross-attention of cross_attn.cuh with a bf16 output:
// cq (R, d) with R = Bw * G rows, window-major (the G beams of a window
// contiguous), over the Bw windows' K/V (Bw, 2, H, Ta, 64) and scales
// (Bw, 2, H, Ta). Greedy decode is G = 1.
int run_cross_attn(const bf16* cq, int R, int d, int H, const int8_t* kv8,
                   const float* sc, int Ta, int Bw, bf16* att,
                   cudaStream_t st) {
  if (Bw <= 0 || R % Bw) return (int)cudaErrorInvalidValue;
  const int G = R / Bw;
  xattn::Args a;
  a.q = cq;
  a.q_sw = (long long)G * d;
  a.q_sh = DH;
  a.q_sg = d;
  a.k8 = kv8;
  a.v8 = kv8 + (size_t)H * Ta * DH;
  a.kv_sw = 2LL * H * Ta * DH;
  a.kv_sh = (long long)Ta * DH;
  a.ks = sc;
  a.vs = sc + (size_t)H * Ta;
  a.s_sw = 2LL * H * Ta;
  a.s_sh = Ta;
  a.out = att;
  a.o_sw = (long long)G * d;
  a.o_sh = DH;
  a.o_sg = d;
  a.H = H;
  a.G = G;
  a.Ta = Ta;
  return xattn::launch<bf16, bf16>(a, Bw, st);
}

int run_layer_norm(const bf16* x, int R, int d, const float* s,
                   const float* b, bf16* y, cudaStream_t st) {
  layer_norm_kernel<<<R, LN_THREADS, 0, st>>>(x, s, b, y, d);
  return launch_status();
}

// offsets of the packed per-layer vector (pack_layer_weights):
// [ln1.s, ln1.b, qkv.b, o.b, lnc.s, lnc.b, cq.b, co.b, ln2.s, ln2.b,
//  fc1.b, fc2.b, s_qkv, s_o, s_cq, s_co, s_f1, s_f2]
void vec_offsets(int d, int ff, int* offs) {
  const int sizes[18] = {d, d, 3 * d, d, d, d, d, d, d, d, ff, d,
                         3 * d, d, d, d, ff, d};
  offs[0] = 0;
  for (int i = 0; i < 18; ++i) offs[i + 1] = offs[i] + sizes[i];
}

}  // namespace

#define RETURN_IF(err) \
  do {                 \
    int e_ = (err);    \
    if (e_) return e_; \
  } while (0)

extern "C" {

int aries_gemm_splits(int K, int N) { return gemm_splits(K, N); }

int aries_layer_norm(const void* x, int R, int d, const float* s,
                     const float* b, void* y, void* stream) {
  return run_layer_norm(static_cast<const bf16*>(x), R, d, s, b,
                        static_cast<bf16*>(y), (cudaStream_t)stream);
}

int aries_w8a16_gemm(const void* x, int ldx, int R, int K, const int8_t* w,
                     int ldw, int N, const float* scale, const float* bias,
                     int mode, void* out, int ldo, float* part, void* stream) {
  return run_gemm(static_cast<const bf16*>(x), ldx, K, w, ldw, N, R, scale,
                  bias, mode, static_cast<bf16*>(out), ldo, part,
                  (cudaStream_t)stream);
}

int aries_self_attn(const void* qkv, int R, int d, int H, void* cache,
                    float* csc, int self_int8, int Tmax, int pos, int vs,
                    void* att, void* stream) {
  return run_self_attn(static_cast<const bf16*>(qkv), R, d, H, cache, csc,
                       self_int8, Tmax, pos, vs, static_cast<bf16*>(att),
                       (cudaStream_t)stream);
}

// f32 scratch the step needs for the split-K partial sums
long long aries_decode_scratch_floats(int R, int d, int ff) {
  const int shapes[4][2] = {{d, 3 * d}, {d, d}, {d, ff}, {ff, d}};
  long long most = 0;
  for (auto& s : shapes) {
    const long long n = (long long)gemm_splits(s[0], s[1]) * R * s[1];
    if (n > most) most = n;
  }
  return most;
}

// All L decoder layers of one step. x (R, d) bf16 is updated in place; the
// self cache (L, R, 2, H, Tmax, 64) [bf16, or int8 with scales csc
// (L, R, 2, H, Tmax)] gets this step's K/V at `pos`. The cross K/V
// (L, Bw, 2, H, Ta, 64) and scales (L, Bw, 2, H, Ta) hold Bw windows, each
// shared by its R / Bw rows (window-major). h (R, d), qkv (R, 3d),
// att (R, d), h1 (R, ff) bf16 and part (aries_decode_scratch_floats) are
// scratch the caller owns.
int aries_decode_layers(void* x_, int R, int d, int ff, int H, int L,
                        const int8_t* wq8, const int8_t* wf1,
                        const int8_t* wf2, const float* vecs, int vec_len,
                        void* cache, float* csc, int self_int8, int Tmax,
                        const int8_t* xkv, const float* xsc, int Ta, int Bw,
                        int pos,
                        int vs, void* h_, void* qkv_, void* att_, void* h1_,
                        float* part, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  bf16* x = static_cast<bf16*>(x_);
  bf16* h = static_cast<bf16*>(h_);
  bf16* qkv = static_cast<bf16*>(qkv_);
  bf16* att = static_cast<bf16*>(att_);
  bf16* h1 = static_cast<bf16*>(h1_);
  int off[19];
  vec_offsets(d, ff, off);
  const size_t self_stride = (size_t)R * 2 * H * Tmax * DH;
  const size_t self_sc_stride = (size_t)R * 2 * H * Tmax;
  const size_t cross_stride = (size_t)Bw * 2 * H * Ta * DH;
  const size_t cross_sc_stride = (size_t)Bw * 2 * H * Ta;
  const int ldq = 6 * d;
  for (int l = 0; l < L; ++l) {
    const float* v = vecs + (size_t)l * vec_len;
    const int8_t* wq = wq8 + (size_t)l * d * ldq;
    void* cache_l = self_int8
        ? (void*)(static_cast<int8_t*>(cache) + l * self_stride)
        : (void*)(static_cast<bf16*>(cache) + l * self_stride);
    float* csc_l = self_int8 ? csc + l * self_sc_stride : nullptr;
    // self-attention block
    RETURN_IF(run_layer_norm(x, R, d, v + off[0], v + off[1], h, st));
    RETURN_IF(run_gemm(h, d, d, wq, ldq, 3 * d, R, v + off[12], v + off[2],
                       EPI_STORE, qkv, 3 * d, part, st));
    RETURN_IF(run_self_attn(qkv, R, d, H, cache_l, csc_l, self_int8, Tmax,
                            pos, vs, att, st));
    RETURN_IF(run_gemm(att, d, d, wq + 3 * d, ldq, d, R, v + off[13],
                       v + off[3], EPI_RESIDUAL, x, d, part, st));
    // cross-attention block (cq overwrites h once its GEMM has read it)
    RETURN_IF(run_layer_norm(x, R, d, v + off[4], v + off[5], h, st));
    RETURN_IF(run_gemm(h, d, d, wq + 4 * d, ldq, d, R, v + off[14],
                       v + off[6], EPI_STORE, h, d, part, st));
    RETURN_IF(run_cross_attn(h, R, d, H, xkv + l * cross_stride,
                             xsc + l * cross_sc_stride, Ta, Bw, att, st));
    RETURN_IF(run_gemm(att, d, d, wq + 5 * d, ldq, d, R, v + off[15],
                       v + off[7], EPI_RESIDUAL, x, d, part, st));
    // MLP block
    RETURN_IF(run_layer_norm(x, R, d, v + off[8], v + off[9], h, st));
    RETURN_IF(run_gemm(h, d, d, wf1 + (size_t)l * d * ff, ff, ff, R,
                       v + off[16], v + off[10], EPI_GELU, h1, ff, part, st));
    RETURN_IF(run_gemm(h1, ff, ff, wf2 + (size_t)l * ff * d, d, d, R,
                       v + off[17], v + off[11], EPI_RESIDUAL, x, d, part,
                       st));
  }
  return 0;
}

}  // extern "C"
