// Decoder-layer kernels for one decode step (all L layers).
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
// The speculative verify step (replacing also whisper_aries_tpu/models/
// whisper.py, decoder_step_fused_multi, which packs drafts into the TPU
// kernel's beam slots) runs the same layers on R = rows x Q queries: the Q
// drafted tokens of a self-cache row, query q appending at pos + q and
// attending over [vs, pos + q]; the GEMMs, LayerNorms and cross-attention
// (G = Q queries a window) take its rows as any others.
//
// compute_type "f32" (the JAX megakernel at x f32) instantiates the step
// with an f32 residual stream: x (R, d) f32, LayerNorm reading it, the
// residual epilogues adding y into x without a rounding, qkv and cq
// stored f32 (q scaled, K/V quantized or cached from their f32 values),
// self-attention probabilities f32 into P . V, cross-attention on f32
// queries, and an f32 self cache where it is not int8. The products' A
// operands stay bf16 (h, att, the cross output, h1): the megakernel
// rounds every product's input to bf16 too. The verify step runs at f32
// alike, Q queries a cache row (self_verify_kernel<INT8, Q, true>).
//
// Bound on the H100: bytes. At large-v3 (d 1280, ff 5120, L 32) a step
// streams 0.73 GB of int8 weights, ~1 GB of int8 cross K/V plus scales for
// 8 windows (whatever the beams per window) and the self cache up to
// `pos`; the products are ~1.5 GFLOP at R = 8. Each kernel moves a few MB
// at most, so its launch and its first load's latency weigh as much as its
// bytes: the design keeps every kernel one launch, fills the card, and
// overlaps the kernels' starts.
//
// Design: the layer loop runs in C (aries_decode_layers), 11 launches a
// layer on the caller's stream, each a programmatic dependent launch (PDL)
// of the one before, so the next kernel's blocks are resident while the
// previous one drains; the GEMMs prefetch their weights (which no kernel
// writes) before waiting for their input. The whole loop is captured once
// per decode call as a CUDA graph (ops/decode_layers.py, DecodeStepGraph):
// `pos` and `valid_start` are read from device memory, so one graph
// serves every step.
//   * LayerNorm: one warp per row, 16-byte loads, two-pass f32 statistics.
//   * W8A16 GEMM: one launch per product. A block owns 64 output columns
//     and one K slice; the K slices of a column tile are one thread-block
//     cluster (at most 8). The block streams its int8 weight rows and the
//     matching x columns through a 6-stage ring of 16-byte cp.async
//     copies, converts the weights to bf16 (exact) and multiplies on the
//     tensor cores (ldmatrix + mma.sync m16n8k16, f32 sums; 64 rows of x
//     per pass). The cluster's partial sums meet in distributed shared
//     memory, each output summed over the slices in rank order
//     (deterministic, no atomics, no f32 scratch in device memory), and
//     the epilogue (scale, bias, store / GELU / residual add) writes bf16.
//     gemm_plan picks the slices; ops/decode_layers.py mirrors it.
//   * Self- and cross-attention: split-KV clusters (attn_split.cuh).
// The self and cross caches are dh-minor: (L, R, 2, H, T, 64) with scales
// (L, R, 2, H, T).
#include "attn_split.cuh"
#include "common.cuh"

namespace {

constexpr int DH = 64;
using splitkv::cp16;
using splitkv::cp_commit;
using splitkv::cp_wait;
using splitkv::launch;
using splitkv::pdl_trigger;
using splitkv::pdl_wait;
using splitkv::smem_u32addr;

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32addr(p)));
}

// ------------------------------------------------------------ (a) LayerNorm

// one warp per row; d % 8 == 0, rows 16-byte aligned; x bf16 or f32 (XT),
// y bf16 (the products' A operand)
template <typename XT>
__global__ void __launch_bounds__(32)
layer_norm_kernel(const XT* __restrict__ x, const float* __restrict__ s,
                  const float* __restrict__ b, bf16* __restrict__ y, int d) {
  constexpr int E = 16 / sizeof(XT);  // elements a 16-byte load
  using Out = std::conditional_t<E == 8, int4, uint2>;
  pdl_wait();
  pdl_trigger();
  const int lane = threadIdx.x;
  const XT* xr = x + (size_t)blockIdx.x * d;
  bf16* yr = y + (size_t)blockIdx.x * d;
  float acc = 0.f;
  for (int i = E * lane; i < d; i += 32 * E) {
    const int4 raw = *reinterpret_cast<const int4*>(xr + i);
    const XT* v = reinterpret_cast<const XT*>(&raw);
#pragma unroll
    for (int j = 0; j < E; ++j) acc += splitkv::to_f(v[j]);
  }
  const float mu = warp_sum(acc) / (float)d;
  float sq = 0.f;
  for (int i = E * lane; i < d; i += 32 * E) {
    const int4 raw = *reinterpret_cast<const int4*>(xr + i);
    const XT* v = reinterpret_cast<const XT*>(&raw);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float dx = splitkv::to_f(v[j]) - mu;
      sq = fmaf(dx, dx, sq);
    }
  }
  const float var = warp_sum(sq) / (float)d;
  const float rstd = 1.f / sqrtf(var + 1e-5f);
  for (int i = E * lane; i < d; i += 32 * E) {
    const int4 raw = *reinterpret_cast<const int4*>(xr + i);
    const XT* v = reinterpret_cast<const XT*>(&raw);
    Out outw;
    bf16* o = reinterpret_cast<bf16*>(&outw);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float n = __fmul_rn(__fsub_rn(splitkv::to_f(v[j]), mu), rstd);
      o[j] = f2bf(__fadd_rn(__fmul_rn(n, s[i + j]), b[i + j]));
    }
    *reinterpret_cast<Out*>(yr + i) = outw;
  }
}

// --------------------------------------------------------- (b) W8A16 GEMM

constexpr int G_COLS = 64;      // output columns per block (16 per warp)
constexpr int G_THREADS = 128;  // 4 warps
constexpr int G_KC = 64;        // K rows per ring stage
constexpr int G_NST = 6;        // ring stages
constexpr int G_WLD = 80;       // bytes per staged weight row (64 + pad)
constexpr int G_XLD = 72;       // bf16 per staged x row (64 + pad)
constexpr int G_RLD = 68;       // floats per partial-sum row (64 + pad)
constexpr int G_MAX_CLUSTER = 8;
constexpr int G_TARGET_WAVES = 2;  // blocks per SM the plan aims at

enum { EPI_STORE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

__host__ __device__ constexpr int gemm_stage_bytes(int MT) {
  return G_KC * G_WLD + MT * 16 * G_XLD * 2;
}
__host__ __device__ constexpr int gemm_smem_bytes(int MT) {
  return G_NST * gemm_stage_bytes(MT) + MT * 16 * G_RLD * 4 + 2 * G_COLS * 4;
}

// K slices for a (K, N) weight on `sms` SMs (K % 64 == 0, N % 64 == 0):
// the least divisor s <= 8 of K / 64 giving N / 64 x s >= 2 x sms blocks,
// else the largest such divisor; each slice K / s rows (a whole number of
// 64-row stages), the slices of a column tile one cluster of s blocks.
// Whatever R is: the weights are read once per call.
// ops/decode_layers.py::gemm_plan mirrors it.
int gemm_plan(int K, int N, int sms) {
  const int cols = N / G_COLS, units = K / G_KC;
  int best = 1;
  for (int s = 1; s <= G_MAX_CLUSTER; ++s) {
    if (units % s) continue;
    best = s;
    if (cols * s >= G_TARGET_WAVES * sms) break;
  }
  return best;
}

struct GemmArgs {
  const bf16* x;       // (R, K), row stride ldx
  int ldx;
  const int8_t* w;     // (K, N), row stride ldw bytes
  int ldw;
  int K, N, R;
  const float* scale;  // (N,)
  const float* bias;   // (N,)
  int mode;
  void* out;           // (R, N) bf16 or f32 (the kernel's OT), stride ldo
  int ldo;
};

// grid (s, N / 64), cluster (s, 1, 1): block (ks, ct) owns columns
// [64 ct, 64 ct + 64) and K rows [ks K/s, (ks + 1) K/s). Warp w owns 16
// columns (two n8 tiles): a thread's 16-bit weight load at column
// 16 w + 2 g holds fragment column g of both tiles (tile j's column g is
// physical column 16 w + 2 g + j). MT m16 row tiles (16 MT rows) a pass.
// OT f32 (the f32 residual stream's qkv, cq and x) stores y, or adds it to
// x, without a rounding.
template <int MT, typename OT>
__global__ void __launch_bounds__(G_THREADS)
gemm_w8_kernel(GemmArgs a) {
  extern __shared__ __align__(128) uint8_t sm[];
  constexpr int RT = MT * 16;
  constexpr int SB = gemm_stage_bytes(MT);
  float* red = reinterpret_cast<float*>(sm + G_NST * SB);
  float* ssm = red + RT * G_RLD;  // the tile's scales, then its biases
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ks = blockIdx.x, S = gridDim.x;
  const int n0 = blockIdx.y * G_COLS;
  const int kslice = a.K / S, kbase = ks * kslice, nch = kslice / G_KC;

  auto load_w = [&](int c) {
    uint8_t* dst = sm + (c % G_NST) * SB;
    const int8_t* src = a.w + (size_t)(kbase + c * G_KC) * a.ldw + n0;
#pragma unroll
    for (int i = tid; i < G_KC * 4; i += G_THREADS) {
      const int r = i >> 2, q = i & 3;
      cp16(dst + r * G_WLD + q * 16, src + (size_t)r * a.ldw + q * 16,
                 16);
    }
  };
  auto load_x = [&](int c, int r0) {
    bf16* dst = reinterpret_cast<bf16*>(sm + (c % G_NST) * SB + G_KC * G_WLD);
    const int k = kbase + c * G_KC;
#pragma unroll
    for (int i = tid; i < RT * 8; i += G_THREADS) {
      const int r = i >> 3, q = i & 7;
      const int row = r0 + r;
      const bool ok = row < a.R;
      const bf16* src = a.x + (size_t)(ok ? row : 0) * a.ldx + k + q * 8;
      cp16(dst + r * G_XLD + q * 8, src, ok ? 16 : 0);
    }
  };

  for (int r0 = 0; r0 < a.R; r0 += RT) {
    // the weights, scales and biases depend on no kernel: the first
    // stages go out before the wait for the previous kernel (x's producer)
    for (int c = 0; c < G_NST - 1; ++c)
      if (c < nch) load_w(c);
    if (r0 == 0 && tid < 2 * G_COLS / 4)
      cp16(ssm + 4 * tid,
                 (tid < G_COLS / 4 ? a.scale + n0 : a.bias + n0 - G_COLS) +
                     4 * tid,
                 16);
    cp_commit();
    if (r0 == 0) {
      pdl_wait();
      pdl_trigger();
    }
    for (int c = 0; c < G_NST - 1; ++c) {
      if (c < nch) load_x(c, r0);
      cp_commit();
    }

    float acc[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;

    for (int c = 0; c < nch; ++c) {
      cp_wait<G_NST - 2>();
      __syncthreads();  // stage c landed; stage c - 1 is free
      const int cn = c + G_NST - 1;
      if (cn < nch) {
        load_w(cn);
        load_x(cn, r0);
      }
      cp_commit();
      const uint8_t* sw = sm + (c % G_NST) * SB;
      const uint16_t* w16 = reinterpret_cast<const uint16_t*>(sw);
      const bf16* sx = reinterpret_cast<const bf16*>(sw + G_KC * G_WLD);
#pragma unroll
      for (int kk = 0; kk < G_KC / 16; ++kk) {
        const int kr = kk * 16 + 2 * t;
        const int col = warp * 8 + g;  // in 16-bit words of a weight row
        const uint32_t w0 = w16[kr * (G_WLD / 2) + col];
        const uint32_t w1 = w16[(kr + 1) * (G_WLD / 2) + col];
        const uint32_t w8 = w16[(kr + 8) * (G_WLD / 2) + col];
        const uint32_t w9 = w16[(kr + 9) * (G_WLD / 2) + col];
        // bytes: [k 2t | k 2t+1] x [tile 0, tile 1], as exact f32
        float lo[4], hi[4];
        splitkv::i8x4_to_f32((int)(w0 | (w1 << 16)), lo);
        splitkv::i8x4_to_f32((int)(w8 | (w9 << 16)), hi);
        const uint32_t b0[2] = {pack_bf2(lo[0], lo[2]), pack_bf2(lo[1], lo[3])};
        const uint32_t b1[2] = {pack_bf2(hi[0], hi[2]), pack_bf2(hi[1], hi[3])};
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t af[4];
          ldmatrix_x4(af, sx + (m * 16 + (lane & 15)) * G_XLD + kk * 16 +
                              (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 2; ++j) mma_bf16(acc[m][j], af, b0[j], b1[j]);
        }
      }
    }
    cp_wait<0>();

    // fragment (row g [+8], fragment column 2t [+1]) of tile j is physical
    // column 16 warp + 2 (2t [+1]) + j
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[(m * 16 + g + (i >= 2 ? 8 : 0)) * G_RLD + warp * 16 +
              2 * (2 * t + (i & 1)) + j] = acc[m][j][i];
    cl.sync();

    // the cluster's K slices summed in rank order, four columns a thread
    // (one 16-byte load from each block); each block finishes an
    // interleaved share of the tile's outputs
    const int nr = min(RT, a.R - r0);
    for (int i = ks * G_THREADS + tid; i < nr * (G_COLS / 4);
         i += S * G_THREADS) {
      const int r = i >> 4, c = (i & 15) * 4;
      OT* o = static_cast<OT*>(a.out) + (size_t)(r0 + r) * a.ldo + n0 + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < S; ++q) {
        const float4 p = *reinterpret_cast<const float4*>(
            cl.map_shared_rank(&red[r * G_RLD + c], q));
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
      const float vv[4] = {v.x, v.y, v.z, v.w};
      if constexpr (std::is_same<OT, float>::value) {
        float4 res = make_float4(0.f, 0.f, 0.f, 0.f);
        if (a.mode == EPI_RESIDUAL) res = *reinterpret_cast<const float4*>(o);
        const float rv[4] = {res.x, res.y, res.z, res.w};
        float ov[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float y =
              __fadd_rn(__fmul_rn(vv[j], ssm[c + j]), ssm[G_COLS + c + j]);
          if (a.mode == EPI_GELU)
            ov[j] = gelu_as(y);
          else if (a.mode == EPI_RESIDUAL)
            ov[j] = __fadd_rn(rv[j], y);
          else
            ov[j] = y;
        }
        *reinterpret_cast<float4*>(o) = make_float4(ov[0], ov[1], ov[2], ov[3]);
      } else {
        uint2 res = make_uint2(0u, 0u);
        if (a.mode == EPI_RESIDUAL) res = *reinterpret_cast<const uint2*>(o);
        const bf16* rv = reinterpret_cast<const bf16*>(&res);
        uint2 outw;
        bf16* ob = reinterpret_cast<bf16*>(&outw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float y =
              __fadd_rn(__fmul_rn(vv[j], ssm[c + j]), ssm[G_COLS + c + j]);
          if (a.mode == EPI_GELU)
            ob[j] = f2bf(gelu_as(y));
          else if (a.mode == EPI_RESIDUAL)
            ob[j] = f2bf(__fadd_rn(bf2f(rv[j]), round_bf(y)));
          else
            ob[j] = f2bf(y);
        }
        *reinterpret_cast<uint2*>(o) = outw;
      }
    }
    cl.sync();  // red stays alive until every block has read it
  }
}

template <typename OT>
int launch_gemm(const GemmArgs& a, dim3 grid, int s, int pdl,
                cudaStream_t st) {
  const int tiles = (a.R + 15) / 16;
  if (tiles <= 1)
    return launch(gemm_w8_kernel<1, OT>, grid, G_THREADS, gemm_smem_bytes(1),
                  s, pdl, st, a);
  if (tiles == 2)
    return launch(gemm_w8_kernel<2, OT>, grid, G_THREADS, gemm_smem_bytes(2),
                  s, pdl, st, a);
  if (tiles == 3)
    return launch(gemm_w8_kernel<3, OT>, grid, G_THREADS, gemm_smem_bytes(3),
                  s, pdl, st, a);
  return launch(gemm_w8_kernel<4, OT>, grid, G_THREADS, gemm_smem_bytes(4),
                s, pdl, st, a);
}

template <typename OT>
int allow_gemm_smem() {
  const void* kerns[] = {(const void*)gemm_w8_kernel<1, OT>,
                         (const void*)gemm_w8_kernel<2, OT>,
                         (const void*)gemm_w8_kernel<3, OT>,
                         (const void*)gemm_w8_kernel<4, OT>};
  for (int mt = 1; mt <= 4; ++mt) {
    const cudaError_t e = cudaFuncSetAttribute(
        kerns[mt - 1], cudaFuncAttributeMaxDynamicSharedMemorySize,
        gemm_smem_bytes(mt));
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// out bf16, or f32 with `out_f32` (16-byte aligned rows)
int run_gemm(const bf16* x, int ldx, int K, const int8_t* w, int ldw, int N,
             int R, const float* scale, const float* bias, int mode,
             void* out, int ldo, int out_f32, int sms, int pdl,
             cudaStream_t st) {
  if (K % G_KC || N % G_COLS || R <= 0 || ldx % 8 || ldw % 16 || ldo % 4 ||
      reinterpret_cast<uintptr_t>(out) % (out_f32 ? 16 : 8) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(scale) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 16)
    return (int)cudaErrorInvalidValue;
  const int s = gemm_plan(K, N, sms);
  const dim3 grid(s, N / G_COLS);
  GemmArgs a{x, ldx, w, ldw, K, N, R, scale, bias, mode, out, ldo};
  return out_f32 ? launch_gemm<float>(a, grid, s, pdl, st)
                 : launch_gemm<bf16>(a, grid, s, pdl, st);
}

// --------------------------------------------- (c), (d) attention parts

// R rows, `queries` a cache row (the verify step's drafted tokens; 1 for
// a decode step); `f32`: qkv f32 and a non-int8 cache f32
int run_self_attn(const void* qkv, int R, int queries, int d, int H,
                  void* cache, float* csc, int self_int8, int Tmax,
                  const int* step, bf16* att, int f32, int pdl,
                  cudaStream_t st) {
  using namespace splitkv;
  SelfArgs a{qkv, d, cache, csc, H, Tmax, 0, 0, step, att};
  int S, C;
  split_plan(Tmax, &S, &C);
  if (S > MAX_SPLITS || C > SELF_MAX_KEYS || queries < 1 ||
      queries > SELF_MAX_QUERIES || R <= 0 || R % queries ||
      R / queries > 65535)
    return (int)cudaErrorInvalidValue;
  a.C = C;
  a.HPB = self_heads_per_block(H, C, self_int8, queries, f32);
  const int smem = self_int8 ? self_smem_bytes<true>(a.HPB, C, queries)
                   : f32     ? self_smem_bytes<false, true>(a.HPB, C, queries)
                             : self_smem_bytes<false>(a.HPB, C, queries);
  if (smem > SELF_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const dim3 grid(S, H / a.HPB, R / queries);
  const int threads = a.HPB * C;
  if (f32)
    return self_int8 ? launch_self_nq<true, true>(a, grid, threads, smem,
                                                  queries, pdl, st)
                     : launch_self_nq<false, true>(a, grid, threads, smem,
                                                   queries, pdl, st);
  return self_int8
             ? launch_self_nq<true>(a, grid, threads, smem, queries, pdl, st)
             : launch_self_nq<false>(a, grid, threads, smem, queries, pdl, st);
}

// cq (R, d) with R = Bw * G rows, window-major (the G beams of a window
// contiguous), over the Bw windows' K/V (Bw, 2, H, Ta, 64) and scales
// (Bw, 2, H, Ta). Greedy decode is G = 1. cq bf16, or f32 with `q_f32`.
int run_cross_attn(const void* cq, int R, int d, int H, const int8_t* kv8,
                   const float* sc, int Ta, int Bw, bf16* att, int q_f32,
                   int sms, int pdl, cudaStream_t st) {
  if (Bw <= 0 || R % Bw) return (int)cudaErrorInvalidValue;
  const int G = R / Bw;
  const size_t v_off = (size_t)H * Ta;  // V after K: rows, scales
  splitkv::CrossArgs a{};
  a.q = cq;
  a.q_sw = (long long)G * d;  // the G rows of a window
  a.q_sh = DH;
  a.q_sg = d;
  a.k8 = kv8;
  a.v8 = kv8 + v_off * DH;
  a.kv_sw = 2LL * H * Ta * DH;
  a.kv_sh = (long long)Ta * DH;
  a.ks = sc;
  a.vs = sc + v_off;
  a.s_sw = 2LL * H * Ta;
  a.s_sh = Ta;
  a.out = att;
  a.o_sw = a.q_sw;
  a.o_sh = DH;
  a.o_sg = d;
  a.H = H;
  a.Ta = Ta;
  a.G = G;
  return q_f32 ? splitkv::launch_cross_split<float, bf16>(a, Bw, sms, pdl, st)
               : splitkv::launch_cross_split<bf16, bf16>(a, Bw, sms, pdl, st);
}

// x bf16, or f32 with `x_f32`
int run_layer_norm(const void* x, int R, int d, const float* s,
                   const float* b, bf16* y, int x_f32, int pdl,
                   cudaStream_t st) {
  if (d % 8) return (int)cudaErrorInvalidValue;
  if (x_f32)
    return launch(layer_norm_kernel<float>, dim3(R), 32, 0, 0, pdl, st,
                  static_cast<const float*>(x), s, b, y, d);
  return launch(layer_norm_kernel<bf16>, dim3(R), 32, 0, 0, pdl, st,
                static_cast<const bf16*>(x), s, b, y, d);
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

// Once per card, before any launch or capture there: every kernel of the
// step loaded (a module loaded lazily at its first launch would otherwise
// load inside a graph capture) and allowed its dynamic shared memory.
int aries_decode_init() {
  cudaFuncAttributes fa;
  RETURN_IF((int)cudaFuncGetAttributes(&fa, layer_norm_kernel<bf16>));
  RETURN_IF((int)cudaFuncGetAttributes(&fa, layer_norm_kernel<float>));
  RETURN_IF(splitkv::self_allow_smem<true>());
  RETURN_IF(splitkv::self_allow_smem<false>());
  RETURN_IF((splitkv::cross_allow_smem<bf16, bf16>()));
  RETURN_IF((splitkv::cross_allow_smem<float, bf16>()));
  RETURN_IF(allow_gemm_smem<bf16>());
  RETURN_IF(allow_gemm_smem<float>());
  return 0;
}

// the plans, for the Python mirrors' checks
int aries_gemm_plan(int K, int N, int sms) { return gemm_plan(K, N, sms); }

int aries_attn_split(int T, int* out) {
  splitkv::split_plan(T, &out[0], &out[1]);
  return 0;
}

int aries_cross_split(int Ta, int pairs, int G, int sms, int* out) {
  splitkv::cross_plan(Ta, pairs, G, sms, &out[0], &out[1]);
  return 0;
}

// the parts one by one; `f32` flags the f32 residual stream's operands
// (x, the GEMM's output, qkv and the self cache, cq)
int aries_layer_norm(const void* x, int R, int d, const float* s,
                     const float* b, void* y, int x_f32, void* stream) {
  return run_layer_norm(x, R, d, s, b, static_cast<bf16*>(y), x_f32, 0,
                        (cudaStream_t)stream);
}

int aries_w8a16_gemm(const void* x, int ldx, int R, int K, const int8_t* w,
                     int ldw, int N, const float* scale, const float* bias,
                     int mode, void* out, int ldo, int out_f32, int sms,
                     void* stream) {
  return run_gemm(static_cast<const bf16*>(x), ldx, K, w, ldw, N, R, scale,
                  bias, mode, out, ldo, out_f32, sms, 0,
                  (cudaStream_t)stream);
}

int aries_self_attn(const void* qkv, int R, int queries, int d, int H,
                    void* cache, float* csc, int self_int8, int Tmax,
                    const int* step, void* att, int f32, void* stream) {
  return run_self_attn(qkv, R, queries, d, H, cache, csc, self_int8, Tmax,
                       step, static_cast<bf16*>(att), f32, 0,
                       (cudaStream_t)stream);
}

int aries_cross_attn(const void* cq, int R, int d, int H, const int8_t* kv8,
                     const float* sc, int Ta, int Bw, void* att, int q_f32,
                     int sms, void* stream) {
  return run_cross_attn(cq, R, d, H, kv8, sc, Ta, Bw,
                        static_cast<bf16*>(att), q_f32, sms, 0,
                        (cudaStream_t)stream);
}

// All L decoder layers of one step. x (R, d) bf16 (f32 with `x_f32`: the
// f32 residual stream) is updated in place; the self cache
// (L, R, 2, H, Tmax, 64) [x's type, or int8 with scales csc
// (L, R, 2, H, Tmax)] gets this step's K/V at position step[0], attending
// over [step[1], step[0]] (step: two device int32). With `queries` Q > 1
// (the speculative verify step) the self cache holds R / Q rows, row c's
// Q queries being x rows c Q .. c Q + Q - 1: query q appends at step[0] +
// q and attends over [step[1], step[0] + q]. The cross K/V
// (L, Bw, 2, H, Ta, 64) and scales (L, Bw, 2, H, Ta) hold Bw windows, each
// shared by its R / Bw rows (window-major). h (R, d), qkv (R, 3d) (x's
// type; at f32 it holds cq too), att (R, d), h1 (R, ff) bf16 are scratch
// the caller owns. `sms` is the
// card's SM count (the GEMM plan); `pdl` launches each kernel as a
// programmatic dependent of the one before. Nothing here queries or sets
// the device, so the call can be captured in a CUDA graph.
int aries_decode_layers(void* x_, int R, int queries, int d, int ff, int H,
                        int L,
                        const int8_t* wq8, const int8_t* wf1,
                        const int8_t* wf2, const float* vecs, int vec_len,
                        void* cache, float* csc, int self_int8, int Tmax,
                        const int8_t* xkv, const float* xsc, int Ta, int Bw,
                        const int* step, void* h_, void* qkv_, void* att_,
                        void* h1_, int x_f32, int sms, int pdl,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  void* x = x_;
  bf16* h = static_cast<bf16*>(h_);
  void* qkv = qkv_;
  bf16* att = static_cast<bf16*>(att_);
  bf16* h1 = static_cast<bf16*>(h1_);
  // at f32, cq goes into qkv's scratch (free once self-attention has read
  // it), in f32 as the cross-attention reads it
  void* cq = x_f32 ? qkv : (void*)att;
  const size_t xe = x_f32 ? 4 : 2;  // bytes of an x / cache element
  int off[19];
  vec_offsets(d, ff, off);
  if (queries < 1 || R % queries)
    return (int)cudaErrorInvalidValue;
  const size_t self_stride = (size_t)(R / queries) * 2 * H * Tmax * DH;
  const size_t self_sc_stride = (size_t)(R / queries) * 2 * H * Tmax;
  const size_t cross_stride = (size_t)Bw * 2 * H * Ta * DH;
  const size_t cross_sc_stride = (size_t)Bw * 2 * H * Ta;
  const int ldq = 6 * d;
  for (int l = 0; l < L; ++l) {
    const float* v = vecs + (size_t)l * vec_len;
    const int8_t* wq = wq8 + (size_t)l * d * ldq;
    void* cache_l = self_int8
        ? (void*)(static_cast<int8_t*>(cache) + l * self_stride)
        : (void*)(static_cast<uint8_t*>(cache) + l * self_stride * xe);
    float* csc_l = self_int8 ? csc + l * self_sc_stride : nullptr;
    // self-attention block
    RETURN_IF(run_layer_norm(x, R, d, v + off[0], v + off[1], h, x_f32, pdl,
                             st));
    RETURN_IF(run_gemm(h, d, d, wq, ldq, 3 * d, R, v + off[12], v + off[2],
                       EPI_STORE, qkv, 3 * d, x_f32, sms, pdl, st));
    RETURN_IF(run_self_attn(qkv, R, queries, d, H, cache_l, csc_l,
                            self_int8, Tmax, step, att, x_f32, pdl, st));
    RETURN_IF(run_gemm(att, d, d, wq + 3 * d, ldq, d, R, v + off[13],
                       v + off[3], EPI_RESIDUAL, x, d, x_f32, sms, pdl, st));
    // cross-attention block (at bf16 cq overwrites att, and the
    // cross-attention's output h, once their readers are done)
    RETURN_IF(run_layer_norm(x, R, d, v + off[4], v + off[5], h, x_f32, pdl,
                             st));
    RETURN_IF(run_gemm(h, d, d, wq + 4 * d, ldq, d, R, v + off[14],
                       v + off[6], EPI_STORE, cq, d, x_f32, sms, pdl, st));
    RETURN_IF(run_cross_attn(cq, R, d, H, xkv + l * cross_stride,
                             xsc + l * cross_sc_stride, Ta, Bw, h, x_f32,
                             sms, pdl, st));
    RETURN_IF(run_gemm(h, d, d, wq + 5 * d, ldq, d, R, v + off[15],
                       v + off[7], EPI_RESIDUAL, x, d, x_f32, sms, pdl, st));
    // MLP block
    RETURN_IF(run_layer_norm(x, R, d, v + off[8], v + off[9], h, x_f32, pdl,
                             st));
    RETURN_IF(run_gemm(h, d, d, wf1 + (size_t)l * d * ff, ff, ff, R,
                       v + off[16], v + off[10], EPI_GELU, h1, ff, 0, sms,
                       pdl, st));
    RETURN_IF(run_gemm(h1, ff, ff, wf2 + (size_t)l * ff * d, d, d, R,
                       v + off[17], v + off[11], EPI_RESIDUAL, x, d, x_f32,
                       sms, pdl, st));
  }
  return 0;
}

}  // extern "C"
