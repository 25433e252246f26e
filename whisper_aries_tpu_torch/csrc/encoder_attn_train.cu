// Encoder attention for training: an f32 forward that keeps the row
// log-sum-exp, and its backward.
//
// Replaces: whisper_aries_tpu/models/whisper.py, _flash_attention_pallas
// (the Pallas TPU kernel the JAX encoder runs on a TPU at n_audio_ctx >=
// 256), at the f32 inputs of a train step (params in f32, as
// ``init_params`` makes them). JAX cannot differentiate that kernel, so
// what the backward computes is the gradient of the same function, held
// against the autograd of the plain version (models/whisper.py
// ``attention_plain``, the JAX package's ``_attention_xla``).
//
// What it computes, for q, k, v (B, H, T, 64) f32:
//   forward:  s_ij = (q_i * 1/8) . k_j over the T real keys (keys at or
//             past T are never scored), o_i = softmax_j(s_ij) v_j and
//             L_i = log sum_j exp(s_ij), all in f32;
//   backward: given dO, D_i = dO_i . o_i, P_ij = exp(s_ij - L_i),
//             dV_j = sum_i P_ij dO_i, dS_ij = P_ij (dO_i . v_j - D_i),
//             dK_j = sum_i dS_ij (q_i / 8), dQ_i = 1/8 sum_j dS_ij k_j.
// Every product term is one f32 FMA on the CUDA cores: no tensor-core
// instruction and no reduced-precision split, so the products are those of
// the plain version with TF32 off. Scaling by 1/8 is exact (a power of
// two), so it is applied to S and to dK / dQ after the sums.
//
// What bounds it: operations. At (2, 20, 1500, 64) the forward's two
// products and the backward's five are 2.3e10 and 5.8e10 FLOP, 0.344 and
// 0.860 ms at the H100's 67 TFLOP/s f32; the bytes (q, k, v, o, dO and
// the gradients once) are 0.03-0.06 ms. Each product is register-blocked
// as a small GEMM, so that an FMA seldom waits on shared memory; the rest
// of the time goes to the softmax, the barriers, the partial-dQ stores and
// the grids' last partial waves (PERF.md, row 2t).
//
// Design:
//   * a warp owns 16 rows of its side (queries in the forward, keys in
//     the backward); lane (ty, tx) = (lane / 16, lane % 16) holds rows
//     ty + 2i (i < 8) against columns tx + 16j (j < 4) of the 64 rows of
//     the other side's tile: an 8 x 4 micro-tile of S (and dP), and the
//     same 8 rows x dims 4tx..4tx+3 of O (dK, dV). A step of a product
//     reads 8 float4 of its rows (2 distinct addresses a warp: broadcasts)
//     and 4 float4 of the other side, for 128 FMAs: 10.7 FMAs a 16-byte
//     shared load (a thread a row, reading a key a step, does 4);
//   * tiles stream through two stages of dynamic shared memory filled by
//     cp.async (zeros past T), the next tile loading while the current
//     one is used. A tile read at one chunk by 16 rows lies XOR-swizzled
//     (chunk c of row r at c ^ (r & 7)), and a P / dS buffer written by
//     both parities of rows at chunk c ^ 4 (r & 1), so no read or store
//     of a warp meets itself on a bank; nothing is padded;
//   * tiles lie row-major, as in global memory, not transposed (dim-major)
//     and padded: cp.async copies 16 contiguous bytes, so a transposed
//     tile would take 4-byte copies or a pass through registers, and one
//     float4 of padding a row would take the forward block to 119 KB, one
//     block an SM. A step along the dims (a float4 of each of 8 rows, one
//     of each of 4 columns) gives the same 10.7 FMAs a load as the
//     transposed layout's 8 x 4 outer product. The transposed layout was
//     not built or timed against this one;
//   * forward: a block owns 16 FW query rows and walks 64-key tiles of K
//     and V. S goes through an online softmax whose row max meets across
//     the 16 lanes of a half-warp (shuffles; each lane keeps its own part
//     of the row sum until the end), P through the warp's own buffer in
//     shared memory (a __syncwarp, no block barrier) into O += P V;
//   * backward: D = rowsum(dO o), a thread a row; then a block owns 16 BW
//     keys, their K and V tiles in shared memory and their dK, dV sums in
//     registers, and walks 64-row tiles of q and dO: S^T and P^T from L,
//     dP^T = V dO^T, dS^T, dV += P^T dO and dK += dS^T q (P^T, then dS^T,
//     through one buffer), and the tile's partial dQ = dS K over the
//     block's keys, written to scratch (B H, key tiles, T, 64); a last
//     pass sums the partials in key-tile order. Five products, no atomics:
//     every sum is taken in a fixed order, so two runs give the same bits.
// Rows and keys past T are loaded as zeros, never scored (S is -inf, P 0)
// and never written.
//
// Tiling: forward 6 warps a block (96 query rows, 112 KB of shared memory,
// 168 registers: 2 blocks, 12 warps an SM; 640 blocks at (2, 20, 1500),
// 2.42 waves on 132 SMs), backward 4 (64 keys, 112 KB, 244 registers: 2
// blocks an SM; 960 blocks, 3.64 waves; a 369 MB partial-dQ scratch).
#include <mutex>

#include "common.cuh"

namespace {

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

constexpr int DH = 64;
constexpr int C4 = DH / 4;  // float4 chunks a row
constexpr int TILE = 64;    // rows of the streamed side a tile
constexpr int FW = 6;        // forward: warps a block (16 query rows each)
constexpr int BW = 4;        // backward: warps a block (16 keys each)
constexpr int FQ = 16 * FW;  // forward: query rows a block
constexpr int BK = 16 * BW;  // backward: keys a block
constexpr int RQ = TILE / (2 * BW);  // partial dQ: rows a thread
constexpr int DELTA_NT = 128, SUM_NT = 256;  // D, dQ sum: threads a block

// dynamic shared memory, in float4: forward q, two K and two V stages,
// a P buffer a warp; backward K, V, two q and two dO stages, P^T / dS^T
constexpr int FWD_SMEM = (FQ + 4 * TILE + FQ) * C4 * 16;
constexpr int BWD_SMEM = (3 * BK + 4 * TILE) * C4 * 16;

// where chunk c of row r of a [rows][64] tile lies, in float4: as is
// (SW 0), swizzled against 16 rows read at one chunk (SW 1), or against
// stores from rows of both parities (SW 2)
template <int SW>
__device__ __forceinline__ int at(int r, int c) {
  return r * C4 + (SW == 1 ? c ^ (r & 7) : SW == 2 ? c ^ ((r & 1) << 2) : c);
}

// scalar (r, col) of an SW 2 tile, in floats
__device__ __forceinline__ int at_f(int r, int col) {
  return at<2>(r, col >> 2) * 4 + (col & 3);
}

// cp.async of `rows` rows of a (T, 64) head from row r0 into a tile;
// rows at or past T are filled with zeros
template <int SW, int NT>
__device__ __forceinline__ void stage(float4* dst, const float* src, int r0,
                                      int rows, int T) {
  for (int i = threadIdx.x; i < rows * C4; i += NT) {
    const int r = i / C4, c = i % C4;
    const bool in = r0 + r < T;
    cp16(dst + at<SW>(r, c), src + (size_t)(in ? r0 + r : 0) * DH + 4 * c,
         in ? 16 : 0);
  }
}

// a + p.x x0 + p.y x1 + p.z x2 + p.w x3, FMAs in that order
__device__ __forceinline__ float chain4(float a, float4 p, float x0,
                                        float x1, float x2, float x3) {
  return fmaf(p.w, x3, fmaf(p.z, x2, fmaf(p.y, x1, fmaf(p.x, x0, a))));
}

// a += x . y over one chunk, dims in order
__device__ __forceinline__ float dot4(float a, float4 x, float4 y) {
  return chain4(a, x, y.x, y.y, y.z, y.w);
}

// acc[e] += p.x r[0].e + ... + p.w r[3].e: 4 rows of a chunk, in order
__device__ __forceinline__ void axpy4(float (&acc)[4], float4 p,
                                      const float4 (&r)[4]) {
  acc[0] = chain4(acc[0], p, r[0].x, r[1].x, r[2].x, r[3].x);
  acc[1] = chain4(acc[1], p, r[0].y, r[1].y, r[2].y, r[3].y);
  acc[2] = chain4(acc[2], p, r[0].z, r[1].z, r[2].z, r[3].z);
  acc[3] = chain4(acc[3], p, r[0].w, r[1].w, r[2].w, r[3].w);
}

// s[i][j] = rows(i) . cols(j) over the 64 dims: rows ty + 2i of `rows`
// (SW 0, from row r0), columns tx + 16j of `cols` (SW 1)
__device__ __forceinline__ void product(float (&s)[8][4], const float4* rows,
                                        int r0, const float4* cols, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < C4; ++c) {
    float4 cf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) cf[j] = cols[at<1>(tx + 16 * j, c)];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 rf = rows[(r0 + 2 * i) * C4 + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(s[i][j], rf, cf[j]);
    }
  }
}

// acc[i][e] += sum_c w(r0 + 2i, c) * b(c, 4tx + e) over the tile's 64
// rows c: w an SW 2 buffer (rows r0 + 2i), b a 64-row tile (SW SWB)
template <int SWB>
__device__ __forceinline__ void accumulate(float (&acc)[8][4],
                                           const float4* w, int r0,
                                           const float4* b, int tx) {
#pragma unroll 4
  for (int c = 0; c < C4; ++c) {
    float4 bf[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) bf[u] = b[at<SWB>(4 * c + u, tx)];
#pragma unroll
    for (int i = 0; i < 8; ++i) axpy4(acc[i], w[at<2>(r0 + 2 * i, c)], bf);
  }
}

__global__ void __launch_bounds__(32 * FW, 2)
    attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int T, float scale) {
  extern __shared__ float4 sm[];
  float4* qs = sm;                   // [FQ][16]
  float4* ks = qs + FQ * C4;         // [2][TILE][16], SW 1
  float4* vs = ks + 2 * TILE * C4;   // [2][TILE][16]
  float4* ps = vs + 2 * TILE * C4;   // [FW][16][16], SW 2
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = lane >> 4, tx = lane & 15;
  const size_t head = (size_t)blockIdx.y * T * DH;
  const int q0 = blockIdx.x * FQ, nt = (T + TILE - 1) / TILE;
  float4* pw = ps + warp * 16 * C4;
  stage<0, 32 * FW>(qs, q + head, q0, FQ, T);
  stage<1, 32 * FW>(ks, k + head, 0, TILE, T);
  stage<0, 32 * FW>(vs, v + head, 0, TILE, T);
  cp_commit();
  float acc[8][4], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
  for (int t = 0; t < nt; ++t) {
    const int b = t & 1;
    cp_wait_all();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + 1 < nt) {  // into the stage tile t - 1 used
      stage<1, 32 * FW>(ks + (b ^ 1) * TILE * C4, k + head, (t + 1) * TILE,
                        TILE, T);
      stage<0, 32 * FW>(vs + (b ^ 1) * TILE * C4, v + head, (t + 1) * TILE,
                        TILE, T);
      cp_commit();
    }
    float s[8][4];
    product(s, qs, warp * 16 + ty, ks + b * TILE * C4, tx);
    const int k0 = t * TILE;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = k0 + tx + 16 * j < T ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int x = 8; x > 0; x >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float mn = fmaxf(m[i], mx);  // finite: key k0 is real
      const float alpha = expf(m[i] - mn);  // 0 at the first tile
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        l[i] += p;
        reinterpret_cast<float*>(pw)[at_f(ty + 2 * i, tx + 16 * j)] = p;
      }
    }
    __syncwarp();
    accumulate<0>(acc, pw, ty, vs + b * TILE * C4, tx);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float lt = l[i];
#pragma unroll
    for (int x = 8; x > 0; x >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, x);
    const int row = q0 + warp * 16 + ty + 2 * i;
    if (row >= T) continue;
    reinterpret_cast<float4*>(o + head + (size_t)row * DH)[tx] =
        make_float4(acc[i][0] / lt, acc[i][1] / lt, acc[i][2] / lt,
                    acc[i][3] / lt);
    if (tx == 0) lse[(size_t)blockIdx.y * T + row] = m[i] + logf(lt);
  }
}

// D_i = dO_i . o_i, a thread a row, its FMAs in the order of dP's (dims in
// order), so that dP_ij - D_i is exactly 0 where o_i = v_j (one key)
__global__ void attn_delta_kernel(const float* __restrict__ o,
                                  const float* __restrict__ dout,
                                  float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const float4* a = reinterpret_cast<const float4*>(o) + (size_t)row * C4;
  const float4* b = reinterpret_cast<const float4*>(dout) + (size_t)row * C4;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C4; ++c) s = dot4(s, b[c], a[c]);
  delta[row] = s;
}

// part: (B H, key tiles, T, 64) f32, this block's partial dQ (times 8)
__global__ void __launch_bounds__(32 * BW, 2)
    attn_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ part, int T,
                     float scale) {
  extern __shared__ float4 sm[];
  float4* ks = sm;                   // [BK][16]
  float4* vs = ks + BK * C4;         // [BK][16]
  float4* qs = vs + BK * C4;         // [2][TILE][16], SW 1
  float4* gs = qs + 2 * TILE * C4;   // [2][TILE][16], SW 1 (dO)
  float4* bs = gs + 2 * TILE * C4;   // [BK][16], SW 2: P^T, then dS^T
  float* bf = reinterpret_cast<float*>(bs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = lane >> 4, tx = lane & 15;
  const int kr = warp * 16 + ty;  // this lane's keys: kr + 2i of the block
  const int key0 = blockIdx.x * BK, nt = (T + TILE - 1) / TILE;
  const size_t head = (size_t)blockIdx.y * T * DH;
  const float* lse_h = lse + (size_t)blockIdx.y * T;
  const float* delta_h = delta + (size_t)blockIdx.y * T;
  float4* part_b =
      reinterpret_cast<float4*>(part) +
      ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * T * C4;
  stage<0, 32 * BW>(ks, k + head, key0, BK, T);
  stage<0, 32 * BW>(vs, v + head, key0, BK, T);
  stage<1, 32 * BW>(qs, q + head, 0, TILE, T);
  stage<1, 32 * BW>(gs, dout + head, 0, TILE, T);
  cp_commit();
  float dka[8][4], dva[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  const int ry = warp * 2 + ty;  // partial dQ: rows RQ ry .. of the tile
  for (int t = 0; t < nt; ++t) {
    const int b = t & 1, i0 = t * TILE;
    float Lr[4], Dr[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = i0 + tx + 16 * j;
      Lr[j] = row < T ? lse_h[row] : INFINITY;  // P 0 past T
      Dr[j] = row < T ? delta_h[row] : 0.f;
    }
    cp_wait_all();
    // tile t is in; every warp is done with tile t - 1 and with bs
    __syncthreads();
    if (t + 1 < nt) {  // into the stage tile t - 1 used
      stage<1, 32 * BW>(qs + (b ^ 1) * TILE * C4, q + head, i0 + TILE, TILE,
                        T);
      stage<1, 32 * BW>(gs + (b ^ 1) * TILE * C4, dout + head, i0 + TILE,
                        TILE, T);
      cp_commit();
    }
    const float4* qt = qs + b * TILE * C4;
    const float4* gt = gs + b * TILE * C4;
    float p[8][4], dp[8][4];
    product(p, ks, kr, qt, tx);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool real = key0 + kr + 2 * i < T;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = real ? expf(p[i][j] * scale - Lr[j]) : 0.f;
        bf[at_f(kr + 2 * i, tx + 16 * j)] = p[i][j];
      }
    }
    product(dp, vs, kr, gt, tx);
    __syncwarp();
    accumulate<1>(dva, bs, kr, gt, tx);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bf[at_f(kr + 2 * i, tx + 16 * j)] = p[i][j] * (dp[i][j] - Dr[j]);
    __syncwarp();
    accumulate<1>(dka, bs, kr, qt, tx);
    __syncthreads();  // every warp's dS^T is in bs
    // partial dQ of rows RQ ry .. RQ ry + RQ - 1, dims 4tx ..: the sum of
    // dS^T (key, row) k_key over the block's keys, keys in order
    float qa[RQ][4];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[r][e] = 0.f;
#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      const float4 kf = ks[key * C4 + tx];
#pragma unroll
      for (int r4 = 0; r4 < RQ / 4; ++r4) {
        const float4 d = bs[at<2>(key, (RQ * ry) / 4 + r4)];
        const float w[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float* a = qa[4 * r4 + u];
          a[0] = fmaf(w[u], kf.x, a[0]);
          a[1] = fmaf(w[u], kf.y, a[1]);
          a[2] = fmaf(w[u], kf.z, a[2]);
          a[3] = fmaf(w[u], kf.w, a[3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int row = i0 + RQ * ry + r;
      if (row < T)
        part_b[(size_t)row * C4 + tx] =
            make_float4(qa[r][0], qa[r][1], qa[r][2], qa[r][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = key0 + kr + 2 * i;
    if (key >= T) continue;
    reinterpret_cast<float4*>(dk + head + (size_t)key * DH)[tx] =
        make_float4(dka[i][0] * scale, dka[i][1] * scale, dka[i][2] * scale,
                    dka[i][3] * scale);
    reinterpret_cast<float4*>(dv + head + (size_t)key * DH)[tx] =
        make_float4(dva[i][0], dva[i][1], dva[i][2], dva[i][3]);
  }
}

// dQ = 1/8 * the sum of the key tiles' partials, in key-tile order; one
// thread a float4
__global__ void attn_dq_sum_kernel(const float4* __restrict__ part,
                                   float4* __restrict__ dq, int T, int nkt,
                                   size_t n4, float scale) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const size_t per = (size_t)T * C4, bh = i / per;
  const float4* p = part + bh * nkt * per + i % per;
  float4 a = p[0];
  for (int kt = 1; kt < nkt; ++kt) {
    const float4 x = p[kt * per];
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  dq[i] = make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
}

bool bad_shape(int B, int H, int T) {
  return B <= 0 || H <= 0 || T <= 0 || B * H > 65535;
}

// the grid of device kernel i (launch order: forward; D, dK/dV, dQ sum) at
// (B, H, T), for the launches and aries_attn_train_attrs alike
dim3 grid_of(int i, int B, int H, int T) {
  const size_t rows = (size_t)B * H * T;
  switch (i) {
    case 0:
      return dim3((T + FQ - 1) / FQ, B * H);
    case 1:
      return dim3((unsigned)((rows + DELTA_NT - 1) / DELTA_NT));
    case 2:
      return dim3((T + BK - 1) / BK, B * H);
    default:
      return dim3((unsigned)((rows * C4 + SUM_NT - 1) / SUM_NT));
  }
}

// the dynamic shared memory above 48 KB, allowed once per card (the cards
// of a host are numbered below 64); the engine launches from a thread a
// replica, so the first call on a card sets it and the others wait
int allow_smem() {
  static std::once_flag once[64];
  static int status[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    cudaError_t r = cudaFuncSetAttribute(
        attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FWD_SMEM);
    if (r == cudaSuccess)
      r = cudaFuncSetAttribute(attn_dkdv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BWD_SMEM);
    status[dev] = (int)r;
  });
  return status[dev];
}

}  // namespace

extern "C" int aries_attn_train_fwd(const float* q, const float* k,
                                    const float* v, float* o, float* lse,
                                    int B, int H, int T, float scale,
                                    void* stream) {
  if (bad_shape(B, H, T)) return (int)cudaErrorInvalidValue;
  const int err = allow_smem();
  if (err) return err;
  const dim3 grid = grid_of(0, B, H, T);
  attn_fwd_kernel<<<grid, 32 * FW, FWD_SMEM, (cudaStream_t)stream>>>(
      q, k, v, o, lse, T, scale);
  return launch_status();
}

// keys a block of the backward: the partial-dQ scratch holds
// ceil(T / this) partials a row
extern "C" int aries_attn_train_key_tile(void) { return BK; }

// delta: (B, H, T) f32 scratch for D; part: (B H, ceil(T / key tile), T,
// 64) f32 scratch for the partial dQ
extern "C" int aries_attn_train_bwd(const float* q, const float* k,
                                    const float* v, const float* o,
                                    const float* lse, const float* dout,
                                    float* delta, float* part, float* dq,
                                    float* dk, float* dv, int B, int H, int T,
                                    float scale, void* stream) {
  if (bad_shape(B, H, T)) return (int)cudaErrorInvalidValue;
  const int err = allow_smem();
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = B * H * T;
  attn_delta_kernel<<<grid_of(1, B, H, T), DELTA_NT, 0, s>>>(o, dout, delta,
                                                            rows);
  attn_dkdv_kernel<<<grid_of(2, B, H, T), 32 * BW, BWD_SMEM, s>>>(
      q, k, v, dout, lse, delta, dk, dv, part, T, scale);
  attn_dq_sum_kernel<<<grid_of(3, B, H, T), SUM_NT, 0, s>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(dq), T,
      (T + BK - 1) / BK, (size_t)rows * C4, scale);
  return launch_status();
}

// out[7 n] for the device kernels in launch order (forward; D, dK/dV,
// dQ sum) at (B, H, T): registers a thread, local (spilled) bytes a
// thread, static shared bytes, dynamic shared bytes a launch, threads a
// block, blocks resident an SM at that launch, and the blocks of the grid
// the entries above launch. Returns the kernel count, or -(a cudaError_t).
extern "C" int aries_attn_train_attrs(int B, int H, int T, int* out, int n) {
  struct K {
    const void* fn;
    int threads, smem;
  };
  const K ks[4] = {{(const void*)attn_fwd_kernel, 32 * FW, FWD_SMEM},
                   {(const void*)attn_delta_kernel, DELTA_NT, 0},
                   {(const void*)attn_dkdv_kernel, 32 * BW, BWD_SMEM},
                   {(const void*)attn_dq_sum_kernel, SUM_NT, 0}};
  if (bad_shape(B, H, T)) return -(int)cudaErrorInvalidValue;
  const int err = allow_smem();
  if (err) return -err;
  for (int i = 0; i < 4 && i < n; ++i) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, ks[i].fn);
    int blocks = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ks[i].fn, ks[i].threads, ks[i].smem);
    if (e != cudaSuccess) return -(int)e;
    const dim3 g = grid_of(i, B, H, T);
    const int row[7] = {a.numRegs, (int)a.localSizeBytes,
                        (int)a.sharedSizeBytes, ks[i].smem, ks[i].threads,
                        blocks, (int)(g.x * g.y)};
    for (int c = 0; c < 7; ++c) out[7 * i + c] = row[c];
  }
  return 4;
}
