// Bidirectional encoder attention (flash-style forward) on TMA + wgmma.
//
// Replaces: whisper_aries_tpu/models/whisper.py, _flash_attention_pallas
// (the Pallas TPU kernel: per (batch, head, q-block), full K/V per head,
// keys at or past T masked, f32 logits and softmax, probabilities cast to
// V's dtype before P.V).
//
// What it computes: out[b,h,i,:] = softmax_j(q_i . k_j / sqrt(64)) v_j over
// the T real keys, for q, k, v (B, H, T, 64) bf16 -> out (B, H, T, 64) bf16,
// with f32 logits, f32 running max/sum and f32 output accumulators. The
// unnormalised probabilities are rounded to bf16 for the P.V product (the
// TPU kernel rounds the normalised ones), a difference inside the stated
// tolerance.
//
// Bound on the H100: operations, twice over. At (8, 20, 1500, 64) the two
// products are 4 B H T^2 64 = 92 GFLOP of bf16 tensor-core work (0.093 ms
// at 989 TFLOP/s) against ~123 MB of q/k/v/out traffic, and at head dim 64
// the softmax's 3.6e8 exponentials take about as long again on the
// special-function units (~3.9e12/s: ~0.09 ms). The first design (one warp
// per 16 rows on mma.sync, K and V loaded through registers between two
// block-wide syncs, V transposed by 2-byte stores, expf on every logit) ran
// at 9x the tensor-core bound.
//
// Design (FlashAttention-3's structure at head dim 64): one block per
// (192 query rows, head, batch). A producer warpgroup (registers given back
// with setmaxnreg) loads the Q tile once and then K and V tiles of 128 keys
// by TMA into a ring of 3 stages, each with a "full" mbarrier completed by
// the TMA byte count and an "empty" one released by every consumer. Three
// consumer warpgroups of 64 rows each run S = Q K^T by wgmma m64n128k16
// (both from shared memory, K-major), the online softmax on the
// accumulator fragments with exp2 of logits pre-scaled by log2(e) / 8 (one
// FFMA and one MUFU op per logit), then O += P V by wgmma m64n64k16 with P
// converted in registers to bf16 A fragments and V read N-major through
// the transpose bit (no transposed copy). The consumers run independently,
// so one's softmax overlaps the others' products; three of them (192 rows,
// 160 registers a thread, no spills) did better than two (128 rows, 240
// registers). Overlapping a warpgroup's own softmax with its next S product
// (two S register sets) made ptxas serialize the wgmmas and was slower; a
// fourth ring stage was no faster. The maps are 3D (B H, T, 64): a tile
// past a head's T reads zeros, never the next head's rows; keys at or past
// T are masked to -inf; rows at or past T are computed on zeros and dropped
// by the 3D TMA store of the output, staged in the warpgroup's own rows of
// the Q tile.
#include "hopper.cuh"

namespace {

constexpr int DH = 64;
constexpr int NC = 3;        // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * NC;  // query rows per block
constexpr int BKV = 128;     // keys per tile
constexpr int STAGES = 3;
constexpr int THREADS = 128 * (NC + 1);  // consumers 0..NC-1; producer NC
constexpr int TILE = 128 * DH * 2;       // 16 KB: one K or V tile
constexpr int QTILE = BQ * DH * 2;
constexpr int SMEM = 1024 + QTILE + 2 * STAGES * TILE + (1 + 2 * STAGES) * 8;
// registers a thread: the producer gives back, the consumers take
// (24 x 128 + 160 x 384 <= 65536)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 160;

// a thread's two query rows (a = 16 warp + g, b = a + 8 of its
// warpgroup's 64): running max of raw logits, partial sums, and the last
// tile's correction factor for the output accumulators
struct Rows {
  float m_a, m_b, l_a, l_b, cor_a, cor_b;
};

// start S = Q K^T for one tile of 128 keys (64 rows x 128 keys), committed
__device__ __forceinline__ void start_qk(float (&sc)[64], const uint8_t* qw,
                                         const uint8_t* kt) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_m64n128k16_ss<0>(sc, wgmma_desc(qw + kk * 32, 16, 1024),
                           wgmma_desc(kt + kk * 32, 16, 1024), kk > 0);
  wgmma_commit();
}

// start O += P V for one tile, committed; V (keys x 64) is the N-major B
// operand
__device__ __forceinline__ void start_pv(float (&o)[32],
                                         const uint32_t (&pa)[BKV / 16][4],
                                         const uint8_t* vt) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_m64n64k16_rs<1>(o, pa[kk], wgmma_desc(vt + kk * 2048, TILE, 1024),
                          1);
  wgmma_commit();
}

// mask keys at or past T, update the online softmax and write P as bf16 A
// fragments (the accumulators of key blocks 2kk, 2kk + 1 are the A
// fragment of k16 step kk); the 4 threads of a quad share rows a and b
__device__ __forceinline__ void softmax_tile(float (&sc)[64], int key0, int T,
                                             int t, float scale_log2, Rows& r,
                                             uint32_t (&pa)[BKV / 16][4]) {
  if (key0 + BKV > T) {  // zeros from the map past T
#pragma unroll
    for (int jn = 0; jn < BKV / 8; ++jn) {
      const int kc = key0 + jn * 8 + 2 * t;
      if (kc >= T) sc[4 * jn] = sc[4 * jn + 2] = -INFINITY;
      if (kc + 1 >= T) sc[4 * jn + 1] = sc[4 * jn + 3] = -INFINITY;
    }
  }
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int jn = 0; jn < BKV / 8; ++jn) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * jn], sc[4 * jn + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
  }
#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, d));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, d));
  }
  // every tile holds at least one real key, so the new max is finite
  const float mn_a = fmaxf(r.m_a, mx_a), mn_b = fmaxf(r.m_b, mx_b);
  r.cor_a = exp2f((r.m_a - mn_a) * scale_log2);
  r.cor_b = exp2f((r.m_b - mn_b) * scale_log2);
  r.m_a = mn_a;
  r.m_b = mn_b;
  r.l_a *= r.cor_a;
  r.l_b *= r.cor_b;
  const float off_a = mn_a * scale_log2, off_b = mn_b * scale_log2;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      p[e] = exp2f(fmaf(sc[8 * kk + e], scale_log2,
                        -((e & 2) ? off_b : off_a)));
    r.l_a += p[0] + p[1] + p[4] + p[5];
    r.l_b += p[2] + p[3] + p[6] + p[7];
    pa[kk][0] = pack_bf2(p[0], p[1]);
    pa[kk][1] = pack_bf2(p[2], p[3]);
    pa[kk][2] = pack_bf2(p[4], p[5]);
    pa[kk][3] = pack_bf2(p[6], p[7]);
  }
}

__device__ __forceinline__ void rescale(float (&o)[32], const Rows& r) {
#pragma unroll
  for (int jd = 0; jd < DH / 8; ++jd) {
    o[4 * jd] *= r.cor_a;
    o[4 * jd + 1] *= r.cor_a;
    o[4 * jd + 2] *= r.cor_b;
    o[4 * jd + 3] *= r.cor_b;
  }
}

// maps over (B H, T, 64) bf16 with 128-byte swizzle: q, k, v boxes of
// (64, 128, 1), out boxes of (64, 64, 1)
__global__ void __launch_bounds__(THREADS, 1)
encoder_attn_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mo, int T,
                    float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;
  uint8_t* ks = qs + QTILE;
  uint8_t* vs = ks + STAGES * TILE;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(vs + STAGES * TILE);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y;
  const int n_tiles = (T + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {  // producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      mbar_arrive_expect_tx(qfull, QTILE);
      tma_load_3d(qs, &mq, qfull, 0, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * TILE);
        tma_load_3d(ks + s * TILE, &mk, &full[s], 0, j * BKV, bh);
        tma_load_3d(vs + s * TILE, &mv, &full[s], 0, j * BKV, bh);
      }
    }
  } else {  // consumers: query rows q0 + 64 wg .. + 63
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    uint8_t* qw = qs + wg * 64 * 128;
    float o[32], sc[64];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    Rows r{-INFINITY, -INFINITY, 0.f, 0.f, 1.f, 1.f};
    uint32_t pa[BKV / 16][4];
    mbar_wait(qfull, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      start_qk(sc, qw, ks + s * TILE);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile(sc, j * BKV, T, t, scale_log2, r, pa);
      rescale(o, r);
      start_pv(o, pa, vs + s * TILE);
      wgmma_wait<0>();
      fence_regs(o);
      if (tid == 0) mbar_arrive(&empty[s]);
    }
    float l_a = r.l_a, l_b = r.l_b;

#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, d);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, d);
    }
    const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
    // stage O in this warpgroup's Q rows (no wgmma reads them any more),
    // 128-byte swizzled as the out map expects, then one TMA store
    const int ra = warp * 16 + g, rb = ra + 8;  // ra % 8 == rb % 8 == g
#pragma unroll
    for (int jd = 0; jd < DH / 8; ++jd) {
      const int chunk = (jd ^ g) << 4;
      *reinterpret_cast<uint32_t*>(qw + ra * 128 + chunk + 4 * t) =
          pack_bf2(o[4 * jd] * inv_a, o[4 * jd + 1] * inv_a);
      *reinterpret_cast<uint32_t*>(qw + rb * 128 + chunk + 4 * t) =
          pack_bf2(o[4 * jd + 2] * inv_b, o[4 * jd + 3] * inv_b);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (tid == 0) {
      tma_store_3d(&mo, qw, 0, q0 + wg * 64, bh);
      tma_store_commit_and_wait();
    }
  }
}

}  // namespace

// q, k, v, out: (B, H, T, 64) bf16, contiguous, 16-byte aligned. Returns 0,
// a cudaError_t, or hopper.cuh's tensor-map codes.
extern "C" int aries_encoder_attn(const void* q, const void* k, const void* v,
                                  void* out, int B, int H, int T,
                                  void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  static std::once_flag once[MAX_CARDS];
  static int status[MAX_CARDS];
  const int e = once_per_card(once, status, [] {
    return (int)cudaFuncSetAttribute(
        encoder_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
  });
  if (e) return e;
  const cuuint64_t dims[3] = {DH, (cuuint64_t)T, (cuuint64_t)B * H};
  const cuuint64_t strides[2] = {DH * 2, (cuuint64_t)T * DH * 2};
  const cuuint32_t box[3] = {DH, BKV, 1}, qbox[3] = {DH, BQ, 1},
                   obox[3] = {DH, 64, 1};
  CUtensorMap mq, mk, mv, mo;
  int err;
  if ((err = encode_map(&mq, q, 3, dims, strides, qbox)) ||
      (err = encode_map(&mk, k, 3, dims, strides, box)) ||
      (err = encode_map(&mv, v, 3, dims, strides, box)) ||
      (err = encode_map(&mo, out, 3, dims, strides, obox)))
    return err;
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  encoder_attn_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      mq, mk, mv, mo, T, 0.125f * 1.4426950408889634f /* log2(e)/sqrt(64) */);
  return launch_status();
}
