// Bidirectional encoder attention (flash-style forward).
//
// Replaces: whisper_aries_tpu/models/whisper.py, _flash_attention_pallas
// (the Pallas TPU kernel: per (batch, head, q-block), full K/V per head,
// keys at or past T masked, f32 logits and softmax, probabilities cast to
// V's dtype before P.V).
//
// What it computes: out[b,h,i,:] = softmax_j(q_i . k_j / sqrt(64)) v_j over
// the T real keys, for q, k, v (B, H, T, 64) bf16 -> out (B, H, T, 64) bf16,
// with f32 logits, f32 running max/sum and f32 output accumulators.
//
// Bound on the H100: operations. At (8, 20, 1500, 64) the two products are
// 4 * B * H * T^2 * 64 = 92 GFLOP of bf16 tensor-core work against ~123 MB
// of q/k/v/out traffic.
//
// Design: one block of 4 warps per (q tile of 64 rows, head, batch); each
// warp owns 16 query rows and keeps its Q fragments in registers for the
// whole key loop. K and V tiles of 64 keys are staged in shared memory (V
// transposed, so both products read 32-bit B fragments), and the products
// run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).
// The softmax is online: per-row running max and sum in f32, the output
// accumulator rescaled per tile, so the (T, T) logits never leave registers.
// Keys at or past T are masked in-kernel (-inf), so no x128 padding of T is
// needed; query rows past T are computed on zeros and not stored. The
// unnormalised probabilities are rounded to bf16 for the P.V product (the
// TPU kernel rounds the normalised ones), a difference inside the stated
// tolerance. wgmma/TMA come in a later change.
#include "common.cuh"

namespace {

constexpr int DH = 64;
constexpr int BQ = 64;   // query rows per block (4 warps x 16)
constexpr int BK = 64;   // keys per tile
constexpr int LDS = DH + 8;  // padded smem row (bf16): conflict-free frags
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
encoder_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    int H, int T, float scale) {
  __shared__ __align__(16) bf16 ks[BK][LDS];
  __shared__ __align__(16) bf16 vt[DH][BK + 8];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t head = ((size_t)blockIdx.z * H + blockIdx.y) * T * DH;
  const bf16* qh = q + head;
  const bf16* kh = k + head;
  const bf16* vh = v + head;
  const int r0 = blockIdx.x * BQ + warp * 16;  // this warp's first row

  // Q fragments (A operand, 16 x 64 per warp), pre-scaled by 1/sqrt(64):
  // a power of two, so the bf16 product is exact.
  uint32_t qa[4][4];
  {
    const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c0 = kk * 16 + 2 * t4, c1 = c0 + 8;
      float x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
      if (ra < T) {
        x[0] = bf2f(qh[(size_t)ra * DH + c0]);
        x[1] = bf2f(qh[(size_t)ra * DH + c0 + 1]);
        x[4] = bf2f(qh[(size_t)ra * DH + c1]);
        x[5] = bf2f(qh[(size_t)ra * DH + c1 + 1]);
      }
      if (rb < T) {
        x[2] = bf2f(qh[(size_t)rb * DH + c0]);
        x[3] = bf2f(qh[(size_t)rb * DH + c0 + 1]);
        x[6] = bf2f(qh[(size_t)rb * DH + c1]);
        x[7] = bf2f(qh[(size_t)rb * DH + c1 + 1]);
      }
      qa[kk][0] = pack_bf2(x[0] * scale, x[1] * scale);
      qa[kk][1] = pack_bf2(x[2] * scale, x[3] * scale);
      qa[kk][2] = pack_bf2(x[4] * scale, x[5] * scale);
      qa[kk][3] = pack_bf2(x[6] * scale, x[7] * scale);
    }
  }

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max, rows g / g+8
  float l_a = 0.f, l_b = 0.f;              // this thread's partial sums

  const int n_tiles = (T + BK - 1) / BK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int key0 = tile * BK;
    __syncthreads();  // previous tile's smem reads are done
    // stage K (row-major) and V (transposed): 64 keys x 64 dims, 8 bf16
    // (16 bytes) per load, 4 loads per thread
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int idx = threadIdx.x + it * THREADS;  // 0..511
      const int row = idx >> 3, col = (idx & 7) * 8;
      const int key = key0 + row;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < T) {
        kv = *reinterpret_cast<const uint4*>(kh + (size_t)key * DH + col);
        vv = *reinterpret_cast<const uint4*>(vh + (size_t)key * DH + col);
      }
      *reinterpret_cast<uint4*>(&ks[row][col]) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[col + i][row] = ve[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
            &ks[nt * 8 + g][kk * 16 + 2 * t4]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
            &ks[nt * 8 + g][kk * 16 + 2 * t4 + 8]);
        mma_bf16(s[nt], qa[kk], b0, b1);
      }
    }
    // mask keys at or past T
    if (key0 + BK > T) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int kc = key0 + nt * 8 + 2 * t4;
        if (kc >= T) { s[nt][0] = -INFINITY; s[nt][2] = -INFINITY; }
        if (kc + 1 >= T) { s[nt][1] = -INFINITY; s[nt][3] = -INFINITY; }
      }
    }
    // online softmax: the 4 threads of a quad share rows g and g+8
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    // every tile holds at least one real key, so the new max is finite
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float cor_a = expf(m_a - mn_a), cor_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= cor_a;
    l_b *= cor_b;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o[dt][0] *= cor_a; o[dt][1] *= cor_a;
      o[dt][2] *= cor_b; o[dt][3] *= cor_b;
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = expf(s[nt][0] - mn_a), p1 = expf(s[nt][1] - mn_a);
      const float p2 = expf(s[nt][2] - mn_b), p3 = expf(s[nt][3] - mn_b);
      l_a += p0 + p1;
      l_b += p2 + p3;
      // C fragment of key n-tile nt -> A fragment of k-step nt/2
      const int kk = nt >> 1, hi = (nt & 1) * 2;
      pa[kk][hi + 0] = pack_bf2(p0, p1);
      pa[kk][hi + 1] = pack_bf2(p2, p3);
    }
    // O += P V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
            &vt[dt * 8 + g][kk * 16 + 2 * t4]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
            &vt[dt * 8 + g][kk * 16 + 2 * t4 + 8]);
        mma_bf16(o[dt], pa[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  const int ra = r0 + g, rb = r0 + g + 8;
  bf16* oh = out + head;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + 2 * t4;
    if (ra < T)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)ra * DH + c) =
          __floats2bfloat162_rn(o[dt][0] * inv_a, o[dt][1] * inv_a);
    if (rb < T)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)rb * DH + c) =
          __floats2bfloat162_rn(o[dt][2] * inv_b, o[dt][3] * inv_b);
  }
}

}  // namespace

extern "C" int aries_encoder_attn(const void* q, const void* k, const void* v,
                                  void* out, int B, int H, int T,
                                  void* stream) {
  dim3 grid((T + BQ - 1) / BQ, H, B);
  encoder_attn_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), H, T,
      0.125f /* 1/sqrt(64) */);
  return launch_status();
}
