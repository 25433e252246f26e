// The q-attention micro of the TPU encoder megakernel, in the variants of
// the three TPU probes that took it apart, as one kernel template.
//
// Replaces: scripts/probe_qa_micro.py, scripts/probe_qa_opt.py and
// scripts/probe_qa_bisect.py, `build` (every variant).
// Python: whisper_aries_tpu_torch/scripts/qa_micro.py (launch) and the three
// probe modules of that directory.
//
// What it computes (one micro; H 20 heads, dh 64, bq 128 queries, Tp 1536
// keys of which the first T are real, d = H dh = 1280):
//   lg[h,i,j] = sum_c q[h,c,i] k[h,c,j]                     f32 (bf16 in)
//   masked:   keys j >= T set to f32-min (MASK): by a select on the column
//             (WHERE), by adding a row computed from the column (ROW) or
//             read from rmask[0] (BUF); none (NONE)
//   softmax:  ex = exp(lg - max_j lg) (exp(lg) without MAXSUB), sm = sum_j
//             ex; pr = bf16(ex / sm) (NORM_BEFORE) or bf16(ex) with the
//             division after P.V (NORM_DIV: att / sm, NORM_RCP: att (1 /
//             sm)); NORM_NONE: pr = bf16(lg 1e-3), no mask, no softmax
//   P.V:      PV_IDENT: att[h,i,c] = sum_j pr v (f32), then attT = bf16(att)
//             times a bq x bq identity (a product on the tensor cores, as
//             the TPU body has it); PV_VMAJOR: attT[h,c,i] = sum_j v pr
//             directly
//   attr = bf16(attT) as (d, bq); of = bf16(wo)^T attr (f32), (d, bq)
//   X = of[:8, :128] (PHASE_QK: lg[0, :8, :128]; PHASE_SM: pr[0, :8, :128]
//   from lgbuf in place of lg, no products)
// Iteration it < reps adds (it mod 3 + 1) X to the (8, 128) answer, a
// product rounded and then added (no FMA), in order; with BRANCH the micro
// runs inside `if (it >= gate)` on a runtime `gate` and adds into the
// block's output in device memory each iteration, as the bisect probe's
// pl.when adds into its output ref. Each block also writes a checksum of
// everything its micro computes: sum over it of (it mod 3 + 1) times the
// sum of all of `of` (PHASE_QK: all H bq Tp logits; PHASE_SM: all
// probabilities), in f64 a thread and across the block, so a kernel that
// computed only what X reads would not pass.
//
// Design: the TPU ran the micro on one core over VMEM-resident operands;
// here one block of 8 warps runs it on one SM, REPS times, and the grid is
// the card's SM count, every block on the same operands (9.8 MB, L2-resident
// on a 50 MB L2), so the card is full and each block's answer must be the
// same. A warp owns 16 query rows. Products are mma.sync m16n8k16 (bf16 in,
// f32 sums) with ldmatrix fragments from shared memory: Q (dh-major) and K
// (keys minor) through the transposing ldmatrix, V non-transposed. K and V
// tiles of 64 keys stream through two cp.async stages. The logits of one
// head's 128 queries (786 KB f32) do not fit an SM, so the normalisation
// before P.V takes two passes over K: the first takes each row's max and
// (NORM_BEFORE) its online sum, the second recomputes the logits and forms
// the probabilities with the final max (a flash-style running max would
// round bf16(ex) at other points: not this function). NORM_DIV / RCP with
// MAXSUB take the max in pass 1 and the sum beside P.V in pass 2; without
// MAXSUB, and for NORM_NONE and PHASE_QK, one pass. P stays in registers
// in both layouts: its S accumulator is the A fragment of pr.v (PV_IDENT)
// and the B fragment of v.pr^T (PV_VMAJOR). The identity product stages
// bf16(att) through shared memory. attr (327 KB) does not fit either: it
// goes through a per-block scratch in device memory, read back by the
// O-projection (of^T = attr^T wo, tiles of 64 e x 128 i and 64 e x 128 r,
// wo converted from int8 to bf16 on its way into shared memory).
//
// Bound on the H100: operations. A micro is 2 H bq Tp dh (QK^T, 503 MFLOP)
// + the same for P.V + 2 H dh bq^2 (identity, 42 MFLOP) + 2 d^2 bq (the
// O-projection, 419 MFLOP) = 1.47 GFLOP of bf16 products and H bq Tp =
// 3.9e6 exponentials; the grid runs one micro a block an iteration. The
// second pass recomputes QK^T (and, with NORM_BEFORE, the exponentials).
#include "hopper.cuh"

namespace {

constexpr int H = 20, DH = 64, BQ = 128, TP = 1536, D = H * DH;
constexpr int KT = 64;         // keys a tile
constexpr int NT = TP / KT;    // tiles a head
constexpr int THREADS = 256;   // 8 warps, 16 query rows each
constexpr int KP = KT + 8;     // K / V tile row pitch (bf16): 144 B
constexpr int QP = BQ + 8;     // Q tile and O-projection tile pitch: 272 B
constexpr int AP = DH + 8;     // bf16(att) staging pitch: 144 B
constexpr int OE = 64;         // O-projection: e (reduction) a tile
constexpr int OR = 128;        // O-projection: r a chunk
constexpr float NEGF = -3.40282346638528859811704183484516925e+38f;

enum { MASK_NONE, MASK_WHERE, MASK_ROW, MASK_BUF };
enum { NORM_NONE, NORM_BEFORE, NORM_DIV, NORM_RCP };
enum { PV_IDENT, PV_VMAJOR };
enum { PHASE_ALL, PHASE_QK, PHASE_SM };

// shared memory (bytes); the O-projection's two tiles reuse the K / V stages
constexpr int TILE_B = KT * KP * 2;
constexpr int OFF_K = 0;
constexpr int OFF_V = OFF_K + 2 * TILE_B;
constexpr int OFF_Q = OFF_V + 2 * TILE_B;
constexpr int OFF_ATT = OFF_Q + DH * QP * 2;
constexpr int OFF_RM = OFF_ATT + BQ * AP * 2;
constexpr int OFF_X = OFF_RM + TP * 4;
constexpr int OFF_SUM = OFF_X + 8 * 128 * 4;
constexpr int OFF_RED = OFF_SUM + BQ * 4;
constexpr int SMEM = OFF_RED + 32 * 8;
static_assert(2 * OE * QP * 2 <= 4 * TILE_B, "O-projection tiles");

__device__ __forceinline__ void cp16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(s)),
               "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The A fragment (16 rows m0.., k16 step at k0) of a matrix stored k-major
// ([k][m], m contiguous, pitch P) through the transposing ldmatrix; also
// the two n8 B fragments (n0.., n0 + 8..) of a [k][n] matrix.
template <int P>
__device__ __forceinline__ void frag_a_kmajor(uint32_t (&a)[4], const bf16* s,
                                              int k0, int m0, int lane) {
  ldsm_x4_t(a, s + (k0 + ((lane >> 4) << 3) + (lane & 7)) * P + m0 +
                   ((lane >> 3) & 1) * 8);
}
template <int P>
__device__ __forceinline__ void frag_b_kmajor(uint32_t (&b)[4], const bf16* s,
                                              int k0, int n0, int lane) {
  ldsm_x4_t(b, s + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * P + n0 +
                   (lane >> 4) * 8);
}

// quad (the 4 threads sharing a fragment row) reductions
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the bf16x2 of a 0/1 identity fragment: k, k + 1 against column n
__device__ __forceinline__ uint32_t eye2(int k, int n) {
  return (k == n ? 0x3F80u : 0u) | (k + 1 == n ? 0x3F800000u : 0u);
}

template <int MASK, int NORM, int MAXSUB, int LAYOUT, int PHASE, int BRANCH>
struct Micro {
  static constexpr int PASSES =
      (PHASE == PHASE_QK || NORM == NORM_NONE || !MAXSUB) ? 1 : 2;
  static constexpr bool USE_V = PHASE == PHASE_ALL;

  uint8_t* sm;
  const bf16 *q, *k, *v;
  const int8_t* wo;
  const float* lgb;
  bf16* attr;  // this block's (d, bq) scratch
  int T, warp, lane, g, t;

  __device__ bf16* kbuf(int st) const {
    return reinterpret_cast<bf16*>(sm + OFF_K + st * TILE_B);
  }
  __device__ bf16* vbuf(int st) const {
    return reinterpret_cast<bf16*>(sm + OFF_V + st * TILE_B);
  }
  __device__ bf16* qs() const { return reinterpret_cast<bf16*>(sm + OFF_Q); }
  __device__ bf16* atts() const {
    return reinterpret_cast<bf16*>(sm + OFF_ATT);
  }
  __device__ float* rms() const {
    return reinterpret_cast<float*>(sm + OFF_RM);
  }
  __device__ float* xs() const { return reinterpret_cast<float*>(sm + OFF_X); }
  __device__ float* sums() const {
    return reinterpret_cast<float*>(sm + OFF_SUM);
  }

  // start the loads of attention step s (head, pass, tile) into stage s & 1
  __device__ void load_step(int s) const {
    const int h = s / (PASSES * NT), r = s - h * PASSES * NT;
    const int pass = r / NT, tile = r - pass * NT, st = s & 1;
    const size_t kv0 = (size_t)h * DH * TP + tile * KT;
    for (int c = threadIdx.x; c < KT * 8; c += THREADS) {
      const int row = c >> 3, ch = (c & 7) * 8;
      cp16(kbuf(st) + row * KP + ch, k + kv0 + (size_t)row * TP + ch);
      if (USE_V && pass == PASSES - 1)
        cp16(vbuf(st) + row * KP + ch, v + kv0 + (size_t)row * TP + ch);
    }
    if (r == 0)
      for (int c = threadIdx.x; c < DH * 16; c += THREADS) {
        const int row = c >> 4, ch = (c & 15) * 8;
        cp16(qs() + row * QP + ch, q + (size_t)h * DH * BQ + row * BQ + ch);
      }
    cp_commit();
  }

  // keys at or past T to f32-min, as the variant's mask does it
  __device__ void mask(float (&sc)[8][4], int tile) const {
    if (MASK == MASK_NONE) return;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = tile * KT + nb * 8 + 2 * t + e;
        if (MASK == MASK_WHERE) {
          sc[nb][e] = col < T ? sc[nb][e] : NEGF;
          sc[nb][e + 2] = col < T ? sc[nb][e + 2] : NEGF;
        } else {
          const float rm =
              MASK == MASK_ROW ? (col < T ? 0.f : NEGF) : rms()[col];
          sc[nb][e] += rm;
          sc[nb][e + 2] += rm;
        }
      }
  }

  // rows a = 16 warp + g, b = a + 8: running max and (NORM_BEFORE, SM) sum
  __device__ void stats(const float (&sc)[8][4], float& m_a, float& m_b,
                        float& l_a, float& l_b) const {
    float x_a = NEGF, x_b = NEGF;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      x_a = fmaxf(x_a, fmaxf(sc[nb][0], sc[nb][1]));
      x_b = fmaxf(x_b, fmaxf(sc[nb][2], sc[nb][3]));
    }
    const float n_a = fmaxf(m_a, quad_max(x_a));
    const float n_b = fmaxf(m_b, quad_max(x_b));
    if (NORM == NORM_BEFORE || PHASE == PHASE_SM) {
      float s_a = 0.f, s_b = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        s_a += expf(sc[nb][0] - n_a) + expf(sc[nb][1] - n_a);
        s_b += expf(sc[nb][2] - n_b) + expf(sc[nb][3] - n_b);
      }
      l_a = l_a * expf(m_a - n_a) + s_a;
      l_b = l_b * expf(m_b - n_b) + s_b;
    }
    m_a = n_a;
    m_b = n_b;
  }

  // logits -> probabilities (f32, before their bf16 rounding)
  __device__ void probs(float (&sc)[8][4], float m_a, float m_b, float l_a,
                        float l_b, float& s_a, float& s_b) const {
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (NORM == NORM_NONE) {
          sc[nb][e] = sc[nb][e] * 1e-3f;
          continue;
        }
        const float m = e < 2 ? m_a : m_b;
        const float ex = MAXSUB ? expf(sc[nb][e] - m) : expf(sc[nb][e]);
        if (NORM == NORM_BEFORE) {
          sc[nb][e] = ex / (e < 2 ? l_a : l_b);
        } else {
          sc[nb][e] = ex;
          (e < 2 ? s_a : s_b) += ex;
        }
      }
  }

  // X's part of the logits / probabilities: head 0, rows 0..7, keys 0..127
  __device__ void x_from_rows(const float (&sc)[8][4], int h, int tile) const {
    if (h != 0 || warp != 0 || tile >= 2) return;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      xs()[g * 128 + tile * KT + nb * 8 + 2 * t] = sc[nb][0];
      xs()[g * 128 + tile * KT + nb * 8 + 2 * t + 1] = sc[nb][1];
    }
  }

  // attT rows c = 16 mb + g (+ 8), columns i = 16 warp + 8 nb + 2t (+ 1),
  // as (m = c, n = i) accumulators acc[2 mb + nb], rounded into attr
  __device__ void store_attr(const float (&acc)[8][4], int h) const {
#pragma unroll
    for (int mb = 0; mb < 4; ++mb)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int c = h * DH + mb * 16 + g, i = warp * 16 + nb * 8 + 2 * t;
        const float* a = acc[2 * mb + nb];
        *reinterpret_cast<uint32_t*>(attr + (size_t)c * BQ + i) =
            pack_bf2(a[0], a[1]);
        *reinterpret_cast<uint32_t*>(attr + (size_t)(c + 8) * BQ + i) =
            pack_bf2(a[2], a[3]);
      }
  }

  // the end of head h: the late division, the identity product (PV_IDENT),
  // bf16(attT) into attr
  __device__ void head_out(float (&acc)[8][4], int h, float s_a,
                           float s_b) const {
    if (NORM == NORM_DIV || NORM == NORM_RCP) {
      s_a = quad_sum(s_a);
      s_b = quad_sum(s_b);
    }
    if (LAYOUT == PV_VMAJOR) {
      if (NORM == NORM_DIV) {  // attT[c, i] / sm[i]: i is a column here
        if (t == 0) {
          sums()[warp * 16 + g] = s_a;
          sums()[warp * 16 + g + 8] = s_b;
        }
        __syncwarp();
#pragma unroll
        for (int mb = 0; mb < 4; ++mb)
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[2 * mb + nb][e] /=
                  sums()[warp * 16 + nb * 8 + 2 * t + (e & 1)];
        __syncwarp();
      }
      store_attr(acc, h);
      return;
    }
    const float r_a = 1.f / s_a, r_b = 1.f / s_b;
    const int ra = warp * 16 + g;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      float* a = acc[nb];
      if (NORM == NORM_DIV) {
        a[0] /= s_a, a[1] /= s_a, a[2] /= s_b, a[3] /= s_b;
      } else if (NORM == NORM_RCP) {
        a[0] *= r_a, a[1] *= r_a, a[2] *= r_b, a[3] *= r_b;
      }
      *reinterpret_cast<uint32_t*>(atts() + ra * AP + nb * 8 + 2 * t) =
          pack_bf2(a[0], a[1]);
      *reinterpret_cast<uint32_t*>(atts() + (ra + 8) * AP + nb * 8 + 2 * t) =
          pack_bf2(a[2], a[3]);
    }
    __syncthreads();
    // attT[c, i'] = sum_i bf16(att)[i, c] I[i, i'] for this warp's 16 i'
    float o[8][4];
#pragma unroll
    for (int x = 0; x < 8; ++x) o[x][0] = o[x][1] = o[x][2] = o[x][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t b[2][2];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int n = warp * 16 + nb * 8 + g;
        b[nb][0] = eye2(kk * 16 + 2 * t, n);
        b[nb][1] = eye2(kk * 16 + 8 + 2 * t, n);
      }
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) {
        uint32_t a[4];
        frag_a_kmajor<AP>(a, atts(), kk * 16, mb * 16, lane);
        mma_bf16(o[2 * mb], a, b[0][0], b[0][1]);
        mma_bf16(o[2 * mb + 1], a, b[1][0], b[1][1]);
      }
    }
    store_attr(o, h);
  }

  // the attention of every head into attr (PHASE_ALL), or the logits
  // (PHASE_QK); returns this thread's sum of the logits (PHASE_QK)
  __device__ double attention() const {
    constexpr int STEPS = H * PASSES * NT;
    double csum = 0.0;
    uint32_t qa[4][4];
    float acc[8][4];
    float m_a = NEGF, m_b = NEGF, l_a = 0.f, l_b = 0.f, s_a = 0.f, s_b = 0.f;
    load_step(0);
    for (int s = 0; s < STEPS; ++s) {
      if (s + 1 < STEPS)
        load_step(s + 1);
      else
        cp_commit();
      cp_wait<1>();
      __syncthreads();
      const int h = s / (PASSES * NT), r = s - h * PASSES * NT;
      const int pass = r / NT, tile = r - pass * NT, st = s & 1;
      if (r == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          frag_a_kmajor<QP>(qa[kk], qs(), kk * 16, warp * 16, lane);
#pragma unroll
        for (int x = 0; x < 8; ++x)
          acc[x][0] = acc[x][1] = acc[x][2] = acc[x][3] = 0.f;
        m_a = m_b = -INFINITY;
        l_a = l_b = s_a = s_b = 0.f;
      }
      float sc[8][4];
#pragma unroll
      for (int x = 0; x < 8; ++x)
        sc[x][0] = sc[x][1] = sc[x][2] = sc[x][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          frag_b_kmajor<KP>(b, kbuf(st), kk * 16, np * 16, lane);
          mma_bf16(sc[2 * np], qa[kk], b[0], b[1]);
          mma_bf16(sc[2 * np + 1], qa[kk], b[2], b[3]);
        }
      if (PHASE == PHASE_QK) {
        float p = 0.f;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          p += (sc[nb][0] + sc[nb][1]) + (sc[nb][2] + sc[nb][3]);
        csum += p;
        x_from_rows(sc, h, tile);
      } else {
        mask(sc, tile);
        if (PASSES == 2 && pass == 0) {
          stats(sc, m_a, m_b, l_a, l_b);
          if (tile == NT - 1 && NORM == NORM_BEFORE) {
            l_a = quad_sum(l_a);
            l_b = quad_sum(l_b);
          }
        } else {
          probs(sc, m_a, m_b, l_a, l_b, s_a, s_b);
          const bf16* vb = vbuf(st);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float(&s0)[4] = sc[2 * kk], (&s1)[4] = sc[2 * kk + 1];
            const uint32_t p_lo[2] = {pack_bf2(s0[0], s0[1]),
                                      pack_bf2(s1[0], s1[1])};
            const uint32_t p_hi[2] = {pack_bf2(s0[2], s0[3]),
                                      pack_bf2(s1[2], s1[3])};
            if (LAYOUT == PV_IDENT) {  // att (i, c) += pr (i, j) v (j, c)
              const uint32_t a[4] = {p_lo[0], p_hi[0], p_lo[1], p_hi[1]};
#pragma unroll
              for (int np = 0; np < 4; ++np) {
                uint32_t b[4];
                const int row = np * 16 + ((lane >> 4) << 3) + (lane & 7);
                ldsm_x4(b, vb + row * KP + kk * 16 + ((lane >> 3) & 1) * 8);
                mma_bf16(acc[2 * np], a, b[0], b[1]);
                mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
              }
            } else {  // attT (c, i) += v (c, j) pr^T (j, i)
#pragma unroll
              for (int mb = 0; mb < 4; ++mb) {
                uint32_t a[4];
                const int row = mb * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
                ldsm_x4(a, vb + row * KP + kk * 16 + (lane >> 4) * 8);
                mma_bf16(acc[2 * mb], a, p_lo[0], p_lo[1]);
                mma_bf16(acc[2 * mb + 1], a, p_hi[0], p_hi[1]);
              }
            }
          }
          if (tile == NT - 1) head_out(acc, h, s_a, s_b);
        }
      }
      __syncthreads();
    }
    return csum;
  }

  // softmax only, on lgbuf (PHASE_SM); returns this thread's sum of the
  // probabilities
  __device__ double softmax_only() const {
    double csum = 0.0;
    for (int h = 0; h < H; ++h) {
      float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
      float s_a = 0.f, s_b = 0.f;
      const float* rows = lgb + ((size_t)h * BQ + warp * 16 + g) * TP;
      for (int pass = 0; pass < 2; ++pass) {
        for (int tile = 0; tile < NT; ++tile) {
          float sc[8][4];
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int j = tile * KT + nb * 8 + 2 * t;
            const float2 x = *reinterpret_cast<const float2*>(rows + j);
            const float2 y =
                *reinterpret_cast<const float2*>(rows + 8 * TP + j);
            sc[nb][0] = x.x, sc[nb][1] = x.y, sc[nb][2] = y.x, sc[nb][3] = y.y;
          }
          mask(sc, tile);
          if (pass == 0) {
            stats(sc, m_a, m_b, l_a, l_b);
            continue;
          }
          probs(sc, m_a, m_b, l_a, l_b, s_a, s_b);
          float p = 0.f;
#pragma unroll
          for (int nb = 0; nb < 8; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sc[nb][e] = round_bf(sc[nb][e]);
              p += sc[nb][e];
            }
          csum += p;
          x_from_rows(sc, h, tile);
        }
        if (pass == 0) {
          l_a = quad_sum(l_a);
          l_b = quad_sum(l_b);
        }
      }
    }
    return csum;
  }

  // of^T (i, r) = attr^T (i, e) bf16(wo) (e, r): warps 4 (i, 32 each) x 2
  // (r, 64 each) over chunks of 128 r; returns this thread's sum of `of`
  __device__ double oproj() const {
    bf16* at_s = kbuf(0);            // (OE e) x (BQ i), pitch QP
    bf16* wo_s = at_s + OE * QP;     // (OE e) x (OR r), pitch QP
    const int wi = warp & 3, wr = warp >> 2;
    double csum = 0.0;
    for (int rc = 0; rc < D / OR; ++rc) {
      float oc[2][8][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          oc[mb][nb][0] = oc[mb][nb][1] = oc[mb][nb][2] = oc[mb][nb][3] = 0.f;
      uint4 ra[4], rw[2];
      // 16-byte chunk x of a thread: attr rows of 16 chunks (8 bf16), wo
      // rows of 8 chunks (16 int8)
      auto load = [&](int et) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int c = threadIdx.x + x * THREADS;
          ra[x] = *reinterpret_cast<const uint4*>(
              attr + (size_t)(et * OE + (c >> 4)) * BQ + (c & 15) * 8);
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int c = threadIdx.x + x * THREADS;
          rw[x] = *reinterpret_cast<const uint4*>(
              wo + (size_t)(et * OE + (c >> 3)) * D + rc * OR + (c & 7) * 16);
        }
      };
      auto store = [&]() {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int c = threadIdx.x + x * THREADS;
          *reinterpret_cast<uint4*>(at_s + (c >> 4) * QP + (c & 15) * 8) =
              ra[x];
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int c = threadIdx.x + x * THREADS;
          const int8_t* b = reinterpret_cast<const int8_t*>(&rw[x]);
          uint32_t w[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            w[j] = pack_bf2((float)b[2 * j], (float)b[2 * j + 1]);
          uint4* dst =
              reinterpret_cast<uint4*>(wo_s + (c >> 3) * QP + (c & 7) * 16);
          dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
          dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
        }
      };
      load(0);
      store();
      __syncthreads();
      for (int et = 0; et < D / OE; ++et) {
        if (et + 1 < D / OE) load(et + 1);
#pragma unroll
        for (int kk = 0; kk < OE / 16; ++kk) {
          uint32_t a[2][4];
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
            frag_a_kmajor<QP>(a[mb], at_s, kk * 16, wi * 32 + mb * 16, lane);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            frag_b_kmajor<QP>(b, wo_s, kk * 16, wr * 64 + np * 16, lane);
#pragma unroll
            for (int mb = 0; mb < 2; ++mb) {
              mma_bf16(oc[mb][2 * np], a[mb], b[0], b[1]);
              mma_bf16(oc[mb][2 * np + 1], a[mb], b[2], b[3]);
            }
          }
        }
        __syncthreads();
        if (et + 1 < D / OE) {
          store();
          __syncthreads();
        }
      }
      float p = 0.f;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
          p += (oc[mb][nb][0] + oc[mb][nb][1]) +
               (oc[mb][nb][2] + oc[mb][nb][3]);
      csum += p;
      if (rc == 0 && wr == 0)  // X = of[r < 8, i]: the first n8 block
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          const int i = wi * 32 + mb * 16 + g;
          xs()[(2 * t) * 128 + i] = oc[mb][0][0];
          xs()[(2 * t + 1) * 128 + i] = oc[mb][0][1];
          xs()[(2 * t) * 128 + i + 8] = oc[mb][0][2];
          xs()[(2 * t + 1) * 128 + i + 8] = oc[mb][0][3];
        }
    }
    return csum;
  }

  // one micro: X into xs; returns this thread's part of the checksum
  __device__ double run() const {
    double c;
    if (PHASE == PHASE_SM) {
      c = softmax_only();
    } else if (PHASE == PHASE_QK) {
      c = attention();
    } else {
      attention();
      __syncthreads();  // attr written
      c = oproj();
    }
    __syncthreads();  // xs written
    return c;
  }
};

template <int MASK, int NORM, int MAXSUB, int LAYOUT, int PHASE, int BRANCH>
__global__ void __launch_bounds__(THREADS, 1)
qa_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const int8_t* __restrict__ wo,
          const float* __restrict__ lgb, const float* __restrict__ rmask,
          int T, int reps, int gate, bf16* __restrict__ attr_all,
          float* __restrict__ out, double* __restrict__ checksum) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Micro<MASK, NORM, MAXSUB, LAYOUT, PHASE, BRANCH> m;
  m.sm = smem_raw;
  m.q = q, m.k = k, m.v = v, m.wo = wo, m.lgb = lgb;
  m.attr = attr_all + (size_t)blockIdx.x * D * BQ;
  m.T = T;
  m.warp = threadIdx.x >> 5, m.lane = threadIdx.x & 31;
  m.g = m.lane >> 2, m.t = m.lane & 3;
  if (MASK == MASK_BUF)
    for (int j = threadIdx.x; j < TP; j += THREADS) m.rms()[j] = rmask[j];
  float* o = out + (size_t)blockIdx.x * 8 * 128;
  float carry[4] = {0.f, 0.f, 0.f, 0.f};
  if (BRANCH)
    for (int e = 0; e < 4; ++e) o[threadIdx.x + e * THREADS] = 0.f;
  __syncthreads();
  double csum = 0.0;
  for (int it = 0; it < reps; ++it) {
    if (BRANCH && it < gate) continue;
    const float w = (float)(it % 3 + 1);
    csum += (double)w * m.run();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = threadIdx.x + e * THREADS;
      const float add = __fmul_rn(m.xs()[x], w);
      if (BRANCH)
        o[x] = __fadd_rn(o[x], add);
      else
        carry[e] = __fadd_rn(carry[e], add);
    }
    __syncthreads();  // xs read before the next micro writes it
  }
  if (!BRANCH)
    for (int e = 0; e < 4; ++e) o[threadIdx.x + e * THREADS] = carry[e];
  // the block's checksum: warp sums, then the 8 warps in order
  double* red = reinterpret_cast<double*>(smem_raw + OFF_RED);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    csum += __shfl_xor_sync(0xffffffffu, csum, d);
  __syncthreads();
  if (m.lane == 0) red[m.warp] = csum;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int x = 0; x < THREADS / 32; ++x) s += red[x];
    checksum[blockIdx.x] = s;
  }
}

template <int MASK, int NORM, int MAXSUB, int LAYOUT, int PHASE, int BRANCH>
int launch_qa(const void* q, const void* k, const void* v, const void* wo,
              const void* lgb, const void* rmask, int T, int reps, int gate,
              int blocks, void* attr, float* out, double* checksum,
              cudaStream_t st) {
  auto kern = qa_kernel<MASK, NORM, MAXSUB, LAYOUT, PHASE, BRANCH>;
  static bool configured = false;  // the attribute is set once a process
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return ERR_ATTRIBUTE + (int)e;
    configured = true;
  }
  kern<<<blocks, THREADS, SMEM, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int8_t*>(wo),
      static_cast<const float*>(lgb), static_cast<const float*>(rmask), T,
      reps, gate, static_cast<bf16*>(attr), out, checksum);
  return launch_status();
}

}  // namespace

// The instantiations: one per distinct (mask, norm, max subtraction,
// P.V layout, phases, branch) of the 17 TPU variants (the Python mirror is
// scripts/qa_micro.py's variant table).
#define QA_VARIANTS(X)                                   \
  X(MASK_WHERE, NORM_BEFORE, 1, PV_IDENT, PHASE_ALL, 0)  \
  X(MASK_ROW, NORM_BEFORE, 1, PV_IDENT, PHASE_ALL, 0)    \
  X(MASK_NONE, NORM_NONE, 0, PV_IDENT, PHASE_ALL, 0)     \
  X(MASK_WHERE, NORM_BEFORE, 1, PV_IDENT, PHASE_SM, 0)   \
  X(MASK_NONE, NORM_NONE, 0, PV_IDENT, PHASE_QK, 0)      \
  X(MASK_BUF, NORM_BEFORE, 1, PV_VMAJOR, PHASE_ALL, 0)   \
  X(MASK_BUF, NORM_DIV, 1, PV_VMAJOR, PHASE_ALL, 0)      \
  X(MASK_BUF, NORM_DIV, 0, PV_VMAJOR, PHASE_ALL, 0)      \
  X(MASK_WHERE, NORM_BEFORE, 1, PV_IDENT, PHASE_ALL, 1)  \
  X(MASK_ROW, NORM_BEFORE, 1, PV_IDENT, PHASE_ALL, 1)    \
  X(MASK_BUF, NORM_BEFORE, 1, PV_IDENT, PHASE_ALL, 1)    \
  X(MASK_WHERE, NORM_RCP, 1, PV_IDENT, PHASE_ALL, 1)     \
  X(MASK_WHERE, NORM_DIV, 1, PV_IDENT, PHASE_ALL, 1)     \
  X(MASK_BUF, NORM_RCP, 1, PV_IDENT, PHASE_ALL, 1)

extern "C" {

// q (20, 64, 128), k and v (20, 64, 1536) bf16; wo (1280, 1280) int8; lgb
// (20, 128, 1536) f32 (PHASE_SM, else may be null); rmask (>= 1, 1536) f32
// (MASK_BUF, else may be null); attr (blocks, 1280, 128) bf16 scratch; out
// (blocks, 8, 128) f32; checksum (blocks,) f64. The flags take the enums'
// values above. Returns 0, a cudaError_t, ERR_BAD_ARGS for arguments or a
// flag tuple that is not instantiated, or ERR_ATTRIBUTE + the cudaError_t.
int aries_probe_qa(const void* q, const void* k, const void* v, const void* wo,
                   const void* lgb, const void* rmask, int mask, int norm,
                   int max_sub, int layout, int phase, int branch, int T,
                   int reps, int gate, int blocks, void* attr, float* out,
                   double* checksum, void* stream) {
  if (T <= 0 || T > TP || reps <= 0 || blocks <= 0 ||
      (phase == PHASE_SM && lgb == nullptr) ||
      (mask == MASK_BUF && rmask == nullptr))
    return ERR_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
#define QA_DISPATCH(M, N, X, L, P, B)                                        \
  if (mask == M && norm == N && max_sub == X && layout == L && phase == P && \
      branch == B)                                                           \
    return launch_qa<M, N, X, L, P, B>(q, k, v, wo, lgb, rmask, T, reps,     \
                                       gate, blocks, attr, out, checksum, st);
  QA_VARIANTS(QA_DISPATCH)
#undef QA_DISPATCH
  return ERR_BAD_ARGS;
}

}  // extern "C"
