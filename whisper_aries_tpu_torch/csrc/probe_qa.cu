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
// here one block runs it on one SM, REPS times, and the grid is the card's
// SM count, every block on the same operands (9.8 MB, L2-resident on a 50
// MB L2), so the card is full and each block's answer must be the same.
// The block is three warpgroups: two consumers of 64 queries each and a
// producer (registers given back with setmaxnreg). Every product runs on
// wgmma (bf16 in, f32 sums) from 128-byte-swizzled tiles:
//   * The producer keeps a ring of 4 stages of 32 KB full: a head's Q (two
//     64 x 64 boxes, one per consumer, double-buffered by head) and each
//     128-key tile of K (and, in the pass that forms P.V, of V) by TMA,
//     each stage's "full" mbarrier completed by the byte count and its
//     "empty" one by both consumers; for the O-projection, a 64-row tile
//     of attr for each consumer by TMA beside 64 x 128 of wo, which the
//     producer's 128 threads convert from int8 to bf16 on its way into the
//     stage.
//   * QK^T: m64n128k16 from shared memory, Q (dh-major) as the MN-major A
//     and K (keys minor) as the MN-major B: the transpose bits, no copies.
//     The logits land in rows g and g + 8 of each warp's 16, keys 2t,
//     2t + 1 of each 8 (mma.sync's accumulator layout), so the mask, the
//     max, the sums and the probabilities are per-thread code.
//     Normalising before P.V divides each numerator by its row's sum: by
//     div_by_row (the row's reciprocal, a product and two fused
//     corrections: bit for bit the IEEE quotient, without a division or a
//     branch a logit; IEEE division took 40% of the full variant's time).
//   * P.V, PV_IDENT: att (i, c) += P V with P in registers as the A
//     operand (m64n64k16 RS) and V (keys minor) as the K-major B. The
//     identity product attT (c, i) = bf16(att)^T I runs as its transpose,
//     (i', c) = I (i', i) bf16(att) (i, c): the identity's fragments in
//     registers as A, bf16(att) of both consumers' 128 queries staged in
//     shared memory as the MN-major B (the same exact sums).
//   * P.V, PV_VMAJOR: attT (c, i) += V P^T with V as the K-major A, so P^T
//     is the B operand and must be in shared memory: each consumer writes
//     its bf16 P tile (64 queries x 128 keys) there every tile, then one
//     barrier of its warpgroup, then the product.
//   * A tile's P.V stays in flight while the next tile's QK^T is issued;
//     that QK^T's wait completes both (one wait a tile, not two), and the
//     stage is released behind it.
//   * attr (327 KB) does not fit an SM: it goes through a per-block
//     scratch in device memory ((bq, d) for PV_IDENT, (d, bq) for
//     PV_VMAJOR, the layouts the consumers write in rows), fenced for the
//     async proxy and announced to the producer by an mbarrier, which then
//     loads it by TMA. The O-projection is of^T (i, r) = attr^T (i, e)
//     bf16(wo) (e, r): m64n128k16, attr as A (K-major or MN-major by
//     layout), wo as the MN-major B, one 128-column chunk of r at a time.
// The logits of one head's 128 queries (786 KB f32) do not fit an SM, so
// the normalisation before P.V takes two passes over K: the first takes
// each row's max and (NORM_BEFORE) its online sum, the second recomputes
// the logits and forms the probabilities with the final max (a
// flash-style running max would round bf16(ex) at other points: not this
// function). NORM_DIV / RCP with MAXSUB take the max in pass 1 and the sum
// beside P.V in pass 2; without MAXSUB, and for NORM_NONE and PHASE_QK,
// one pass. PHASE_SM (no products) runs on the consumers alone.
//
// Bound on the H100: operations. A micro is 2 H bq Tp dh (QK^T, 503 MFLOP)
// + the same for P.V + 2 H dh bq^2 (identity, 42 MFLOP) + 2 d^2 bq (the
// O-projection, 419 MFLOP) = 1.47 GFLOP of bf16 products and H bq Tp =
// 3.9e6 exponentials; the grid runs one micro a block an iteration. The
// second pass recomputes QK^T (and, with NORM_BEFORE, the exponentials).
#include "hopper.cuh"

namespace {

constexpr int H = 20, DH = 64, BQ = 128, TP = 1536, D = H * DH;
constexpr int KT = 128;                   // keys a tile (a ring stage)
constexpr int NB = 8;                     // n8 key blocks a softmax part
constexpr int NT = TP / KT;               // tiles a head
constexpr int NC = 2;                     // consumer warpgroups
constexpr int CONSUMERS = 128 * NC;       // 8 warps, 16 query rows each
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int STAGES = 4;
constexpr int BOX = 64 * 64 * 2;  // 8 KB: a 64 x 64 bf16 swizzled tile
constexpr int STAGE = 4 * BOX;    // K, V (128 keys) | attr x 2, wo
constexpr int QBUF = 2 * BOX;     // a head's Q, one box per consumer
constexpr int OE = 64;            // O-projection: e (reduction) a tile
constexpr int OR = 128;           // O-projection: r a chunk
constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 216;
constexpr float NEGF = -3.40282346638528859811704183484516925e+38f;

// named barriers (0 is __syncthreads, used before the roles split only)
constexpr int BAR_WG = 1;         // + wg: one consumer warpgroup
constexpr int BAR_CONSUMERS = 3;  // both consumer warpgroups
constexpr int BAR_PRODUCER = 4;

enum { MASK_NONE, MASK_WHERE, MASK_ROW, MASK_BUF };
enum { NORM_NONE, NORM_BEFORE, NORM_DIV, NORM_RCP };
enum { PV_IDENT, PV_VMAJOR };
enum { PHASE_ALL, PHASE_QK, PHASE_SM };

// shared memory (bytes from a 1024-byte boundary)
constexpr int OFF_Q = STAGES * STAGE;
constexpr int OFF_T = OFF_Q + 2 * QBUF;  // bf16(att) (128 rows) or P x 2
constexpr int OFF_RM = OFF_T + 2 * BOX;
constexpr int OFF_X = OFF_RM + TP * 4;
constexpr int OFF_SUM = OFF_X + 8 * 128 * 4;
constexpr int OFF_RED = OFF_SUM + BQ * 4;
constexpr int OFF_BAR = OFF_RED + 32 * 8;
// full[STAGES], empty[STAGES], qfull[2], qempty[2], attr_ready
constexpr int NBAR = 2 * STAGES + 5;
constexpr int SMEM = 1024 + OFF_BAR + NBAR * 8;

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

// an [N][4] accumulator (n8 block, element) as wgmma's flat one
template <int N>
__device__ __forceinline__ float (&flat(float (&a)[N][4]))[4 * N] {
  return *reinterpret_cast<float(*)[4 * N]>(&a[0][0]);
}

// a / b rounded to nearest even, from r = 1 / b (rounded to nearest even,
// once a row): one product and two corrections by fused multiply-adds
// (Markstein: the first makes the quotient faithful, the second correctly
// rounded). For a = 0 or 0x1p-100 <= a <= 1 and b >= 1 (a probability's
// numerator over its row sum) it is bit for bit a / b, without a division
// and without a branch; smaller a, where the residuals could underflow,
// take IEEE division (div_tiny, below).
__device__ __forceinline__ float div_by_row(float a, float b, float r) {
  float q = __fmul_rn(a, r);
  q = __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
  return __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
}
__device__ __forceinline__ bool div_tiny(float a) {
  return a != 0.f && a < 0x1p-100f;
}

// a thread's 32-bit bf16 pair at (row, byte column) of a 128-byte-swizzled
// tile of 128-byte rows
__device__ __forceinline__ uint32_t* swz(uint8_t* tile, int row, int col) {
  return reinterpret_cast<uint32_t*>(
      tile + row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15));
}

struct Bars {
  uint64_t *full, *empty, *qfull, *qempty, *attr_ready;
};

template <int MASK, int NORM, int MAXSUB, int LAYOUT, int PHASE, int BRANCH>
struct Micro {
  static constexpr int PASSES =
      (PHASE == PHASE_QK || NORM == NORM_NONE || !MAXSUB) ? 1 : 2;
  static constexpr bool USE_V = PHASE == PHASE_ALL;

  uint8_t* sm;  // 1024-byte aligned
  Bars bar;
  const int8_t* wo;
  const float* lgb;
  bf16* attr;  // this block's scratch: (bq, d) PV_IDENT, (d, bq) PV_VMAJOR
  int T;
  // consumers: thread ct (0..255), warpgroup wg, warp (0..7) and its
  // index w in the warpgroup, fragment coordinates g, t
  int ct, wg, warp, w, lane, g, t;
  // uses of the ring, heads loaded, O-projections run (mbarrier phases)
  unsigned n = 0, hc = 0, itc = 0;

  __device__ uint8_t* stage(unsigned i) const {
    return sm + (i % STAGES) * STAGE;
  }
  __device__ float* rms() const {
    return reinterpret_cast<float*>(sm + OFF_RM);
  }
  __device__ float* xs() const { return reinterpret_cast<float*>(sm + OFF_X); }
  __device__ float* sums() const {
    return reinterpret_cast<float*>(sm + OFF_SUM);
  }
  __device__ void wait_full(unsigned i) const {
    mbar_wait(&bar.full[i % STAGES], (i / STAGES) & 1);
  }
  __device__ void release(unsigned i) const {  // one arrival a warpgroup
    if ((ct & 127) == 0) mbar_arrive(&bar.empty[i % STAGES]);
  }

  // keys at or past T to f32-min, as the variant's mask does it
  __device__ void mask(float (&sc)[NB][4], int key0) const {
    if (MASK == MASK_NONE) return;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = key0 + nb * 8 + 2 * t + e;
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
  __device__ void stats(const float (&sc)[NB][4], float& m_a, float& m_b,
                        float& l_a, float& l_b) const {
    float x_a = NEGF, x_b = NEGF;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      x_a = fmaxf(x_a, fmaxf(sc[nb][0], sc[nb][1]));
      x_b = fmaxf(x_b, fmaxf(sc[nb][2], sc[nb][3]));
    }
    const float n_a = fmaxf(m_a, quad_max(x_a));
    const float n_b = fmaxf(m_b, quad_max(x_b));
    if (NORM == NORM_BEFORE || PHASE == PHASE_SM) {
      float s_a = 0.f, s_b = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        s_a += expf(sc[nb][0] - n_a) + expf(sc[nb][1] - n_a);
        s_b += expf(sc[nb][2] - n_b) + expf(sc[nb][3] - n_b);
      }
      l_a = l_a * expf(m_a - n_a) + s_a;
      l_b = l_b * expf(m_b - n_b) + s_b;
    }
    m_a = n_a;
    m_b = n_b;
  }

  // logits -> probabilities (f32, before their bf16 rounding); r_a, r_b:
  // 1 / l_a, 1 / l_b (NORM_BEFORE). The division by the row's sum is
  // div_by_row; a warp holding a numerator it does not cover divides all
  // its numerators by IEEE division instead (a branch the warp takes as
  // one, so the fast path carries no division).
  __device__ void probs(float (&sc)[NB][4], float m_a, float m_b, float l_a,
                        float l_b, float r_a, float r_b, float& s_a,
                        float& s_b) const {
    bool tiny = false;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (NORM == NORM_NONE) {
          sc[nb][e] = sc[nb][e] * 1e-3f;
          continue;
        }
        const float m = e < 2 ? m_a : m_b;
        const float ex = MAXSUB ? expf(sc[nb][e] - m) : expf(sc[nb][e]);
        sc[nb][e] = ex;
        if (NORM == NORM_BEFORE)
          tiny |= div_tiny(ex);
        else
          (e < 2 ? s_a : s_b) += ex;
      }
    if (NORM != NORM_BEFORE) return;
    if (__any_sync(0xffffffffu, tiny)) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nb][e] /= e < 2 ? l_a : l_b;
      return;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[nb][e] = e < 2 ? div_by_row(sc[nb][e], l_a, r_a)
                          : div_by_row(sc[nb][e], l_b, r_b);
  }

  // X's part of the logits / probabilities: head 0, rows 0..7, keys 0..127
  // (sc holds keys key0 ..)
  template <int N>
  __device__ void x_from_rows(const float (&sc)[N][4], int h,
                              int key0) const {
    if (h != 0 || warp != 0 || key0 >= 128) return;
#pragma unroll
    for (int nb = 0; nb < N; ++nb) {
      if (key0 + nb * 8 >= 128) break;
      xs()[g * 128 + key0 + nb * 8 + 2 * t] = sc[nb][0];
      xs()[g * 128 + key0 + nb * 8 + 2 * t + 1] = sc[nb][1];
    }
  }

  // sc = the logits of this warpgroup's 64 queries against 8 N keys from
  // kt (N 8: one 64-key box; N 16: the stage's two): Q (c, i) and K (c, j)
  // both MN-major. The wait also completes a P.V still in flight.
  template <int N>
  __device__ void qk(float (&sc)[N][4], const uint8_t* qw,
                     const uint8_t* kt) const {
    fence_regs(flat(sc));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint64_t da = wgmma_desc(qw + kk * 2048, BOX, 1024);
      const uint64_t db = wgmma_desc(kt + kk * 2048, BOX, 1024);
      if constexpr (N == 16)
        wgmma_m64n128k16_ss<1, 1>(flat(sc), da, db, kk > 0);
      else
        wgmma_m64n64k16_ss<1, 1>(flat(sc), da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(flat(sc));
  }

  // start acc += P.V over the 64 keys of one V box (PV_IDENT: att (i, c);
  // PV_VMAJOR: attT (c, i)), P the bf16 rounding of sc; committed, not
  // waited for: the next QK^T's wait completes it. pa (PV_IDENT's
  // register operand) and acc stay untouched until then.
  __device__ void pv(float (&acc)[8][4], const float (&sc)[NB][4],
                     uint32_t (&pa)[4][4], const uint8_t* vb) const {
    if (LAYOUT == PV_IDENT) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf2(sc[2 * kk][0], sc[2 * kk][1]);
        pa[kk][1] = pack_bf2(sc[2 * kk][2], sc[2 * kk][3]);
        pa[kk][2] = pack_bf2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pa[kk][3] = pack_bf2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      }
      fence_regs(flat(acc));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // V (c, j): the K-major B
        wgmma_m64n64k16_rs<0>(flat(acc), pa[kk],
                              wgmma_desc(vb + kk * 32, 16, 1024), 1);
    } else {
      // P (this warpgroup's 64 queries x 64 keys) into shared memory, the
      // K-major B of attT (c, i) += V (c, j) P^T (j, i)
      uint8_t* pb = sm + OFF_T + wg * BOX;
      const int ra = 16 * w + g, rb = ra + 8;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        *swz(pb, ra, 16 * nb + 4 * t) = pack_bf2(sc[nb][0], sc[nb][1]);
        *swz(pb, rb, 16 * nb + 4 * t) = pack_bf2(sc[nb][2], sc[nb][3]);
      }
      fence_proxy_async();
      named_barrier(BAR_WG + wg, 128);
      fence_regs(flat(acc));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss<0, 0>(flat(acc), wgmma_desc(vb + kk * 32, 16, 1024),
                                 wgmma_desc(pb + kk * 32, 16, 1024), 1);
    }
    wgmma_commit();
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
      // acc (c = 16 w + g [+ 8], i = 64 wg + 8 nb + 2t [+ 1])
      const int i0 = 64 * wg;
      if (NORM == NORM_DIV) {  // attT[c, i] / sm[i]: i is a column here
        if (t == 0) {
          sums()[i0 + 16 * w + g] = s_a;
          sums()[i0 + 16 * w + g + 8] = s_b;
        }
        named_barrier(BAR_WG + wg, 128);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[nb][e] /= sums()[i0 + nb * 8 + 2 * t + (e & 1)];
        named_barrier(BAR_WG + wg, 128);
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int c = h * DH + 16 * w + g, i = i0 + nb * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(attr + (size_t)c * BQ + i) =
            pack_bf2(acc[nb][0], acc[nb][1]);
        *reinterpret_cast<uint32_t*>(attr + (size_t)(c + 8) * BQ + i) =
            pack_bf2(acc[nb][2], acc[nb][3]);
      }
      return;
    }
    // acc (i = 64 wg + 16 w + g [+ 8], c = 8 nb + 2t [+ 1]) -> bf16 into
    // the (128 i, 64 c) tile
    const float r_a = 1.f / s_a, r_b = 1.f / s_b;
    const int ia = 64 * wg + 16 * w + g, ib = ia + 8;
    uint8_t* tb = sm + OFF_T;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      float* a = acc[nb];
      if (NORM == NORM_DIV) {
        a[0] /= s_a, a[1] /= s_a, a[2] /= s_b, a[3] /= s_b;
      } else if (NORM == NORM_RCP) {
        a[0] *= r_a, a[1] *= r_a, a[2] *= r_b, a[3] *= r_b;
      }
      *swz(tb, ia, 16 * nb + 4 * t) = pack_bf2(a[0], a[1]);
      *swz(tb, ib, 16 * nb + 4 * t) = pack_bf2(a[2], a[3]);
    }
    fence_proxy_async();
    named_barrier(BAR_CONSUMERS, CONSUMERS);
    // (i', c) = sum over all 128 i of I (i', i) bf16(att) (i, c): the
    // identity's rows i' of this warpgroup as register A fragments
    float o[8][4];
#pragma unroll
    for (int x = 0; x < 8; ++x) o[x][0] = o[x][1] = o[x][2] = o[x][3] = 0.f;
    fence_regs(flat(o));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t a[4] = {eye2(16 * kk + 2 * t, ia), eye2(16 * kk + 2 * t, ib),
                             eye2(16 * kk + 8 + 2 * t, ia),
                             eye2(16 * kk + 8 + 2 * t, ib)};
      wgmma_m64n64k16_rs<1>(flat(o), a, wgmma_desc(tb + kk * 2048, BOX, 1024),
                            1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(flat(o));
    named_barrier(BAR_CONSUMERS, CONSUMERS);  // tb read by both
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int c = h * DH + nb * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(attr + (size_t)ia * D + c) =
          pack_bf2(o[nb][0], o[nb][1]);
      *reinterpret_cast<uint32_t*>(attr + (size_t)ib * D + c) =
          pack_bf2(o[nb][2], o[nb][3]);
    }
  }

  // the attention of every head into attr (PHASE_ALL), or the logits
  // (PHASE_QK); returns this thread's sum of the logits (PHASE_QK). A
  // stage's 128 keys are taken in one product for the logits alone and in
  // two 64-key parts where a softmax follows.
  __device__ double attention() {
    constexpr int QN = PHASE == PHASE_QK ? 2 * NB : NB;  // n8 blocks a part
    constexpr int PARTS = KT / (8 * QN);
    double csum = 0.0;
    float acc[8][4], sc[QN][4];
    uint32_t pa[4][4];
#pragma unroll
    for (int x = 0; x < QN; ++x)
      sc[x][0] = sc[x][1] = sc[x][2] = sc[x][3] = 0.f;
    for (int h = 0; h < H; ++h, ++hc) {
      const int qs = hc & 1;
      mbar_wait(&bar.qfull[qs], (hc >> 1) & 1);
      const uint8_t* qw = sm + OFF_Q + qs * QBUF + wg * BOX;
#pragma unroll
      for (int x = 0; x < 8; ++x)
        acc[x][0] = acc[x][1] = acc[x][2] = acc[x][3] = 0.f;
      float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
      float r_a = 0.f, r_b = 0.f, s_a = 0.f, s_b = 0.f;
      for (int pass = 0; pass < PASSES; ++pass) {
        const bool last = pass == PASSES - 1;
        for (int tile = 0; tile < NT; ++tile, ++n) {
          wait_full(n);
#pragma unroll
          for (int part = 0; part < PARTS; ++part) {
            const int key0 = tile * KT + part * 8 * QN;
            const bool end = tile == NT - 1 && part == PARTS - 1;
            qk(sc, qw, stage(n) + part * BOX);
            if (part == 0 && tile > 0 && last && PHASE == PHASE_ALL)
              release(n - 1);  // the previous tile's P.V read its V
            if (last && end && (ct & 127) == 0)
              mbar_arrive(&bar.qempty[qs]);  // the head's last read of Q
            if (PHASE == PHASE_QK) {
              if (part == PARTS - 1) release(n);
              float p = 0.f;
#pragma unroll
              for (int nb = 0; nb < QN; ++nb)
                p += (sc[nb][0] + sc[nb][1]) + (sc[nb][2] + sc[nb][3]);
              csum += p;
              x_from_rows(sc, h, key0);
              continue;
            }
            float (&s8)[NB][4] = *reinterpret_cast<float(*)[NB][4]>(sc);
            mask(s8, key0);
            if (!last) {  // pass 0 of two: the max (and the sum)
              if (part == PARTS - 1) release(n);
              stats(s8, m_a, m_b, l_a, l_b);
              if (end && NORM == NORM_BEFORE) {
                l_a = quad_sum(l_a);
                l_b = quad_sum(l_b);
                r_a = 1.f / l_a;
                r_b = 1.f / l_b;
              }
              continue;
            }
            probs(s8, m_a, m_b, l_a, l_b, r_a, r_b, s_a, s_b);
            pv(acc, s8, pa, stage(n) + (2 + part) * BOX);
            if (end) {
              wgmma_wait<0>();
              fence_regs(flat(acc));
              release(n);
              head_out(acc, h, s_a, s_b);
            }
          }
        }
      }
    }
    return csum;
  }

  // softmax only, on lgbuf (PHASE_SM); returns this thread's sum of the
  // probabilities
  __device__ double softmax_only() const {
    double csum = 0.0;
    for (int h = 0; h < H; ++h) {
      float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
      float r_a = 0.f, r_b = 0.f, s_a = 0.f, s_b = 0.f;
      const float* rows = lgb + ((size_t)h * BQ + warp * 16 + g) * TP;
      for (int pass = 0; pass < 2; ++pass) {
        for (int key0 = 0; key0 < TP; key0 += 8 * NB) {
          float sc[NB][4];
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            const int j = key0 + nb * 8 + 2 * t;
            const float2 x = *reinterpret_cast<const float2*>(rows + j);
            const float2 y =
                *reinterpret_cast<const float2*>(rows + 8 * TP + j);
            sc[nb][0] = x.x, sc[nb][1] = x.y, sc[nb][2] = y.x, sc[nb][3] = y.y;
          }
          mask(sc, key0);
          if (pass == 0) {
            stats(sc, m_a, m_b, l_a, l_b);
            continue;
          }
          probs(sc, m_a, m_b, l_a, l_b, r_a, r_b, s_a, s_b);
          float p = 0.f;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sc[nb][e] = round_bf(sc[nb][e]);
              p += sc[nb][e];
            }
          csum += p;
          x_from_rows(sc, h, key0);
        }
        if (pass == 0) {
          l_a = quad_sum(l_a);
          l_b = quad_sum(l_b);
          r_a = 1.f / l_a;
          r_b = 1.f / l_b;
        }
      }
    }
    return csum;
  }

  // of^T (i, r) = attr^T (i, e) bf16(wo) (e, r) for this warpgroup's 64 i,
  // 128 r a chunk; returns this thread's sum of `of`
  __device__ double oproj() {
    constexpr int TA = LAYOUT == PV_VMAJOR ? 1 : 0;
    double csum = 0.0;
    const int ia = 64 * wg + 16 * w + g, ib = ia + 8;
    for (int rc = 0; rc < D / OR; ++rc) {
      float oc[64];
#pragma unroll
      for (int x = 0; x < 64; ++x) oc[x] = 0.f;
      for (int et = 0; et < D / OE; ++et, ++n) {
        wait_full(n);
        const uint8_t* a = stage(n) + wg * BOX;
        const uint8_t* b = stage(n) + 2 * BOX;
        fence_regs(oc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < OE / 16; ++kk)
          wgmma_m64n128k16_ss<1, TA>(
              oc,
              TA ? wgmma_desc(a + kk * 2048, BOX, 1024)
                 : wgmma_desc(a + kk * 32, 16, 1024),
              wgmma_desc(b + kk * 2048, BOX, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous tile's products are done
        fence_regs(oc);
        if (et > 0) release(n - 1);
      }
      wgmma_wait<0>();
      fence_regs(oc);
      release(n - 1);
      float p = 0.f;
#pragma unroll
      for (int x = 0; x < 64; x += 4) p += (oc[x] + oc[x + 1]) + (oc[x + 2] + oc[x + 3]);
      csum += p;
      if (rc == 0) {  // X = of[r < 8, i]: the first n8 block
        xs()[(2 * t) * 128 + ia] = oc[0];
        xs()[(2 * t + 1) * 128 + ia] = oc[1];
        xs()[(2 * t) * 128 + ib] = oc[2];
        xs()[(2 * t + 1) * 128 + ib] = oc[3];
      }
    }
    return csum;
  }

  // one micro on the consumers: X into xs; returns this thread's part of
  // the checksum
  __device__ double run() {
    double c;
    if (PHASE == PHASE_SM) {
      c = softmax_only();
    } else if (PHASE == PHASE_QK) {
      c = attention();
    } else {
      attention();
      fence_proxy_async_global();  // attr's stores, for the TMA loads
      mbar_arrive(bar.attr_ready);
      c = oproj();
    }
    named_barrier(BAR_CONSUMERS, CONSUMERS);  // xs written
    return c;
  }

  // the producer's side of one micro: Q, K, V tiles by TMA; attr by TMA
  // and wo converted to bf16 for the O-projection
  __device__ void produce(int pt, const CUtensorMap* mq, const CUtensorMap* mk,
                          const CUtensorMap* mv, const CUtensorMap* ma,
                          int blk) {
    if (PHASE == PHASE_SM) return;
    for (int h = 0; h < H; ++h, ++hc) {
      if (pt == 0) {
        const int qs = hc & 1;
        if (hc >= 2) mbar_wait(&bar.qempty[qs], ((hc >> 1) - 1) & 1);
        uint8_t* qd = sm + OFF_Q + qs * QBUF;
        mbar_arrive_expect_tx(&bar.qfull[qs], QBUF);
        tma_load_2d(qd, mq, &bar.qfull[qs], 0, h * DH);
        tma_load_2d(qd + BOX, mq, &bar.qfull[qs], 64, h * DH);
      }
      for (int pass = 0; pass < PASSES; ++pass)
        for (int tile = 0; tile < NT; ++tile, ++n) {
          // every producer thread waits for each use of the ring in turn:
          // a parity wait is only sound one phase behind
          if (n >= STAGES)
            mbar_wait(&bar.empty[n % STAGES], (n / STAGES - 1) & 1);
          if (pt != 0) continue;
          const bool v = USE_V && pass == PASSES - 1;
          uint64_t* f = &bar.full[n % STAGES];
          mbar_arrive_expect_tx(f, v ? 4 * BOX : 2 * BOX);
          for (int b = 0; b < 2; ++b) {  // keys 64 b .. of the tile
            tma_load_2d(stage(n) + b * BOX, mk, f, tile * KT + 64 * b, h * DH);
            if (v)
              tma_load_2d(stage(n) + (2 + b) * BOX, mv, f, tile * KT + 64 * b,
                          h * DH);
          }
        }
    }
    if (PHASE != PHASE_ALL) return;
    if (pt == 0) mbar_wait(bar.attr_ready, itc & 1);
    ++itc;
    // wo row e = pt / 2 of each tile, 64 columns (half pt % 2 of the 128):
    // one 128-byte swizzled row of a 64-column block. Each tile's bytes
    // are loaded a tile ahead, and attr's TMA goes out before the
    // conversion: the stage's barrier expects attr's bytes first and
    // takes its arrival once the converted rows are written.
    const int e = pt >> 1, half = pt & 1;
    auto wo_row = [&](int i) {  // tile i = rc x (D / OE) + et
      return reinterpret_cast<const int4*>(
          wo + (size_t)((i % (D / OE)) * OE + e) * D + (i / (D / OE)) * OR +
          half * 64);
    };
    constexpr int TILES = (D / OR) * (D / OE);
    int4 raw[4], next[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) next[x] = __ldg(wo_row(0) + x);
    for (int i = 0; i < TILES; ++i, ++n) {
      const int rc = i / (D / OE), et = i - rc * (D / OE);
#pragma unroll
      for (int x = 0; x < 4; ++x) raw[x] = next[x];
      if (i + 1 < TILES)
#pragma unroll
        for (int x = 0; x < 4; ++x) next[x] = __ldg(wo_row(i + 1) + x);
      if (n >= STAGES)
        mbar_wait(&bar.empty[n % STAGES], (n / STAGES - 1) & 1);
      uint64_t* f = &bar.full[n % STAGES];
      if (pt == 0) {
        mbar_expect_tx(f, 2 * BOX);
        for (int c = 0; c < NC; ++c) {
          if (LAYOUT == PV_VMAJOR)
            tma_load_2d(stage(n) + c * BOX, ma, f, 64 * c, blk * D + et * OE);
          else
            tma_load_2d(stage(n) + c * BOX, ma, f, et * OE, blk * BQ + 64 * c);
        }
      }
      uint8_t* dst = stage(n) + (2 + half) * BOX + e * 128;
#pragma unroll
      for (int c = 0; c < 8; ++c) {  // 16 bytes: r 8c .. 8c + 7
        const int* wds = reinterpret_cast<const int*>(&raw[c >> 1]);
        float lo[4], hi[4];
        i8x4_to_f32(wds[2 * (c & 1)], lo);
        i8x4_to_f32(wds[2 * (c & 1) + 1], hi);
        *reinterpret_cast<uint4*>(dst + ((c ^ (e & 7)) << 4)) =
            make_uint4(pack_bf2(lo[0], lo[1]), pack_bf2(lo[2], lo[3]),
                       pack_bf2(hi[0], hi[1]), pack_bf2(hi[2], hi[3]));
      }
      fence_proxy_async();
      named_barrier(BAR_PRODUCER, 128);
      if (pt == 0) mbar_arrive(f);
    }
  }
};

template <int MASK, int NORM, int MAXSUB, int LAYOUT, int PHASE, int BRANCH>
__global__ void __launch_bounds__(THREADS, 1)
qa_kernel(const __grid_constant__ CUtensorMap mq,
          const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv,
          const __grid_constant__ CUtensorMap ma, const int8_t* __restrict__ wo,
          const float* __restrict__ lgb, const float* __restrict__ rmask,
          int T, int reps, int gate, bf16* __restrict__ attr_all,
          float* __restrict__ out, double* __restrict__ checksum) {
  extern __shared__ uint8_t smem_raw[];
  Micro<MASK, NORM, MAXSUB, LAYOUT, PHASE, BRANCH> m;
  m.sm = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(m.sm + OFF_BAR);
  m.bar = Bars{bars, bars + STAGES, bars + 2 * STAGES, bars + 2 * STAGES + 2,
               bars + 2 * STAGES + 4};
  m.wo = wo, m.lgb = lgb;
  m.attr = attr_all + (size_t)blockIdx.x * D * BQ;
  m.T = T;
  m.ct = threadIdx.x;
  m.wg = threadIdx.x >> 7;
  m.warp = threadIdx.x >> 5, m.w = m.warp & 3, m.lane = threadIdx.x & 31;
  m.g = m.lane >> 2, m.t = m.lane & 3;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&m.bar.full[s], 1);
      mbar_init(&m.bar.empty[s], NC);  // one arrival a consumer warpgroup
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&m.bar.qfull[s], 1);
      mbar_init(&m.bar.qempty[s], NC);
    }
    mbar_init(m.bar.attr_ready, CONSUMERS);
    mbar_fence_init();
  }
  if (MASK == MASK_BUF)
    for (int j = threadIdx.x; j < TP; j += THREADS) m.rms()[j] = rmask[j];
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    const int pt = threadIdx.x - CONSUMERS;
    for (int it = 0; it < reps; ++it) {
      if (BRANCH && it < gate) continue;
      m.produce(pt, &mq, &mk, &mv, &ma, blockIdx.x);
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  float* o = out + (size_t)blockIdx.x * 8 * 128;
  float carry[4] = {0.f, 0.f, 0.f, 0.f};
  if (BRANCH)
    for (int e = 0; e < 4; ++e) o[threadIdx.x + e * CONSUMERS] = 0.f;
  double csum = 0.0;
  for (int it = 0; it < reps; ++it) {
    if (BRANCH && it < gate) continue;
    const float wgt = (float)(it % 3 + 1);
    csum += (double)wgt * m.run();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = threadIdx.x + e * CONSUMERS;
      const float add = __fmul_rn(m.xs()[x], wgt);
      if (BRANCH)
        o[x] = __fadd_rn(o[x], add);
      else
        carry[e] = __fadd_rn(carry[e], add);
    }
    named_barrier(BAR_CONSUMERS, CONSUMERS);  // xs read before it is rewritten
  }
  if (!BRANCH)
    for (int e = 0; e < 4; ++e) o[threadIdx.x + e * CONSUMERS] = carry[e];
  // the block's checksum: warp sums, then the 8 warps in order
  double* red = reinterpret_cast<double*>(m.sm + OFF_RED);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    csum += __shfl_xor_sync(0xffffffffu, csum, d);
  if (m.lane == 0) red[m.warp] = csum;
  named_barrier(BAR_CONSUMERS, CONSUMERS);
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int x = 0; x < CONSUMERS / 32; ++x) s += red[x];
    checksum[blockIdx.x] = s;
  }
}

// a bf16 map over `rows` rows of `cols` elements, 64 x 64 boxes
int map2d(CUtensorMap* m, const void* base, int cols, long long rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64};
  return encode_map(m, base, 2, dims, strides, box);
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
  CUtensorMap mq, mk, mv, ma;
  int err;
  if ((err = map2d(&mq, q, BQ, H * DH)) || (err = map2d(&mk, k, TP, H * DH)) ||
      (err = map2d(&mv, v, TP, H * DH)) ||
      (err = LAYOUT == PV_VMAJOR ? map2d(&ma, attr, BQ, (long long)blocks * D)
                                 : map2d(&ma, attr, D, (long long)blocks * BQ)))
    return err;
  kern<<<blocks, THREADS, SMEM, st>>>(
      mq, mk, mv, ma, static_cast<const int8_t*>(wo),
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
// (MASK_BUF, else may be null); attr (blocks, 1280 x 128) bf16 scratch;
// out (blocks, 8, 128) f32; checksum (blocks,) f64; all 16-byte aligned.
// The flags take the enums' values above. Returns 0, a cudaError_t,
// ERR_BAD_ARGS for arguments or a flag tuple that is not instantiated,
// ERR_ATTRIBUTE + the cudaError_t, or hopper.cuh's tensor-map codes.
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
