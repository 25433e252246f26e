// Grouped int8 cross-attention, the standalone entry (ops/cross_attn.py,
// cross_attention_q8_kernel): the prefill's cross-attention, once per
// decoder layer of every prefill, and any int8 cross call outside the
// decode step.
//
// Replaces: whisper_aries_tpu/ops/pallas_cross_attn.py, cross_attention_q8
// and its row-blocked form cross_attention_q8_blocked. The G queries of one
// window (its beams, times the prompt positions in a prefill) attend over
// that window's int8 K/V with per-position scales:
//
//   logits[g, t] = (q[g] . k8[t]) * ks[t]          ks folds 1/sqrt(dh)
//   p[g, t]      = softmax_t(logits[g, :]) * vs[t]  f32, never rounded
//   out[g]       = sum_t p[g, t] * v8[t]            f32 sums
//
// Bound on the H100: bytes. A window's K/V (2 x H x Ta x 64 int8) and its
// scales (2 x H x Ta f32) are read once for all G queries: 24.5 MB at the
// prefills' 6 windows of large-v3, 7.3 us at 3.35 TB/s; the products
// (4 x G x Ta x 64 per head) are far below the card's rate.
//
// Design: the decode step's split-KV cross-attention (attn_split.cuh),
// instantiated here for bf16 or f32 queries, f32 (or, for bf16 queries,
// bf16) outputs and the strides of its operands, and launched without
// PDL. The Ta keys of each (head, window) are cut into S splits (the
// step's cross_plan, mirrored by ops/decode_layers.py::cross_split),
// one block each and the S blocks a cluster; each block streams its
// split's int8 K and V through a cp.async ring, and one exchange through
// distributed shared memory combines the splits' softmax statistics and
// partial outputs in rank order (the same bits every run). Up to 8
// queries (the prefills' 3 prompt positions) run the block-wide kernel:
// logits on the tensor cores, the split's statistics, P . V by f32 FMAs.
// More (best_of 5 x 3 = 15 at the sampled rungs) run in chunks of 16 in
// the per-warp kernel: each warp keeps its own softmax state over 8 keys
// of every tile and forms P . V on the tensor cores from the weights cut
// into three exact bf16 parts; above 16, each chunk streams the K/V again.
// The first design of this entry, one 512-thread block per (head, window)
// walking its 1500 keys through three serial phases, read at about 12% of
// the memory rate (120 blocks on 132 SMs). More splits than cross_plan's
// one wave of 3 blocks an SM measured slower in development.
#include "attn_split.cuh"

namespace {

using splitkv::CrossArgs;

// the largest dynamic shared memory a launch asks for, allowed once per
// card and type pair
template <typename QT, typename OT>
int allow_smem() {
  static std::once_flag once[MAX_CARDS];
  static int status[MAX_CARDS];
  return once_per_card(once, status, splitkv::cross_allow_smem<QT, OT>);
}

template <typename QT, typename OT>
int run(const CrossArgs& a, int Bw, int sms, cudaStream_t st) {
  const int err = allow_smem<QT, OT>();
  if (err) return err;
  return splitkv::launch_cross_split<QT, OT>(a, Bw, sms, 0, st);
}

}  // namespace

extern "C" {

// q (Bw, H, G, 64) bf16 (q_bf16 = 1) or f32, with element strides per
// window, head and query (dims contiguous); k8/v8 (Bw, H, Ta, 64) int8 and
// ks/vs (Bw, H, Ta) f32 with strides per window and head (t contiguous);
// out (Bw, H, G, 64) f32, or bf16 (out_bf16 = 1, bf16 q only: the decode
// step's output type), with element strides per window, head and query.
// `sms`: the SM count of the operands' card.
int aries_cross_attn_q8(const void* q, int q_bf16, long long q_sw,
                        long long q_sh, long long q_sg, const int8_t* k8,
                        const int8_t* v8, long long kv_sw, long long kv_sh,
                        const float* ks, const float* vs, long long s_sw,
                        long long s_sh, void* out, int out_bf16,
                        long long o_sw, long long o_sh, long long o_sg,
                        int Bw, int H, int G, int Ta, int sms, void* stream) {
  if (Bw <= 0 || H <= 0 || G <= 0 || Ta <= 0)
    return (int)cudaErrorInvalidValue;
  CrossArgs a{};
  a.q = q;
  a.q_sw = q_sw;
  a.q_sh = q_sh;
  a.q_sg = q_sg;
  a.k8 = k8;
  a.v8 = v8;
  a.kv_sw = kv_sw;
  a.kv_sh = kv_sh;
  a.ks = ks;
  a.vs = vs;
  a.s_sw = s_sw;
  a.s_sh = s_sh;
  a.out = out;
  a.o_sw = o_sw;
  a.o_sh = o_sh;
  a.o_sg = o_sg;
  a.H = H;
  a.Ta = Ta;
  a.G = G;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    return q_bf16 ? run<bf16, bf16>(a, Bw, sms, st)
                  : (int)cudaErrorInvalidValue;
  return q_bf16 ? run<bf16, float>(a, Bw, sms, st)
                : run<float, float>(a, Bw, sms, st);
}

}  // extern "C"
