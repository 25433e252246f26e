// Decode-step self-attention over an int8 self cache: the unfused
// decoder_step's S == 1 branch (models/whisper.py; ops/self_attn.py,
// self_attention_q8_kernel).
//
// Replaces: whisper_aries_tpu/ops/pallas_self_attn.py,
// self_attention_q8_step. One query per (row, head) over that row's cache:
//
//   logits[t] = (q . k8[t]) * ks[t] + mask[t]     ks folds 1/sqrt(dh)
//   p[t]      = softmax_t(logits) * vs[t]          the max subtracted first
//   out       = sum_t p[t] * v8[t]                 f32 (B, H, 1, 64)
//
// The mask row is the one additive row (0 where a position may be read,
// f32 min elsewhere) every row and head shares: positions past the decode
// position hold zeros or stale values, so it is applied, not assumed.
//
// Bound on the H100: bytes. Each (row, head) reads its int8 K and V rows
// (2 x T x 64) and their scales (2 x T f32) once; the products
// (4 x T x 64 per head) are far below the card's rate.
//
// Design: the device code of the grouped int8 cross-attention
// (cross_attn.cuh), which streams int8 K/V rows with per-position scales,
// run with each cache row as its own "window", G = 1 query, and the mask
// row added to the scaled logits. The port's cache is dh-minor,
// (B, H, T, 64) per layer with (B, H, T) scales, so a key row is 64
// contiguous bytes; the JAX package's time-minor layout is not ported.
#include "cross_attn.cuh"

extern "C" {

// q (B, H, 1, 64) bf16 (q_bf16 = 1) or f32 with element strides per row
// and head (dims contiguous); k8/v8 (B, H, T, 64) int8 and ks/vs (B, H, T)
// f32 with strides per row and head (t contiguous); mask (T,) f32;
// out (B, H, 1, 64) f32 contiguous.
int aries_self_attn_q8(const void* q, int q_bf16, long long q_sb,
                       long long q_sh, const int8_t* k8, const int8_t* v8,
                       long long kv_sb, long long kv_sh, const float* ks,
                       const float* vs, long long s_sb, long long s_sh,
                       const float* mask, float* out, int B, int H, int T,
                       void* stream) {
  if (mask == nullptr) return (int)cudaErrorInvalidValue;
  xattn::Args a;
  a.q = q;
  a.q_sw = q_sb;
  a.q_sh = q_sh;
  a.q_sg = xattn::DH;
  a.k8 = k8;
  a.v8 = v8;
  a.kv_sw = kv_sb;
  a.kv_sh = kv_sh;
  a.ks = ks;
  a.vs = vs;
  a.s_sw = s_sb;
  a.s_sh = s_sh;
  a.out = out;
  a.o_sw = (long long)H * xattn::DH;
  a.o_sh = xattn::DH;
  a.o_sg = xattn::DH;
  a.H = H;
  a.G = 1;
  a.Ta = T;
  a.mask = mask;
  cudaStream_t st = (cudaStream_t)stream;
  return q_bf16 ? xattn::launch<bf16, float>(a, B, st)
                : xattn::launch<float, float>(a, B, st);
}

}  // extern "C"
