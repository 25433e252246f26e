// Grouped int8 cross-attention, the standalone entry (ops/cross_attn.py,
// cross_attention_q8_kernel): the prefill's cross-attention and any other
// int8 cross call outside the decode step. The device code, its design and
// its bound are in cross_attn.cuh.
//
// Replaces: whisper_aries_tpu/ops/pallas_cross_attn.py, cross_attention_q8
// and cross_attention_q8_blocked.
#include "cross_attn.cuh"

extern "C" {

// q (Bw, H, G, 64) bf16 (q_bf16 = 1) or f32, with element strides per
// window, head and query (dims contiguous); k8/v8 (Bw, H, Ta, 64) int8 and
// ks/vs (Bw, H, Ta) f32 with strides per window and head (t contiguous);
// out (Bw, H, G, 64) f32, or bf16 (out_bf16 = 1, bf16 q only: the decode
// step's output type), with element strides per window, head and query.
int aries_cross_attn_q8(const void* q, int q_bf16, long long q_sw,
                        long long q_sh, long long q_sg, const int8_t* k8,
                        const int8_t* v8, long long kv_sw, long long kv_sh,
                        const float* ks, const float* vs, long long s_sw,
                        long long s_sh, void* out, int out_bf16,
                        long long o_sw, long long o_sh, long long o_sg,
                        int Bw, int H, int G, int Ta, void* stream) {
  xattn::Args a;
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
  a.G = G;
  a.Ta = Ta;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    return q_bf16 ? xattn::launch<bf16, bf16>(a, Bw, st)
                  : (int)cudaErrorInvalidValue;
  return q_bf16 ? xattn::launch<bf16, float>(a, Bw, st)
                : xattn::launch<float, float>(a, Bw, st);
}

}  // extern "C"
