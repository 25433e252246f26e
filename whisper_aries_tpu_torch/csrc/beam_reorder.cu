// Beam-cache reorder (ops/beam_reorder.py, permute_rows_kernel): the
// block-diagonal row permutation of one beam self-cache leaf, in place.
//
// Replaces: whisper_aries_tpu/ops/pallas_beam_reorder.py, _permute_leaf.
// A leaf is (L, B*K, ...) with the row axis second; after a beam step
//   row b*K + o  <-  row b*K + src[b, o]        (src in [0, K))
// for every layer. Whole rows move; no arithmetic.
//
// Bound on the H100: bytes, the leaf read once and written once
// (2 x 0.79 GB for the int8 self cache with its scales at R = 40,
// T = P + 224: ~0.47 ms).
//
// Design: one block per (chunk of a row's bytes, window, layer). It loads
// that chunk of all K rows of its window into shared memory, syncs, and
// writes them back in `src` order (rows that keep their place are not
// written). No block writes bytes another block reads, so the permutation
// runs in place, with no second cache buffer. Loads and stores are 16
// bytes a thread where the row length allows.
//
// Identity skip: a block whose window's map is the identity (every beam
// keeps its own history) returns before it reads a byte. The decode loop
// graph launches the reorder at every step and lets the kernel decide on
// the device; JAX skips the permute when every window's map is the
// identity (generate.py:877-881), this skips each such window, with the
// same result.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4096;  // bytes of each row per block
constexpr int KMAX = 8;    // beams per window (K x CHUNK of shared memory)

template <typename VT>
__global__ void __launch_bounds__(THREADS)
reorder_kernel(char* __restrict__ data, const int* __restrict__ src, int B,
               int K, long long row_bytes) {
  extern __shared__ uint4 sbuf4[];  // K x CHUNK bytes
  VT* sbuf = reinterpret_cast<VT*>(sbuf4);
  constexpr int CH = CHUNK / (int)sizeof(VT);  // elements per row chunk
  const int c = blockIdx.x, b = blockIdx.y, l = blockIdx.z;
  bool identity = true;
  for (int k = 0; k < K; ++k) identity = identity && src[b * K + k] == k;
  if (identity) return;
  const long long off = (long long)c * CHUNK;
  const long long left = row_bytes - off;
  const int n = (int)((left < CHUNK ? left : CHUNK) / (long long)sizeof(VT));
  char* base = data + ((long long)l * B * K + (long long)b * K) * row_bytes + off;
  for (int k = 0; k < K; ++k) {
    const VT* in = reinterpret_cast<const VT*>(base + k * row_bytes);
    for (int i = threadIdx.x; i < n; i += THREADS) sbuf[k * CH + i] = in[i];
  }
  __syncthreads();
  for (int o = 0; o < K; ++o) {
    const int s = src[b * K + o];
    if (s < 0 || s >= K) __trap();  // not a beam of this window
    if (s == o) continue;
    VT* out = reinterpret_cast<VT*>(base + o * row_bytes);
    for (int i = threadIdx.x; i < n; i += THREADS) out[i] = sbuf[s * CH + i];
  }
}

template <typename VT>
int launch(char* data, const int* src, int L, int B, int K,
           long long row_bytes, cudaStream_t st) {
  const long long chunks = (row_bytes + CHUNK - 1) / CHUNK;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  reorder_kernel<VT><<<dim3((unsigned)chunks, B, L), THREADS,
                        (size_t)K * CHUNK, st>>>(
      data, src, B, K, row_bytes);
  return launch_status();
}

}  // namespace

extern "C" {

// data: one leaf (L, B*K, row_bytes) of any element type, contiguous;
// src (B, K) int32 on the device.
int aries_beam_reorder(void* data, const int* src, int L, int B, int K,
                       long long row_bytes, void* stream) {
  if (L <= 0 || B <= 0 || K <= 0 || K > KMAX || row_bytes <= 0 ||
      L > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  char* p = static_cast<char*>(data);
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned long long addr = (unsigned long long)p;
  if (row_bytes % 16 == 0 && addr % 16 == 0)
    return launch<uint4>(p, src, L, B, K, row_bytes, st);
  if (row_bytes % 4 == 0 && addr % 4 == 0)
    return launch<uint32_t>(p, src, L, B, K, row_bytes, st);
  return launch<uint8_t>(p, src, L, B, K, row_bytes, st);
}

}  // extern "C"
