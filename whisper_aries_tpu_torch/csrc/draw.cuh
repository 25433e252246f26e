// The sampled rungs' draw (decode_loop.cu's standalone draw kernel and
// decode_choice.cu's fused one): u in (0, 1), a counter-based hash of
// (seed, row, position, vocab id), so a graph that replays a step draws new
// numbers at each position and the same numbers for the same seed. The
// plain version (ops/decode_loop.py::uniform_draw_plain) is the same integer
// hash in torch ops, bit for bit.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// the key of row r at position pos
__device__ __forceinline__ uint32_t draw_key(uint32_t seed_lo,
                                             uint32_t seed_hi, int r,
                                             int pos) {
  return mix32(mix32(mix32(seed_lo ^ mix32(seed_hi)) ^ (uint32_t)r) ^
               (uint32_t)pos);
}

// u of id v under a row's key; 23 bits: (h >> 9) + 0.5 is exact in f32,
// so u never rounds to 0 or 1
__device__ __forceinline__ float draw_uniform(uint32_t key, int v) {
  const uint32_t h = mix32(key ^ (uint32_t)v);
  return ((float)(h >> 9) + 0.5f) * 1.1920928955078125e-7f;
}
