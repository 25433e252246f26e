// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel source is compiled on its own by nvcc into a shared library
// with a plain C interface (loaded with ctypes, see ops/cuda_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// Never with --use_fast_math: the int8 grids need IEEE division and
// round-half-to-even, and the erf fit needs an accurate expf.
//
// Launch contract: kernels run on the caller's stream, allocate nothing
// (the Python wrapper hands in outputs and scratch), and each C entry point
// returns cudaGetLastError() so a refused launch is reported at once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }

// round an f32 value to bf16 and back (what a cast to the activation
// dtype and back does in the plain version)
__device__ __forceinline__ float round_bf(float v) { return bf2f(f2bf(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// f32 bits made monotone as unsigned (every value but NaN), and back; a
// float max over a warp is then one redux.sync (sm_80 and later)
__device__ __forceinline__ unsigned f32_ord(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float f32_unord(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}
__device__ __forceinline__ float warp_max_redux(float v) {
  return f32_unord(__reduce_max_sync(0xffffffffu, f32_ord(v)));
}

// Block-wide reductions over blockDim.x threads (a multiple of 32, at most
// 1024); `scratch` holds >= 32 floats. Every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = lane < nwarp ? scratch[lane] : 0.f;
  return warp_sum(r);
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = lane < nwarp ? scratch[lane] : -INFINITY;
  return warp_max(r);
}

// two f32 values -> a bf16x2 register (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the four signed bytes of a 32-bit word as exact f32 values, without the
// quarter-rate integer conversion: byte b + 128 becomes the low mantissa
// byte of 2^23 (one byte permute), then one subtraction
__device__ __forceinline__ void i8x4_to_f32(int word, float (&f)[4]) {
  const uint32_t u = (uint32_t)word ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | k)) -
           8388736.f;
}

// c += a . b on the tensor cores: m16n8k16, bf16 in, f32 accumulate, with
// PTX's fragment layout (g = lane / 4, t = lane % 4):
//   a[0] (row g, k 2t..2t+1)  a[1] (row g+8, k 2t..)  a[2] (row g, k 2t+8..)
//   a[3] (row g+8, k 2t+8..)  b0 (k 2t..2t+1, col g)  b1 (k 2t+8.., col g)
//   c[0..1] (row g, cols 2t, 2t+1)  c[2..3] (row g+8, cols 2t, 2t+1)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static inline int launch_status() { return (int)cudaGetLastError(); }
