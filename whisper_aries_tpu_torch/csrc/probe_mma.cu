// Matrix-unit rate probe: chains of wgmma over operands resident in
// shared memory, the Hopper counterpart of two TPU probes.
//
// Replaces:
//   scripts/probe_mxu.py, probe             (sum over i < N of (A.B)[0, 0])
//   scripts/probe_int8_mxu.py, make_kernel  (sum over i < REPS of
//                                            (i mod 3 + 1) (A.B)[:8, :128])
// Python: whisper_aries_tpu_torch/scripts/probe_mxu.py (mma_loop_kernel)
// and probe_int8_mxu.py (mma_fold_kernel).
//
// What it computes. A (TM, K) and B (K, TN), K = KB bytes of operands a
// row: out[block] (TM, TN) = W . (A . B), where W = n_iter (fold 0) or
// sum over i < n_iter of (i mod 3 + 1) (fold 1), for
//   kind 0: bf16 operands, f32 sums        (K 128, m64n256k16)
//   kind 1: s8 operands, s32 sums, wrapping (K 256, m64n256k32)
//   kind 2: f32 operands read as TF32, f32 sums (K 64, m64n256k8)
// Every block computes the same product; out[block][:8, :128] is the TPU
// fold with K cut to the resident tile's depth (227 KB cannot hold the
// TPU's 1024 x 8192 operands).
//
// Bound on the H100: operations, 2 TM TN K W per block at the type's
// dense tensor-core peak (989 bf16, 1,979 int8, 495 TF32 TFLOP/s). Device
// memory is read once (the operands, 96 KB a block) and written once.
//
// Design. One block per SM, two warpgroups, each owning 64 rows of A. The
// block stages A and B (K-major: B arrives transposed, (TN, K)) once into
// shared memory in wgmma's 128-byte-swizzled layout, then every
// iteration i issues (i mod 3 + 1) (fold 1) or one (fold 0) whole products
// A.B into the same 128 accumulator registers a thread, each product 8
// wgmma of 32 bytes of K, back to back; one commit group a product set
// stays in flight. Accumulating every product into the registers keeps
// each of them live (the TPU probe's rotating fold), and nothing else
// runs in the loop.
#include "hopper.cuh"

namespace {

constexpr int WG = 2;            // warpgroups a block, 64 rows of A each
constexpr int TM = 64 * WG;      // rows of A
constexpr int TN = 256;          // columns of B
constexpr int KB = 256;          // bytes of K a row (two 128-byte blocks)
constexpr int KSTEPS = KB / 32;  // wgmma a product (32 bytes of K each)
constexpr int THREADS = 128 * WG;
constexpr int SMEM = TM * KB + TN * KB + 1024;

// a (rows, KB bytes) row-major operand -> shared memory as KB / 128
// K-blocks of rows x 128 bytes, chunk c of row r at c ^ (r % 8)
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src,
                                      int rows) {
  constexpr int PER_ROW = KB / 16;
  for (int q = threadIdx.x; q < rows * PER_ROW; q += blockDim.x) {
    const int r = q / PER_ROW, c = q % PER_ROW;
    const uint4 v = *reinterpret_cast<const uint4*>(src + (size_t)r * KB +
                                                    c * 16);
    *reinterpret_cast<uint4*>(dst + (c / 8) * rows * 128 + r * 128 +
                              ((c % 8) ^ (r & 7)) * 16) = v;
  }
}

// d (+)= a . b over one k step: A and B K-major from shared memory,
// 128 accumulators a thread (the m64n256 layout of hopper.cuh's m64n128)
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

using ::fence_regs;  // hopper.cuh's, for the f32 and s32 accumulators

template <int KIND>
struct Acc {
  using T = float;
};
template <>
struct Acc<1> {
  using T = int;
};

template <int KIND>
__device__ __forceinline__ void mma(typename Acc<KIND>::T (&d)[128],
                                    uint64_t da, uint64_t db) {
  if constexpr (KIND == 0) wgmma_bf16(d, da, db, 1);
  if constexpr (KIND == 1) wgmma_s8(d, da, db, 1);
  if constexpr (KIND == 2) wgmma_tf32(d, da, db, 1);
}

template <int KIND>
__global__ void __launch_bounds__(THREADS, 1)
mma_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ bt,
           typename Acc<KIND>::T* __restrict__ out, long long n_iter,
           int fold) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = align1024(smem_raw);
  uint8_t* sb = sa + TM * KB;
  stage(sa, a, TM);
  stage(sb, bt, TN);
  fence_proxy_async();  // the stores above, before wgmma reads them
  __syncthreads();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  typename Acc<KIND>::T d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  const uint64_t da0 = wgmma_desc(sa + wg * 64 * 128, 16, 1024);
  const uint64_t db0 = wgmma_desc(sb, 16, 1024);
  wgmma_fence();
  for (long long i = 0; i < n_iter; ++i) {
    const int reps = fold ? (int)(i % 3) + 1 : 1;
    for (int r = 0; r < reps; ++r) {
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s)
        mma<KIND>(d, da0 + (((s / 4) * TM * 128 + (s % 4) * 32) >> 4),
                  db0 + (((s / 4) * TN * 128 + (s % 4) * 32) >> 4));
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(d);
  typename Acc<KIND>::T* o =
      out + ((size_t)blockIdx.x * TM + 64 * wg + 16 * warp + g) * TN + 2 * t;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    o[8 * j] = d[4 * j];
    o[8 * j + 1] = d[4 * j + 1];
    o[8 * TN + 8 * j] = d[4 * j + 2];
    o[8 * TN + 8 * j + 1] = d[4 * j + 3];
  }
}

template <int KIND>
int launch(const void* a, const void* bt, void* out, long long n_iter,
           int fold, int blocks, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      mma_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  mma_kernel<KIND><<<blocks, THREADS, SMEM, st>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(bt),
      static_cast<typename Acc<KIND>::T*>(out), n_iter, fold);
  return launch_status();
}

}  // namespace

extern "C" {

// kind 0 (bf16 -> f32), 1 (s8 -> s32), 2 (f32 as TF32 -> f32). a (TM, K)
// and bt (TN, K) row-major (bt is B transposed), K = KB / element bytes,
// 16-byte aligned; out (blocks, TM, TN) f32 (int32 for kind 1). fold 0:
// one product an iteration; fold 1: (i mod 3 + 1).
int aries_probe_mma(int kind, const void* a, const void* bt, void* out,
                    long long n_iter, int fold, int blocks, void* stream) {
  if (kind < 0 || kind > 2 || n_iter <= 0 || blocks <= 0 ||
      (reinterpret_cast<uintptr_t>(a) & 15) ||
      (reinterpret_cast<uintptr_t>(bt) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0) return launch<0>(a, bt, out, n_iter, fold, blocks, st);
  if (kind == 1) return launch<1>(a, bt, out, n_iter, fold, blocks, st);
  return launch<2>(a, bt, out, n_iter, fold, blocks, st);
}

// the tile: rows of A, columns of B, bytes of K a row
void aries_probe_mma_tile(int* tm, int* tn, int* kbytes) {
  *tm = TM, *tn = TN, *kbytes = KB;
}

}  // extern "C"
