// Copy-rate and shared-memory probes: device memory -> shared memory by
// TMA, the Hopper counterparts of three TPU probes.
//
// Replaces:
//   scripts/probe_dma.py, probe        (a ring of n_slots async copies)
//   scripts/probe_dma.py, probe_multi  (n_streams independent rings)
//   scripts/probe_vmem.py, try_size    (one copy into the largest scratch)
// Python: whisper_aries_tpu_torch/scripts/probe_dma.py (copy_ring_kernel,
// copy_streams_kernel) and probe_vmem.py (smem_copy_kernel).
//
// What it computes. The source is (C, rows, full_lanes) elements (bf16 or
// int8), cut into `bands` bands of `band` rows, `lanes` wide, each chunk
// (band * bands <= rows). The work is n_iter * bands copies of the (TPU
// iteration i, band j) pairs, item = i * bands + j; walker b takes items b,
// b + blocks, b + 2 * blocks, ... (its steps t = 0, 1, ...). Its ring s
// copies, at step t, band j of chunk c = (i * n_streams + s) mod C into the
// next slot of the ring and, once the copy has landed, adds the first
// `head` elements of the slot (its element [0, 0] for the rate probes) to
// an f32 sum: out[b][s] (a walker's checksum is the sum of its rings').
// Where `trace` is given, every read is also written there
// (trace[b][s][t], t < ceil(items / blocks), zero past the walker's
// last step), so a check can hold each copy's landing in place, not only
// their sum. With blocks == bands, walker b copies band b of every chunk at
// step t = i; with one walker, one ring and the whole chunk as the band,
// this is the TPU probe's function: sum over i < n_iter of src[i mod C][0,
// 0].
//
// Bound on the H100: bytes (every copy reads its band from device memory;
// the source is made larger than the 50 MB L2 so that it does). The probe
// measures how close a ring of copies comes to it, by bytes in flight.
//
// Design. Walker b is block b; its ring s is warp s, whose lane 0 drives
// it alone, as the TPU's DMA engine needs no vector work: it issues each
// copy with one instruction, a bulk copy (cp.async.bulk) for a contiguous
// band or 2-D tensor-map boxes of at most 256 elements x band rows for a
// strided one, completing on the slot's mbarrier with the copy's whole
// byte count (expect_tx). The loop is the TPU probe's: before waiting on
// slot t mod n_slots it issues the copy of step t + n_slots - 1 into the
// slot freed by step t - 1; a slot is read only after its barrier's phase
// completed, i.e. after every byte of its copy arrived, and
// fence.proxy.async orders that read before the next copy into the slot.
// The rate runs launch one
// walker's block an SM (a persistent grid over the items), so every SM
// holds a walker's n_streams rings, as the TPU's core holds its streams,
// and keeps n_streams x n_slots copies of the largest band that fits in
// flight, whatever the chunk's band count. The walk is kept by increments
// (the host divides blocks by bands once: no 64-bit division on the card).
// The shared memory is all dynamic (every ring's barriers first, then each
// ring's slots), so the shared-memory probe's request is exactly what the
// launch asks for.
#include "hopper.cuh"

namespace {

struct CopyArgs {
  const uint8_t* src;
  float* out;             // (blocks, n_streams)
  float* trace;           // (blocks, n_streams, steps) or null
  long long steps;        // ceil(items / blocks): a block's most steps
  long long steps_rem;    // items % blocks: blocks below it take `steps`
  int C, rows, full_lanes, band, lanes, elem;
  int bands;              // bands a chunk walked
  int step_q, step_r;     // blocks = step_q * bands + step_r
  int chunk_q, chunk_q1;  // (step_q * n_streams) mod C, ((step_q + 1) ...)
  int n_slots, n_streams, head;
  int tma2d, boxes, box_lanes;
  unsigned copy_bytes;    // band x lanes x elem
  unsigned slot_stride;   // bytes between slots
  unsigned data_off;      // bytes from the dynamic base to the first slot
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float to_f32(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

template <typename T>
__global__ void copy_ring_kernel(const CopyArgs a,
                                 const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(16) uint8_t smem[];
  // this warp is ring s of walker b: its barriers (one a slot), its slots.
  // s through a shuffle is warp-uniform to the compiler (threadIdx is
  // not), so the copies' and barriers' addresses stay in uniform registers
  // instead of a loop over lanes around every TMA and barrier instruction
  const int s = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
  const int b = (int)blockIdx.x;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + s * a.n_slots;
  uint8_t* ring = smem + a.data_off;
  if (a.tma2d)  // tensor-map boxes land on 128-byte boundaries
    ring += (128 - (smem_u32(ring) & 127)) & 127;
  ring += (size_t)s * a.n_slots * a.slot_stride;
  if ((threadIdx.x & 31) == 0) {
    for (int k = 0; k < a.n_slots; ++k) mbar_init(bar + k, 1);
    mbar_fence_init();
    const unsigned box_bytes = (unsigned)a.box_lanes * a.band * a.elem;
    // walker b's steps: items b, b + blocks, ... below n_iter * bands
    const long long n_steps =
        a.steps_rem == 0 || b < a.steps_rem ? a.steps : a.steps - 1;
    // the next copy to issue: its number, slot, band and chunk, kept by
    // increments (no 64-bit division in the loop, whose cost a small copy
    // would otherwise measure)
    long long issued = 0;
    int band_j = b % a.bands;
    int chunk = (b / a.bands * a.n_streams + s) % a.C;
    int issue_slot = 0;
    auto issue = [&]() {
      const long long row0 =
          (long long)chunk * a.rows + (long long)band_j * a.band;
      uint8_t* dst = ring + (size_t)issue_slot * a.slot_stride;
      uint64_t* full = bar + issue_slot;
      mbar_arrive_expect_tx(full, a.copy_bytes);
      if (!a.tma2d) {
        bulk_load(dst, a.src + row0 * a.full_lanes * a.elem, a.copy_bytes,
                  full);
      } else {
        for (int j = 0; j < a.boxes; ++j)
          tma_load_2d(dst + (size_t)j * box_bytes, &map, full,
                      j * a.box_lanes, (int)row0);
      }
      ++issued;
      issue_slot = issue_slot + 1 == a.n_slots ? 0 : issue_slot + 1;
      // item += blocks: band += step_r (carrying into the iteration), the
      // iteration += step_q (+ 1), so the chunk += (its) * n_streams
      band_j += a.step_r;
      if (band_j >= a.bands) {
        band_j -= a.bands;
        chunk += a.chunk_q1;
      } else {
        chunk += a.chunk_q;
      }
      if (chunk >= a.C) chunk -= a.C;
    };
    while (issued < a.n_slots - 1 && issued < n_steps) issue();
    float acc = 0.f;
    int slot = 0;
    uint32_t parity = 0;
    float* trace =
        a.trace ? a.trace + ((long long)b * a.n_streams + s) * a.steps
                : nullptr;
    for (long long i = 0; i < n_steps; ++i) {
      // the copy of step i + n_slots - 1, into the slot freed by i - 1
      if (issued < n_steps) issue();
      mbar_wait(bar + slot, parity);
      const T* v = reinterpret_cast<const T*>(ring + (size_t)slot * a.slot_stride);
      float r = 0.f;
      for (int e = 0; e < a.head; ++e) r += to_f32(v[e]);
      fence_proxy_async();  // the read above, before the next copy here
      acc += r;
      if (trace) trace[i] = r;
      if (++slot == a.n_slots) slot = 0, parity ^= 1;
    }
    if (trace)
      for (long long i = n_steps; i < a.steps; ++i) trace[i] = 0.f;
    a.out[(long long)b * a.n_streams + s] = acc;
  }
}

// the kernel's attributes for a launch: 0, or ERR_ATTRIBUTE + the
// cudaError_t with which the card refused one
template <typename T>
int configure(int smem, int cluster) {
  cudaError_t e = cudaFuncSetAttribute(
      copy_ring_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(copy_ring_kernel<T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) return 0;
  cudaGetLastError();  // not left for the next launch
  return ERR_ATTRIBUTE + (int)e;
}

cudaLaunchConfig_t launch_config(int blocks, int threads, int smem,
                                 int cluster, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  if (cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

// dynamic shared memory of a block: its n_slots barriers (every ring's),
// 16-byte aligned, then the slots (with 128 bytes of slack to align
// tensor-map boxes)
unsigned data_offset(int n_slots) {
  return (unsigned)((8 * n_slots + 15) / 16 * 16);
}

CUtensorMapDataType map_type(int elem) {
  return elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                   : CU_TENSOR_MAP_DATA_TYPE_UINT16;
}

}  // namespace

extern "C" {

// src (C, rows, full_lanes) of elem bytes (2: bf16, 1: int8), contiguous,
// 16-byte aligned; out (blocks, n_streams) f32, one sum a ring. The
// blocks walkers walk the n_iter x bands (iteration, band) items, band j
// being rows [j * band, (j + 1) * band) of a chunk, lanes wide (lanes ==
// full_lanes: one bulk copy, band x lanes x elem a multiple of 16; else
// tensor-map boxes of box_lanes = min(lanes, 256) elements, lanes %
// box_lanes == 0, band <= 256); walker b is a block of 32 x n_streams
// threads, a warp a ring. smem: the dynamic shared memory a block asks for
// (at least what its rings need; the shared-memory probe asks for exactly
// its limit).
// cluster > 1 launches clusters of that many blocks (blocks % cluster ==
// 0). trace: null, or (blocks, n_streams, ceil(n_iter * bands / blocks))
// f32 for every read. Returns 0, the launch's cudaError_t, or one of
// hopper.cuh's codes: ERR_BAD_ARGS where these rules are broken,
// ERR_ATTRIBUTE + the error where the card refuses the shared memory or
// cluster size asked for.
int aries_probe_copy(const void* src, int elem, int C, int rows,
                     int full_lanes, int band, int bands, int lanes,
                     long long n_iter, int n_slots, int n_streams, int head,
                     int blocks, int cluster, int smem, float* out,
                     float* trace, void* stream) {
  if ((elem != 1 && elem != 2) || C <= 0 || rows <= 0 || band <= 0 ||
      bands <= 0 || (long long)bands * band > rows || lanes <= 0 ||
      lanes > full_lanes || n_iter <= 0 || n_iter > (1LL << 40) ||
      n_slots <= 0 || n_streams <= 0 || n_streams > 32 || head <= 0 ||
      head > lanes || blocks <= 0 || cluster <= 0 || blocks % cluster ||
      (reinterpret_cast<uintptr_t>(src) & 15))
    return ERR_BAD_ARGS;
  CopyArgs a = {};
  a.src = static_cast<const uint8_t*>(src);
  a.out = out;
  a.trace = trace;
  const long long items = n_iter * bands;
  a.steps = (items + blocks - 1) / blocks;
  a.steps_rem = items % blocks;
  a.C = C, a.rows = rows, a.full_lanes = full_lanes, a.band = band;
  a.lanes = lanes, a.elem = elem, a.bands = bands;
  a.step_q = blocks / bands, a.step_r = blocks % bands;
  a.chunk_q = (int)((long long)a.step_q * n_streams % C);
  a.chunk_q1 = (int)((long long)(a.step_q + 1) * n_streams % C);
  a.n_slots = n_slots, a.n_streams = n_streams, a.head = head;
  const long long copy = (long long)band * lanes * elem;
  if (copy % 16 || copy >= (1 << 20)) return ERR_BAD_ARGS;
  a.copy_bytes = (unsigned)copy;
  a.tma2d = lanes != full_lanes;
  a.data_off = data_offset(n_slots * n_streams);
  CUtensorMap map = {};
  if (a.tma2d) {
    a.box_lanes = lanes < 256 ? lanes : 256;
    if (lanes % a.box_lanes || (a.box_lanes * elem) % 16 || band > 256 ||
        ((long long)full_lanes * elem) % 16)
      return ERR_BAD_ARGS;
    a.boxes = lanes / a.box_lanes;
    a.slot_stride = (unsigned)((copy + 127) / 128 * 128);
    EncodeTiledFn fn = encode_tiled_fn();
    if (fn == nullptr) return ERR_NO_TENSOR_MAP;
    const cuuint64_t dims[2] = {(cuuint64_t)full_lanes,
                                (cuuint64_t)C * rows};
    const cuuint64_t strides[1] = {(cuuint64_t)full_lanes * elem};
    const cuuint32_t box[2] = {(cuuint32_t)a.box_lanes, (cuuint32_t)band};
    const cuuint32_t estr[2] = {1, 1};
    const CUresult r = fn(&map, map_type(elem), 2, const_cast<void*>(src),
                          dims, strides, box, estr,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return ERR_TENSOR_MAP + (int)r;
  } else {
    a.slot_stride = a.copy_bytes;
  }
  const long long need = (long long)a.data_off + (a.tma2d ? 128 : 0) +
                         (long long)a.slot_stride * n_slots * n_streams;
  if (smem < need) return ERR_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  const int threads = 32 * n_streams;
  cudaError_t e;
  int c;
  if (elem == 2) {
    if ((c = configure<bf16>(smem, cluster)) != 0) return c;
    cudaLaunchConfig_t cfg =
        launch_config(blocks, threads, smem, cluster, st, attr);
    e = cudaLaunchKernelEx(&cfg, copy_ring_kernel<bf16>, a, map);
  } else {
    if ((c = configure<int8_t>(smem, cluster)) != 0) return c;
    cudaLaunchConfig_t cfg =
        launch_config(blocks, threads, smem, cluster, st, attr);
    e = cudaLaunchKernelEx(&cfg, copy_ring_kernel<int8_t>, a, map);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// the current card's shared-memory attributes, in bytes
int aries_probe_smem_limits(int* optin, int* per_sm, int* per_block,
                            int* reserved) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(per_block, cudaDevAttrMaxSharedMemoryPerBlock,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  return (int)e;
}

// blocks of the copy kernel (elem bytes, threads, smem) that fit one SM
int aries_probe_copy_occupancy(int elem, int threads, int smem, int* n) {
  cudaError_t e;
  int c;
  if (elem == 2) {
    if ((c = configure<bf16>(smem, 1)) != 0) return c;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, copy_ring_kernel<bf16>, threads, smem);
  } else {
    if ((c = configure<int8_t>(smem, 1)) != 0) return c;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, copy_ring_kernel<int8_t>, threads, smem);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// clusters of `cluster` blocks (bf16 copy kernel, threads, smem each) that
// the card can hold at once (cudaOccupancyMaxActiveClusters)
int aries_probe_copy_max_clusters(int cluster, int threads, int smem,
                                  int* n) {
  const int c = configure<bf16>(smem, cluster);
  if (c != 0) return c;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      launch_config(cluster, threads, smem, cluster, 0, attr);
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(n, copy_ring_kernel<bf16>, &cfg);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

}  // extern "C"
